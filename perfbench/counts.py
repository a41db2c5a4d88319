"""Operations and bytes of one launch of the solve kernel, and the H100's
peaks: the yardstick of the roofline shares.

Operations are counted from the arithmetic of the port's solve kernel
(`csrc/ilqr.cu`'s device functions) for a `SolverConfig`: a libdevice call
counts as one, products with the structural zeros of [A|B], Jr and Jg do not
count, and work the kernel repeats on several lanes counts once.  The count
is fixed by the configuration: the kernel makes every AL round, iLQR
iteration and ladder rung, with no early exit.  Bytes: each input read once
and each output written once.  The peaks are NVIDIA's data sheet for the
H100 SXM at 700 W: 67 TFLOP/s in float32 and 34 in float64 outside the
tensor cores, 3.35 TB/s of HBM.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
FLOP_PER_S = {"float32": 67e12, "float64": 34e12}
NX, NU = 8, 2
NZ = NX + NU
N_SCAL = 31  # the kernel's scalar vector without rho and reg


def solve_flops(cfg: dict, n_con: int = 14) -> int:
    """Operations of one AL-iLQR solve of one OCP.  The RHS 85; its
    partials and the 29 nonzero entries of d rhs/d[x, u] 133 more; one
    tangent through them 47; one RK4 substep's updates of an 8-vector 104.
    The linearisation of a step evaluates the RHS and its partials once per
    RK4 stage and carries NZ tangent columns; a rollout step is the RHS and
    the updates.  The constraints 56 (53 more for the ellipse rows), the
    stage cost 43, the PHR penalty 8 per row; the GN quads 159 for the
    residual rows, 252 for constraint rows 0-13 and 274 for the ellipse
    rows; a Riccati stage 4,725; the feedback law 54 per rung and stage."""
    N, L, ss = cfg["horizon"], cfg["n_linesearch"], cfg["substeps"]
    ellipse = n_con == 16
    rhs, partials, tangent, update = 85, 133, 47, 104
    step = ss * (4 * rhs + update)
    lin = ss * (4 * (rhs + partials) + update + 10 * (4 * tangent + update))
    con, cost = 56 + 53 * ellipse, 43
    al = cost + con + 8 * n_con
    quads = 159 + 252 + 274 * ellipse
    iteration = N * (lin + 4725 + L * (54 + step)) + (N + 1) * (quads + L * al)
    al_round = cfg["ilqr_iters"] * iteration + (N + 1) * (al + con + 3 * n_con)
    return cfg["al_iters"] * al_round + N * step + (N + 1) * (cost + con + n_con)


def solve_bytes(cfg: dict, batch: int, table_len: int, itemsize: int, n_con: int = 14) -> int:
    """Bytes one launch for `batch` OCPs must move: z0, the warm start and
    the multipliers in, the inputs, trajectory, multipliers, cost and
    violation out, per OCP; the (4, n) table, the ladder and the scalars
    once."""
    N, L = cfg["horizon"], cfg["n_linesearch"]
    per_ocp = NZ + N * NU + (N + 1) * n_con + N * NU + (N + 1) * NZ + (N + 1) * n_con + 2
    return itemsize * (batch * per_ocp + 4 * table_len + L + N_SCAL)


def bound_ms(cfg: dict, batch: int, table_len: int, dtype: str, n_con: int = 14) -> float:
    """The least time of one launch: operations over the peak rate or bytes
    over the bandwidth, whichever is larger."""
    itemsize = 4 if dtype == "float32" else 8
    t_ops = batch * solve_flops(cfg, n_con) / FLOP_PER_S[dtype]
    t_bytes = solve_bytes(cfg, batch, table_len, itemsize, n_con) / HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes)

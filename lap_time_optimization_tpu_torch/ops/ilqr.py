"""The AL-iLQR solve of the horizon NMPC: one CUDA kernel for the whole solve.

Port of two Pallas TPU kernels of `lap_time_optimization_tpu/ops/`,
`pallas_ilqr.py::backward_forward` (one AL-iLQR iteration of one OCP) and
`pallas_ilqr_batch.py::backward_forward_batch` (the same for B OCPs, each
with its own Levenberg reg), and of the eager code around them in
`mpc/solver.py`: on the card one launch computes what `solver.solve` /
`solver.solve_batch` compute.

* `solve` — the wrapper.  CUDA tensors go to `csrc/ilqr.cu`'s
  `ilqr_solve_kernel` (CUDA C++ for sm_90a, one warp per OCP; see the note
  at the top of that file), compiled with the port's other kernels by one
  `nvcc` call at first use (`ops/_build.py`) and called through ctypes on
  PyTorch's current stream.  The (4, n) table sits in shared memory where
  it fits beside the OCPs' slices, and else in global memory; past what a
  block holds (one OCP's slice: horizon 160 in float32 and 79 in float64 at
  6 rungs) the scalars and the slices move, in the same layout, to a
  workspace in global memory that the wrapper allocates (`placement`).
  Where both placements in shared memory hold the launch, the one whose
  blocks fill the card's SMs in fewer waves runs it.  The same arithmetic
  runs in every placement, so they give the same bits, and any table
  length, horizon and ladder runs.  It raises if the kernel
  cannot be built or launched or the workspace cannot be allocated; there
  is no fallback.  CPU tensors go to the plain version, `solve_reference`.
* `solve_reference` — the same solve in plain PyTorch: `mpc/solver.py`'s
  `_solve` (AL rounds, accept/reject, reg escalation, multiplier update),
  whose iterations run `backward_forward_reference` /
  `backward_forward_batch_reference`: the Riccati scan and the ladder of
  the JAX package's XLA path (mpc/solver.py `_backward_pass` +
  `_forward_pass`), one function, `_reference`, over any leading instance
  shape.  These iteration twins are also what the JAX package's Pallas
  kernels are held against (tests/test_torch_ilqr*.py).

The solve's constants are packed once (`pack`: the lookup tables, the
ladder's step sizes and the scalar vector without rho and reg) by the
closed loop that runs many solves, or by `solver.solve` called alone.
Scalars ride in one vector (layout `SCAL_FIELDS`, the JAX kernel's plus
`ptv`, the torque-vectoring gain: 0 when the model has torque vectoring
off, so Mtv = ptv·(tan δ·vx/L − r) vanishes).  The constraint count (14,
or 16 with the friction-ellipse rows) is `lam_init.shape[-1]`.
"""

from __future__ import annotations

import ctypes
from types import SimpleNamespace
from typing import NamedTuple

import torch

from lap_time_optimization_tpu_torch.ops import _build
from lap_time_optimization_tpu_torch.utils import profiling

NX = 8
NU = 2
NZ = NX + NU
N_CON = 14

SCAL_FIELDS = (
    "rho", "reg", "s_max", "inv_ds", "h",  # h = dt / substeps
    "mass", "length_f", "length_r", "rot_inertia",
    "B_f", "C_f", "D_f", "B_r", "C_r", "D_r",
    "C_m", "Cr_0", "Cr_2",
    "q_n", "q_mu", "q_B", "r_delta", "r_throttle", "vref_scale",
    "mu_max", "steer_max", "throttle_max", "dsteer_max", "dthrottle_max",
    "half_len", "half_wid", "lateral_margin", "ptv",
)
_S = {name: i for i, name in enumerate(SCAL_FIELDS)}
NS = len(SCAL_FIELDS)

#: OCPs (warps) per block of the solve kernel: they share one copy of the
#: lookup table.  A launch of B OCPs takes min(WARPS, B), and fewer where
#: shared memory does not hold that many slices (long tables or horizons)
#: and the workspace is not needed.
WARPS = 4
MAX_WARPS = 4

_ENTRY = {torch.float32: "lto_ilqr_solve_f32", torch.float64: "lto_ilqr_solve_f64"}
_lib = None
#: `occupancy` by (device index, dtype, placement, N, L, n_con, n).
_OCCUPANCY: dict = {}


# ------------------------------------------------------------------ packing
def scal_tail(model, p, cfg) -> torch.Tensor:
    """`scal` without its first two entries (rho, reg), on the model's device
    and dtype.  Built from the model's buffers on the device (no upload);
    `pack` builds it once, and the plain solve splices rho and reg in per
    iteration."""
    veh, track = model.vehicle, model.track
    ref = track.k_vals
    n = ref.shape[0]
    ptv = veh.ptv if model.enable_torque_vectoring else torch.zeros_like(veh.ptv)
    vals = {
        "s_max": track.s_max,
        "inv_ds": (n - 1) / track.s_max,
        "h": torch.full((), cfg.dt / cfg.substeps, dtype=ref.dtype, device=ref.device),
        "mass": veh.mass, "length_f": veh.length_f, "length_r": veh.length_r,
        "rot_inertia": veh.rotational_inertia,
        "B_f": veh.B_f, "C_f": veh.C_f, "D_f": veh.D_f,
        "B_r": veh.B_r, "C_r": veh.C_r, "D_r": veh.D_r,
        "C_m": veh.C_m, "Cr_0": veh.Cr_0, "Cr_2": veh.Cr_2,
        "q_n": p.q_n, "q_mu": p.q_mu, "q_B": p.q_B,
        "r_delta": p.r_delta, "r_throttle": p.r_throttle, "vref_scale": p.vref_scale,
        "mu_max": p.mu_max, "steer_max": p.steer_max, "throttle_max": p.throttle_max,
        "dsteer_max": p.dsteer_max, "dthrottle_max": p.dthrottle_max,
        "half_len": 0.5 * (veh.length_f + veh.length_r),
        "half_wid": 0.5 * veh.width,
        "lateral_margin": p.lateral_margin,
        "ptv": ptv,
    }
    return torch.stack([vals[f].to(ref.dtype) for f in SCAL_FIELDS[2:]])


def scal_vector(model, p, cfg, rho, reg) -> torch.Tensor:
    """The full (NS,) scalar vector for given rho and reg."""
    tail = scal_tail(model, p, cfg)
    c = lambda v: torch.as_tensor(v, dtype=tail.dtype, device=tail.device).reshape(1)
    return torch.cat([c(rho), c(reg), tail])


def tables_matrix(model) -> torch.Tensor:
    """(4, n) stacked lookup tables: k, dist_left, dist_right, vref."""
    t = model.track
    return torch.stack([t.k_vals, t.nl_vals, t.nr_vals, t.vref_vals])


def ladder(n: int, dtype, device) -> torch.Tensor:
    """Line-search step sizes 10^linspace(0, -2.5, n), computed in float64."""
    return (10.0 ** torch.linspace(0.0, -2.5, n, dtype=torch.float64, device=device)).to(dtype)


# --------------------------------------------------------------- plain twin
def _views(scal, tables, n_con):
    """Model and OCP-parameter views over `scal`/`tables` for the solver's
    cost and dynamics functions (0-d views into `scal`, no copies)."""
    from lap_time_optimization_tpu_torch.models.bicycle import BicycleModel
    from lap_time_optimization_tpu_torch.mpc.track import MPCTrack

    f = {name: scal[i] for i, name in enumerate(SCAL_FIELDS)}
    veh = SimpleNamespace(
        mass=f["mass"], rotational_inertia=f["rot_inertia"],
        length_f=f["length_f"], length_r=f["length_r"], width=2.0 * f["half_wid"],
        B_f=f["B_f"], C_f=f["C_f"], D_f=f["D_f"], B_r=f["B_r"], C_r=f["C_r"], D_r=f["D_r"],
        C_m=f["C_m"], Cr_0=f["Cr_0"], Cr_2=f["Cr_2"], ptv=f["ptv"],
    )
    track = MPCTrack(k_vals=tables[0], nl_vals=tables[1], nr_vals=tables[2],
                     vref_vals=tables[3], s_max=f["s_max"])
    # ptv is 0 when the caller's model has torque vectoring off
    model = BicycleModel(veh, track, enable_torque_vectoring=True,
                         enable_traction_ellipse=(n_con == N_CON + 2))
    p = SimpleNamespace(**{k: f[k] for k in (
        "q_n", "q_mu", "q_B", "r_delta", "r_throttle", "vref_scale", "mu_max",
        "steer_max", "throttle_max", "dsteer_max", "dthrottle_max", "lateral_margin")})
    return model, p, f


def _reference(A, B, lz, lu, lzz, luu, luz, Vz, Vzz, zs, us, lams, tables, alphas, scal,
               reg, *, substeps: int):
    """The iteration in plain PyTorch for any leading instance shape `lead`
    (() for one OCP, (B,) for a batch): every per-instance argument carries
    it, `reg` has shape `lead`, and tables, alphas and scal are shared.

    Riccati sweep with the closed-form 2×2 Quu inverse and Levenberg reg;
    `ok` is 0 once a feedforward gain is non-finite.  Then every ladder rung
    rolls out, its AL cost is summed, NaN costs count as +inf, and the
    lowest-index rung among the minimal costs is returned (`torch.argmin`
    returns the first occurrence).  There is no Python loop over instances."""
    from lap_time_optimization_tpu_torch.mpc import solver

    N = us.shape[-2]
    lead = us.shape[:-2]
    rho = scal[_S["rho"]]
    T = lambda M: M.transpose(-1, -2)
    mv = lambda M, v: (M @ v.unsqueeze(-1)).squeeze(-1)
    Quu_reg_diag = reg[..., None, None] * torch.eye(NU, dtype=zs.dtype, device=zs.device)
    ok = torch.ones(lead, dtype=torch.bool, device=zs.device)
    ks, Ks = [None] * N, [None] * N
    for k in reversed(range(N)):
        A_k, B_k = A[..., k, :, :], B[..., k, :, :]
        Qz = lz[..., k, :] + mv(T(A_k), Vz)
        Qu = lu[..., k, :] + mv(T(B_k), Vz)
        Qzz = lzz[..., k, :, :] + T(A_k) @ Vzz @ A_k
        Quu = luu[..., k, :, :] + T(B_k) @ Vzz @ B_k
        Quz = luz[..., k, :, :] + T(B_k) @ Vzz @ A_k
        Quu_reg = Quu + Quu_reg_diag
        # NU = 2: invert the control Hessian in closed form (det/adjugate)
        a, b = Quu_reg[..., 0, 0], Quu_reg[..., 0, 1]
        c, d = Quu_reg[..., 1, 0], Quu_reg[..., 1, 1]
        det = a * d - b * c
        inv = torch.stack([torch.stack([d, -b], -1), torch.stack([-c, a], -1)], -2) / det[..., None, None]
        kK = inv @ torch.cat([Qu.unsqueeze(-1), Quz], dim=-1)
        k_k, K_k = -kK[..., 0], -kK[..., 1:]
        Vz = Qz + mv(T(K_k) @ Quu, k_k) + mv(T(K_k), Qu) + mv(T(Quz), k_k)
        Vzz = Qzz + T(K_k) @ Quu @ K_k + T(K_k) @ Quz + T(Quz) @ K_k
        Vzz = 0.5 * (Vzz + T(Vzz))
        ok = ok & torch.isfinite(k_k).all(dim=-1)
        ks[k], Ks[k] = k_k, K_k

    model, p, f = _views(scal, tables, lams.shape[-1])
    L = alphas.shape[0]
    z = zs[..., :1, :].expand(lead + (L, NZ))
    z_rungs, u_rungs = [z], []
    for k in range(N):
        dz = z - zs[..., k:k + 1, :]
        u = us[..., k:k + 1, :] + alphas[:, None] * ks[k].unsqueeze(-2) + dz @ T(Ks[k])
        z = torch.cat([model.rk4(z[..., :NX], u, f["h"], substeps), u], dim=-1)
        z_rungs.append(z)
        u_rungs.append(u)
    zs_l = torch.stack(z_rungs, dim=-2)  # lead + (L, N+1, NZ)
    us_l = torch.stack(u_rungs, dim=-2)  # lead + (L, N, NU)
    costs = solver._total_al_cost(model, p, zs_l, us_l, lams.unsqueeze(-3), rho)  # lead + (L,)
    costs = torch.where(torch.isfinite(costs), costs, torch.inf)
    best = torch.argmin(costs, dim=-1, keepdim=True)
    pick = lambda t: torch.take_along_dim(t, best[..., None, None], dim=-3).squeeze(-3)
    cost = torch.take_along_dim(costs, best, dim=-1).squeeze(-1)
    return pick(zs_l), pick(us_l), cost, ok.to(zs.dtype)


def backward_forward_reference(A, B, lz, lu, lzz, luu, luz, Vz, Vzz,
                               zs, us, lams, tables, alphas, scal, *, substeps: int):
    """One AL-iLQR iteration of one OCP in plain PyTorch, with the signature
    and semantics of the JAX package's Pallas kernel `backward_forward`
    (see `_reference`); reg is the `reg` entry of `scal`.
    Returns (zs (N+1,NZ), us (N,NU), cost (), ok ())."""
    return _reference(A, B, lz, lu, lzz, luu, luz, Vz, Vzz, zs, us, lams, tables, alphas,
                      scal, scal[_S["reg"]], substeps=substeps)


def backward_forward_batch_reference(A, B, lz, lu, lzz, luu, luz, Vz, Vzz, zs, us, lams,
                                     tables, alphas, scal, reg_b, *, substeps: int):
    """One AL-iLQR iteration of B OCPs in plain PyTorch, with the signature
    and semantics of the JAX package's Pallas kernel `backward_forward_batch`
    (see `_reference`): instance b runs with reg = reg_b[b], and the
    `reg` entry of `scal` is ignored.  Returns (zs (B,N+1,NZ), us (B,N,NU),
    cost (B,), ok (B,))."""
    return _reference(A, B, lz, lu, lzz, luu, luz, Vz, Vzz, zs, us, lams, tables, alphas,
                      scal, reg_b, substeps=substeps)


class Pack(NamedTuple):
    """The solve's constants on the model's device and dtype: the (4, n)
    lookup tables, the ladder's step sizes (L,) and the scalar vector
    without rho and reg (NS - 2,).  Built by `pack` once per closed loop
    (and by `solver.solve` called alone); nothing caches it beyond that
    call, so a model with other flags never reads another model's pack."""
    tables: torch.Tensor
    alphas: torch.Tensor
    scal_tail: torch.Tensor


def pack(model, p, cfg) -> Pack:
    """Pack `model`'s tables, `cfg`'s ladder and the scalars of `model`,
    `p` and `cfg` (about 40 small device ops)."""
    ref = model.track.k_vals
    return Pack(tables_matrix(model).contiguous(), ladder(cfg.n_linesearch, ref.dtype, ref.device),
                scal_tail(model, p, cfg))


# --------------------------------------------------------------- plain solve
def solve_reference(model, p, cfg, z0, us_init, lam_init, pk: Pack):
    """The solve in plain PyTorch (`solver._solve` over the iteration
    twins), for one OCP (z0 (NZ,)) or a batch (z0 (B, NZ)).  Returns
    (us, zs, lam, cost, max_violation) as `solver.SolveResult`."""
    from lap_time_optimization_tpu_torch.mpc import solver

    return solver._solve(model, p, cfg, z0, us_init, lam_init, pk)


# ------------------------------------------------------------------- kernel
def build():
    """Build the kernel library (`ops/_build.py`, one nvcc process per
    source, in parallel) and bind the solve's entry points."""
    global _lib
    if _lib is None:
        lib = _build.load()
        _build.bind(lib, _ENTRY.values(), 12, 10, 3)
        lib.lto_ilqr_solve_smem_bytes.argtypes = [ctypes.c_int] * 7
        lib.lto_ilqr_solve_smem_bytes.restype = ctypes.c_longlong
        lib.lto_ilqr_solve_workspace_elems.argtypes = [ctypes.c_int] * 4
        lib.lto_ilqr_solve_workspace_elems.restype = ctypes.c_longlong
        lib.lto_ilqr_solve_blocks_per_sm.argtypes = [ctypes.c_int] * 8
        lib.lto_ilqr_solve_blocks_per_sm.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check_solve(cfg, z0, us_init, lam_init, pk: Pack):
    """Raise on what the solve kernel does not take (before any build);
    returns the leading instance shape, () or (B,)."""
    if cfg.hessian_mode != "gauss_newton":
        raise NotImplementedError(
            f"hessian_mode={cfg.hessian_mode!r}: the solve kernel is Gauss-Newton only; "
            "exact Hessians run on mpc.solver's plain path (solver._solve)")
    if z0.dtype not in _ENTRY:
        raise TypeError(f"the solve kernel takes float32 or float64, not {z0.dtype}")
    if z0.dim() not in (1, 2):
        raise ValueError(f"z0: shape {tuple(z0.shape)}, expected (NZ,) or (B, NZ)")
    lead = tuple(z0.shape[:-1])
    N, L, n_con = cfg.horizon, cfg.n_linesearch, lam_init.shape[-1]
    shapes = {"z0": lead + (NZ,), "us_init": lead + (N, NU), "lam_init": lead + (N + 1, n_con),
              "tables": (4, pk.tables.shape[-1]), "alphas": (L,), "scal_tail": (NS - 2,)}
    tensors = {"z0": z0, "us_init": us_init, "lam_init": lam_init, **pk._asdict()}
    for name, t in tensors.items():
        if t.device != z0.device or t.dtype != z0.dtype:
            raise ValueError(f"{name}: {t.dtype} on {t.device}, expected {z0.dtype} on {z0.device}")
        if tuple(t.shape) != shapes[name]:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shapes[name]}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if n_con not in (N_CON, N_CON + 2):
        raise ValueError(f"unsupported constraint count {n_con}")
    if lead and lead[0] < 1:
        raise ValueError(f"unsupported batch size {lead[0]}")
    if (L < 1 or N < 1 or pk.tables.shape[-1] < 2 or cfg.substeps < 1
            or cfg.al_iters < 0 or cfg.ilqr_iters < 0):
        raise ValueError(f"unsupported sizes N={N} L={L} n={pk.tables.shape[-1]} "
                         f"substeps={cfg.substeps} al_iters={cfg.al_iters} ilqr_iters={cfg.ilqr_iters}")
    return lead


def smem_bytes(dtype, warps: int, N: int, L: int, n_con: int, n: int,
               global_table: bool = False) -> int:
    """Dynamic shared memory of a block of `warps` OCPs with the table in
    shared or (`global_table`) global memory (0: refused, or past a block)."""
    return int(build().lto_ilqr_solve_smem_bytes(torch.empty((), dtype=dtype).element_size(),
                                                 warps, N, L, n_con, n, int(global_table)))


def workspace_elems(warps: int, N: int, L: int, n_con: int) -> int:
    """Elements of one block's part of the workspace placement's workspace:
    the scalars and `warps` OCP slices (0: refused)."""
    return int(build().lto_ilqr_solve_workspace_elems(warps, N, L, n_con))


class Placement(NamedTuple):
    """Where a launch keeps its data: OCPs per block, the table in global
    memory, and the scalars and slices in the global workspace (in the
    layout they have in shared memory)."""
    warps: int
    global_table: bool
    workspace: bool

    @property
    def name(self) -> str:
        """Where the table lives, "shared" or "global", or "workspace" for
        the workspace placement."""
        return "workspace" if self.workspace else "global" if self.global_table else "shared"


def waves(B: int, warps: int, sms: int, blocks: int) -> int:
    """Waves of a launch of B OCPs, `warps` a block, on `sms` SMs that hold
    `blocks` blocks each at once: ⌈⌈B / warps⌉ / (sms · blocks)⌉."""
    grid = -(-B // warps)
    return -(-grid // (sms * blocks))


def fewest_waves(B: int, candidates) -> Placement:
    """Of `candidates`, (placement, SMs, blocks per SM) in order of
    preference, the first that runs a launch of B OCPs in the fewest
    waves."""
    return min(candidates, key=lambda c: waves(B, c[0].warps, c[1], c[2]))[0]


def occupancy(dtype, where: Placement, N: int, L: int, n_con: int, n: int, device=None) -> tuple[int, int]:
    """(SMs, blocks per SM) of placement `where` on `device` (default: the
    current card): the card's SM count and `blocks_per_sm`, queried once
    per (device, dtype, placement, N, L, n_con, n)."""
    device = torch.device("cuda") if device is None else torch.device(device)
    index = torch.cuda.current_device() if device.index is None else device.index
    key = (index, dtype, where, N, L, n_con, n)
    if key not in _OCCUPANCY:
        with torch.cuda.device(index):
            _OCCUPANCY[key] = (torch.cuda.get_device_properties(index).multi_processor_count,
                               blocks_per_sm(dtype, where, N, L, n_con, n))
    return _OCCUPANCY[key]


def candidates(dtype, warps: int, N: int, L: int, n_con: int, n: int) -> dict[str, Placement]:
    """Every placement the kernel takes at these sizes, by `Placement.name`:
    "shared" (the table and the slices in shared memory) and "global" (the
    table in global memory, the slices in shared memory), each with the most
    OCPs per block up to `warps` that fit, where one fits; "workspace"
    (table, scalars and slices in global memory, `warps` OCPs per block)
    wherever an OCP's slice fits the kernel's 32-bit indices."""
    found = {}
    for global_table in (False, True):
        W = next((w for w in range(warps, 0, -1) if smem_bytes(dtype, w, N, L, n_con, n, global_table)), 0)
        if W:
            where = Placement(W, global_table, False)
            found[where.name] = where
    if workspace_elems(warps, N, L, n_con):
        found["workspace"] = Placement(warps, True, True)
    return found


def placement(dtype, warps: int, N: int, L: int, n_con: int, n: int, B: int = 1, device=None) -> Placement:
    """Where a launch of B OCPs runs on `device` (default: the current
    card), of its `candidates`: of "shared" and "global", those that fit,
    the one that runs the launch in the fewest waves (`fewest_waves`, from
    `occupancy`), the first where they tie: at B = 1 and wherever the
    blocks fit the card at once, the shared one.  Where neither fits, the
    workspace.  Raises where the kernel takes none: an OCP's slice past its
    32-bit indices."""
    found = candidates(dtype, warps, N, L, n_con, n)
    fits = [found[name] for name in ("shared", "global") if name in found]
    if len(fits) > 1:
        return fewest_waves(B, [(where, *occupancy(dtype, where, N, L, n_con, n, device)) for where in fits])
    if fits:
        return fits[0]
    if "workspace" in found:
        return found["workspace"]
    raise ValueError(f"the solve kernel does not take N={N} L={L} n_con={n_con} with {warps} OCPs per "
                     "block: an OCP's slice would pass its 32-bit indices")


def blocks_per_sm(dtype, where: Placement, N: int, L: int, n_con: int, n: int) -> int:
    """Blocks of `where.warps` OCPs in placement `where` that one SM of the
    current card holds at once, at the launch's dynamic shared memory
    (`cudaOccupancyMaxActiveBlocksPerMultiprocessor`)."""
    rc = build().lto_ilqr_solve_blocks_per_sm(torch.empty((), dtype=dtype).element_size(), where.warps, N, L,
                                              n_con, n, int(where.global_table), int(where.workspace))
    if rc < 0:
        raise RuntimeError(f"the solve kernel's occupancy for {where} N={N} L={L} n_con={n_con} n={n}: "
                           f"cudaError_t {-rc}")
    return rc


def _launch(cfg, z0, us_init, lam_init, pk: Pack, where: Placement | None = None):
    """Check, allocate the outputs (and the workspace where the placement
    needs one), launch the solve kernel on the current stream in the
    placement `placement` picks for B OCPs on z0's card, with at most
    min(WARPS, B) OCPs per block, or in `where` as given (one of
    `candidates`), and count the launch as "ilqr.solve" and by its
    placement as "ilqr.solve.<name>"."""
    lead = _check_solve(cfg, z0, us_init, lam_init, pk)
    B = lead[0] if lead else 1
    N, L, n_con, n = cfg.horizon, cfg.n_linesearch, lam_init.shape[-1], pk.tables.shape[-1]
    lib = build()
    if where is None:
        where = placement(z0.dtype, min(WARPS, B), N, L, n_con, n, B, z0.device)
    if not 1 <= where.warps <= MAX_WARPS:
        raise ValueError(f"warps={where.warps}: the kernel takes 1 to {MAX_WARPS} OCPs per block")
    new = lambda *shape: torch.empty(lead + shape, dtype=z0.dtype, device=z0.device)
    outs = (new(N, NU), new(N + 1, NZ), new(N + 1, n_con), new(), new())
    ws_ptr = None
    if where.workspace:
        elems = -(-B // where.warps) * workspace_elems(where.warps, N, L, n_con)
        try:
            ws = torch.empty(elems, dtype=z0.dtype, device=z0.device)
        except torch.cuda.OutOfMemoryError as exc:
            raise RuntimeError(
                f"the solve kernel's workspace for B={B} N={N} L={L} n_con={n_con} "
                f"({elems * z0.element_size()} bytes) cannot be allocated on {z0.device}") from exc
        ws_ptr = ws.data_ptr()
    ptrs = [t.data_ptr() for t in (z0, us_init, lam_init, *pk, *outs)]
    with torch.cuda.device(z0.device):
        stream = torch.cuda.current_stream(z0.device).cuda_stream
        rc = getattr(lib, _ENTRY[z0.dtype])(
            *ptrs, ws_ptr, B, where.warps, N, L, n_con, n, cfg.substeps, cfg.al_iters,
            cfg.ilqr_iters, int(where.global_table), float(cfg.rho_init), float(cfg.rho_scale),
            float(cfg.reg_init), stream)
    if rc != 0:
        raise RuntimeError(f"solve kernel launch failed: cudaError_t {rc}")
    profiling.count("ilqr.solve")
    profiling.count(f"ilqr.solve.{where.name}")
    return outs


def solve(model, p, cfg, z0, us_init, lam_init, pk: Pack):
    """The AL-iLQR solve from z0 (NZ,) or (B, NZ), warm-started at us_init
    (..., N, NU) and lam_init (..., N+1, n_con), with the constants `pk`
    (`pack(model, p, cfg)`).  Returns (us, zs, lam, cost, max_violation),
    each with z0's leading shape.  CUDA tensors: one launch of the solve
    kernel; CPU tensors: `solve_reference`."""
    if z0.device.type == "cuda":
        if lam_init.shape[-1] != (N_CON + 2 if model.enable_traction_ellipse else N_CON):
            raise ValueError(f"lam_init has {lam_init.shape[-1]} rows; the model's constraint "
                             f"set has {N_CON + 2 * model.enable_traction_ellipse}")
        return _launch(cfg, z0, us_init, lam_init, pk)
    if z0.device.type == "cpu":
        return tuple(solve_reference(model, p, cfg, z0, us_init, lam_init, pk))
    raise ValueError(f"no solve implementation for device {z0.device}")

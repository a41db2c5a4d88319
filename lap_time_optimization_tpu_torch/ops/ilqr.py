"""One fused AL-iLQR iteration: Riccati backward sweep + line-search ladder.

Port of two Pallas TPU kernels of `lap_time_optimization_tpu/ops/`:
`pallas_ilqr.py::backward_forward` (one OCP) and
`pallas_ilqr_batch.py::backward_forward_batch` (B independent OCPs, each
with its own Levenberg reg).  Each has two implementations with one
signature:

* `csrc/ilqr.cu` — CUDA C++ for sm_90a, one thread block per OCP
  (see the note at the top of that file).  Compiled with the port's other
  kernels by one `nvcc` call at first use (`ops/_build.py`), and called
  through ctypes on PyTorch's current stream.
* `backward_forward_reference` / `backward_forward_batch_reference` — the
  same computation in plain PyTorch (one function, `_reference`, over any
  leading instance shape): the Riccati scan and the ladder of the JAX
  package's XLA path (mpc/solver.py `_backward_pass` + `_forward_pass`).

`backward_forward` and `backward_forward_batch` dispatch on the tensors'
device: CPU tensors go to the plain version, CUDA tensors to the kernel,
which raises if it cannot be built or launched.  There is no fallback from
CUDA to the plain version.

Scalars ride in one vector `scal` (layout `SCAL_FIELDS`, the JAX kernel's
plus `ptv`, the torque-vectoring gain: 0 when the model has torque
vectoring off, so Mtv = ptv·(tan δ·vx/L − r) vanishes).  The constraint
count (14, or 16 with the friction-ellipse rows) is `lams.shape[-1]`.
"""

from __future__ import annotations

from types import SimpleNamespace

import torch

from lap_time_optimization_tpu_torch.ops import _build

NX = 8
NU = 2
NZ = NX + NU
N_CON = 14
MAX_LADDER = 128  # one thread per rung in a 128-thread block

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

#: Launches of the one-OCP kernel and of the batch kernel so far; a run
#: resets them to count its own.
LAUNCHES = 0
BATCH_LAUNCHES = 0

_ENTRY = {torch.float32: "lto_ilqr_backward_forward_f32",
          torch.float64: "lto_ilqr_backward_forward_f64"}
_ENTRY_BATCH = {torch.float32: "lto_ilqr_backward_forward_batch_f32",
                torch.float64: "lto_ilqr_backward_forward_batch_f64"}
_lib = None


# ------------------------------------------------------------------ packing
def scal_tail(model, p, cfg) -> torch.Tensor:
    """`scal` without its first two entries (rho, reg), on the model's device
    and dtype.  Built from the model's buffers on the device (no upload);
    a solve builds it once and splices rho and reg in per iteration."""
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
    """Plain PyTorch version of the one-OCP kernel, same signature and
    semantics (see `_reference`); reg is the `reg` entry of `scal`.
    Returns (zs (N+1,NZ), us (N,NU), cost (), ok ())."""
    return _reference(A, B, lz, lu, lzz, luu, luz, Vz, Vzz, zs, us, lams, tables, alphas,
                      scal, scal[_S["reg"]], substeps=substeps)


def backward_forward_batch_reference(A, B, lz, lu, lzz, luu, luz, Vz, Vzz, zs, us, lams,
                                     tables, alphas, scal, reg_b, *, substeps: int):
    """Plain PyTorch version of the batch kernel, same signature and
    semantics (see `_reference`): instance b runs with reg = reg_b[b], and the
    `reg` entry of `scal` is ignored.  Returns (zs (B,N+1,NZ), us (B,N,NU),
    cost (B,), ok (B,))."""
    return _reference(A, B, lz, lu, lzz, luu, luz, Vz, Vzz, zs, us, lams, tables, alphas,
                      scal, reg_b, substeps=substeps)


# ------------------------------------------------------------------- kernel
def build():
    """Build the kernel library (`ops/_build.py`, one nvcc call for every
    source) and bind the iLQR entry points."""
    global _lib
    if _lib is None:
        lib = _build.load()
        _build.bind(lib, _ENTRY.values(), 19, 5)
        _build.bind(lib, _ENTRY_BATCH.values(), 20, 6)
        _lib = lib
    return _lib


_SHARED = ("tables", "alphas", "scal")


def _check_inputs(tensors: dict, N: int, L: int, n_con: int, n_table: int, substeps: int,
                  batch: int | None = None):
    """Raise on what the kernels do not take.  With `batch`, every argument
    but the shared tables, alphas and scal has a leading axis of that size,
    and `reg_b` has shape (batch,)."""
    ref = tensors["zs"]
    if ref.dtype not in _ENTRY:
        raise TypeError(f"the iLQR kernel takes float32 or float64, not {ref.dtype}")
    shapes = {
        "A": (N, NZ, NZ), "B": (N, NZ, NU), "lz": (N, NZ), "lu": (N, NU),
        "lzz": (N, NZ, NZ), "luu": (N, NU, NU), "luz": (N, NU, NZ),
        "Vz": (NZ,), "Vzz": (NZ, NZ), "zs": (N + 1, NZ), "us": (N, NU),
        "lams": (N + 1, n_con), "tables": (4, n_table), "alphas": (L,), "scal": (NS,),
    }
    if batch is not None:
        if batch < 1:
            raise ValueError(f"unsupported batch size {batch}")
        shapes = {k: v if k in _SHARED else (batch, *v) for k, v in shapes.items()}
        shapes["reg_b"] = (batch,)
    if set(tensors) != set(shapes):
        raise ValueError(f"arguments {sorted(tensors)}, expected {sorted(shapes)}")
    for name, t in tensors.items():
        if t.device != ref.device or t.dtype != ref.dtype:
            raise ValueError(f"{name}: {t.dtype} on {t.device}, expected {ref.dtype} on {ref.device}")
        if tuple(t.shape) != shapes[name]:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shapes[name]}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if n_con not in (N_CON, N_CON + 2):
        raise ValueError(f"unsupported constraint count {n_con}")
    if not (1 <= L <= MAX_LADDER) or N < 1 or n_table < 2 or substeps < 1:
        raise ValueError(f"unsupported sizes N={N} L={L} n={n_table} substeps={substeps}")


def _launch(inputs: dict, substeps: int, batch: int | None = None):
    """Check `inputs` (in the C entry points' argument order), allocate the
    outputs, launch the one-OCP kernel (`batch` None) or the batch kernel on
    the current stream, and count the launch."""
    global LAUNCHES, BATCH_LAUNCHES
    zs, us, lams, tables, alphas = (inputs[k] for k in ("zs", "us", "lams", "tables", "alphas"))
    N, L, n_con, n_table = us.shape[-2], alphas.shape[0], lams.shape[-1], tables.shape[-1]
    _check_inputs(inputs, N, L, n_con, n_table, substeps, batch)
    lead = () if batch is None else (batch,)
    fn = getattr(build(), (_ENTRY if batch is None else _ENTRY_BATCH)[zs.dtype])
    new = lambda *shape: torch.empty(lead + shape, dtype=zs.dtype, device=zs.device)
    outs = (new(N + 1, NZ), new(N, NU), new(), new())
    ptrs = [t.data_ptr() for t in (*inputs.values(), *outs)]
    sizes = (N, L, n_con, n_table, substeps) if batch is None else (batch, N, L, n_con, n_table, substeps)
    with torch.cuda.device(zs.device):
        stream = torch.cuda.current_stream(zs.device).cuda_stream
        rc = fn(*ptrs, *sizes, stream)
    if rc != 0:
        raise RuntimeError(f"iLQR kernel launch failed: cudaError_t {rc}")
    if batch is None:
        LAUNCHES += 1
    else:
        BATCH_LAUNCHES += 1
    return outs


def backward_forward(A, B, lz, lu, lzz, luu, luz, Vz, Vzz,
                     zs, us, lams, tables, alphas, scal, *, substeps: int):
    """One fused iLQR iteration.  Inputs: stage Jacobians A (N,NZ,NZ),
    B (N,NZ,NU); AL quads lz, lu, lzz, luu, luz; terminal Vz, Vzz; reference
    trajectory zs (N+1,NZ), us (N,NU); multipliers lams (N+1,n_con); tables
    (4,n); ladder alphas (L,); scal (NS,).  Returns (zs_new, us_new, cost,
    ok) with ok = 1.0 while the backward pass stayed finite."""
    if zs.device.type == "cuda":
        inputs = dict(A=A, B=B, lz=lz, lu=lu, lzz=lzz, luu=luu, luz=luz, Vz=Vz, Vzz=Vzz,
                      zs=zs, us=us, lams=lams, tables=tables, alphas=alphas, scal=scal)
        return _launch(inputs, substeps)
    if zs.device.type == "cpu":
        return backward_forward_reference(A, B, lz, lu, lzz, luu, luz, Vz, Vzz, zs, us,
                                          lams, tables, alphas, scal, substeps=substeps)
    raise ValueError(f"no iLQR implementation for device {zs.device}")


def backward_forward_batch(A, B, lz, lu, lzz, luu, luz, Vz, Vzz,
                           zs, us, lams, tables, alphas, scal, reg_b, *, substeps: int):
    """One fused iLQR iteration for B independent OCPs.  Batch-major
    inputs: A (B,N,NZ,NZ), B (B,N,NZ,NU), lz (B,N,NZ), lu (B,N,NU),
    lzz (B,N,NZ,NZ), luu (B,N,NU,NU), luz (B,N,NU,NZ), Vz (B,NZ),
    Vzz (B,NZ,NZ), zs (B,N+1,NZ), us (B,N,NU), lams (B,N+1,n_con) and the
    per-instance Levenberg reg_b (B,); shared: tables (4,n), alphas (L,) and
    scal (NS,), whose `reg` entry is ignored.  Returns (zs_new (B,N+1,NZ),
    us_new (B,N,NU), cost (B,), ok (B,)).

    The whole table is read by every instance, so unlike the JAX package's
    batch kernel there is no table window: instance b gives what
    `backward_forward` gives on it with reg = reg_b[b]."""
    if zs.device.type == "cuda":
        inputs = dict(A=A, B=B, lz=lz, lu=lu, lzz=lzz, luu=luu, luz=luz, Vz=Vz, Vzz=Vzz,
                      zs=zs, us=us, lams=lams, tables=tables, alphas=alphas, scal=scal,
                      reg_b=reg_b)
        return _launch(inputs, substeps, batch=zs.shape[0])
    if zs.device.type == "cpu":
        return backward_forward_batch_reference(A, B, lz, lu, lzz, luu, luz, Vz, Vzz, zs, us,
                                                lams, tables, alphas, scal, reg_b,
                                                substeps=substeps)
    raise ValueError(f"no iLQR implementation for device {zs.device}")

"""One fused AL-iLQR iteration: Riccati backward sweep + line-search ladder.

Port of `lap_time_optimization_tpu/ops/pallas_ilqr.py::backward_forward`
(the Pallas TPU kernel).  Two implementations with one signature:

* `csrc/ilqr.cu` — CUDA C++ for sm_90a, one thread block per OCP
  (see the note at the top of that file).  Compiled with `nvcc` at first
  use into `build/torch_kernels/`, keyed by a hash of the source and flags,
  and called through ctypes on PyTorch's current stream.
* `backward_forward_reference` — the same computation in plain PyTorch:
  the Riccati scan and the ladder of the JAX package's XLA path
  (mpc/solver.py `_backward_pass` + `_forward_pass`).

`backward_forward` dispatches on the tensors' device: CPU tensors go to the
plain version, CUDA tensors to the kernel, which raises if it cannot be
built or launched.  There is no fallback from CUDA to the plain version.

Scalars ride in one vector `scal` (layout `SCAL_FIELDS`, the JAX kernel's
plus `ptv`, the torque-vectoring gain: 0 when the model has torque
vectoring off, so Mtv = ptv·(tan δ·vx/L − r) vanishes).  The constraint
count (14, or 16 with the friction-ellipse rows) is `lams.shape[1]`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from types import SimpleNamespace

import torch

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

#: Kernel launches so far; a run resets it to count its own.
LAUNCHES = 0

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG_DIR, "csrc", "ilqr.cu")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "torch_kernels")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
_ENTRY = {torch.float32: "lto_ilqr_backward_forward_f32",
          torch.float64: "lto_ilqr_backward_forward_f64"}
_lib = None
#: nvcc's output from the build in this process ("" if the library was cached).
BUILD_LOG = ""


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


def backward_forward_reference(A, B, lz, lu, lzz, luu, luz, Vz, Vzz,
                               zs, us, lams, tables, alphas, scal, *, substeps: int):
    """Plain PyTorch version of the kernel, same signature and semantics.

    Riccati sweep with the closed-form 2×2 Quu inverse and Levenberg reg;
    `ok` is 0 once a feedforward gain is non-finite.  Then every ladder rung
    rolls out, its AL cost is summed, NaN costs count as +inf, and the
    lowest-index rung among the minimal costs is returned (`torch.argmin`
    returns the first occurrence).  Returns (zs (N+1,NZ), us (N,NU), cost (),
    ok ())."""
    from lap_time_optimization_tpu_torch.mpc import solver

    N = us.shape[0]
    rho, reg = scal[_S["rho"]], scal[_S["reg"]]
    I_u = torch.eye(NU, dtype=zs.dtype, device=zs.device)
    ok = torch.ones((), dtype=torch.bool, device=zs.device)
    ks, Ks = [None] * N, [None] * N
    for k in reversed(range(N)):
        A_k, B_k = A[k], B[k]
        Qz = lz[k] + A_k.T @ Vz
        Qu = lu[k] + B_k.T @ Vz
        Qzz = lzz[k] + A_k.T @ Vzz @ A_k
        Quu = luu[k] + B_k.T @ Vzz @ B_k
        Quz = luz[k] + B_k.T @ Vzz @ A_k
        Quu_reg = Quu + reg * I_u
        # NU = 2: invert the control Hessian in closed form (det/adjugate)
        a, b = Quu_reg[0, 0], Quu_reg[0, 1]
        c, d = Quu_reg[1, 0], Quu_reg[1, 1]
        det = a * d - b * c
        inv = torch.stack([torch.stack([d, -b]), torch.stack([-c, a])]) / det
        kK = inv @ torch.cat([Qu[:, None], Quz], dim=1)
        k_k, K_k = -kK[:, 0], -kK[:, 1:]
        Vz = Qz + K_k.T @ Quu @ k_k + K_k.T @ Qu + Quz.T @ k_k
        Vzz = Qzz + K_k.T @ Quu @ K_k + K_k.T @ Quz + Quz.T @ K_k
        Vzz = 0.5 * (Vzz + Vzz.T)
        ok = ok & torch.isfinite(k_k).all()
        ks[k], Ks[k] = k_k, K_k

    model, p, f = _views(scal, tables, lams.shape[1])
    L = alphas.shape[0]
    z = zs[0].expand(L, NZ)
    z_rungs, u_rungs = [z], []
    for k in range(N):
        u = us[k] + alphas[:, None] * ks[k] + (z - zs[k]) @ Ks[k].T
        z = torch.cat([model.rk4(z[:, :NX], u, f["h"], substeps), u], dim=-1)
        z_rungs.append(z)
        u_rungs.append(u)
    zs_b = torch.stack(z_rungs, dim=1)  # (L, N+1, NZ)
    us_b = torch.stack(u_rungs, dim=1)  # (L, N, NU)
    costs = solver._total_al_cost(model, p, zs_b, us_b, lams, rho)
    costs = torch.where(torch.isfinite(costs), costs, torch.inf)
    best = torch.argmin(costs)
    return zs_b[best], us_b[best], costs[best], ok.to(zs.dtype)


# ------------------------------------------------------------------- kernel
def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        cand = os.path.join(CUDA_HOME, "bin", "nvcc")
        if os.path.isfile(cand):
            return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA iLQR kernel cannot be built")
    return found


def build():
    """Compile `csrc/ilqr.cu` (once per source hash) and load it."""
    global _lib, BUILD_LOG
    if _lib is not None:
        return _lib
    with open(SOURCE, "rb") as fh:
        src = fh.read()
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    so = os.path.join(BUILD_DIR, f"ilqr_{key}.so")
    if not os.path.isfile(so):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{so}.{os.getpid()}.tmp"
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, SOURCE],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {SOURCE}:\n{proc.stdout}{proc.stderr}")
        BUILD_LOG = proc.stdout + proc.stderr
        os.replace(tmp, so)
    lib = ctypes.CDLL(so)
    for name in _ENTRY.values():
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * 19 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    _lib = lib
    return lib


def _check_inputs(tensors: dict, N: int, L: int, n_con: int, n_table: int, substeps: int):
    ref = tensors["zs"]
    if ref.dtype not in _ENTRY:
        raise TypeError(f"the iLQR kernel takes float32 or float64, not {ref.dtype}")
    shapes = {
        "A": (N, NZ, NZ), "B": (N, NZ, NU), "lz": (N, NZ), "lu": (N, NU),
        "lzz": (N, NZ, NZ), "luu": (N, NU, NU), "luz": (N, NU, NZ),
        "Vz": (NZ,), "Vzz": (NZ, NZ), "zs": (N + 1, NZ), "us": (N, NU),
        "lams": (N + 1, n_con), "tables": (4, n_table), "alphas": (L,), "scal": (NS,),
    }
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


def _launch(A, B, lz, lu, lzz, luu, luz, Vz, Vzz, zs, us, lams, tables, alphas, scal, *, substeps):
    global LAUNCHES
    inputs = dict(A=A, B=B, lz=lz, lu=lu, lzz=lzz, luu=luu, luz=luz, Vz=Vz, Vzz=Vzz,
                  zs=zs, us=us, lams=lams, tables=tables, alphas=alphas, scal=scal)
    N, L, n_con, n_table = us.shape[0], alphas.shape[0], lams.shape[-1], tables.shape[-1]
    _check_inputs(inputs, N, L, n_con, n_table, substeps)
    fn = getattr(build(), _ENTRY[zs.dtype])
    zs_out = torch.empty((N + 1, NZ), dtype=zs.dtype, device=zs.device)
    us_out = torch.empty((N, NU), dtype=zs.dtype, device=zs.device)
    cost = torch.empty((), dtype=zs.dtype, device=zs.device)
    ok = torch.empty((), dtype=zs.dtype, device=zs.device)
    ptrs = [t.data_ptr() for t in (*inputs.values(), zs_out, us_out, cost, ok)]
    with torch.cuda.device(zs.device):
        stream = torch.cuda.current_stream(zs.device).cuda_stream
        rc = fn(*ptrs, N, L, n_con, n_table, substeps, stream)
    if rc != 0:
        raise RuntimeError(f"iLQR kernel launch failed: cudaError_t {rc}")
    LAUNCHES += 1
    return zs_out, us_out, cost, ok


def backward_forward(A, B, lz, lu, lzz, luu, luz, Vz, Vzz,
                     zs, us, lams, tables, alphas, scal, *, substeps: int):
    """One fused iLQR iteration.  Inputs: stage Jacobians A (N,NZ,NZ),
    B (N,NZ,NU); AL quads lz, lu, lzz, luu, luz; terminal Vz, Vzz; reference
    trajectory zs (N+1,NZ), us (N,NU); multipliers lams (N+1,n_con); tables
    (4,n); ladder alphas (L,); scal (NS,).  Returns (zs_new, us_new, cost,
    ok) with ok = 1.0 while the backward pass stayed finite."""
    if zs.device.type == "cuda":
        return _launch(A, B, lz, lu, lzz, luu, luz, Vz, Vzz, zs, us, lams, tables,
                       alphas, scal, substeps=substeps)
    if zs.device.type == "cpu":
        return backward_forward_reference(A, B, lz, lu, lzz, luu, luz, Vz, Vzz, zs, us,
                                          lams, tables, alphas, scal, substeps=substeps)
    raise ValueError(f"no iLQR implementation for device {zs.device}")

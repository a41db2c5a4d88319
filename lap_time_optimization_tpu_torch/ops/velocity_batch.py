"""Fused batched velocity-profile solve (both sweeps, forward only).

Port of the Pallas TPU kernel `lap_time_optimization_tpu/ops/pallas_velocity.py`
(`_fused_solve` :176, entry `solve_profile_batch` :229, packing
`_pack_vehicle` :131): the 3-pass quasi-static profile of B candidates at
once, for the racing-line searches' batched forward evaluation
(`optim/global_search._batch_lap_times(solver="fused")`).  Two
implementations with one signature:

* `csrc/velocity.cu` — CUDA C++ for sm_90a (see the note at the top of that
  file), built with the port's other kernels at first use (`ops/_build.py`)
  and called through ctypes on PyTorch's current stream.
* `solve_profile_batch_reference` — the two-lap, both-sweeps recurrence of
  the Pallas kernel as a Python loop over 2N steps on (B,) rows.

`solve_profile_batch` dispatches on the tensors' device: CPU tensors go to
the plain version, CUDA tensors to the kernel, which raises if it cannot be
built or launched; there is no fallback.  Like the Pallas kernel it is
forward-only, and it raises if an input requires grad: the searches carry
gradients through `ops/velocity.solve_profile_parallel`.

The twin's recurrence (pallas_velocity.py:19-28): each sweep runs the
UNROLLED cyclic recurrence twice (2N steps) instead of rolling each row to
its argmin.  The update v⁺ = where(v_loc > v_prev, min(v_loc, reach(v_prev)),
v_loc) is monotone in v_prev and exact at the global minimum whatever the
carry, so every value of the second lap is exact.  `ds < 0` marks the seam
of an open track and restarts the chain.  Acceleration is force·(1/mass),
as in the Pallas kernel, where `ops/velocity.solve_profile` divides by the
mass: the two agree to roundoff, not bit for bit.

The kernel's schedule computes the same values with one lap per sweep: one
warp per candidate (`warps_for` picks W = 1, 2 or 4 candidates per block
from B so that a search's batch spreads over the SMs); the rows and three
streams (lateral limit, ds, curvature) in shared memory, or, for a lap
longer than one block's shared memory holds (N > 11,622 in float32, 5,811
in float64), in a global scratch of (B, 5, N) that `_launch` allocates, with
the same schedule and the same bits; both sweeps start
where the step resets whatever its carry (the first argmin of the lateral
limit on a closed lap, the seams on an open one); lanes 0-15 run the
acceleration sweep and 16-31 the braking sweep, each lap cut into P ≤ 16
segments that start from an upper-bound guess and are repaired in rounds
until no carry changes (exact for any data, at most P-1 rounds).
tests/test_torch_velocity_schedule.py models that schedule in PyTorch and
holds it to the twin bit for bit.
"""

from __future__ import annotations

import ctypes

import torch

from lap_time_optimization_tpu_torch.ops import _build
from lap_time_optimization_tpu_torch.ops.velocity import GRAV
from lap_time_optimization_tpu_torch.utils import profiling

MAX_ENGINE_KNOTS = 8
#: Packed scalars: mass, traction cap f_cap, Pacejka engine constant
#: T·C_m − Cr0 and quadratic Cr2, and μ·g of the lateral limit.
N_PARAMS = 5
#: Candidates (warps) per block: at most MAX_WARPS, chosen by `warps_for`.
MAX_WARPS = 4
#: Arrays of N a candidate keeps (k, v_loc, ds, v_acc, v_dec): in shared
#: memory, or in the global scratch of the long laps.
ARRAYS = 5
#: Segments per sweep: the kernel takes 1 to MAX_SEGMENTS (one lane each of
#: a sweep's 16); the wrapper launches SEGMENTS.
MAX_SEGMENTS = 16
SEGMENTS = 16

_ENTRY = {torch.float32: "lto_velocity_profile_batch_f32",
          torch.float64: "lto_velocity_profile_batch_f64"}
_lib = None


def pack_vehicle(vehicle, dtype, device):
    """(params (N_PARAMS,), engine (4, MAX_ENGINE_KNOTS), pacejka flag) on
    `device`: the kernel's argument vector, built from the vehicle's
    buffers where they lie (on the device: no host sync).  Engine table
    rows: knot speeds, slopes, widths and f0, for the clamp-sum
    f(v) = f₀ + Σᵢ slopeᵢ·clamp(v−vᵢ, 0, Δvᵢ), which is `jnp.interp`'s
    clamped extrapolation exactly."""
    mu_g = vehicle.friction_coef * GRAV
    if hasattr(vehicle, "D_f"):
        D = 0.5 * (vehicle.D_f + vehicle.D_r)
        f_cap = 2.0 * D * vehicle.mass * GRAV  # traction(lam=2.0), vehicleMX5.py:23-37
        params = torch.stack([vehicle.mass, f_cap, vehicle.T * vehicle.C_m - vehicle.Cr_0,
                              vehicle.Cr_2, mu_g])
        engine = torch.zeros((4, MAX_ENGINE_KNOTS), dtype=dtype, device=device)
        return params.to(device=device, dtype=dtype), engine, True
    if hasattr(vehicle, "engine_v"):
        f_cap = vehicle.friction_coef * vehicle.mass * GRAV
        zero = torch.zeros_like(vehicle.mass)
        params = torch.stack([vehicle.mass, f_cap, zero, zero, mu_g])
        v, f = vehicle.engine_v, vehicle.engine_f
        nk = v.shape[0]
        if nk > MAX_ENGINE_KNOTS:
            raise ValueError(f"engine map has {nk} knots > {MAX_ENGINE_KNOTS}")
        pad = MAX_ENGINE_KNOTS - nk
        dv = torch.diff(v)
        fill = lambda x, n: torch.cat([x, torch.zeros(n, dtype=v.dtype, device=v.device)])
        engine = torch.stack([
            torch.cat([v, v[-1:] + 1e6 + torch.zeros(pad, dtype=v.dtype, device=v.device)]),
            fill(torch.diff(f) / dv, pad + 1)[:MAX_ENGINE_KNOTS],
            fill(dv, pad + 1)[:MAX_ENGINE_KNOTS],
            f[0].expand(MAX_ENGINE_KNOTS),
        ])
        return params.to(device=device, dtype=dtype), engine.to(device=device, dtype=dtype), False
    raise TypeError(f"unsupported vehicle type {type(vehicle)}")


def _rows(s, k_abs, s_max):
    """(s (B, N) or (N,), s_max (B,) or (), as tensors of k's dtype/device)."""
    s = torch.as_tensor(s, dtype=k_abs.dtype, device=k_abs.device)
    s_max = torch.as_tensor(s_max, dtype=k_abs.dtype, device=k_abs.device)
    return s, s_max


# --------------------------------------------------------------- plain twin
def solve_profile_batch_reference(vehicle, s, k_abs, s_max, closed: bool = True, sqrt=torch.sqrt):
    """Plain PyTorch version of the kernel, same signature and semantics as
    `solve_profile_batch`: both sweeps advanced together over two laps of
    2N steps on (B,) rows, the braking sweep on the flipped order, the
    output written on the second lap, then min(v_acc, flip(v_dec)).

    `sqrt` is the square root it takes.  The card's is correctly rounded,
    as numpy's is; PyTorch's vectorised CPU sqrt can be one ulp off, which
    the friction circle near saturation magnifies over a long lap (1.3e-5
    of a float32 profile at N = 20,831), so a CPU run held to the kernel's
    bits passes numpy's."""
    B, N = k_abs.shape
    s, s_max = _rows(s, k_abs, s_max)
    s = s.reshape(-1, N).expand(B, N)
    s_max = s_max.reshape(-1).expand(B)
    params, engine, pacejka = pack_vehicle(vehicle, k_abs.dtype, k_abs.device)
    mass, f_cap, eng_const, eng_quad, mu_g = params.unbind()
    inv_mass = 1.0 / mass
    v_local = sqrt(mu_g / torch.maximum(k_abs, torch.full_like(k_abs, 1e-12)))

    ds_raw = s - torch.roll(s, 1, dims=1)
    sf = torch.flip(s, dims=(1,))
    ds_raw_d = torch.roll(sf, 1, dims=1) - sf
    if closed:
        ds_a = torch.remainder(ds_raw, s_max[:, None])
        ds_d = torch.remainder(ds_raw_d, s_max[:, None])
    else:  # the seam restarts the chain
        ds_a, ds_d = ds_raw.clone(), ds_raw_d.clone()
        ds_a[:, 0] = -1.0
        ds_d[:, 0] = -1.0
    streams_a = (v_local, torch.roll(k_abs, 1, dims=1), ds_a)
    streams_d = (torch.flip(v_local, dims=(1,)), torch.roll(torch.flip(k_abs, dims=(1,)), 1, dims=1), ds_d)

    def traction(v, k):
        f_lat = mass * v * v * k
        slack = f_cap * f_cap - f_lat * f_lat
        return torch.where(slack > 0.0, sqrt(torch.clamp(slack, min=1e-12)), torch.zeros_like(slack))

    def engine_force(v):
        if pacejka:
            return eng_const - eng_quad * v * v
        f = engine[3, 0].expand_as(v)
        for i in range(MAX_ENGINE_KNOTS - 1):
            f = f + engine[1, i] * torch.minimum(torch.clamp(v - engine[0, i], min=0.0), engine[2, i])
        return f

    def limit(v_prev, v_here, k_p, ds_j, accelerating):
        force = traction(v_prev, k_p)
        if accelerating:
            force = torch.minimum(engine_force(v_prev), force)
        vlim = sqrt(v_prev * v_prev + 2.0 * force * inv_mass * torch.clamp(ds_j, min=0.0))
        grow = (ds_j >= 0.0) & (v_here > v_prev)
        return torch.where(grow, torch.minimum(v_here, vlim), v_here)

    va, vd = streams_a[0][:, 0], streams_d[0][:, 0]
    out_a, out_d = [], []
    for t in range(2 * N):
        j = t % N
        va = limit(va, *(x[:, j] for x in streams_a), True)
        vd = limit(vd, *(x[:, j] for x in streams_d), False)
        if t >= N:
            out_a.append(va)
            out_d.append(vd)
    v_acc = torch.stack(out_a, dim=1)
    v_dec = torch.flip(torch.stack(out_d, dim=1), dims=(1,))
    return torch.minimum(v_acc, v_dec)


# ------------------------------------------------------------------- kernel
def build():
    """Build the kernel library (`ops/_build.py`) and bind kernel 3's entry points."""
    global _lib
    if _lib is None:
        lib = _build.load()
        _build.bind(lib, _ENTRY.values(), 7, 8)
        lib.lto_velocity_profile_batch_smem_bytes.argtypes = [ctypes.c_int] * 3
        lib.lto_velocity_profile_batch_smem_bytes.restype = ctypes.c_longlong
        _lib = lib
    return _lib


def warps_for(B: int, n_sm: int) -> int:
    """Candidates per block for a batch of B on `n_sm` SMs: the most of
    (4, 2, 1) that still gives every SM a block (B=1024 on 132 SMs: 4, 256
    blocks in one wave; B=128 or 256: 1)."""
    return next((w for w in (MAX_WARPS, 2) if -(-B // w) >= n_sm), 1)


def smem_bytes(dtype, warps: int, N: int) -> int:
    """Dynamic shared memory of a block of `warps` candidates with their
    arrays in shared memory (0: refused, as for every N past the shared
    placement's ceiling)."""
    return int(build().lto_velocity_profile_batch_smem_bytes(
        torch.empty((), dtype=dtype).element_size(), warps, N))


def _launch(vehicle, s, k_abs, s_max, closed: bool, warps: int | None = None,
            segments: int | None = None, force_global: bool = False):
    """Check the inputs, allocate the output, launch the kernel on the
    current stream with `warps` candidates per block (default `warps_for`;
    fewer where shared memory does not hold them) and `segments` per sweep
    (default SEGMENTS), and count the launch as "velocity_batch.launch".
    The candidates' arrays sit in shared memory where one candidate's fit,
    else (or with `force_global`) in a global scratch of (B, ARRAYS, N)
    with `warps` per block."""
    if k_abs.dtype not in _ENTRY:
        raise TypeError(f"the velocity kernel takes float32 or float64, not {k_abs.dtype}")
    B, N = k_abs.shape
    if B < 1 or N < 1:
        raise ValueError(f"unsupported shape {(B, N)}")
    s, s_max = _rows(s, k_abs, s_max)
    if tuple(s.shape) not in ((N,), (B, N)):
        raise ValueError(f"s: shape {tuple(s.shape)}, expected ({N},) or ({B}, {N})")
    if tuple(s_max.shape) not in ((), (B,)):
        raise ValueError(f"s_max: shape {tuple(s_max.shape)}, expected () or ({B},)")
    if not (k_abs.is_contiguous() and s.stride(-1) == 1):
        raise ValueError("k_abs must be contiguous, and s contiguous along its rows")
    P = SEGMENTS if segments is None else segments
    if not 1 <= P <= MAX_SEGMENTS:
        raise ValueError(f"segments={P}: the kernel takes 1 to {MAX_SEGMENTS} segments per sweep")
    if warps is not None and not 1 <= warps <= MAX_WARPS:
        raise ValueError(f"warps={warps}: the kernel takes 1 to {MAX_WARPS} candidates per block")
    lib = build()
    if warps is None:
        warps = warps_for(B, torch.cuda.get_device_properties(k_abs.device).multi_processor_count)
    W, scratch = 0, None
    if not force_global:
        W = next((w for w in range(warps, 0, -1) if smem_bytes(k_abs.dtype, w, N)), 0)
    if W == 0:  # the global placement
        W = warps
        scratch = torch.empty((B, ARRAYS, N), dtype=k_abs.dtype, device=k_abs.device)
    params, engine, pacejka = pack_vehicle(vehicle, k_abs.dtype, k_abs.device)
    out = torch.empty((B, N), dtype=k_abs.dtype, device=k_abs.device)
    ptrs = [t.data_ptr() for t in (s, k_abs, s_max, params, engine, out)]
    ptrs.append(None if scratch is None else scratch.data_ptr())
    # s and s_max may be strided views (the searches pass s[:, :-1] and the
    # splines' lengths, t[:, -1])
    ints = (B, N, s.stride(0) if s.dim() == 2 else 0, s_max.stride(0) if s_max.dim() == 1 else 0,
            int(closed), int(pacejka), W, P)
    with torch.cuda.device(k_abs.device):
        stream = torch.cuda.current_stream(k_abs.device).cuda_stream
        rc = getattr(lib, _ENTRY[k_abs.dtype])(*ptrs, *ints, stream)
    if rc != 0:
        raise RuntimeError(f"velocity kernel launch failed: cudaError_t {rc}")
    profiling.count("velocity_batch.launch")
    return out


def solve_profile_batch(vehicle, s, k_abs, s_max, closed: bool = True) -> torch.Tensor:
    """Batched 3-pass velocity profile, forward only.

    vehicle: `PointMassVehicle` (≤8-knot engine map) or `PacejkaVehicle`;
    s: (N,) shared or (B, N) per-candidate sample distances; k_abs: (B, N)
    absolute curvature; s_max: scalar or (B,) lap lengths (ignored when
    closed=False).  Returns v (B, N), which is `ops/velocity.solve_profile`
    of every row."""
    k_abs = torch.as_tensor(k_abs)
    if any(isinstance(x, torch.Tensor) and x.requires_grad for x in (s, k_abs, s_max)):
        raise ValueError("solve_profile_batch is forward-only; differentiate "
                         "through ops.velocity.solve_profile_parallel")
    if k_abs.dim() != 2:
        raise ValueError(f"k_abs: shape {tuple(k_abs.shape)}, expected (B, N)")
    if k_abs.device.type == "cuda":
        return _launch(vehicle, s, k_abs, s_max, closed)
    if k_abs.device.type == "cpu":
        return solve_profile_batch_reference(vehicle, s, k_abs, s_max, closed)
    raise ValueError(f"no velocity-profile implementation for device {k_abs.device}")

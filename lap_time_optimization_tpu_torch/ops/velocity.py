"""Quasi-static velocity profile (3-pass) — port of `lap_time_optimization_tpu/ops/velocity.py`.

The reference's `VelocityProfile` (src/velocity.py:9-76):

1. local lateral limit  v = sqrt(μ g / κ)                 (src/velocity.py:28-29)
2. forward pass from the globally slowest point, limiting acceleration by
   min(engine, traction)/m with v' = sqrt(v² + 2 a Δs)    (src/velocity.py:31-53)
3. an identical backward pass for braking                 (src/velocity.py:55-76)

final profile v = min(accel-limited, decel-limited)       (src/velocity.py:26)

Two schedules of the same physics, both over an optional leading candidate
axis ((B, N) samples; (N,) without it) and both differentiable by autograd:

* `solve_profile` — the sequential oracle: a Python loop over the N samples
  on (B,) rows, each row rolled to start at its own argmin by `gather`.
* `solve_profile_parallel` — the log-depth "assoc" schedule that carries the
  searches' gradients: repeated frozen-coefficient min-plus scans.

Gradient conventions follow JAX: `torch.minimum`/`torch.maximum` split the
gradient 0.5/0.5 at ties as `lax.min`/`lax.max` do, so they are used where
the JAX code has `jnp.minimum`/`jnp.maximum` (never `clamp`, which passes
the whole gradient at the bound).  Padding of the scan uses the combine's
finite identity (c = finfo.max/4, b = 0), never +inf, so no inf − inf or
inf·0 reaches autograd.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

GRAV = 9.81  # m s^-2


def local_limit(vehicle, k_abs: torch.Tensor) -> torch.Tensor:
    """Lateral-grip speed limit sqrt(μ g / κ) (src/velocity.py:28-29)."""
    k_safe = torch.maximum(k_abs, torch.full_like(k_abs, 1e-12))
    return torch.sqrt(vehicle.friction_coef * GRAV / k_safe)


def lap_time(s: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Lap time Σ Δs / v with s (..., ns) samples and v (..., ns-1) profile
    (reference src/trajectory.py:54-58)."""
    return torch.sum(torch.diff(s, dim=-1) / v, dim=-1)


def _roll_rows(x: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """Per-row `jnp.roll(x[b], shift[b])` over the last axis of (B, N) by a
    gather; the indices carry no gradient."""
    n = x.shape[-1]
    idx = (torch.arange(n, device=x.device)[None, :] - shift[:, None]) % n
    return torch.gather(x, -1, idx)


def _force(vehicle, v_prev, k_prev, accelerating: bool):
    if accelerating:
        return torch.minimum(vehicle.engine_force(v_prev), vehicle.traction(v_prev, k_prev))
    return vehicle.traction(v_prev, k_prev)


def _directional_pass(vehicle, v_loc, k_prev, ds, valid, accelerating: bool):
    """One monotone sweep over (B, N) rows already rolled/flipped so it is a
    plain left-to-right recurrence; `valid` masks the open-track wrap step."""
    v_prev = v_loc[:, -1]
    out = []
    for j in range(v_loc.shape[-1]):
        v_here = v_loc[:, j]
        accel = _force(vehicle, v_prev, k_prev[:, j], accelerating) / vehicle.mass
        vlim = torch.sqrt(v_prev * v_prev + 2.0 * accel * ds[:, j])
        v_prev = torch.where(valid[:, j] & (v_here > v_prev), torch.minimum(v_here, vlim), v_here)
        out.append(v_prev)
    return torch.stack(out, dim=-1)


def _rolled_streams(s, k_abs, v_local, s_max, closed: bool):
    """Rows rolled to start at their own argmin of the local limit, and the
    forward/braking (v_loc, k_prev, ds, valid) streams of the JAX solver."""
    B, n = k_abs.shape
    i0 = torch.argmin(v_local, dim=-1)
    idx = torch.arange(n, device=k_abs.device)[None, :].expand(B, n)
    sr, kr, vr = (_roll_rows(x, -i0) for x in (s, k_abs, v_local))
    ds_raw = sr - torch.roll(sr, 1, dims=-1)
    if closed:
        ds_fwd = torch.remainder(ds_raw, s_max[:, None])
        valid_fwd = torch.ones_like(idx, dtype=torch.bool)
    else:
        ds_fwd = ds_raw
        valid_fwd = idx != ((-i0) % n)[:, None]
    fwd = (vr, torch.roll(kr, 1, dims=-1), ds_fwd, valid_fwd)

    sf, kf, vf = (torch.flip(x, dims=(-1,)) for x in (sr, kr, vr))
    ds_raw_b = torch.roll(sf, 1, dims=-1) - sf
    if closed:
        ds_bwd = torch.remainder(ds_raw_b, s_max[:, None])
        valid_bwd = torch.ones_like(idx, dtype=torch.bool)
    else:
        ds_bwd = ds_raw_b
        valid_bwd = idx != i0[:, None]
    bwd = (vf, torch.roll(kf, 1, dims=-1), ds_bwd, valid_bwd)
    return i0, fwd, bwd


def _rows(s, k_abs, s_max):
    """Broadcast to (B, N) rows and (B,) lap lengths; whether k was 1-D."""
    k_abs = torch.as_tensor(k_abs)
    single = k_abs.dim() == 1
    k2 = k_abs.reshape(-1, k_abs.shape[-1])
    s2 = torch.as_tensor(s, dtype=k2.dtype, device=k2.device).reshape(-1, k2.shape[-1]).expand(k2.shape)
    if s_max is not None:
        s_max = torch.as_tensor(s_max, dtype=k2.dtype, device=k2.device).reshape(-1).expand(k2.shape[0])
    return s2, k2, s_max, single


def solve_profile(vehicle, s: torch.Tensor, k_abs: torch.Tensor, s_max, closed: bool = True):
    """Solve the 3-pass velocity profile sequentially.

    s: (N,) or (B, N) sample distances, excluding the duplicated endpoint of
    closed laps (reference src/trajectory.py:49-52); k_abs: (N,) or (B, N)
    absolute curvature; s_max: lap length(s), scalar or (B,) (ignored when
    closed=False).  Returns v = min(v_acc, v_dec) of k_abs's shape."""
    s2, k2, s_max, single = _rows(s, k_abs, s_max)
    v_local = local_limit(vehicle, k2)
    i0, fwd, bwd = _rolled_streams(s2, k2, v_local, s_max, closed)
    v_acc = _roll_rows(_directional_pass(vehicle, *fwd, accelerating=True), i0)
    v_dec = _directional_pass(vehicle, *bwd, accelerating=False)
    v_dec = _roll_rows(torch.flip(v_dec, dims=(-1,)), i0)
    v = torch.minimum(v_acc, v_dec)
    return v[0] if single else v


# --------------------------------------------------------------------------- parallel solver
def _minplus_scan(c: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve x_i = min(c_i, x_{i-1} + b_i) with x_{-1} = +inf in log depth.

    The affine-min maps f_i(x) = min(c_i, x + b_i) compose associatively:
    (c_j, b_j) ∘ (c_i, b_i) = (min(c_j, c_i + b_j), b_i + b_j).  Inclusive
    Hillis–Steele scan over the last axis: ⌈log2 N⌉ steps, each combining
    every element with the one `offset` before it; the first `offset`
    elements combine with the identity (finfo.max/4, 0)."""
    n = c.shape[-1]
    big = torch.finfo(c.dtype).max / 4
    offset = 1
    while offset < n:
        c_l = F.pad(c[..., :-offset], (offset, 0), value=big)
        b_l = F.pad(b[..., :-offset], (offset, 0), value=0.0)
        c, b = torch.minimum(c, c_l + b), b_l + b
        offset *= 2
    return c


def _parallel_pass(vehicle, v_loc, k_prev, ds, valid, accelerating: bool, sweeps: int):
    """Fixpoint of the monotone sweep via repeated frozen-coefficient scans.

    With e_i = v_i², the exact recurrence is
      e_i = min(e_loc_i, e_{i-1} + 2·a(v_{i-1}, k_{i-1})·Δs_i);
    freezing a at the current iterate turns each sweep into a min-plus scan
    (nonlinear Jacobi) that converges to the sequential fixpoint."""
    e_loc = v_loc * v_loc
    big = torch.finfo(v_loc.dtype).max / 4
    e = e_loc
    for _ in range(sweeps):
        v_prev = torch.roll(torch.sqrt(e), 1, dims=-1)
        b = 2.0 * (_force(vehicle, v_prev, k_prev, accelerating) / vehicle.mass) * ds
        # masked (open-track wrap) entries break the chain: allow unlimited
        # increase across them so the scan restarts from the local limit
        b = torch.where(valid, b, torch.full_like(b, big))
        # cyclic closure: fold the link from the last element into position 0
        link0 = torch.where(valid[..., 0], e[..., -1] + b[..., 0], torch.full_like(b[..., 0], big))
        c = torch.cat([torch.minimum(e_loc[..., :1], link0[..., None]), e_loc[..., 1:]], dim=-1)
        e = torch.minimum(e_loc, _minplus_scan(c, b))
    return torch.sqrt(e)


def solve_profile_parallel(vehicle, s: torch.Tensor, k_abs: torch.Tensor, s_max,
                           closed: bool = True, sweeps: int = 16):
    """Log-depth variant of `solve_profile`: each directional pass runs
    `sweeps` frozen-coefficient min-plus scans (O(sweeps·log N) wide ops)
    instead of N serial steps.  Converges to the sequential profile: smooth
    traction laws (MX5) in ~4 sweeps, friction-circle laws (tbr18) in ~16."""
    s2, k2, s_max, single = _rows(s, k_abs, s_max)
    v_local = local_limit(vehicle, k2)
    i0, fwd, bwd = _rolled_streams(s2, k2, v_local, s_max, closed)
    n = k2.shape[-1]
    # position 0 is the global minimum: it is never limited, and the chain
    # from the last element cannot lower it, so dropping that link is exact
    not_first = torch.arange(n, device=k2.device)[None, :] != 0
    v_acc = _parallel_pass(vehicle, *fwd[:3], fwd[3] & not_first, True, sweeps)
    v_acc = _roll_rows(v_acc, i0)
    v_dec = _parallel_pass(vehicle, *bwd, False, sweeps)
    v_dec = _roll_rows(torch.flip(v_dec, dims=(-1,)), i0)
    v = torch.minimum(v_acc, v_dec)
    return v[0] if single else v

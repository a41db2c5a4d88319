"""The tail of a closed-loop control cycle: one CUDA kernel after the solve.

After each cycle's solve the closed loop (`mpc/runner._step_fn`) clips the
solve's first input to the actuator limits, integrates the plant over one
control period, shifts the warm start one stage forward and records the
cycle's outputs.  The JAX runner's scan fuses that under XLA; in eager
PyTorch it is ~730 kernels of a few elements each, which a CUDA graph
replays one after another.

* `tail` — the wrapper.  CUDA tensors go to `csrc/cycle_tail.cu`'s
  `cycle_tail_kernel` (CUDA C++ for sm_90a, one thread per loop, blocks of
  up to 128 loops), built with the port's other kernels (`ops/_build.py`)
  and called through ctypes on PyTorch's current stream.  Its plant step is
  the solve kernel's own RK4 step (`csrc/bicycle.cuh`), over the constants
  the loop already packed (`ops.ilqr.pack`).  It can write the cycle's
  outputs straight into the caller's rows.  It raises on what it does not
  take and if the launch fails; there is no fallback.  CPU tensors go to
  the plain version, so every CPU result is the plain code's.
* `tail_reference` — the same tail in plain PyTorch: the code the closed
  loop ran after the solve before this kernel, unchanged.

The kernel divides by dt where PyTorch's CUDA division by a Python number
multiplies by its reciprocal, and libdevice's trig and FMA contraction
differ from PyTorch's per-op kernels in the last ulps, so on the card the
kernel and the plain version agree to rounding, not bit for bit.  Every
loop on the card (eager and graphed) runs the kernel, so they agree with
each other bit for bit.
"""

from __future__ import annotations

import ctypes

import torch

from lap_time_optimization_tpu_torch.ops import _build, ilqr
from lap_time_optimization_tpu_torch.utils import profiling

NX, NU = ilqr.NX, ilqr.NU

_ENTRY = {torch.float32: "lto_cycle_tail_f32", torch.float64: "lto_cycle_tail_f64"}
_lib = None


def tail_reference(model, p, cfg, x, us, lam):
    """Clip, plant step, warm-start shift and track progress in plain
    PyTorch, for any leading instance shape: from the states x (..., NX) and
    the solve's inputs us (..., N, NU) and multipliers lam (..., N+1,
    n_con), returns (x_next, u0, us_next, lam_next, sdot)."""
    # actuator saturation: the AL solver leaves O(1e-2) slack on the input
    # boxes at fixed iteration budgets; the physical actuators (and the
    # reference's hard NLP bounds, src/mpc/controller.py:79-103) cannot
    # exceed them, so the APPLIED input is clipped to the rate limits and so
    # that the integrated steer/throttle states stay inside their boxes
    rate_lim = torch.stack([p.dsteer_max, p.dthrottle_max])
    box = torch.stack([p.steer_max, p.throttle_max])
    act = x[..., 6:8]
    lo = torch.maximum(-rate_lim, (-box - act) / cfg.dt)
    hi = torch.minimum(rate_lim, (box - act) / cfg.dt)
    u0 = torch.clamp(us[..., 0, :], lo, hi)
    x_next = model.step(x, u0, cfg.dt, substeps=cfg.substeps)
    # shift warm starts one stage forward
    us_next = torch.cat([us[..., 1:, :], us[..., -1:, :]], dim=-2)
    lam_next = torch.cat([lam[..., 1:, :], lam[..., -1:, :]], dim=-2)
    sdot = (x_next[..., 0] - x[..., 0]) / cfg.dt
    return x_next, u0, us_next, lam_next, sdot


def build():
    """Build the kernel library (`ops/_build.py`) and bind the tail's entry
    points."""
    global _lib
    if _lib is None:
        lib = _build.load()
        ptr, i64 = ctypes.c_void_p, ctypes.c_longlong
        for name in _ENTRY.values():
            fn = getattr(lib, name)
            fn.argtypes = ([ptr] * 11 + [ptr, i64] * 5 + [ctypes.c_int] * 5 + [ctypes.c_double, ptr])
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check(cfg, x, us, lam, cost, viol, pk: ilqr.Pack, rows):
    """Raise on what the kernel does not take (before any build); returns
    the leading instance shape, () or (B,)."""
    if x.dtype not in _ENTRY:
        raise TypeError(f"the tail kernel takes float32 or float64, not {x.dtype}")
    if x.dim() not in (1, 2):
        raise ValueError(f"x: shape {tuple(x.shape)}, expected (NX,) or (B, NX)")
    lead = tuple(x.shape[:-1])
    if lead and lead[0] < 1:
        raise ValueError(f"unsupported batch size {lead[0]}")
    N, n_con = us.shape[-2], lam.shape[-1]
    if N < 1 or n_con not in (ilqr.N_CON, ilqr.N_CON + 2):
        raise ValueError(f"unsupported horizon {N} or constraint count {n_con}")
    shapes = {"x": lead + (NX,), "us": lead + (N, NU), "lam": lead + (N + 1, n_con), "cost": lead,
              "max_violation": lead, "tables": (4, pk.tables.shape[-1]), "scal_tail": (ilqr.NS - 2,)}
    tensors = {"x": x, "us": us, "lam": lam, "cost": cost, "max_violation": viol,
               "tables": pk.tables, "scal_tail": pk.scal_tail}
    if rows is not None:
        names = ("xs row", "us row", "cost row", "violation row", "sdot row")
        shapes.update(zip(names, (lead + (NX,), lead + (NU,), lead, lead, lead)))
        tensors.update(zip(names, rows))
    for name, t in tensors.items():
        if t.device != x.device or t.dtype != x.dtype:
            raise ValueError(f"{name}: {t.dtype} on {t.device}, expected {x.dtype} on {x.device}")
        if tuple(t.shape) != shapes[name]:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shapes[name]}")
        if name.endswith(" row"):
            if t.dim() > len(lead) and t.stride(-1) != 1:
                raise ValueError(f"{name}: its last axis must be contiguous")
        elif not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if pk.tables.shape[-1] < 2 or cfg.substeps < 1:
        raise ValueError(f"unsupported table length {pk.tables.shape[-1]} or substeps {cfg.substeps}")
    return lead


def _launch(cfg, x, us, lam, cost, viol, pk: ilqr.Pack, rows=None):
    """Check, allocate the new carry (and, without `rows`, sdot), launch the
    tail kernel on the current stream and count the launch as
    "cycle_tail.tail".  Returns (x_next, u0, us_next, lam_next, sdot)."""
    lead = _check(cfg, x, us, lam, cost, viol, pk, rows)
    B = lead[0] if lead else 1
    N, n_con = us.shape[-2], lam.shape[-1]
    lib = build()
    carry = (torch.empty_like(x), x.new_empty(lead + (NU,)), torch.empty_like(us), torch.empty_like(lam))
    sdot = x.new_empty(lead) if rows is None else rows[4]
    # a record row: (pointer, elements between instances); None skips it
    rec = lambda t: (None, 0) if t is None else (t.data_ptr(), t.stride(0) if lead else 0)
    recs = (*(rows[:4] if rows is not None else (None,) * 4), sdot)
    args = [t.data_ptr() for t in (x, us, lam, cost, viol, pk.tables, pk.scal_tail, *carry)]
    for t in recs:
        args.extend(rec(t))
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = getattr(lib, _ENTRY[x.dtype])(*args, B, N, n_con, pk.tables.shape[-1], cfg.substeps,
                                            float(cfg.dt), stream)
    if rc != 0:
        raise RuntimeError(f"tail kernel launch failed: cudaError_t {rc}")
    profiling.count("cycle_tail.tail")
    x_next, u0, us_next, lam_next = carry
    return x_next, u0, us_next, lam_next, sdot


def tail(model, p, cfg, x, res, pk: ilqr.Pack | None = None, rows=None):
    """The tail of a cycle from the states x (NX,) or (B, NX) and the
    cycle's solve `res` (`solver.SolveResult`), with the solve's constants
    `pk` (`ilqr.pack(model, p, cfg)`, which the loop packs once; the plain
    version does not read it).  Returns (carry,
    out): the next carry (x_next, us_next, lam_next, u0) and the cycle's
    outputs (x_next, u0, cost, max_violation, sdot).  With `rows`, views
    with x's leading shape to record the outputs in (the xs and us rows,
    each with a contiguous last axis, and the cost, violation and sdot
    entries), they are written there and `out` is `rows`.  CUDA tensors: one
    launch of the tail kernel (the solve's fields made contiguous first),
    which raises without `pk`; CPU tensors: `tail_reference`."""
    if x.device.type == "cuda":
        if pk is None:
            raise ValueError("the tail kernel takes the loop's packed constants: pass pk = ilqr.pack(model, p, cfg)")
        fields = (res.us, res.lam, res.cost, res.max_violation)
        us, lam, cost, viol = (t.contiguous() for t in fields)
        x_next, u0, us_next, lam_next, sdot = _launch(cfg, x.contiguous(), us, lam, cost, viol, pk, rows)
        out = (x_next, u0, res.cost, res.max_violation, sdot) if rows is None else rows
        return (x_next, us_next, lam_next, u0), out
    if x.device.type != "cpu":
        raise ValueError(f"no tail implementation for device {x.device}")
    x_next, u0, us_next, lam_next, sdot = tail_reference(model, p, cfg, x, res.us, res.lam)
    out = (x_next, u0, res.cost, res.max_violation, sdot)
    if rows is not None:
        for dst, src in zip(rows, out):
            dst.copy_(src)
        out = rows
    return (x_next, us_next, lam_next, u0), out

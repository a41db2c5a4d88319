"""The tail of a control cycle (`ops/cycle_tail.py`): the clip, the plant
step, the warm-start shift and the cycle's outputs, one CUDA kernel on the
card (`csrc/cycle_tail.cu`) and the plain code on the CPU.

On the CPU: the kernels' names (the benchmark finds the solve kernel by the
substring `ilqr_solve_kernel`, so no other kernel may hold it), the launch
count staying 0, the wrapper's checks (they run before any build) and its
rows, and that a failed build raises instead of falling back.

The `cuda` tests skip here and run on the card; this file imports no JAX,
so they also run where only the port is installed:

    python -m pytest --noconftest tests/test_torch_cycle_tail.py -q -s -m cuda

There the kernel is held to the plain version on the card from the same
solve outputs and carry: B = 1 (and the single stream's unbatched shapes),
33 and 4096, float32 and float64, horizon 10 and 20, 1 and 2 RK4 substeps,
torque vectoring and the traction ellipse's 16 rows, with inputs that meet
every branch of the clip.  The shifted warm start and multipliers are bit
for bit (copies); x_next, u0 and sdot agree within 1e-5 (float32) and
1e-13 (float64) relative: x_next to |x| + |x_next|, the magnitudes its last
addition rounds, and sdot, a difference of two arc lengths over dt, to
(|s| + |s_next|) / dt, and it is bit for bit the division of the kernel's
own x_next.  The launch count reads the loop's cycles after a graphed
`closed_loop` and `closed_loop_batch`.
"""

import copy
import os
import re
from collections import Counter

import numpy as np
import pytest
import torch

from lap_time_optimization_tpu_torch.models import load_vehicle
from lap_time_optimization_tpu_torch.models.bicycle import BicycleModel
from lap_time_optimization_tpu_torch.mpc import runner
from lap_time_optimization_tpu_torch.mpc import track as mpc_track
from lap_time_optimization_tpu_torch.mpc.solver import OCPParams, SolveResult, SolverConfig
from lap_time_optimization_tpu_torch.ops import _build, cycle_tail, ilqr
from lap_time_optimization_tpu_torch.utils import profiling

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO_DATA = os.path.join(ROOT, "data")
CSRC = os.path.join(ROOT, "lap_time_optimization_tpu_torch", "csrc")
CPU_CFG = SolverConfig(horizon=4, substeps=1, al_iters=1, ilqr_iters=1, n_linesearch=2)
DTYPES = {"float64": torch.float64, "float32": torch.float32}
RTOL = {torch.float32: 1e-5, torch.float64: 1e-13}


@pytest.fixture(scope="module")
def track():
    if not os.path.isdir(os.path.join(REPO_DATA, "plots", "MX-5", "buckmore", "curvature")):
        pytest.skip("shipped curvature artifacts not available")
    return mpc_track.load("MX-5", "buckmore", "curvature", base_dir=REPO_DATA)


def _setup(track, dtype, device="cpu", **flags):
    model = BicycleModel(load_vehicle("MX5"), copy.deepcopy(track), **flags).to(device, dtype)
    return model, OCPParams.reference(dtype, device, lateral_margin=0.05)


#: Clip branches, per input channel: inside the limits, past the rate limit
#: either way, and past the limit the box implies either way (the state's
#: steer or throttle a little inside its box, so (±box - act) / dt is inside
#: the rate limit).
BRANCHES = ("free", "rate_hi", "rate_lo", "box_hi", "box_lo")


def _inputs(model, p, cfg, lead, n_con, offset, seed):
    """States spread over the lap, the solve's us / lam / cost / violation,
    on the CPU in float64.  Instance i's steer channel takes branch (i +
    offset) % 5 of `BRANCHES` and its throttle channel (i + offset + 2) % 5."""
    g = torch.Generator().manual_seed(seed)
    r = lambda *shape: torch.rand(lead + shape, generator=g, dtype=torch.float64)
    N, dt = cfg.horizon, cfg.dt
    rate = torch.tensor([float(p.dsteer_max), float(p.dthrottle_max)], dtype=torch.float64)
    box = torch.tensor([float(p.steer_max), float(p.throttle_max)], dtype=torch.float64)
    x = torch.stack([r() * float(model.track.s_max), (r() - 0.5) * 2.0, (r() - 0.5) * 0.4, 4.0 + 8.0 * r(),
                     (r() - 0.5) * 0.5, (r() - 0.5) * 0.6, torch.zeros(lead, dtype=torch.float64),
                     torch.zeros(lead, dtype=torch.float64)], dim=-1)
    us = (r(N, 2) - 0.5) * rate
    idx = torch.arange(int(np.prod(lead)) if lead else 1).reshape(lead)
    for c in range(2):
        branch = (idx + offset + 2 * c) % len(BRANCHES)
        # inside its box for free and rate branches, at ±(box - 0.2·rate·dt) for the box branches
        act = (r() - 0.5) * box[c]
        act = torch.where(branch == 3, box[c] - 0.2 * rate[c] * dt, act)
        act = torch.where(branch == 4, -box[c] + 0.2 * rate[c] * dt, act)
        u = torch.where(branch == 0, (r() - 0.5) * rate[c], 3.0 * rate[c] * (1.0 + r()))
        u = torch.where((branch == 2) | (branch == 4), -u, u)
        x[..., 6 + c] = act
        us[..., 0, c] = u
    return x, us, r(N + 1, n_con), r(), r()


def _branch_hits(x, us, p, dt):
    """Which clip branch binds for each input, from the plain formulas."""
    rate = torch.stack([p.dsteer_max, p.dthrottle_max]).double().cpu()
    box = torch.stack([p.steer_max, p.throttle_max]).double().cpu()
    act, u = x[..., 6:8].double().cpu(), us[..., 0, :].double().cpu()
    lo_box, hi_box = (-box - act) / dt, (box - act) / dt
    hits = set()
    hits |= {"rate_hi"} if bool(((u > rate) & (rate <= hi_box)).any()) else set()
    hits |= {"rate_lo"} if bool(((u < -rate) & (-rate >= lo_box)).any()) else set()
    hits |= {"box_hi"} if bool(((u > hi_box) & (hi_box < rate)).any()) else set()
    hits |= {"box_lo"} if bool(((u < lo_box) & (lo_box > -rate)).any()) else set()
    inside = (u > torch.maximum(-rate, lo_box)) & (u < torch.minimum(rate, hi_box))
    hits |= {"free"} if bool(inside.any()) else set()
    return hits


# --------------------------------------------------------------------- CPU
def _global_names():
    names = []
    for fname in sorted(os.listdir(CSRC)):
        if fname.endswith((".cu", ".cuh")):
            with open(os.path.join(CSRC, fname)) as fh:
                src = fh.read()
            names += re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)\s*\(", src)
    return names


def test_one_kernel_holds_the_solve_kernels_name():
    """The benchmark's readers find the solve kernel by the substring
    `ilqr_solve_kernel`: exactly one `__global__` under csrc/ holds it, and
    the tail kernel is another."""
    names = _global_names()
    assert "cycle_tail_kernel" in names and len(names) >= 3, names
    assert [n for n in names if "ilqr_solve_kernel" in n] == ["ilqr_solve_kernel"], names


def test_the_build_hashes_every_source_and_header():
    """A source or header under csrc/ that the build leaves out of its hash
    would let an edit to it reuse a stale library."""
    listed = {os.path.basename(path) for path in _build.SOURCES + _build.HEADERS}
    assert listed == {f for f in os.listdir(CSRC) if f.endswith((".cu", ".cuh"))}


def test_no_tail_launch_on_the_cpu(track, monkeypatch):
    """A CPU loop runs the plain tail: the launch count stays 0."""
    monkeypatch.setattr(profiling, "COUNTS", Counter())
    model, p = _setup(track, torch.float64)
    x0 = torch.as_tensor(runner.X0_REFERENCE, dtype=torch.float64)
    runner.closed_loop(model, p, CPU_CFG, x0, 3)
    runner.closed_loop_batch(model, p, CPU_CFG, x0.repeat(2, 1), 2)
    assert profiling.counts()["cycle_tail.tail"] == 0


@pytest.mark.parametrize("batch", [None, 3])
def test_rows_take_the_outputs_on_the_cpu(track, batch):
    """With rows, the plain tail writes the cycle's outputs into them (views
    into a loop's outputs) and returns them; without, it returns the plain
    version's values and the solve's own cost and violation."""
    model, p = _setup(track, torch.float64)
    lead = () if batch is None else (batch,)
    x, us, lam, cost, viol = _inputs(model, p, CPU_CFG, lead, 14, 0, 3)
    res = SolveResult(us, None, lam, cost, viol)
    carry, out = cycle_tail.tail(model, p, CPU_CFG, x, res)
    ref = cycle_tail.tail_reference(model, p, CPU_CFG, x, us, lam)
    assert out[2] is cost and out[3] is viol
    for a, b in zip((*carry, out[4]), (ref[0], ref[2], ref[3], ref[1], ref[4])):
        assert torch.equal(a, b)
    dest = runner._empty_result(x, 4)
    rows = (dest.xs[..., 2, :], dest.us[..., 2, :], dest.costs[..., 1], dest.violations[..., 1], dest.sdot[..., 1])
    _, got = cycle_tail.tail(model, p, CPU_CFG, x, res, None, rows)
    assert got is rows
    for a, b in zip(rows, out):
        assert torch.equal(a, b)


def _bad(x, us, lam, cost, viol, rows):
    """Variants the wrapper refuses, each with the exception it raises."""
    yield "dtype", TypeError, (x.half(), us, lam, cost, viol, rows)
    yield "mixed dtype", ValueError, (x, us.float(), lam, cost, viol, rows)
    yield "horizon", ValueError, (x, us[..., :0, :], lam[..., :1, :], cost, viol, rows)
    yield "lam rows", ValueError, (x, us, lam[..., :-1, :], cost, viol, rows)
    yield "constraint count", ValueError, (x, us, lam[..., :13], cost, viol, rows)
    yield "rank", ValueError, (x[None], us[None], lam[None], cost[None], viol[None], None)
    yield "cost shape", ValueError, (x, us, lam, cost[..., None], viol, rows)
    yield "non-contiguous us", ValueError, (x, us.transpose(-1, -2).contiguous().transpose(-1, -2), lam, cost,
                                             viol, rows)
    xs_row = torch.zeros(x.shape[:-1] + (8, 2), dtype=x.dtype)[..., 0]  # last axis strided
    yield "strided xs row", ValueError, (x, us, lam, cost, viol, (xs_row, *rows[1:]))
    yield "row dtype", ValueError, (x, us, lam, cost, viol, (rows[0].float(), *rows[1:]))


def test_the_wrapper_checks_before_any_build(track, monkeypatch):
    """`_launch` refuses what the kernel does not take before it builds or
    launches anything (the build is made to fail, so a check that let a
    case through would show as RuntimeError), and a failed build raises:
    nothing falls back to the plain tail."""
    model, p = _setup(track, torch.float64)
    pk = ilqr.pack(model, p, CPU_CFG)
    lead = (5,)
    x, us, lam, cost, viol = _inputs(model, p, CPU_CFG, lead, 14, 0, 4)
    dest = runner._empty_result(x, 3)
    rows = (dest.xs[..., 1, :], dest.us[..., 1, :], dest.costs[..., 0], dest.violations[..., 0], dest.sdot[..., 0])

    def no_build():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(_build, "load", no_build)
    monkeypatch.setattr(cycle_tail, "_lib", None)
    monkeypatch.setattr(profiling, "COUNTS", Counter())
    for name, exc, args in _bad(x, us, lam, cost, viol, rows):
        with pytest.raises(exc):
            cycle_tail._launch(CPU_CFG, *args[:5], pk, args[5])
    with pytest.raises(ValueError):
        cycle_tail._launch(CPU_CFG, x, us, lam, cost, viol, pk._replace(tables=pk.tables[:, :1].contiguous()))
    with pytest.raises(RuntimeError, match="nvcc"):
        cycle_tail._launch(CPU_CFG, x, us, lam, cost, viol, pk, rows)
    assert profiling.counts()["cycle_tail.tail"] == 0


# --------------------------------------------------------------- on the card
def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the tail kernel runs on the card only)")


def _close(got, ref, scale, rtol):
    """max |got - ref| / scale, asserted ≤ rtol."""
    err = float(((got.double() - ref.double()).abs() / scale.double()).max())
    assert err <= rtol, err
    return err


@pytest.mark.cuda
@pytest.mark.parametrize("flags", ["plain", "tv_ellipse"])
@pytest.mark.parametrize("horizon, substeps", [(10, 2), (20, 1)])
@pytest.mark.parametrize("dtype_name", list(DTYPES))
@pytest.mark.parametrize("batch", [None, 1, 33, 4096])
def test_cuda_tail_matches_plain(track, batch, dtype_name, horizon, substeps, flags):
    """The kernel against the plain tail on the card, from the same solve
    outputs and carry, with and without rows (views into a loop's outputs);
    every clip branch is met (B = 1 and the unbatched shapes over five
    launches, each with its own branch offset)."""
    _need_cuda()
    dtype = DTYPES[dtype_name]
    on = flags == "tv_ellipse"
    model, p = _setup(track, dtype, "cuda", enable_torque_vectoring=on, enable_traction_ellipse=on)
    cfg = SolverConfig(horizon=horizon, substeps=substeps)
    pk = ilqr.pack(model, p, cfg)
    lead = () if batch is None else (batch,)
    rtol, hits, worst = RTOL[dtype], set(), {}
    for offset in range(5 if (batch or 1) < 5 else 1):
        host = _inputs(model, p, cfg, lead, 16 if on else 14, offset, 1000 * offset + (batch or 0))
        x, us, lam, cost, viol = (t.to("cuda", dtype) for t in host)
        hits |= _branch_hits(x, us, p, cfg.dt)
        ref = cycle_tail.tail_reference(model, p, cfg, x, us, lam)
        res = SolveResult(us, None, lam, cost, viol)
        dest = runner._empty_result(x, 3)
        rows = (dest.xs[..., 2, :], dest.us[..., 2, :], dest.costs[..., 1], dest.violations[..., 1],
                dest.sdot[..., 1])
        for with_rows in (False, True):
            carry, out = cycle_tail.tail(model, p, cfg, x, res, pk, rows if with_rows else None)
            x_next, us_next, lam_next, u0 = carry
            assert torch.equal(us_next, ref[2]) and torch.equal(lam_next, ref[3])
            assert torch.equal(out[0], x_next) and torch.equal(out[1], u0)
            assert torch.equal(out[2], cost) and torch.equal(out[3], viol)
            sdot = out[4]
            assert torch.equal(sdot.cpu(), (x_next[..., 0] - x[..., 0]).cpu() / cfg.dt)
            worst["x_next"] = max(worst.get("x_next", 0.0), _close(x_next, ref[0], x.abs() + ref[0].abs(), rtol))
            tiny = torch.finfo(dtype).tiny
            worst["u0"] = max(worst.get("u0", 0.0), _close(u0, ref[1], ref[1].abs() + tiny, rtol))
            s_scale = (x[..., 0].abs() + ref[0][..., 0].abs()) / cfg.dt
            worst["sdot"] = max(worst.get("sdot", 0.0), _close(sdot, ref[4], s_scale, rtol))
        assert dest.xs[..., 2, :].data_ptr() == rows[0].data_ptr()
    assert hits == set(BRANCHES), hits
    print(f"\ntail B={batch} {dtype_name} N={horizon} substeps={substeps} {flags}: "
          + ", ".join(f"{k} {v:.3g}" for k, v in worst.items()) + f" (limit {rtol:g})")


@pytest.mark.cuda
def test_cuda_tail_takes_non_contiguous_fields(track):
    """Exact mode's plain solve may return non-contiguous fields: the tail
    makes them contiguous and gives the same bits.  Without the packed
    constants the kernel raises: it never packs them per call."""
    _need_cuda()
    model, p = _setup(track, torch.float64, "cuda")
    cfg = SolverConfig(horizon=10)
    pk = ilqr.pack(model, p, cfg)
    x, us, lam, cost, viol = (t.to("cuda") for t in _inputs(model, p, cfg, (7,), 14, 0, 11))
    strided = lambda t: t.transpose(0, -1).contiguous().transpose(0, -1)
    assert not strided(us).is_contiguous()
    a = cycle_tail.tail(model, p, cfg, x, SolveResult(us, None, lam, cost, viol), pk)
    b = cycle_tail.tail(model, p, cfg, strided(x),
                        SolveResult(strided(us), None, strided(lam), cost, viol), pk)
    for ta, tb in zip((*a[0], *a[1]), (*b[0], *b[1])):
        assert torch.equal(ta, tb)
    with pytest.raises(ValueError, match="packed constants"):
        cycle_tail.tail(model, p, cfg, x, SolveResult(us, None, lam, cost, viol))


@pytest.mark.cuda
@pytest.mark.parametrize("loop", ["closed_loop", "closed_loop_batch"])
def test_cuda_tail_launches_count_the_cycles(track, monkeypatch, loop):
    """After a graphed loop of 2G + 7 cycles the tail launches read its
    cycles: a replay adds the launches its graph recorded, and the capture's
    warm-up and recording are not counted."""
    _need_cuda()
    monkeypatch.setattr(runner, "_PROGRAMS", {})
    monkeypatch.setattr(profiling, "COUNTS", Counter())
    model, p = _setup(track, torch.float32, "cuda")
    x0 = torch.as_tensor(runner.X0_REFERENCE, dtype=torch.float32, device="cuda")
    if loop == "closed_loop_batch":
        x0 = x0.repeat(8, 1)
    steps = 2 * runner.GRAPH_CYCLES + 7
    getattr(runner, loop)(model, p, SolverConfig(horizon=10), x0, steps)
    torch.cuda.synchronize()
    assert profiling.counts()["cycle_tail.tail"] == steps
    assert all(prog.graph is not None and prog.counts["cycle_tail.tail"] == prog.cycles
               for prog in runner._PROGRAMS.values())

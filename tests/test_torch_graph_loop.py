"""The closed loops by programs of G cycles (`mpc/runner._Program`), against
the eager loop.

On a CUDA device a Gauss-Newton loop replays captured CUDA graphs of G
control cycles over fixed carry and output tensors.  Nothing here can
capture a graph, so the CPU tests run the same programs uncaptured
(`runner._loop`, `runner._closed_loop_chunked` with `cycles=G`) and hold
them to the eager loop (`cycles=0`, `runner._advance`) bit for bit: the
single stream, the fleet (B=4) and the chunked loop with a checkpoint and a
resume, in float64 and float32, at G = 1, 3 and 7 over 10 and 17 cycles
(tails of 1-6 cycles).  The loops run a cheap solver budget (horizon 4, 1
AL round × 1 iLQR iteration, 2 rungs, 1 RK4 substep): what is tested is the
programs' carry and output buffers, not the solver.  Then the program
cache's key (fault R1 of the JAX runner's `_const_jit`: the port's key holds
both model flags, the whole `SolverConfig`, dtype, device, the leading
shape, G and every buffer's identity and version) and the cache itself.

The `cuda` tests skip here and run on the card; this file imports no JAX,
so they also run where only the port is installed:

    python -m pytest --noconftest tests/test_torch_graph_loop.py -q -m cuda

There the four loops replay graphs bit-equal to the eager loop, a program
is captured once per key and G, the solve launches read steps + 2, and a
capture that fails raises.
"""

import copy
import dataclasses
import os
from collections import Counter
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from lap_time_optimization_tpu_torch.models import load_vehicle
from lap_time_optimization_tpu_torch.models.bicycle import BicycleModel
from lap_time_optimization_tpu_torch.mpc import runner
from lap_time_optimization_tpu_torch.mpc import track as mpc_track
from lap_time_optimization_tpu_torch.mpc.solver import OCPParams, SolverConfig
from lap_time_optimization_tpu_torch.utils import checkpoint, profiling

REPO_DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "data")
CFG = SolverConfig(horizon=4, substeps=1, al_iters=1, ilqr_iters=1, n_linesearch=2)
CHUNK = 4
DTYPES = {"float64": torch.float64, "float32": torch.float32}


@pytest.fixture(scope="module")
def track():
    if not os.path.isdir(os.path.join(REPO_DATA, "plots", "MX-5", "buckmore", "curvature")):
        pytest.skip("shipped curvature artifacts not available")
    return mpc_track.load("MX-5", "buckmore", "curvature", base_dir=REPO_DATA)


def _setup(track, dtype, device="cpu", **flags):
    """A model of its own (the track copied, so flags and buffers edited
    here stay here) and the OCP parameters."""
    model = BicycleModel(load_vehicle("MX5"), copy.deepcopy(track), **flags).to(device, dtype)
    return model, OCPParams.reference(dtype, device, lateral_margin=0.05)


def _x0(dtype, batch=None, device="cpu"):
    x0 = runner.X0_REFERENCE if batch is None else (
        np.tile(runner.X0_REFERENCE, (batch, 1)) + 0.01 * np.arange(batch)[:, None])
    return torch.as_tensor(x0, dtype=dtype, device=device)


def _assert_same(got, ref):
    for name, a, b in zip(runner.SimResult._fields, got, ref):
        assert a.shape == b.shape and torch.equal(a, b), name


@pytest.fixture(scope="module")
def eager(track):
    """The eager loop's result per (dtype, batch, steps), computed once."""
    cache = {}

    def get(dtype_name, batch, steps):
        key = (dtype_name, batch, steps)
        if key not in cache:
            model, p = _setup(track, DTYPES[dtype_name])
            cache[key] = runner._loop(model, p, CFG, _x0(DTYPES[dtype_name], batch), steps, 0)
        return cache[key]

    return get


@pytest.mark.parametrize("steps", [10, 17])
@pytest.mark.parametrize("cycles", [1, 3, 7])
@pytest.mark.parametrize("loop", ["closed_loop", "closed_loop_batch", "closed_loop_chunked"])
@pytest.mark.parametrize("dtype_name", list(DTYPES))
def test_programs_match_eager(track, eager, tmp_path, dtype_name, loop, cycles, steps):
    """The programs' body, uncaptured, gives the eager loop's bits: the
    carry crosses programs (and a tail program of steps mod G cycles)
    through the fixed carry tensors, the outputs through one copy per field.
    The chunked loop (chunks of 4, which G = 3 and 7 do not divide) writes a
    checkpoint after every chunk; a rerun resumes at the last one, copies
    the saved carry into the programs' carry and gives the same bits."""
    dtype = DTYPES[dtype_name]
    model, p = _setup(track, dtype)
    batch = 4 if loop == "closed_loop_batch" else None
    ref = eager(dtype_name, batch, steps)
    if loop == "closed_loop_chunked":
        cp = str(tmp_path / "sim_checkpoint.npz")
        got = runner._closed_loop_chunked(model, p, CFG, _x0(dtype), steps, CHUNK, cp, cycles)
        assert int(checkpoint.load(cp)["done"]) == (steps - 1) // CHUNK * CHUNK
        _assert_same(got, ref)
        got = runner._closed_loop_chunked(model, p, CFG, _x0(dtype), steps, CHUNK, cp, cycles)
    else:
        got = runner._loop(model, p, CFG, _x0(dtype, batch), steps, cycles)
    _assert_same(got, ref)


def test_programs_run_no_eager_cycle(track, monkeypatch):
    """With G > 0 every cycle runs in a program: `_advance` is never called,
    the programs are built once per cycle count (10 cycles at G = 4: 4, 4
    and a tail of 2) and reused by a second loop, and on the CPU nothing is
    captured and no solve kernel is launched."""
    model, p = _setup(track, torch.float64)
    monkeypatch.setattr(runner, "_advance", lambda *a: pytest.fail("eager cycle"))
    monkeypatch.setattr(runner, "_PROGRAMS", {})
    counts = profiling.counts()
    first = runner._loop(model, p, CFG, _x0(torch.float64), 10, 4)
    assert sorted(key[7] for key in runner._PROGRAMS) == [2, 4]
    progs = dict(runner._PROGRAMS)
    _assert_same(runner._loop(model, p, CFG, _x0(torch.float64), 10, 4), first)
    assert runner._PROGRAMS == progs
    assert profiling.counts() == counts
    assert all(prog.graph is None for prog in progs.values())


def test_zero_steps(track):
    """No cycle, no program: x[0] = x0, u[0] = 0 and empty scalars."""
    model, p = _setup(track, torch.float64)
    x0 = _x0(torch.float64)
    for res in (runner._loop(model, p, CFG, x0, 0, 3),
                runner._closed_loop_chunked(model, p, CFG, x0, 0, CHUNK, None, 3)):
        assert res.xs.shape == (1, 8) and torch.equal(res.xs[0], x0) and not res.us.any()
        assert res.costs.shape == res.violations.shape == res.sdot.shape == (0,)


@pytest.mark.parametrize("hessian_mode, device, expected", [
    ("gauss_newton", "cuda", runner.GRAPH_CYCLES), ("exact", "cuda", 0),
    ("gauss_newton", "cpu", 0), ("exact", "cpu", 0)])
def test_which_loops_are_graphed(hessian_mode, device, expected):
    """Gauss-Newton loops on a CUDA device run graphs of `GRAPH_CYCLES`
    cycles; exact mode (its plain `torch.func` solve) and the CPU run the
    eager loop.  Only the states' device is read, so no card is needed."""
    x0 = SimpleNamespace(device=torch.device(device, 0) if device == "cuda" else torch.device(device))
    assert runner._cycles(x0, SolverConfig(hessian_mode=hessian_mode)) == expected


# ------------------------------------------------------------------ the key
def _key(model, p, cfg=CFG, x0=None, cycles=3):
    return runner._program_key(model, p, cfg, _x0(torch.float64) if x0 is None else x0, cycles)


def test_key_is_equal_for_the_same_objects(track):
    model, p = _setup(track, torch.float64)
    assert _key(model, p) == _key(model, p)
    assert hash(_key(model, p)) == hash(_key(model, p))


@pytest.mark.parametrize("flag", ["enable_traction_ellipse", "enable_torque_vectoring", "closed"])
def test_key_holds_the_model_flags(track, flag):
    """Fault R1: the same model object, its buffers untouched, with one flag
    flipped, is another program."""
    model, p = _setup(track, torch.float64)
    owner = model.track if flag == "closed" else model
    before = _key(model, p)
    setattr(owner, flag, not getattr(owner, flag))
    assert _key(model, p) != before


@pytest.mark.parametrize("field", [f.name for f in dataclasses.fields(SolverConfig)])
def test_key_holds_every_config_field(track, field):
    model, p = _setup(track, torch.float64)
    value = getattr(CFG, field)
    other = ("exact" if field == "hessian_mode" else
             value + 1 if isinstance(value, int) else value * 1.5)
    assert _key(model, p, dataclasses.replace(CFG, **{field: other})) != _key(model, p)


def test_key_holds_dtype_shape_and_cycles(track):
    model, p = _setup(track, torch.float64)
    keys = [_key(model, p, x0=_x0(torch.float64)), _key(model, p, x0=_x0(torch.float32)),
            _key(model, p, x0=_x0(torch.float64, 4)), _key(model, p, x0=_x0(torch.float64, 5)),
            _key(model, p, x0=_x0(torch.float64, 1)), _key(model, p, cycles=4)]
    assert len(set(keys)) == len(keys)


@pytest.mark.parametrize("owner", ["ocp", "vehicle", "track"])
def test_key_holds_buffer_versions(track, owner):
    """An in-place edit to a buffer (same object, same values) changes the
    key, and the cache then builds another program."""
    model, p = _setup(track, torch.float64)
    buf = {"ocp": p.q_n, "vehicle": model.vehicle.mass, "track": model.track.k_vals}[owner]
    x0 = _x0(torch.float64)
    before = _key(model, p)
    first = runner._program(model, p, CFG, x0, 3)
    assert runner._program(model, p, CFG, x0, 3) is first
    with torch.no_grad():
        buf.mul_(1.0)
    assert _key(model, p) != before
    assert runner._program(model, p, CFG, x0, 3) is not first


def test_key_holds_buffer_identity(track):
    """Two models of equal values are two programs, and a program keeps its
    model, parameters and pack alive, so their ids are not reused."""
    (m1, p1), (m2, p2) = _setup(track, torch.float64), _setup(track, torch.float64)
    assert _key(m1, p1) != _key(m2, p2) and _key(m1, p1) != _key(m1, p2)
    prog = runner._program(m1, p1, CFG, _x0(torch.float64), 3)
    assert prog.model is m1 and prog.p is p1 and len(prog.pack) == 3


def test_cache_is_bounded(track, monkeypatch):
    """At most 32 programs, the oldest evicted first, as JAX bounds its
    `_const_jit` cache."""
    monkeypatch.setattr(runner, "_PROGRAMS", {})
    model, p = _setup(track, torch.float64)
    x0 = _x0(torch.float64)
    first = runner._program(model, p, CFG, x0, 1)
    for cycles in range(2, runner._MAX_PROGRAMS + 2):
        runner._program(model, p, CFG, x0, cycles)
    assert len(runner._PROGRAMS) == runner._MAX_PROGRAMS
    assert first not in runner._PROGRAMS.values()
    assert min(key[7] for key in runner._PROGRAMS) == 2


# --------------------------------------------------------------- on the card
def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (graphs are captured on the card only)")


@pytest.fixture
def fresh(monkeypatch):
    """An empty program cache and zeroed counts."""
    monkeypatch.setattr(runner, "_PROGRAMS", {})
    monkeypatch.setattr(profiling, "COUNTS", Counter())


CARD_CFG = SolverConfig(horizon=10)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype_name", list(DTYPES))
@pytest.mark.parametrize("loop", ["closed_loop", "closed_loop_batch", "closed_loop_chunked",
                                  "closed_loop_fleet"])
def test_cuda_graphed_equals_eager(track, fresh, tmp_path, loop, dtype_name):
    """Each public loop on the card (graphs of `GRAPH_CYCLES` cycles, 2G + 7
    cycles: a tail program) against the eager loop on the card, bit for bit;
    the chunked loop in chunks of G + 3 with a checkpoint and a resume; the
    fleet (B=32, bench.py's x0 + 0.01·b) without a mesh."""
    _need_cuda()
    dtype = DTYPES[dtype_name]
    model, p = _setup(track, dtype, "cuda")
    G = runner.GRAPH_CYCLES
    steps = 2 * G + 7
    batch = 32 if loop in ("closed_loop_batch", "closed_loop_fleet") else None
    x0 = _x0(dtype, batch, "cuda")
    ref = runner._loop(model, p, CARD_CFG, x0, steps, 0)
    if loop == "closed_loop_chunked":
        cp = str(tmp_path / "sim_checkpoint.npz")
        got = runner.closed_loop_chunked(model, p, CARD_CFG, x0, steps, G + 3, cp)
        _assert_same(got, ref)
        got = runner.closed_loop_chunked(model, p, CARD_CFG, x0, steps, G + 3, cp)
    elif loop == "closed_loop_fleet":
        got = runner.closed_loop_fleet(model, p, CARD_CFG, x0, steps, None)
    else:
        got = getattr(runner, loop)(model, p, CARD_CFG, x0, steps)
    torch.cuda.synchronize()
    assert profiling.counts()["runner.graph_captures"] >= 2
    assert all(prog.graph is not None for prog in runner._PROGRAMS.values())
    _assert_same(got, ref)


@pytest.mark.cuda
def test_cuda_captures_once_per_key_and_cycles(track, fresh):
    """One capture per program: a loop of 2G + 7 cycles captures G and 7,
    a second loop none, and a flag flipped on the same model or an in-place
    edit to a buffer captures both again.  The solve launches read steps + 2
    each time (a replay adds those its graph holds); the warm-up and the
    captures count apart."""
    _need_cuda()
    model, p = _setup(track, torch.float32, "cuda")
    x0 = _x0(torch.float32, device="cuda")
    G = runner.GRAPH_CYCLES
    steps = 2 * G + 7
    expected = [2, 2, 4, 6]
    for i, change in enumerate(("first", "again", "flag", "edit")):
        if change == "flag":
            model.enable_torque_vectoring = True
        elif change == "edit":
            with torch.no_grad():
                p.q_n.mul_(1.0)
        solves = profiling.counts()["ilqr.solve"]
        runner.closed_loop(model, p, CARD_CFG, x0, steps)
        torch.cuda.synchronize()
        assert profiling.counts()["runner.graph_captures"] == expected[i], change
        assert profiling.counts()["ilqr.solve"] - solves == steps + 2, change
    # per capture: a warm-up cycle and the body
    assert profiling.counts()["runner.capture.ilqr.solve"] == 3 * (G + 1 + 7 + 1)
    assert sorted(prog.counts["ilqr.solve"] for prog in runner._PROGRAMS.values()) == [7, 7, 7, G, G, G]


@pytest.mark.cuda
def test_cuda_failed_capture_raises(track, fresh, monkeypatch):
    """A cycle that cannot be captured (here one that reads a value back to
    the host) makes the loop raise: no eager cycle runs in its place and no
    program is kept.  Runs last: the capture it breaks is abandoned."""
    _need_cuda()
    model, p = _setup(track, torch.float32, "cuda")
    x0 = _x0(torch.float32, device="cuda")
    step_fn = runner._step_fn

    def host_sync(*a, **k):
        carry, out = step_fn(*a, **k)
        float(out[2])  # a device-to-host copy: not allowed while capturing
        return carry, out

    monkeypatch.setattr(runner, "_step_fn", host_sync)
    monkeypatch.setattr(runner, "_advance", lambda *a: pytest.fail("eager cycle"))
    with pytest.raises(RuntimeError):
        runner.closed_loop(model, p, CARD_CFG, x0, 5)
    counts = profiling.counts()
    assert runner._PROGRAMS == {} and counts["runner.graph_captures"] == 0 and counts["ilqr.solve"] == 2

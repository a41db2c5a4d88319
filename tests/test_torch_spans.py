"""The program's span recorder (`utils/profiling`) and the closed loop's
spans (`mpc/runner`).

Off, `profiling.span` returns one shared no-op context and a loop records
nothing.  On, a loop of 25 cycles by uncaptured programs of G = 10 records
one `runner.request`, one `runner.presolve` and three `runner.replay`
spans (10, 10 and 5 cycles) that share the request's id and nest in it,
and its trajectory is bit-equal to the loop's with the recorder off.  The
recorder's clock is the one torch.profiler stamps its events with.  The
loops run a cheap solver budget (horizon 4, 1 AL round x 1 iLQR
iteration): what is tested is the spans, not the solver.

The `cuda` test skips here and runs on the card; this file imports no JAX:

    python -m pytest --noconftest tests/test_torch_spans.py -q -m cuda

There the programs are captured: the same spans, one `runner.capture` per
new program with its three children, a finite, positive `device_ms` on
every device span, and steps + 2 solve launches.
"""

import copy
import json
import math
import os
import statistics
import time
from collections import Counter

import pytest
import torch

from lap_time_optimization_tpu_torch.models import load_vehicle
from lap_time_optimization_tpu_torch.models.bicycle import BicycleModel
from lap_time_optimization_tpu_torch.mpc import runner
from lap_time_optimization_tpu_torch.mpc import track as mpc_track
from lap_time_optimization_tpu_torch.mpc.solver import OCPParams, SolverConfig
from lap_time_optimization_tpu_torch.utils import profiling

REPO_DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "data")
CFG = SolverConfig(horizon=4, substeps=1, al_iters=1, ilqr_iters=1, n_linesearch=2)
STEPS, G = 25, 10


@pytest.fixture(scope="module")
def track():
    if not os.path.isdir(os.path.join(REPO_DATA, "plots", "MX-5", "buckmore", "curvature")):
        pytest.skip("shipped curvature artifacts not available")
    return mpc_track.load("MX-5", "buckmore", "curvature", base_dir=REPO_DATA)


def _setup(track, dtype=torch.float64, device="cpu"):
    model = BicycleModel(load_vehicle("MX5"), copy.deepcopy(track)).to(device, dtype)
    p = OCPParams.reference(dtype, device, lateral_margin=0.05)
    return model, p, torch.as_tensor(runner.X0_REFERENCE, dtype=dtype, device=device)


@pytest.fixture(autouse=True)
def recorder_off():
    """Every test starts and ends with the recorder off."""
    profiling.record(False)
    yield
    profiling.record(False)


def _by_name(spans):
    out = {}
    for s in spans:
        out.setdefault(s["name"], []).append(s)
    return out


def _assert_loop_spans(spans, steps=STEPS, cycles=G):
    """One request, one presolve, a replay per program run; all share the
    request's id, the presolve and the replays are its children, and each
    span lies inside its parent."""
    named = _by_name(spans)
    (req,), (pre,) = named["runner.request"], named["runner.presolve"]
    replays = named["runner.replay"]
    assert req["parent"] is None and req["request"] == req["id"]
    assert req["attrs"] == {"batch": 1, "cycles": steps}
    runs = [min(cycles, steps - t) for t in range(0, steps, cycles)]
    assert [r["attrs"]["cycles"] for r in replays] == runs
    by_id = {s["id"]: s for s in spans}
    for s in spans:
        assert s["request"] == req["id"]
        assert s["start_ns"] <= s["end_ns"]
        if s["parent"] is not None:
            parent = by_id[s["parent"]]
            assert parent["start_ns"] <= s["start_ns"] and s["end_ns"] <= parent["end_ns"]
    assert pre["parent"] == req["id"] and all(r["parent"] == req["id"] for r in replays)
    assert pre["end_ns"] <= replays[0]["start_ns"]
    return named


def test_off_records_nothing(track):
    """Off (the default), `span()` is one shared object that records
    nothing, and a loop leaves the recording empty."""
    model, p, x0 = _setup(track)
    profiling.record(True)
    profiling.record(False)
    assert profiling.span("a") is profiling.span("b", device="cpu", request=True, cycles=3)
    with profiling.span("a") as attrs:
        assert attrs is None
    runner._loop(model, p, CFG, x0, STEPS, G)
    assert profiling.spans() == [] and profiling.RECORDER.records == []


def test_loop_spans_on_the_cpu(track):
    """On, a 25-cycle loop by uncaptured programs of G = 10 records one
    request, one presolve and three replays (10, 10, 5), nothing captured
    and no device time on the CPU; its trajectory is the trajectory with
    the recorder off, bit for bit."""
    model, p, x0 = _setup(track)
    off = runner._loop(model, p, CFG, x0, STEPS, G)
    with profiling.recording():
        on = runner._loop(model, p, CFG, x0, STEPS, G)
    spans = profiling.spans()
    named = _assert_loop_spans(spans)
    assert len(spans) == 5 and "runner.capture" not in named
    assert all(s["device_ms"] is None and s["device_at_ms"] is None for s in spans)
    for name, a, b in zip(runner.SimResult._fields, on, off):
        assert torch.equal(a, b), name


def test_chunked_loop_is_one_request(track):
    """The chunked loop (chunks of 7, programs of 10: each chunk runs its
    own programs) is one request with one presolve."""
    model, p, x0 = _setup(track)
    with profiling.recording():
        runner._closed_loop_chunked(model, p, CFG, x0, 20, 7, None, G)
    named = _by_name(profiling.spans())
    (req,) = named["runner.request"]
    assert len(named["runner.presolve"]) == 1
    assert [r["attrs"]["cycles"] for r in named["runner.replay"]] == [7, 7, 6]
    assert all(s["request"] == req["id"] for s in profiling.spans())


def test_each_recording_starts_empty_and_requests_are_apart(track):
    """Two loops in one recording are two requests; a new recording drops
    the last one's spans; a span outside any request has none."""
    model, p, x0 = _setup(track)
    with profiling.recording():
        with profiling.span("outside") as attrs:
            attrs["k"] = 1
        runner._loop(model, p, CFG, x0, 3, G)
        runner._loop(model, p, CFG, x0, 3, G)
    spans = profiling.spans()
    assert spans[0]["name"] == "outside" and spans[0]["request"] is None and spans[0]["attrs"] == {"k": 1}
    reqs = [s["id"] for s in spans if s["name"] == "runner.request"]
    assert len(reqs) == 2 and {s["request"] for s in spans[1:]} == set(reqs)
    with profiling.recording():
        pass
    assert profiling.spans() == []


def test_write_spans_and_timer_report(tmp_path):
    """`write_spans` writes one JSON object a line; `Timer.span` still
    keeps each name's wall times for `report()`."""
    with profiling.recording() as timer:
        for _ in range(3):
            with profiling.span("outer", note="x"):
                with profiling.span("inner"):
                    time.sleep(0.001)
    path = tmp_path / "spans.jsonl"
    assert profiling.write_spans(str(path)) == 6
    rows = [json.loads(line) for line in path.read_text().splitlines()]
    assert rows == profiling.spans()
    assert set(rows[0]) == {"name", "id", "parent", "request", "start_ns", "end_ns", "attrs", "device_ms",
                            "device_at_ms"}
    report = timer.report()
    assert report["outer"]["count"] == report["inner"]["count"] == 3
    assert report["inner"]["first_s"] >= 0.001 and report["outer"]["steady_s"] >= report["inner"]["steady_s"]


def test_clock_is_the_profilers():
    """Under torch.profiler, a span around a `record_function` block
    encloses that event's start_ns()..end_ns(), and by little: the median
    slack at each end is under 100 us (the first block, the profiler's own
    warm-up, is left out)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU]) as prof, profiling.recording():
        for _ in range(21):
            with profiling.span("port"):
                with record_function("block"):
                    torch.ones(64).sum()
    events = sorted((e.start_ns(), e.end_ns()) for e in prof.profiler.kineto_results.events()
                    if e.name() == "block")
    spans = [(s["start_ns"], s["end_ns"]) for s in profiling.spans()]
    assert len(events) == len(spans) == 21
    head = [ev[0] - sp[0] for sp, ev in zip(spans, events)]
    tail = [sp[1] - ev[1] for sp, ev in zip(spans, events)]
    assert min(head) >= 0 and min(tail) >= 0, (head, tail)
    assert statistics.median(head[1:]) < 100_000 and statistics.median(tail[1:]) < 100_000, (head, tail)


# --------------------------------------------------------------- on the card
@pytest.fixture
def fresh(monkeypatch):
    """An empty program cache and zeroed counts."""
    monkeypatch.setattr(runner, "_PROGRAMS", {})
    monkeypatch.setattr(profiling, "COUNTS", Counter())


@pytest.mark.cuda
def test_cuda_loop_spans(track, fresh):
    """On the card (graphs of G = 10; 25 cycles: programs of 10 and 5),
    the CPU's spans, plus one `runner.capture` per new program (none on a
    second loop) with its three children; every device span has a finite,
    positive `device_ms`; the solve launches read steps + 2 each loop."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (graphs are captured on the card only)")
    model, p, x0 = _setup(track, torch.float32, "cuda")
    cfg = SolverConfig(horizon=10)
    for captures in (2, 0):
        solves = profiling.counts()["ilqr.solve"]
        with profiling.recording():
            runner.closed_loop(model, p, cfg, x0, STEPS)
        spans = profiling.spans()
        named = _assert_loop_spans(spans, cycles=runner.GRAPH_CYCLES)
        assert profiling.counts()["ilqr.solve"] - solves == STEPS + 2
        caps = named.get("runner.capture", [])
        assert len(caps) == captures
        for cap in caps:
            assert cap["attrs"]["pool_bytes"] >= 0 and cap["device_ms"] is None
            kids = [s["name"] for s in spans if s["parent"] == cap["id"]]
            assert kids == ["runner.capture.warmup", "runner.capture.record", "runner.capture.instantiate"]
        for s in named["runner.request"] + named["runner.presolve"] + named["runner.replay"]:
            assert math.isfinite(s["device_ms"]) and s["device_ms"] > 0, s
            assert s["device_at_ms"] >= 0, s
        (req,) = named["runner.request"]
        assert sum(r["device_ms"] for r in named["runner.replay"]) <= req["device_ms"]

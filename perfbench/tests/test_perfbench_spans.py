"""The readings of the port's spans (`perfbench/spans.py`): on hand-made
spans and device events, without spans, and in a run of a tiny cell on the
CPU with the recorder on."""

import json
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from perfbench import run, spans, trace  # noqa: E402
from perfbench.tests.test_perfbench_harness import TINY, tiny_checkout  # noqa: E402

MS = 1_000_000  # ns


def span(i, name, start, end, request, parent=None, device_ms=None, at=None, **attrs):
    return {"name": name, "id": i, "parent": parent, "request": request, "start_ns": start * MS,
            "end_ns": end * MS, "attrs": attrs, "device_ms": device_ms, "device_at_ms": at}


def two_requests(capture=True):
    """A warm-up request that captures (0-40 ms), then two window requests
    (100-130 and 200-230 ms) of a presolve and replays of 10, 10 and 5
    cycles; times in ms."""
    out = [span(0, "runner.request", 0, 40, 0, device_ms=39.0, at=0.0, batch=1, cycles=25)]
    if capture:
        out += [span(1, "runner.capture", 5, 15, 0, parent=0, pool_bytes=1024),
                span(2, "runner.capture.warmup", 5, 8, 0, parent=1)]
    for base, rid, pre, reps in ((100, 10, 6.0, (3.0, 3.2, 1.5)), (200, 20, 8.0, (3.4, 3.6, 1.7))):
        out.append(span(rid, "runner.request", base, base + 30, rid, device_ms=29.0, at=float(base), batch=1,
                        cycles=25))
        out.append(span(rid + 1, "runner.presolve", base + 1, base + 5, rid, parent=rid, device_ms=pre))
        for k, (ms, n) in enumerate(zip(reps, (10, 10, 5))):
            out.append(span(rid + 2 + k, "runner.replay", base + 6 + 5 * k, base + 9 + 5 * k, rid, parent=rid,
                            device_ms=ms, cycles=n))
    return out


def test_presolve_and_replay_read_the_window_after_the_profiled_requests():
    s = two_requests()
    assert spans.presolve_ms(s, window=2) == pytest.approx(7.0)
    assert spans.presolve_ms(s, window=2, skip=1) == pytest.approx(8.0)
    # the replays of the longest program (10 cycles) only
    assert spans.replay_ms(s, window=2) == pytest.approx(3.3)
    assert spans.replay_ms(s, window=2, skip=1) == pytest.approx(3.5)
    assert spans.capture_s(s) == pytest.approx(0.010)
    assert [r["id"] for r in spans.window_requests(s, 2)] == [10, 20]


def test_readings_are_none_without_spans():
    dev, host = [], [(trace.REQUEST_SPAN, 0, 10 * MS)]
    for found in (None, []):
        assert spans.presolve_ms(found, 2) is None and spans.replay_ms(found, 2) is None
        assert spans.capture_s(found) is None and spans.program_idle_ms(found, dev, host) is None
        assert spans.request_slack_ms(found, host) is None
    assert spans.capture_s(two_requests(capture=False)) is None
    assert spans.program_idle_ms(two_requests(), [], []) is None  # no trace
    assert spans.readings([], 2, 0) == {"presolve_ms": None, "replay_ms": None, "program_idle_ms": None,
                                        "request_idle_ms": None, "capture_s": None, "request_slack_ms": None}


def test_program_idle_is_the_idle_inside_the_ports_request_spans():
    """The harness's request 95-135 ms, the port's 100-130 ms; the device
    busy 96-99, 101-120 and 121-131: idle 95-96, 99-101, 120-121 and
    131-135 (8 ms), of which 100-101 and 120-121 inside the port's span."""
    s = two_requests()
    host = [(trace.REQUEST_SPAN, 95 * MS, 135 * MS), ("cudaGraphLaunch", 110 * MS, 111 * MS)]
    dev = [("k", 96 * MS, 99 * MS), ("k", 101 * MS, 120 * MS), ("k", 121 * MS, 131 * MS),
           ("k", 300 * MS, 310 * MS)]
    assert spans.request_idle_ms(dev, host) == pytest.approx(8.0)
    assert spans.program_idle_ms(s, dev, host) == pytest.approx(2.0)
    assert spans.request_slack_ms(s, host) == [(pytest.approx(5.0), pytest.approx(5.0))]
    # never more than the request's whole idle time, whatever the device did
    for busy in ([], dev[:1], dev[1:], [("k", 0, 400 * MS)]):
        assert spans.program_idle_ms(s, busy, host) <= spans.request_idle_ms(busy, host) + 1e-9


def test_split_reads_each_window_request():
    rows = spans.split(two_requests(), 2)
    assert len(rows) == 2
    first = rows[0]
    assert first["wall_ms"] == pytest.approx(30.0) and first["presolve_ms"] == 6.0
    assert first["replay_sum_ms"] == pytest.approx(7.7) and first["replay_median_ms"] == pytest.approx(3.0)
    assert first["replay_host_ms"] == pytest.approx(9.0)
    assert first["between_ms"] == pytest.approx(30.0 - 4.0 - 9.0)
    assert first["gap_to_next_ms"] == pytest.approx(200.0 - 100.0 - 29.0)
    assert rows[1]["gap_to_next_ms"] is None


def test_a_run_of_a_tiny_cell_with_spans_on_the_cpu(tmp_path):
    """`spans.execute` on the CPU: the run's result as run.py gives it,
    the spans file, one request span per request (the window's after set-up's),
    each inside its harness request event, and no device time to read."""
    root = tiny_checkout(tmp_path)
    path = str(tmp_path / "spans.jsonl")
    args = run.parse(["--workload", TINY, "--seed", str(2**31 + 9), "--seconds", "0", "--trace", "1"])
    result, err, rows = spans.execute(args, path, "cpu", root=root, chips_check=False)
    assert result["correct"], err
    assert list(result)[-2:] == ["spans", "check"]
    found = [json.loads(line) for line in open(path)]
    reqs = [s for s in found if s["name"] == "runner.request"]
    assert len(reqs) == 1 + result["attempted"] and len(rows) == result["attempted"]  # warm-up, then the window
    got = result["spans"]
    assert got["presolve_ms"] is None and got["replay_ms"] is None and got["capture_s"] is None
    assert 0 <= got["program_idle_ms"] <= got["request_idle_ms"]
    (head, tail), = got["request_slack_ms"]
    assert 0 <= head < 1000 and 0 <= tail < 1000

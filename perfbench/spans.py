"""The port's own spans in a benchmark run, and what they read.

    python3 perfbench/spans.py --spans PATH --workload <cell> --seed <n> --seconds <s> --trace <0|1>

runs one run of `perfbench/run.py` (the same arguments, the same result)
with the port's span recorder (`lap_time_optimization_tpu_torch.utils.
profiling`) on from the process's start, so set-up's captures are in it
too, and without CUPTI where `--trace` is 0.  It writes the spans to PATH
as JSON lines, adds their readings to the result line under "spans", and
writes a line per window request to standard error.  The port records
`runner.request` (a loop's whole call, on a CUDA device also timed by CUDA
events), `runner.presolve`, `runner.replay` (one per program run, with its
output copies) and `runner.capture` (host only, with `.warmup`, `.record`
and `.instantiate` inside).

The readings (each None where there is nothing to read):
- `presolve_ms`: the median `device_ms` of `runner.presolve` over the
  window's requests after the profiled ones;
- `replay_ms`: the median `device_ms` of the `runner.replay` spans of the
  longest program (G cycles), same requests;
- `program_idle_ms`: per profiled request, the device's idle time (the
  gaps `perfbench/trace.py` finds between the profiler's device events)
  while the host is inside a `runner.request` span: the spans share the
  profiler's clock, `time.time_ns()`;
- `request_idle_ms`: per profiled request, all the device's idle time;
- `capture_s`: the host seconds of every `runner.capture` span of the run;
- `request_slack_ms`: for each profiled request, how far its
  `runner.request` span lies inside the harness's `perfbench.request`
  event at each end.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
if os.path.dirname(HERE) not in sys.path:
    sys.path.insert(0, os.path.dirname(HERE))

from perfbench import run as bench  # noqa: E402  (its clock starts the run's set-up)
from perfbench import trace  # noqa: E402

REQUEST, PRESOLVE, REPLAY, CAPTURE = "runner.request", "runner.presolve", "runner.replay", "runner.capture"


def window_requests(spans, window: int, skip: int = 0) -> list:
    """The `runner.request` spans of the window's requests (the last
    `window` of the run), less the first `skip` (the profiled ones)."""
    reqs = [s for s in spans if s["name"] == REQUEST]
    return reqs[max(len(reqs) - window, 0):][skip:]


def _median_device_ms(spans, name, requests, longest=False):
    ids = {r["id"] for r in requests}
    found = [s for s in spans if s["name"] == name and s["request"] in ids and s["device_ms"] is not None]
    if longest and found:
        most = max(s["attrs"]["cycles"] for s in found)
        found = [s for s in found if s["attrs"]["cycles"] == most]
    return statistics.median(s["device_ms"] for s in found) if found else None


def presolve_ms(spans, window: int, skip: int = 0):
    if not spans:
        return None
    return _median_device_ms(spans, PRESOLVE, window_requests(spans, window, skip))


def replay_ms(spans, window: int, skip: int = 0):
    if not spans:
        return None
    return _median_device_ms(spans, REPLAY, window_requests(spans, window, skip), longest=True)


def capture_s(spans):
    caps = [s for s in spans or () if s["name"] == CAPTURE]
    return sum(s["end_ns"] - s["start_ns"] for s in caps) / 1e9 if caps else None


def _traced(host_events):
    return sorted((s, e) for name, s, e in host_events if name == trace.REQUEST_SPAN)


def _gaps(device_events, host_events):
    traced = _traced(host_events)
    lo, hi = traced[0][0], max(e for _, e in traced)
    return traced, trace.gaps_ns([(s, e) for _, s, e in device_events], lo, hi)


def request_idle_ms(device_events, host_events):
    if not _traced(host_events or ()):
        return None
    traced, gaps = _gaps(device_events, host_events)
    return sum(e - s for s, e in gaps) / 1e6 / len(traced)


def program_idle_ms(spans, device_events, host_events):
    if not spans or not _traced(host_events or ()):
        return None
    traced, gaps = _gaps(device_events, host_events)
    inside = [(s["start_ns"], s["end_ns"]) for s in spans if s["name"] == REQUEST]
    return sum(trace.union_ns(inside, s, e) for s, e in gaps) / 1e6 / len(traced)


def request_slack_ms(spans, host_events):
    """[(head, tail)] in ms, one per profiled request: the `runner.request`
    span that overlaps it most, its start after the event's and its end
    before the event's (negative: outside)."""
    reqs = [s for s in spans or () if s["name"] == REQUEST]
    out = []
    for lo, hi in _traced(host_events or ()):
        overlap = lambda r: min(r["end_ns"], hi) - max(r["start_ns"], lo)
        best = max(reqs, key=overlap, default=None)
        if best is not None and overlap(best) > 0:
            out.append(((best["start_ns"] - lo) / 1e6, (hi - best["end_ns"]) / 1e6))
    return out or None


def split(spans, window: int) -> list:
    """A row per window request: its host wall, the host time between its
    spans, its device time, the presolve's, the sum and median of its
    replays' and their host time, and the device's time from its end event
    to the next request's start event."""
    reqs = window_requests(spans, window)
    rows = []
    for i, r in enumerate(reqs):
        kids = [s for s in spans if s["parent"] == r["id"]]
        host = lambda s: (s["end_ns"] - s["start_ns"]) / 1e6
        reps = [s for s in kids if s["name"] == REPLAY]
        dev = [s["device_ms"] for s in reps if s["device_ms"] is not None]
        pre = [s["device_ms"] for s in kids if s["name"] == PRESOLVE]
        nxt = reqs[i + 1] if i + 1 < len(reqs) else None
        gap = None
        if nxt is not None and r["device_ms"] is not None and nxt["device_at_ms"] is not None:
            gap = nxt["device_at_ms"] - r["device_at_ms"] - r["device_ms"]
        rows.append({"wall_ms": host(r), "between_ms": host(r) - sum(host(s) for s in kids),
                     "device_ms": r["device_ms"], "presolve_ms": pre[0] if pre else None,
                     "replay_sum_ms": sum(dev) if dev else None,
                     "replay_median_ms": statistics.median(dev) if dev else None,
                     "replay_host_ms": sum(host(s) for s in reps), "gap_to_next_ms": gap})
    return rows


def readings(spans, window: int, traced: int, events=None) -> dict:
    dev, host = events if events is not None else ((), ())
    return {"presolve_ms": presolve_ms(spans, window, traced), "replay_ms": replay_ms(spans, window, traced),
            "program_idle_ms": program_idle_ms(spans, dev, host), "request_idle_ms": request_idle_ms(dev, host),
            "capture_s": capture_s(spans), "request_slack_ms": request_slack_ms(spans, host)}


def execute(args, spans_path: str, device: str, root: str = bench.ROOT, chips_check: bool = True):
    """`perfbench/run.execute` with the port's recorder on; the spans go to
    `spans_path`.  Returns the result (with "spans": the readings), the
    lines for standard error and the per-request rows."""
    from lap_time_optimization_tpu_torch.utils import profiling

    kept = {}
    read_events = trace.read_events

    def keep(prof):
        kept["events"] = read_events(prof)
        return kept["events"]

    trace.read_events = keep  # the traced run's events, as run.py reads them
    try:
        with profiling.recording():
            result, err = bench.execute(args, device, root, chips_check)
    finally:
        trace.read_events = read_events
    spans = profiling.spans()
    profiling.write_spans(spans_path)
    traced = 0
    if args.trace:
        traced = int(bench.Cell(args.workload, root).traffic.get("trace_requests", 1))
    found = readings(spans, result["attempted"], traced, kept.get("events"))
    result = {**{k: v for k, v in result.items() if k != "check"}, "spans": found, "check": result["check"]}
    return result, err, split(spans, result["attempted"])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--spans", required=True, help="write the run's spans to this file, as JSON lines")
    own, rest = ap.parse_known_args(argv)
    args = bench.parse(rest)
    if not os.path.isdir(os.path.dirname(os.path.abspath(own.spans))):
        ap.error(f"--spans: no directory for {own.spans}")
    try:
        result, err, rows = execute(args, own.spans, "cuda")
    except bench.RunError as exc:
        print(f"perfbench: {exc}", file=sys.stderr)
        return 1
    bad = bench.forbidden_modules()
    if bad:
        print("perfbench: the run loaded " + ", ".join(bad), file=sys.stderr)
        return 1
    err += ["request " + json.dumps(row) for row in rows]
    print("\n".join(err), file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())

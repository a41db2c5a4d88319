"""Timing and observability — port of `lap_time_optimization_tpu/utils/profiling.py`.

* `Timer` — named spans: the wall time of each span under its name (the
  first span of a name kept apart: here the first call's kernel build and
  allocator warm-up), and each span as a record (its id, parent, request,
  start and end on `time.time_ns()`, attributes, and on a CUDA device the
  device time between two CUDA events);
* `record` / `recording`, `span`, `spans`, `write_spans` — the program's
  span recorder: one `Timer`, off by default;
* `count`, `counts`, `set_counts` — the program's event counts: one table
  by "<module>.<event>", where each kernel wrapper counts its launches;
* `trace` — an optional `torch.profiler` session that writes a Chrome trace
  into a directory;
* `log_metrics` — one-line structured (JSON) metric records on stdout;
* `Heartbeat` — a one-line JSON heartbeat file for long searches.

The recorder's clock, `time.time_ns()`, is the one torch.profiler stamps
its events with (nanoseconds since the Unix epoch), so a span and the
profiler's events of the same run line up without conversion.  Recording
never syncs with the device: `spans()` synchronises once, when the
records are read.  Spans nest by the order they open in, so spans are
recorded from one thread.
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import sys
import time

import torch


class Timer:
    """Named spans.  `records` holds every span: `name`, `id`, `parent`
    (the innermost span open at its start), `request` (the id of the
    innermost enclosing span opened with `request=True`, which is its own),
    `start_ns` and `end_ns` on `time.time_ns()`, and `attrs`; `report()`
    gives each name's wall seconds, the first apart from the steady mean."""

    def __init__(self):
        self.records: list[dict] = []
        self._open: list[dict] = []
        self._events: dict[int, tuple] = {}  # record id -> (start, end) CUDA events

    @contextlib.contextmanager
    def span(self, name: str, device=None, request: bool = False, **attrs):
        """A span over the block; yields its `attrs`, which the block may
        add to.  With `device` a CUDA device, two `torch.cuda.Event`s on its
        current stream also time the block's device work (`device_ms` in
        `resolve`)."""
        parent = self._open[-1] if self._open else None
        rec = {"name": name, "id": len(self.records), "parent": None if parent is None else parent["id"],
               "request": None if parent is None else parent["request"], "start_ns": 0, "end_ns": None,
               "attrs": attrs}
        if request:
            rec["request"] = rec["id"]
        self.records.append(rec)
        self._open.append(rec)
        stream = None
        if device is not None and torch.device(device).type == "cuda":
            stream = torch.cuda.current_stream(device)
            start = torch.cuda.Event(enable_timing=True)
            start.record(stream)
        rec["start_ns"] = time.time_ns()
        try:
            yield attrs
        finally:
            if stream is not None:
                end = torch.cuda.Event(enable_timing=True)
                end.record(stream)
                self._events[rec["id"]] = (start, end)
            rec["end_ns"] = time.time_ns()
            self._open.pop()

    def resolve(self) -> list[dict]:
        """The closed spans as plain dicts, in the order they opened, each
        with `device_ms` (its CUDA events' elapsed time, else None) and
        `device_at_ms` (its start event's time after the first device
        span's start event, on the device's clock, else None).  Syncs the
        device once where any span holds CUDA events."""
        if self._events:
            torch.cuda.synchronize()
        first = None
        out = []
        for rec in self.records:
            if rec["end_ns"] is None:
                continue
            item = {**rec, "attrs": dict(rec["attrs"]), "device_ms": None, "device_at_ms": None}
            events = self._events.get(rec["id"])
            if events is not None:
                first = events[0] if first is None else first
                item["device_ms"] = events[0].elapsed_time(events[1])
                item["device_at_ms"] = first.elapsed_time(events[0])
            out.append(item)
        return out

    def report(self) -> dict:
        spans: dict[str, list[float]] = {}
        for rec in sorted((r for r in self.records if r["end_ns"] is not None), key=lambda r: r["end_ns"]):
            spans.setdefault(rec["name"], []).append((rec["end_ns"] - rec["start_ns"]) / 1e9)
        return {
            name: {"first_s": xs[0], "steady_s": (sum(xs[1:]) / len(xs[1:]) if len(xs) > 1 else xs[0]),
                   "count": len(xs)}
            for name, xs in spans.items()
        }


#: The program's span recorder and its switch (`record`).
RECORDER = Timer()
_RECORDING = False
_OFF = contextlib.nullcontext()


def record(on: bool) -> None:
    """Switch the program's span recorder on (a new, empty recording) or
    off (the recording stays readable by `spans()`)."""
    global RECORDER, _RECORDING
    if on:
        RECORDER = Timer()
    _RECORDING = bool(on)


@contextlib.contextmanager
def recording():
    """The recorder on over the block (a new recording), off after it."""
    record(True)
    try:
        yield RECORDER
    finally:
        record(False)


def span(name: str, device=None, request: bool = False, **attrs):
    """`RECORDER.span(...)` while recording; otherwise one shared no-op
    context (it yields None), so a span site costs one check."""
    if not _RECORDING:
        return _OFF
    return RECORDER.span(name, device, request, **attrs)


def spans() -> list[dict]:
    """The current (or last) recording's closed spans (`Timer.resolve`)."""
    return RECORDER.resolve()


def write_spans(path: str) -> int:
    """Write `spans()` to `path` as JSON lines; returns how many."""
    items = spans()
    with open(path, "w") as fh:
        for item in items:
            fh.write(json.dumps(item) + "\n")
    return len(items)


#: The program's event counts by "<module>.<event>" (the solve kernel's
#: launches are "ilqr.solve", and by placement "ilqr.solve.shared" ...): the
#: code that launches a kernel counts it there, and a graph replay adds the
#: counts its capture recorded (`mpc/runner._Program`).
COUNTS: collections.Counter = collections.Counter()


def count(name: str, n: int = 1) -> None:
    """Adds n to the event count `name`."""
    COUNTS[name] += n


def counts() -> collections.Counter:
    """A copy of the whole table (a name never counted reads 0)."""
    return collections.Counter(COUNTS)


def set_counts(table) -> None:
    """Replaces the whole table by `table`."""
    COUNTS.clear()
    COUNTS.update(table)


@contextlib.contextmanager
def trace(logdir: str | None):
    """torch.profiler session over the block, CPU and (where present) CUDA
    activity, written as a Chrome trace `trace.json` into `logdir`; a no-op
    when logdir is None."""
    if logdir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def log_metrics(stream=None, **metrics) -> None:
    print(json.dumps({"metrics": metrics}), file=stream or sys.stdout, flush=True)


class Heartbeat:
    """Writes a one-line JSON heartbeat — the round counter, wall time and
    best objective — to a file (atomic replace) and optionally stdout.  A
    watchdog declares the run stalled when the file's mtime stops
    advancing; with the per-round checkpoints (utils/checkpoint.py) that
    gives detect + resume."""

    def __init__(self, path: str | None = None, echo: bool = False):
        self.path = path
        self.echo = echo
        self.t0 = time.time()

    def beat(self, round_idx: int, **fields) -> None:
        record = {"heartbeat": {"round": round_idx, "wall_s": round(time.time() - self.t0, 3), **fields}}
        line = json.dumps(record)
        if self.echo:
            print(line, flush=True)
        if self.path:
            tmp = self.path + ".tmp"
            with open(tmp, "w") as f:
                f.write(line + "\n")
            os.replace(tmp, self.path)

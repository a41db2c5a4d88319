"""Timing and observability — port of `lap_time_optimization_tpu/utils/profiling.py`.

* `Timer` — named wall-time spans; the first span of a name is kept apart
  (in the JAX package it holds the compile; here the first call's kernel
  build and allocator warm-up);
* `solve_rate` — solves per second;
* `trace` — an optional `torch.profiler` session that writes a Chrome trace
  into a directory;
* `log_metrics` — one-line structured (JSON) metric records on stdout;
* `Heartbeat` — a one-line JSON heartbeat file for long searches.
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
import time


class Timer:
    """Accumulates named wall-time spans; the first span per name is the
    warm-up."""

    def __init__(self):
        self.spans: dict[str, list[float]] = {}

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.spans.setdefault(name, []).append(time.perf_counter() - t0)

    def compile_time(self, name: str) -> float:
        return self.spans[name][0]

    def steady_time(self, name: str) -> float:
        xs = self.spans[name][1:] or self.spans[name]
        return sum(xs) / len(xs)

    def report(self) -> dict:
        return {
            name: {"first_s": xs[0], "steady_s": (sum(xs[1:]) / len(xs[1:]) if len(xs) > 1 else xs[0]),
                   "count": len(xs)}
            for name, xs in self.spans.items()
        }


def solve_rate(n_solves: int, seconds: float) -> float:
    return n_solves / max(seconds, 1e-12)


@contextlib.contextmanager
def trace(logdir: str | None):
    """torch.profiler session over the block, CPU and (where present) CUDA
    activity, written as a Chrome trace `trace.json` into `logdir`; a no-op
    when logdir is None."""
    if logdir is None:
        yield
        return
    import torch
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

"""Liveness and metric records — the part of
`lap_time_optimization_tpu/utils/profiling.py` the searches use.

* `log_metrics` — one-line structured (JSON) metric records on stdout;
* `Heartbeat` — a one-line JSON heartbeat file for long searches.
"""

from __future__ import annotations

import json
import os
import sys
import time


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

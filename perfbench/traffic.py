"""The one generator of requests: initial states drawn from the seed.

A traffic mix is a JSON file of parameters (`perfbench/traffic/<name>.json`):

- `batch`: B, the loops one request runs (1: `runner.closed_loop`, else
  `runner.closed_loop_batch`); `cycles`: control cycles per request;
- `draw`: how each request's initial states are drawn from the
  configuration's `x0`: `s` [low, high] (arc length, uniform, m), `vx`
  [low, high] (uniform), and `n` "in_band" with `band_clearance`
  (the lateral offset moved, from 0, just far enough that the car's
  footprint at mu = 0 keeps that clearance from both boundaries);
- `warm_up_requests`: whole requests of the mix's length that set-up runs
  after the capture (the seed's request 0 again), so that the window
  starts on a card that has run the cell's own work;
- `trace_requests`: the whole requests a `--trace 1` run profiles;
- `check_rows`: how many (request, row) loops the correctness check
  follows, drawn from the seed (null: every row of every request).

Request i of a run draws from `numpy.random.default_rng([seed, i])`, so a
seed gives the same states in every run, and the work of a request (B,
cycles, the solver's fixed iteration counts) is the same for every seed.
"""

from __future__ import annotations

import json

import numpy as np


def load(path: str) -> dict:
    with open(path) as fh:
        return json.load(fh)


def initial_states(traffic: dict, x0, tables, half_width: float, seed: int, index: int) -> np.ndarray:
    """The (B, 8) float64 initial states of request `index`."""
    B = int(traffic["batch"])
    draw = traffic.get("draw", {})
    rng = np.random.default_rng([seed, index])
    x = np.tile(np.asarray(x0, dtype=np.float64), (B, 1))
    if "s" in draw:
        x[:, 0] = rng.uniform(*draw["s"], B)
    if "vx" in draw:
        lo, hi = draw["vx"]
        x[:, 3] = rng.uniform(lo, hi, B)
    if draw.get("n") == "in_band":
        reach = half_width + float(draw["band_clearance"])
        grid = np.linspace(0.0, tables.s_max, tables.k.shape[0])
        nl = np.interp(np.mod(x[:, 0], tables.s_max), grid, tables.nl)
        nr = np.interp(np.mod(x[:, 0], tables.s_max), grid, tables.nr)
        x[:, 1] = np.clip(x[:, 1], reach - nr, nl - reach)
    return x


def check_sample(traffic: dict, n_requests: int, seed: int):
    """The (request, row) pairs the correctness check follows, sorted."""
    B = int(traffic["batch"])
    total = n_requests * B
    rows = traffic.get("check_rows")
    if rows is None or rows >= total:
        pick = np.arange(total)
    else:
        pick = np.sort(np.random.default_rng([seed, 2**32]).choice(total, int(rows), replace=False))
    return [(int(p // B), int(p % B)) for p in pick]

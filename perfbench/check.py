"""What decides `correct`: the closed loops the window ran, held to the
plain reference (`perfbench/reference/`), which imports nothing of the
program and works the track tables out again from the raw artifacts.

Two comparisons, each over every sampled loop (every loop of every request
of a single-stream cell; a seeded sample of (request, row) loops of a
fleet):

- The plant and the clip, over every cycle: from the program's own state
  xs[t] and its own applied input us[t+1], the reference steps its plant in
  float64 and reads the next state's gap |x_program - x_reference| /
  max(1, |x_reference|) (largest component), and reads how far the applied
  input lies outside the clip box that the state sets (the rate limits, and
  the steer and throttle boxes one step ahead).  At the start it reads the
  program's first state against the state the harness drew.  No solver
  decision enters, so in a sound run this is rounding at every cycle: a
  state that is not advanced, a row that is not run, an input recorded
  other than the one applied, all show.  `plant_max` is the largest of them.
- The solver, the solve kernel and the warm start: the reference follows
  each loop from its start, at cycle t solving from the program's xs[t] and
  last input us[t], warm-started by its own shifted solution of cycle t-1
  (its presolve from xs[0] at t = 0), in float64, then clips and steps its
  plant from xs[t].  Per cycle it reads the applied input's gap
  |u_program - u_reference| (largest component; rad/s, 1/s) and the next
  state's, as above.  A value that is not finite counts as infinitely far.

The AL-iLQR's fixed 2 x 5 iterations decide by comparisons (a step kept or
not, the first of the ladder's least costs), so a rounding difference now
and then flips a decision and moves one cycle's input by up to the rate
limits, in a sound float32 run too; and the reference's warm start, its own
shifted solution, drifts from the program's as rounding piles up, so that
in float32 the gaps past the second cycle are set by the loop's sensitivity
and hardly by the arithmetic (PERF.md).  The solver's numbers are
therefore quantiles, which such flips do not move, taken at each of the
first `EARLY` cycle indices apart and the largest kept, so that a fault
that only the second cycle reads (the warm-start shift, the multipliers the
solve hands on) cannot hide behind the first cycle's sound gaps:

- `u_first`, `x_first`: the largest over t < EARLY of the lower quartile
  of the loops' input (next-state) gaps at cycle t; `u_first_q75`: the same
  of the upper quartile, which sees a fault in part of a fleet;
- `u_med`, `u_q90`, `x_med`: the median and the 90th percentile of the
  input gaps and the median of the next-state gaps over the first
  `follow_cycles` cycles, for a cell whose precision keeps the loops of
  both sides together over many cycles (float64).

A cell's file (`perfbench/cells/<cell>.json`) gives the limits of the
numbers it compares (those that its control, `perfbench/control.py`, or a
planted fault reads well above a sound run) and `follow_cycles`, the
cycles the reference follows each loop over (default `EARLY`).  Only what
the limits read is computed.
"""

from __future__ import annotations

import json
import os

import numpy as np

from perfbench import traffic as traffic_mod
from perfbench.reference import model as ref_model
from perfbench.reference import solver as ref_solver
from perfbench.reference import track as ref_track

#: The cycles at the start of each loop that the `*_first` numbers read.
EARLY = 2
FIRST = ("u_first", "u_first_q75", "x_first")
FOLLOWED = ("u_med", "u_q90", "x_med")


def reference_model(config: dict, root: str, precision: str = "float64") -> ref_model.Model:
    art = config["artifacts"]
    tables = ref_track.Tables.from_artifacts(
        os.path.join(root, art["base_dir"], "plots", art["vehicle"], art["track"], art["method"]))
    return ref_model.Model(config["vehicle"], config["ocp"], tables, ref_model.Precision(precision))


def reference_config(config: dict) -> ref_solver.Config:
    return ref_solver.Config(**{k: v for k, v in config["solver"].items() if k != "hessian_mode"})


def _finite(a):
    a = np.asarray(a, dtype=np.float64)
    return np.where(np.isfinite(a), a, np.inf)


def _state_gap(x, ref):
    return np.max(_finite(np.abs(x - ref) / np.maximum(1.0, np.abs(ref))), axis=-1)


def gaps(model: ref_model.Model, cfg: ref_solver.Config, xs, us, cycles: int):
    """The per-cycle input and next-state gaps (K, cycles) of loops xs (K,
    T+1, 8), us (K, T+1, 2) that a closed loop produced, over their first
    `cycles` cycles."""
    xs = np.asarray(xs, dtype=np.float64)[:, :cycles + 1]
    us = np.asarray(us, dtype=np.float64)[:, :cycles + 1]
    fol = ref_solver.follow(model, cfg, xs, us)
    du = np.max(_finite(np.abs(us[:, 1:] - fol["us"])), axis=-1)
    return du, _state_gap(xs[:, 1:], fol["xs"])


def plant_gaps(model: ref_model.Model, cfg: ref_solver.Config, xs, us, x0):
    """(K, T+1): at 0 the first state's gap to the drawn x0 (K, 8); at t+1
    the larger of the next state's gap to the reference's plant step from
    (xs[t], us[t+1]) and the applied input's excess over its clip box."""
    xs, us = np.asarray(xs, dtype=np.float64), np.asarray(us, dtype=np.float64)
    x, u = xs[:, :-1], us[:, 1:]
    step = ref_solver.plant(model, cfg, x.reshape(-1, 8), u.reshape(-1, 2)).reshape(x.shape)
    lo, hi = ref_solver.clip_box(model, cfg, x)
    excess = np.max(_finite(np.maximum(np.maximum(lo - u, u - hi), 0.0)), axis=-1)
    start = _state_gap(xs[:, 0], np.asarray(x0, dtype=np.float64))
    return np.concatenate([start[:, None], np.maximum(_state_gap(xs[:, 1:], step), excess)], axis=1)


def numbers(du, dx, dp, wanted) -> dict:
    """The `wanted` numbers from the input, next-state and plant gaps."""
    q = lambda a, p: float(np.quantile(a, p))
    first = lambda a, p: max(q(a[:, t], p) for t in range(min(EARLY, a.shape[1])))
    every = {"u_first": lambda: first(du, 0.25), "u_first_q75": lambda: first(du, 0.75),
             "x_first": lambda: first(dx, 0.25), "plant_max": lambda: float(np.max(dp)),
             "u_med": lambda: q(du, 0.5), "u_q90": lambda: q(du, 0.9), "x_med": lambda: q(dx, 0.5)}
    return {k: every[k]() for k in wanted}


def follow_cycles(cell: dict, cycles: int) -> int:
    """The cycles the reference follows each loop over."""
    return min(cycles, int(cell.get("follow_cycles", EARLY)))


def sampled(results, sample):
    """The fields of the sampled (request, row) loops, stacked."""
    return {k: np.stack([results[r][k][b] for r, b in sample]) for k in ("xs", "us")}


def judge(config: dict, traffic: dict, cell: dict, results: list, states, seed: int, root: str,
          dump: str | None = None) -> dict:
    """The numbers that the cell's limits read, for a run's requests (each a
    dict of host arrays with the instance axis first; `states(i)`: the
    states request i was drawn from), and each request's applied violation
    of the true band, largest over its rows.  `dump`: an .npz file to save
    the checked loops and their per-cycle gaps in."""
    model, cfg = reference_model(config, root), reference_config(config)
    sample = traffic_mod.check_sample(traffic, len(results), seed)
    loops = sampled(results, sample)
    x0 = np.stack([states(r)[b] for r, b in sample])
    du, dx = gaps(model, cfg, loops["xs"], loops["us"], follow_cycles(cell, int(traffic["cycles"])))
    dp = plant_gaps(model, cfg, loops["xs"], loops["us"], x0)
    found = numbers(du, dx, dp, cell["limits"])
    if dump:
        np.savez(dump, sample=np.asarray(sample), du=du, dx=dx, dp=dp, x0=x0, **loops)
    applied = [float(np.max(ref_solver.applied_violation(model, r["xs"].astype(np.float64),
                                                         r["us"].astype(np.float64))))
               for r in results]
    return {"numbers": found, "loops": len(sample), "applied": applied}


def load_cell(path: str) -> dict:
    with open(path) as fh:
        return json.load(fh)

#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--steps 500] [--profile DIR]

Drives the port's paths through the entry points a user calls, after
building the hand-written CUDA kernels from the sources in this checkout
(one nvcc process per source, in parallel) and holding each against its
plain PyTorch version on the card.  The NMPC paths: the single-stream closed loop (`runner.closed_loop`:
MX5 on buckmore, horizon 10, float32, 500 control cycles) and the fleet of
32 independent closed loops (`runner.closed_loop_batch`: bench.py's batch,
x0 tiled + 0.01·b, max(10, steps // 5) = 100 cycles, as bench.py:82 sets
them).  The racing-line searches: `global_search.nonlinear` and
`global_search.bayesian` for tbr18 on buckmore at width 0.99, float32,
seed 0, at their `Config()` budgets, on the fused route (kernel 3).  The
racing-line methods: the racing-line CLI (`cli/race.main`) for tbr18 on
buckmore at width 0.99, float32, `--solver fused`, each of curvature,
compromise, laptime, sectors and estimated at its default budget; then the
MX-5 curvature artifacts it writes driving the NMPC.  Then the paths of
`SolverConfig.accurate()`, exact Hessians and `parallel/` on a 1-rank
NCCL process group on the one card the script uses (the multi-rank
semantics are held on gloo ranks by the CPU tests).  Then full-size
circuits, past both kernels' shared-memory ceilings: the NMPC loops on a
table of the Nürburgring Nordschleife's 20,832 samples, the nonlinear
search's selection on seeded synthetic circuits of its and
Spa-Francorchamps' lengths (`track.synthetic_circuit`), and `--curvature`
through the CLI on the 20 km one.  Then long horizons and ladders, and the
horizon-20 class (`SolverConfig.for_horizon(20)`) through a whole lap of
`runner.closed_loop_chunked`, as the JAX package's tests drive it.
Phases:

1. versions, the card's name and power limit, TF32 off;
2. build `csrc/ilqr.cu`, `csrc/velocity.cu` and `csrc/cycle_tail.cu`, one nvcc
   process per source started together, and print ptxas' registers and
   spills;
3. the solve kernel (the whole AL-iLQR solve, kernels 1-2 of the JAX
   package and the eager code around them) vs the plain solve on the card
   at the NMPC paths' shapes, for 14 and 16 constraint rows, float64 and
   float32, torque vectoring on: three single states with seeded warm
   starts and multipliers, 32 instances spread over the lap, and every
   instance of the batch against its own B=1 launch, bit for bit; the
   solve kernel timed at B = 1, 32 and 1024 with 1, 2 and 4 OCPs per
   block, and the plain solve; at B=1 also without iLQR iterations and
   with 1 RK4 substep, to split the solve's time; the blocks per SM of
   h10 f32 in the global placement at 4 warps and of h20 f64 in the
   placement a fleet of 4096 takes;
4. single stream: a 5-cycle float64 closed loop on the card (solve kernel)
   against the same loop on the CPU (plain solve), then a warm-up of G
   cycles (which captures the CUDA graph of G = `runner.GRAPH_CYCLES`
   cycles) and the timed closed loop, its graphs replayed, whose solve
   and tail launches are counted (one each per cycle); the
   applied violation read with both pairings (`runner.applied_violation`),
   gated on the JAX package's;
5. fleet: a 3-cycle float64 batched loop (4 instances) on the card against
   the CPU, then a warm-up of G cycles and the timed 32-instance loop
   (graphed), with its solve and tail launches counted
   (one each per cycle) and both readings of the applied violation;
6. nonlinear search: the 1024-candidate selection timed alone, then the
   whole search, its lap by the scan oracle gated below the published
   36.178 s × 1.01 and its kernel launches counted (1);
7. Bayesian search: the whole search, gated below 36.227 s × 1.01, with
   1 + rounds kernel-3 launches;
8. racing line: the nonlinear search of phase 6 once more, bit-equal to it
   (the card's seeded searches are reproducible), and once with gather's
   atomic backward for the cost of the deterministic one; the lap-time
   objective's value and gradient replayed from its CUDA graph against
   the eager call (bit-equal), both timed; `minimize_bounded_chunked` in
   chunks of 7 against `minimize_bounded` on the curvature objective
   (float32, two lines, 100 iterations: bit-equal, one graph capture per
   run); then the five methods through the CLI, each gated on the scan
   oracle's lap of its line (curvature and compromise below the published
   lap × 1.01, laptime, which runs the chunked loop with one capture,
   below the published 40.892 s, sectors below the published curvature
   lap, estimated below 40 s), with its wall time, L-BFGS iterations, graph
   captures and kernel-3 launches (1 per ε sweep, 1 per sector sweep, 1
   per evaluate); then the MX-5 curvature artifacts of the CLI and 20 NMPC
   cycles on them (finite states, monotone progress, both violation
   readings);
9. `accurate()`, exact mode and `parallel/` on a 1×1 NCCL mesh: the solve
   kernel at `accurate()` vs the plain solve (f64 and f32, B = 1 and 32,
   phase 3's tolerances), its time per solve at B=1, and a 25-cycle f32
   closed loop at `accurate()` (launches counted; both violation gates); a
   horizon-10 exact-Hessian f64 solve on the card against the CPU (1e-9;
   no kernel launch); `runner.closed_loop_fleet` of bench.py's 32 loops for
   20 cycles, bit-equal to `closed_loop_batch` (1 launch per cycle,
   instances 0-25 gated); `sp_velocity.solve_profile_sp` against
   `ops.velocity.solve_profile` (f64, tbr18 and MX5, closed and open, rtol
   1e-9); `mesh.search_step_dp_sp` against `search_step(solver="scan")`
   (f64, B=16); `mesh.evolutionary_search(solver="fused")` for tbr18 on
   buckmore 0.99, f32, batch 1024, 20 rounds (elitism: a non-increasing
   history, lower at the end; 1 kernel-3 launch per round);
   `scaling.measure` on the 1-rank world; and `nonlinear(mesh=1×1)`,
   bit-equal to phase 6;
10. long tracks: (a) the solve kernel with its table forced into global
   memory, bit-equal to the shared table on buckmore (f32 and f64, B = 1
   and 32), and both timed at B=1; (b) the shipped MX-5 curvature
   artifacts loaded with 20,832 samples (the table in global memory): one
   solve against the plain solve (f64 and f32) and 100 single-stream cycles
   (f32, h10, launches counted, applied violation < 1e-2); (c) the 32-loop fleet for 20 cycles
   on it (finite states; instances 0-24 gated on the band and on progress:
   the JAX package's own controller drives 25-31 off the track there); the
   solve kernel timed on the long table
   at B = 1 and 32 beside buckmore's; (d) kernel 3 with its arrays forced
   into the global scratch, bit-equal to the shared placement on the 1024
   tbr18 buckmore rows of phase 11 (tbr18 and MX5, closed and open, P = 1,
   4, 16, f32 and f64); (e) the nonlinear selection (1024 candidates, one
   kernel-3 launch) on a 20,831 m synthetic circuit in f32 and a 7,003 m
   one in f64, written as track JSONs in a temporary directory, 32 rows of
   each against the twin on the CPU; (f) `--curvature --solver fused`
   through the CLI on the 20 km circuit, its lap against the scan oracle's
   on the same line; (g) the solve kernel at the fleet's B = 4096 (h10
   f32) on buckmore with its table in shared memory and in global memory
   (`_launch`'s `where`; bit-equal), in the placement the wrapper picks
   (the global one, 3 blocks per SM against 2), and on the benchmark's
   full-length circuit (20,831 samples; `tools/make_circuit.py`), which
   takes the global placement: blocks per SM (`ops.ilqr.blocks_per_sm`),
   launches by placement ("ilqr.solve.<name>" in `utils.profiling`'s
   counts) and the time per launch (CUDA events), so that the placement is
   told apart from the table's length;
   then the placement rule across B = 32 to 8192 at h10 f32 and h20 f64:
   the wrapper's pick and both placements' waves and times;
11. kernel 3 vs its twin on 1024 real candidate geometries (closed,
   B=1024, N=846; open, the first 300 samples; ragged B=160), on the
   sector windows of phase 8 (open, B = sectors × 8, N = the windows'
   samples) and on hard rows (NaN samples, a row all NaN, constant
   curvature, the minimum at sample 0 and N-1; N=846 closed and 300 open),
   tbr18 and MX5, float64 and float32, with 1, 4 and 16 segments per
   sweep, and f64 `_batch_lap_times(solver="fused")` on the card against
   the CPU; kernel 3's dynamic shared memory per block;
12. kernel 3 timed at B = 128, 256 and 1024 (the Bayesian init, a
   Bayesian round, the nonlinear selection) for 1, 4 and 16 segments,
   float32 and float64, by its device time in torch.profiler, and the
   wrapper and the twin per call, and at phase 10's long selections; the
   tail kernel by its device time at phase 16's timed shapes (h10 f32 and
   h20 f64, the single stream's shape and B = 4096), beside the plain
   tail's device time and kernels per call; then,
   with --profile, the profiles of both NMPC loops, graphed (G cycles) and
   eager (3 cycles), and of one graphed chunk of the h20 lap (f64 and f32),
   each with the device's busy share of its unprofiled wall time.  Phases 11-12 come
   after every driven path, so the paths run in a fresh process, and a
   profiler session, which slows the process's later launches, comes after
   every timed path;
13. long horizons and the h20 class (run after phase 10, before the
   profiler sessions of phases 11-12): (a) at buckmore h10 the solve
   kernel's workspace placement forced (the scalars and the slices in a
   global workspace in their shared-memory layout, the table in global
   memory), bit-equal to the shared placement (f32 and f64, B = 1 and 32);
   (b) past one OCP's slice in a block (N ≤ 160 in
   f32, 79 in f64), the workspace placement at `for_horizon(N)` against the
   plain solve at phase 3's tolerances (f32 N = 161 and 200, f64 N = 80 and
   100, B = 1 and 32), and f32 at N = 400 launched (finite outputs); (c)
   33 and 48 rungs at h10 (48 also reversed, so that the full step is rung
   47) against the plain solve, f32 and f64; (d) `for_horizon(20)` through
   950 cycles of `closed_loop_chunked` in chunks of 190 from X0_REFERENCE,
   f64 then f32, each held to the JAX package's TestHorizon20 and
   TestFullLap gates (applied states on the true band < 1e-2 over the
   first 20 cycles, progress strictly monotone, the lap completed, |mu| <
   0.5) and to one launch per cycle; (e) after every
   gate, the solve kernel's time per call (CUDA events) with its bound at
   h10 f64, B=4096, h20 (f32 and f64, B = 1 and 32), h40, N = 200 f32 and
   N = 100 f64 (workspace) and 48 rungs, and the workspace forced at equal
   horizon (h10 and N=160) beside the wrapper's placement;
14. the summary lines; the last one is {"ok": true, "device": {...}}.
15. the graphed loops (run after phase 13, before 11-12): every NMPC loop
   of phases 4, 5, 9, 10 and 13 that ran graphed through its entry point
   (the 500-cycle single stream, the 32 x 100 fleet, 100 cycles on the
   20,832-sample table, the 25-cycle `accurate()` loop, and the h20 lap in
   chunks of 190, f64 and f32) run again eagerly (`runner._loop` /
   `runner._closed_loop_chunked` with 0 cycles per graph) and held to it
   bit for bit; the single stream and the fleet eager and graphed in turns;
   the capture (warm-up, recording, instantiation, pool bytes) and the rate
   at G = 10, 25, 50 and 100 cycles per graph; the captures so far;
16. the tail kernel (run after phase 3, before phase 4: every NMPC loop
   runs it) against the plain tail on the card (`ops.cycle_tail.tail` vs
   `tail_reference`), from the solve kernel's outputs and the carry at the
   main paths' shapes: h10 f32 unbatched (the single stream), B=32 and
   B=4096, with torque vectoring and the traction ellipse's 16 rows at
   the first two, and the h20 class in f64 (unbatched, B=32, B=4096),
   each without and with output rows: the shifts and the outputs' copies
   bit for bit, x_next, u0 and sdot at the `cuda` tests' tolerances, its
   launches counted; the plain tail's time per call (CUDA events) at the
   shapes phase 12 times.

The NMPC loops on the card replay CUDA graphs of G control cycles
(`mpc/runner`); each phase's warm-up call captures the graphs its timed
call replays, and the solve-kernel launches they count are the cycles'
("ilqr.solve" in `utils.profiling`'s counts; the solves of warm-ups and
captures count as "runner.capture.ilqr.solve"), and so do their
tail-kernel launches ("cycle_tail.tail", one per cycle; a capture's count
as "runner.capture.cycle_tail.tail").

Every path is driven with all launch counts set to 0 just before it and
read just after.  Any failure raises, so the exit code is non-zero and no
result line is printed.  Without a CUDA device, or without the package
beside it, the script exits non-zero as well.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import dataclasses
import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
# The solve kernel vs the plain solve, max |d| / max(1, |ref|) per output:
# 1e-9 in float64; in float32 1e-4 for us, zs, cost and max_violation (the
# JAX tests' tolerance for two implementations of one solve) and 2e-3 for
# the multipliers: lam = max(0, lam + rho g) turns a state difference d into
# rho·d (rho = 100 in the last round); on an H100 the kernel reads up to
# 5.6e-4 there, and the plain float32 solve itself lies up to 7.1e-3 from
# the float64 one on the same inputs (both printed below).
SOLVE_F64_TOL, SOLVE_F32_TOL, SOLVE_F32_LAM_TOL = 1e-9, 1e-4, 2e-3
# The predicted-horizon violation is gated < 0.02 over the first 25 cycles,
# the window tests/test_mpc.py gates for the JAX package.  Over a whole
# 500-cycle lap the predicted tails of the JAX package's own closed loop
# reach 0.08 in float32 (XLA path on the CPU), so the full run is gated on
# the applied states (< 1e-2, as bench.py) and its predicted maximum is
# printed.
PREDICTED_WINDOW = 25
BATCH = 32  # the fleet of bench.py's context line (bench.py:79-83)
# bench.py's fleet adds 0.01·b to every state component, so instance b starts
# b cm off the line with b/100 rad of heading error, yaw rate and steer.  The
# JAX package's own controller (XLA path, float32, on the CPU) keeps
# instances 0-25 inside the true band (applied violation 0.0) and drives
# 26-31 over the left limit at cycles 6-7 (0.114, 0.103, 0.175, 0.247, 0.286,
# 0.409 m); the port reproduces those numbers on the CPU.  The applied-state
# gate (< 1e-2) therefore holds the first 26 instances; every instance is
# held to finite states and monotone progress, and the others are printed.
FLEET_IN_BAND = 26
# The racing-line searches: tbr18 on buckmore at width 0.99, the width the
# reference README's search laps were produced at, gated at the published
# lap × 1.01 as tests/test_gp.py:81,88 gate the JAX package: the nonlinear
# search on the scan oracle's lap of its answer, the Bayesian search on the
# lap it returns (its dataset's best), as tests/test_gp.py:88 does.  The
# Bayesian answer is an L-BFGS polish of the "assoc" objective, which reads
# ~0.09 s faster than the scan oracle at such polished lines; both laps are
# printed.
WIDTH = 0.99
GATE_NONLINEAR = 36.178 * 1.01
GATE_BAYES = 36.227 * 1.01
# The racing-line methods' published tbr18 laps on buckmore (reference
# README, as tests/test_racing_line.py:18-23), the width of the MX-5
# artifacts the CLI writes for the NMPC, and the NMPC cycles run on them.
REF_CURVATURE_LAP, REF_COMPROMISE_LAP, REF_LAPTIME_LAP = 39.934, 37.810, 40.892
MX5_WIDTH = 0.8
ARTIFACT_STEPS = 20
K3_BATCH = 1024  # Config().nonlinear.n_random, the selection's batch
# Kernel 3's batches on the searches' paths: the Bayesian init (n_init), a
# Bayesian round (3 x 64 local + 64 uniform proposals, global_search._propose)
# and the nonlinear selection; and the segment counts timed.
K3_TIMED_BATCHES = (128, 256, K3_BATCH)
K3_SEGMENTS = (1, 4, 16)
# Kernel 3 vs its twin, max |d| / max(1, |ref|): both round every product
# and root on its own (the kernel uses no fused multiply-add), so float64
# agrees to roundoff; float32 is held to 1e-5.  The card's f64
# `_batch_lap_times(solver="fused")` is held to the CPU's at 1e-8 relative:
# PyTorch's CPU float64 sqrt is not correctly rounded (one ulp off on ~1% of
# inputs), and near the friction circle's saturation sqrt(f_cap² − f_lat²)
# turns one ulp into ~1e-9 of the profile.
K3_TOL = {torch.float64: 1e-12, torch.float32: 1e-5}
LAP_TOL_F64 = 1e-8
# The least time of a kernel: the larger of its bytes (each input read once,
# each output written once) over the H100 SXM's 3.35 TB/s and its
# operations over 67 TFLOP/s, its float32 rate outside the tensor cores
# (NVIDIA's H100 SXM data sheet).
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
# Its float64 rate outside the tensor cores (the same data sheet), for the
# float64 solves that phase 13 times.
F64_FLOP_PER_S = 34e12
# Phase 16, the tail kernel against the plain tail: the main paths' shapes
# (the single stream, unbatched; bench.py's fleet; the benchmark's fleet of
# 4096) in float32 at horizon 10, with torque vectoring and the traction
# ellipse's 16 rows too, and the h20 class in float64: (dtype, horizon, both
# flags on, batches).  u0 and sdot are held as the cuda tests hold them
# (tests/test_torch_cycle_tail.py): relative, sdot to (|s| + |s_next|) / dt;
# the shifts are copies, bit for bit.  x_next is held to |x| + |x_next| of
# its component's largest instance, not of its own: these loops start on
# the line with no heading error (`fleet_states`), and after one step an
# instance's offset or heading error can be a near-cancelled difference of
# the RHS's terms, 1e-6 of its size; there the plain float32 tail itself
# lies up to 6.5e-3 of |x| + |x_next| from the float64 one (B=4096, h10,
# on the CPU), and the kernel 1.2e-4 from the plain float32 tail (on an
# H100).  Both per-instance readings are printed.
TAIL_CASES = ((torch.float32, 10, False, (1, BATCH, 4096)), (torch.float32, 10, True, (1, BATCH)),
              (torch.float64, 20, False, (1, BATCH, 4096)))
TAIL_RTOL = {torch.float32: 1e-5, torch.float64: 1e-13}
TIMED_TAILS = ("h10 float32 B=1", "h10 float32 B=4096", "h20 float64 B=1", "h20 float64 B=4096")
# Phase 9: the closed loop at `accurate()` (the window tests/test_mpc.py runs
# the JAX package's at), the fleet's cycles on the mesh, the evolutionary
# search's budget, and the tolerances of the exact solve (card vs CPU, f64)
# and of the sequence-parallel profile (24 sweeps' fixpoint, as
# tests/test_parallel.py holds JAX's).
ACCURATE_STEPS = 25
MESH_FLEET_STEPS = 20
EVO_BATCH, EVO_ROUNDS = 1024, 20
EXACT_TOL, SP_TOL = 1e-9, 1e-9
# accurate() in float32 at B=32: the AL-free cost of the kernel's solve
# against the plain solve's, max |d| / max(1, |ref|) (read 7.7e-4 on an
# H100; the bistable instances' inputs are the phase's own, see there).
ACCURATE_F32_COST_TOL = 1e-2
# Phase 10, long tracks: the samples of one lap at one a metre on the
# Nürburgring Nordschleife (20.832 km) and Spa-Francorchamps (7.004 km), the
# NMPC's cycles on the long table, the fleet's, and the rows of each long
# selection held against the twin, which runs on the CPU (its 2N-step loop
# on the card would take ~50 s at N = 20,831; on the CPU it takes numpy's
# correctly rounded sqrt, as the card's is, so the kernel's bits are its).
LONG_NS, SPA_NS = 20832, 7004
# Phase 10 (g): the fleet's B, and the batch sizes of the placement sweep
# (264 and 396: the H100's 132 SMs times the shared and the global
# placement's blocks per SM at h10 f32).
FLEET_B = 4096
PLACEMENT_SWEEP = (32, 264, 396, 1024, 2048, 4096, 8192)
LONG_STEPS, LONG_FLEET_STEPS = 100, 20
LONG_ROWS = 32
# bench.py's fleet on the long table: the JAX package's own controller (XLA,
# float32, on the CPU) drives instances 25-31 over the left limit within 20
# cycles there (0.0283, 0.0622, 0.151, 0.503, 0.929, 2.705, 0.418 m; 26-31
# on the 846-sample table, FLEET_IN_BAND), and instance 30's progress goes
# backwards, so the applied-state and progress gates hold instances 0-24,
# every instance is held to finite states, and the others are printed.
LONG_FLEET_IN_BAND = 25
# The --curvature lap of the 20 km circuit by kernel 3 (the CLI's, f32)
# against the scan oracle's on the same line (f32), relative: the profiles
# may differ in the last place (force·(1/mass) against force/mass); on the
# CPU the twin's and the scan's laps of that line are equal, and the f32
# scan lies 1.0e-5 from the f64 one.
LONG_LAP_RTOL = 1e-5
# Phase 13, long horizons and the h20 class: the horizons past one block's
# shared memory (one OCP's slice holds N <= 160 in float32 and 79 in float64
# at 6 rungs and 14 rows), the ladders past one lane per rung, the f32
# horizon launched once, and the h20 lap: JAX's TestFullLap (950 cycles of
# `closed_loop_chunked` at `for_horizon(20)` in chunks of 190, f64) and
# TestHorizon20 (applied states on the true band < 1e-2 over 20 cycles)
# (tests/test_mpc.py:493-545).
LONG_HORIZONS = {torch.float32: (161, 200), torch.float64: (80, 100)}
HUGE_HORIZON = 400
LONG_LADDERS = (33, 48)
LAP_CYCLES, LAP_CHUNK, LAP_WINDOW, LAP_MU = 950, 190, 20, 0.5
# The solve kernel's timed shapes beside the main path's (h10 f32 B=1):
# (label, dtype, horizon of `SolverConfig.for_horizon`, rungs if not its 6,
# B).
TIMED_SOLVES = (
    ("h10 f64", torch.float64, 10, None, 1),
    ("h10 f32 B=4096", torch.float32, 10, None, 4096),
    ("h20 f32", torch.float32, 20, None, 1),
    ("h20 f32 B=32", torch.float32, 20, None, 32),
    ("h20 f64", torch.float64, 20, None, 1),
    ("h20 f64 B=32", torch.float64, 20, None, 32),
    ("h40 f32", torch.float32, 40, None, 1),
    ("N=200 f32 (workspace)", torch.float32, 200, None, 1),
    ("N=100 f64 (workspace)", torch.float64, 100, None, 1),
    ("L=48 h10 f32", torch.float32, 10, 48, 1),
)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    )
    return out.stdout.strip().splitlines()[0]


#: The launch counts `read_counts` reads: solve kernel, kernel 3, tail kernel.
LAUNCH_COUNTS = ("ilqr.solve", "velocity_batch.launch", "cycle_tail.tail")


def reset_counts():
    """Sets the counts of LAUNCH_COUNTS to 0, the others as they are."""
    from lap_time_optimization_tpu_torch.utils import profiling

    profiling.set_counts({**profiling.counts(), **dict.fromkeys(LAUNCH_COUNTS, 0)})


def read_counts():
    """(solve kernel, kernel 3, tail kernel) launches since the last reset."""
    from lap_time_optimization_tpu_torch.utils import profiling

    counts = profiling.counts()
    return tuple(counts[name] for name in LAUNCH_COUNTS)


def graph_captures() -> int:
    """Captures of `ops.optimize.GraphedValueAndGrad` so far."""
    from lap_time_optimization_tpu_torch.utils import profiling

    return profiling.counts()["optimize.capture"]


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound_ms(n_bytes: int, flops: float, flop_rate: float = F32_FLOP_PER_S):
    """(least time in ms, what sets it) for `n_bytes` moved and `flops` done."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, flops / flop_rate
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def solve_flops(cfg, n_con: int = 14) -> int:
    """Operations one AL-iLQR solve of one OCP needs, counted from the
    arithmetic of csrc/ilqr.cu's device functions: a libdevice call counts
    as one, products with the structural zeros of [A|B], Jr and Jg do not
    count, and work the kernel repeats on several lanes counts once.
    The RHS 85; its partials and the 29 nonzero entries of d rhs/d[x, u]
    133 more; one tangent through them 47; one RK4 substep's updates of an
    8-vector 104.  The linearisation of a step evaluates the RHS and its
    partials once per RK4 stage and carries NZ tangent columns; a rollout
    step is the RHS and the updates.  The constraints 56 (53 more for the
    ellipse rows), the stage cost 43, the PHR penalty 8 per row; the GN
    quads 159 for the residual rows, 252 for constraint rows 0-13 and 274
    for the ellipse rows; a Riccati stage 4,725 (qv 162, Vzz[A|B] 1,520,
    the Q blocks 1,364, the gains 99, Vz 180, Vzz symmetrised 1,400); the
    feedback law 54 per rung and stage."""
    N, L, ss = cfg.horizon, cfg.n_linesearch, cfg.substeps
    ellipse = n_con == 16
    rhs, partials, tangent, update = 85, 133, 47, 104
    step = ss * (4 * rhs + update)
    lin = ss * (4 * (rhs + partials) + update + 10 * (4 * tangent + update))
    con, cost = 56 + 53 * ellipse, 43
    al = cost + con + 8 * n_con
    quads = 159 + 252 + 274 * ellipse
    iteration = N * (lin + 4725 + L * (54 + step)) + (N + 1) * (quads + L * al)
    al_round = cfg.ilqr_iters * iteration + (N + 1) * (al + con + 3 * n_con)
    return cfg.al_iters * al_round + N * step + (N + 1) * (cost + con + n_con)


def velocity_flops(B: int, N: int, pacejka: bool) -> int:
    """Operations of the velocity profile, one pass of each sweep, counted
    from csrc/velocity.cu: per sample 3 for each lateral limit, 9 for each
    traction, 35 for the 7-knot clamp-sum engine (3 for Pacejka's), 7 for
    each reach, 5 for each select and ds, and the final min."""
    return B * N * (53 if pacejka else 85)


def tail_flops(cfg) -> int:
    """Operations of one loop's cycle tail, counted from csrc/cycle_tail.cu
    as `solve_flops` counts: the clip 10 per input (the negated rate, the
    two box differences and their divisions by dt, the max and the min of
    the bounds and of the clamp), the plant step's RK4 substeps (4 RHS
    evaluations of 85 and the 8-vector updates, 104, each) and sdot 2."""
    return 2 * 10 + cfg.substeps * (4 * 85 + 104) + 2


def search_setup(device, dtype):
    """Buckmore at width 0.99 and the tbr18 and MX5 vehicles, on `device`."""
    from lap_time_optimization_tpu_torch.models import load_vehicle
    from lap_time_optimization_tpu_torch.track import Track

    track = Track.load(os.path.join(ROOT, "data", "tracks", "buckmore.json"), WIDTH)
    return (track.to(device, dtype), load_vehicle("tbr18").to(device, dtype),
            load_vehicle("MX5").to(device, dtype))


def lap_report(track, veh, x):
    """The lap of alphas x by the scan oracle in the search's float32 (the
    gated lap), by "assoc" (the objective the refinement descends), and by
    the scan oracle in float64."""
    from lap_time_optimization_tpu_torch.optim import global_search as gs

    with torch.no_grad():
        oracle = float(gs.evaluate_decongested(track, veh, x)[0])
        assoc = float(gs.decongested_lap_time(track, veh, x, "assoc"))
        track64, veh64 = (copy.deepcopy(m).double() for m in (track, veh))
        oracle64 = float(gs.evaluate_decongested(track64, veh64, x.double())[0])
    return oracle, f"scan-oracle lap {oracle:.4f} s (assoc {assoc:.4f} s, float64 scan {oracle64:.4f} s)"


def line_report(track, veh, alphas):
    """The scan oracle's lap of a full-resolution line (alphas as numpy) in
    the track's float32 (the gated lap) and in float64."""
    from lap_time_optimization_tpu_torch.optim import racing_line as rl

    x = torch.as_tensor(alphas, dtype=track.left.dtype, device=track.left.device)
    lap = float(rl.evaluate(track, veh, x, "scan")[0])
    track64, veh64 = (copy.deepcopy(m).double() for m in (track, veh))
    lap64 = float(rl.evaluate(track64, veh64, x.double(), "scan")[0])
    return lap, f"scan-oracle lap {lap:.4f} s (float64 scan {lap64:.4f} s)"


def race_cases(conf):
    """(method, gate on the scan oracle's lap, kernel-3 launches of a fused
    run): curvature and compromise below the published lap × 1.01, laptime
    below the published lap, sectors below the published curvature lap,
    estimated below 40 s (tests/test_racing_line.py's gates); kernel 3 runs
    once per ε sweep, once per sector sweep and once per evaluate."""
    return (("curvature", REF_CURVATURE_LAP * 1.01, 1),
            ("compromise", REF_COMPROMISE_LAP * 1.01, conf.compromise.n_refine + 2),
            ("laptime", REF_LAPTIME_LAP, 1),
            ("sectors", REF_CURVATURE_LAP, 2),
            ("estimated", 40.0, 1))


def run_race(method, vehicle, width, out_dir, track_path=None):
    """`cli/race.main` for one method on the card (float32, fused), its
    output kept apart, on buckmore or the track JSON at `track_path`:
    (result, wall s, launches, L-BFGS iterations of each minimisation, the
    largest over its instances, graph captures)."""
    from lap_time_optimization_tpu_torch.cli import race
    from lap_time_optimization_tpu_torch.ops import optimize

    iters = []
    names = ("minimize_bounded", "minimize_bounded_chunked")
    origs = {name: getattr(optimize, name) for name in names}

    def counted(orig):
        def run(*a, **kw):
            res = orig(*a, **kw)
            iters.append(int(res.n_iter.max()))
            return res
        return run

    argv = [track_path or os.path.join(ROOT, "data", "tracks", "buckmore.json"),
            os.path.join(ROOT, "data", "vehicles", f"{vehicle}.json"), str(width), f"--{method}",
            "--device", "cuda", "--dtype", "float32", "--solver", "fused", "--output-dir", out_dir]
    for name, orig in origs.items():
        setattr(optimize, name, counted(orig))
    try:
        reset_counts()
        captures = graph_captures()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            out = race.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        for name, orig in origs.items():
            setattr(optimize, name, orig)
    return out, wall, read_counts(), iters, graph_captures() - captures


def atomic_backward_run(fn):
    """fn() with the spline gather's backward as torch.gather's own
    (scatter_add: atomic adds on the card), timed: (result, s)."""
    from lap_time_optimization_tpu_torch.ops import spline

    orig = spline.knot_adjoint
    spline.knot_adjoint = lambda g, j, m, masked: orig(g, j, m, False)
    try:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0
    finally:
        spline.knot_adjoint = orig


def graph_check(track, veh, seed=11):
    """The lap-time objective's value and gradient ("assoc", K=1, the
    laptime method's shape) at three seeded lines, eager and replayed from
    its CUDA graph (`optimize.GraphedValueAndGrad`): (bit-equal, capture s,
    eager ms, replay ms per call)."""
    from lap_time_optimization_tpu_torch.ops import optimize
    from lap_time_optimization_tpu_torch.optim import racing_line as rl

    fun = lambda a: rl.lap_time_of(track, veh, a, "assoc")
    rng = np.random.default_rng(seed)
    xs = [torch.as_tensor(rng.uniform(0.3, 0.7, (1, track.size)), dtype=track.left.dtype,
                          device=track.left.device) for _ in range(3)]
    graphed = optimize.GraphedValueAndGrad(fun)
    t0 = time.perf_counter()
    graphed(xs[0])
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    same = True
    for x in xs:
        f_e, g_e = optimize._value_and_grad(fun, x)
        f_g, g_g = graphed(x)
        same = same and torch.equal(f_e, f_g) and torch.equal(g_e, g_g)
    eager_ms = cuda_ms(lambda: optimize._value_and_grad(fun, xs[1]), 3)
    replay_ms = cuda_ms(lambda: graphed(xs[1]), 10)
    return same, capture_s, eager_ms, replay_ms


def chunked_check(track, max_iter=100, chunk=7, seed=12):
    """`minimize_bounded_chunked` in chunks of `chunk` against
    `minimize_bounded` on the curvature objective Γ² of the track, two
    instances (the centre line and a seeded line), `max_iter` iterations:
    (bit-equal, n_iter, [graph captures], [wall s]) of the two runs."""
    from lap_time_optimization_tpu_torch.ops import optimize
    from lap_time_optimization_tpu_torch.optim import racing_line as rl

    fun = lambda a: rl.gamma2_objective(track, a)
    x0 = np.stack([np.full(track.size, 0.5), np.random.default_rng(seed).uniform(0.3, 0.7, track.size)])
    x0 = torch.as_tensor(x0, dtype=track.left.dtype, device=track.left.device)
    runs, captures, walls = [], [], []
    for minimise, kw in ((optimize.minimize_bounded, {}), (optimize.minimize_bounded_chunked, {"chunk": chunk})):
        before = graph_captures()
        t0 = time.perf_counter()
        runs.append(minimise(fun, x0, max_iter=max_iter, **kw))
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        captures.append(graph_captures() - before)
    same = all(torch.equal(a, b) for a, b in zip(*runs))
    return same, runs[0].n_iter.tolist(), captures, walls


def sector_lines(track, n_grid=8, seed=13):
    """The open sector windows of `racing_line.optimise_sectors` for the
    track, n_grid seeded lines per window: (s[:, :-1], |κ|, length) of
    B = sectors × n_grid open splines, as the sector sweep scores them."""
    from lap_time_optimization_tpu_torch.ops import spline
    from lap_time_optimization_tpu_torch.optim import racing_line as rl

    corners, _ = rl.detect_track_corners(track)
    _, _, left_w, right_w, ns_pad = rl.sector_windows(track, corners)
    lw = left_w.repeat_interleave(n_grid, dim=0)
    rw = right_w.repeat_interleave(n_grid, dim=0)
    a = np.random.default_rng(seed).uniform(0.1, 0.9, (lw.shape[0], lw.shape[-1]))
    with torch.no_grad():
        sp = spline.fit(lw + torch.as_tensor(a, dtype=lw.dtype, device=lw.device)[:, None, :] * (rw - lw),
                        closed=False)
        s = spline.uniform_samples(sp.length, ns_pad)
        return s[:, :-1], spline.curvature(sp, s[:, :-1]), sp.length


def check_velocity(label, veh, s, k, s_max, closed, tol):
    """Gate kernel 3 against its twin on one input, through the wrapper and
    at every segment count of K3_SEGMENTS; returns the largest max |d|."""
    from lap_time_optimization_tpu_torch.ops import velocity_batch as vb

    ref = vb.solve_profile_batch_reference(veh, s, k, s_max, closed)
    fin = torch.isfinite(ref)
    runs = [("wrapper", vb.solve_profile_batch(veh, s, k, s_max, closed))]
    runs += [(f"P={P}", vb._launch(veh, s, k, s_max, closed, segments=P)) for P in K3_SEGMENTS]
    torch.cuda.synchronize()
    worst, ok, readings = 0.0, True, []
    for name, got in runs:
        nan_same = bool(torch.equal(torch.isnan(got), torch.isnan(ref)))
        d = (got - ref).abs()[fin]
        rel = float((d / ref.abs()[fin].clamp(min=1.0)).max()) if d.numel() else 0.0
        worst = max(worst, float(d.max()) if d.numel() else 0.0)
        ok = ok and got.shape == ref.shape and rel <= tol and nan_same
        readings.append(f"{name} {rel:.3e}{'' if nan_same else ' NaN rows differ'}")
    print(f"{label}: max |d|/max(1,|ref|) (tol {tol:g}) " + ", ".join(readings)
          + f"; max |d| {worst:.3e}; {int((~fin).any(dim=1).sum())} NaN rows")
    if not ok:
        raise AssertionError(f"{label}: kernel 3 disagrees")
    return worst


def hard_rows(s, k, s_max, N):
    """8 rows of N samples: two real lines, NaN curvature at three samples,
    a NaN distance, all NaN, constant curvature (every sample ties), and a
    line rolled so that its minimum lateral limit is at sample 0 and at N-1."""
    s, k, s_max = s[:8, :N].clone(), k[:8, :N].clone(), s_max[:8].clone()
    k[2, [1, N // 2, N - 1]] = float("nan")
    s[3, N // 3] = float("nan")
    k[4] = float("nan")
    k[5] = 0.0123
    for row, at in ((6, 0), (7, N - 1)):
        k[row] = torch.roll(k[row], at - int(torch.argmax(k[row])))
    return s, k, s_max


def device_ms(fn, n, name):
    """Device time per launch of the kernel whose name holds `name`, from
    torch.profiler over n calls of fn after one warm-up call: the kernel
    alone, without the host's time per call.  Where the profiler shows no
    such kernel, CUDA events around the n calls (printed as such)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    hits = [a for a in prof.key_averages() if a.device_type == DeviceType.CUDA and name in a.key]
    count = sum(a.count for a in hits)
    if count == 0:
        print(f"  (the profiler shows no {name}: CUDA events around the calls)")
        return cuda_ms(fn, n)
    return sum(a.self_device_time_total for a in hits) / 1e3 / count


def load_main_path(device, dtype, tv=False, te=False):
    from lap_time_optimization_tpu_torch.models import load_vehicle
    from lap_time_optimization_tpu_torch.models.bicycle import BicycleModel
    from lap_time_optimization_tpu_torch.mpc import track as mpc_track
    from lap_time_optimization_tpu_torch.mpc.solver import OCPParams

    track = mpc_track.load("MX-5", "buckmore", "curvature", base_dir=os.path.join(ROOT, "data"))
    model = BicycleModel(load_vehicle("MX5"), track, enable_torque_vectoring=tv,
                         enable_traction_ellipse=te).to(device, dtype)
    return model, OCPParams.reference(dtype, device, lateral_margin=0.05)


def solve_inputs(model, cfg, x0, lam_scale, seed):
    """(z0, us_init, lam_init) of a solve from x0 ((NX,) for one OCP, (B, NX)
    for a batch) on the model's device and dtype, with seeded steering and
    multipliers."""
    from lap_time_optimization_tpu_torch.mpc import solver as S

    rng = np.random.default_rng(seed)
    dtype, device = model.track.k_vals.dtype, model.track.k_vals.device
    t = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype, device=device).contiguous()
    lead = x0.shape[:-1]
    z0 = t(np.concatenate([x0, np.zeros(lead + (2,))], axis=-1))
    us = t(np.stack([rng.normal(0.0, 0.3, lead + (cfg.horizon,)),
                     np.full(lead + (cfg.horizon,), 0.05)], axis=-1))
    lams = t(rng.uniform(0.0, lam_scale, lead + (cfg.horizon + 1, S.n_con(model))))
    return z0, us, lams


def fleet_states(track, n: int) -> np.ndarray:
    """`n` reference states spread over the lap, the last 3 m before the
    seam, at speeds from 4 to 12 m/s: the batch kernel's parity inputs."""
    from lap_time_optimization_tpu_torch.mpc import runner

    s_max = float(track.s_max)
    x0 = np.tile(runner.X0_REFERENCE, (n, 1))
    x0[:, 0] = np.linspace(0.0, s_max, n, endpoint=False)
    x0[-1, 0] = s_max - 3.0
    x0[:, 3] = np.linspace(4.0, 12.0, n)
    return x0


def cuda_ms(fn, n):
    fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / n


def profile_cycles(run, name, kernel, out_dir, steps):
    """torch.profiler over `run(steps)`, a short closed loop (presolve +
    `steps` cycles) after a warm-up call (which captures its graphs) and an
    unprofiled call that sets its wall time: device busy time and kernel
    count per solve, the iLQR kernel's share (device kernels whose name
    holds `kernel`), and the device's busy share of the unprofiled wall
    time (the profiler's own host cost makes its wall clock useless for
    that)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(out_dir, exist_ok=True)
    run(steps)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run(steps)
    torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run(steps)
        torch.cuda.synchronize()
    averages = prof.key_averages()
    device = [a for a in averages if a.device_type == DeviceType.CUDA]
    solves = steps + 2
    busy_ms = sum(a.self_device_time_total for a in device) / 1e3
    kernels = sum(a.count for a in device) / solves
    ilqr_ms = sum(a.self_device_time_total for a in device if kernel in a.key) / 1e3
    table = averages.table(sort_by="self_device_time_total", row_limit=30)
    with open(os.path.join(out_dir, f"{name}_profile.txt"), "w") as fh:
        fh.write(table)
    print(f"profile {name} ({steps} cycles, {solves} solves): device busy {busy_ms / solves:.3f} ms per solve, "
          f"{100 * busy_ms / wall_ms:.1f}% of the unprofiled {wall_ms / steps:.3f} ms per control cycle "
          f"({wall_ms:.1f} ms for the call); {kernels:.0f} device kernels per solve, "
          f"{kernels * solves / steps:.0f} per cycle (the presolve's included), {kernel} "
          f"{ilqr_ms / solves:.3f} ms per solve ({100 * ilqr_ms / max(busy_ms, 1e-9):.1f}% of busy)")


SOLVE_FIELDS = ("us", "zs", "lam", "cost", "max_violation")


def check_solve(label, got, ref, dtype):
    """Print and gate one solve-kernel-vs-plain comparison (tolerances at
    SOLVE_F64_TOL); returns the largest plain |d| over the outputs."""
    errs, ok = [], True
    for name, g, r in zip(SOLVE_FIELDS, got, ref):
        rel = float(((g - r).abs() / r.abs().clamp(min=1.0)).max())
        tol = (SOLVE_F64_TOL if dtype == torch.float64
               else SOLVE_F32_LAM_TOL if name == "lam" else SOLVE_F32_TOL)
        ok = ok and g.shape == r.shape and rel <= tol
        errs.append((name, rel, tol, float((g - r).abs().max())))
    print(f"{label}: max |d|/max(1,|ref|) " + ", ".join(f"{n} {e:.2e} (tol {t:g})" for n, e, t, _ in errs)
          + f"; cost {float(ref[3].max()):.2f}")
    if not ok:
        raise AssertionError(f"{label}: the solve kernel disagrees with the plain solve")
    return max(a for *_, a in errs)


def rel_err(got, ref) -> float:
    """max |d| / max(1, |ref|) over the finite entries of ref."""
    got, ref = got.double().cpu(), ref.double().cpu()
    return float(((got - ref).abs() / ref.abs().clamp(min=1.0)).max())


def device_busy_ms(fn, n):
    """(device time per call of every kernel fn launches, kernels per call),
    from torch.profiler over n calls of fn after one warm-up call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    device = [a for a in prof.key_averages() if a.device_type == DeviceType.CUDA]
    return sum(a.self_device_time_total for a in device) / 1e3 / n, sum(a.count for a in device) / n


def phase_tail(device):
    """Phase 16: the tail kernel against the plain tail on the card (see the
    module docstring).  Returns the largest float32 |d| of x_next, u0 and
    sdot, the kernel's launches, and by label the timed shapes' inputs
    (model, p, cfg, x, res, pk, rows, bound) with the plain tail's time per
    call (CUDA events) beside them; phase 12 times the kernel on them."""
    from lap_time_optimization_tpu_torch.mpc import runner
    from lap_time_optimization_tpu_torch.mpc.solver import SolveResult, SolverConfig
    from lap_time_optimization_tpu_torch.ops import cycle_tail, ilqr

    t_phase = time.perf_counter()
    worst_abs, timed, n_solves, n_tails = 0.0, {}, 0, 0
    reset_counts()
    for dtype, horizon, on, batches in TAIL_CASES:
        model, p = load_main_path(device, dtype, on, on)
        m64, p64 = load_main_path(device, torch.float64, on, on)
        cfg = SolverConfig(horizon=horizon) if horizon == 10 else SolverConfig.for_horizon(horizon)
        pk = ilqr.pack(model, p, cfg)
        rtol, tiny = TAIL_RTOL[dtype], torch.finfo(dtype).tiny
        for B in batches:
            label = f"h{horizon} {str(dtype)[6:]} B={B}" + (" tv ellipse" if on else "")
            x0 = runner.X0_REFERENCE if B == 1 else fleet_states(model.track, B)
            z0, us_init, lam_init = solve_inputs(model, cfg, x0, 0.0 if B == 1 else 2.0, 5)
            res = SolveResult(*ilqr.solve(model, p, cfg, z0, us_init, lam_init, pk))
            n_solves += 1
            x = z0[..., :ilqr.NX].contiguous()
            ref = cycle_tail.tail_reference(model, p, cfg, x, res.us, res.lam)
            dest = runner._empty_result(x, 3)
            rows = (dest.xs[..., 2, :], dest.us[..., 2, :], dest.costs[..., 1], dest.violations[..., 1],
                    dest.sdot[..., 1])
            # x_next against each component's magnitude over the batch (see TAIL_RTOL)
            x_scale = (x.abs() + ref[0].abs()).reshape(-1, ilqr.NX).amax(0)
            per_instance = lambda got, r: float(((got.double() - r.double()).abs()
                                                 / (x.abs() + r.abs()).double().clamp(min=tiny)).max())
            errs, copies = {}, True
            for with_rows in (False, True):
                carry, out = cycle_tail.tail(model, p, cfg, x, res, pk, rows if with_rows else None)
                n_tails += 1
                x_next, us_next, lam_next, u0 = carry
                # the shifts are copies; the outputs are the carry's values (in the rows
                # when given) and the solve's own; sdot the division of the kernel's x_next
                copies = (copies and torch.equal(us_next, ref[2]) and torch.equal(lam_next, ref[3])
                          and torch.equal(out[0], x_next) and torch.equal(out[1], u0)
                          and torch.equal(out[2], res.cost) and torch.equal(out[3], res.max_violation)
                          and torch.equal(out[4].cpu(), (x_next[..., 0] - x[..., 0]).cpu() / cfg.dt)
                          and (not with_rows or out is rows))
                s_scale = (x[..., 0].abs() + ref[0][..., 0].abs()) / cfg.dt
                for name, got, r, scale in (("x_next", x_next, ref[0], x_scale),
                                            ("u0", u0, ref[1], ref[1].abs() + tiny),
                                            ("sdot", out[4], ref[4], s_scale)):
                    d = (got.double() - r.double()).abs()
                    errs[name] = max(errs.get(name, 0.0), float((d / scale.double()).max()))
                    if dtype == torch.float32:
                        worst_abs = max(worst_abs, float(d.max()))
            # per instance, as the cuda tests hold x_next (printed): beside float32's own
            # distance from float64 on the same inputs, the plain tail's and the kernel's
            context = f"x_next per instance {per_instance(x_next, ref[0]):.3g}"
            if dtype == torch.float32:
                ref64 = cycle_tail.tail_reference(m64, p64, cfg, x.double(), res.us.double(), res.lam.double())
                context += (f"; against the plain tail in float64 per instance: the plain float32 tail "
                            f"{per_instance(ref[0], ref64[0]):.3g}, the kernel {per_instance(x_next, ref64[0]):.3g}")
            print(f"tail kernel vs plain tail {label} n_con={res.lam.shape[-1]} substeps={cfg.substeps}, "
                  f"without and with rows: shifts and outputs bit-equal {copies}; "
                  + ", ".join(f"{k} {v:.3g}" for k, v in errs.items()) + f" (tol {rtol:g}); {context}")
            if not copies or not all(v <= rtol for v in errs.values()):
                raise AssertionError(f"{label}: the tail kernel disagrees with the plain tail")
            if label in TIMED_TAILS:
                outs = (x_next, u0, us_next, lam_next, *rows)
                n_bytes = nbytes(x, res.us, res.lam, res.cost, res.max_violation, pk.tables, pk.scal_tail, *outs)
                rate = F64_FLOP_PER_S if dtype == torch.float64 else F32_FLOP_PER_S
                bound = bound_ms(n_bytes, B * tail_flops(cfg), rate)
                plain = cuda_ms(lambda: cycle_tail.tail_reference(model, p, cfg, x, res.us, res.lam), 20)
                timed[label] = ((model, p, cfg, x, res, pk, rows, bound), plain)
    counts = read_counts()
    print(f"phase 16: {time.perf_counter() - t_phase:.1f} s; launches {counts}")
    if counts != (n_solves, 0, n_tails):
        raise AssertionError(f"phase 16 launches {counts}, expected ({n_solves}, 0, {n_tails})")
    return worst_abs, n_tails, timed


def phase_parallel(device, x0b_np, nl, best_x, best_f):
    """Phase 9: `accurate()` on the solve kernel, exact Hessians on the card,
    and `parallel/` on a 1×1 NCCL mesh (see the module docstring).  Returns
    (solve-kernel launches, kernel-3 launches) of its driven paths and a
    dict of its readings."""
    import torch.distributed as dist

    from lap_time_optimization_tpu_torch.mpc import runner
    from lap_time_optimization_tpu_torch.mpc import solver as S
    from lap_time_optimization_tpu_torch.ops import ilqr, spline, velocity
    from lap_time_optimization_tpu_torch.optim import global_search as gs
    from lap_time_optimization_tpu_torch.parallel import distributed, scaling, sp_velocity
    from lap_time_optimization_tpu_torch.parallel import mesh as pmesh

    t_phase = time.perf_counter()
    distributed.initialize(distributed.local_init_method(), world_size=1, rank=0, device="cuda")
    mesh = pmesh.make_mesh(1, sp=1, device="cuda")
    print(f"process group: {dist.get_backend()}, world {dist.get_world_size()}; {mesh}")
    launches, k3_launches, out = 0, 0, {}

    # accurate() on the solve kernel, against the plain solve on the card:
    # f64 at B = 1 and 32 and f32 at B=1 at phase 3's tolerances.  In f32 at
    # B=32 the solve is bistable on some instances (ρ reaches 1250 over 32
    # iterations): two plain f32 solves, on the CPU and on the card, land up
    # to 1.35 apart in u on one instance, so no per-instance tolerance holds
    # for two f32 implementations there.  That case is held to each instance
    # of the launch being its own B=1 launch bit for bit, to finite outputs
    # and to the AL-free costs (ACCURATE_F32_COST_TOL), and its per-instance
    # distances are printed beside the plain f32 solve's own from f64.
    acc = S.SolverConfig.accurate()
    x_mid = np.array([430.0, *runner.X0_REFERENCE[1:]])
    m64, p64 = load_main_path(device, torch.float64)
    for dtype in (torch.float64, torch.float32):
        model, p = load_main_path(device, dtype)
        pk = ilqr.pack(model, p, acc)
        for name, x0, seed in (("B=1 s0=430", x_mid, 1), (f"B={BATCH}", fleet_states(model.track, BATCH), 3)):
            sargs = solve_inputs(model, acc, x0, 2.0, seed)
            got = ilqr.solve(model, p, acc, *sargs, pk)
            ref = ilqr.solve_reference(model, p, acc, *sargs, pk)
            label = f"accurate() solve kernel vs plain {str(dtype)[6:]} {name}"
            if not (dtype == torch.float32 and x0.ndim == 2):
                check_solve(label, got, ref, dtype)
                continue
            ref64 = ilqr.solve_reference(m64, p64, acc, *(a.double() for a in sargs), ilqr.pack(m64, p64, acc))
            du = lambda a, b: (a[0].double() - b[0].double()).abs().amax(dim=(1, 2))
            same = all(torch.equal(g[b], o) for b in range(BATCH)
                       for g, o in zip(got, ilqr.solve(model, p, acc, *(a[b] for a in sargs), pk)))
            cost = float(((got[3] - ref[3]).abs() / ref[3].abs().clamp(min=1.0)).max())
            d_kp, d_p64 = du(got, ref), du(ref, ref64)
            print(f"{label}: per instance max |d us| kernel vs plain f32 {float(d_kp.max()):.3e} "
                  f"({int((d_kp > SOLVE_F32_TOL).sum())} of {BATCH} above {SOLVE_F32_TOL:g}), plain f32 vs plain "
                  f"f64 {float(d_p64.max()):.3e} ({int((d_p64 > SOLVE_F32_TOL).sum())} above); AL-free cost max "
                  f"|d|/max(1,|ref|) {cost:.2e} (tol {ACCURATE_F32_COST_TOL:g}); each instance bit-equal to its "
                  f"B=1 launch: {same}")
            if not (same and cost <= ACCURATE_F32_COST_TOL and all(bool(torch.isfinite(g).all()) for g in got)):
                raise AssertionError(f"{label}: the solve kernel fails its float32 gates")
    sargs = solve_inputs(model, acc, runner.X0_REFERENCE, 0.0, 3)
    out["accurate_ms"] = cuda_ms(lambda: ilqr.solve(model, p, acc, *sargs, pk), 20)
    print(f"solve kernel per call at accurate() (N=10 L=8 substeps=4 4x8 iterations) B=1 f32: "
          f"{out['accurate_ms']:.4f} ms; smem per block "
          f"{[ilqr.smem_bytes(torch.float32, W, 10, 8, 14, 846) for W in (1, 2, 4)]} B")
    x0 = torch.as_tensor(runner.X0_REFERENCE, dtype=torch.float32, device=device)
    runner.closed_loop(model, p, acc, x0, ACCURATE_STEPS)  # warm-up: the graph of its cycles
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    sim = runner.closed_loop(model, p, acc, x0, ACCURATE_STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    xs = sim.xs.cpu().numpy()
    predicted = float(sim.violations.max())
    applied = runner.applied_violation(model, p, sim)
    print(f"closed loop at accurate(): {ACCURATE_STEPS} steps f32 in {wall:.3f} s = {ACCURATE_STEPS / wall:.2f} Hz; "
          f"progress {xs[-1, 0]:.2f} m; applied violation {applied:.3e} (JAX pairing, gated < 1e-2), "
          f"predicted {predicted:.3e} (gated < 0.02); launches (solve kernel, kernel 3, tail kernel) {counts}")
    if counts != (ACCURATE_STEPS + 2, 0, ACCURATE_STEPS):
        raise AssertionError(f"accurate() loop launches {counts}, expected "
                             f"({ACCURATE_STEPS + 2}, 0, {ACCURATE_STEPS})")
    if not (np.all(np.isfinite(xs)) and np.all(np.diff(xs[:, 0]) > 0) and applied < 1e-2 and predicted < 0.02):
        raise AssertionError("the closed loop at accurate() fails its gates")
    launches += counts[0]
    out["tail_launches"] = out.get("tail_launches", 0) + counts[2]
    out["accurate_hz"] = ACCURATE_STEPS / wall
    out["accurate_loop"] = (model, p, acc, x0, sim)

    # exact Hessians: the plain solve on the card against the CPU, float64
    exact = S.SolverConfig(horizon=10, hessian_mode="exact")
    mc, pc = load_main_path("cpu", torch.float64)
    sargs = solve_inputs(m64, exact, x_mid, 2.0, 1)
    reset_counts()
    t0 = time.perf_counter()
    got = S.solve(m64, p64, exact, *sargs)
    torch.cuda.synchronize()
    out["exact_s"] = time.perf_counter() - t0
    counts = read_counts()
    t0 = time.perf_counter()
    ref = S.solve(mc, pc, exact, *(a.cpu() for a in sargs))
    cpu_s = time.perf_counter() - t0
    err = max(rel_err(g, r) for g, r in zip(got, ref))
    print(f"exact-Hessian solve h10 f64 (2x5 iterations): card {out['exact_s']:.2f} s, CPU {cpu_s:.2f} s; "
          f"card vs CPU max |d|/max(1,|ref|) {err:.3e} (tol {EXACT_TOL:g}); cost {float(ref.cost):.4f}; "
          f"launches {counts} (none: the kernel is Gauss-Newton only)")
    if counts != (0, 0, 0) or not err <= EXACT_TOL:
        raise AssertionError("the exact-Hessian solve on the card disagrees with the CPU or launched a kernel")

    # the fleet on the 1x1 NCCL mesh, bit-equal to closed_loop_batch
    cfg = S.SolverConfig(horizon=10)
    model, p = load_main_path(device, torch.float32)
    x0b = torch.as_tensor(x0b_np, dtype=torch.float32, device=device)
    # warm-up: the NCCL communicator and the graph of the timed run's cycles
    runner.closed_loop_fleet(model, p, cfg, x0b, MESH_FLEET_STEPS, mesh)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    fleet = runner.closed_loop_fleet(model, p, cfg, x0b, MESH_FLEET_STEPS, mesh)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    batch = runner.closed_loop_batch(model, p, cfg, x0b, MESH_FLEET_STEPS)
    same = all(torch.equal(f, b) for f, b in zip(fleet, batch))
    per = [runner.applied_violation(model, p, runner.SimResult(*(a[b] for a in fleet))) for b in range(BATCH)]
    bxs = fleet.xs.cpu().numpy()
    out["fleet_solves_per_s"] = BATCH * MESH_FLEET_STEPS / wall
    print(f"closed_loop_fleet on the 1x1 mesh: {BATCH} loops x {MESH_FLEET_STEPS} steps f32 in {wall:.3f} s = "
          f"{out['fleet_solves_per_s']:.1f} solves/s; bit-equal to closed_loop_batch: {same}; applied "
          f"violation, worst of instances 0-{FLEET_IN_BAND - 1} {max(per[:FLEET_IN_BAND]):.3e}; launches {counts}")
    if counts != (MESH_FLEET_STEPS + 2, 0, MESH_FLEET_STEPS) or not same:
        raise AssertionError(f"fleet on the mesh: launches {counts}, bit-equal {same}")
    if not (np.all(np.isfinite(bxs)) and np.all(np.diff(bxs[:, :, 0], axis=1) > 0)
            and max(per[:FLEET_IN_BAND]) < 1e-2):
        raise AssertionError("the fleet on the mesh fails its gates")
    launches += counts[0]
    out["tail_launches"] = out.get("tail_launches", 0) + counts[2]

    # the sequence-parallel profile on a 1-rank sp axis, float64
    track64, tbr64, mx64 = search_setup(device, torch.float64)
    with torch.no_grad():
        mid = track64.mid_spline()
        s = spline.uniform_samples(mid.length, track64.ns)[:-1]
        k = spline.curvature(mid, s, signed=False)
    errs = []
    for name, veh in (("tbr18", tbr64), ("MX5", mx64)):
        for closed, n in ((True, s.shape[0]), (False, 400)):
            ref = velocity.solve_profile(veh, s[:n], k[:n], mid.length, closed)
            got = sp_velocity.solve_profile_sp(veh, s[:n], k[:n], mid.length, mesh, closed, sweeps=24)
            errs.append(float(((got - ref).abs() / ref.abs()).max()))
    out["sp_ms"] = cuda_ms(lambda: sp_velocity.solve_profile_sp(tbr64, s, k, mid.length, mesh, True, sweeps=24), 3)
    print(f"solve_profile_sp on a 1-rank sp axis vs solve_profile, f64 (tbr18, MX5 x closed, open): max "
          f"|d|/|ref| {[f'{e:.2e}' for e in errs]} (tol {SP_TOL:g}); {out['sp_ms']:.2f} ms per closed tbr18 call")
    if not max(errs) <= SP_TOL:
        raise AssertionError("the sequence-parallel profile disagrees with solve_profile")

    # one dp x sp round against search_step(solver="scan"), float64, B=16
    alphas = torch.rand((16, track64.size), generator=torch.Generator(device=device).manual_seed(5),
                        dtype=torch.float64, device=device)
    steps = [fn(track64, tbr64, alphas, torch.Generator(device=device).manual_seed(5), 0.1)
             for fn in (lambda *a: pmesh.search_step(*a, solver="scan", mesh=mesh),
                        lambda *a: pmesh.search_step_dp_sp(*a, mesh))]
    (nb_r, t_r, a_r), (nb, t, a) = steps
    d_batch = float((nb - nb_r).abs().max())
    ok = rel_err(t, t_r) <= 1e-9 and rel_err(a, a_r) <= 1e-9 and d_batch <= 1e-7
    print(f"search_step_dp_sp on 1x1 vs search_step(scan), f64 B=16: best {float(t):.6f} s vs {float(t_r):.6f} s; "
          f"new batch max |d| {d_batch:.2e} (tol 1e-7)")
    if not ok:
        raise AssertionError("search_step_dp_sp disagrees with search_step(solver='scan')")

    # the evolutionary search on kernel 3
    track, tbr18, _ = search_setup(device, torch.float32)
    reset_counts()
    t0 = time.perf_counter()
    _, hist = pmesh.evolutionary_search(track, tbr18, mesh=mesh, batch=EVO_BATCH, rounds=EVO_ROUNDS, solver="fused")
    torch.cuda.synchronize()
    out["evo_s"] = time.perf_counter() - t0
    counts = read_counts()
    print(f"evolutionary_search (tbr18, buckmore {WIDTH}, f32, batch {EVO_BATCH}, {EVO_ROUNDS} rounds, fused, 1x1): "
          f"{out['evo_s']:.2f} s; best lap {hist[0]:.4f} -> {hist[-1]:.4f} s; launches {counts}")
    if counts != (0, EVO_ROUNDS, 0) or not (np.all(np.diff(hist) <= 0) and hist[-1] < hist[0]):
        raise AssertionError("the evolutionary search fails its gates")
    k3_launches += counts[1]

    reset_counts()
    scale = scaling.measure(track, tbr18, device_counts=(1, 2, 4, 8), batch_per_device=EVO_BATCH, rounds=3,
                            solver="fused")
    counts = read_counts()
    print(f"scaling.measure on the 1-rank world (fused, {EVO_BATCH} per rank; launches {counts}):")
    print(scaling.report(scale))
    if set(scale) != {1} or counts != (0, 4, 0):
        raise AssertionError(f"scaling.measure: entries {sorted(scale)}, launches {counts}")
    k3_launches += counts[1]

    reset_counts()
    t0 = time.perf_counter()
    mx, mf = gs.nonlinear(track, tbr18, seed=0, n_random=nl.n_random, n_refine=nl.n_refine, max_iter=nl.max_iter,
                          solver="fused", mesh=mesh)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    same = bool(torch.equal(mx, best_x)) and mf == best_f
    print(f"nonlinear on the 1x1 mesh: {wall:.2f} s, search lap {mf:.4f} s, bit-equal to phase 6: {same}; "
          f"launches {counts}")
    if not same or counts != (0, 1, 0):
        raise AssertionError("nonlinear on the mesh differs from phase 6")
    k3_launches += counts[1]
    dist.destroy_process_group()
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"phase 9: {out['phase_s']:.1f} s")
    return launches, k3_launches, out


def np_sqrt(x):
    """numpy's square root of a CPU tensor: correctly rounded, as the card's
    is (`ops.velocity_batch.solve_profile_batch_reference`'s `sqrt`)."""
    return torch.from_numpy(np.asarray(np.sqrt(x.numpy())))


def write_track_json(path, name, left, right):
    """A track JSON of cones (left, right), each (2, n), as data/tracks has."""
    with open(path, "w") as fh:
        json.dump({"name": name, "left": {"x": left[0].tolist(), "y": left[1].tolist()},
                   "right": {"x": right[0].tolist(), "y": right[1].tolist()}}, fh)


def phase_long_tracks(device, cfg, conf, x0b_np):
    """Phase 10: both kernels past their shared-memory ceilings through the
    entry points (see the module docstring).  Returns (solve-kernel
    launches, kernel-3 launches) of its driven paths, its readings, the
    long selections' kernel-3 inputs by dtype (timed in phase 12) and the
    largest float32 |kernel - plain|."""
    from lap_time_optimization_tpu_torch.models import load_vehicle
    from lap_time_optimization_tpu_torch.models.bicycle import BicycleModel
    from lap_time_optimization_tpu_torch.mpc import runner
    from lap_time_optimization_tpu_torch.mpc import track as mpc_track
    from lap_time_optimization_tpu_torch.mpc.solver import OCPParams
    from lap_time_optimization_tpu_torch.ops import ilqr, spline, velocity
    from lap_time_optimization_tpu_torch.ops import velocity_batch as vb
    from lap_time_optimization_tpu_torch.optim import global_search as gs
    from lap_time_optimization_tpu_torch.optim import racing_line as rl
    from lap_time_optimization_tpu_torch.track import Track, synthetic_circuit

    t_phase = time.perf_counter()
    solve_n, k3_n, out, worst = 0, 0, {}, 0.0
    L = cfg.n_linesearch

    # (a) the solve kernel's placements at buckmore's 846 samples: the
    # wrapper keeps the table in shared memory, and the same launch with
    # the table in global memory gives the same bits
    for dtype in (torch.float64, torch.float32):
        model, p = load_main_path(device, dtype)
        pk = ilqr.pack(model, p, cfg)
        n = pk.tables.shape[-1]
        for name, x0, seed in (("B=1", runner.X0_REFERENCE, 1), (f"B={BATCH}", fleet_states(model.track, BATCH), 3)):
            sargs = solve_inputs(model, cfg, x0, 2.0, seed)
            B = 1 if x0.ndim == 1 else BATCH
            where = ilqr.placement(dtype, min(ilqr.WARPS, B), cfg.horizon, L, 14, n, B=B)
            glob = ilqr.candidates(dtype, min(ilqr.WARPS, B), cfg.horizon, L, 14, n)["global"]
            shared = ilqr._launch(cfg, *sargs, pk)
            forced = ilqr._launch(cfg, *sargs, pk, where=glob)
            same = all(torch.equal(a, b) for a, b in zip(forced, shared))
            print(f"solve kernel {str(dtype)[6:]} {name} n={n}: the wrapper's (OCPs per block, table in global "
                  f"memory) {where}; the table forced into global memory: bit-equal {same}")
            if where[1] or not same:
                raise AssertionError(f"solve kernel {name}: placement {where}, forced global bit-equal {same}")
            if dtype == torch.float32 and x0.ndim == 1:
                out["solve_846_ms"] = cuda_ms(lambda: ilqr._launch(cfg, *sargs, pk), 20)
                out["solve_846_global_ms"] = cuda_ms(lambda: ilqr._launch(cfg, *sargs, pk, where=glob), 20)
    print(f"solve kernel B=1 n=846 f32: shared table {out['solve_846_ms']:.4f} ms, forced global "
          f"{out['solve_846_global_ms']:.4f} ms per call (CUDA events)")

    # (b) the NMPC single stream on the shipped MX-5 curvature artifacts
    # resampled to the Nordschleife's metre count: the table's length, not
    # its spacing, sets the ceiling
    t0 = time.perf_counter()
    ltrack = mpc_track.load("MX-5", "buckmore", "curvature", base_dir=os.path.join(ROOT, "data"),
                            n_samples=LONG_NS)
    print(f"long NMPC table: {LONG_NS} samples over {float(ltrack.s_max):.1f} m "
          f"({float(ltrack.s_max) / (LONG_NS - 1) * 100:.2f} cm apart), built in {time.perf_counter() - t0:.2f} s")
    x_mid = np.array([430.0, *runner.X0_REFERENCE[1:]])
    models = {}
    for dtype in (torch.float64, torch.float32):
        lmodel = BicycleModel(load_vehicle("MX5"), copy.deepcopy(ltrack)).to(device, dtype)
        lp = OCPParams.reference(dtype, device, lateral_margin=0.05)
        pk = ilqr.pack(lmodel, lp, cfg)
        models[dtype] = (lmodel, lp, pk)
        where = ilqr.placement(dtype, 1, cfg.horizon, L, 14, LONG_NS)
        sargs = solve_inputs(lmodel, cfg, x_mid, 2.0, 1)
        got = ilqr.solve(lmodel, lp, cfg, *sargs, pk)
        ref = ilqr.solve_reference(lmodel, lp, cfg, *sargs, pk)
        err = check_solve(f"solve kernel vs plain {str(dtype)[6:]} B=1 s0=430 n={LONG_NS} (placement {where})",
                          got, ref, dtype)
        if not where[1]:
            raise AssertionError(f"the {LONG_NS}-sample table took placement {where}")
        if dtype == torch.float32:
            worst = max(worst, err)
    lmodel, lp, pk = models[torch.float32]
    x0 = torch.as_tensor(runner.X0_REFERENCE, dtype=torch.float32, device=device)
    runner.closed_loop(lmodel, lp, cfg, x0, runner.GRAPH_CYCLES)  # warm-up: the graph of G cycles
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    sim = runner.closed_loop(lmodel, lp, cfg, x0, LONG_STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    xs = sim.xs.cpu().numpy()
    applied = runner.applied_violation(lmodel, lp, sim)
    print(f"closed loop on the {LONG_NS}-sample table: {LONG_STEPS} steps f32 in {wall:.3f} s = "
          f"{LONG_STEPS / wall:.2f} Hz; progress {xs[-1, 0]:.2f} m; applied violation {applied:.3e} (JAX pairing, "
          f"gated < 1e-2; with the state each input was applied from "
          f"{runner.applied_violation(lmodel, lp, sim, pairing='applied'):.3e}); predicted violation over the first "
          f"{PREDICTED_WINDOW} cycles {float(sim.violations[:PREDICTED_WINDOW].max()):.3e}; launches {counts}")
    if counts != (LONG_STEPS + 2, 0, LONG_STEPS):
        raise AssertionError(f"long-table closed loop launches {counts}, expected "
                             f"({LONG_STEPS + 2}, 0, {LONG_STEPS})")
    if not (np.all(np.isfinite(xs)) and np.all(np.diff(xs[:, 0]) > 0) and applied < 1e-2):
        raise AssertionError("the closed loop on the long table fails its gates")
    solve_n += counts[0]
    out["tail_launches"] = out.get("tail_launches", 0) + counts[2]
    out["long_hz"] = LONG_STEPS / wall
    out["long_loop"] = (lmodel, lp, cfg, x0, sim)

    # (c) the fleet on the same table, gated on the instances the JAX
    # package keeps in the band there (fault R2)
    x0b = torch.as_tensor(x0b_np, dtype=torch.float32, device=device)
    runner.closed_loop_batch(lmodel, lp, cfg, x0b, LONG_FLEET_STEPS)  # warm-up: the graph of its cycles
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    fleet = runner.closed_loop_batch(lmodel, lp, cfg, x0b, LONG_FLEET_STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    bxs = fleet.xs.cpu().numpy()
    per = [runner.applied_violation(lmodel, lp, runner.SimResult(*(a[b] for a in fleet))) for b in range(BATCH)]
    monotone = np.all(np.diff(bxs[:, :, 0], axis=1) > 0, axis=1)
    print(f"fleet on the {LONG_NS}-sample table: {BATCH} loops x {LONG_FLEET_STEPS} steps f32 in {wall:.3f} s = "
          f"{BATCH * LONG_FLEET_STEPS / wall:.1f} solves/s; applied violation, worst of instances "
          f"0-{LONG_FLEET_IN_BAND - 1} {max(per[:LONG_FLEET_IN_BAND]):.3e} (gated), instances "
          f"{LONG_FLEET_IN_BAND}-{BATCH - 1} {[round(v, 4) for v in per[LONG_FLEET_IN_BAND:]]}; progress not "
          f"monotone on instances {np.flatnonzero(~monotone).tolist()}; launches {counts}")
    if counts != (LONG_FLEET_STEPS + 2, 0, LONG_FLEET_STEPS):
        raise AssertionError(f"long-table fleet launches {counts}, expected "
                             f"({LONG_FLEET_STEPS + 2}, 0, {LONG_FLEET_STEPS})")
    if not (np.all(np.isfinite(bxs)) and np.all(monotone[:LONG_FLEET_IN_BAND])
            and max(per[:LONG_FLEET_IN_BAND]) < 1e-2):
        raise AssertionError("the fleet on the long table fails its gates")
    solve_n += counts[0]
    out["tail_launches"] = out.get("tail_launches", 0) + counts[2]

    # the solve kernel's time on the long table (global placement) beside
    # the shared placement's at buckmore's size, CUDA events
    bmodel, bp = load_main_path(device, torch.float32)
    bpk = ilqr.pack(bmodel, bp, cfg)
    for B in (1, BATCH):
        x0s = runner.X0_REFERENCE if B == 1 else fleet_states(lmodel.track, B)
        sargs = solve_inputs(lmodel, cfg, x0s, 0.0 if B == 1 else 2.0, 3)
        bargs = solve_inputs(bmodel, cfg, runner.X0_REFERENCE if B == 1 else fleet_states(bmodel.track, B),
                             0.0 if B == 1 else 2.0, 3)
        out[f"long_solve_ms_{B}"] = cuda_ms(lambda: ilqr.solve(lmodel, lp, cfg, *sargs, pk), 20)
        short_ms = cuda_ms(lambda: ilqr.solve(bmodel, bp, cfg, *bargs, bpk), 20)
        outs = ilqr.solve(lmodel, lp, cfg, *sargs, pk)
        out[f"long_solve_bound_{B}"] = bound_ms(nbytes(*sargs, *pk, *outs), B * solve_flops(cfg))
        print(f"solve kernel per call at B={B} f32, table in global memory n={LONG_NS}: "
              f"{out[f'long_solve_ms_{B}']:.4f} ms (placement {ilqr.placement(torch.float32, min(ilqr.WARPS, B), 10, L, 14, LONG_NS)}); "
              f"shared placement n=846: {short_ms:.4f} ms; bound {out[f'long_solve_bound_{B}'][0] * 1e3:.4f} us "
              f"({out[f'long_solve_bound_{B}'][1]})")

    # (d) kernel 3's placements on the tbr18 buckmore rows of phase 11
    n_dec = search_setup("cpu", torch.float64)[0].n_decongested
    alphas_np = np.random.default_rng(7).uniform(0.0, gs.ALPHA_HI, (K3_BATCH, n_dec))
    for dtype in (torch.float64, torch.float32):
        track, tbr18, mx5 = search_setup(device, dtype)
        with torch.no_grad():
            s_b, k_b, len_b = gs._geometry(track, torch.as_tensor(alphas_np, dtype=dtype, device=device),
                                           spline.FIT_METHOD_CLOSED_BATCHED)
        s_n = s_b[:, :-1]
        same = True
        for veh in (tbr18, mx5):
            for closed, n in ((True, k_b.shape[1]), (False, 300)):
                kn = k_b[:, :n].contiguous()
                for P in K3_SEGMENTS:
                    shared = vb._launch(veh, s_n[:, :n], kn, len_b, closed, segments=P)
                    forced = vb._launch(veh, s_n[:, :n], kn, len_b, closed, segments=P, force_global=True)
                    same = same and torch.equal(forced, shared)
        print(f"kernel 3 {str(dtype)[6:]} B={K3_BATCH} N={k_b.shape[1]} (closed) and 300 (open), tbr18 and MX5, "
              f"P = {K3_SEGMENTS}: shared memory per block {vb.smem_bytes(dtype, 4, k_b.shape[1])} B at W=4; the "
              f"arrays forced into the global scratch: bit-equal {same}")
        if not same:
            raise AssertionError("kernel 3's global scratch differs from its shared placement")

    # (e) the nonlinear search's selection on seeded synthetic circuits of
    # the Nordschleife's and Spa's lengths, held against the twin on the CPU;
    # (f) --curvature through the CLI on the 20 km circuit
    long_k3 = {}
    nl = conf.nonlinear
    with tempfile.TemporaryDirectory() as tmp:
        paths = {}
        for ns, dtype in ((LONG_NS, torch.float32), (SPA_NS, torch.float64)):
            left, right = synthetic_circuit(ns, seed=0)
            paths[ns] = os.path.join(tmp, f"synthetic{ns}.json")
            write_track_json(paths[ns], f"synthetic{ns}", left, right)
            strack = Track.load(paths[ns], WIDTH).to(device, dtype)
            veh = load_vehicle("tbr18").to(device, dtype)
            gen = torch.Generator(device=device)
            gen.manual_seed(0)
            cands = gs._uniform(gen, (nl.n_random, strack.n_decongested), strack)
            gs._nonlinear_select(strack, veh, cands, nl.n_refine, "fused")  # warm-up
            torch.cuda.synchronize()
            reset_counts()
            t0 = time.perf_counter()
            times = gs._nonlinear_select(strack, veh, cands, nl.n_refine, "fused")[0]
            torch.cuda.synchronize()
            sel_s = time.perf_counter() - t0
            counts = read_counts()
            with torch.no_grad():
                s_b, k_b, len_b = gs._geometry(strack, cands, spline.FIT_METHOD_CLOSED_BATCHED)
            s_n = s_b[:, :-1]
            v = vb.solve_profile_batch(veh, s_n, k_b, len_b, True)
            t0 = time.perf_counter()
            ref = vb.solve_profile_batch_reference(load_vehicle("tbr18").to("cpu", dtype), s_n[:LONG_ROWS].cpu(),
                                                   k_b[:LONG_ROWS].cpu(), len_b[:LONG_ROWS].cpu(), True, sqrt=np_sqrt)
            twin_s = time.perf_counter() - t0
            got = v[:LONG_ROWS].cpu()
            fin = torch.isfinite(ref)
            d = (got - ref).abs()[fin]
            rel = float((d / ref.abs()[fin].clamp(min=1.0)).max())
            nan_same = bool(torch.equal(torch.isnan(got), torch.isnan(ref)))
            lap_d = float((velocity.lap_time(s_b, v) - times).abs().max())
            dt = str(dtype)[6:]
            print(f"nonlinear selection on the {ns - 1} m synthetic circuit ({strack.size} cone pairs, width {WIDTH}), "
                  f"tbr18 {dt}: {nl.n_random} candidates in {1e3 * sel_s:.2f} ms = {nl.n_random / sel_s:.0f} "
                  f"candidates/s; best {float(times.min()):.3f} s, {int(torch.isinf(times).sum())} non-finite; "
                  f"launches {counts}; kernel 3 at B={nl.n_random} N={k_b.shape[1]} (shared memory per block at W=1: "
                  f"{vb.smem_bytes(dtype, 1, k_b.shape[1])} B, so the global scratch) vs the twin on the CPU on "
                  f"{LONG_ROWS} rows ({twin_s:.1f} s): max |d|/max(1,|ref|) {rel:.3e} (tol {K3_TOL[dtype]:g}), "
                  f"bit-equal {torch.equal(got, ref)}, NaN positions equal {nan_same}; its laps vs the selection's "
                  f"max |d| {lap_d:.3e} s")
            if counts != (0, 1, 0):
                raise AssertionError(f"long selection launches {counts}, expected (0, 1, 0)")
            if not (rel <= K3_TOL[dtype] and nan_same and got.shape == ref.shape):
                raise AssertionError(f"kernel 3 disagrees with its twin on the {ns - 1} m circuit")
            if dtype == torch.float32:
                worst = max(worst, float(d.max()) if d.numel() else 0.0)
            k3_n += counts[1]
            long_k3[dtype] = (veh, s_n, k_b, len_b)
            out[f"selection_ms_{ns}"] = 1e3 * sel_s

        res, wall, counts, iters, captures = run_race("curvature", "tbr18", WIDTH, os.path.join(tmp, "race"),
                                                      track_path=paths[LONG_NS])
        strack = Track.load(paths[LONG_NS], WIDTH).to(device, torch.float32)
        veh = load_vehicle("tbr18").to(device, torch.float32)
        x = torch.as_tensor(res["alphas"], dtype=torch.float32, device=device)
        t0 = time.perf_counter()
        with torch.no_grad():
            scan = float(rl.evaluate(strack, veh, x, "scan")[0])
        scan_s = time.perf_counter() - t0
        rel = abs(res["lap_time"] - scan) / scan
        print(f"race --curvature on the {LONG_NS - 1} m synthetic circuit (tbr18, width {WIDTH}, f32, fused): "
              f"{wall:.2f} s; L-BFGS iterations {iters}; graph captures {captures}; CLI lap {res['lap_time']:.4f} s "
              f"(kernel 3), scan-oracle lap of the same line {scan:.4f} s ({scan_s:.1f} s): |d|/scan {rel:.3e} "
              f"(tol {LONG_LAP_RTOL:g}); launches {counts}")
        if counts != (0, 1, 0):
            raise AssertionError(f"long --curvature launches {counts}, expected (0, 1, 0)")
        if not (np.isfinite(scan) and rel <= LONG_LAP_RTOL):
            raise AssertionError("the long --curvature lap disagrees with the scan oracle")
        k3_n += counts[1]
        out["race_s"] = wall
    solve_n += fleet_placements(device, cfg, out)
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"phase 10: {out['phase_s']:.1f} s")
    return solve_n, k3_n, out, long_k3, worst


def fleet_placements(device, cfg, out, reps: int = 10) -> int:
    """Phase 10 (g): the solve kernel at h10 f32 and B = FLEET_B, from
    `fleet_states` (starts over the whole lap, 4-12 m/s), on buckmore in the
    shared and in the global placement (given through `_launch`'s `where`;
    bit-equal), in the placement the wrapper picks there (the global one:
    3 blocks per SM against the shared placement's 2, so 3 waves against 4;
    bit-equal), and on the
    benchmark's full-length circuit (`data/plots/MX-5/circuit20832/curvature`,
    20,831 samples), whose table takes the global placement: each case's
    placement, blocks per SM, launches by placement and ms per launch (CUDA
    events over `reps` launches after one) into `out`; then
    `placement_sweep`.  Returns the solve launches."""
    from lap_time_optimization_tpu_torch.models import load_vehicle
    from lap_time_optimization_tpu_torch.models.bicycle import BicycleModel
    from lap_time_optimization_tpu_torch.mpc import track as mpc_track
    from lap_time_optimization_tpu_torch.mpc.solver import OCPParams
    from lap_time_optimization_tpu_torch.ops import ilqr
    from lap_time_optimization_tpu_torch.utils import profiling

    dtype, N, L = torch.float32, cfg.horizon, cfg.n_linesearch
    circuit = mpc_track.load("MX-5", "circuit20832", "curvature", base_dir=os.path.join(ROOT, "data"))
    buckmore = load_main_path(device, dtype)
    shared, global_table = ilqr.Placement(ilqr.WARPS, False, False), ilqr.Placement(ilqr.WARPS, True, False)
    # (label, model and OCP parameters, the placement given or None, the placement expected, its blocks per
    # SM or None)
    cases = (("buckmore shared", buckmore, shared, "shared", None),
             ("buckmore global", buckmore, global_table, "global", None),
             ("buckmore, the wrapper's placement", buckmore, None, "global", 3),
             ("circuit20832", (BicycleModel(load_vehicle("MX5"), circuit).to(device, dtype),
                               OCPParams.reference(dtype, device, lateral_margin=0.05)), None, "global", None))
    launches, shared_out = 0, None
    for label, (model, p), given, expect, expect_blocks in cases:
        pk = ilqr.pack(model, p, cfg)
        n = pk.tables.shape[-1]
        sargs = solve_inputs(model, cfg, fleet_states(model.track, FLEET_B), 2.0, 3)
        where = given or ilqr.placement(dtype, ilqr.WARPS, N, L, 14, n, B=FLEET_B, device=device)
        blocks = ilqr.blocks_per_sm(dtype, where, N, L, 14, n)
        smem = ilqr.smem_bytes(dtype, where.warps, N, L, 14, n, where.global_table)
        before = profiling.counts()
        got = ilqr._launch(cfg, *sargs, pk, where=given)
        ms = cuda_ms(lambda: ilqr._launch(cfg, *sargs, pk, where=given), reps)
        counted = profiling.counts() - before
        moved = {name: counted[f"ilqr.solve.{name}"] for name in ("shared", "global", "workspace")}
        launches += reps + 2
        shared_out = shared_out or got
        equal = model is not buckmore[0] or all(torch.equal(a, b) for a, b in zip(got, shared_out))
        print(f"solve kernel h10 f32 B={FLEET_B} {label}: n={n}, placement {where.name} ({where.warps} OCPs a "
              f"block, {smem} B of shared memory a block), {blocks} blocks per SM ({blocks * where.warps} warps); "
              f"launches by placement {moved}; {ms:.4f} ms per launch (CUDA events, "
              f"{reps})" + (f"; bit-equal to the shared launch {equal}" if model is buckmore[0] else ""))
        if (where.name != expect or moved != {**dict.fromkeys(moved, 0), expect: reps + 2} or not equal
                or expect_blocks not in (None, blocks)):
            raise AssertionError(f"{label}: placement {where.name} at {blocks} blocks per SM, launches {moved}, "
                                 f"bit-equal to the shared launch {equal}; expected {expect}")
        out[f"fleet_{label}"] = {"placement": where.name, "blocks_per_sm": blocks, "smem_bytes": smem, "ms": ms}
    return launches + placement_sweep(device, out)


def placement_sweep(device, out, reps: int = 5) -> int:
    """Phase 10 (g), the placement rule across B: for h10 f32 and h20 f64 on
    buckmore, at each B of PLACEMENT_SWEEP (from `fleet_states`), the
    placement the wrapper picks, each candidate's blocks per SM and waves,
    and its ms per launch (CUDA events over `reps` launches after one),
    given through `_launch`'s `where`, the candidates bit-equal; printed,
    with the pick's time over the faster candidate's, and into `out`.
    Returns the solve launches."""
    from lap_time_optimization_tpu_torch.mpc.solver import SolverConfig
    from lap_time_optimization_tpu_torch.ops import ilqr

    launches = 0
    for label, dtype, cfg in (("h10 f32", torch.float32, SolverConfig(horizon=10)),
                              ("h20 f64", torch.float64, SolverConfig.for_horizon(20))):
        model, p = load_main_path(device, dtype)
        pk = ilqr.pack(model, p, cfg)
        N, L, n = cfg.horizon, cfg.n_linesearch, pk.tables.shape[-1]
        found = ilqr.candidates(dtype, ilqr.WARPS, N, L, 14, n)
        if "shared" not in found:
            raise AssertionError(f"{label}: the table does not fit shared memory ({found})")
        candidates = (found["shared"], found["global"])
        for B in PLACEMENT_SWEEP:
            sargs = solve_inputs(model, cfg, fleet_states(model.track, B), 2.0, 3)
            pick = ilqr.placement(dtype, ilqr.WARPS, N, L, 14, n, B=B, device=device)
            outs = [ilqr._launch(cfg, *sargs, pk, where=w) for w in candidates]
            same = all(torch.equal(a, b) for a, b in zip(*outs))
            ms = {w.name: cuda_ms(lambda: ilqr._launch(cfg, *sargs, pk, where=w), reps) for w in candidates}
            resident = {w.name: ilqr.occupancy(dtype, w, N, L, 14, n, device) for w in candidates}
            waves = {w.name: ilqr.waves(B, w.warps, *resident[w.name]) for w in candidates}
            launches += 2 * (reps + 2)
            print(f"placement sweep {label} B={B}: the wrapper picks {pick.name}; "
                  + "; ".join(f"{w.name} ({w.warps} OCPs a block, {resident[w.name][1]} blocks per SM, "
                              f"{waves[w.name]} waves) {ms[w.name]:.4f} ms" for w in candidates)
                  + f"; the pick over the faster {ms[pick.name] / min(ms.values()):.4f}; bit-equal {same}")
            if pick not in candidates or not same:
                raise AssertionError(f"{label} B={B}: pick {pick}, candidates bit-equal {same}")
            out[f"sweep {label} B={B}"] = {"pick": pick.name, "ms": ms, "waves": waves}
    return launches


def lap_gates(model, p, sim, window: int):
    """TestHorizon20's and TestFullLap's gates of a lap: (applied violation
    of the first `window` cycles on the true band, progress strictly
    monotone, the last s past s_max, max |mu|, all finite)."""
    from lap_time_optimization_tpu_torch.mpc import runner

    head = runner.SimResult(*(a[:window + 1] for a in sim[:2]), *(a[:window] for a in sim[2:]))
    xs = sim.xs.double().cpu().numpy()
    return (runner.applied_violation(model, p, head), bool(np.all(np.diff(xs[:, 0]) > 0)),
            float(xs[-1, 0]) > float(model.track.s_max), float(np.abs(xs[:, 2]).max()),
            all(bool(torch.isfinite(a).all()) for a in sim))


def loop_start(model, cfg, B):
    """(z0, us_init, lam_init) a closed loop's first solve takes (the zero
    warm start of `runner._presolve`): from X0_REFERENCE at B=1, from
    bench.py's fleet (X0_REFERENCE + 0.01·b) at B > 1."""
    from lap_time_optimization_tpu_torch.mpc import runner
    from lap_time_optimization_tpu_torch.mpc import solver as S

    dtype, device = model.track.k_vals.dtype, model.track.k_vals.device
    x0 = runner.X0_REFERENCE if B == 1 else np.tile(runner.X0_REFERENCE, (B, 1)) + 0.01 * np.arange(B)[:, None]
    lead = x0.shape[:-1]
    z0 = torch.as_tensor(np.concatenate([x0, np.zeros(lead + (2,))], axis=-1), dtype=dtype, device=device)
    zeros = lambda *shape: torch.zeros(lead + shape, dtype=dtype, device=device)
    return z0, zeros(cfg.horizon, 2), zeros(cfg.horizon + 1, S.n_con(model))


def check_long_solve(label, model, p, cfg, sargs, pk) -> int:
    """The solve kernel against the plain solve per instance at long
    horizons, where the plain solve is not always stable to rounding: with
    `for_horizon`'s 2 x 5 iterations one ulp of z0 moves the plain solve
    itself by many tolerances on some warm starts (at f32 N >= 161 on all
    of the loops' warm starts), so two implementations that round
    differently can be held only where it does not.  Each instance's distance (max over the
    outputs, in units of phase 3's tolerance of each output) is held to 1
    where the plain solve's own distance under one ulp of z0 is within 1;
    every instance is held to finite outputs.  Prints both; returns the
    number of instances held."""
    from lap_time_optimization_tpu_torch.ops import ilqr

    dtype = sargs[0].dtype
    got = ilqr.solve(model, p, cfg, *sargs, pk)
    lead = (lambda t: t[None]) if sargs[0].dim() == 1 else (lambda t: t)
    z0, us, lam = (lead(a) for a in sargs)
    B = z0.shape[0]
    z0_ulp = torch.nextafter(z0, torch.full_like(z0, float("inf")))
    both = ilqr.solve_reference(model, p, cfg, torch.cat([z0, z0_ulp]), torch.cat([us, us]),
                                torch.cat([lam, lam]), pk)
    ref, ref_ulp, got = [t[:B] for t in both], [t[B:] for t in both], [lead(t) for t in got]

    def dist(a, b):  # per instance, in units of each output's tolerance
        out = torch.zeros(B, dtype=torch.float64, device=z0.device)
        for name, x, y in zip(SOLVE_FIELDS, a, b):
            tol = (SOLVE_F64_TOL if dtype == torch.float64 else SOLVE_F32_LAM_TOL if name == "lam"
                   else SOLVE_F32_TOL)
            d = ((x.double() - y.double()).abs() / y.double().abs().clamp(min=1.0)).reshape(B, -1).amax(1)
            out = torch.maximum(out, d / tol)
        return out

    d_kernel, d_ulp = dist(got, ref), dist(ref_ulp, ref)
    stable = d_ulp <= 1.0
    finite = all(bool(torch.isfinite(g).all()) for g in got)
    worst = lambda d, m: f"{float(d[m].max()):.3g}" if bool(m.any()) else "-"
    print(f"{label}: {int(stable.sum())} of {B} instances stable to one ulp of z0 (the plain solve moves by <= 1 "
          f"tolerance), the kernel's distance there {worst(d_kernel, stable)} tolerances (held <= 1); on the "
          f"others the kernel's {worst(d_kernel, ~stable)}, the plain solve's own under one ulp "
          f"{worst(d_ulp, ~stable)}; finite {finite}; cost {float(ref[3].max()):.2f}")
    if not finite or bool((d_kernel[stable] > 1.0).any()):
        raise AssertionError(f"{label}: the solve kernel disagrees with the plain solve")
    return int(stable.sum())


def phase_long_horizons(device):
    """Phase 13: the solve kernel's workspace placement and long ladders
    against the shared placement and the plain solve, the h20 class through
    a whole lap, then the kernel's times (see the module docstring).
    Returns the solve-kernel launches of its driven paths and its readings."""
    from lap_time_optimization_tpu_torch.mpc import runner
    from lap_time_optimization_tpu_torch.mpc.solver import SolverConfig
    from lap_time_optimization_tpu_torch.ops import ilqr

    t_phase = time.perf_counter()
    launches, out = 0, {}
    h10 = SolverConfig(horizon=10)
    dt = lambda dtype: str(dtype)[6:]
    cases = lambda model, B: (runner.X0_REFERENCE if B == 1 else fleet_states(model.track, B))

    # bits: at buckmore h10 the slices sit in shared memory; the workspace
    # forced (scalars, slices and table in global memory) gives the same bits
    for dtype in (torch.float64, torch.float32):
        model, p = load_main_path(device, dtype)
        pk = ilqr.pack(model, p, h10)
        for B in (1, BATCH):
            sargs = solve_inputs(model, h10, cases(model, B), 2.0, 1 if B == 1 else 3)
            where = ilqr.placement(dtype, min(ilqr.WARPS, B), 10, h10.n_linesearch, 14, pk.tables.shape[-1], B=B)
            shared = ilqr._launch(h10, *sargs, pk)
            ws = ilqr.candidates(dtype, min(ilqr.WARPS, B), 10, h10.n_linesearch, 14, pk.tables.shape[-1])["workspace"]
            same = all(torch.equal(a, b) for a, b in zip(ilqr._launch(h10, *sargs, pk, where=ws), shared))
            print(f"solve kernel {dt(dtype)} B={B} h10: the wrapper's placement {tuple(where)}; the workspace "
                  f"forced: bit-equal {same}")
            if where.workspace or not same:
                raise AssertionError(f"workspace placement {dt(dtype)} B={B}: placement {where}, bit-equal {same}")

    # long horizons.  At the last horizon one OCP's slice fits a block, the
    # workspace forced gives the bits of the slice in shared memory; past
    # it, the workspace against the plain solve (B=1 and 32, from the
    # warm start a closed loop begins with), per instance at phase 3's
    # tolerances where the plain solve itself is stable to one ulp of z0
    # (see check_long_solve)
    for dtype, horizons in LONG_HORIZONS.items():
        model, p = load_main_path(device, dtype)
        n = int(model.track.k_vals.shape[0])
        top = max(N for N in range(1, 400) if ilqr.smem_bytes(dtype, 1, N, 6, 14, n, True))
        cfg = SolverConfig.for_horizon(top)
        pk = ilqr.pack(model, p, cfg)
        for B in (1, BATCH):
            sargs = loop_start(model, cfg, B)
            own = ilqr.solve(model, p, cfg, *sargs, pk)
            ws = ilqr.candidates(dtype, min(ilqr.WARPS, B), top, cfg.n_linesearch, 14, n)["workspace"]
            same = all(torch.equal(a, b) for a, b in zip(ilqr._launch(cfg, *sargs, pk, where=ws), own))
            print(f"N={top}, the last horizon whose slice fits a block in {dt(dtype)} (6 rungs, 14 rows), B={B}: the "
                  f"wrapper's placement {tuple(ilqr.placement(dtype, min(ilqr.WARPS, B), top, 6, 14, n, B=B))}; the "
                  f"workspace forced: bit-equal {same}; N={top + 1} takes "
                  f"{tuple(ilqr.placement(dtype, min(ilqr.WARPS, B), top + 1, 6, 14, n, B=B))}")
            if not same or ilqr.placement(dtype, 1, top, 6, 14, n).workspace:
                raise AssertionError(f"the workspace at N={top} {dt(dtype)} B={B} differs from the shared slice")
        for N in horizons:
            cfg = SolverConfig.for_horizon(N)
            pk = ilqr.pack(model, p, cfg)
            for B in (1, BATCH):
                where = ilqr.placement(dtype, min(ilqr.WARPS, B), N, 6, 14, n, B=B)
                if not where.workspace:
                    raise AssertionError(f"N={N} {dt(dtype)} took placement {where}")
                held = check_long_solve(f"solve kernel vs plain {dt(dtype)} N={N} B={B} (placement {tuple(where)})",
                                        model, p, cfg, loop_start(model, cfg, B), pk)
                if dtype == torch.float64 and not held:
                    raise AssertionError(f"no f64 instance at N={N} B={B} is stable enough to hold")
    model, p = load_main_path(device, torch.float32)
    cfg = SolverConfig.for_horizon(LONG_HORIZONS[torch.float32][-1])
    pk = ilqr.pack(model, p, cfg)
    sargs = loop_start(model, cfg, BATCH)
    got = ilqr.solve(model, p, cfg, *sargs, pk)
    same = all(torch.equal(g[b], o) for b in range(BATCH)
               for g, o in zip(got, ilqr.solve(model, p, cfg, *(a[b] for a in sargs), pk)))
    print(f"solve kernel f32 N={cfg.horizon} B={BATCH} (workspace) vs B=1 per instance: bit-equal {same}")
    if not same:
        raise AssertionError(f"a workspace batch instance at N={cfg.horizon} differs from its B=1 launch")
    model, p = load_main_path(device, torch.float32)
    cfg = SolverConfig.for_horizon(HUGE_HORIZON)
    pk = ilqr.pack(model, p, cfg)
    got = ilqr.solve(model, p, cfg, *solve_inputs(model, cfg, runner.X0_REFERENCE, 0.0, 3), pk)
    finite = all(bool(torch.isfinite(g).all()) for g in got)
    print(f"solve kernel f32 N={HUGE_HORIZON} B=1 ({ilqr.workspace_elems(1, HUGE_HORIZON, 6, 14) * 4} B of workspace): "
          f"outputs finite {finite}; cost {float(got[3]):.3f}, max violation {float(got[4]):.3e}")
    if not finite:
        raise AssertionError(f"the f32 solve at N={HUGE_HORIZON} is not finite")

    # long ladders: past one lane per rung, against the plain solve; at 48
    # rungs also reversed, so that the full step lies on rung 47
    for dtype in (torch.float64, torch.float32):
        model, p = load_main_path(device, dtype)
        sargs = solve_inputs(model, h10, np.array([430.0, *runner.X0_REFERENCE[1:]]), 2.0, 1)
        for L in LONG_LADDERS:
            cfg = dataclasses.replace(h10, n_linesearch=L)
            pk = ilqr.pack(model, p, cfg)
            for name, pk_l in (("", pk), (" reversed", pk._replace(alphas=pk.alphas.flip(0).contiguous())))[
                    :1 + (L == LONG_LADDERS[-1])]:
                got = ilqr.solve(model, p, cfg, *sargs, pk_l)
                check_solve(f"solve kernel vs plain {dt(dtype)} L={L}{name} h10 B=1 s0=430", got,
                            ilqr.solve_reference(model, p, cfg, *sargs, pk_l), dtype)

    # the h20 class through a whole lap: TestFullLap and TestHorizon20 on
    # the card, f64 and f32 (JAX runs them in f64; f32 meets them too)
    cfg = SolverConfig.for_horizon(20)
    for dtype in (torch.float64, torch.float32):
        model, p = load_main_path(device, dtype)
        x0 = torch.as_tensor(runner.X0_REFERENCE, dtype=dtype, device=device)
        runner.closed_loop_chunked(model, p, cfg, x0, LAP_CHUNK, chunk=LAP_CHUNK)  # warm-up: a chunk's graphs
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        sim = runner.closed_loop_chunked(model, p, cfg, x0, LAP_CYCLES, chunk=LAP_CHUNK)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()
        applied, monotone, lapped, mu, finite = lap_gates(model, p, sim, LAP_WINDOW)
        meets = applied < 1e-2 and monotone and lapped and mu < LAP_MU and finite
        out[f"lap_hz_{dt(dtype)}"] = LAP_CYCLES / wall
        out[f"lap_{dt(dtype)}"] = (model, p, cfg, x0, sim)
        print(f"h20 lap (for_horizon(20), {LAP_CYCLES} cycles of closed_loop_chunked, chunk {LAP_CHUNK}, "
              f"{dt(dtype)}): {wall:.3f} s = {LAP_CYCLES / wall:.2f} Hz; progress {float(sim.xs[-1, 0]):.2f} m of "
              f"{float(model.track.s_max):.2f}; applied violation over the first {LAP_WINDOW} cycles {applied:.3e} "
              f"(< 1e-2), over the lap {runner.applied_violation(model, p, sim):.3e}; progress monotone {monotone}; "
              f"lap completed {lapped}; max |mu| {mu:.4f} (< {LAP_MU}); finite {finite}; JAX's gates met {meets}; "
              f"launches {counts}")
        if counts != (LAP_CYCLES + 2, 0, LAP_CYCLES):
            raise AssertionError(f"h20 lap launches {counts}, expected ({LAP_CYCLES + 2}, 0, {LAP_CYCLES})")
        if not meets:
            raise AssertionError(f"the {dt(dtype)} h20 lap fails its gates")
        launches += counts[0]
        out["tail_launches"] = out.get("tail_launches", 0) + counts[2]

    # times, after every gate: CUDA events per call, with the bound
    timed = []
    for label, dtype, horizon, rungs, B in TIMED_SOLVES:
        cfg = SolverConfig.for_horizon(horizon)
        cfg = cfg if rungs is None else dataclasses.replace(cfg, n_linesearch=rungs)
        model, p = load_main_path(device, dtype)
        pk = ilqr.pack(model, p, cfg)
        sargs = solve_inputs(model, cfg, cases(model, B), 0.0 if B == 1 else 2.0, 3)
        outs = ilqr.solve(model, p, cfg, *sargs, pk)
        ms = cuda_ms(lambda: ilqr.solve(model, p, cfg, *sargs, pk), 5 if cfg.horizon > 40 or B > BATCH else 20)
        bound = bound_ms(nbytes(*sargs, *pk, *outs), B * solve_flops(cfg),
                         F64_FLOP_PER_S if dtype == torch.float64 else F32_FLOP_PER_S)
        where = ilqr.placement(dtype, min(ilqr.WARPS, B), cfg.horizon, cfg.n_linesearch, 14, pk.tables.shape[-1], B=B)
        timed.append((label, ms, bound))
        print(f"solve kernel per call {label} B={B} (N={cfg.horizon} L={cfg.n_linesearch} substeps={cfg.substeps} "
              f"{cfg.al_iters}x{cfg.ilqr_iters} iterations, placement {tuple(where)}): {ms:.4f} ms; "
              f"bound {bound[0] * 1e3:.4f} us ({bound[1]})")
    # the workspace's own cost at equal horizon: forced at h10 and at N=160
    # (the last f32 slice a block holds) beside the placement the wrapper takes
    model, p = load_main_path(device, torch.float32)
    for cfg in (h10, SolverConfig.for_horizon(160)):
        pk = ilqr.pack(model, p, cfg)
        sargs = solve_inputs(model, cfg, runner.X0_REFERENCE, 0.0, 3)
        forced = ilqr.candidates(torch.float32, 1, cfg.horizon, cfg.n_linesearch, 14, pk.tables.shape[-1])["workspace"]
        own = cuda_ms(lambda: ilqr._launch(cfg, *sargs, pk), 10)
        ws = cuda_ms(lambda: ilqr._launch(cfg, *sargs, pk, where=forced), 10)
        out[f"workspace_cost_{cfg.horizon}"] = ws / own
        print(f"solve kernel f32 B=1 N={cfg.horizon}: the wrapper's placement "
              f"{tuple(ilqr.placement(torch.float32, 1, cfg.horizon, 6, 14, pk.tables.shape[-1]))} {own:.4f} ms, "
              f"the workspace forced {ws:.4f} ms ({ws / own:.3f}x)")
    out["timed"] = timed
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"phase 13: {out['phase_s']:.1f} s")
    return launches, out


def phase_graphs(loops, main, steps, batch_steps):
    """Phase 15: the graphed loops against the eager loop on the card.
    `loops`: (label, (model, p, cfg, x0, graphed result), chunk or None) of
    the loops the earlier phases ran through their public entry points,
    each held bit for bit to the same loop run eagerly (`runner._loop` /
    `_closed_loop_chunked` with 0 cycles per program).  Then, on the main path (`main`: model, p,
    cfg, x0, x0b), the single stream (`steps` cycles) and the fleet
    (`batch_steps`) eager and graphed in turns, and the capture and the rate
    at G = 10, 25, 50 and 100 cycles per graph."""
    from lap_time_optimization_tpu_torch.mpc import runner
    from lap_time_optimization_tpu_torch.utils import profiling

    t_phase = time.perf_counter()
    for label, (model, p, cfg, x0, graphed), chunk in loops:
        n = graphed.costs.shape[-1]
        t0 = time.perf_counter()
        if chunk:
            eager = runner._closed_loop_chunked(model, p, cfg, x0, n, chunk, None, 0)
        else:
            eager = runner._loop(model, p, cfg, x0, n, 0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        same = all(torch.equal(g, e) for g, e in zip(graphed, eager))
        worst = max(float((g.double() - e.double()).abs().max()) for g, e in zip(graphed, eager))
        print(f"graphed vs eager, {label}: bit-equal {same} (max |d| {worst:.3e}); eager {n / wall:.2f} "
              f"cycles/s")
        if not same:
            raise AssertionError(f"{label}: the graphed loop differs from the eager loop")

    # the main path's rates in turns: eager, graphed, graphed, eager
    model, p, cfg, x0, x0b = main
    for label, start, n in (("single stream", x0, steps), ("fleet", x0b, batch_steps)):
        rates = []
        for cycles in (0, runner.GRAPH_CYCLES, runner.GRAPH_CYCLES, 0):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            runner._loop(model, p, cfg, start, n, cycles)
            torch.cuda.synchronize()
            rates.append(start[..., 0].numel() * n / (time.perf_counter() - t0))
        unit = "Hz" if start.dim() == 1 else "solves/s"
        print(f"{label} f32 in turns (eager, graphed G={runner.GRAPH_CYCLES}, graphed, eager): "
              + ", ".join(f"{r:.2f}" for r in rates) + f" {unit}")

    # G: a capture and then a timed run of the single stream and the fleet
    # at each G, the capture's times from its spans (the G of the timed
    # phases is already captured: no capture, no spans)
    for G in (10, 25, 50, 100):
        row = []
        for start, n in ((x0, steps), (x0b, batch_steps)):
            key = runner._program_key(model, p, cfg, start, min(G, n))
            captures = profiling.counts()["runner.graph_captures"]
            t0 = time.perf_counter()
            with profiling.recording():
                runner._loop(model, p, cfg, start, n, G)
            torch.cuda.synchronize()
            first = time.perf_counter() - t0
            host_s = {s["name"]: (s["end_ns"] - s["start_ns"]) / 1e9 for s in profiling.spans()
                      if s["name"].startswith("runner.capture.")}
            t0 = time.perf_counter()
            runner._loop(model, p, cfg, start, n, G)
            torch.cuda.synchronize()
            rate = start[..., 0].numel() * n / (time.perf_counter() - t0)
            prog = runner._PROGRAMS[key]
            capture = (f"capture (warm-up cycle {host_s['runner.capture.warmup']:.3f} s, record "
                       f"{host_s['runner.capture.record']:.3f} s, end and instantiate "
                       f"{host_s['runner.capture.instantiate']:.3f} s)" if host_s else "captured before")
            captured = profiling.counts()["runner.graph_captures"] - captures
            row.append(f"B={start[..., 0].numel()} {n} cycles: {capture}, pool "
                       f"{prog.pool_bytes / 2**20:.1f} MiB, {captured} captured in this "
                       f"run, first run {first:.3f} s, then {rate:.2f} solves/s")
        print(f"G={G}: " + "; ".join(row))
    pools = sum(prog.pool_bytes for prog in runner._PROGRAMS.values() if prog.graph is not None)
    counts = profiling.counts()
    print(f"graph captures so far {counts['runner.graph_captures']} (programs cached {len(runner._PROGRAMS)}, at "
          f"most {runner._MAX_PROGRAMS}); their warm-up and recorded solve launches "
          f"{counts['runner.capture.ilqr.solve']}; the cached "
          f"graphs' pools {pools / 2**20:.1f} MiB; memory reserved {torch.cuda.memory_reserved() / 2**20:.1f} MiB")
    print(f"phase 15: {time.perf_counter() - t_phase:.1f} s")


def fingerprint(device) -> dict:
    """SHA-256 of both kernels' outputs through their wrappers on phase 3's
    solve inputs (three single states and 32 over the lap, three model
    variants, f64 and f32) and on the 1024 tbr18 buckmore lines of phase 11
    (tbr18 and MX5, closed and the first 300 samples open, f64 and f32),
    with hashes of those inputs, the kernels' times at the main paths'
    shapes: the solve kernel per call at B = 1 and 32 (CUDA events) and
    kernel 3 at B=1024 (device time), and the NMPC rates of phases 4-5
    (host clock), twice each, through the public loops and, in turns with
    them, the eager loop where the tree has `runner._loop`.  Only public entry points that every slice of the port
    has are used, so the same script run beside an earlier tree shows
    whether a change kept the kernels' bits and the loops' rates."""
    import hashlib

    from lap_time_optimization_tpu_torch.mpc import runner
    from lap_time_optimization_tpu_torch.mpc.solver import SolverConfig
    from lap_time_optimization_tpu_torch.ops import ilqr, spline
    from lap_time_optimization_tpu_torch.ops import velocity_batch as vb
    from lap_time_optimization_tpu_torch.optim import global_search as gs

    digest = {name: hashlib.sha256() for name in ("solve_in", "solve_out", "solve_l32_out", "k3_in", "k3_out")}
    feed = lambda name, *ts: [digest[name].update(t.detach().cpu().contiguous().numpy().tobytes()) for t in ts]
    cfg = SolverConfig(horizon=10)
    out = {}
    for dtype in (torch.float64, torch.float32):
        for tv, te in ((False, False), (False, True), (True, False)):
            model, p = load_main_path(device, dtype, tv, te)
            pk = ilqr.pack(model, p, cfg)
            cases = [(np.array([s0, *runner.X0_REFERENCE[1:]]), lam, seed)
                     for s0, lam, seed in ((0.0, 0.0, 0), (430.0, 2.0, 1), (855.0, 5.0, 2))]
            cases.append((fleet_states(model.track, BATCH), 2.0, 3))
            for x0, lam, seed in cases:
                sargs = solve_inputs(model, cfg, x0, lam, seed)
                feed("solve_in", *sargs, *pk)
                feed("solve_out", *ilqr.solve(model, p, cfg, *sargs, pk))
            cfg32 = dataclasses.replace(cfg, n_linesearch=32)  # the most rungs every slice takes
            pk32 = ilqr.pack(model, p, cfg32)
            for x0, lam, seed in cases:
                feed("solve_l32_out", *ilqr.solve(model, p, cfg32, *solve_inputs(model, cfg32, x0, lam, seed), pk32))
            if dtype == torch.float32 and not (tv or te):
                for B in (1, BATCH):
                    sargs = solve_inputs(model, cfg, runner.X0_REFERENCE if B == 1 else fleet_states(model.track, B),
                                         0.0 if B == 1 else 2.0, 3)
                    out[f"solve_ms_B{B}"] = cuda_ms(lambda: ilqr.solve(model, p, cfg, *sargs, pk), 20)
    # the single stream (500 cycles) and the fleet (32 x 100) of phases 4-5,
    # before kernel 3's profiler session, which slows later launches: the
    # public loops (graphed on the card where the tree has graphs) and, where
    # the tree has it, the eager loop (`runner._loop(..., 0)`), in turns
    # (eager, public, public, eager); each list holds its two readings
    model, p = load_main_path(device, torch.float32)
    x0 = torch.as_tensor(runner.X0_REFERENCE, dtype=torch.float32, device=device)
    x0b = torch.as_tensor(np.tile(runner.X0_REFERENCE, (BATCH, 1)) + 0.01 * np.arange(BATCH)[:, None],
                          dtype=torch.float32, device=device)  # bench.py:81-83
    eager_loop = getattr(runner, "_loop", None)
    for name, loop, steps, B in (("single_stream_hz", runner.closed_loop, 500, 1),
                                 ("fleet_solves_per_s", runner.closed_loop_batch, 100, BATCH)):
        start = x0 if B == 1 else x0b
        loop(model, p, cfg, start, getattr(runner, "GRAPH_CYCLES", 3))  # warm-up: the graph of G cycles
        turns = [("eager_" + name, lambda: eager_loop(model, p, cfg, start, steps, 0)),
                 (name, lambda: loop(model, p, cfg, start, steps))]
        turns = turns + turns[::-1] if eager_loop is not None else turns[1:] * 2
        for key, run in turns:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            out.setdefault(key, []).append(B * steps / (time.perf_counter() - t0))
    n_dec = search_setup("cpu", torch.float64)[0].n_decongested
    alphas_np = np.random.default_rng(7).uniform(0.0, gs.ALPHA_HI, (K3_BATCH, n_dec))
    for dtype in (torch.float64, torch.float32):
        track, tbr18, mx5 = search_setup(device, dtype)
        with torch.no_grad():
            s_b, k_b, len_b = gs._geometry(track, torch.as_tensor(alphas_np, dtype=dtype, device=device),
                                           spline.FIT_METHOD_CLOSED_BATCHED)
        s_n = s_b[:, :-1]
        feed("k3_in", s_n, k_b, len_b)
        for veh in (tbr18, mx5):
            feed("k3_out", vb.solve_profile_batch(veh, s_n, k_b, len_b, True),
                 vb.solve_profile_batch(veh, s_n[:, :300], k_b[:, :300].contiguous(), len_b, False))
        if dtype == torch.float32:
            out["k3_ms_B1024"] = device_ms(lambda: vb.solve_profile_batch(tbr18, s_n, k_b, len_b, True), 50,
                                           "velocity_profile_batch_kernel")
    out.update({name: h.hexdigest()[:16] for name, h in digest.items()})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=500,
                    help="timed single-stream control cycles; the fleet runs max(10, steps // 5)")
    ap.add_argument("--profile", type=str, default=None,
                    help="directory for torch.profiler summaries of each NMPC loop, graphed and eager")
    ap.add_argument("--fingerprint", action="store_true",
                    help="print only the kernels' output hashes and times at the main paths' shapes "
                         "(`fingerprint`), to hold two trees against each other, and exit")
    args = ap.parse_args(argv)

    # ---------------------------------------------------------------- phase 1
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    if args.fingerprint:
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
        print(f"card: {nvidia_smi()}")
        print(json.dumps({"fingerprint": fingerprint(torch.device("cuda", 0)), "root": ROOT}))
        return 0
    from lap_time_optimization_tpu_torch.models import load_vehicle
    from lap_time_optimization_tpu_torch.models.bicycle import BicycleModel
    from lap_time_optimization_tpu_torch.mpc import runner
    from lap_time_optimization_tpu_torch.mpc import track as mpc_track
    from lap_time_optimization_tpu_torch.mpc.solver import SolverConfig
    from lap_time_optimization_tpu_torch.ops import _build, cycle_tail, ilqr, spline
    from lap_time_optimization_tpu_torch.ops import velocity_batch as vb
    from lap_time_optimization_tpu_torch.optim import global_search as gs
    from lap_time_optimization_tpu_torch.utils.config import Config

    device = torch.device("cuda", 0)
    smi = nvidia_smi()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    print(f"nvidia-smi: {smi}")
    print(f"allow_tf32: matmul={torch.backends.cuda.matmul.allow_tf32} cudnn={torch.backends.cudnn.allow_tf32}")

    # ---------------------------------------------------------------- phase 2
    t0 = time.perf_counter()
    ilqr.build()
    vb.build()
    cycle_tail.build()
    print(f"build: {time.perf_counter() - t0:.2f} s ({len(_build.SOURCES)} sources, one nvcc process each, "
          f"in parallel)")
    for line in _build.BUILD_LOG.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print(f"  nvcc: {line.strip()}")

    # ---------------------------------------------------------------- phase 3
    cfg = SolverConfig(horizon=10)
    worst_f32_abs = 0.0
    for dtype in (torch.float64, torch.float32):
        for tv, te in ((False, False), (False, True), (True, False)):
            model, p = load_main_path(device, dtype, tv, te)
            pk = ilqr.pack(model, p, cfg)
            tag = f"{str(dtype)[6:]} n_con={14 + 2 * te} tv={tv}"
            errs = []
            cases = [(f"s0={s0}", np.array([s0, *runner.X0_REFERENCE[1:]]), lam_scale, seed)
                     for s0, lam_scale, seed in ((0.0, 0.0, 0), (430.0, 2.0, 1), (855.0, 5.0, 2))]
            cases.append((f"B={BATCH}", fleet_states(model.track, BATCH), 2.0, 3))
            if dtype == torch.float32:
                m64, p64 = load_main_path(device, torch.float64, tv, te)
            for name, x0, lam_scale, seed in cases:
                sargs = solve_inputs(model, cfg, x0, lam_scale, seed)
                got = ilqr.solve(model, p, cfg, *sargs, pk)
                ref = ilqr.solve_reference(model, p, cfg, *sargs, pk)
                errs.append(check_solve(f"solve kernel vs plain {tag} {name}", got, ref, dtype))
                if dtype == torch.float32:  # how far float32 itself is from float64
                    ref64 = ilqr.solve_reference(m64, p64, cfg, *(a.double() for a in sargs),
                                                 ilqr.pack(m64, p64, cfg))
                    print(f"  plain f32 vs plain f64 on the same inputs: max |d|/max(1,|ref|) "
                          + ", ".join(f"{n} {float(((r.double() - r6).abs() / r6.abs().clamp(min=1.0)).max()):.2e}"
                                      for n, r, r6 in zip(SOLVE_FIELDS, ref, ref64)))
            # instance b of the batch launch is the B=1 launch on it, bit for bit
            same = all(torch.equal(g[b], o) for b in range(BATCH)
                       for g, o in zip(got, ilqr.solve(model, p, cfg, *(a[b] for a in sargs), pk)))
            print(f"solve kernel B={BATCH} vs B=1 per instance {tag}: bit-equal {same}")
            if not same:
                raise AssertionError(f"{tag}: a batch instance differs from its B=1 launch")
            if dtype == torch.float32:
                worst_f32_abs = max(worst_f32_abs, *errs)

    model, p = load_main_path(device, torch.float32)
    pk = ilqr.pack(model, p, cfg)
    solve_ms, plain_ms, bounds = {}, {}, {}
    for B in (1, BATCH, 1024):
        x0 = runner.X0_REFERENCE if B == 1 else fleet_states(model.track, B)
        sargs = solve_inputs(model, cfg, x0, 0.0 if B == 1 else 2.0, 3)
        for W in (1, 2, 4):
            where = ilqr.placement(torch.float32, W, cfg.horizon, cfg.n_linesearch, 14, pk.tables.shape[-1], B=B)
            solve_ms[B, W] = cuda_ms(lambda: ilqr._launch(cfg, *sargs, pk, where=where), 20)
        plain_ms[B] = cuda_ms(lambda: ilqr.solve_reference(model, p, cfg, *sargs, pk), 3 if B <= BATCH else 1)
        outs = ilqr.solve(model, p, cfg, *sargs, pk)
        bounds[B] = bound_ms(nbytes(*sargs, *pk, *outs), B * solve_flops(cfg))
        print(f"solve kernel per call at B={B} N=10 L=6 substeps=2 2x5 iterations n=846 f32: "
              + ", ".join(f"W={W} {solve_ms[B, W]:.4f} ms" for W in (1, 2, 4))
              + f" (the wrapper takes W={min(ilqr.WARPS, B)}); plain solve {plain_ms[B]:.2f} ms"
              + f"; bound {bounds[B][0] * 1e3:.4f} us ({bounds[B][1]}); "
              f"smem per block {[ilqr.smem_bytes(torch.float32, W, 10, 6, 14, 846) for W in (1, 2, 4)]} B")
    # where the time of a B=1 solve goes, by the kernel's own arguments: no
    # iLQR iteration (the rollout, the AL costs, the multiplier updates and
    # the outputs), and 1 RK4 substep (halves every RK4 chain: the rollout,
    # the linearisation and the ladder)
    sargs = solve_inputs(model, cfg, runner.X0_REFERENCE, 0.0, 3)
    ablation = {}
    for name, c in (("default", cfg), ("ilqr_iters=0", dataclasses.replace(cfg, ilqr_iters=0)),
                    ("substeps=1", dataclasses.replace(cfg, substeps=1))):
        pk_c = ilqr.pack(model, p, c)  # h = dt / substeps
        ablation[name] = cuda_ms(lambda: ilqr.solve(model, p, c, *sargs, pk_c), 20)
    per_it = (ablation["default"] - ablation["ilqr_iters=0"]) / (cfg.al_iters * cfg.ilqr_iters)
    rk4 = 2.0 * (ablation["default"] - ablation["substeps=1"]) / ablation["default"]
    print("solve kernel ablation at B=1 f32: " + ", ".join(f"{k} {v:.4f} ms" for k, v in ablation.items())
          + f"; per iLQR iteration {per_it:.4f} ms; the RK4 chains ~{100 * rk4:.1f}% of the solve")
    n = pk.tables.shape[-1]
    cfg20 = SolverConfig.for_horizon(20)
    h20 = ilqr.placement(torch.float64, ilqr.WARPS, 20, cfg20.n_linesearch, 14, n, B=4096, device=device)
    print(f"blocks per SM: h10 f32 global at 4 warps "
          f"{ilqr.blocks_per_sm(torch.float32, ilqr.Placement(4, True, False), 10, 6, 14, n)}; h20 f64 "
          f"{h20.name} at {h20.warps} warps (a fleet of 4096) "
          f"{ilqr.blocks_per_sm(torch.float64, h20, 20, cfg20.n_linesearch, 14, n)}")

    # ---------------------------------------------------------------- phase 16
    # before the loops, which run the tail kernel every cycle
    worst_tail_abs, p16_tail, tail_timed = phase_tail(device)

    # ---------------------------------------------------------------- phase 4
    x0_np = runner.X0_REFERENCE
    m64, p64 = load_main_path(device, torch.float64)
    ref_m, ref_p = load_main_path("cpu", torch.float64)
    got = runner.closed_loop(m64, p64, cfg, torch.as_tensor(x0_np, device=device), 5)
    ref = runner.closed_loop(ref_m, ref_p, cfg, torch.as_tensor(x0_np), 5)
    dev = float((got.xs.cpu() - ref.xs).abs().max())
    print(f"5-cycle f64 closed loop, card (solve kernel) vs CPU (plain): max |d xs| = {dev:.3e} (tol 1e-9)")
    if not dev <= 1e-9:
        raise AssertionError("closed loop on the card disagrees with the CPU reference")

    x0 = torch.as_tensor(x0_np, dtype=torch.float32, device=device)
    runner.closed_loop(model, p, cfg, x0, runner.GRAPH_CYCLES)  # warm-up: the graph of G cycles
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    sim = runner.closed_loop(model, p, cfg, x0, args.steps)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, stray3, tails = read_counts()
    xs = sim.xs.cpu().numpy()
    applied = runner.applied_violation(model, p, sim)
    applied_pairs = runner.applied_violation(model, p, sim, pairing="applied")
    viols = sim.violations.cpu().numpy()
    predicted = float(viols[:PREDICTED_WINDOW].max())
    hz = args.steps / wall
    print(f"closed loop: {args.steps} steps f32 in {wall:.3f} s = {hz:.2f} Hz; "
          f"progress {xs[-1, 0]:.2f} m; applied violation {applied:.3e} (JAX pairing, gated; "
          f"each input with the state it was applied from: {applied_pairs:.3e}); "
          f"predicted violation {predicted:.3e} over the first {PREDICTED_WINDOW} cycles, "
          f"{float(viols.max()):.3e} over all (step {int(viols.argmax())}); "
          f"solve-kernel launches {launches} ({launches / (args.steps + 2):.1f} per control cycle), "
          f"tail-kernel launches {tails}")
    if launches != args.steps + 2 or stray3 != 0 or tails != args.steps:
        raise AssertionError(f"{launches} solve-kernel launches, expected {args.steps + 2}; "
                             f"{stray3} kernel-3 launches, expected 0; {tails} tail-kernel launches, "
                             f"expected {args.steps}")
    if xs.shape != (args.steps + 1, 8) or not np.all(np.isfinite(xs)):
        raise AssertionError("closed-loop states are not finite or of the wrong shape")
    if not np.all(np.diff(xs[:, 0]) > 0):
        raise AssertionError("track progress is not monotone")
    if not (applied < 1e-2 and predicted < 0.02):
        raise AssertionError("constraint violation above its gate")

    # ---------------------------------------------------------------- phase 5
    batch_steps = max(10, args.steps // 5)  # bench.py:82
    x0b_np = np.tile(x0_np, (BATCH, 1)) + 0.01 * np.arange(BATCH)[:, None]  # bench.py:81-83
    got = runner.closed_loop_batch(m64, p64, cfg, torch.as_tensor(x0b_np[:4], device=device), 3)
    ref = runner.closed_loop_batch(ref_m, ref_p, cfg, torch.as_tensor(x0b_np[:4]), 3)
    dev = float((got.xs.cpu() - ref.xs).abs().max())
    print(f"3-cycle f64 batched loop of 4, card (solve kernel) vs CPU (plain): max |d xs| = {dev:.3e} "
          f"(tol 1e-9)")
    if not dev <= 1e-9:
        raise AssertionError("batched loop on the card disagrees with the CPU reference")

    x0b = torch.as_tensor(x0b_np, dtype=torch.float32, device=device)
    runner.closed_loop_batch(model, p, cfg, x0b, runner.GRAPH_CYCLES)  # warm-up: the graph of G cycles at B=32
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    fleet = runner.closed_loop_batch(model, p, cfg, x0b, batch_steps)
    torch.cuda.synchronize()
    bwall = time.perf_counter() - t0
    batch_launches, stray3, batch_tails = read_counts()
    bxs = fleet.xs.cpu().numpy()
    per = [runner.applied_violation(model, p, runner.SimResult(*(a[b] for a in fleet)))
           for b in range(BATCH)]
    bapplied = max(per[:FLEET_IN_BAND])
    per_pairs = [runner.applied_violation(model, p, runner.SimResult(*(a[b] for a in fleet)), pairing="applied")
                 for b in range(BATCH)]
    solves_per_s = BATCH * batch_steps / bwall
    print(f"fleet: {BATCH} loops x {batch_steps} steps f32 in {bwall:.3f} s = "
          f"{solves_per_s:.1f} solves/s ({batch_steps / bwall:.2f} control cycles/s); "
          f"progress {bxs[:, -1, 0].min():.2f}-{bxs[:, -1, 0].max():.2f} m; applied violation, "
          f"worst of instances 0-{FLEET_IN_BAND - 1} {bapplied:.3e}, instances {FLEET_IN_BAND}-{BATCH - 1} "
          f"{[round(v, 4) for v in per[FLEET_IN_BAND:]]} (JAX pairing, gated; with the state each input was "
          f"applied from: 0-{FLEET_IN_BAND - 1} {max(per_pairs[:FLEET_IN_BAND]):.3e}, {FLEET_IN_BAND}-{BATCH - 1} "
          f"{[round(v, 4) for v in per_pairs[FLEET_IN_BAND:]]}); predicted violation over all "
          f"{float(fleet.violations.max()):.3e}; "
          f"solve-kernel launches {batch_launches} ({batch_launches / (batch_steps + 2):.1f} "
          f"per control cycle), tail-kernel launches {batch_tails}")
    if batch_launches != batch_steps + 2 or stray3 != 0 or batch_tails != batch_steps:
        raise AssertionError(f"{batch_launches} solve-kernel launches, expected {batch_steps + 2}; "
                             f"{stray3} kernel-3 launches, expected 0; {batch_tails} tail-kernel launches, "
                             f"expected {batch_steps}")
    if bxs.shape != (BATCH, batch_steps + 1, 8) or not np.all(np.isfinite(bxs)):
        raise AssertionError("fleet states are not finite or of the wrong shape")
    if not np.all(np.diff(bxs[:, :, 0], axis=1) > 0):
        raise AssertionError("track progress of some instance is not monotone")
    if not bapplied < 1e-2:
        raise AssertionError(f"applied violation of an instance below {FLEET_IN_BAND} above its gate")


    # ---------------------------------------------------------------- phase 6
    conf = Config()
    nl, bo = conf.nonlinear, conf.bayes
    track, tbr18, _ = search_setup(device, torch.float32)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    cands = gs._uniform(gen, (nl.n_random, track.n_decongested), track)  # nonlinear's own draw
    gs._nonlinear_select(track, tbr18, cands, nl.n_refine, "fused")  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sel_times = gs._nonlinear_select(track, tbr18, cands, nl.n_refine, "fused")[0]
    torch.cuda.synchronize()
    sel_s = time.perf_counter() - t0
    print(f"nonlinear selection alone: {nl.n_random} candidates f32 in {1e3 * sel_s:.2f} ms = "
          f"{nl.n_random / sel_s:.0f} candidates/s; best {float(sel_times.min()):.3f} s, "
          f"{int(torch.isinf(sel_times).sum())} non-finite")

    reset_counts()
    t0 = time.perf_counter()
    best_x, best_f = gs.nonlinear(track, tbr18, seed=0, n_random=nl.n_random, n_refine=nl.n_refine,
                                  max_iter=nl.max_iter, solver="fused")
    torch.cuda.synchronize()
    nl_wall = time.perf_counter() - t0
    nl_counts = read_counts()
    nl_lap, laps = lap_report(track, tbr18, best_x)
    print(f"nonlinear (tbr18, buckmore {WIDTH}, f32, seed 0, {nl.n_random} random, {nl.n_refine} refined, "
          f"{nl.max_iter} iterations, fused): {nl_wall:.2f} s; search lap {best_f:.4f} s, {laps} "
          f"(gate {GATE_NONLINEAR:.3f}); launches (solve kernel, kernel 3, tail kernel) {nl_counts}")
    if nl_counts != (0, 1, 0):
        raise AssertionError(f"nonlinear launches {nl_counts}, expected (0, 1, 0)")
    if not (np.isfinite(nl_lap) and np.isfinite(best_f)):
        raise AssertionError("nonlinear lap is not finite")
    if not nl_lap < GATE_NONLINEAR:
        raise AssertionError(f"nonlinear lap {nl_lap:.4f} s above its gate {GATE_NONLINEAR:.3f} s")

    # ---------------------------------------------------------------- phase 7
    reset_counts()
    t0 = time.perf_counter()
    bo_x, bo_f, info = gs.bayesian(
        track, tbr18, seed=0, n_init=bo.n_init, n_local=bo.n_local, n_uniform=bo.n_uniform,
        max_rounds=bo.max_rounds, sigma_window=bo.sigma_window, sigma_tol=bo.sigma_tol,
        min_samples=bo.min_samples, polish_every=bo.polish_every, polish_iters=bo.polish_iters,
        solver="fused")
    torch.cuda.synchronize()
    bo_wall = time.perf_counter() - t0
    bo_counts = read_counts()
    bo_lap, laps = lap_report(track, tbr18, bo_x)
    print(f"bayesian (tbr18, buckmore {WIDTH}, f32, seed 0, n_init {bo.n_init}, {bo.n_local}+{bo.n_uniform} "
          f"per round, up to {bo.max_rounds} rounds, {bo.polish_iters} polish iterations, fused): "
          f"{bo_wall:.2f} s; {info['rounds']} rounds, {info['n_samples']} samples; timings "
          f"{json.dumps(info['timings'])}; search lap {bo_f:.4f} s, {laps} "
          f"(gate {GATE_BAYES:.3f}); launches (solve kernel, kernel 3, tail kernel) {bo_counts}")
    if bo_counts != (0, 1 + info["rounds"], 0):
        raise AssertionError(f"bayesian launches {bo_counts}, expected (0, {1 + info['rounds']}, 0)")
    if not (np.isfinite(bo_lap) and np.isfinite(bo_f)):
        raise AssertionError("bayesian lap is not finite")
    if not bo_f < GATE_BAYES:
        raise AssertionError(f"bayesian lap {bo_f:.4f} s above its gate {GATE_BAYES:.3f} s")

    # ---------------------------------------------------------------- phase 8
    # fault 3.1: the same seeded search once more, bit-equal; and once with
    # gather's atomic backward (the state before the repair) for its cost
    reset_counts()
    t0 = time.perf_counter()
    again_x, again_f = gs.nonlinear(track, tbr18, seed=0, n_random=nl.n_random, n_refine=nl.n_refine,
                                    max_iter=nl.max_iter, solver="fused")
    torch.cuda.synchronize()
    again_wall = time.perf_counter() - t0
    again_counts = read_counts()
    same = bool(torch.equal(again_x, best_x)) and again_f == best_f
    atomic_x, atomic_wall = atomic_backward_run(lambda: gs.nonlinear(
        track, tbr18, seed=0, n_random=nl.n_random, n_refine=nl.n_refine, max_iter=nl.max_iter,
        solver="fused")[0])
    print(f"nonlinear again (same seed and budget): {again_wall:.2f} s, search lap {again_f:.4f} s, "
          f"bit-equal to phase 6: {same}; with gather's atomic backward: {atomic_wall:.2f} s, "
          f"bit-equal: {bool(torch.equal(atomic_x, best_x))} (the deterministic backward's cost: "
          f"{nl_wall - atomic_wall:+.2f} s over phase 6, {again_wall - atomic_wall:+.2f} s over this run)")
    if not same or again_counts != (0, 1, 0):
        raise AssertionError(f"the seeded nonlinear search is not reproducible on the card "
                             f"(launches {again_counts})")

    same_graph, capture_s, eager_ms, replay_ms = graph_check(track, tbr18)
    print(f"lap-time objective value+grad (tbr18, buckmore {WIDTH}, f32, 'assoc', K=1): eager "
          f"{eager_ms:.2f} ms, CUDA-graph replay {replay_ms:.2f} ms per call (capture with its warm-up "
          f"{capture_s:.2f} s); bit-equal to eager at 3 lines: {same_graph}")
    if not same_graph:
        raise AssertionError("the graphed value and gradient differ from the eager ones")

    reset_counts()
    same_chunked, chunked_iters, captures, walls = chunked_check(track)
    chunked_counts = read_counts()
    print(f"minimize_bounded_chunked (chunks of 7) vs minimize_bounded on the curvature objective (buckmore "
          f"{WIDTH}, f32, 2 lines, 100 iterations): bit-equal {same_chunked}; n_iter {chunked_iters}; graph "
          f"captures (unchunked, chunked) {captures}; {walls[0]:.2f} s and {walls[1]:.2f} s; "
          f"launches {chunked_counts}")
    if not same_chunked or captures != [1, 1] or chunked_counts != (0, 0, 0):
        raise AssertionError("the chunked L-BFGS run differs from the whole run, or captured its graph "
                             f"more than once ({captures})")

    race_dir = os.path.join(ROOT, "build", "chip_smoke_race")
    shutil.rmtree(race_dir, ignore_errors=True)
    race_k3 = 0
    for method, gate, k3_expected in race_cases(conf):
        out, wall, counts, iters, race_captures = run_race(method, "tbr18", WIDTH, race_dir)
        lap, laps = line_report(track, tbr18, out["alphas"])
        race_k3 += counts[1]
        print(f"race --{method} (tbr18, buckmore {WIDTH}, f32, fused): {wall:.2f} s; L-BFGS iterations "
              f"{iters}; graph captures {race_captures}; CLI lap {out['lap_time']:.4f} s (kernel 3), {laps} "
              f"(gate {gate:.3f}); launches (solve kernel, kernel 3, tail kernel) {counts}")
        if counts != (0, k3_expected, 0):
            raise AssertionError(f"--{method} launches {counts}, expected (0, {k3_expected}, 0)")
        if method == "laptime" and race_captures != 1:
            raise AssertionError(f"--laptime captured its graph {race_captures} times, expected 1")
        if not (np.isfinite(lap) and lap < gate):
            raise AssertionError(f"--{method} lap {lap:.4f} s above its gate {gate:.3f} s")

    # pipeline 1 → pipeline 2: the CLI's MX-5 curvature artifacts drive the NMPC
    out, wall, counts, _, _ = run_race("curvature", "MX5", MX5_WIDTH, race_dir)
    race_k3 += counts[1]
    mtrack = mpc_track.load("MX-5", "buckmore", "curvature", base_dir=race_dir)
    mmodel = BicycleModel(load_vehicle("MX5"), mtrack).to(device, torch.float32)
    reset_counts()
    msim = runner.closed_loop(mmodel, p, cfg, x0, ARTIFACT_STEPS)
    torch.cuda.synchronize()
    m_counts = read_counts()
    mxs = msim.xs.cpu().numpy()
    print(f"NMPC on the CLI's MX-5 curvature artifacts (buckmore {MX5_WIDTH}, {wall:.2f} s to write, lap "
          f"{out['lap_time']:.3f} s, {float(mtrack.s_max):.1f} m): {ARTIFACT_STEPS} cycles f32, progress "
          f"{mxs[-1, 0]:.2f} m, applied violation {runner.applied_violation(mmodel, p, msim):.3e} (JAX "
          f"pairing; with the state each input was applied from "
          f"{runner.applied_violation(mmodel, p, msim, pairing='applied'):.3e}); launches {m_counts}")
    if counts != (0, 1, 0) or m_counts != (ARTIFACT_STEPS + 2, 0, ARTIFACT_STEPS):
        raise AssertionError(f"launches {counts} writing the artifacts, {m_counts} in the loop")
    if mxs.shape != (ARTIFACT_STEPS + 1, 8) or not np.all(np.isfinite(mxs)):
        raise AssertionError("NMPC states on the CLI's artifacts are not finite")
    if not np.all(np.diff(mxs[:, 0]) > 0):
        raise AssertionError("NMPC progress on the CLI's artifacts is not monotone")

    # ---------------------------------------------------------------- phase 9
    p9_solve, p9_k3, p9_out = phase_parallel(device, x0b_np, nl, best_x, best_f)

    # ---------------------------------------------------------------- phase 10
    p10_solve, p10_k3, p10_out, long_k3, p10_worst = phase_long_tracks(device, cfg, conf, x0b_np)
    worst_f32_abs = max(worst_f32_abs, p10_worst)

    # ---------------------------------------------------------------- phase 13
    # before phases 11-12, whose profiler sessions slow later launches
    p13_solve, p13_out = phase_long_horizons(device)

    # ---------------------------------------------------------------- phase 15
    # also before phases 11-12
    loops = [(f"single stream, {args.steps} cycles f32", (model, p, cfg, x0, sim), None),
             (f"fleet, {BATCH} x {batch_steps} cycles f32", (model, p, cfg, x0b, fleet), None),
             (f"{LONG_STEPS} cycles on the {LONG_NS}-sample table f32", p10_out["long_loop"], None),
             (f"accurate(), {ACCURATE_STEPS} cycles f32", p9_out["accurate_loop"], None),
             *((f"h20 lap, {LAP_CYCLES} cycles of closed_loop_chunked in chunks of {LAP_CHUNK} {name}",
                p13_out[f"lap_{name}"], LAP_CHUNK) for name in ("float64", "float32"))]
    phase_graphs(loops, (model, p, cfg, x0, x0b), args.steps, batch_steps)

    # ---------------------------------------------------------------- phase 11
    # Kernel 3's checks and timings come after every driven path, so that the
    # paths run in a fresh process: a profiler session leaves the process's
    # later launches slower (the NMPC loops read 11-20% lower on one card
    # when kernel 3's timings ran before them).
    n_dec = search_setup("cpu", torch.float64)[0].n_decongested
    alphas_np = np.random.default_rng(7).uniform(0.0, gs.ALPHA_HI, (K3_BATCH, n_dec))
    worst_k3_abs = 0.0
    k3_inputs = {}  # dtype -> (tbr18, s, k, s_max) of the 1024 lines, timed in phase 12
    for dtype in (torch.float64, torch.float32):
        track, tbr18, mx5 = search_setup(device, dtype)
        alphas = torch.as_tensor(alphas_np, dtype=dtype, device=device)
        with torch.no_grad():
            s_b, k_b, len_b = gs._geometry(track, alphas, spline.FIT_METHOD_CLOSED_BATCHED)
        s_n = s_b[:, :-1]
        n_samp = k_b.shape[1]
        dt = str(dtype)[6:]
        k3_inputs[dtype] = (tbr18, s_n, k_b, len_b)
        print(f"kernel 3 dynamic shared memory per block at N={n_samp} {dt}: "
              + ", ".join(f"W={W} {vb.smem_bytes(dtype, W, n_samp)} B" for W in range(1, vb.MAX_WARPS + 1)))
        for name, veh in (("tbr18", tbr18), ("MX5", mx5)):
            tag = f"kernel 3 vs twin {dt} {name}"
            tol = K3_TOL[dtype]
            errs = [check_velocity(f"{tag} closed B={K3_BATCH} N={n_samp}", veh, s_n, k_b, len_b, True, tol),
                    check_velocity(f"{tag} open B={K3_BATCH} N=300", veh, s_n[:, :300],
                                   k_b[:, :300].contiguous(), len_b, False, tol),
                    check_velocity(f"{tag} closed ragged B=160 N={n_samp}", veh, s_n[:160], k_b[:160],
                                   len_b[:160], True, tol)]
            s_w, k_w, len_w = sector_lines(track)
            errs.append(check_velocity(f"{tag} sector windows open B={k_w.shape[0]} N={k_w.shape[1]}",
                                       veh, s_w, k_w, len_w, False, tol))
            for n_hard, closed in ((n_samp, True), (300, False)):
                errs.append(check_velocity(f"{tag} hard rows {'closed' if closed else 'open'} B=8 N={n_hard}",
                                           veh, *hard_rows(s_n, k_b, len_b, n_hard), closed, tol))
            if dtype == torch.float32:
                worst_k3_abs = max(worst_k3_abs, *errs)
        if dtype == torch.float64:
            cpu_track, cpu_tbr18, _ = search_setup("cpu", dtype)
            got = gs._batch_lap_times(track, tbr18, alphas[:16], "fused").cpu()
            ref = gs._batch_lap_times(cpu_track, cpu_tbr18, alphas[:16].cpu(), "fused")
            rel = float(((got - ref).abs() / ref.abs()).max())
            print(f"f64 _batch_lap_times(solver='fused') of 16 candidates, card (kernel) vs CPU (twin): "
                  f"max |d|/|ref| = {rel:.3e} (tol {LAP_TOL_F64:g}); laps {ref.min():.4f}-{ref.max():.4f} s")
            if not rel <= LAP_TOL_F64:
                raise AssertionError("fused lap times on the card disagree with the CPU")

    # ---------------------------------------------------------------- phase 12
    kname = "velocity_profile_batch_kernel"
    n_sm = torch.cuda.get_device_properties(device).multi_processor_count
    k3_dev = {}
    for dtype, (veh, s_n, k_b, len_b) in k3_inputs.items():
        n_samp = k_b.shape[1]
        for B in K3_TIMED_BATCHES:
            for P in K3_SEGMENTS:
                k3_dev[dtype, B, P] = device_ms(
                    lambda: vb._launch(veh, s_n[:B], k_b[:B], len_b[:B], True, segments=P), 50, kname)
            print(f"kernel 3 device time per launch at B={B} N={n_samp} {str(dtype)[6:]} tbr18 closed "
                  f"(W={vb.warps_for(B, n_sm)}): "
                  + ", ".join(f"P={P} {k3_dev[dtype, B, P]:.4f} ms" for P in K3_SEGMENTS)
                  + f" (the wrapper takes P={vb.SEGMENTS})")
    veh, s_n, k_b, len_b = k3_inputs[torch.float32]
    by_w = {W: device_ms(lambda: vb._launch(veh, s_n, k_b, len_b, True, warps=W), 50, kname)
            for W in range(1, vb.MAX_WARPS + 1)}
    print(f"kernel 3 device time at B={K3_BATCH} f32 P={vb.SEGMENTS} by candidates per block: "
          + ", ".join(f"W={W} {t:.4f} ms" for W, t in by_w.items()))
    k3_ms = device_ms(lambda: vb.solve_profile_batch(veh, s_n, k_b, len_b, True), 50, kname)
    k3_call_ms = cuda_ms(lambda: vb.solve_profile_batch(veh, s_n, k_b, len_b, True), 200)
    k3_twin_ms = cuda_ms(lambda: vb.solve_profile_batch_reference(veh, s_n, k_b, len_b, True), 2)
    k3_bound = bound_ms(4 * (3 * K3_BATCH * n_samp + K3_BATCH), velocity_flops(K3_BATCH, n_samp, False))
    print(f"kernel 3 at B={K3_BATCH} N={n_samp} f32 tbr18 closed: kernel {k3_ms:.4f} ms (device time), "
          f"{k3_call_ms:.4f} ms per wrapper call (CUDA events, host included), twin {k3_twin_ms:.4f} ms, "
          f"bound {k3_bound[0] * 1e3:.3f} us ({k3_bound[1]})")
    # the global scratch at buckmore's size, and the long selections of
    # phase 10 (global scratch), beside the shared placement
    k3_global_ms = device_ms(lambda: vb._launch(veh, s_n, k_b, len_b, True, force_global=True), 50, kname)
    print(f"kernel 3 at B={K3_BATCH} N={n_samp} f32 tbr18 closed with its arrays forced into the global scratch: "
          f"{k3_global_ms:.4f} ms (device time; shared placement {k3_ms:.4f} ms)")
    for dtype, (veh_l, s_l, k_l, len_l) in long_k3.items():
        B_l, N_l = k_l.shape
        t_l = device_ms(lambda: vb._launch(veh_l, s_l, k_l, len_l, True), 10, kname)
        bound_l = bound_ms(nbytes(s_l, k_l, len_l, k_l), velocity_flops(B_l, N_l, False))
        print(f"kernel 3 device time per launch at B={B_l} N={N_l} {str(dtype)[6:]} tbr18 closed, global scratch "
              f"(W={vb.warps_for(B_l, n_sm)}, P={vb.SEGMENTS}): {t_l:.4f} ms; at N={n_samp} in shared memory "
              f"{k3_dev[dtype, K3_BATCH, vb.SEGMENTS]:.4f} ms; bound {bound_l[0] * 1e3:.3f} us ({bound_l[1]})")
    # the tail kernel by its device time at the main paths' shapes, beside
    # the plain tail's device time (what a graph of it replays) and its
    # time per call (CUDA events, phase 16)
    tail_ms = {}
    for label, ((t_model, t_p, t_cfg, t_x, t_res, t_pk, t_rows, t_bound), t_plain) in tail_timed.items():
        tail_ms[label] = device_ms(lambda: cycle_tail.tail(t_model, t_p, t_cfg, t_x, t_res, t_pk, t_rows), 200,
                                   "cycle_tail_kernel")
        plain_dev, plain_kernels = device_busy_ms(
            lambda: cycle_tail.tail_reference(t_model, t_p, t_cfg, t_x, t_res.us, t_res.lam), 20)
        print(f"tail kernel device time per launch at {label}: {tail_ms[label]:.5f} ms; plain tail "
              f"{plain_dev:.4f} device ms in {plain_kernels:.0f} kernels, {t_plain:.4f} ms per call (CUDA events); "
              f"bound {t_bound[0] * 1e6:.2f} ns ({t_bound[1]})")
    if args.profile:
        # the graphed loops (5 replays of G cycles), the eager loops for the
        # parent's reading (3 cycles), and one chunk of the graphed h20 lap
        G = runner.GRAPH_CYCLES
        for tag, cycles, steps in (("graphed", G, 5 * G), ("eager", 0, 3)):
            profile_cycles(lambda n: runner._loop(model, p, cfg, x0, n, cycles), f"closed_loop_{tag}",
                           "ilqr_solve_kernel", args.profile, steps)
            profile_cycles(lambda n: runner._loop(model, p, cfg, x0b, n, cycles), f"closed_loop_batch_{tag}",
                           "ilqr_solve_kernel", args.profile, steps)
        for dtype in (torch.float64, torch.float32):
            lap_model, lap_p, lap_cfg, lap_x0, _ = p13_out[f"lap_{str(dtype)[6:]}"]
            profile_cycles(lambda n: runner.closed_loop_chunked(lap_model, lap_p, lap_cfg, lap_x0, n, chunk=n),
                           f"h20_lap_chunk_{str(dtype)[6:]}", "ilqr_solve_kernel", args.profile, LAP_CHUNK)

    # ---------------------------------------------------------------- phase 14
    print(f"solve-kernel launches on the NMPC paths: single stream {launches}, fleet {batch_launches}, "
          f"phase 9 {p9_solve}, phase 10 {p10_solve}, phase 13 {p13_solve}; kernel-3 launches in phase 10 {p10_k3}")
    tail_launches = (p16_tail + tails + batch_tails + m_counts[2] + p9_out["tail_launches"]
                     + p10_out["tail_launches"] + p13_out["tail_launches"])
    main_tail = TIMED_TAILS[0]
    tail_bound = tail_timed[main_tail][0][-1]
    print(json.dumps({"kernels": [{
        "name": "ilqr_solve",
        "route": "cuda",
        "source": "lap_time_optimization_tpu_torch/csrc/ilqr.cu",
        "replaces": "lap_time_optimization_tpu/ops/pallas_ilqr.py:471 and "
                    "lap_time_optimization_tpu/ops/pallas_ilqr_batch.py:444",
        "launches": launches + batch_launches + p9_solve + p10_solve + p13_solve,
        "max_abs_err": worst_f32_abs,
        "ms": solve_ms[1, 1],  # the wrapper launches one warp at B=1
        "plain_ms": plain_ms[1],
        "bound_ms": bounds[1][0],
        "bound_by": bounds[1][1],
        "library_ms": None,
    }, {
        "name": "velocity_profile_batch",
        "route": "cuda",
        "source": "lap_time_optimization_tpu_torch/csrc/velocity.cu",
        "replaces": "lap_time_optimization_tpu/ops/pallas_velocity.py:229",
        "launches": nl_counts[1] + bo_counts[1] + again_counts[1] + race_k3 + p9_k3 + p10_k3,
        "max_abs_err": worst_k3_abs,
        "ms": k3_ms,
        "plain_ms": k3_twin_ms,
        "bound_ms": k3_bound[0],
        "bound_by": k3_bound[1],
        "library_ms": None,
    }, {
        "name": "cycle_tail",
        "route": "cuda",
        "source": "lap_time_optimization_tpu_torch/csrc/cycle_tail.cu",
        "replaces": "none: the tail of lap_time_optimization_tpu/mpc/runner.py:54 _step_fn and :284 "
                    "_step_fn_batch, fused by XLA",
        "launches": tail_launches,
        "max_abs_err": worst_tail_abs,
        "ms": tail_ms[main_tail],  # device time at the single stream's shape
        "plain_ms": tail_timed[main_tail][1],
        "bound_ms": tail_bound[0],
        "bound_by": tail_bound[1],
        "library_ms": None,
    }]}))
    print(f"card: {smi}")
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

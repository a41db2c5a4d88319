"""Racing-line CLI — port of `lap_time_optimization_tpu/cli/race.py`
(surface of reference src/__main__.py).

    python -m lap_time_optimization_tpu_torch <track> <vehicle> <width> --curvature

The same positionals (track JSON, vehicle JSON, usable track-width
fraction), mutually exclusive method flags, plot flags, `--output-dir`,
`--seed`, `--restarts`, `--config` and `--profile-dir`, the same results
block and the same artifact layout (<output-dir>/plots/<vehicle>/<track>/
<method>/ with path/left/right/widths/velocities JSON and config.json), so
runs diff against the JAX package's.

`--device` (default cuda) and `--dtype` (default float32) choose where and
in what precision the run goes; asking for cuda without a GPU is an error,
never a CPU run.  `--solver` picks the velocity profile of the lap times
(`optim/racing_line`): "scan" (default) or "fused", which scores laps on
kernel 3, the Results lap included, and differentiates on "assoc".
`--debug-nans` runs the method under `torch.autograd.detect_anomaly`.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import time

import numpy as np
import torch

from lap_time_optimization_tpu_torch.models import load_vehicle
from lap_time_optimization_tpu_torch.ops import spline, velocity_batch
from lap_time_optimization_tpu_torch.optim import global_search, racing_line
from lap_time_optimization_tpu_torch.track import Track
from lap_time_optimization_tpu_torch.utils import io, profiling
from lap_time_optimization_tpu_torch.utils.config import Config

METHOD_DIRS = {
    "curvature": "curvature",
    "compromise": "compromise",
    "laptime": "laptime",
    "sectors": "sectors",
    "estimated": "estimated",
    "bayes": "bayesian",
    "nonlinear": "nonlinear",
}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Racing line optimisation (PyTorch/CUDA)")
    p.add_argument("track", type=str, help="path to JSON containing track data")
    p.add_argument("vehicle", type=str, help="path to JSON containing vehicle data")
    p.add_argument("track_width", type=float,
                   help="fraction (0.01..1.0) of the track width the car may use")
    methods = p.add_argument_group("generation methods").add_mutually_exclusive_group(required=True)
    methods.add_argument("--curvature", action="store_const", dest="method", const="curvature",
                         help="minimise curvature")
    methods.add_argument("--compromise", action="store_const", dest="method", const="compromise",
                         help="minimise an optimal length-curvature compromise")
    methods.add_argument("--bayes", action="store_const", dest="method", const="bayes",
                         help="minimise time via bayesian optimisation")
    methods.add_argument("--nonlinear", action="store_const", dest="method", const="nonlinear",
                         help="minimise time via nonlinear optimisation")
    methods.add_argument("--laptime", action="store_const", dest="method", const="laptime",
                         help="directly minimise lap time")
    methods.add_argument("--sectors", action="store_const", dest="method", const="sectors",
                         help="optimise and merge sector paths")
    methods.add_argument("--estimated", action="store_const", dest="method", const="estimated",
                         help="minimise a pre-computed length-curvature compromise")
    p.add_argument("--plot-corners", action="store_true", dest="plot_corners")
    p.add_argument("--plot-path", action="store_true", dest="plot_path")
    p.add_argument("--plot-trajectory", action="store_true", dest="plot_trajectory")
    p.add_argument("--plot-all", action="store_true", dest="plot_all")
    p.add_argument("--plot-format", type=str, dest="ext", default="png")
    p.add_argument("--output-dir", type=str, default="./data",
                   help="base directory for plots + JSON artifacts")
    p.add_argument("--seed", type=int, default=0, help="seed of bayes/nonlinear")
    p.add_argument("--restarts", type=int, default=1,
                   help="bayes/nonlinear: run the whole search from this many seeds "
                        "(seed..seed+N-1) and keep the best line")
    p.add_argument("--config", type=str, default=None,
                   help="JSON config overriding the reference-default hyperparameters "
                        "(corner detection, epsilon search, bayes/nonlinear budgets); "
                        "the effective config is dumped into the artifact dir")
    p.add_argument("--debug-nans", action="store_true",
                   help="run under torch.autograd.detect_anomaly(check_nan=True)")
    p.add_argument("--profile-dir", type=str, default=None,
                   help="write a torch.profiler Chrome trace to this directory")
    p.add_argument("--device", type=str, default="cuda", help="torch device (cuda, cuda:1, cpu)")
    p.add_argument("--dtype", type=str, default="float32", choices=("float32", "float64"))
    p.add_argument("--solver", type=str, default="scan", choices=("scan", "fused"),
                   help="velocity profile of the lap times: the sequential scan, or "
                        "kernel 3 for forward scoring with gradients on 'assoc'")
    return p


def run(args) -> dict:
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device}: no CUDA device is available")
    anomaly = (torch.autograd.detect_anomaly(check_nan=True) if args.debug_nans
               else contextlib.nullcontext())
    with profiling.trace(args.profile_dir), anomaly:
        return _run_inner(args, device, getattr(torch, args.dtype))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _search(args, cfg, track, vehicle):
    """bayes/nonlinear over `--restarts` seeds; the best line by the scan oracle."""
    best = None
    for s_ in range(args.seed, args.seed + max(1, args.restarts)):
        if args.method == "bayes":
            b = cfg.bayes
            a_, _, info = global_search.bayesian(
                track, vehicle, seed=s_, n_init=b.n_init, n_local=b.n_local, n_uniform=b.n_uniform,
                max_rounds=b.max_rounds, sigma_window=b.sigma_window, sigma_tol=b.sigma_tol,
                min_samples=b.min_samples, polish_every=b.polish_every,
                polish_iters=b.polish_iters, solver=args.solver)
        else:
            nl = cfg.nonlinear
            a_, _ = global_search.nonlinear(track, vehicle, seed=s_, n_random=nl.n_random,
                                            n_refine=nl.n_refine, max_iter=nl.max_iter,
                                            solver=args.solver)
        t_ = float(global_search.evaluate_decongested(track, vehicle, a_)[0])
        if args.method == "bayes":
            print(f"  seed {s_}: {t_:.3f} s ({info['rounds']} rounds / {info['n_samples']} samples)")
        elif args.restarts > 1:
            print(f"  seed {s_}: {t_:.3f} s")
        if best is None or t_ < best[0]:
            best = (t_, a_)
    return best[1]


def _run_inner(args, device, dtype) -> dict:
    cfg = Config.load(args.config) if args.config else Config()
    track = Track.load(args.track, track_width=args.track_width).to(device, dtype)
    print(f"[ Imported {track.name} ]")
    vehicle = load_vehicle(args.vehicle).to(device, dtype)
    print(f"[ Imported {vehicle.name} ]")
    if device.type == "cuda" and args.solver == "fused":
        velocity_batch.build()  # compile the kernel before the clock starts

    t0 = time.time()
    decongested = args.method in ("bayes", "nonlinear")
    solver = args.solver
    if args.method == "curvature":
        print("[ Minimising curvature ]")
        alphas = racing_line.minimise_curvature(track).x
    elif args.method == "compromise":
        print("[ Minimising optimal compromise ]")
        c = cfg.compromise
        alphas, epsilon, _ = racing_line.minimise_optimal_compromise(
            track, vehicle, eps_min=c.eps_min, eps_max=c.eps_max, n_grid=c.n_grid,
            n_refine=c.n_refine, solver=solver)
        print(f"  epsilon = {epsilon:.4f}")
    elif args.method == "laptime":
        print("[ Minimising lap time ]")
        alphas = racing_line.minimise_lap_time(track, vehicle, solver=solver).x
    elif args.method == "sectors":
        print("[ Optimising sectors ]")
        c = cfg.corners
        alphas, eps_w, _ = racing_line.optimise_sectors(
            track, vehicle, k_min=c.k_min, proximity=c.proximity, length=c.length, solver=solver)
        for i, e in enumerate(eps_w):
            print(f"  Sector {i:d}: eps={float(e):.4f}")
    elif args.method == "estimated":
        print("[ Minimising pre-computed compromise ]")
        alphas, epsilon = racing_line.minimise_estimated_compromise(track, vehicle)
        print(f"  epsilon = {epsilon:.4f}")
    elif args.method in ("bayes", "nonlinear"):
        print(f"[ {'BAYES' if args.method == 'bayes' else 'NONLINEAR'} ]")
        alphas = _search(args, cfg, track, vehicle)
    else:  # pragma: no cover
        raise ValueError(f"unknown method {args.method}")

    print("[ Computing lap time ]")
    with torch.no_grad():
        if decongested:
            lap_time, length, v, s = global_search.evaluate_decongested(track, vehicle, alphas)
            controls = track.control_points_decongested(alphas)
        else:
            lap_time, length, v, s = racing_line.evaluate(track, vehicle, alphas, solver)
            controls = track.control_points(alphas)
        sp = spline.fit(controls, track.closed)
        positions = _host(spline.evaluate(sp, s))
    _sync(device)
    run_time = time.time() - t0

    lap_time = float(lap_time)
    length = float(length)
    v = _host(v)
    print()
    print("=== Results ==========================================================")
    print("Lap time = {:.3f}".format(lap_time))
    print("Run time = {:.3f}".format(run_time))
    print("Path Length = {:.3f}".format(length))
    print("Max velocity = {:.3f}".format(float(np.max(v))))
    print("Mean velocity = {:.3f}".format(float(np.mean(v))))
    print("======================================================================")
    print()

    # ---------------------------------------------------------------- artifacts
    plot_dir = io.artifact_dir(args.output_dir, vehicle.name, track.name, METHOD_DIRS[args.method])
    os.makedirs(plot_dir, exist_ok=True)
    old_left, old_right = _host(track.old_left), _host(track.old_right)

    if args.plot_corners or args.plot_all:
        from lap_time_optimization_tpu_torch.viz import plot as viz

        _, mask = racing_line.detect_track_corners(
            track, cfg.corners.k_min, cfg.corners.proximity, cfg.corners.length)
        mid = track.mid_spline()
        with torch.no_grad():
            mid_pos = _host(spline.evaluate(mid, spline.uniform_samples(mid.length, track.ns)))
        viz.plot_corners(os.path.join(plot_dir, f"corners.{args.ext}"), old_left, old_right,
                         mid_pos, mask)
    if args.plot_path or args.plot_all:
        from lap_time_optimization_tpu_torch.viz import plot as viz

        viz.plot_path(os.path.join(plot_dir, f"path.{args.ext}"), old_left, old_right, positions,
                      _host(sp.controls))
    if args.plot_trajectory or args.plot_all:
        from lap_time_optimization_tpu_torch.viz import plot as viz

        viz.plot_trajectory(os.path.join(plot_dir, f"trajectory.{args.ext}"), old_left, old_right,
                            positions, v)

    # effective config: reproducibility record for this artifact set
    with open(os.path.join(plot_dir, "config.json"), "w") as f:
        f.write(cfg.to_json())

    # always save the NMPC-stage inputs (reference src/__main__.py:199-213)
    io.save_path_json(plot_dir, positions[0], positions[1], "path")
    io.save_path_json(plot_dir, old_left[0], old_left[1], "left")
    io.save_path_json(plot_dir, old_right[0], old_right[1], "right")
    io.save_widths_json(plot_dir, _host(track.widths), "widths")
    io.save_velocities_json(plot_dir, v, "velocities")

    profiling.log_metrics(method=args.method, track=track.name, vehicle=vehicle.name,
                          lap_time_s=lap_time, run_time_s=round(run_time, 3), path_length_m=length)
    return dict(lap_time=lap_time, run_time=run_time, length=length,
                max_velocity=float(np.max(v)), mean_velocity=float(np.mean(v)),
                alphas=_host(alphas), artifact_dir=plot_dir)


def main(argv=None):
    return run(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()

"""Spline-basis comparison — port of `lap_time_optimization_tpu/cli/simplify.py`
(the finished version of the reference's `src/simplify.py`, whose
POLY/TRIG/HYP enum at src/simplify.py:12-16 is the spec).

    python -m lap_time_optimization_tpu_torch.cli.simplify <track> <vehicle> [width] --all

For the chosen basis (or all three with --all) this fits the centre line
(alphas = 0.5), samples it per metre, and reports the interpolation
residual, curvature energy Γ², arc length, the quasi-static lap time and the
evaluation throughput on the device.  `--device` (default cuda; no CPU
fallback) and `--dtype` (default float32) as in the port's other CLIs.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from lap_time_optimization_tpu_torch.models import load_vehicle
from lap_time_optimization_tpu_torch.ops import spline, spline_extra, velocity
from lap_time_optimization_tpu_torch.track import Track

BASES = ("poly", "trig", "hyp")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Track spline simplification method comparison")
    p.add_argument("track", type=str, help="path to JSON containing track data")
    p.add_argument("vehicle", type=str, help="path to JSON containing vehicle data")
    p.add_argument("track_width", nargs="?", type=float, default=1.0,
                   help="fraction of the track width to use (default 1.0)")
    basis = p.add_argument_group("spline").add_mutually_exclusive_group(required=True)
    basis.add_argument("--poly", action="store_const", dest="basis", const="poly",
                       help="polynomial (cubic) spline interpolation")
    basis.add_argument("--trig", action="store_const", dest="basis", const="trig",
                       help="trigonometric (Fourier) spline interpolation")
    basis.add_argument("--hyp", action="store_const", dest="basis", const="hyp",
                       help="hyperbolic (tension) spline interpolation")
    basis.add_argument("--all", action="store_const", dest="basis", const="all",
                       help="compare all three bases side by side")
    p.add_argument("--tension", type=float, default=0.5,
                   help="tension parameter tau for --hyp (per metre of chord)")
    p.add_argument("--plot-path", action="store_true", dest="plot_path",
                   help="plot the fitted centre line for each basis")
    p.add_argument("--plot-format", type=str, dest="ext", default="png")
    p.add_argument("--output-dir", type=str, default="./data", help="root directory for plots")
    p.add_argument("--device", type=str, default="cuda", help="torch device (cuda, cuda:1, cpu)")
    p.add_argument("--dtype", type=str, default="float32", choices=("float32", "float64"))
    return p


def _fit(basis: str, controls, closed: bool, tension: float):
    if basis == "poly":
        return spline.fit(controls, closed)
    if basis == "trig":
        return spline_extra.trig_fit(controls, closed)
    if basis == "hyp":
        return spline_extra.tension_fit(controls, closed, tension=tension)
    raise ValueError(f"unknown basis {basis}")


def _eval_fns(basis: str):
    if basis == "poly":
        return spline.evaluate, lambda sp, u: spline.curvature(sp, u, signed=False)
    ev = spline_extra.trig_evaluate if basis == "trig" else spline_extra.tension_evaluate
    return ev, lambda sp, u: spline_extra.curvature(sp, u, signed=False)


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@torch.no_grad()
def analyse_basis(basis: str, track: Track, vehicle, tension: float = 0.5) -> dict:
    """Fit the centre line with `basis` and compute the comparison metrics."""
    alphas = torch.full((track.size,), 0.5, dtype=track.left.dtype, device=track.left.device)
    controls = track.control_points(alphas)
    sp = _fit(basis, controls, track.closed, tension)
    ev, curv = _eval_fns(basis)

    u = spline.uniform_samples(sp.length, track.ns)
    # interpolation residual at the control sites (~roundoff): the trig
    # basis places its nodes uniformly in index, the piecewise bases at the
    # chord-length parameter values
    tk = sp.nodes if basis == "trig" else spline.chord_lengths(controls)
    resid = float(torch.max(torch.sqrt(torch.sum((ev(sp, tk, 0) - controls) ** 2, dim=0))))

    k = curv(sp, u[:-1])
    g2 = float(torch.sum(k * k))
    d1 = ev(sp, u, 1)
    speed = torch.sqrt(d1[0] ** 2 + d1[1] ** 2)
    length = float(torch.sum(0.5 * (speed[1:] + speed[:-1]) * torch.diff(u)))
    v = velocity.solve_profile(vehicle, u[:-1], k, sp.length, track.closed)
    lap = float(velocity.lap_time(u, v))

    # evaluation throughput on the device (position and two derivatives at
    # ns samples), after one warm-up
    bench = lambda: (ev(sp, u, 0), ev(sp, u, 1), ev(sp, u, 2))
    bench()
    device = u.device
    _sync(device)
    t0 = time.perf_counter()
    reps = 50
    for _ in range(reps):
        bench()
    _sync(device)
    evals_per_s = reps * track.ns / (time.perf_counter() - t0)

    return {
        "basis": basis,
        "spline": sp,
        "samples": ev(sp, u, 0).cpu().numpy(),
        "velocities": v.cpu().numpy(),
        "fit_residual_m": resid,
        "gamma2": g2,
        "path_length_m": length,
        "lap_time_s": lap,
        "eval_throughput_per_s": evals_per_s,
    }


def run(args) -> list[dict]:
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device}: no CUDA device is available")
    dtype = getattr(torch, args.dtype)
    track = Track.load(args.track, track_width=args.track_width).to(device, dtype)
    print(f"[ Imported {track.name} ]")
    vehicle = load_vehicle(args.vehicle).to(device, dtype)
    print(f"[ Imported {vehicle.name} ]")

    bases = BASES if args.basis == "all" else (args.basis,)
    results = []
    for basis in bases:
        print(f"[ Fitting {basis} spline ]")
        results.append(analyse_basis(basis, track, vehicle, tension=args.tension))

    print()
    print("=== Spline comparison ================================================")
    print(f"{'':>22s}" + "".join(f"{r['basis']:>14s}" for r in results))
    rows = [
        ("Fit residual (m)", "fit_residual_m", "{:14.2e}"),
        ("Gamma^2", "gamma2", "{:14.4f}"),
        ("Path length (m)", "path_length_m", "{:14.3f}"),
        ("Lap time (s)", "lap_time_s", "{:14.3f}"),
        ("Eval rate (pts/s)", "eval_throughput_per_s", "{:14.3e}"),
    ]
    for label, key, fmt in rows:
        print(f"{label:>22s}" + "".join(fmt.format(r[key]) for r in results))
    print("======================================================================")

    if args.plot_path:
        from lap_time_optimization_tpu_torch.viz import plot as plot_mod

        plot_dir = os.path.join(args.output_dir, "plots", vehicle.name, track.name, "simplify")
        os.makedirs(plot_dir, exist_ok=True)
        left, right = (np.asarray(t.cpu()) for t in (track.left, track.right))
        for r in results:
            dest = os.path.join(plot_dir, f"path_{r['basis']}.{args.ext}")
            plot_mod.plot_path(dest, left, right, r["samples"])
            print(f"[ Wrote {dest} ]")
    return results


def main(argv=None):
    return run(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()

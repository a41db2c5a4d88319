"""NMPC closed-loop CLI — port of `lap_time_optimization_tpu/cli/mpc.py`.

    python -m lap_time_optimization_tpu_torch.cli.mpc --curvature

Same method flags choosing which racing-line artifact set to track, same
`sim_results.json` output schema, same default 500 × 0.1 s simulation.
`--device` (default cuda) and `--dtype` (default float32) choose where and
in what precision the loop runs; asking for cuda on a host without a GPU is
an error, never a silent CPU run.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import numpy as np
import torch

from lap_time_optimization_tpu_torch.models import load_vehicle
from lap_time_optimization_tpu_torch.models.bicycle import BicycleModel
from lap_time_optimization_tpu_torch.models.vehicle import PacejkaVehicle
from lap_time_optimization_tpu_torch.mpc import runner
from lap_time_optimization_tpu_torch.mpc import track as mpc_track
from lap_time_optimization_tpu_torch.mpc.solver import OCPParams, SolverConfig
from lap_time_optimization_tpu_torch.ops import ilqr
from lap_time_optimization_tpu_torch.utils import io
from lap_time_optimization_tpu_torch.utils.config import Config


def build_parser():
    p = argparse.ArgumentParser(description="Closed-loop NMPC simulation (PyTorch/CUDA)")
    methods = p.add_argument_group("generation methods").add_mutually_exclusive_group(required=True)
    methods.add_argument("--curvature", action="store_const", dest="method", const="curvature")
    methods.add_argument("--compromise", action="store_const", dest="method", const="compromise")
    methods.add_argument("--laptime", action="store_const", dest="method", const="laptime")
    methods.add_argument("--bayes", action="store_const", dest="method", const="bayesian")
    p.add_argument("--vehicle", type=str, default="MX5", help="vehicle name/path (artifact dir uses its name)")
    p.add_argument("--track", type=str, default="buckmore")
    p.add_argument("--steps", type=int, default=None, help="simulation steps (reference src/mpc.py:125)")
    p.add_argument("--horizon", type=int, default=None, help="MPC horizon (reference src/mpc/controller.py:9)")
    p.add_argument("--dt", type=float, default=None)
    p.add_argument("--config", type=str, default=None,
                   help="JSON config overriding the reference-default MPC parameters "
                        "(horizon, dt, steps, weights, x0); explicit flags win over it")
    p.add_argument("--data-dir", type=str, default=None, help="artifact base dir (default: auto-discover)")
    p.add_argument("--output", type=str, default="sim_results.json")
    p.add_argument("--plot", action="store_true", help="write replay + internals plots")
    p.add_argument("--vref-scale", type=float, default=None,
                   help="fraction of the racing-line velocity profile to track "
                        "(the reference hardcodes 0.6, src/mpc/controller.py:53)")
    p.add_argument("--vref-preview", type=float, default=None, metavar="DECEL",
                   help="braking-curve preview budget [m/s^2] baked into the vref "
                        "table (mpc/track.with_brake_preview); 0 = off")
    p.add_argument("--device", type=str, default="cuda", help="torch device (cuda, cuda:1, cpu)")
    p.add_argument("--dtype", type=str, default="float32", choices=("float32", "float64"))
    return p


def effective_config(args):
    """Merge the MPC config layer: dataclass defaults < --config file < flags."""
    cfg = Config.load(args.config) if args.config else Config()
    m = cfg.mpc
    if args.steps is not None:
        m = dataclasses.replace(m, steps=args.steps)
    if args.horizon is not None:
        m = dataclasses.replace(m, horizon=args.horizon)
    if args.dt is not None:
        m = dataclasses.replace(m, dt=args.dt)
    if args.vref_scale is not None:
        m = dataclasses.replace(m, vref_scale=args.vref_scale)
    if args.vref_preview is not None:
        m = dataclasses.replace(m, vref_preview_decel=args.vref_preview)
    return dataclasses.replace(cfg, mpc=m)


def load_stack(args):
    """Build (track tables, vehicle) from the artifact set, in float64 on the CPU."""
    vehicle = load_vehicle(args.vehicle)
    if not isinstance(vehicle, PacejkaVehicle):
        raise ValueError(
            f"NMPC requires a Pacejka-parameterised vehicle (MX5-style JSON); "
            f"'{vehicle.name}' is a point-mass vehicle."
        )
    fallbacks = ("compromise",) if args.method == "laptime" else ()
    found, method = io.find_artifact_dir(
        vehicle.name, args.track, args.method, base=args.data_dir, method_fallbacks=fallbacks
    )
    track = mpc_track.load(vehicle.name, args.track, method, base_dir=found)
    return track, vehicle


def main(argv=None):
    args = build_parser().parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device}: no CUDA device is available")
    dtype = getattr(torch, args.dtype)
    print(f"[ Path method: {args.method} ]")
    track, vehicle = load_stack(args)
    print(f"[ Loaded artifacts: lap length {float(track.s_max):.1f} m, "
          f"{track.k_vals.shape[0]} table samples ]")

    conf = effective_config(args)
    mc = conf.mpc
    if mc.vref_preview_decel > 0.0:
        track = mpc_track.with_brake_preview(track, mc.vref_preview_decel, vref_scale=mc.vref_scale)
        print(f"[ vref brake preview: {mc.vref_preview_decel:.2f} m/s^2 budget ]")
    model = BicycleModel(vehicle=vehicle, track=track).to(device, dtype)
    p = OCPParams(**{
        **OCPParams.REFERENCE,
        "q_n": mc.q_n, "q_mu": mc.q_mu, "q_B": mc.q_B,
        "r_delta": mc.r_controls[0], "r_throttle": mc.r_controls[1],
        "vref_scale": mc.vref_scale, "lateral_margin": mc.lateral_margin,
    }).to(device, dtype)
    cfg = SolverConfig.for_horizon(mc.horizon, dt=mc.dt)
    x0 = torch.as_tensor(mc.x0, dtype=dtype, device=device)
    steps = mc.steps
    if device.type == "cuda":
        ilqr.build()  # compile the kernel before the clock starts

    print(f"[ Running {steps} steps, horizon {cfg.horizon}, dt {cfg.dt} on {device} ({args.dtype}) ]")
    t0 = time.perf_counter()
    result = runner.closed_loop(model, p, cfg, x0, steps)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0

    xs = result.xs.cpu().numpy()
    sdot = result.sdot.cpu().numpy()
    viol = result.violations.cpu().numpy()
    print()
    print("=== NMPC Results =====================================================")
    print(f"Simulated time     = {steps * mc.dt:.1f} s")
    print(f"Track progress     = {xs[-1, 0]:.1f} m of {float(track.s_max):.1f} m lap")
    print(f"Mean sdot          = {np.mean(sdot):.3f} m/s")
    print(f"Max |n| deviation  = {np.max(np.abs(xs[:, 1])):.3f} m")
    print(f"Max cons violation = {np.max(viol):.4f}")
    print(f"Wall               = {wall:.2f} s  → {steps / wall:.1f} solves/s")
    print("======================================================================")
    print()

    with open(args.output, "w") as f:
        json.dump(runner.to_sim_results(model, result), f)
    base, _ = os.path.splitext(args.output)
    with open(base + "_config.json", "w") as f:
        f.write(conf.to_json())
    print(f"[ Wrote {args.output} ]")

    if args.plot:
        from lap_time_optimization_tpu_torch.viz import visualiser

        visualiser.plot_replay(base + "_replay.png", track, args.output)
        visualiser.plot_internal(base + "_internals.png", track, args.output, dt=mc.dt)
        print(f"[ Wrote {base}_replay.png, {base}_internals.png ]")
    return result


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--steps 500] [--profile DIR]

Drives the port's main path, the single-stream closed-loop NMPC (MX5 on
buckmore, horizon 10, float32, 500 control cycles), through the same entry
points the CLI uses, after building the hand-written CUDA kernel from the
sources in this checkout and holding it against its plain PyTorch twin on
the card.  Phases:

1. versions, the card's name and power limit, TF32 off;
2. build `csrc/ilqr.cu` with nvcc;
3. kernel vs twin at the main path's shapes from a real linearisation, for
   14 and 16 constraint rows, float64 and float32, torque vectoring on;
   kernel and twin time per call;
4. a 5-cycle float64 closed loop on the card (kernel) against the same loop
   on the CPU (twin), then a short warm-up and the timed closed loop, whose
   kernel launches are counted;
5. the summary lines; the last one is {"ok": true, "device": {...}}.

Any failure raises, so the exit code is non-zero and no result line is
printed.  Without a CUDA device, or without the package beside it, the
script exits non-zero as well.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
F64_TOL, F32_TOL = 1e-10, 1e-4
# The predicted-horizon violation is gated < 0.02 over the first 25 cycles,
# the window tests/test_mpc.py gates for the JAX package.  Over a whole
# 500-cycle lap the predicted tails of the JAX package's own closed loop
# reach 0.08 in float32 (XLA path on the CPU), so the full run is gated on
# the applied states (< 1e-2, as bench.py) and its predicted maximum is
# printed.
PREDICTED_WINDOW = 25


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    )
    return out.stdout.strip().splitlines()[0]


def load_main_path(device, dtype, tv=False, te=False):
    from lap_time_optimization_tpu_torch.models import load_vehicle
    from lap_time_optimization_tpu_torch.models.bicycle import BicycleModel
    from lap_time_optimization_tpu_torch.mpc import track as mpc_track
    from lap_time_optimization_tpu_torch.mpc.solver import OCPParams

    track = mpc_track.load("MX-5", "buckmore", "curvature", base_dir=os.path.join(ROOT, "data"))
    model = BicycleModel(load_vehicle("MX5"), track, enable_torque_vectoring=tv,
                         enable_traction_ellipse=te).to(device, dtype)
    return model, OCPParams.reference(dtype, device, lateral_margin=0.05)


def kernel_inputs(model, p, cfg, s0, lam_scale, seed):
    """The kernel's arguments at one iterate of a solve from the reference
    state moved to arc length s0, with seeded steering and multipliers."""
    from lap_time_optimization_tpu_torch.mpc import runner
    from lap_time_optimization_tpu_torch.mpc import solver as S
    from lap_time_optimization_tpu_torch.ops import ilqr

    rng = np.random.default_rng(seed)
    dtype, device = model.track.k_vals.dtype, model.track.k_vals.device
    t = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype, device=device)
    x0 = runner.X0_REFERENCE.copy()
    x0[0] = s0
    z0 = t(np.concatenate([x0, np.zeros(2)]))
    us = t(np.stack([rng.normal(0.0, 0.3, cfg.horizon), np.full(cfg.horizon, 0.05)], axis=1))
    lams = t(rng.uniform(0.0, lam_scale, (cfg.horizon + 1, S.n_con(model))))
    zs = S._rollout(model, cfg, z0, us)
    rho, reg = t(cfg.rho_init), t(cfg.reg_init)
    A, B = S._linearize_joint(model, cfg, zs, us)
    quads = S._quads_gauss_newton(model, p, zs[:-1], us, lams[:-1], rho)
    Vz, Vzz = S._terminal_quads_gauss_newton(model, p, zs[-1], lams[-1], rho)
    c = lambda a: a.contiguous()
    return [c(A), c(B), *map(c, quads), c(Vz), c(Vzz), c(zs), c(us), c(lams),
            c(ilqr.tables_matrix(model)), ilqr.ladder(cfg.n_linesearch, dtype, device),
            ilqr.scal_vector(model, p, cfg, rho, reg)]


def max_err(got, ref):
    """max |got - ref| / max(1, |ref|) over the outputs (the gated measure:
    the arc length reaches 855 m and the cost hundreds, where one float32
    ulp is 6e-5), and the plain max |got - ref| of each output."""
    rel = max(float(((g - r).abs() / r.abs().clamp(min=1.0)).max()) for g, r in zip(got, ref))
    return rel, [float((g - r).abs().max()) for g, r in zip(got, ref)]


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


def profile_cycles(model, p, cfg, x0, out_dir, cycle_ms, steps=3):
    """torch.profiler over a short closed loop (presolve + `steps` cycles):
    device busy time and kernel count per solve, the iLQR kernel's share,
    and the busy share of `cycle_ms`, the unprofiled time per control cycle
    (the profiler's own host cost makes its wall clock useless for that)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from lap_time_optimization_tpu_torch.mpc import runner

    os.makedirs(out_dir, exist_ok=True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        runner.closed_loop(model, p, cfg, x0, steps)
        torch.cuda.synchronize()
    averages = prof.key_averages()
    device = [a for a in averages if a.device_type == DeviceType.CUDA]
    solves = steps + 2
    busy_ms = sum(a.self_device_time_total for a in device) / 1e3 / solves
    kernels = sum(a.count for a in device) / solves
    ilqr_ms = sum(a.self_device_time_total for a in device if "ilqr_kernel" in a.key) / 1e3 / solves
    table = averages.table(sort_by="self_device_time_total", row_limit=30)
    with open(os.path.join(out_dir, "closed_loop_profile.txt"), "w") as fh:
        fh.write(table)
    print(f"profile ({solves} solves): device busy {busy_ms:.2f} ms per solve "
          f"({100 * busy_ms / cycle_ms:.1f}% of the unprofiled {cycle_ms:.1f} ms per control "
          f"cycle), {kernels:.0f} device kernels per solve, iLQR kernel {ilqr_ms:.2f} ms "
          f"per solve ({100 * ilqr_ms / busy_ms:.1f}% of busy)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=500, help="timed closed-loop control cycles")
    ap.add_argument("--profile", type=str, default=None,
                    help="directory for a torch.profiler summary of 3 control cycles")
    args = ap.parse_args(argv)

    # ---------------------------------------------------------------- phase 1
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from lap_time_optimization_tpu_torch.mpc import runner
    from lap_time_optimization_tpu_torch.mpc.solver import SolverConfig
    from lap_time_optimization_tpu_torch.ops import ilqr

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
    print(f"build: {time.perf_counter() - t0:.2f} s")
    for line in ilqr.BUILD_LOG.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print(f"  nvcc: {line.strip()}")

    # ---------------------------------------------------------------- phase 3
    cfg = SolverConfig(horizon=10)
    worst_f32_abs = 0.0
    for dtype, tol in ((torch.float64, F64_TOL), (torch.float32, F32_TOL)):
        for tv, te in ((False, False), (False, True), (True, False)):
            model, p = load_main_path(device, dtype, tv, te)
            for s0, lam_scale, seed in ((0.0, 0.0, 0), (430.0, 2.0, 1), (855.0, 5.0, 2)):
                inp = kernel_inputs(model, p, cfg, s0, lam_scale, seed)
                got = ilqr.backward_forward(*inp, substeps=cfg.substeps)
                ref = ilqr.backward_forward_reference(*inp, substeps=cfg.substeps)
                torch.cuda.synchronize()
                rel, ab = max_err(got[:3], ref[:3])
                print(f"kernel vs twin {str(dtype)[6:]} n_con={inp[11].shape[1]} tv={tv} s0={s0}: "
                      f"max |d|/max(1,|ref|) = {rel:.3e} (tol {tol:g}); max |d| zs {ab[0]:.3e}, "
                      f"us {ab[1]:.3e}, cost {ab[2]:.3e} (|cost| {float(ref[2]):.1f}); "
                      f"ok {float(got[3]):.0f}/{float(ref[3]):.0f}")
                if not (rel <= tol and float(got[3]) == float(ref[3])):
                    raise AssertionError("kernel disagrees with its plain twin")
                if dtype == torch.float32:
                    worst_f32_abs = max(worst_f32_abs, *ab)

    model, p = load_main_path(device, torch.float32)
    inp = kernel_inputs(model, p, cfg, 0.0, 0.0, 0)
    kernel_ms = cuda_ms(lambda: ilqr.backward_forward(*inp, substeps=cfg.substeps), 200)
    twin_ms = cuda_ms(lambda: ilqr.backward_forward_reference(*inp, substeps=cfg.substeps), 20)
    print(f"per call at N=10 L=6 substeps=2 n=846 f32: kernel {kernel_ms:.4f} ms, twin {twin_ms:.4f} ms")

    # ---------------------------------------------------------------- phase 4
    x0_np = runner.X0_REFERENCE
    m64, p64 = load_main_path(device, torch.float64)
    ref_m, ref_p = load_main_path("cpu", torch.float64)
    got = runner.closed_loop(m64, p64, cfg, torch.as_tensor(x0_np, device=device), 5)
    ref = runner.closed_loop(ref_m, ref_p, cfg, torch.as_tensor(x0_np), 5)
    dev = float((got.xs.cpu() - ref.xs).abs().max())
    print(f"5-cycle f64 closed loop, card (kernel) vs CPU (twin): max |d xs| = {dev:.3e} (tol 1e-9)")
    if not dev <= 1e-9:
        raise AssertionError("closed loop on the card disagrees with the CPU reference")

    x0 = torch.as_tensor(x0_np, dtype=torch.float32, device=device)
    runner.closed_loop(model, p, cfg, x0, 3)  # warm-up: allocator, cuBLAS handles
    torch.cuda.synchronize()
    ilqr.LAUNCHES = 0
    t0 = time.perf_counter()
    sim = runner.closed_loop(model, p, cfg, x0, args.steps)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ilqr.LAUNCHES
    xs = sim.xs.cpu().numpy()
    applied = runner.applied_violation(model, p, sim)
    viols = sim.violations.cpu().numpy()
    predicted = float(viols[:PREDICTED_WINDOW].max())
    hz = args.steps / wall
    print(f"closed loop: {args.steps} steps f32 in {wall:.3f} s = {hz:.2f} Hz; "
          f"progress {xs[-1, 0]:.2f} m; applied violation {applied:.3e}; "
          f"predicted violation {predicted:.3e} over the first {PREDICTED_WINDOW} cycles, "
          f"{float(viols.max()):.3e} over all (step {int(viols.argmax())}); "
          f"kernel launches {launches} ({launches / (args.steps + 2):.1f} per control cycle)")
    expected = (args.steps + 2) * cfg.al_iters * cfg.ilqr_iters
    if launches != expected:
        raise AssertionError(f"{launches} kernel launches, expected {expected}")
    if xs.shape != (args.steps + 1, 8) or not np.all(np.isfinite(xs)):
        raise AssertionError("closed-loop states are not finite or of the wrong shape")
    if not np.all(np.diff(xs[:, 0]) > 0):
        raise AssertionError("track progress is not monotone")
    if not (applied < 1e-2 and predicted < 0.02):
        raise AssertionError("constraint violation above its gate")

    if args.profile:
        profile_cycles(model, p, cfg, x0, args.profile, 1e3 * wall / args.steps)

    # ---------------------------------------------------------------- phase 5
    print(json.dumps({"kernels": [{
        "name": "ilqr_backward_forward",
        "route": "cuda",
        "source": "lap_time_optimization_tpu_torch/csrc/ilqr.cu",
        "replaces": "lap_time_optimization_tpu/ops/pallas_ilqr.py:471",
        "launches": launches,
        "max_abs_err": worst_f32_abs,
        "ms": kernel_ms,
        "plain_ms": twin_ms,
    }]}))
    print(f"card: {smi}")
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Internal-parameter plots from a sim_results.json — port of
`lap_time_optimization_tpu/cli/show_results.py` (reference
src/show_results.py, which hardcodes MX-5/buckmore/curvature; here the
artifact set is selectable).

    python -m lap_time_optimization_tpu_torch.cli.show_results sim_results.json --method curvature
"""

from __future__ import annotations

import argparse


def build_parser():
    p = argparse.ArgumentParser(description="Plot NMPC internal parameters from sim results")
    p.add_argument("results", nargs="?", default="sim_results.json")
    p.add_argument("--vehicle", type=str, default="MX-5")
    p.add_argument("--track", type=str, default="buckmore")
    p.add_argument("--method", type=str, default="curvature",
                   choices=["curvature", "compromise", "laptime", "bayesian", "nonlinear"])
    p.add_argument("--data-dir", type=str, default=None)
    p.add_argument("--out", type=str, default="show_results.png")
    p.add_argument("--dt", type=float, default=0.1)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    from lap_time_optimization_tpu_torch.mpc import track as mpc_track
    from lap_time_optimization_tpu_torch.utils import io
    from lap_time_optimization_tpu_torch.viz import visualiser

    base, method = io.find_artifact_dir(args.vehicle, args.track, args.method, base=args.data_dir)
    track = mpc_track.load(args.vehicle, args.track, method, base_dir=base)
    visualiser.plot_internal(args.out, track, args.results, dt=args.dt)
    print(f"[ Wrote {args.out} ]")


if __name__ == "__main__":
    main()

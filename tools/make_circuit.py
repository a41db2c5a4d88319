#!/usr/bin/env python3
"""Make the seeded full-length circuit and its MX-5 racing-line artifacts.

    python3 tools/make_circuit.py [--device cuda] [--output-dir data]

Writes `data/tracks/circuit20832.json`: the cones of
`track.synthetic_circuit(20832, seed=0, lobes=36, width=10.0)`, a closed
circuit of the Nordschleife's published length (20,832 m) whose geometry
is seeded, not measured (a cone pair every ~10 m, a constant 10 m width).
Then runs the port's racing-line CLI on it with the MX-5, width 0.8 and
`--curvature` (kernel 3, `--solver fused`, float32), which writes
`<output-dir>/plots/MX-5/circuit20832/curvature/{path,left,right,widths,
velocities,config}.json`: the artifacts the NMPC configuration
`perfbench/configs/mx5_circuit20832_h10_f32.json` reads.  Prints one JSON
line: the cone pairs, the line's length, the number of velocity samples
(the NMPC table's length), the CLI's wall time and the device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

NAME, LENGTH, SEED, LOBES, WIDTH = "circuit20832", 20832, 0, 36, 10.0
#: The racing-line CLI's track width for the MX-5's NMPC artifacts.
CLI_WIDTH = 0.8


def write_track(path: str) -> int:
    """Write the circuit's cones as a track JSON; returns the cone pairs."""
    from chip_smoke import write_track_json
    from lap_time_optimization_tpu_torch.track import synthetic_circuit

    left, right = synthetic_circuit(LENGTH, seed=SEED, lobes=LOBES, width=WIDTH)
    write_track_json(path, NAME, left, right)
    return int(left.shape[1])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--output-dir", default=os.path.join(ROOT, "data"))
    args = ap.parse_args(argv)
    track = os.path.join(ROOT, "data", "tracks", f"{NAME}.json")
    pairs = write_track(track)
    cmd = [sys.executable, "-m", "lap_time_optimization_tpu_torch", track,
           os.path.join(ROOT, "data", "vehicles", "MX5.json"), str(CLI_WIDTH), "--curvature",
           "--device", args.device, "--dtype", "float32", "--solver", "fused", "--output-dir", args.output_dir]
    t0 = time.perf_counter()
    subprocess.run(cmd, check=True, cwd=ROOT)
    wall = time.perf_counter() - t0
    out = os.path.join(args.output_dir, "plots", "MX-5", NAME, "curvature")
    with open(os.path.join(out, "velocities.json")) as fh:
        samples = len(json.load(fh)["velocities"])
    with open(os.path.join(out, "path.json")) as fh:
        path = json.load(fh)["path"]
    xy = list(zip(path["x"], path["y"]))
    length = sum(((x1 - x0) ** 2 + (y1 - y0) ** 2) ** 0.5 for (x0, y0), (x1, y1) in zip(xy, xy[1:] + xy[:1]))
    device = args.device
    if device.startswith("cuda"):
        import torch

        device = torch.cuda.get_device_name(0)
    print(json.dumps({"track": os.path.relpath(track, ROOT), "artifacts": os.path.relpath(out, ROOT),
                      "cone_pairs": pairs, "line_polygon_m": length, "velocities": samples,
                      "cli_wall_s": wall, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The control of a cell's `correct`: the plain reference put in the
program's place, computed in the precision below the configuration's
(`control_precision`: TF32 products for float32, float32 for float64), and
judged by the same comparison as a run (`perfbench/check.py`).

    python3 perfbench/control.py --workload <cell> --seeds 1,2,3 --requests N

For each seed it makes the first N requests' initial states as a run with
that seed makes them, runs the reference's closed loop in the control's
precision over the (request, row) loops and the cycles a run's check would
follow, and prints one JSON line with the numbers, each beside the cell's
limit.  A fleet's loops are independent of one another, so the rows the
check does not follow are not computed.  Benchmark runs do not run it; it needs no
card.
"""

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402

from perfbench import check, traffic  # noqa: E402
from perfbench.reference import solver as ref_solver  # noqa: E402
from perfbench.run import Cell  # noqa: E402


def readings(cell: Cell, seed: int, requests: int, precision: str) -> dict:
    """The control's numbers: every number of the cell's kind, compared or
    not, over the cycles a run's check follows."""
    conf, tr = cell.config, cell.traffic
    cfg = check.reference_config(conf)
    half_width = 0.5 * float(conf["vehicle"]["width"])
    tables = model_tables(cell)
    starts = [traffic.initial_states(tr, conf["x0"], tables, half_width, seed, i) for i in range(requests)]
    sample = traffic.check_sample(tr, requests, seed)
    x0 = np.stack([starts[r][b] for r, b in sample])
    cycles = check.follow_cycles(cell.check, int(tr["cycles"]))
    loops = ref_solver.closed_loop(check.reference_model(conf, cell.root, precision), cfg, x0, cycles)
    ref = check.reference_model(conf, cell.root)
    du, dx = check.gaps(ref, cfg, loops["xs"], loops["us"], cycles)
    dp = check.plant_gaps(ref, cfg, loops["xs"], loops["us"], x0)
    wanted = check.FIRST + ("plant_max",) + (check.FOLLOWED if cycles > check.EARLY else ())
    return check.numbers(du, dx, dp, wanted)


def model_tables(cell: Cell):
    from perfbench.reference import track as ref_track

    art = cell.config["artifacts"]
    return ref_track.Tables.from_artifacts(
        os.path.join(cell.root, art["base_dir"], "plots", art["vehicle"], art["track"], art["method"]))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    ap.add_argument("--requests", type=int, required=True, help="requests a run of the cell makes")
    ap.add_argument("--precision", default=None, help="default: the configuration's control_precision")
    args = ap.parse_args(argv)
    cell = Cell(args.workload)
    precision = args.precision or cell.config["control_precision"]
    for seed in (int(s) for s in args.seeds.split(",")):
        found = readings(cell, seed, args.requests, precision)
        line = {"workload": cell.name, "seed": seed, "precision": precision, "requests": args.requests,
                "numbers": {k: {"value": v, "limit": cell.limits.get(k),
                                "fails": k in cell.limits and v > cell.limits[k]} for k, v in found.items()}}
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

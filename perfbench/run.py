"""The benchmark of the PyTorch and CUDA port: one cell, one run.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A cell of `BENCHMARK.json` names a configuration (its file, under
`perfbench/configs/`) and a traffic mix (`perfbench/traffic/<name>.json`);
its check's limits are in `perfbench/cells/<cell>.json`, and each
metric is read by `perfbench/metrics/<name>.py` (or the file of the name
cut at its last dot: `solve_kernel_ms.single` is read by
`solve_kernel_ms.py`).  So a configuration, a traffic mix, a cell or a
metric is added by files alone.

Set-up (imports, the CUDA context, the kernel library, the track tables,
the model, a warm-up request of the cell's B and dtype that captures the
CUDA graphs every request replays, and the traffic's `warm_up_requests`
whole requests) runs from the process's start to the first timed request.  The window then runs whole requests, one after
another, until `--seconds` have passed; it lasts from the first request's
start to the last one's end.  With `--trace 1` torch.profiler covers the
traffic's first `trace_requests` requests.  After the window the reference
follows the requests' loops on the host (`perfbench/check.py`).  The last
line of standard output is one JSON object; the numbers compared and their
limits are the last lines of standard error and the result's last key.
Without a CUDA device (or with fewer than the cell's chips) the run fails
and prints no result.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from perfbench import check, system, traffic  # noqa: E402
from perfbench.reference import track as ref_track  # noqa: E402

#: Top-level module names that no run may hold once its window has closed:
#: JAX and the JAX package the port was made from.
FORBIDDEN = ("jax", "jaxlib", "flax", "lap_time_optimization_tpu")


class RunError(RuntimeError):
    """A run that cannot give a result."""


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--chrome-trace", default=None,
                    help="write the traced requests' Chrome trace to this file (with --trace 1)")
    ap.add_argument("--dump", default=None,
                    help="save the checked loops and their per-cycle gaps to this .npz file")
    return ap.parse_args(argv)


def load_json(path):
    with open(path) as fh:
        return json.load(fh)


class Cell:
    """A cell of BENCHMARK.json with its configuration, traffic, limits and
    the metrics it reports (entries of BENCHMARK.json)."""

    def __init__(self, name: str, root: str = ROOT):
        bench = load_json(os.path.join(root, "BENCHMARK.json"))
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise RunError(f"no cell {name!r} in BENCHMARK.json")
        self.name, self.root = name, root
        self.entry = cells[name]
        config = {c["name"]: c for c in bench["configs"]}[self.entry["config"]]
        self.config = load_json(os.path.join(root, config["file"]))
        self.traffic = traffic.load(os.path.join(root, "perfbench", "traffic", f"{self.entry['traffic']}.json"))
        self.check = check.load_cell(os.path.join(root, "perfbench", "cells", f"{name}.json"))
        self.limits = self.check["limits"]
        self.end_to_end = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
        names = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in bench["per_layer"]
                          if (name in m["workloads"] if "workloads" in m else m["moves"] in names)]


def reader(name: str, root: str = ROOT):
    """The `read` function of the metric's file: `metrics/<name>.py`, or of
    the name cut at its last dot, and so on."""
    stem = name
    while True:
        path = os.path.join(root, "perfbench", "metrics", f"{stem}.py")
        if os.path.isfile(path):
            spec = importlib.util.spec_from_file_location(f"perfbench_metric_{stem.replace('.', '_')}", path)
            module = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(module)
            return module.read
        if "." not in stem:
            raise RunError(f"no reader for metric {name!r} under perfbench/metrics/")
        stem = stem.rsplit(".", 1)[0]


class Run:
    """What the readers read: the cell, the window's requests and times,
    the set-up time and, in a traced run, the trace's `Summary`."""

    def __init__(self, cell, walls, window_s, setup_s, summary, table_len):
        self.cell, self.walls, self.window_s = cell, walls, window_s
        self.setup_s, self.summary, self.table_len = setup_s, summary, table_len
        self.batch = int(cell.traffic["batch"])
        self.cycles = int(cell.traffic["cycles"])
        self.requests = len(walls)
        self.solver = cell.config["solver"]
        self.dtype = cell.config["dtype"]


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else "not read"
    except (OSError, subprocess.SubprocessError):
        return "not read"


def forbidden_modules():
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def window(request, seconds: float, n_traced: int = 0, prof=None, clock=time.perf_counter):
    """Whole requests, one after another, until `seconds` have passed since
    the first one's start (and at least `n_traced` of them, which `prof`
    profiles, each inside a `perfbench.request` span): (results, each
    request's wall seconds, the window's start, the window's length from the
    first start to the last end).  `request(i)` runs request i and returns
    once its results are on the host."""
    results, walls, start, end = [], [], None, None
    while True:
        i = len(results)
        if prof is not None and i == 0:
            prof.start()
        t0 = clock()
        start = t0 if start is None else start
        with torch.profiler.record_function("perfbench.request"):
            results.append(request(i))
        end = clock()
        if prof is not None and i == n_traced - 1:
            prof.stop()
        walls.append(end - t0)
        if end - start >= seconds and len(results) >= n_traced:
            return results, walls, start, end - start


def execute(args, device: str, root: str = ROOT, chips_check: bool = True):
    """One run; returns the result's dict and the lines for standard error."""
    cell = Cell(args.workload, root)
    if chips_check:
        need = int(cell.entry["chips"])
        if not torch.cuda.is_available() or torch.cuda.device_count() < need:
            raise RunError(f"cell {cell.name} needs {need} CUDA device(s); "
                           f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
                           f"device_count() {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
    cuda = device.startswith("cuda")
    art = cell.config["artifacts"]
    tables = ref_track.Tables.from_artifacts(
        os.path.join(root, art["base_dir"], "plots", art["vehicle"], art["track"], art["method"]))
    half_width = 0.5 * float(cell.config["vehicle"]["width"])
    states = lambda i: traffic.initial_states(cell.traffic, cell.config["x0"], tables, half_width, args.seed, i)
    cycles = int(cell.traffic["cycles"])
    sut = system.System(cell.config, root, device)
    sut.warm_up(states(0), cycles)
    for _ in range(int(cell.traffic.get("warm_up_requests", 0))):
        sut.request(states(0), cycles)
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    sync()

    prof = None
    n_traced = int(cell.traffic.get("trace_requests", 1)) if args.trace else 0
    if n_traced:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        prof = profile(activities=acts)
    results, walls, window_start, window_s = window(
        lambda i: sut.request(states(i), cycles), args.seconds, n_traced, prof)
    setup_s = window_start - T_START
    memory_peak = int(torch.cuda.max_memory_allocated()) if cuda else 0
    kind = torch.cuda.get_device_name(0) if cuda else "cpu"
    sut.close()

    summary = None
    if prof is not None:
        from perfbench import trace as trace_mod

        dev, host = trace_mod.read_events(prof)
        summary = trace_mod.Summary(dev, host, cycles)
        if args.chrome_trace:
            prof.export_chrome_trace(args.chrome_trace)
        del prof, dev, host

    err = [f"device: {kind}; nvidia-smi name, power limit: {power_limit() if cuda else 'no card'}",
           "request wall s: " + " ".join(f"{w:.6f}" for w in walls)]
    failed = sum(1 for r in results if not all(np.all(np.isfinite(a)) for a in r.values()))
    t_check = time.perf_counter()
    verdict = check.judge(cell.config, cell.traffic, cell.check, results, states, args.seed, root, dump=args.dump)
    t_check = time.perf_counter() - t_check
    err.append("applied violation of the true band, largest over each request's rows (m): "
               + " ".join(f"{a:.6g}" for a in verdict["applied"]))
    numbers = verdict["numbers"]
    correct = failed == 0 and all(numbers[k] <= limit for k, limit in cell.limits.items())

    run = Run(cell, walls, window_s, setup_s, summary, tables.k.shape[0])
    wanted = cell.per_layer if args.trace else cell.end_to_end
    metrics = {}
    for m in wanted:
        value = reader(m["name"], root)(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    device_info = {"platform": "gpu" if cuda else "cpu", "kind": kind,
                   "count": int(cell.entry["chips"]), "memory_peak_bytes": memory_peak}
    result = {"correct": bool(correct), "attempted": len(results), "failed": failed,
              "metrics": metrics, "device": device_info}
    if summary is not None:
        device_info["busy_s"] = summary.busy_s
        device_info["window_s"] = summary.window_s
        result["breakdown"] = {"device_ops": summary.device_ops, "idle_gaps": summary.idle_gaps}
    result["check"] = {k: {"value": numbers[k], "limit": limit} for k, limit in cell.limits.items()}
    err.append(f"checked {verdict['loops']} loops of {len(results)} requests against the reference "
               f"in {t_check:.1f} s; window {window_s:.3f} s, set-up {setup_s:.3f} s")
    err += [f"{k} {numbers[k]!r} limit {limit!r}" for k, limit in cell.limits.items()]
    return result, err


def main(argv=None) -> int:
    args = parse(argv)
    try:
        result, err = execute(args, "cuda")
    except RunError as exc:
        print(f"perfbench: {exc}", file=sys.stderr)
        return 1
    bad = forbidden_modules()
    if bad:
        print("perfbench: the run loaded " + ", ".join(bad), file=sys.stderr)
        return 1
    print("\n".join(err), file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())

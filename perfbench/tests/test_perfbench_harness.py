"""The benchmark harness on the CPU: generators, the window, the trace's
reduction, cells found by their files, what the runs import, the refusal
without a card, and `correct` coming out false on a broken program and on
the control.  The test marked `cuda` runs one short cell on the card."""

import json
import os
import shutil
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from perfbench import check, control, run, trace, traffic  # noqa: E402
from perfbench.reference import solver as ref_solver  # noqa: E402

CELLS = ("mx5_h10_f32.single", "mx5_h10_f32.fleet4096", "mx5_h20_f64.single")


def tables():
    return control.model_tables(run.Cell(CELLS[0]))


# ----------------------------------------------------------- traffic
@pytest.mark.parametrize("cell", CELLS)
def test_states_repeat_by_seed_and_differ_across_seeds(cell):
    c = run.Cell(cell)
    draw = lambda seed, i: traffic.initial_states(c.traffic, c.config["x0"], tables(), 1.15, seed, i)
    big = 2**31 + 12345
    np.testing.assert_array_equal(draw(big, 3), draw(big, 3))
    assert not np.array_equal(draw(big, 3), draw(big + 1, 3))
    assert not np.array_equal(draw(big, 3), draw(big, 4))
    x = draw(big, 0)
    assert x.shape == (int(c.traffic["batch"]), 8)
    lo, hi = c.traffic["draw"]["s"]
    assert np.all((x[:, 0] >= lo) & (x[:, 0] < hi))


def test_states_keep_the_footprint_in_the_band():
    t = tables()
    tr = {"batch": 256, "cycles": 1, "draw": {"s": [0.0, t.s_max], "n": "in_band", "band_clearance": 0.1}}
    x = traffic.initial_states(tr, [0, 0, 0, 5.0, 0, 0, 0, 0.1], t, 1.15, 7, 0)
    grid = np.linspace(0.0, t.s_max, t.k.shape[0])
    nl, nr = np.interp(x[:, 0], grid, t.nl), np.interp(x[:, 0], grid, t.nr)
    assert np.all(x[:, 1] + 1.25 <= nl + 1e-12) and np.all(-x[:, 1] + 1.25 <= nr + 1e-12)


def test_check_sample_repeats_by_seed():
    tr = {"batch": 4096, "check_rows": 32}
    a = traffic.check_sample(tr, 8, 99)
    assert a == traffic.check_sample(tr, 8, 99) and a != traffic.check_sample(tr, 8, 100)
    assert len(set(a)) == 32 and all(0 <= r < 8 and 0 <= b < 4096 for r, b in a)
    assert traffic.check_sample({"batch": 1, "check_rows": None}, 5, 1) == [(i, 0) for i in range(5)]


# ----------------------------------------------------------- the window
class Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


@pytest.mark.parametrize("seconds, expect", [(0.0, 1), (5.0, 3), (6.0, 3), (6.1, 4)])
def test_window_runs_whole_requests(seconds, expect):
    clock = Clock()

    def request(i):
        clock.t += 2.0 + 0.01 * i  # a request's own time
        return i

    results, walls, start, length = run.window(request, seconds, clock=clock)
    assert results == list(range(expect))
    assert walls == pytest.approx([2.0 + 0.01 * i for i in range(expect)])
    assert start == 100.0 and length == pytest.approx(sum(walls))


def test_window_takes_the_traced_requests_whole():
    clock = Clock()

    class Prof:
        calls = []

        def start(self):
            self.calls.append(("start", clock.t))

        def stop(self):
            self.calls.append(("stop", clock.t))

    def request(i):
        clock.t += 1.0
        return i

    p = Prof()
    results, _, _, _ = run.window(request, 0.5, n_traced=3, prof=p, clock=clock)
    assert len(results) == 3 and p.calls == [("start", 100.0), ("stop", 103.0)]


def fake_run(batch, cycles, walls, window_s, summary=None):
    cell = SimpleNamespace(traffic={"batch": batch, "cycles": cycles},
                           config={"solver": {"horizon": 10, "n_linesearch": 6, "substeps": 2, "al_iters": 2,
                                              "ilqr_iters": 5}, "dtype": "float32"})
    return run.Run(cell, walls, window_s, 7.5, summary, 846)


def test_rates_are_all_the_work_over_all_the_time():
    r = fake_run(1, 500, [1.8, 1.9, 1.7], 5.5)
    assert run.reader("nmpc_hz")(r) == pytest.approx(1500 / 5.5)
    assert run.reader("fleet_solves_per_s")(r) == pytest.approx(1500 / 5.5)
    assert run.reader("setup_s")(r) == 7.5
    f = fake_run(4096, 100, [1.3] * 8, 10.6)
    assert run.reader("fleet_solves_per_s")(f) == pytest.approx(8 * 4096 * 100 / 10.6)
    assert run.reader("nmpc_hz")(f) is None
    assert run.reader("solve_kernel_ms.single")(f) is None  # no trace: nothing to read


# ----------------------------------------------------------- the trace
def test_union_of_overlapping_and_nested_intervals():
    iv = [(0, 10), (2, 5), (8, 15), (20, 30), (22, 24), (40, 41)]
    assert trace.union_ns(iv, 0, 50) == 15 + 10 + 1
    assert trace.union_ns(iv, 5, 25) == 10 + 5
    assert trace.gaps_ns(iv, 0, 50) == [(15, 20), (30, 40), (41, 50)]
    assert trace.union_ns([], 0, 10) == 0 and trace.gaps_ns([], 0, 10) == [(0, 10)]


def test_summary_reads_kernels_busy_time_and_gaps():
    span = trace.REQUEST_SPAN
    host = [(span, 0, 1000), ("cudaGraphLaunch", 400, 700), ("cudaGraphLaunch", 1100, 1300),
            ("aten::copy_", 1150, 1200), (span, 2000, 2600)]
    dev = [("ilqr_solve_kernel<float>", 10, 300), ("elementwise", 300, 350), ("elementwise", 320, 340),
           ("ilqr_solve_kernel<float>", 2000, 2300), ("Memcpy DtoH", 2500, 2600), ("elementwise", 5000, 5100)]
    s = trace.Summary(dev, host, cycles_per_request=10)
    assert s.requests == 2 and s.cycles == 20 and s.window_s == pytest.approx(2600e-9)
    assert s.busy_s == pytest.approx((340 + 300 + 100) * 1e-9)
    assert s.kernel_stats("ilqr_solve_kernel") == (2, pytest.approx(590e-9))
    assert s.kernel_stats(exclude="ilqr_solve_kernel") == (2, pytest.approx(70e-9))
    assert s.copies["Memcpy DtoH"] == [1, pytest.approx(100e-9)]
    # the longest gap first, named by the innermost host operation at its middle
    assert s.idle_gaps == [["aten::copy_", pytest.approx(1650e-9)], ["host idle", pytest.approx(200e-9)],
                           ["host idle", pytest.approx(10e-9)]]
    r = fake_run(1, 10, [1e-6, 1e-6], 2.6e-6, s)
    assert run.reader("device_idle_pct.single")(r) == pytest.approx(100 * (1 - 740 / 2600))
    assert run.reader("kernels_per_cycle.single")(r) == pytest.approx(4 / 20)
    assert run.reader("tail_ms_per_cycle.single")(r) == pytest.approx(70e-6 / 20)
    assert run.reader("solve_kernel_ms.single")(r) == pytest.approx(295e-6)


# ----------------------------------------------------------- files alone
TINY = "mx5_h20_f64.tiny"


def tiny_checkout(tmp_path, batch=2, cycles=2, extra_metric=False, like=None):
    """A copy of the benchmark's files with one more configuration, traffic
    mix and cell (and, if asked, a metric), added as files alone; the
    program and its data are linked in.  The cell is a copy of the h20
    configuration with B = `batch`, or with `like`, a cell of BENCHMARK.json,
    a copy of that cell's configuration, traffic and check with `cycles`
    cycles a request."""
    root = tmp_path / "checkout"
    root.mkdir()
    shutil.copytree(os.path.join(ROOT, "perfbench"), root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for name in ("lap_time_optimization_tpu_torch", "data", "native"):
        os.symlink(os.path.join(ROOT, name), root / name)
    bench = json.loads(open(os.path.join(ROOT, "BENCHMARK.json")).read())
    if like is None:
        config, tr = "mx5_h20_f64", {"batch": batch, "draw": {"s": [560.0, 700.0], "vx": [4.0, 8.0], "n": "in_band",
                                                              "band_clearance": 0.1},
                                     "trace_requests": 1, "check_rows": None}
        cell_file = "mx5_h20_f64.single"
    else:
        entry = {w["name"]: w for w in bench["workloads"]}[like]
        config, cell_file = entry["config"], like
        tr = json.loads(open(os.path.join(ROOT, "perfbench", "traffic", f"{entry['traffic']}.json")).read())
    conf = json.loads(open(os.path.join(ROOT, "perfbench", "configs", f"{config}.json")).read())
    conf["name"] = f"{config}_copy"
    (root / "perfbench" / "configs" / f"{config}_copy.json").write_text(json.dumps(conf))
    tr.update(cycles=cycles, warm_up_requests=0)
    (root / "perfbench" / "traffic" / "tiny.json").write_text(json.dumps(tr))
    shutil.copy(os.path.join(ROOT, "perfbench", "cells", f"{cell_file}.json"), root / "perfbench" / "cells" / f"{TINY}.json")
    bench["configs"].append({"name": f"{config}_copy", "source": "test", "file": f"perfbench/configs/{config}_copy.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": TINY, "config": f"{config}_copy", "traffic": "tiny", "chips": 1, "why": "test"})
    for m in bench["end_to_end"]:
        if m["name"] == "fleet_solves_per_s":
            m["workloads"].append(TINY)
    if extra_metric:
        (root / "perfbench" / "metrics" / "requests_done.py").write_text(
            "def read(run):\n    return float(run.requests)\n")
        bench["end_to_end"].append({"name": "requests_done", "unit": "requests", "better": "higher", "bound": 0.01,
                                    "source": "host_clock", "workloads": [TINY]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return str(root)


def cpu_run(root, seed=2**31 + 5, trace_=0, extra=()):
    args = run.parse(["--workload", TINY, "--seed", str(seed), "--seconds", "0", "--trace", str(trace_), *extra])
    return run.execute(args, "cpu", root=root, chips_check=False)


def test_a_cell_config_traffic_and_metric_are_added_by_files_alone(tmp_path):
    root = tiny_checkout(tmp_path, extra_metric=True)
    cell = run.Cell(TINY, root)
    assert cell.traffic["cycles"] == 2 and cell.config["name"] == "mx5_h20_f64_copy"
    assert [m["name"] for m in cell.end_to_end] == ["fleet_solves_per_s", "setup_s", "requests_done"]
    dump, chrome = str(tmp_path / "loops.npz"), str(tmp_path / "trace.json")
    result, err = cpu_run(root)
    assert result["correct"], err
    assert result["metrics"]["requests_done"] == {"value": 1.0, "unit": "requests"}
    traced, err = cpu_run(root, trace_=1, extra=("--dump", dump, "--chrome-trace", chrome))
    assert traced["correct"] and traced["metrics"] == {}, err  # no per-layer metric has a device to read here
    assert np.load(dump)["du"].shape == (2, 2) and json.load(open(chrome))["traceEvents"]
    assert set(result["metrics"]) == {"fleet_solves_per_s", "setup_s", "requests_done"}
    assert list(result)[-1] == "check" and set(result["check"]) == set(cell.limits)


# ----------------------------------------------------------- imports
FORBIDDEN_PROBE = """
import sys
sys.path.insert(0, {root!r})
import perfbench.run, perfbench.check, perfbench.control, perfbench.trace, perfbench.counts
import perfbench.system
from lap_time_optimization_tpu_torch.models.bicycle import BicycleModel
from lap_time_optimization_tpu_torch.models.vehicle import PacejkaVehicle
from lap_time_optimization_tpu_torch.mpc import runner, track, solver
from lap_time_optimization_tpu_torch.ops import ilqr, _build
import glob, importlib.util, os
for path in glob.glob(os.path.join({root!r}, "perfbench", "metrics", "*.py")):
    perfbench.run.reader(os.path.basename(path)[:-3])
print(" ".join(sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax", "lap_time_optimization_tpu"))))
"""


def probe(code):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    return out.stdout.strip()


def test_the_harness_and_the_program_it_runs_import_no_jax():
    assert probe(FORBIDDEN_PROBE.format(root=ROOT)) == ""


def test_the_reference_imports_nothing_of_the_program():
    code = (f"import sys; sys.path.insert(0, {ROOT!r})\n"
            "import perfbench.reference.track, perfbench.reference.model, perfbench.reference.solver\n"
            "print(' '.join(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('lap_time_optimization_tpu_torch', 'lap_time_optimization_tpu', 'jax', 'torch'))))")
    assert probe(code) == ""


def test_a_run_without_a_card_fails_and_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    out = subprocess.run([sys.executable, os.path.join(ROOT, "perfbench", "run.py"), "--workload", CELLS[0],
                          "--seed", "1", "--seconds", "1", "--trace", "0"], capture_output=True, text=True,
                         cwd=ROOT, timeout=300)
    assert out.returncode != 0 and out.stdout == "" and "CUDA" in out.stderr


def test_a_run_beside_nothing_but_the_benchmark_fails_and_prints_no_result(tmp_path):
    shutil.copytree(os.path.join(ROOT, "perfbench"), tmp_path / "perfbench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path / "BENCHMARK.json")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "perfbench/run.py", "--workload", CELLS[0], "--seed", "1",
                          "--seconds", "1", "--trace", "0"], capture_output=True, text=True, cwd=tmp_path,
                         env=env, timeout=300)
    assert out.returncode != 0 and out.stdout == ""


# ----------------------------------------------------------- faults and the control
def plant_unchanged(runner, solver):
    orig = runner._step_fn

    def step(model, p, cfg, carry, pack=None):
        new, (x_next, u0, cost, viol, sdot) = orig(model, p, cfg, carry, pack)
        return (carry[0], *new[1:]), (carry[0].clone(), u0, cost, viol, sdot)
    return "_step_fn", step


def half_batch_left_out(runner, solver):
    orig = runner._solve

    def pick(x):
        fn = orig(x)
        if x.dim() == 1:
            return fn

        def half(model, p, cfg, z0, us, lam, pack=None):
            b = z0.shape[0] // 2
            top = fn(model, p, cfg, z0[:b].contiguous(), us[:b].contiguous(), lam[:b].contiguous(), pack)
            cat = lambda t, rest: torch.cat([t, rest], dim=0)
            zs_rest = torch.zeros_like(top.zs[:1]).expand((z0.shape[0] - b,) + top.zs.shape[1:])
            return solver.SolveResult(cat(top.us, us[b:]), cat(top.zs, zs_rest), cat(top.lam, lam[b:]),
                                      cat(top.cost, torch.zeros_like(top.cost[:1]).expand(z0.shape[0] - b)),
                                      cat(top.max_violation, torch.zeros_like(top.cost[:1]).expand(z0.shape[0] - b)))
        return half
    return "_solve", pick


def answer_altered(runner, solver):
    orig = runner._step_fn

    def step(model, p, cfg, carry, pack=None):
        new, (x_next, u0, cost, viol, sdot) = orig(model, p, cfg, carry, pack)
        return new, (x_next, u0 + 0.01, cost, viol, sdot)
    return "_step_fn", step


def warm_start_stale(runner, solver):
    orig = runner._step_fn

    def step(model, p, cfg, carry, pack=None):
        new, out = orig(model, p, cfg, carry, pack)
        return (new[0], carry[1], carry[2], new[3]), out  # the solve's warm start and multipliers not handed on
    return "_step_fn", step


def multipliers_dropped(runner, solver):
    orig = runner._step_fn

    def step(model, p, cfg, carry, pack=None):
        new, out = orig(model, p, cfg, carry, pack)
        return (new[0], new[1], torch.zeros_like(new[2]), new[3]), out
    return "_step_fn", step


def plant(monkeypatch, fault):
    from lap_time_optimization_tpu_torch.mpc import runner
    from lap_time_optimization_tpu_torch.mpc import solver

    if fault is not None:
        name, fn = fault(runner, solver)
        monkeypatch.setattr(runner, name, fn)


@pytest.mark.parametrize("fault", [None, plant_unchanged, half_batch_left_out, answer_altered, warm_start_stale,
                                   multipliers_dropped])
def test_correct_comes_out_false_on_a_broken_program(tmp_path, monkeypatch, fault):
    root = tiny_checkout(tmp_path, batch=4)
    plant(monkeypatch, fault)
    result, err = cpu_run(root, seed=11)
    assert result["correct"] is (fault is None), err


@pytest.mark.parametrize("fault", [None, plant_unchanged, half_batch_left_out, answer_altered, warm_start_stale])
def test_correct_comes_out_false_on_a_broken_fleet(tmp_path, monkeypatch, fault):
    """The fleet cell's traffic (B = 4096, its draw, its 64-loop sample),
    configuration (float32) and limits, the port run eagerly on the CPU
    over the `EARLY` cycles that its solver numbers read."""
    root = tiny_checkout(tmp_path, cycles=check.EARLY, like="mx5_h10_f32.fleet4096")
    plant(monkeypatch, fault)
    result, err = cpu_run(root, seed=2**31 + 17)
    assert result["correct"] is (fault is None), err


@pytest.mark.parametrize("cell, seed", [("mx5_h10_f32.fleet4096", 311), ("mx5_h20_f64.single", 321)])
def test_the_control_comes_out_incorrect(cell, seed):
    """The reference in the precision below the configuration's, in the
    program's place, for the first cycles of a run's loops (the early
    numbers read only those), fails one of the cell's limits."""
    c = run.Cell(cell)
    conf, tr = c.config, c.traffic
    cfg = check.reference_config(conf)
    starts = [traffic.initial_states(tr, conf["x0"], tables(), 1.15, seed, i) for i in range(2)]
    loops = [(r, b) for r, b in traffic.check_sample(tr, 2, seed)][:8]
    x0 = np.stack([starts[r][b] for r, b in loops])
    ctl = ref_solver.closed_loop(check.reference_model(conf, ROOT, conf["control_precision"]), cfg, x0, check.EARLY)
    ref = check.reference_model(conf, ROOT)
    du, dx = check.gaps(ref, cfg, ctl["xs"], ctl["us"], check.EARLY)
    found = check.numbers(du, dx, check.plant_gaps(ref, cfg, ctl["xs"], ctl["us"], x0), check.FIRST)
    assert any(found[k] > limit for k, limit in c.limits.items() if k in found), found


@pytest.mark.cuda
def test_one_short_run_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = subprocess.run([sys.executable, os.path.join(ROOT, "perfbench", "run.py"), "--workload", CELLS[1],
                          "--seed", "12345", "--seconds", "1", "--trace", "1"], capture_output=True, text=True,
                         cwd=ROOT, timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"
    assert 0 < result["device"]["busy_s"] <= result["device"]["window_s"]
    assert 0 < result["metrics"]["solve_roofline_pct.fleet"]["value"] < 100

"""The solve kernel's placements (`ops.ilqr.candidates`: every placement
the kernel takes at a launch's sizes, by name: the table in shared memory,
in global memory, or everything in the workspace), its placement rule
(`ops.ilqr.placement`: of the candidates that fit in shared memory, the one
whose blocks fill the card's SMs in the fewest waves at the launch's B, the
shared one where they tie) and its launches counted in the event counts of
`utils.profiling` ("ilqr.solve", and by placement "ilqr.solve.<name>"),
which a graph replay adds to without the runner naming them.

On the CPU (no JAX; a few seconds): the candidates and the rule as a
function of B, the OCPs per block, the SM count, each candidate's blocks
per SM and which candidates fit, with the kernel library's size and
occupancy queries replaced; each placement's name; a loop on the CPU
launches nothing, so no count moves; a replay adds what its graph recorded
to every count at once.

On the card (`cuda`): a B = 32 `closed_loop_batch` at h10 f32 counts its
solve launches by placement, all "global" on the benchmark's full-length
circuit (`mx5_circuit20832_h10_f32`: 20,831 samples, past the 13,468 that
a block's shared memory holds beside one OCP's slice) and all "shared" on
buckmore's 846 (`mx5_h10_f32`), as many as "ilqr.solve" moved, and the
device trace shows the same instantiation of `ilqr_solve_kernel` for each.
At the benchmark's B = 4096 on buckmore every solve launch is "global" (3
blocks of 4 OCPs per SM against the shared placement's 2: 3 waves against
4), with the bits of the same launches in the shared placement.
"""

import json
import os
import sys
import types
from collections import Counter

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from lap_time_optimization_tpu_torch.models.bicycle import BicycleModel  # noqa: E402
from lap_time_optimization_tpu_torch.models.vehicle import PacejkaVehicle  # noqa: E402
from lap_time_optimization_tpu_torch.mpc import runner  # noqa: E402
from lap_time_optimization_tpu_torch.mpc import track as mpc_track  # noqa: E402
from lap_time_optimization_tpu_torch.mpc.solver import OCPParams, SolverConfig  # noqa: E402
from lap_time_optimization_tpu_torch.ops import ilqr  # noqa: E402
from lap_time_optimization_tpu_torch.utils import profiling  # noqa: E402
from perfbench import trace, traffic  # noqa: E402
from perfbench.reference import track as ref_track  # noqa: E402

#: The longest (4, n) float32 table that fits a block's shared memory beside
#: one h10 OCP slice (csrc/ilqr.cu's solve_smem_bytes at W = 1, 6 rungs, 14
#: rows); past it the table stays in global memory.
SHARED_TABLE_MAX = 13468


def load(*parts):
    with open(os.path.join(ROOT, *parts)) as fh:
        return json.load(fh)


def model_of(conf, device="cpu", dtype=torch.float64):
    art = conf["artifacts"]
    track = mpc_track.load(art["vehicle"], art["track"], art["method"], base_dir=os.path.join(ROOT, art["base_dir"]))
    veh = PacejkaVehicle(name=conf["vehicle"]["name"], **{k: v for k, v in conf["vehicle"].items() if k != "name"})
    return (BicycleModel(veh, track).to(device, dtype), OCPParams(**conf["ocp"]).to(device, dtype),
            SolverConfig(**conf["solver"]))


def reference_tables(track):
    """The port's tables as the benchmark reference's `Tables` (for the
    traffic's start states)."""
    host = lambda t: t.detach().cpu().numpy().astype(np.float64)
    return ref_track.Tables(host(track.k_vals), host(track.nl_vals), host(track.nr_vals), host(track.vref_vals),
                            float(track.s_max))


@pytest.fixture
def counters(monkeypatch):
    """A fresh table of counts, so that a test neither reads nor leaves others'."""
    monkeypatch.setattr(profiling, "COUNTS", Counter())


SHARED, GLOBAL = ilqr.Placement(4, False, False), ilqr.Placement(4, True, False)


def fake_queries(monkeypatch, fits, blocks=(0, 0), workspace=True):
    """The kernel library's queries replaced: `fits` maps each placement in
    shared memory that holds an OCP to the most OCPs a block it holds,
    `blocks` gives the shared and global placements' blocks per SM on a
    card of 132 SMs, `workspace` whether an OCP's slice fits the kernel's
    indices.  Returns the placements `occupancy` is asked about."""
    queried = []

    def smem_bytes(dtype, w, N, L, n_con, n, global_table=False):
        return 1000 * w if w <= fits.get("global" if global_table else "shared", 0) else 0

    def occupancy(dtype, where, N, L, n_con, n, device=None):
        queried.append(where)
        return 132, blocks[where.global_table]

    monkeypatch.setattr(ilqr, "smem_bytes", smem_bytes)
    monkeypatch.setattr(ilqr, "workspace_elems", lambda w, N, L, n_con: 100 * w * workspace)
    monkeypatch.setattr(ilqr, "occupancy", occupancy)
    return queried


@pytest.mark.parametrize("B, fits, blocks, expected", [
    # buckmore h10 f32: 4 OCPs a block in either, 2 blocks per SM shared, 3 global
    (1, {"shared": 4, "global": 4}, (2, 3), (1, False, False)),
    (32, {"shared": 4, "global": 4}, (2, 3), SHARED),
    (4096, {"shared": 4, "global": 4}, (2, 3), GLOBAL),  # 1024 blocks: 4 waves against 3
    (2048, {"shared": 4, "global": 4}, (2, 3), SHARED),  # 512 blocks: 2 waves in each
    (8192, {"shared": 4, "global": 4}, (2, 3), GLOBAL),  # 2048 blocks: 8 waves against 6
    # 3 OCPs a block shared, 4 global (h20 f64): 11 or 8 blocks, one wave
    (32, {"shared": 3, "global": 4}, (2, 3), ilqr.Placement(3, False, False)),
    # a table past shared memory: global, whatever the waves
    (4096, {"global": 4}, (0, 3), GLOBAL),
    (1, {"global": 4}, (0, 3), ilqr.Placement(1, True, False)),
    # a slice past a block: the workspace
    (4096, {}, (0, 0), ilqr.Placement(4, True, True)),
])
def test_the_rule_picks_the_fewest_waves(monkeypatch, B, fits, blocks, expected):
    """`placement` at B OCPs with the library's queries replaced
    (`fake_queries`)."""
    queried = fake_queries(monkeypatch, fits, blocks)
    assert ilqr.placement(torch.float32, min(ilqr.WARPS, B), 10, 6, 14, 846, B=B) == expected
    assert bool(queried) == (len(fits) == 2)  # occupancy decides only between two that fit


@pytest.mark.parametrize("warps, fits, workspace, expected", [
    # what a launch of one OCP forced into global memory runs
    (1, {"shared": 4, "global": 4}, True,
     {"shared": (1, False, False), "global": (1, True, False), "workspace": (1, True, True)}),
    # what a launch forced into the workspace runs: there also where shared memory holds the launch
    (4, {"shared": 4, "global": 4}, True, {"shared": SHARED, "global": GLOBAL, "workspace": (4, True, True)}),
    (4, {"shared": 3, "global": 4}, True,
     {"shared": (3, False, False), "global": GLOBAL, "workspace": (4, True, True)}),
    (4, {"global": 2}, True, {"global": (2, True, False), "workspace": (4, True, True)}),
    # an OCP's slice past the kernel's indices: none
    (4, {}, False, {}),
])
def test_candidates_are_every_placement_that_fits(monkeypatch, warps, fits, workspace, expected):
    """`candidates` with the library's queries replaced (`fake_queries`):
    the shared and global placements at the most OCPs per block up to
    `warps` that fit, and the workspace wherever its indices fit; no
    occupancy is asked."""
    queried = fake_queries(monkeypatch, fits, workspace=workspace)
    assert ilqr.candidates(torch.float32, warps, 10, 6, 14, 846) == expected
    assert queried == []


@pytest.mark.parametrize("B, warps, sms, blocks, expected", [
    (1, 1, 132, 2, 1), (4096, 4, 132, 2, 4), (4096, 4, 132, 3, 3), (2048, 4, 132, 2, 2),
    (2048, 4, 132, 3, 2), (1056, 4, 132, 2, 1), (1057, 4, 132, 2, 2), (8192, 4, 132, 3, 6),
])
def test_waves(B, warps, sms, blocks, expected):
    assert ilqr.waves(B, warps, sms, blocks) == expected


@pytest.mark.parametrize("where, name", [
    (ilqr.Placement(4, False, False), "shared"),
    (ilqr.Placement(4, True, False), "global"),
    (ilqr.Placement(4, True, True), "workspace"),
])
def test_placement_names(monkeypatch, where, name):
    assert where.name == name
    fake_queries(monkeypatch, {"shared": 4, "global": 4})
    assert ilqr.candidates(torch.float32, 4, 10, 6, 14, 846)[name] == where


def test_a_loop_on_the_cpu_counts_no_launch(counters):
    model, p, cfg = model_of(load("perfbench", "configs", "mx5_h10_f32.json"))
    x0 = torch.as_tensor(runner.X0_REFERENCE, dtype=torch.float64).repeat(2, 1)
    res = runner.closed_loop_batch(model, p, cfg, x0, 2)
    assert bool(torch.isfinite(res.xs).all())
    assert profiling.counts() == Counter()


def test_a_replay_adds_its_graphs_launches_to_every_counter(counters):
    profiling.set_counts({"ilqr.solve": 2, "ilqr.solve.shared": 2, "cycle_tail.tail": 1})
    prog = runner._Program.__new__(runner._Program)
    prog.graph = types.SimpleNamespace(replay=lambda: None)
    prog.counts = Counter({"ilqr.solve": 10, "ilqr.solve.global": 10, "cycle_tail.tail": 10})
    prog.run()
    prog.run()
    assert profiling.counts() == {"ilqr.solve": 22, "ilqr.solve.shared": 2, "ilqr.solve.global": 20,
                                  "cycle_tail.tail": 21}


# ----------------------------------------------------------------- the card
def kernel_launches(prof) -> Counter:
    """Device launches of each solve-kernel instantiation in a profile, by
    its template arguments as the trace names them."""
    device, _ = trace.read_events(prof)
    return Counter(name.split("ilqr_solve_kernel<", 1)[1].split(">", 1)[0]
                   for name, _, _ in device if "ilqr_solve_kernel<" in name)


@pytest.mark.cuda
@pytest.mark.parametrize("config, traffic_mix, placement, instantiation", [
    ("mx5_circuit20832_h10_f32", "fleet4096_lap", "global", "float, true, false"),
    ("mx5_h10_f32", "fleet4096", "shared", "float, false, false"),
])
def test_cuda_fleet_counts_its_placement(config, traffic_mix, placement, instantiation):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    from torch.profiler import ProfilerActivity, profile

    conf = load("perfbench", "configs", f"{config}.json")
    model, p, cfg = model_of(conf, "cuda", torch.float32)
    n = model.track.k_vals.shape[0]
    assert (n > SHARED_TABLE_MAX) == (placement == "global")
    assert ilqr.smem_bytes(torch.float32, 1, 10, 6, 14, SHARED_TABLE_MAX) > 0
    assert ilqr.smem_bytes(torch.float32, 1, 10, 6, 14, SHARED_TABLE_MAX + 1) == 0
    tr = {**load("perfbench", "traffic", f"{traffic_mix}.json"), "batch": 32}
    x0 = traffic.initial_states(tr, conf["x0"], reference_tables(model.track), 0.5 * conf["vehicle"]["width"], 7, 0)
    x0 = torch.as_tensor(x0, dtype=torch.float32, device="cuda")
    runner.closed_loop_batch(model, p, cfg, x0, runner.GRAPH_CYCLES)  # captures the program
    torch.cuda.synchronize()
    before = profiling.counts()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        res = runner.closed_loop_batch(model, p, cfg, x0, 2 * runner.GRAPH_CYCLES)
        torch.cuda.synchronize()
    counted = profiling.counts() - before
    solves = counted["ilqr.solve"]
    print(f"n={n}: counted {dict(counted)}, in the trace {dict(kernel_launches(prof))}")
    assert bool(torch.isfinite(res.xs).all())
    assert solves == 2 * runner.GRAPH_CYCLES + 2  # the presolve's two, then one a cycle
    assert {k: v for k, v in counted.items() if k.startswith("ilqr.solve.")} == {f"ilqr.solve.{placement}": solves}
    assert kernel_launches(prof) == Counter({instantiation: solves})


@pytest.mark.cuda
def test_cuda_fleet_of_4096_moves_to_the_global_placement():
    """Buckmore h10 f32 at the benchmark's B = 4096: 1024 blocks run in 3
    waves at the global placement's 3 blocks per SM against 4 at the shared
    placement's 2, so every solve launch of the loop is "global" and is
    `<float, true, false>` in the trace; a launch gives the bits of the
    same launch in the shared placement."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    from torch.profiler import ProfilerActivity, profile

    conf = load("perfbench", "configs", "mx5_h10_f32.json")
    model, p, cfg = model_of(conf, "cuda", torch.float32)
    tr = load("perfbench", "traffic", "fleet4096.json")
    x0 = traffic.initial_states(tr, conf["x0"], reference_tables(model.track), 0.5 * conf["vehicle"]["width"], 7, 0)
    x0 = torch.as_tensor(x0, dtype=torch.float32, device="cuda")
    assert x0.shape[0] == 4096
    N, L, n = cfg.horizon, cfg.n_linesearch, model.track.k_vals.shape[0]
    shared = ilqr.Placement(ilqr.WARPS, False, False)
    assert ilqr.placement(torch.float32, ilqr.WARPS, N, L, 14, n) == shared  # B = 1
    assert ilqr.placement(torch.float32, ilqr.WARPS, N, L, 14, n, B=4096) == ilqr.Placement(ilqr.WARPS, True, False)
    print(f"blocks per SM: shared {ilqr.occupancy(torch.float32, shared, N, L, 14, n)}, global "
          f"{ilqr.occupancy(torch.float32, ilqr.Placement(ilqr.WARPS, True, False), N, L, 14, n)}")

    runner.closed_loop_batch(model, p, cfg, x0, runner.GRAPH_CYCLES)  # captures the program
    torch.cuda.synchronize()
    before = profiling.counts()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        res = runner.closed_loop_batch(model, p, cfg, x0, 2 * runner.GRAPH_CYCLES)
        torch.cuda.synchronize()
    counted = profiling.counts() - before
    solves = counted["ilqr.solve"]
    print(f"counted {dict(counted)}, in the trace {dict(kernel_launches(prof))}")
    assert bool(torch.isfinite(res.xs).all())
    assert solves == 2 * runner.GRAPH_CYCLES + 2
    assert {k: v for k, v in counted.items() if k.startswith("ilqr.solve.")} == {"ilqr.solve.global": solves}
    assert kernel_launches(prof) == Counter({"float, true, false": solves})

    pk = ilqr.pack(model, p, cfg)
    z0 = torch.cat([x0, torch.zeros(4096, 2, dtype=torch.float32, device="cuda")], dim=-1)
    gen = torch.Generator(device="cpu").manual_seed(3)
    us = (0.1 * torch.randn(4096, N, 2, generator=gen, dtype=torch.float32)).cuda()
    lam = (2.0 * torch.rand(4096, N + 1, 14, generator=gen, dtype=torch.float32)).cuda()
    before = profiling.counts()
    got = ilqr._launch(cfg, z0, us, lam, pk)
    assert profiling.counts() - before == {"ilqr.solve": 1, "ilqr.solve.global": 1}
    want = ilqr._launch(cfg, z0, us, lam, pk, where=shared)
    assert profiling.counts() - before == {"ilqr.solve": 2, "ilqr.solve.global": 1, "ilqr.solve.shared": 1}
    assert all(torch.equal(a, b) for a, b in zip(got, want))

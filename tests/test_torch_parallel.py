"""The port's `parallel/` package in one process, against the JAX package.

A 1-rank gloo process group (`parallel.distributed.initialize` on a local
port) carries the meshes; the multi-rank semantics are held on 4 gloo
ranks in tests/test_torch_distributed.py.

* `initialize` does nothing in a single process, and importing the package
  starts no process group; a CUDA mesh refuses a gloo group.
* `make_mesh` / `global_mesh` shapes and axis names.
* `mesh.batch_lap_times` against JAX's on the same alphas, float64, "scan"
  and "assoc": MX5 at rtol 1e-10; tbr18 at 1e-8, the repo's accepted
  deviation for tbr18 profiles (PyTorch's CPU float64 sqrt is not correctly
  rounded and XLA contracts FMAs; near the friction circle's saturation one
  ulp grows to ~1e-9 of a speed, 4.5e-10 of these laps).
* `search_step` on 1×1: elitism in slot 0, clipping to [0, 1], the best
  time the batch's minimum, reproducible under a seed; the kernel route on
  1×1 against "scan", and `evolutionary_search`'s device check and history.
* `sp_velocity.solve_profile_sp` on a 1-rank sp mesh against JAX
  `velocity.solve_profile`, rtol 1e-9 (24 sweeps, as tests/test_parallel.py).
* `closed_loop_fleet` and `nonlinear(mesh=...)` on 1×1 bit-equal to the
  unsharded calls; `scaling.measure` / `report` fields.
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from lap_time_optimization_tpu.ops import spline as jax_spline
from lap_time_optimization_tpu.ops import velocity as jax_velocity
from lap_time_optimization_tpu.parallel import mesh as jax_mesh
from lap_time_optimization_tpu_torch.models import load_vehicle
from lap_time_optimization_tpu_torch.parallel import distributed, scaling, sp_velocity
from lap_time_optimization_tpu_torch.parallel import mesh as pmesh
from lap_time_optimization_tpu_torch.track import Track

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAP_RTOL = {"MX5": 1e-10, "tbr18": 1e-8}


@pytest.fixture(scope="module")
def world():
    """A 1-rank gloo process group for the module's meshes."""
    distributed.initialize(distributed.local_init_method(), world_size=1, rank=0, device="cpu")
    yield pmesh.make_mesh(1, sp=1, device="cpu")
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def port_track():
    return Track.load(os.path.join(ROOT, "data", "tracks", "buckmore.json"), 0.8)


def _vehicles(name, request):
    return request.getfixturevalue(name.lower()), load_vehicle(name)


def test_initialize_is_a_noop_single_process():
    """In a fresh interpreter: importing the package starts no process
    group, `initialize()` with one process and no address does nothing, and
    a mesh then asks for a process group."""
    code = (
        "import torch.distributed as dist\n"
        "from lap_time_optimization_tpu_torch.parallel import distributed, mesh, scaling, sp_velocity\n"
        "assert not dist.is_initialized()\n"
        "distributed.initialize()\n"
        "assert not dist.is_initialized()\n"
        "assert distributed.backend_for('cuda') == 'nccl' and distributed.backend_for('cpu') == 'gloo'\n"
        "try:\n"
        "    distributed.global_mesh(device='cpu')\n"
        "except RuntimeError as e:\n"
        "    assert 'initialize' in str(e)\n"
        "else:\n"
        "    raise AssertionError('a mesh without a process group')\n"
        "print('ok')\n"
    )
    env = {k: v for k, v in os.environ.items() if k not in ("WORLD_SIZE", "RANK", "MASTER_ADDR")}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=120, env=env)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_mesh_shapes(world):
    for m in (pmesh.make_mesh(1, sp=2, device="cpu"), pmesh.make_mesh(device="cpu"),
              distributed.global_mesh(sp=2, device="cpu"), world):
        assert m.mesh_dim_names == ("dp", "sp") and tuple(m.shape) == (1, 1)
        assert m.device_type == "cpu" and distributed.axis(m, "dp")[1:] == (1, 0)
    with pytest.raises(RuntimeError, match="nccl"):
        pmesh.make_mesh(1, device="cuda")  # a CUDA mesh never runs on gloo


@pytest.mark.parametrize("solver", ["scan", "assoc"])
@pytest.mark.parametrize("name", ["MX5", "tbr18"])
def test_batch_lap_times_matches_jax(world, buckmore, port_track, name, solver, request):
    jv, tv = _vehicles(name, request)
    alphas = np.random.default_rng(0).uniform(0.2, 0.8, (16, buckmore.size))
    ref = np.asarray(jax_mesh.batch_lap_times(buckmore, jv, jnp.asarray(alphas), solver))
    got = pmesh.batch_lap_times(port_track, tv, torch.from_numpy(alphas), solver, world)
    np.testing.assert_allclose(got.numpy(), ref, rtol=LAP_RTOL[name])
    unsharded = pmesh.batch_lap_times(port_track, tv, torch.from_numpy(alphas), solver)
    assert torch.equal(got, unsharded)


def test_search_step_on_1x1(world, port_track):
    veh = load_vehicle("MX5")
    alphas = torch.from_numpy(np.random.default_rng(1).uniform(0.0, 1.0, (12, port_track.size)))
    times = pmesh.batch_lap_times(port_track, veh, alphas, "scan", world)

    def step(seed):
        gen = torch.Generator()
        gen.manual_seed(seed)
        return pmesh.search_step(port_track, veh, alphas, gen, 0.3, elite=4, mesh=world)

    new_batch, t_best, a_best = step(3)
    assert new_batch.shape == alphas.shape
    assert float(t_best) == float(times.min()) and torch.equal(a_best, alphas[torch.argmin(times)])
    assert torch.equal(new_batch[0], a_best)  # elitism
    assert float(new_batch.min()) >= 0.0 and float(new_batch.max()) <= 1.0
    assert bool(((new_batch == 0.0) | (new_batch == 1.0)).any())  # σ = 0.3 reaches the clip
    again = step(3)
    assert all(torch.equal(a, b) for a, b in zip(again, (new_batch, t_best, a_best)))
    assert not torch.equal(step(4)[0], new_batch)


def test_fused_route_and_evolutionary_search(world, port_track):
    from lap_time_optimization_tpu_torch.ops import velocity_batch

    veh = load_vehicle("tbr18")
    alphas = torch.from_numpy(np.random.default_rng(2).uniform(0.2, 0.8, (8, port_track.size)))
    launches = velocity_batch.LAUNCHES
    fused = pmesh.batch_lap_times(port_track, veh, alphas, "fused", world)
    scan = pmesh.batch_lap_times(port_track, veh, alphas, "scan", world)
    assert velocity_batch.LAUNCHES == launches  # the twin on the CPU
    np.testing.assert_allclose(fused.numpy(), scan.numpy(), rtol=1e-9)
    with pytest.raises(ValueError, match="lies on cpu"):
        pmesh.evolutionary_search(port_track, veh, batch=8, rounds=1)  # device="cuda" by default
    best, hist = pmesh.evolutionary_search(port_track, veh, mesh=world, batch=16, rounds=4,
                                           solver="fused")
    assert best.shape == (port_track.size,) and hist.shape == (4,)
    assert np.all(np.diff(hist) <= 0.0) and np.all(np.isfinite(hist))
    ref = pmesh.batch_lap_times(port_track, veh, best[None], "fused")
    assert float(ref[0]) == hist[-1]


@pytest.mark.parametrize("name", ["tbr18", "MX5"])
def test_solve_profile_sp_matches_jax(world, buckmore, name, request):
    jv, tv = _vehicles(name, request)
    sp = buckmore.mid_spline()
    s = np.linspace(0.0, float(sp.length), buckmore.ns)[:-1]
    k = np.array(jax_spline.curvature(sp, jnp.asarray(s), signed=False))
    ref = np.asarray(jax_velocity.solve_profile(jv, jnp.asarray(s), jnp.asarray(k), float(sp.length),
                                                closed=True))
    got = sp_velocity.solve_profile_sp(tv, torch.from_numpy(s), torch.from_numpy(k), float(sp.length),
                                       world, closed=True, sweeps=24)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-9)


def test_fleet_and_nonlinear_on_1x1_equal_unsharded(world, port_track):
    from lap_time_optimization_tpu_torch.mpc import runner
    from lap_time_optimization_tpu_torch.mpc import track as mpc_track
    from lap_time_optimization_tpu_torch.models.bicycle import BicycleModel
    from lap_time_optimization_tpu_torch.mpc.solver import OCPParams, SolverConfig
    from lap_time_optimization_tpu_torch.optim import global_search

    track = mpc_track.load("MX-5", "buckmore", "curvature", base_dir=os.path.join(ROOT, "data"))
    model = BicycleModel(load_vehicle("MX5"), track)
    p = OCPParams.reference(torch.float64, lateral_margin=0.05)
    cfg = SolverConfig(horizon=10, al_iters=1, ilqr_iters=2)
    x0 = torch.from_numpy(np.tile(runner.X0_REFERENCE, (2, 1)))
    x0[1, 0] = 100.0
    fleet = runner.closed_loop_fleet(model, p, cfg, x0, 2, world)
    batch = runner.closed_loop_batch(model, p, cfg, x0, 2)
    assert all(torch.equal(f, b) for f, b in zip(fleet, batch))

    veh = load_vehicle("tbr18")
    kw = dict(seed=0, n_random=16, n_refine=2, max_iter=3, solver="fused")
    x1, f1 = global_search.nonlinear(port_track, veh, **kw)
    x2, f2 = global_search.nonlinear(port_track, veh, mesh=world, **kw)
    assert torch.equal(x1, x2) and f1 == f2


def test_scaling_measure_and_report(world, port_track):
    results = scaling.measure(port_track, load_vehicle("MX5"), device_counts=(1, 2), batch_per_device=4,
                              rounds=1)
    assert set(results) == {1}  # a world of one rank
    r = results[1]
    assert set(r) == {"evals_per_s", "sec_per_round", "efficiency"}
    assert r["evals_per_s"] > 0 and r["sec_per_round"] > 0 and r["efficiency"] == pytest.approx(1.0)
    assert "efficiency" in scaling.report(results) and "100.00%" in scaling.report(results)

"""The port's `parallel/` package on 4 gloo ranks, against one process and JAX.

The test spawns 4 worker processes by running this file as a script (each
imports only torch, numpy and the port, with one thread, and is killed at
WORKER_TIMEOUT so that a hang fails instead of stalling).  The workers
join one gloo process group (`parallel.distributed.initialize`) and run
four legs; the parent computes the references meanwhile and compares:

* SP: `solve_profile_sp` on a 1×4 mesh (the sample axis over 4 sp ranks)
  against JAX `velocity.solve_profile`, closed (tbr18, MX5) and open (the
  first 400 samples), float64, rtol 1e-9, as tests/test_parallel.py.
* DPSP: `search_step_dp_sp` on 2×2 against the port's
  `search_step(solver="scan")` in one process with the same generator seed,
  B=16: time and elite within rtol 1e-9, the new batch within atol 1e-7
  (tests/test_parallel.py's gates); and its message when dp does not divide
  the batch.
* FLEET: `closed_loop_fleet` of 4 starts spread along the lap, 6 cycles,
  float64, on a 4×1 mesh (one loop per rank), against the port's
  `closed_loop_batch` (rtol 1e-12) and JAX's (atol 1e-7, as
  tests/test_torch_closed_loop_batch.py); a 3-car fleet (padded to 4)
  returns exactly its 3 rows, equal to the first 3 of the 4.
* DP: `nonlinear(mesh=4×1)` against the unsharded run at a small budget,
  rtol 1e-3 (JAX's gate for its sharded search); and `solver="fused"` of
  `mesh.batch_lap_times` refuses the 4-rank mesh.

Every rank returns the whole result of each leg; all four are compared.
"""

import argparse
import os
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4
WORKER_TIMEOUT = 240  # seconds, for all four workers together
FLEET_STEPS = 6
DP_SEARCH = dict(seed=0, n_random=32, n_refine=4, max_iter=10, solver="fused")


def _worker(rank: int, init: str, io_dir: str) -> None:
    """One rank: join the group, run the legs, write rank<r>.npz."""
    import torch.distributed as dist

    from lap_time_optimization_tpu_torch.models import load_vehicle
    from lap_time_optimization_tpu_torch.mpc import runner
    from lap_time_optimization_tpu_torch.mpc.solver import SolverConfig
    from lap_time_optimization_tpu_torch.optim import global_search
    from lap_time_optimization_tpu_torch.parallel import distributed, sp_velocity
    from lap_time_optimization_tpu_torch.parallel import mesh as pmesh
    from lap_time_optimization_tpu_torch.track import Track
    from lap_time_optimization_tpu_torch.utils import convert

    torch.set_num_threads(1)
    distributed.initialize(init, world_size=WORLD, rank=rank, device="cpu")
    inp = np.load(os.path.join(io_dir, "inputs.npz"))
    t = lambda name: torch.from_numpy(inp[name])
    out = {}
    track = Track.load(os.path.join(ROOT, "data", "tracks", "buckmore.json"), 0.8)
    veh = {name: load_vehicle(name) for name in ("tbr18", "MX5")}

    m_sp = pmesh.make_mesh(WORLD, sp=WORLD, device="cpu")
    s, k, s_max = t("s"), t("k"), float(inp["s_max"])
    for name, v in veh.items():
        out[f"sp_closed_{name}"] = sp_velocity.solve_profile_sp(v, s, k, s_max, m_sp, closed=True, sweeps=24)
    out["sp_open_tbr18"] = sp_velocity.solve_profile_sp(veh["tbr18"], s[:400], k[:400], s_max, m_sp,
                                                        closed=False, sweeps=24)

    m22 = pmesh.make_mesh(WORLD, sp=2, device="cpu")
    gen = torch.Generator()
    gen.manual_seed(5)
    out["dpsp_batch"], out["dpsp_time"], out["dpsp_elite"] = pmesh.search_step_dp_sp(
        track, veh["tbr18"], t("alphas"), gen, 0.1, m22)
    try:
        pmesh.search_step_dp_sp(track, veh["tbr18"], t("alphas")[:15], gen, 0.1, m22)
    except ValueError as e:
        out["dpsp_error"] = np.array(str(e))

    m41 = pmesh.make_mesh(WORLD, sp=1, device="cpu")
    fields = lambda prefix: {k[len(prefix):]: inp[k] for k in inp.files if k.startswith(prefix)}
    model = convert.model_from_numpy(fields("veh."), fields("trk."))
    p = convert.ocp_params_from_numpy(fields("ocp."))
    cfg = SolverConfig(horizon=10)
    for tag, x0 in (("fleet", t("x0")), ("fleet3", t("x0")[:3])):
        res = runner.closed_loop_fleet(model, p, cfg, x0, FLEET_STEPS, m41)
        out.update({f"{tag}_{name}": a for name, a in zip(res._fields, res)})
    try:
        pmesh.batch_lap_times(track, veh["tbr18"], t("alphas"), "fused", m41)
    except ValueError as e:
        out["fused_error"] = np.array(str(e))

    track99 = Track.load(os.path.join(ROOT, "data", "tracks", "buckmore.json"), 0.99)
    out["dp_x"], dp_f = global_search.nonlinear(track99, veh["tbr18"], mesh=m41, **DP_SEARCH)
    out["dp_f"] = np.array(dp_f)

    np.savez(os.path.join(io_dir, f"rank{rank}.npz"),
             **{k: (v.numpy() if isinstance(v, torch.Tensor) else v) for k, v in out.items()})
    dist.destroy_process_group()


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description="one rank of tests/test_torch_distributed.py")
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--init", required=True)
    ap.add_argument("--io", required=True)
    a = ap.parse_args()
    sys.path.insert(0, ROOT)
    _worker(a.rank, a.init, a.io)
    sys.exit(0)


# ------------------------------------------------------------------ parent
import subprocess  # noqa: E402

import pytest  # noqa: E402
from test_torch_closed_loop_batch import _pair  # noqa: E402
from test_torch_ilqr import _numpy_fields, base  # noqa: E402,F401  (fixture)


def _spawn(io_dir):
    from lap_time_optimization_tpu_torch.parallel.distributed import local_init_method

    init = local_init_method()
    env = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": ROOT}
    for key in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(key, None)
    logs = [open(os.path.join(io_dir, f"rank{r}.log"), "w") for r in range(WORLD)]
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--rank", str(r), "--init", init,
                               "--io", str(io_dir)], cwd=ROOT, env=env, stdout=logs[r],
                              stderr=subprocess.STDOUT) for r in range(WORLD)]
    return procs, logs


def _wait(procs, logs, io_dir, deadline):
    try:
        for proc in procs:
            proc.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for log in logs:
            log.close()
    if any(proc.returncode != 0 for proc in procs):
        tails = []
        for r in range(WORLD):
            with open(os.path.join(io_dir, f"rank{r}.log")) as fh:
                tails.append(fh.read()[-3000:])
        pytest.fail(f"worker exit codes {[proc.returncode for proc in procs]} (killed after "
                    f"{WORKER_TIMEOUT} s if still running):\n" + "\n---\n".join(tails))
    return [dict(np.load(os.path.join(io_dir, f"rank{r}.npz"))) for r in range(WORLD)]


@pytest.fixture(scope="module")
def legs(tmp_path_factory, buckmore, tbr18, mx5, base):  # noqa: F811
    """Spawn the ranks, compute the references while they run, and return
    (per-rank outputs, references)."""
    import jax.numpy as jnp

    from lap_time_optimization_tpu.mpc import runner as jax_runner
    from lap_time_optimization_tpu.mpc import solver as JS
    from lap_time_optimization_tpu.ops import spline as jax_spline
    from lap_time_optimization_tpu.ops import velocity as jax_velocity
    from lap_time_optimization_tpu_torch.models import load_vehicle
    from lap_time_optimization_tpu_torch.mpc import runner
    from lap_time_optimization_tpu_torch.mpc.solver import SolverConfig
    from lap_time_optimization_tpu_torch.optim import global_search
    from lap_time_optimization_tpu_torch.parallel import mesh as pmesh
    from lap_time_optimization_tpu_torch.track import Track

    io_dir = tmp_path_factory.mktemp("ranks")
    sp = buckmore.mid_spline()
    s = np.linspace(0.0, float(sp.length), buckmore.ns)[:-1]
    k = np.array(jax_spline.curvature(sp, jnp.asarray(s), signed=False))
    alphas = np.random.default_rng(5).uniform(0.0, 1.0, (16, buckmore.size))
    veh_j, track_j = base
    jm, jp, tm, tp = _pair(base, "float64")
    x0 = np.tile(jax_runner.X0_REFERENCE, (WORLD, 1))
    x0[:, 0] = np.arange(WORLD) * 200.0
    fields = {**{f"veh.{k_}": v for k_, v in _numpy_fields(veh_j).items()},
              **{f"trk.{k_}": v for k_, v in _numpy_fields(track_j).items() if v.dtype != object},
              **{f"ocp.{k_}": v for k_, v in _numpy_fields(jp).items()}}
    np.savez(io_dir / "inputs.npz", s=s, k=k, s_max=np.array(float(sp.length)), alphas=alphas, x0=x0,
             **fields)
    deadline = time.monotonic() + WORKER_TIMEOUT
    procs, logs = _spawn(io_dir)
    try:
        ref = {}
        for name, jv in (("tbr18", tbr18), ("MX5", mx5)):
            ref[f"sp_closed_{name}"] = np.asarray(jax_velocity.solve_profile(
                jv, jnp.asarray(s), jnp.asarray(k), float(sp.length), closed=True))
        ref["sp_open_tbr18"] = np.asarray(jax_velocity.solve_profile(
            tbr18, jnp.asarray(s[:400]), jnp.asarray(k[:400]), None, closed=False))
        track = Track.load(os.path.join(ROOT, "data", "tracks", "buckmore.json"), 0.8)
        gen = torch.Generator()
        gen.manual_seed(5)
        ref["dpsp"] = pmesh.search_step(track, load_vehicle("tbr18"), torch.from_numpy(alphas), gen, 0.1,
                                        solver="scan")
        ref["fleet_port"] = runner.closed_loop_batch(tm, tp, SolverConfig(horizon=10), torch.from_numpy(x0),
                                                     FLEET_STEPS)
        ref["fleet_jax"] = jax_runner.closed_loop_batch(jm, jp, JS.SolverConfig(horizon=10, backend="xla"),
                                                        jnp.asarray(x0), FLEET_STEPS)
        track99 = Track.load(os.path.join(ROOT, "data", "tracks", "buckmore.json"), 0.99)
        ref["dp"] = global_search.nonlinear(track99, load_vehicle("tbr18"), **DP_SEARCH)
    finally:
        outs = _wait(procs, logs, io_dir, deadline)
    return outs, ref


@pytest.mark.parametrize("key", ["sp_closed_tbr18", "sp_closed_MX5", "sp_open_tbr18"])
def test_sp_profile_matches_jax(legs, key):
    outs, ref = legs
    for out in outs:
        np.testing.assert_allclose(out[key], ref[key], rtol=1e-9)


def test_dp_sp_step_matches_one_process(legs):
    outs, ref = legs
    nb_ref, t_ref, a_ref = (x.numpy() for x in ref["dpsp"])
    for out in outs:
        np.testing.assert_allclose(out["dpsp_time"], t_ref, rtol=1e-9)
        np.testing.assert_allclose(out["dpsp_elite"], a_ref, rtol=1e-9)
        np.testing.assert_allclose(out["dpsp_batch"], nb_ref, atol=1e-7)
        assert str(out["dpsp_error"]) == "the dp axis 2 must divide the batch 15"


def test_fleet_matches_batch_and_jax(legs):
    outs, ref = legs
    port, jax_ref = ref["fleet_port"], ref["fleet_jax"]
    for out in outs:
        for name in port._fields:
            got = out[f"fleet_{name}"]
            assert got.shape == tuple(getattr(port, name).shape), name
            np.testing.assert_allclose(got, getattr(port, name).numpy(), rtol=1e-12, atol=1e-12, err_msg=name)
            assert out[f"fleet3_{name}"].shape[0] == 3
            np.testing.assert_allclose(out[f"fleet3_{name}"], got[:3], rtol=1e-12, atol=1e-12, err_msg=name)
        np.testing.assert_allclose(out["fleet_xs"], np.asarray(jax_ref.xs), rtol=0, atol=1e-7)
        np.testing.assert_allclose(out["fleet_us"], np.asarray(jax_ref.us), rtol=0, atol=1e-7)
        assert np.all(np.diff(out["fleet_xs"][:, :, 0], axis=1) > 0)


def test_sharded_nonlinear_matches_unsharded(legs):
    outs, ref = legs
    x_ref, f_ref = ref["dp"]
    for out in outs:
        np.testing.assert_allclose(float(out["dp_f"]), f_ref, rtol=1e-3)
        assert out["dp_x"].shape == tuple(x_ref.shape)
    assert all(np.array_equal(out["dp_x"], outs[0]["dp_x"]) for out in outs)


def test_fused_refuses_a_multi_rank_mesh(legs):
    outs, _ = legs
    for out in outs:
        assert "single-device production path" in str(out["fused_error"])
        assert "4-rank mesh" in str(out["fused_error"])

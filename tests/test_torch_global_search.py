"""Parity of the port's racing-line searches (`optim/global_search.py`) with the JAX package.

Same float64 numpy alphas on buckmore at width 0.8 through both.
Tolerances: lap times rtol 1e-8 and gradients atol 1e-7 (tbr18's friction
circle magnifies last-place rounding differences of the two libraries,
see tests/test_torch_velocity.py).  The refinement is held to JAX's for
two L-BFGS steps, alphas to 1e-4 and laps to rtol 1e-5: the lap-time
objective is jagged, and the ~1e-8 gradient differences grow ~30× per
step (2.4e-5 in alphas and 1.2e-6 in laps after two steps, measured).  The searches draw
their candidates from a `torch.Generator`, not `jax.random`, so the whole
searches are held to lap-time gates at tiny budgets, as tests/test_gp.py
gates the JAX package.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lap_time_optimization_tpu.ops import pallas_velocity, spline as jax_spline, velocity as jax_velocity
from lap_time_optimization_tpu.optim import global_search as jax_gs
from lap_time_optimization_tpu_torch.models import load_vehicle
from lap_time_optimization_tpu_torch.optim import global_search
from lap_time_optimization_tpu_torch.track import Track
from lap_time_optimization_tpu_torch.utils import checkpoint

REPO_DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "data")


@pytest.fixture(scope="module")
def port():
    return Track.load(os.path.join(REPO_DATA, "tracks", "buckmore.json"), 0.8), load_vehicle("tbr18")


@pytest.fixture(scope="module")
def alphas(buckmore):
    return np.random.default_rng(8).uniform(0.0, 0.99, (8, buckmore.n_decongested))


def _jax_fused(track, vehicle, a):
    """The JAX package's solver="pallas" route with the Pallas kernel in
    interpret mode (its `_batch_lap_times` compiles it for the TPU)."""
    def geometry(x):
        sp = jax_spline.fit(track.control_points_decongested(x), track.closed,
                            jax_spline.FIT_METHOD_CLOSED_BATCHED)
        s = jnp.linspace(0.0, sp.length, track.ns)
        return s, jax_spline.curvature(sp, s[:-1], signed=False), sp.length

    s, k, length = jax.vmap(geometry)(a)
    v = pallas_velocity.solve_profile_batch(vehicle, s[:, :-1], k, length, track.closed, interpret=True)
    t = jax.vmap(jax_velocity.lap_time)(s, v)
    return jnp.where(jnp.isnan(t), jnp.inf, t)


@pytest.mark.parametrize("solver", ["scan", "assoc", "fused"])
def test_batch_lap_times_match_jax(solver, alphas, buckmore, tbr18, port):
    a = jnp.asarray(alphas)
    ref = _jax_fused(buckmore, tbr18, a) if solver == "fused" else \
        jax_gs._batch_lap_times(buckmore, tbr18, a, solver)
    got = global_search._batch_lap_times(*port, torch.as_tensor(alphas), solver)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-8)
    assert np.all(np.isfinite(got.numpy())) and 35.0 < got.min() < got.max() < 60.0


@pytest.mark.parametrize("solver", ["scan", "assoc"])
def test_decongested_lap_time_value_and_gradient(solver, alphas, buckmore, tbr18, port):
    x = alphas[0]
    ref_f, ref_g = jax.value_and_grad(lambda a: jax_gs.decongested_lap_time(buckmore, tbr18, a, solver))(
        jnp.asarray(x))
    xt = torch.as_tensor(x).requires_grad_(True)
    f = global_search.decongested_lap_time(*port, xt, solver)
    f.backward()
    assert f.item() == pytest.approx(float(ref_f), rel=1e-8)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(ref_g), rtol=0, atol=1e-7)
    lap, length, v, s = global_search.evaluate_decongested(*port, torch.as_tensor(x))
    assert v.shape == (port[0].ns - 1,) and s.shape == (port[0].ns,) and float(s[-1]) == float(length)
    assert float(lap) == pytest.approx(float(jax_gs.evaluate_decongested_jit(buckmore, tbr18, jnp.asarray(x))[0]),
                                       rel=1e-8)


def test_refine_matches_jax_for_two_steps(alphas, buckmore, tbr18, port):
    seeds = alphas[:3]
    ref = jax_gs._refine_chunked(buckmore, tbr18, jnp.asarray(seeds), 2, "assoc", batched=True)
    got = global_search._refine(*port, torch.as_tensor(seeds), 2, "assoc")
    np.testing.assert_allclose(got.x.numpy(), np.asarray(ref.x), rtol=0, atol=1e-4)
    np.testing.assert_allclose(got.fun.numpy(), np.asarray(ref.fun), rtol=1e-5)
    np.testing.assert_array_equal(got.n_iter.numpy(), np.asarray(ref.n_iter))
    assert np.all(got.fun.numpy() < global_search._batch_lap_times(*port, torch.as_tensor(seeds), "assoc").numpy())


def test_gp_targets_replace_nonfinite():
    y = torch.tensor([40.0, torch.inf, 37.0, torch.nan, 99.0], dtype=torch.float64)
    mask = torch.tensor([True, True, True, True, False])
    np.testing.assert_allclose(global_search._gp_targets(y, mask).numpy(), [40.0, 40.0, 37.0, 40.0, 0.0])
    y = torch.tensor([torch.inf, torch.nan, torch.inf, 50.0], dtype=torch.float64)
    mask = torch.tensor([True, True, True, False])
    np.testing.assert_allclose(global_search._gp_targets(y, mask).numpy(), [0.0, 0.0, 0.0, 0.0])


def test_nan_candidates_lose_every_argmin(alphas, port):
    """A NaN lap becomes +inf and loses the selection, the round's best and
    the incumbent choice."""
    a = torch.as_tensor(alphas[:4]).clone()
    a[0, 0] = torch.nan
    for solver in ("assoc", "fused"):
        t = global_search._batch_lap_times(*port, a, solver)
        assert torch.isinf(t[0]) and torch.all(torch.isfinite(t[1:]))
    times, order, seeds = global_search._nonlinear_select(*port, a, 2, "fused")
    assert int(order[-1]) == 0 and not torch.isnan(seeds).any()
    j, w, t_star = global_search._best_candidate(a, times)
    assert int(j) != 0 and torch.isfinite(t_star)
    _, incumbent = global_search._round_pre(a, times, 4)
    assert not torch.isnan(incumbent).any()


def test_nonlinear_small_budget(port):
    best_x, best_f = global_search.nonlinear(*port, seed=0, n_random=32, n_refine=2, max_iter=4,
                                             solver="fused")
    assert best_x.shape == (port[0].n_decongested,)
    assert np.isfinite(best_f) and best_f < 42.0
    lap = float(global_search.evaluate_decongested(*port, best_x)[0])
    assert lap == pytest.approx(best_f, rel=1e-2)


def test_bayesian_small_budget_converges(port, tmp_path):
    """The σ stop rule and the heartbeat at tiny budgets (as
    tests/test_gp.py::test_bayesian_small_budget_converges)."""
    hb = str(tmp_path / "bo_heartbeat.json")
    best_x, best_f, info = global_search.bayesian(
        *port, seed=0, n_init=6, n_local=8, n_uniform=8, max_rounds=4, min_samples=5,
        sigma_window=3, polish_every=2, polish_iters=6, n_polish_starts=2, heartbeat_path=hb,
        solver="fused")
    assert best_f < 42.0
    assert info["rounds"] <= 4 and len(info["sigma_history"]) == info["rounds"]
    assert info["timings"]["polish_calls"] >= 1
    beat = json.load(open(hb))["heartbeat"]
    assert beat["round"] == info["rounds"] and beat["best"] <= 42.0


def test_bayesian_checkpoint_resume(port, tmp_path):
    """Two rounds, then a resume to four: the resumed run continues from the
    saved dataset and generator state and ends as the uninterrupted run."""
    kw = dict(seed=0, n_init=4, n_local=4, n_uniform=4, min_samples=100, sigma_window=3,
              polish_every=0, solver="fused")
    ck = str(tmp_path / "bo.npz")
    _, _, info1 = global_search.bayesian(*port, max_rounds=2, checkpoint_path=ck, **kw)
    assert checkpoint.exists(ck) and int(checkpoint.load(ck)["round"]) == 2
    x2, f2, info2 = global_search.bayesian(*port, max_rounds=4, checkpoint_path=ck, **kw)
    x3, f3, info3 = global_search.bayesian(*port, max_rounds=4, **kw)
    assert info2["n_samples"] == info3["n_samples"] == info1["n_samples"] + 2
    assert f2 == f3 and torch.equal(x2, x3)
    assert len(info2["sigma_history"]) == len(info3["sigma_history"]) == 4

"""The port's racing-line methods (`optim/racing_line.py`) against the JAX
package's, in float64 on the CPU.

Track: the 25-cone ring of tests/test_cli.py (width 0.8), plus buckmore
where it is cheap (the sector windows).  Tolerances: optimised alphas
within 1e-6 (the zoom L-BFGS is held to optax's iterates at 1e-10 per step
in tests/test_torch_optimize_zoom.py; over hundreds of iterations the
last-place differences of the two packages' gradients grow), lap times
within 1e-8 relative (tbr18's friction circle turns one ulp of a sqrt into
~1e-9, tests/test_torch_velocity.py).  `solver="fused"` (kernel 3's plain
twin on the CPU) scores within 1e-10 relative of "scan".  The full-budget
buckmore gates of the published laps are `slow`.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lap_time_optimization_tpu.models import load_vehicle as jax_load_vehicle
from lap_time_optimization_tpu.optim import racing_line as jax_rl
from lap_time_optimization_tpu.track import Track as JaxTrack
from lap_time_optimization_tpu_torch.models import load_vehicle
from lap_time_optimization_tpu_torch.ops import velocity_batch
from lap_time_optimization_tpu_torch.optim import racing_line
from lap_time_optimization_tpu_torch.track import Track

REPO_DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "data")
ALPHA_TOL, LAP_RTOL, FUSED_RTOL = 1e-6, 1e-8, 1e-10
ALPHA_TOL_FLAT = 1e-5  # the curvature line, whose optimum is flat (see its test)
# published laps (reference README, as tests/test_racing_line.py:18-23)
REF_CURVATURE_LAP_TBR18 = 39.934
REF_COMPROMISE_LAP_TBR18 = 37.810
REF_LAPTIME_LAP_TBR18 = 40.892


def ring_json(directory) -> str:
    """tests/test_cli.py's small synthetic closed track."""
    th = np.linspace(0, 2 * np.pi, 25)
    r_mid = 30.0 + 6.0 * np.sin(3 * th)
    data = {"name": "tinyring",
            "left": {"x": ((r_mid - 2.5) * np.cos(th)).tolist(), "y": ((r_mid - 2.5) * np.sin(th)).tolist()},
            "right": {"x": ((r_mid + 2.5) * np.cos(th)).tolist(), "y": ((r_mid + 2.5) * np.sin(th)).tolist()}}
    for side in ("left", "right"):
        data[side]["x"][-1] = data[side]["x"][0]
        data[side]["y"][-1] = data[side]["y"][0]
    path = os.path.join(str(directory), "tinyring.json")
    with open(path, "w") as fh:
        json.dump(data, fh)
    return path


@pytest.fixture(scope="module")
def ring(tmp_path_factory):
    path = ring_json(tmp_path_factory.mktemp("tracks"))
    return JaxTrack.load(path, 0.8), Track.load(path, 0.8)


@pytest.fixture(scope="module")
def tbr18_pair():
    path = os.path.join(REPO_DATA, "vehicles", "tbr18.json")
    return jax_load_vehicle(path), load_vehicle(path)


def _lap(track, veh, alphas, solver="scan"):
    return float(racing_line.evaluate(track, veh, torch.as_tensor(np.asarray(alphas)), solver)[0])


def _same_line(got_x, ref_x, track, veh, jtrack, jveh):
    np.testing.assert_allclose(got_x.numpy(), np.asarray(ref_x), rtol=0, atol=ALPHA_TOL)
    ref_lap = float(jax_rl.evaluate_jit(jtrack, jveh, jnp.asarray(ref_x))[0])
    np.testing.assert_allclose(_lap(track, veh, got_x), ref_lap, rtol=LAP_RTOL)


def test_curvature_matches_jax(ring, tbr18_pair):
    """`minimise_curvature` at its full budget (400 iterations, tol 1e-6).

    Γ² is flat along the ring's optimum: the two packages' iterates part by
    1e-16 at step 1, 3e-9 at step 100 and 9.5e-6 at step 130 as |∇f| falls
    to 1e-6, and both stop at step 133 with Γ² equal to 1e-9 and the lines
    2.4e-6 apart, their laps 3.8e-8 apart.  So the iterates are held at
    1e-10 over the first 60 steps; the finished line at ALPHA_TOL_FLAT =
    1e-5 with Γ² at 1e-9 and its lap at 1e-7; and the port's lap of the
    JAX line at LAP_RTOL."""
    early = racing_line.minimise_curvature(ring[1], max_iter=60)
    early_ref = jax_rl.minimise_curvature(ring[0], max_iter=60)
    np.testing.assert_allclose(early.x.numpy(), np.asarray(early_ref.x), rtol=0, atol=1e-10)
    got = racing_line.minimise_curvature(ring[1])
    ref = jax_rl.minimise_curvature(ring[0])
    assert int(got.n_iter) == int(ref.n_iter)
    np.testing.assert_allclose(float(got.fun), float(ref.fun), rtol=1e-9)
    np.testing.assert_allclose(got.x.numpy(), np.asarray(ref.x), rtol=0, atol=ALPHA_TOL_FLAT)
    ref_lap = float(jax_rl.evaluate_jit(ring[0], tbr18_pair[0], ref.x)[0])
    np.testing.assert_allclose(_lap(ring[1], tbr18_pair[1], got.x), ref_lap, rtol=1e-7)
    np.testing.assert_allclose(_lap(ring[1], tbr18_pair[1], ref.x), ref_lap, rtol=LAP_RTOL)


def test_compromise_at_eps_matches_jax(ring, tbr18_pair):
    got = racing_line.minimise_compromise(ring[1], 0.05)
    ref = jax_rl.minimise_compromise(ring[0], 0.05)
    assert int(got.n_iter) == int(ref.n_iter)
    _same_line(got.x, ref.x, ring[1], tbr18_pair[1], ring[0], tbr18_pair[0])


def test_estimated_matches_jax(ring, tbr18_pair):
    got_x, got_eps = racing_line.minimise_estimated_compromise(ring[1], tbr18_pair[1])
    ref_x, ref_eps = jax_rl.minimise_estimated_compromise(ring[0], tbr18_pair[0])
    assert 0.0 < got_eps < 0.2
    np.testing.assert_allclose(got_eps, ref_eps, rtol=1e-12)
    _same_line(got_x, ref_x, ring[1], tbr18_pair[1], ring[0], tbr18_pair[0])


def test_optimal_compromise_sweep_matches_jax(ring, tbr18_pair):
    """The ε grid as the optimiser's instance axis: a 4-point grid and one
    zoom into the best cell, ε, the (ε, lap) history and the line."""
    kw = dict(n_grid=4, n_refine=1)
    got_x, got_eps, got_hist = racing_line.minimise_optimal_compromise(ring[1], tbr18_pair[1], **kw)
    ref_x, ref_eps, ref_hist = jax_rl.minimise_optimal_compromise(ring[0], tbr18_pair[0], **kw)
    assert got_eps == ref_eps and got_hist.shape == ref_hist.shape == (8, 2)
    np.testing.assert_array_equal(got_hist[:, 0], ref_hist[:, 0])
    np.testing.assert_allclose(got_hist[:, 1], ref_hist[:, 1], rtol=LAP_RTOL)
    _same_line(got_x, ref_x, ring[1], tbr18_pair[1], ring[0], tbr18_pair[0])


def test_lap_time_first_iterations_match_jax(ring, tbr18_pair):
    """`minimise_lap_time(solver="scan")` (the sequential profile, as JAX)
    for its first 3 iterations."""
    got = racing_line.minimise_lap_time(ring[1], tbr18_pair[1], max_iter=3, solver="scan")
    ref = jax_rl.minimise_lap_time(ring[0], tbr18_pair[0], max_iter=3)
    assert int(got.n_iter) == int(ref.n_iter) == 3
    np.testing.assert_allclose(got.x.numpy(), np.asarray(ref.x), rtol=0, atol=ALPHA_TOL)
    np.testing.assert_allclose(float(got.fun), float(ref.fun), rtol=LAP_RTOL)


def test_fused_scoring_equals_scan(ring, tbr18_pair):
    """Kernel 3's twin (solver="fused") against the scan oracle on the ring:
    `evaluate` on a line, and `_compromise_sweep`'s scores of 3 ε."""
    track, veh = ring[1], tbr18_pair[1]
    x = racing_line.minimise_compromise(track, 0.1, max_iter=30).x
    for line in (torch.full((track.size,), 0.5, dtype=torch.float64), x):
        np.testing.assert_allclose(_lap(track, veh, line, "fused"), _lap(track, veh, line), rtol=FUSED_RTOL)
    before = velocity_batch.LAUNCHES
    eps = torch.tensor([0.0, 0.1, 0.2], dtype=torch.float64)
    a_f, t_f = racing_line._compromise_sweep(track, veh, eps, max_iter=20, solver="fused")
    a_s, t_s = racing_line._compromise_sweep(track, veh, eps, max_iter=20, solver="scan")
    assert torch.equal(a_f, a_s) and velocity_batch.LAUNCHES == before  # the CPU runs the twin
    np.testing.assert_allclose(t_f.numpy(), t_s.numpy(), rtol=FUSED_RTOL)


class TestSectors:
    @pytest.fixture(scope="class")
    def buck(self, buckmore99):
        return buckmore99, Track.load(os.path.join(REPO_DATA, "tracks", "buckmore.json"), 0.99)

    def test_sectors_match_jax(self, buck, tbr18_pair):
        """`optimise_sectors` at n_grid=2, max_iter=5: every sector × ε
        instance in one batch, each on its own open window."""
        got_x, got_eps, got_c = racing_line.optimise_sectors(buck[1], tbr18_pair[1], n_grid=2, max_iter=5)
        ref_x, ref_eps, ref_c = jax_rl.optimise_sectors(buck[0], tbr18_pair[0], n_grid=2, max_iter=5)
        np.testing.assert_array_equal(got_c, ref_c)
        np.testing.assert_array_equal(got_eps, np.asarray(ref_eps))
        np.testing.assert_allclose(got_x.numpy(), np.asarray(ref_x), rtol=0, atol=ALPHA_TOL)

    def test_sector_scores_fused_equal_scan(self, buck, tbr18_pair):
        """The sector sweep's open-window scores, kernel 3's twin vs scan."""
        track, veh = buck[1], tbr18_pair[1]
        corners, _ = racing_line.detect_track_corners(track)
        _, _, left_w, right_w, ns_pad = racing_line.sector_windows(track, corners)
        got = racing_line._sector_sweep(left_w, right_w, veh, ns_pad, 2, 3, solver="fused")
        ref = racing_line._sector_sweep(left_w, right_w, veh, ns_pad, 2, 3, solver="scan")
        assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
        lw = left_w[:1]
        sp_scores = []
        for solver in ("fused", "scan"):
            sp_scores.append(racing_line._profile_of(
                veh, *_window_geometry(lw, right_w[:1], ns_pad), False, solver))
        np.testing.assert_allclose(sp_scores[0].numpy(), sp_scores[1].numpy(), rtol=FUSED_RTOL)


def _window_geometry(lw, rw, ns_pad):
    """(s, |κ|, length) of the centre line of one open window."""
    from lap_time_optimization_tpu_torch.ops import spline

    sp = spline.fit(lw + 0.5 * (rw - lw), closed=False)
    s = spline.uniform_samples(sp.length, ns_pad)
    return s, spline.curvature(sp, s[:, :-1]), sp.length


# ------------------------------------------------------------------ full budget
@pytest.mark.slow
class TestPublishedLaps:
    """Buckmore at width 0.99 with tbr18, float64, at the methods' default
    budgets, gated as tests/test_racing_line.py gates the JAX package."""

    @pytest.fixture(scope="class")
    def setup(self):
        return (Track.load(os.path.join(REPO_DATA, "tracks", "buckmore.json"), 0.99),
                load_vehicle(os.path.join(REPO_DATA, "vehicles", "tbr18.json")))

    def test_curvature(self, setup):
        track, veh = setup
        assert _lap(track, veh, racing_line.minimise_curvature(track, max_iter=600).x) < REF_CURVATURE_LAP_TBR18 * 1.01

    def test_compromise(self, setup):
        track, veh = setup
        alphas, eps, _ = racing_line.minimise_optimal_compromise(track, veh, solver="fused")
        assert 0.0 <= eps <= 0.2 and _lap(track, veh, alphas) < REF_COMPROMISE_LAP_TBR18 * 1.01

    def test_laptime(self, setup):
        track, veh = setup
        assert _lap(track, veh, racing_line.minimise_lap_time(track, veh, solver="fused").x) < REF_LAPTIME_LAP_TBR18

    def test_estimated(self, setup):
        track, veh = setup
        alphas, eps = racing_line.minimise_estimated_compromise(track, veh, max_iter=200)
        assert 0.0 < eps < 0.2 and _lap(track, veh, alphas) < 40.0

    def test_sectors(self, setup):
        track, veh = setup
        alphas, eps_w, corners = racing_line.optimise_sectors(track, veh, n_grid=4, max_iter=150, solver="fused")
        assert len(eps_w) == corners.shape[0]
        assert _lap(track, veh, torch.clamp(alphas, 0.0, 1.0)) < REF_CURVATURE_LAP_TBR18

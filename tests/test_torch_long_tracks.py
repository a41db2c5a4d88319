"""Full-size circuits on the port's CPU paths, against the JAX package.

The two CUDA kernels take track tables of any length (csrc/ilqr.cu's
global table placement, csrc/velocity.cu's global scratch), so the sizes
they are driven at on the card by `chip_smoke.py` phase 10 are held here on
the CPU, where the wrappers run their plain twins:

* `track.synthetic_circuit`, the seeded circuit of any length that phase 10
  drives: closed, ns ≥ 20,000 at the Nürburgring Nordschleife's 20,832 m,
  and the port's and the JAX package's `Track` of its cones equal in
  float64 (ns exactly; length and control points to 1e-12 relative).
* kernel 3's twin `solve_profile_batch_reference` at Spa-Francorchamps'
  length (ns = 7,004, N = 7,003 samples; float64, B = 4) against JAX's
  sequential `ops/velocity.solve_profile` per row, at the tolerances
  tests/test_torch_velocity.py states per vehicle (MX5 1e-12, tbr18 1e-8:
  XLA's FMA contraction and PyTorch's CPU float64 sqrt differ in the last
  place, which the friction circle's sqrt near saturation magnifies).
* `mpc/track.load(..., n_samples=20832)`, the NMPC table at the
  Nordschleife's metre count: every table against JAX's (rtol 1e-9, atol
  1e-10, as tests/test_torch_track.py), and 3 control cycles of
  `runner.closed_loop` in float64 on those tables against JAX's XLA path
  (atol 1e-7, as tests/test_torch_closed_loop.py; 4e-16 measured).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lap_time_optimization_tpu.models import load_vehicle as jax_load_vehicle
from lap_time_optimization_tpu.models.bicycle import BicycleModel as JaxBicycle
from lap_time_optimization_tpu.mpc import runner as jax_runner
from lap_time_optimization_tpu.mpc import solver as JS
from lap_time_optimization_tpu.mpc import track as jax_track
from lap_time_optimization_tpu.ops import velocity as jax_velocity
from lap_time_optimization_tpu.track import Track as JaxTrack
from lap_time_optimization_tpu_torch.models import load_vehicle
from lap_time_optimization_tpu_torch.models.bicycle import BicycleModel
from lap_time_optimization_tpu_torch.mpc import runner
from lap_time_optimization_tpu_torch.mpc import solver as TS
from lap_time_optimization_tpu_torch.mpc import track as mpc_track
from lap_time_optimization_tpu_torch.ops import spline, velocity_batch
from lap_time_optimization_tpu_torch.optim import global_search
from lap_time_optimization_tpu_torch.track import Track, synthetic_circuit

REPO_DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "data")
NORDSCHLEIFE, SPA = 20832, 7004  # metres: the samples of one lap
RTOL = {"tbr18": 1e-8, "MX5": 1e-12}
STEPS = 3


@pytest.mark.parametrize("ns", [NORDSCHLEIFE, SPA])
def test_synthetic_circuit_matches_jax_track(ns):
    left, right = synthetic_circuit(ns, seed=0)
    again = synthetic_circuit(ns, seed=0)
    assert all(np.array_equal(a, b) for a, b in zip((left, right), again))
    assert not np.array_equal(left, synthetic_circuit(ns, seed=1)[0])
    got = Track.from_cones(left, right, 0.9, name="synthetic")
    ref = JaxTrack.from_cones(left, right, 0.9, name="synthetic")
    assert got.closed and ref.closed and got.size == ref.size == left.shape[1] - 1
    assert got.ns == ref.ns == ns >= (20000 if ns == NORDSCHLEIFE else 7000)
    assert float(got.length) == pytest.approx(float(ref.length), rel=1e-12)
    assert float(got.length) == pytest.approx(ns - 0.5, rel=1e-12)
    spacing = np.hypot(*np.diff(0.5 * (left + right), axis=1))
    assert 9.0 < spacing.mean() < 11.0
    widths = np.hypot(*(right - left))
    np.testing.assert_allclose(widths, 10.0, rtol=1e-12)
    for alphas in np.random.default_rng(3).uniform(0.0, 1.0, (2, got.size)):
        np.testing.assert_allclose(got.control_points(torch.as_tensor(alphas)).numpy(),
                                   np.asarray(ref.control_points(jnp.asarray(alphas))), rtol=1e-12, atol=1e-9)


@pytest.fixture(scope="module")
def spa_rows():
    """(s, |κ|, lap length) of 4 seeded lines on the Spa-length circuit in
    float64: the searches' batched geometry, N = 7,003 samples a row."""
    track = Track.from_cones(*synthetic_circuit(SPA, seed=0), 0.99, name="synthetic")
    alphas = np.random.default_rng(5).uniform(0.1, 0.9, (4, track.n_decongested))
    with torch.no_grad():
        s, k, length = global_search._geometry(track, torch.as_tensor(alphas),
                                               spline.FIT_METHOD_CLOSED_BATCHED)
    return s[:, :-1], k, length


@pytest.mark.parametrize("name", ["tbr18", "MX5"])
def test_twin_matches_jax_scan_at_spa_length(spa_rows, name):
    s, k, length = spa_rows
    assert k.shape == (4, SPA - 1) and k.dtype == torch.float64
    got = velocity_batch.solve_profile_batch(load_vehicle(name), s, k, length, True)
    jv = jax_load_vehicle(os.path.join(REPO_DATA, "vehicles", f"{name}.json"))
    for b in range(k.shape[0]):
        ref = jax_velocity.solve_profile(jv, jnp.asarray(s[b].numpy()), jnp.asarray(k[b].numpy()),
                                         float(length[b]), closed=True)
        np.testing.assert_allclose(got[b].numpy(), np.asarray(ref), rtol=RTOL[name], err_msg=f"row {b}")


@pytest.fixture(scope="module")
def long_tables():
    if not os.path.isdir(os.path.join(REPO_DATA, "plots", "MX-5", "buckmore", "curvature")):
        pytest.skip("shipped curvature artifacts not available")
    return (jax_track.load("MX-5", "buckmore", "curvature", base_dir=REPO_DATA, n_samples=NORDSCHLEIFE),
            mpc_track.load("MX-5", "buckmore", "curvature", base_dir=REPO_DATA, n_samples=NORDSCHLEIFE))


def test_long_mpc_tables_match_jax(long_tables):
    ref, got = long_tables
    assert got.k_vals.shape == (NORDSCHLEIFE,) and got.k_vals.dtype == torch.float64
    for name in mpc_track.LOOKUP_FIELDS + mpc_track.GEOMETRY_FIELDS:
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(ref, name)),
                                   rtol=1e-9, atol=1e-10, err_msg=name)


def test_closed_loop_on_long_table_matches_jax_f64(long_tables):
    """The port's own tables (not JAX's arrays) in the port's model, against
    the JAX package's XLA path on its tables."""
    ref_track, got_track = long_tables
    jm = JaxBicycle(vehicle=jax_load_vehicle(os.path.join(REPO_DATA, "vehicles", "MX5.json")), track=ref_track)
    jp = JS.OCPParams.reference(jnp.float64, lateral_margin=0.05)
    ref = jax_runner.closed_loop(jm, jp, JS.SolverConfig(horizon=10, backend="xla"),
                                 jnp.asarray(jax_runner.X0_REFERENCE), STEPS)
    tm = BicycleModel(load_vehicle("MX5"), got_track).to("cpu", torch.float64)
    tp = TS.OCPParams.reference(torch.float64, "cpu", lateral_margin=0.05)
    got = runner.closed_loop(tm, tp, TS.SolverConfig(horizon=10), torch.as_tensor(runner.X0_REFERENCE), STEPS)
    np.testing.assert_allclose(got.xs.numpy(), np.asarray(ref.xs), rtol=0, atol=1e-7)
    np.testing.assert_allclose(got.us.numpy(), np.asarray(ref.us), rtol=0, atol=1e-7)
    np.testing.assert_allclose(got.costs.numpy(), np.asarray(ref.costs), rtol=1e-7)
    np.testing.assert_allclose(got.violations.numpy(), np.asarray(ref.violations), rtol=1e-6, atol=1e-9)
    assert np.all(np.diff(got.xs[:, 0].numpy()) > 0)

"""Parity of the PyTorch port's host-side track stack with the JAX package.

Same shipped inputs through both: vehicle JSONs, the closed-spline fit on the
buckmore curvature path, and every MPC lookup table.  JAX runs on the CPU in
x64 (tests/conftest.py); the port builds its tables in float64.  Tolerances:
rtol 1e-9 where the two solve the same dense systems in another summation
order (roundoff ~1e-13 measured), exact equality where the arithmetic is the
same numpy code.
"""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lap_time_optimization_tpu.models import load_vehicle as jax_load_vehicle
from lap_time_optimization_tpu.mpc import track as jax_track
from lap_time_optimization_tpu.ops import spline as jax_spline
from lap_time_optimization_tpu.utils import io as jax_io
from lap_time_optimization_tpu_torch.models import load_vehicle
from lap_time_optimization_tpu_torch.mpc import track as torch_track
from lap_time_optimization_tpu_torch.ops import spline as torch_spline
from lap_time_optimization_tpu_torch.utils import convert

REPO_DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "data")
ART = os.path.join(REPO_DATA, "plots", "MX-5", "buckmore", "curvature")


def _numpy_fields(obj) -> dict:
    return {f.name: np.asarray(getattr(obj, f.name)) for f in dataclasses.fields(obj)}


@pytest.fixture(scope="module")
def tracks():
    if not os.path.isdir(ART):
        pytest.skip("shipped curvature artifacts not available")
    return (jax_track.load("MX-5", "buckmore", "curvature", base_dir=REPO_DATA),
            torch_track.load("MX-5", "buckmore", "curvature", base_dir=REPO_DATA))


@pytest.mark.parametrize("name", ["MX5", "tbr18"])
def test_load_vehicle_fields_equal(name):
    """Every parameter parses to the same float64 value."""
    ref = jax_load_vehicle(os.path.join(REPO_DATA, "vehicles", f"{name}.json"))
    got = load_vehicle(os.path.join(REPO_DATA, "vehicles", f"{name}.json"))
    assert type(got).__name__ == type(ref).__name__
    assert got.name == ref.name
    for field in got.FIELDS:
        np.testing.assert_array_equal(getattr(got, field).numpy(), np.asarray(getattr(ref, field)))


def test_vehicle_force_laws_match():
    """engine_force / traction on seeded speeds and curvatures (rtol 1e-12:
    same formula, float64)."""
    rng = np.random.default_rng(3)
    v = rng.uniform(1.0, 40.0, 64)
    k = rng.uniform(-0.05, 0.05, 64)
    for name in ("MX5", "tbr18"):
        ref = jax_load_vehicle(os.path.join(REPO_DATA, "vehicles", f"{name}.json"))
        got = load_vehicle(os.path.join(REPO_DATA, "vehicles", f"{name}.json"))
        tv, tk = torch.as_tensor(v), torch.as_tensor(k)
        np.testing.assert_allclose(got.engine_force(tv).numpy(),
                                   np.asarray(ref.engine_force(jnp.asarray(v))), rtol=1e-12)
        np.testing.assert_allclose(got.traction(tv, tk).numpy(),
                                   np.asarray(ref.traction(jnp.asarray(v), jnp.asarray(k))),
                                   rtol=1e-12, atol=1e-9)


def test_spline_fit_evaluate_curvature_match():
    """Closed dense fit of the buckmore racing line, its value and first two
    derivatives, signed curvature and the arc-length table (rtol 1e-9)."""
    px, py = jax_io.load_artifact(os.path.join(ART, "path.json"))
    pts = np.stack([px, py])
    if not np.allclose(pts[:, 0], pts[:, -1]):
        pts = np.concatenate([pts, pts[:, :1]], axis=1)
    ref = jax_spline.fit(jnp.asarray(pts), closed=True)
    got = torch_spline.fit(torch.as_tensor(pts), closed=True)
    for field in ("tk", "Mj", "Mj1", "h"):
        np.testing.assert_allclose(getattr(got, field).numpy(), np.asarray(getattr(ref, field)),
                                   rtol=1e-9, atol=1e-12)
    u = np.linspace(-3.0, float(ref.length) * 1.5, 2001)
    for der in (0, 1, 2):
        np.testing.assert_allclose(torch_spline.evaluate(got, torch.as_tensor(u), der=der).numpy(),
                                   np.asarray(jax_spline.evaluate(ref, jnp.asarray(u), der=der)),
                                   rtol=1e-9, atol=1e-10)
    np.testing.assert_allclose(torch_spline.curvature(got, torch.as_tensor(u), signed=True).numpy(),
                               np.asarray(jax_spline.curvature(ref, jnp.asarray(u), signed=True)),
                               rtol=1e-9, atol=1e-12)
    u_t, arc_t = torch_spline.arc_length_table(got, n_samples=500)
    u_j, arc_j = jax_spline.arc_length_table(ref, n_samples=500)
    np.testing.assert_allclose(arc_t.numpy(), np.asarray(arc_j), rtol=1e-9)
    s = np.linspace(0.0, float(arc_j[-1]), 97)
    np.testing.assert_allclose(
        torch_spline.u_of_arc_length(u_t, arc_t, torch.as_tensor(s)).numpy(),
        np.asarray(jax_spline.u_of_arc_length(u_j, arc_j, jnp.asarray(s))), rtol=1e-9, atol=1e-12)


def test_interp_matches_jnp_interp():
    """The port's interp reproduces jnp.interp, edges included (to 1e-14:
    XLA may fuse the multiply-add, a last-bit difference)."""
    rng = np.random.default_rng(4)
    xp = np.sort(rng.uniform(0.0, 10.0, 50))
    fp = rng.normal(size=50)
    x = np.concatenate([rng.uniform(-2.0, 12.0, 200), xp[:5], [xp[0], xp[-1]]])
    np.testing.assert_allclose(
        torch_spline.interp(torch.as_tensor(x), torch.as_tensor(xp), torch.as_tensor(fp)).numpy(),
        np.asarray(jnp.interp(jnp.asarray(x), jnp.asarray(xp), jnp.asarray(fp))),
        rtol=1e-14, atol=1e-15)


def test_mpc_track_tables_match(tracks):
    """Every lookup table, the replay geometry and s_max of the shipped
    MX-5/buckmore/curvature set (rtol 1e-9, atol 1e-10)."""
    ref, got = tracks
    assert got.k_vals.dtype == torch.float64
    for name in torch_track.LOOKUP_FIELDS + torch_track.GEOMETRY_FIELDS:
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(ref, name)),
                                   rtol=1e-9, atol=1e-10, err_msg=name)


def test_lookups_match(tracks):
    """k/NL/NR/vref lookups on s over two laps, from bit-identical tables
    (rtol 1e-12)."""
    ref, _ = tracks
    got = convert.track_from_numpy(_numpy_fields(ref))
    s = np.linspace(-10.0, 2.0 * float(ref.s_max), 401)
    for fn in ("curvature", "dist_left", "dist_right", "v_ref"):
        np.testing.assert_allclose(getattr(got, fn)(torch.as_tensor(s)).numpy(),
                                   np.asarray(getattr(ref, fn)(jnp.asarray(s))),
                                   rtol=1e-12, atol=1e-14, err_msg=fn)


@pytest.mark.parametrize("a_brake, vref_scale", [(1.0, 0.6), (0.05, 1.0), (float("inf"), 0.6)])
def test_brake_preview_envelope_equal(tracks, a_brake, vref_scale):
    """with_brake_preview runs the same float64 sweep: equal envelopes."""
    ref, _ = tracks
    got = convert.track_from_numpy(_numpy_fields(ref))
    out_ref = jax_track.with_brake_preview(ref, a_brake, vref_scale=vref_scale)
    out_got = torch_track.with_brake_preview(got, a_brake, vref_scale=vref_scale)
    np.testing.assert_array_equal(out_got.vref_vals.numpy(), np.asarray(out_ref.vref_vals))
    np.testing.assert_array_equal(out_got.k_vals.numpy(), got.k_vals.numpy())


def test_position_and_replay_match(tracks):
    """`MPCTrack.position` and the replay reconstruction
    (`viz.visualiser.vehicle_positions`) on the port's own tables equal the
    JAX package's on seeded states over two laps (rtol 1e-9: the tables
    themselves agree to ~1e-13)."""
    from lap_time_optimization_tpu.viz import visualiser as jax_vis
    from lap_time_optimization_tpu_torch.viz import visualiser

    ref, got = tracks
    rng = np.random.default_rng(5)
    states = np.zeros((200, 8))
    states[:, 0] = rng.uniform(-5.0, 2.0 * float(ref.s_max), 200)
    states[:, 1:5] = rng.normal(0.0, [0.5, 0.2, 8.0, 0.5], (200, 4))
    pts, tans = got.position(torch.as_tensor(states[:, 0]))
    ref_pts, ref_tans = ref.position(jnp.asarray(states[:, 0]))
    np.testing.assert_allclose(pts.numpy(), np.asarray(ref_pts), rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(tans.numpy(), np.asarray(ref_tans), rtol=1e-9, atol=1e-9)
    for a, b in zip(visualiser.vehicle_positions(got, states), jax_vis.vehicle_positions(ref, states)):
        np.testing.assert_allclose(a, b, rtol=1e-9, atol=1e-9)

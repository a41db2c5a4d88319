"""Parity of the port's splines (all of `ops/spline.py`) and racing-line
`Track` with the JAX package.

Same float64 numpy inputs through both.  Tolerances: exact equality where
both do the same numpy arithmetic (track loading, alpha maps); rtol 1e-9 on
spline values, derivatives and curvature, where the two solve the same
moment systems in another order (dense LU against LU, or the O(n)
recurrence; roundoff ~1e-13 measured), as tests/test_spline.py holds the
tridiag solve to the dense one.
"""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lap_time_optimization_tpu.ops import spline as jax_spline
from lap_time_optimization_tpu.track import Track as JaxTrack
from lap_time_optimization_tpu_torch.ops import spline
from lap_time_optimization_tpu_torch.track import Track
from lap_time_optimization_tpu_torch.utils import convert

REPO_DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "data")
BUCKMORE = os.path.join(REPO_DATA, "tracks", "buckmore.json")


@pytest.fixture(scope="module")
def polygons():
    """4 closed control polygons of buckmore's decongested subset at 0.8."""
    track = Track.load(BUCKMORE, 0.8)
    alphas = np.random.default_rng(2).uniform(0.0, 0.99, (4, track.n_decongested))
    return track.control_points_decongested(torch.as_tensor(alphas)).numpy()


def _u(length, n=257):
    return np.linspace(0.0, float(length), n)


def test_tridiag_equals_dense_batched(polygons):
    """The O(n) cyclic Thomas + Sherman–Morrison solve against the dense
    solve on a batch of 4 polygons (1e-9, as tests/test_spline.py)."""
    pts = torch.as_tensor(polygons)
    dense = spline.fit(pts, True, "dense")
    tri = spline.fit(pts, True, "tridiag")
    np.testing.assert_allclose(tri.Mj.numpy(), dense.Mj.numpy(), rtol=1e-9, atol=1e-9)
    u = torch.as_tensor(np.stack([_u(L) for L in dense.length.numpy()]))
    np.testing.assert_allclose(spline.curvature(tri, u).numpy(), spline.curvature(dense, u).numpy(),
                               rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("method", ["dense", "tridiag"])
def test_closed_fit_matches_jax(method, polygons):
    """The batched fit, evaluation (der 0-2; the third derivative jumps at
    the knots, where the two packages' cumulative sums may put a sample on
    either side), curvature and gamma2 equal the JAX package's per polygon."""
    got = spline.fit(torch.as_tensor(polygons), True, method)
    assert got.batched and got.Mj.shape == (4, 2, polygons.shape[-1] - 1)
    u = np.stack([_u(L) for L in got.length.numpy()])
    for b in range(4):
        ref = jax_spline.fit(jnp.asarray(polygons[b]), True, method)
        np.testing.assert_allclose(float(got.length[b]), float(ref.length), rtol=1e-14)
        for der in range(3):
            np.testing.assert_allclose(spline.evaluate(got, torch.as_tensor(u), der=der).numpy()[b],
                                       np.asarray(jax_spline.evaluate(ref, jnp.asarray(u[b]), der=der)),
                                       rtol=1e-9, atol=1e-9)
        np.testing.assert_allclose(spline.curvature(got, torch.as_tensor(u), signed=True).numpy()[b],
                                   np.asarray(jax_spline.curvature(ref, jnp.asarray(u[b]), signed=True)),
                                   rtol=1e-9, atol=1e-9)
        np.testing.assert_allclose(float(spline.gamma2(got, torch.as_tensor(u))[b]),
                                   float(jax_spline.gamma2(ref, jnp.asarray(u[b]))), rtol=1e-9)


def test_open_fit_matches_jax(polygons):
    """The not-a-knot open fit (unbatched and batched) against JAX."""
    pts = polygons[:2, :, :-1]  # drop the closing duplicate: an open polyline
    batched = spline.fit(torch.as_tensor(pts), closed=False)
    for b in range(2):
        ref = jax_spline.fit(jnp.asarray(pts[b]), False)
        one = spline.fit(torch.as_tensor(pts[b]), closed=False)
        u = _u(ref.length, 199)
        for der in range(3):
            want = np.asarray(jax_spline.evaluate(ref, jnp.asarray(u), der=der))
            np.testing.assert_allclose(spline.evaluate(one, torch.as_tensor(u), der=der).numpy(), want,
                                       rtol=1e-9, atol=1e-9)
            np.testing.assert_allclose(spline.evaluate(batched, torch.as_tensor(np.stack([u, u])),
                                                       der=der).numpy()[b], want, rtol=1e-9, atol=1e-9)
        np.testing.assert_allclose(float(spline.gamma2(one, torch.as_tensor(u))),
                                   float(jax_spline.gamma2(ref, jnp.asarray(u))), rtol=1e-9)


@pytest.mark.parametrize("width", [0.8, 0.99])
def test_track_matches_jax(width):
    """Loaded fields, sizes and both alpha maps (batched) equal the JAX
    Track's; so does the Track converted from the JAX fields."""
    ref = JaxTrack.load(BUCKMORE, track_width=width)
    fields = {f.name: (getattr(ref, f.name) if f.name in ("closed", "size", "ns", "name", "decongest_stride")
                       else np.asarray(getattr(ref, f.name))) for f in dataclasses.fields(ref)}
    for got in (Track.load(BUCKMORE, track_width=width), convert.race_track_from_numpy(fields)):
        assert (got.closed, got.size, got.ns, got.name, got.n_decongested) == \
            (ref.closed, ref.size, ref.ns, ref.name, ref.n_decongested)
        for name in ("left", "right", "diffs", "widths", "old_left", "old_right", "length"):
            np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(ref, name)))
        rng = np.random.default_rng(3)
        a_full = rng.uniform(0.0, 1.0, (3, ref.size))
        a_dec = rng.uniform(0.0, 0.99, (3, ref.n_decongested))
        full = got.control_points(torch.as_tensor(a_full)).numpy()
        dec = got.control_points_decongested(torch.as_tensor(a_dec)).numpy()
        for b in range(3):
            np.testing.assert_array_equal(full[b], np.asarray(ref.control_points(jnp.asarray(a_full[b]))))
            np.testing.assert_array_equal(dec[b],
                                          np.asarray(ref.control_points_decongested(jnp.asarray(a_dec[b]))))


def test_mid_and_path_spline_match_jax():
    ref = JaxTrack.load(BUCKMORE, track_width=0.8)
    got = Track.load(BUCKMORE, track_width=0.8)
    mid_ref, mid = ref.mid_spline(), got.mid_spline()
    u = _u(mid_ref.length)
    np.testing.assert_allclose(spline.curvature(mid, torch.as_tensor(u)).numpy(),
                               np.asarray(jax_spline.curvature(mid_ref, jnp.asarray(u))), rtol=1e-9, atol=1e-12)
    alphas = np.random.default_rng(6).uniform(0.0, 1.0, (2, got.size))
    path = got.path_spline(torch.as_tensor(alphas), spline.FIT_METHOD_CLOSED_BATCHED)
    for b in range(2):
        path_ref = ref.path_spline(jnp.asarray(alphas[b]), jax_spline.FIT_METHOD_CLOSED_BATCHED)
        np.testing.assert_allclose(path.Mj[b].numpy(), np.asarray(path_ref.Mj), rtol=1e-9, atol=1e-9)
    assert (spline.FIT_METHOD_CLOSED, spline.FIT_METHOD_CLOSED_BATCHED) == (
        jax_spline.FIT_METHOD_CLOSED, jax_spline.FIT_METHOD_CLOSED_BATCHED) == ("dense", "tridiag")

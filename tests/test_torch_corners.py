"""The port's corner detection and host geometry (`utils/corners.py`,
`utils/native.py`) against the JAX package and against each other.

The native library (`native/lto_geometry.cpp`, built by the port into
`build/native/`) and the numpy versions must give exactly the same numbers
(compared with `==`); `detect_corners` on buckmore must equal the JAX
package's exactly; and the synthetic `filter_corners` cases of
tests/test_track.py hold for the port.
"""

import os

import numpy as np
import pytest

from lap_time_optimization_tpu.optim import racing_line as jax_rl
from lap_time_optimization_tpu_torch.mpc import track as mpc_track
from lap_time_optimization_tpu_torch.optim import racing_line
from lap_time_optimization_tpu_torch.track import Track
from lap_time_optimization_tpu_torch.utils import corners, native

REPO_DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "data")


@pytest.fixture(scope="module")
def built():
    if not native.available():
        pytest.skip("no C++ toolchain: the numpy versions run (covered by the cases below)")
    return True


@pytest.fixture
def numpy_only(monkeypatch):
    """The port's numpy path, as where no compiler is at hand."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", True)


def test_nearest_distances_native_equals_numpy(built, rng):
    path = rng.standard_normal((2, 300)) * 50
    boundary = rng.standard_normal((2, 400)) * 50
    got = native.nearest_distances(path, boundary)
    np.testing.assert_array_equal(got, native.nearest_distances_numpy(path, boundary))
    np.testing.assert_array_equal(native.nearest_distances(np.zeros((2, 1)), np.asarray([[3.0], [4.0]])),
                                  [5.0])


def test_filter_corners_native_equals_numpy(built, rng):
    for _ in range(20):
        mask = rng.random(200) < 0.4
        mask[0] = False  # already in the shifted form
        dists = np.cumsum(rng.uniform(0.5, 2.0, 200))
        got = native.filter_corners_shifted(mask.copy(), dists, length=4.0, proximity=8.0)
        ref = corners._drop_short_corners(corners._merge_short_straights(mask.copy(), dists, 8.0),
                                          dists, 4.0)
        np.testing.assert_array_equal(got, ref)


def test_idx_modulo():
    np.testing.assert_array_equal(corners.idx_modulo(2, 5, 10), [2, 3, 4])
    np.testing.assert_array_equal(corners.idx_modulo(8, 2, 10), [8, 9, 0, 1])


@pytest.mark.parametrize("path", ["native", "numpy"])
def test_filter_and_pairs_synthetic(path, request):
    """tests/test_track.py's case: corners at [10,30), [35,40), [60,62) on
    100 samples 1 m apart; the 5 m straight [30,35) is below the proximity
    and merges, the 2 m corner [60,62) is below the length and drops."""
    request.getfixturevalue("built" if path == "native" else "numpy_only")
    is_corner = np.zeros(100, dtype=bool)
    is_corner[10:30] = True
    is_corner[35:40] = True
    is_corner[60:62] = True
    out = corners.filter_corners(is_corner, np.arange(100.0), length=4.0, proximity=8.0)
    assert out[10:40].all() and not out[60:62].any()
    pairs = corners.corner_idxs(out)
    assert pairs.shape == (1, 2) and pairs[0][0] == 10 and pairs[0][1] == 40
    assert corners.corner_idxs(np.ones(5, bool)).shape == (0, 2)
    np.testing.assert_array_equal(corners.samples_to_controls(np.arange(10.0), np.array([[2, 7]]),
                                                              np.array([0.0, 5.0, 10.0])), [[1, 2]])


@pytest.mark.parametrize("path", ["native", "numpy"])
def test_detect_on_buckmore_equals_jax(path, request, buckmore):
    """Buckmore at width 0.8: the corner pairs and the sample mask equal
    the JAX package's exactly, with either path of the port."""
    request.getfixturevalue("built" if path == "native" else "numpy_only")
    track = Track.load(os.path.join(REPO_DATA, "tracks", "buckmore.json"), 0.8)
    got_c, got_m = racing_line.detect_track_corners(track)
    ref_c, ref_m = jax_rl.detect_track_corners(buckmore)
    np.testing.assert_array_equal(got_c, ref_c)
    np.testing.assert_array_equal(got_m, ref_m)
    assert got_c.shape[0] >= 3 and got_m.dtype == bool and got_m.any() and not got_m.all()


def test_mpc_track_tables_use_native(built, monkeypatch):
    """`mpc/track.build` goes through `native.nearest_distances`, and its
    tables are the same with the numpy path."""
    base = os.path.join(REPO_DATA, "plots", "MX-5", "buckmore", "curvature")
    if not os.path.isdir(base):
        pytest.skip("shipped curvature artifacts not available")
    got = mpc_track.load("MX-5", "buckmore", "curvature", base_dir=REPO_DATA, n_samples=400)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", True)
    ref = mpc_track.load("MX-5", "buckmore", "curvature", base_dir=REPO_DATA, n_samples=400)
    for name in ("nl_vals", "nr_vals", "k_vals"):
        assert np.array_equal(getattr(got, name).numpy(), getattr(ref, name).numpy()), name

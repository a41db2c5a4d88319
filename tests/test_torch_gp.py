"""Parity of the port's Gaussian process (`ops/gp.py`) with the JAX package.

Same seeded float64 dataset through both (as tests/test_gp.py).  The grid
fit is deterministic in both, so the fitted length scale must match to
rtol 1e-10 (the two Cholesky factorisations round differently, which could
only move the argmin between two grid points whose likelihoods tie to
~1e-12); predictions to 1e-8.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lap_time_optimization_tpu.ops import gp as jax_gp
from lap_time_optimization_tpu_torch.ops import gp


@pytest.fixture(scope="module")
def dataset():
    rng = np.random.default_rng(0)
    x = rng.uniform(0, 1, size=(30, 5))
    y = np.sin(3 * x[:, 0]) + 0.5 * x[:, 1] ** 2 + 0.1 * rng.standard_normal(30)
    return x, y


def test_matern52_matches(dataset):
    x, _ = dataset
    for ell in (0.3, 1.0, 2.7):
        np.testing.assert_allclose(gp.matern52(torch.as_tensor(x), torch.as_tensor(x), ell).numpy(),
                                   np.asarray(jax_gp.matern52(jnp.asarray(x), jnp.asarray(x), ell)),
                                   rtol=1e-13, atol=1e-15)
    grid = gp.matern52(torch.as_tensor(x), torch.as_tensor(x[:4]), torch.tensor([0.3, 2.7], dtype=torch.float64))
    assert grid.shape == (2, 30, 4)


@pytest.mark.parametrize("ell0", [None, 0.7])
def test_fit_predict_match_jax(dataset, ell0):
    x, y = dataset
    got = gp.fit(torch.as_tensor(x), torch.as_tensor(y), ell0=ell0)
    ref = jax_gp.fit(jnp.asarray(x), jnp.asarray(y), jax.random.PRNGKey(0), ell0=ell0)
    np.testing.assert_allclose(float(got.length_scale), float(ref.length_scale), rtol=1e-10)
    np.testing.assert_allclose(got.weights.numpy(), np.asarray(ref.weights), rtol=1e-6, atol=1e-8)
    xq = np.random.default_rng(1).uniform(0, 1, (7, 5))
    mean, std = gp.predict(got, torch.as_tensor(xq))
    ref_mean, ref_std = jax_gp.predict(ref, jnp.asarray(xq))
    np.testing.assert_allclose(mean.numpy(), np.asarray(ref_mean), rtol=1e-8, atol=1e-8)
    np.testing.assert_allclose(std.numpy(), np.asarray(ref_std), rtol=1e-8, atol=1e-8)


def test_padded_equals_unpadded(dataset):
    x, y = dataset
    plain = gp.fit(torch.as_tensor(x), torch.as_tensor(y))
    cap = 48
    xp, yp = np.zeros((cap, 5)), np.zeros(cap)
    xp[:30], yp[:30] = x, y
    mask = torch.arange(cap) < 30
    padded = gp.fit(torch.as_tensor(xp), torch.as_tensor(yp), mask=mask)
    np.testing.assert_allclose(float(padded.length_scale), float(plain.length_scale), rtol=1e-6)
    xq = torch.as_tensor(np.linspace(0, 1, 5)[:, None] * np.ones((1, 5)))
    m1, s1 = gp.predict(plain, xq)
    m2, s2 = gp.predict(padded, xq)
    np.testing.assert_allclose(m2.numpy(), m1.numpy(), atol=1e-8)
    np.testing.assert_allclose(s2.numpy(), s1.numpy(), atol=1e-7)
    # the fit interpolates its training data at the fitted scale
    np.testing.assert_allclose(gp.predict(plain, torch.as_tensor(x))[0].numpy(), y, atol=1e-3)

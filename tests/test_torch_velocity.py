"""Parity of the port's velocity profiles (`ops/velocity.py`) with the JAX package.

Same float64 numpy inputs through both: buckmore's mid-spline samples and
curvature (as tests/test_velocity.py), the shipped vehicles.  Tolerances:

* MX5 (and every formula without a square root near zero): rtol 1e-12.
* tbr18: rtol 1e-8.  Its friction-circle traction sqrt(f_cap² − f_lat²)
  vanishes at the lateral limit, and near that saturation one ulp of the
  slack becomes ~1e-9 of the profile.  The two libraries round differently
  in the last place: XLA's CPU code contracts a·b − c·d into a fused
  multiply-add, and PyTorch's CPU float64 sqrt is not correctly rounded
  (both measured with PyTorch 2.13 and JAX 0.9 on an AVX512 CPU).  The
  largest difference seen is 1e-9 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lap_time_optimization_tpu.ops import spline as jax_spline
from lap_time_optimization_tpu.ops import velocity as jax_velocity
from lap_time_optimization_tpu_torch.models import load_vehicle
from lap_time_optimization_tpu_torch.ops import velocity

RTOL = {"tbr18": 1e-8, "mx5": 1e-12}
VEHICLE_FILE = {"tbr18": "tbr18", "mx5": "MX5"}


@pytest.fixture(scope="module")
def samples(buckmore):
    sp = buckmore.mid_spline()
    s = np.linspace(0.0, float(sp.length), buckmore.ns)[:-1]
    k = np.array(jax_spline.curvature(sp, jnp.asarray(s), signed=False))
    return s, k, float(sp.length)


def _vehicles(name, request):
    return request.getfixturevalue(name), load_vehicle(VEHICLE_FILE[name])


def test_local_limit_matches(samples, request):
    _, k, _ = samples
    for name in ("tbr18", "mx5"):
        jv, tv = _vehicles(name, request)
        np.testing.assert_allclose(velocity.local_limit(tv, torch.as_tensor(k)).numpy(),
                                   np.asarray(jax_velocity.local_limit(jv, jnp.asarray(k))), rtol=1e-14)


@pytest.mark.parametrize("name, closed", [("tbr18", True), ("mx5", True), ("tbr18", False)],
                         ids=["closed-tbr18", "closed-mx5", "open-tbr18"])
def test_solve_profile_matches(name, closed, samples, request):
    s, k, s_max = samples
    jv, tv = _vehicles(name, request)
    n = len(s) if closed else 400
    ref = jax_velocity.solve_profile(jv, jnp.asarray(s[:n]), jnp.asarray(k[:n]),
                                     s_max if closed else None, closed=closed)
    got = velocity.solve_profile(tv, torch.as_tensor(s[:n]), torch.as_tensor(k[:n]),
                                 s_max if closed else None, closed=closed)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL[name])


def test_solve_profile_rows_are_independent(samples, rng):
    """A (B, N) batch, each row rolled to its own argmin, equals the rows
    solved one by one (same arithmetic: rtol 1e-14)."""
    s, k, s_max = samples
    tv = load_vehicle("tbr18")
    kb = torch.as_tensor(np.stack([k * f for f in rng.uniform(0.8, 1.2, 3)]))
    sb = torch.as_tensor(np.stack([s * f for f in (1.0, 1.01, 0.99)]))
    smax = torch.as_tensor([s_max, 1.01 * s_max, 0.99 * s_max])
    for solve in (velocity.solve_profile, velocity.solve_profile_parallel):
        got = solve(tv, sb, kb, smax, closed=True)
        for b in range(3):
            np.testing.assert_allclose(got[b].numpy(), solve(tv, sb[b], kb[b], smax[b]).numpy(),
                                       rtol=1e-14)


@pytest.mark.parametrize("name", ["tbr18", "mx5"])
def test_solve_profile_parallel_matches(name, samples, request):
    s, k, s_max = samples
    jv, tv = _vehicles(name, request)
    ref = jax_velocity.solve_profile_parallel(jv, jnp.asarray(s), jnp.asarray(k), s_max, closed=True)
    got = velocity.solve_profile_parallel(tv, torch.as_tensor(s), torch.as_tensor(k), s_max, closed=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL[name])


def test_lap_time_matches(samples, tbr18):
    s, k, s_max = samples
    v = np.array(jax_velocity.solve_profile(tbr18, jnp.asarray(s), jnp.asarray(k), s_max))
    s_full = np.append(s, s_max)
    ref = float(jax_velocity.lap_time(jnp.asarray(s_full), jnp.asarray(v)))
    got = float(velocity.lap_time(torch.as_tensor(s_full), torch.as_tensor(v)))
    assert got == pytest.approx(ref, rel=1e-14)
    assert 20.0 < got < 120.0


@pytest.mark.parametrize("name", ["tbr18", "mx5"])
def test_assoc_lap_time_gradient_matches_jax(name, samples, request):
    """d(lap time)/d(curvature) through the log-depth "assoc" solver: the
    port's autograd against `jax.grad`, to 1e-9 of the largest entry for
    MX5 and 1e-6 for tbr18, whose traction's derivative 1/(2·sqrt(slack))
    magnifies the last-place differences further (3e-8 measured).  The
    min-plus scan's ties split the gradient 0.5/0.5 in both, as lax.min and
    torch.minimum do."""
    s, k, s_max = samples
    jv, tv = _vehicles(name, request)
    s_full = np.append(s, s_max)

    def jax_lap(kk):
        v = jax_velocity.solve_profile_parallel(jv, jnp.asarray(s), kk, s_max, closed=True)
        return jax_velocity.lap_time(jnp.asarray(s_full), v)

    ref = np.asarray(jax.grad(jax_lap)(jnp.asarray(k)))
    kt = torch.as_tensor(k).requires_grad_(True)
    v = velocity.solve_profile_parallel(tv, torch.as_tensor(s), kt, s_max, closed=True)
    velocity.lap_time(torch.as_tensor(s_full), v).backward()
    got = kt.grad.numpy()
    assert np.all(np.isfinite(got))
    tol = {"tbr18": 1e-6, "mx5": 1e-9}[name]
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol * max(1.0, np.abs(ref).max()))

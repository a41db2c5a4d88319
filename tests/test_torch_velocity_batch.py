"""Kernel 3's plain twin against the JAX package's Pallas kernel, and the dispatch.

`ops/velocity_batch.solve_profile_batch_reference` runs the CUDA kernel's
recurrence (two laps of both sweeps) in plain PyTorch; it is held against
`pallas_velocity.solve_profile_batch(..., interpret=True)` on the same
float64 inputs as tests/test_pallas_velocity.py: buckmore's mid-spline
curvature scaled per row, closed for tbr18 and MX5, open (300 samples),
and a ragged batch of 160 rows.  Tolerances as tests/test_torch_velocity.py
states them: rtol 1e-12 for MX5, 1e-8 for tbr18 (its friction circle
magnifies last-place rounding differences of the two libraries near
saturation).  The kernel itself is held against the twin on the card by
tests/test_torch_velocity_cuda.py and chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lap_time_optimization_tpu.ops import pallas_velocity, spline
from lap_time_optimization_tpu_torch.models import load_vehicle
from lap_time_optimization_tpu_torch.ops import velocity, velocity_batch
from lap_time_optimization_tpu_torch.utils import profiling

RTOL = {"tbr18": 1e-8, "mx5": 1e-12}
VEHICLE_FILE = {"tbr18": "tbr18", "mx5": "MX5"}


@pytest.fixture(scope="module")
def samples(buckmore):
    sp = buckmore.mid_spline()
    s = np.linspace(0.0, float(sp.length), buckmore.ns)[:-1]
    k = np.array(spline.curvature(sp, jnp.asarray(s), signed=False))
    return s, k, float(sp.length)


@pytest.fixture(scope="module")
def k_batch(samples):
    _, k, _ = samples
    return np.stack([k * f for f in np.random.default_rng(4).uniform(0.8, 1.2, 6)])


@pytest.mark.parametrize("name", ["tbr18", "mx5"])
def test_twin_matches_pallas_closed(name, samples, k_batch, request):
    s, _, s_max = samples
    ref = pallas_velocity.solve_profile_batch(request.getfixturevalue(name), jnp.asarray(s),
                                              jnp.asarray(k_batch), s_max, closed=True, interpret=True)
    got = velocity_batch.solve_profile_batch(load_vehicle(VEHICLE_FILE[name]), torch.as_tensor(s),
                                             torch.as_tensor(k_batch), s_max, closed=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL[name])


def test_twin_matches_pallas_open(tbr18, samples, k_batch):
    s, _, s_max = samples
    kb = k_batch[:, :300]
    ref = pallas_velocity.solve_profile_batch(tbr18, jnp.asarray(s[:300]), jnp.asarray(kb), s_max,
                                              closed=False, interpret=True)
    got = velocity_batch.solve_profile_batch(load_vehicle("tbr18"), torch.as_tensor(s[:300]),
                                             torch.as_tensor(kb), s_max, closed=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL["tbr18"])


def test_twin_matches_pallas_ragged_batch(tbr18, samples):
    """B=160 (two Pallas lane tiles; five 32-row blocks of the CUDA kernel),
    per-row s and s_max."""
    s, k, s_max = samples
    B = 160
    f = np.random.default_rng(5).uniform(0.9, 1.1, B)
    kb, sb, smax = k[None] / f[:, None], s[None] * f[:, None], s_max * f
    ref = pallas_velocity.solve_profile_batch(tbr18, jnp.asarray(sb), jnp.asarray(kb), jnp.asarray(smax),
                                              closed=True, interpret=True)
    got = velocity_batch.solve_profile_batch(load_vehicle("tbr18"), torch.as_tensor(sb),
                                             torch.as_tensor(kb), torch.as_tensor(smax), closed=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL["tbr18"])


@pytest.mark.parametrize("name", ["tbr18", "mx5"])
def test_twin_equals_sequential_solver(name, samples, k_batch):
    """The two-lap recurrence equals the argmin-rolled oracle of the port
    (`ops/velocity.solve_profile`) row by row: same library, roundoff only
    (force·(1/mass) against force/mass)."""
    s, _, s_max = samples
    veh = load_vehicle(VEHICLE_FILE[name])
    kb = torch.as_tensor(k_batch)
    got = velocity_batch.solve_profile_batch(veh, torch.as_tensor(s), kb, s_max)
    ref = velocity.solve_profile(veh, torch.as_tensor(s), kb, s_max)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-13)


@pytest.mark.parametrize("name", ["tbr18", "mx5"])
def test_pack_vehicle_matches_pallas(name, request):
    jv = request.getfixturevalue(name)
    params, engine, pacejka = velocity_batch.pack_vehicle(load_vehicle(VEHICLE_FILE[name]),
                                                          torch.float64, "cpu")
    ref_params, ref_engine, ref_pacejka = pallas_velocity._pack_vehicle(jv, jnp.float64)
    assert pacejka == ref_pacejka
    np.testing.assert_array_equal(params.numpy()[:4], np.asarray(ref_params))
    np.testing.assert_array_equal(engine.numpy(), np.asarray(ref_engine))
    assert params[4].item() == float(jv.friction_coef) * 9.81  # μ·g of the lateral limit


def test_cpu_tensors_take_the_twin(samples, k_batch, monkeypatch):
    """A CPU tensor goes to the plain twin: no build, no launch."""
    s, _, s_max = samples

    def no_kernel(*args, **kwargs):
        raise AssertionError("the CUDA kernel was reached from CPU tensors")

    monkeypatch.setattr(velocity_batch, "_launch", no_kernel)
    monkeypatch.setattr(velocity_batch, "build", no_kernel)
    launches = profiling.counts()["velocity_batch.launch"]
    veh = load_vehicle("tbr18")
    got = velocity_batch.solve_profile_batch(veh, torch.as_tensor(s), torch.as_tensor(k_batch[:2]), s_max)
    ref = velocity_batch.solve_profile_batch_reference(veh, torch.as_tensor(s), torch.as_tensor(k_batch[:2]),
                                                       s_max)
    assert torch.equal(got, ref) and profiling.counts()["velocity_batch.launch"] == launches


def test_forward_only_and_device_checks(samples, k_batch):
    s, _, s_max = samples
    veh = load_vehicle("tbr18")
    k = torch.as_tensor(k_batch[:2]).requires_grad_(True)
    with pytest.raises(ValueError, match="forward-only"):
        velocity_batch.solve_profile_batch(veh, torch.as_tensor(s), k, s_max)
    with pytest.raises(ValueError, match="no velocity-profile implementation"):
        velocity_batch.solve_profile_batch(veh, torch.as_tensor(s, device="meta"),
                                           torch.empty((2, len(s)), device="meta", dtype=torch.float64),
                                           s_max)
    with pytest.raises(ValueError, match="expected \\(B, N\\)"):
        velocity_batch.solve_profile_batch(veh, torch.as_tensor(s), torch.as_tensor(k_batch[0]), s_max)

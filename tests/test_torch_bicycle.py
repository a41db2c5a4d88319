"""Parity of the port's bicycle model and solver pieces with the JAX package.

Both sides run on bit-identical float64 parameters (`utils/convert.py` fills
the port's modules from the JAX dataclasses' arrays) and seeded numpy
states.  Tolerances: 1e-12 for the RHS / RK4 step and the constraint rows
(same formulas, roundoff only), 1e-11 for the linearisation and the
Gauss-Newton quadratics (the port's Jacobians are analytic, JAX's come from
jacfwd: the same derivatives in another rounding order).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lap_time_optimization_tpu.models import load_vehicle as jax_load_vehicle
from lap_time_optimization_tpu.models.bicycle import BicycleModel as JaxBicycle
from lap_time_optimization_tpu.mpc import runner as jax_runner
from lap_time_optimization_tpu.mpc import solver as JS
from lap_time_optimization_tpu.mpc import track as jax_track
from lap_time_optimization_tpu_torch.mpc import solver as TS
from lap_time_optimization_tpu_torch.utils import convert

REPO_DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "data")


def _numpy_fields(obj) -> dict:
    return {f.name: np.asarray(getattr(obj, f.name)) for f in dataclasses.fields(obj)}


@pytest.fixture(scope="module")
def params():
    if not os.path.isdir(os.path.join(REPO_DATA, "plots", "MX-5", "buckmore", "curvature")):
        pytest.skip("shipped curvature artifacts not available")
    veh = jax_load_vehicle(os.path.join(REPO_DATA, "vehicles", "MX5.json"))
    track = jax_track.load("MX-5", "buckmore", "curvature", base_dir=REPO_DATA)
    p = JS.OCPParams.reference(jnp.float64, lateral_margin=0.05)
    return veh, track, p


def _pair(params, tv=False, te=False):
    veh, track, p = params
    jm = JaxBicycle(vehicle=veh, track=track, enable_torque_vectoring=tv, enable_traction_ellipse=te)
    tm = convert.model_from_numpy(_numpy_fields(veh), _numpy_fields(track),
                                  enable_torque_vectoring=tv, enable_traction_ellipse=te)
    return jm, tm, p, convert.ocp_params_from_numpy(_numpy_fields(p))


def _states(n, seed):
    """Seeded augmented states z = [x, u_prev] over a lap and two inputs."""
    rng = np.random.default_rng(seed)
    x = np.stack([
        rng.uniform(-5.0, 900.0, n), rng.uniform(-1.0, 1.0, n), rng.uniform(-0.3, 0.3, n),
        rng.uniform(1.0, 20.0, n), rng.uniform(-2.0, 2.0, n), rng.uniform(-1.0, 1.0, n),
        rng.uniform(-0.5, 0.5, n), rng.uniform(-1.0, 1.0, n),
    ], axis=1)
    return np.concatenate([x, rng.uniform(-0.5, 0.5, (n, 2))], axis=1), rng.uniform(-1.0, 1.0, (n, 2))


@pytest.mark.parametrize("tv", [False, True])
def test_rhs_and_step_match(params, tv):
    """RHS (with and without torque vectoring) and the RK4 step on 10
    seeded states (1e-12)."""
    jm, tm, _, _ = _pair(params, tv=tv)
    z, u = _states(10, seed=5)
    x = z[:, :8]
    ref_rhs = np.asarray(jax.vmap(jm.rhs)(jnp.asarray(x), jnp.asarray(u)))
    ref_step = np.asarray(jax.vmap(lambda a, b: jm.step(a, b, 0.1, substeps=2))(jnp.asarray(x), jnp.asarray(u)))
    got_rhs = tm.rhs(torch.as_tensor(x), torch.as_tensor(u)).numpy()
    got_step = tm.step(torch.as_tensor(x), torch.as_tensor(u), 0.1, substeps=2).numpy()
    np.testing.assert_allclose(got_rhs, ref_rhs, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(got_step, ref_step, rtol=1e-12, atol=1e-12)
    if tv:  # the flag must matter, or this case tests nothing
        off = _pair(params)[1].rhs(torch.as_tensor(x), torch.as_tensor(u)).numpy()
        assert np.max(np.abs(off[:, 5] - got_rhs[:, 5])) > 1e-5


@pytest.mark.parametrize("te", [False, True])
def test_constraints_match(params, te):
    """True and tightened constraint rows, 14 or 16 with the friction ellipse."""
    jm, tm, jp, tp = _pair(params, te=te)
    z, u = _states(10, seed=6)
    for jf, tf in ((JS.constraints, TS.constraints), (JS.tightened_constraints, TS.tightened_constraints)):
        ref = np.asarray(jax.vmap(lambda a, b: jf(jm, jp, a, b))(jnp.asarray(z), jnp.asarray(u)))
        got = tf(tm, tp, torch.as_tensor(z), torch.as_tensor(u)).numpy()
        assert got.shape == (10, 16 if te else 14)
        np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-12)
    ref_cost = np.asarray(jax.vmap(lambda a, b: JS.stage_cost(jm, jp, a, b))(jnp.asarray(z), jnp.asarray(u)))
    got_cost = TS.stage_cost(tm, tp, torch.as_tensor(z), torch.as_tensor(u)).numpy()
    np.testing.assert_allclose(got_cost, ref_cost, rtol=1e-12)


def _trajectory(jm, cfg, kind):
    """The reference-state rollout (s = 0 and mu = 0 exactly: grid-point and
    |mu| kinks) or a seeded off-line trajectory spanning the lap seam."""
    rng = np.random.default_rng(7)
    if kind == "reference":
        x0 = jax_runner.X0_REFERENCE
        us = np.stack([rng.normal(0.0, 0.3, cfg.horizon), np.full(cfg.horizon, 0.05)], axis=1)
        z0 = jnp.concatenate([jnp.asarray(x0), jnp.zeros(2)])
        return np.array(JS._rollout(jm, cfg, z0, jnp.asarray(us))), us
    z, _ = _states(cfg.horizon + 1, seed=8)
    z[:, 0] = np.linspace(850.0, 870.0, cfg.horizon + 1)
    return z, rng.uniform(-1.0, 1.0, (cfg.horizon, 2))


@pytest.mark.parametrize("kind", ["reference", "seeded"])
@pytest.mark.parametrize("tv, te", [(False, False), (True, True)])
def test_linearisation_and_quads_match(params, kind, tv, te):
    """A, B of every stage and the GN stage/terminal quadratics (1e-11)."""
    jm, tm, jp, tp = _pair(params, tv=tv, te=te)
    cfg_j = JS.SolverConfig(horizon=10, backend="xla")
    cfg_t = TS.SolverConfig(horizon=10)
    zs, us = _trajectory(jm, cfg_j, kind)
    lams = np.random.default_rng(9).uniform(0.0, 3.0, (11, JS.n_con(jm)))
    rho = 20.0
    A, B = JS._linearize_joint(jm, cfg_j, jnp.asarray(zs), jnp.asarray(us))
    tA, tB = TS._linearize_joint(tm, cfg_t, torch.as_tensor(zs), torch.as_tensor(us))
    np.testing.assert_allclose(tA.numpy(), np.asarray(A), rtol=1e-11, atol=1e-11)
    np.testing.assert_allclose(tB.numpy(), np.asarray(B), rtol=1e-11, atol=1e-11)

    ref = jax.vmap(lambda z, u, lam: JS._quads_gauss_newton(jm, jp, z, u, lam, rho))(
        jnp.asarray(zs[:-1]), jnp.asarray(us), jnp.asarray(lams[:-1]))
    got = TS._quads_gauss_newton(tm, tp, torch.as_tensor(zs[:-1]), torch.as_tensor(us),
                                 torch.as_tensor(lams[:-1]), torch.tensor(rho, dtype=torch.float64))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-11, atol=1e-11)
    ref_t = JS._terminal_quads_gauss_newton(jm, jp, jnp.asarray(zs[-1]), jnp.asarray(lams[-1]), rho)
    got_t = TS._terminal_quads_gauss_newton(tm, tp, torch.as_tensor(zs[-1]), torch.as_tensor(lams[-1]),
                                            torch.tensor(rho, dtype=torch.float64))
    for g, r in zip(got_t, ref_t):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-11, atol=1e-11)


def test_traction_ellipse_matches(params):
    """The reference's raw friction-ellipse form on 64 seeded points of
    (throttle, vx, vy, r, delta, ρ, α), both axles (rtol 1e-12)."""
    jm, tm, _, _ = _pair(params)
    rng = np.random.default_rng(11)
    lo_hi = ((-1.0, 1.0), (1.0, 25.0), (-2.0, 2.0), (-1.5, 1.5), (-0.4, 0.4), (0.5, 1.5), (0.5, 1.5))
    grid = [rng.uniform(lo, hi, 64) for lo, hi in lo_hi]
    ref = jm.traction_ellipse(*(jnp.asarray(g) for g in grid))
    got = tm.traction_ellipse(*(torch.as_tensor(g) for g in grid))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-12)


def test_traction_ellipse_raw_form(params):
    """tests/test_flags.py's TestTractionEllipse on the port: more drive
    force consumes ellipse margin on both axles, and at a gentle state,
    where the physical form holds, the raw form reads > 1e3."""
    tm = _pair(params)[1]
    state = lambda thr: [torch.tensor(v, dtype=torch.float64) for v in (thr, 8.0, 0.0, 0.0, 0.0)]
    g_lo, g_hi = tm.traction_ellipse(*state(0.1)), tm.traction_ellipse(*state(0.9))
    assert float(g_hi[0]) > float(g_lo[0]) and float(g_hi[1]) > float(g_lo[1])
    raw_f, _ = tm.traction_ellipse(*state(0.2))
    phys_f, phys_r = tm.traction_ellipse_physical(*state(0.2))
    assert float(raw_f) > 1e3 and float(phys_f) < 0.0 and float(phys_r) < 0.0

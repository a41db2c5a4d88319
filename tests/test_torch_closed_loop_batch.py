"""The port's batched solve and batched closed loop against the JAX package.

Both sides run on bit-identical parameters (`utils/convert.py`); the port
runs on the CPU, where `ops.ilqr.solve` takes its plain version.  The oracle is the JAX package's XLA path, where `solve_batch` is
`vmap(solve)`.  Instances start at s = 0, 0.43·s_max and s_max − 3 at
different speeds, as in tests/test_pallas_ilqr.py::TestBatchedKernel, whose
tolerances these are: 1e-9 in float64 and 2e-4 in float32 for a solve.
The closed loops are held as tests/test_torch_closed_loop.py holds the
single stream (1e-7 in float64), and batch == single per instance as in
tests/test_mpc.py::TestBatchedClosedLoop.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lap_time_optimization_tpu.models.bicycle import BicycleModel as JaxBicycle
from lap_time_optimization_tpu.mpc import runner as jax_runner
from lap_time_optimization_tpu.mpc import solver as JS
from lap_time_optimization_tpu_torch.mpc import runner, solver as TS
from lap_time_optimization_tpu_torch.ops import ilqr
from lap_time_optimization_tpu_torch.utils import convert, profiling
from test_torch_ilqr import _numpy_fields, base  # noqa: F401  (fixture)

JDT = {"float32": jnp.float32, "float64": jnp.float64}


def _pair(base, dtype_name, tv=False, te=False):
    jdt = JDT[dtype_name]
    cast = lambda tree: jax.tree.map(
        lambda a: a.astype(jdt) if jnp.issubdtype(a.dtype, jnp.floating) else a, tree)
    veh, track = cast(base[0]), cast(base[1])
    jm = JaxBicycle(vehicle=veh, track=track, enable_torque_vectoring=tv, enable_traction_ellipse=te)
    jp = JS.OCPParams.reference(jdt, lateral_margin=0.05)
    tm = convert.model_from_numpy(_numpy_fields(veh), _numpy_fields(track),
                                  enable_torque_vectoring=tv, enable_traction_ellipse=te)
    return jm, jp, tm, convert.ocp_params_from_numpy(_numpy_fields(jp))


def _batch_inputs(s_max, n_con, dtype_name, horizon=10):
    """(z0, us, lams) for three instances, as numpy arrays."""
    x0 = np.tile(jax_runner.X0_REFERENCE, (3, 1))
    x0[:, 0] = [0.0, 0.43 * s_max, s_max - 3.0]
    x0[:, 3] = [5.0, 7.0, 9.0]
    z0 = np.concatenate([x0, np.zeros((3, 2))], axis=1)
    us = np.full((3, horizon, 2), 0.05)
    lams = np.zeros((3, horizon + 1, n_con))
    return tuple(a.astype(dtype_name) for a in (z0, us, lams))


def _assert_result(got, ref, tol):
    for name in ("us", "zs", "lam", "max_violation"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(ref, name)),
                                   rtol=tol, atol=tol, err_msg=name)
    np.testing.assert_allclose(got.cost.numpy(), np.asarray(ref.cost), rtol=10 * tol)


@pytest.mark.parametrize("dtype_name, n_con, al_iters, ilqr_iters", [
    ("float64", 14, 2, 3), ("float32", 14, 2, 3), ("float32", 16, 1, 2)])
def test_solve_batch_matches_jax(base, dtype_name, n_con, al_iters, ilqr_iters):  # noqa: F811
    """(d) The port's solve_batch against JAX solve_batch on the XLA path."""
    jm, jp, tm, tp = _pair(base, dtype_name, te=(n_con == 16))
    args = _batch_inputs(float(base[1].s_max), n_con, dtype_name)
    ref = JS.solve_batch(jm, jp, JS.SolverConfig(horizon=10, al_iters=al_iters, ilqr_iters=ilqr_iters,
                                                 backend="xla"), *map(jnp.asarray, args))
    got = TS.solve_batch(tm, tp, TS.SolverConfig(horizon=10, al_iters=al_iters, ilqr_iters=ilqr_iters),
                         *map(torch.from_numpy, args))
    assert got.us.dtype == getattr(torch, dtype_name) and got.cost.shape == (3,)
    _assert_result(got, ref, 1e-9 if dtype_name == "float64" else 2e-4)


@pytest.mark.parametrize("n_con", [14, 16])
def test_solve_batch_is_solve_per_instance(base, n_con):  # noqa: F811
    """(d) Instance b of the port's solve_batch is the port's solve on it
    (float64, torque vectoring on), with its own accept/reject and reg."""
    _, _, tm, tp = _pair(base, "float64", tv=True, te=(n_con == 16))
    cfg = TS.SolverConfig(horizon=10, al_iters=2, ilqr_iters=3)
    args = [torch.from_numpy(a) for a in _batch_inputs(float(base[1].s_max), n_con, "float64")]
    got = TS.solve_batch(tm, tp, cfg, *args)
    for b in range(3):
        one = TS.solve(tm, tp, cfg, *(a[b] for a in args))
        for name, g, r in zip(one._fields, got, one):
            np.testing.assert_allclose(g[b].numpy(), r.numpy(), rtol=1e-11, atol=1e-12, err_msg=name)


def test_solve_batch_rejects_exact_hessians(base):  # noqa: F811
    """Exact Hessians never reach the solve kernel: its check refuses them
    (the kernel is Gauss-Newton only), and solve_batch runs them on the
    plain path, with no kernel launch (held to JAX in
    tests/test_torch_solver_exact.py)."""
    _, _, tm, tp = _pair(base, "float64")
    cfg = TS.SolverConfig(horizon=10, al_iters=1, ilqr_iters=1, hessian_mode="exact")
    args = [torch.from_numpy(a) for a in _batch_inputs(float(base[1].s_max), 14, "float64")]
    with pytest.raises(NotImplementedError, match="hessian_mode"):
        ilqr._check_solve(cfg, *args, ilqr.pack(tm, tp, cfg))
    launches = profiling.counts()["ilqr.solve"]
    got = TS.solve_batch(tm, tp, cfg, *args)
    assert profiling.counts()["ilqr.solve"] == launches
    assert got.us.shape == (3, 10, 2) and bool(torch.isfinite(got.cost).all())


def _fleet_states():
    """The reference state, and the same at vx = 6."""
    x0 = np.stack([jax_runner.X0_REFERENCE, jax_runner.X0_REFERENCE])
    x0[1, 3] = 6.0
    return x0


@pytest.fixture(scope="module")
def fleets(base):  # noqa: F811
    """3 control cycles of two float64 loops on both sides, and the port's
    solve kernel launches over its run."""
    jm, jp, tm, tp = _pair(base, "float64")
    x0 = _fleet_states()
    ref = jax_runner.closed_loop_batch(jm, jp, JS.SolverConfig(horizon=10, backend="xla"),
                                       jnp.asarray(x0), 3)
    launches = profiling.counts()["ilqr.solve"]
    got = runner.closed_loop_batch(tm, tp, TS.SolverConfig(horizon=10), torch.from_numpy(x0), 3)
    launches = profiling.counts()["ilqr.solve"] - launches
    return ref, got, tm, tp, launches


def test_closed_loop_batch_matches_jax(fleets):
    """(e) The batched closed loop against JAX closed_loop_batch (XLA)."""
    ref, got, _, _, _ = fleets
    assert got.xs.shape == (2, 4, 8) and got.us.shape == (2, 4, 2) and got.costs.shape == (2, 3)
    np.testing.assert_allclose(got.xs.numpy(), np.asarray(ref.xs), rtol=0, atol=1e-7)
    np.testing.assert_allclose(got.us.numpy(), np.asarray(ref.us), rtol=0, atol=1e-7)
    np.testing.assert_allclose(got.costs.numpy(), np.asarray(ref.costs), rtol=1e-7)
    np.testing.assert_allclose(got.violations.numpy(), np.asarray(ref.violations), rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(got.sdot.numpy(), np.asarray(ref.sdot), rtol=1e-7, atol=1e-9)


def test_closed_loop_batch_equals_single(base):  # noqa: F811
    """(e) Instance b of the batched loop is `closed_loop` from its state
    (a cheap solver budget, 1 AL round × 2 iLQR iterations: what is tested
    is the batching, which the budget does not touch)."""
    _, _, tm, tp = _pair(base, "float64")
    cfg = TS.SolverConfig(horizon=10, al_iters=1, ilqr_iters=2)
    x0 = torch.from_numpy(_fleet_states())
    got = runner.closed_loop_batch(tm, tp, cfg, x0, 3)
    for b in range(2):
        one = runner.closed_loop(tm, tp, cfg, x0[b], 3)
        for name, g, r in zip(one._fields, got, one):
            np.testing.assert_allclose(g[b].numpy(), r.numpy(), rtol=1e-9, atol=1e-12, err_msg=name)


def test_closed_loop_batch_gates(fleets):
    """Monotone progress and the applied-state gate (< 1e-2) for every
    instance; on the CPU the plain solve runs, so the kernel counter stays."""
    _, got, tm, tp, launches = fleets
    assert np.all(np.diff(got.xs[:, :, 0].numpy(), axis=1) > 0)
    for b in range(2):
        assert runner.applied_violation(tm, tp, runner.SimResult(*(a[b] for a in got))) < 1e-2
    assert launches == 0

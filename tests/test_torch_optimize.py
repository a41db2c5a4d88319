"""Parity of the port's ladder L-BFGS (`ops/optimize.py`) with the JAX package.

The objective is smooth and seeded (a weighted quadratic with a quartic and
a coupling term in 6 dimensions), so iterates can be compared step for step
in float64: the same x0 through JAX `lbfgs_ladder_stepper` /
`bounded_stepper(linesearch="ladder")` and the port's, for a fixed number
of steps, to rtol 1e-10 (gradients by jax.grad and autograd differ in the
last places).  The port runs every instance in one batch with the
semantics of `jax.vmap` over a `while_loop`; a batch must equal its
instances run one by one, including an instance that stops early.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lap_time_optimization_tpu.ops import optimize as jax_optimize
from lap_time_optimization_tpu_torch.ops import optimize

D = 6
_rng = np.random.default_rng(9)
W = _rng.uniform(0.5, 3.0, D)
C = _rng.uniform(0.1, 0.9, D)


def jax_fun(x):
    return jnp.sum(W * (x - C) ** 2) + 0.3 * jnp.sum((x - C) ** 4) + 0.2 * jnp.sum(x) ** 2


def torch_fun(x):
    w, c = torch.as_tensor(W), torch.as_tensor(C)
    return (torch.sum(w * (x - c) ** 2, dim=-1) + 0.3 * torch.sum((x - c) ** 4, dim=-1)
            + 0.2 * torch.sum(x, dim=-1) ** 2)


@pytest.fixture(scope="module")
def x0():
    return np.random.default_rng(10).uniform(-2.0, 2.0, (3, D))


@pytest.mark.parametrize("steps", [1, 4, 9])
def test_ladder_iterates_match_jax(x0, steps):
    init, run = optimize.lbfgs_ladder_stepper(torch_fun, max_iter=50, memory_size=5)
    got = run(init(torch.as_tensor(x0)), steps)
    j_init, j_run = jax_optimize.lbfgs_ladder_stepper(jax_fun, max_iter=50, memory_size=5)
    for b in range(3):
        ref = j_run(j_init(jnp.asarray(x0[b])), steps)
        np.testing.assert_allclose(got[0][b].numpy(), np.asarray(ref[0]), rtol=1e-10, atol=1e-12)
        assert int(got[2][b]) == int(ref[2])
        np.testing.assert_allclose(float(got[4][b]), float(ref[4]), rtol=1e-12)
        np.testing.assert_allclose(float(got[3][b]), float(ref[3]), rtol=1e-8, atol=1e-12)
        for name in ("s", "y", "rho", "gamma", "center"):
            np.testing.assert_allclose(got[1][name][b].numpy(), np.asarray(ref[1][name]),
                                       rtol=1e-8, atol=1e-12)
        assert int(got[1]["count"][b]) == int(ref[1]["count"])


def test_bounded_stepper_matches_jax(x0):
    """The box [0, 0.99] through the sigmoid transform: finalize's x, f and
    n_iter after 6 steps."""
    start = np.clip(0.5 + 0.2 * x0, 0.01, 0.98)
    init, run, fin = optimize.bounded_stepper(torch_fun, lo=0.0, hi=0.99, max_iter=40,
                                              dtype=torch.float64)
    got = fin(run(init(torch.as_tensor(start)), 6))
    j_init, j_run, j_fin = jax_optimize.bounded_stepper(jax_fun, lo=0.0, hi=0.99, max_iter=40,
                                                        dtype=jnp.float64, linesearch="ladder")
    for b in range(3):
        ref = j_fin(j_run(j_init(jnp.asarray(start[b])), 6))
        np.testing.assert_allclose(got.x[b].numpy(), np.asarray(ref.x), rtol=1e-10)
        np.testing.assert_allclose(float(got.fun[b]), float(ref.fun), rtol=1e-12)
        assert int(got.n_iter[b]) == int(ref.n_iter)
    with pytest.raises(NotImplementedError):
        optimize.bounded_stepper(torch_fun, linesearch="zoom")


def test_batch_equals_instances_with_early_stop(x0):
    """Instance 1 starts 1e-3 from the unconstrained minimiser and converges
    (gnorm ≤ tol) long before the others; in the batch it is frozen while
    they go on, and every instance equals its own run, n_iter included."""
    x_star = jax.device_get(jax_optimize.minimize_lbfgs(jax_fun, jnp.asarray(C), max_iter=200,
                                                        tol=1e-12, linesearch="ladder").x)
    starts = x0.copy()
    starts[1] = np.asarray(x_star) + 1e-3
    init, run = optimize.lbfgs_ladder_stepper(torch_fun, max_iter=30, tol=1e-6, memory_size=5)
    batch = run(init(torch.as_tensor(starts)), 30)
    n_iter = batch[2].numpy()
    assert n_iter[1] < n_iter[0] and n_iter[1] < n_iter[2] and float(batch[3][1]) <= 1e-6
    for b in range(3):
        one = run(init(torch.as_tensor(starts[b:b + 1])), 30)
        assert int(one[2][0]) == int(n_iter[b])
        np.testing.assert_allclose(batch[0][b].numpy(), one[0][0].numpy(), rtol=1e-12, atol=1e-14)
        np.testing.assert_allclose(float(batch[4][b]), float(one[4][0]), rtol=1e-12)
    again = run(batch, 30)  # every instance is done: nothing moves
    assert torch.equal(again[0], batch[0]) and torch.equal(again[2], batch[2])


def test_bounded_transform_round_trip():
    to_params, to_theta = optimize.bounded_transform(torch.tensor(0.0, dtype=torch.float64),
                                                     torch.tensor(0.99, dtype=torch.float64))
    x = torch.linspace(0.01, 0.98, 9, dtype=torch.float64)
    np.testing.assert_allclose(to_params(to_theta(x)).numpy(), x.numpy(), rtol=1e-12)
    res = optimize.MinimizeResult(x=x, fun=x.sum(), n_iter=torch.tensor(3), grad_norm=x.norm())
    assert res.n_iter == 3 and res._fields == ("x", "fun", "n_iter", "grad_norm")

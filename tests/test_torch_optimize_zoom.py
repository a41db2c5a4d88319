"""Parity of the port's zoom L-BFGS (`ops/optimize.lbfgs_stepper`) with the
JAX package's `lbfgs_stepper` (optax L-BFGS and its zoom line search).

Every case runs the same x0 through both packages in float64 one
iteration at a time and compares the iterate after each iteration, to
atol 1e-10 (autograd and jax.grad, and XLA's and PyTorch's dot products,
differ in the last places): a bounded Rosenbrock-type objective over
≥ 24 iterations; a non-smooth one (weighted |x − c|) whose line search
fails and takes optax's safe step; and the curvature energy Γ² of buckmore,
the racing-line objective, for its first 5 iterations.  A batch of
instances, one of which converges early, equals the instances run one by
one, bit for bit.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lap_time_optimization_tpu.ops import optimize as jax_optimize
from lap_time_optimization_tpu.optim import racing_line as jax_rl
from lap_time_optimization_tpu.track import Track as JaxTrack
from lap_time_optimization_tpu_torch.ops import optimize
from lap_time_optimization_tpu_torch.optim import racing_line
from lap_time_optimization_tpu_torch.track import Track

REPO_DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "data")
D = 6
C = np.random.default_rng(9).uniform(0.2, 0.8, D)
_rng = np.random.default_rng(9)
KW, KC = _rng.uniform(0.5, 3.0, D), _rng.uniform(0.1, 0.9, D)
ATOL = 1e-10


def jax_rosen(x):
    return jnp.sum(10.0 * (x[1:] - x[:-1] ** 2) ** 2) + jnp.sum((C - x) ** 2)


def torch_rosen(x):
    c = torch.as_tensor(C)
    return torch.sum(10.0 * (x[:, 1:] - x[:, :-1] ** 2) ** 2, dim=-1) + torch.sum((c - x) ** 2, dim=-1)


def jax_kink(x):
    return jnp.sum(KW * jnp.abs(x - KC)) + 0.1 * jnp.sum((x - KC) ** 2)


def torch_kink(x):
    w, c = torch.as_tensor(KW), torch.as_tensor(KC)
    return torch.sum(w * torch.abs(x - c), dim=-1) + 0.1 * torch.sum((x - c) ** 2, dim=-1)


@pytest.fixture(scope="module")
def starts():
    return np.random.default_rng(10).uniform(0.05, 0.95, (3, D))


def _step_by_step(j_init, j_run, t_init, t_run, x0, steps):
    """Both steppers one iteration at a time from x0 (d,); the largest
    iterate difference, the final carries and the JAX line search's failures
    (a positive decrease or curvature error at the end of a search)."""
    j_run = jax.jit(j_run, static_argnums=1)
    jc, tc = j_init(jnp.asarray(x0)), t_init(torch.as_tensor(x0[None]))
    worst, failures = 0.0, 0
    for _ in range(steps):
        jc, tc = j_run(jc, 1), t_run(tc, 1)
        worst = max(worst, float(np.abs(np.asarray(jc[0]) - tc[0][0].numpy()).max()))
        info = jc[1][2].info
        failures += int(float(info.decrease_error) > 0 or float(info.curvature_error) > 0)
    return worst, jc, tc, failures


@pytest.mark.parametrize("b", [0, 1, 2])
def test_bounded_iterates_match_optax(starts, b):
    """The box [0, 0.99] through the sigmoid transform, tol 1e-9: 24-30
    iterations to convergence, each iterate within 1e-10, the same
    iteration count and f at the end."""
    j_init, j_run, j_fin = jax_optimize.bounded_stepper(jax_rosen, lo=0.0, hi=0.99, max_iter=60,
                                                        tol=1e-9, dtype=jnp.float64)
    t_init, t_run, t_fin = optimize.bounded_stepper(torch_rosen, lo=0.0, hi=0.99, max_iter=60,
                                                    tol=1e-9, dtype=torch.float64)
    worst, jc, tc, _ = _step_by_step(j_init, j_run, t_init, t_run, starts[b], 60)
    assert int(jc[2]) >= 15 and int(tc[2][0]) == int(jc[2])
    assert worst <= ATOL
    ref, got = j_fin(jc), t_fin(tc)
    np.testing.assert_allclose(got.x[0].numpy(), np.asarray(ref.x), rtol=0, atol=ATOL)
    np.testing.assert_allclose(float(got.fun[0]), float(ref.fun), rtol=1e-12)


def test_failed_line_search_matches_optax():
    """A kinked objective: the zoom cannot meet the curvature condition
    near the kinks, shrinks its interval below 1e-5 and takes the safe step
    (optax `_try_safe_step`).  40 iterations, each within 1e-10."""
    j_init, j_run = jax_optimize.lbfgs_stepper(jax_kink, max_iter=40)
    t_init, t_run = optimize.lbfgs_stepper(torch_kink, max_iter=40)
    total = 0
    for x0 in np.random.default_rng(10).uniform(-2.0, 2.0, (2, D)):
        worst, jc, tc, failures = _step_by_step(j_init, j_run, t_init, t_run, x0, 40)
        total += failures
        assert worst <= ATOL and int(tc[2][0]) == int(jc[2]) == 40
        np.testing.assert_allclose(float(tc[3][0]), float(jc[3]), rtol=1e-12)
    assert total > 0  # the line search did fail


def test_gamma2_buckmore_first_steps(buckmore):
    """The curvature method's objective on buckmore (width 0.8) from the
    centre line: 5 iterations of the bounded zoom L-BFGS, each iterate
    within 1e-10 of JAX's."""
    track = Track.load(os.path.join(REPO_DATA, "tracks", "buckmore.json"), 0.8)
    assert isinstance(buckmore, JaxTrack)
    j_init, j_run, _ = jax_optimize.bounded_stepper(lambda a: jax_rl.gamma2_objective(buckmore, a),
                                                    max_iter=400, dtype=jnp.float64)
    t_init, t_run, _ = optimize.bounded_stepper(lambda a: racing_line.gamma2_objective(track, a),
                                                max_iter=400, dtype=torch.float64)
    worst, jc, tc, _ = _step_by_step(j_init, j_run, t_init, t_run, np.full(track.size, 0.5), 5)
    assert int(tc[2][0]) == int(jc[2]) == 5
    assert worst <= ATOL


def test_batch_equals_instances_with_early_stop(starts):
    """Instance 1 starts at the minimiser of the kinked objective's smooth
    neighbour and converges first; in the batch it is frozen while the
    others go on, and every instance equals its own run bit for bit."""
    x_star = optimize.minimize_lbfgs(torch_rosen, torch.as_tensor(starts[:1]), tol=1e-12).x
    x0 = torch.as_tensor(starts.copy())
    x0[1] = x_star[0] + 1e-4
    init, run = optimize.lbfgs_stepper(torch_rosen, max_iter=40, tol=1e-8)
    batch = run(init(x0), 40)
    n_iter = batch[2].numpy()
    assert n_iter[1] < n_iter[0] and n_iter[1] < n_iter[2]
    for b in range(3):
        one = run(init(x0[b:b + 1]), 40)
        assert int(one[2][0]) == int(n_iter[b])
        assert torch.equal(batch[0][b], one[0][0])
    again = run(batch, 40)  # every instance is done: nothing moves
    assert torch.equal(again[0], batch[0]) and torch.equal(again[2], batch[2])


def test_graphed_value_and_grad_is_eager_on_the_cpu(starts):
    """`GraphedValueAndGrad` captures only on a CUDA device: on the CPU it is
    the eager call and keeps no graph (the card's capture is held to the
    eager call bit for bit in tests/test_torch_determinism_cuda.py)."""
    x = torch.as_tensor(starts)
    graphed = optimize.GraphedValueAndGrad(torch_rosen)
    f, g = graphed(x)
    f_ref, g_ref = optimize._value_and_grad(torch_rosen, x)
    assert torch.equal(f, f_ref) and torch.equal(g, g_ref) and not graphed.graphs


def test_minimize_bounded_matches_jax(starts):
    """`minimize_bounded` (zoom) to convergence: x, f and n_iter."""
    got = optimize.minimize_bounded(torch_rosen, torch.as_tensor(starts), lo=0.0, hi=0.99, tol=1e-9)
    for b in range(3):
        ref = jax_optimize.minimize_bounded(jax_rosen, jnp.asarray(starts[b]), lo=0.0, hi=0.99, tol=1e-9)
        np.testing.assert_allclose(got.x[b].numpy(), np.asarray(ref.x), rtol=0, atol=ATOL)
        np.testing.assert_allclose(float(got.fun[b]), float(ref.fun), rtol=1e-12)
        assert int(got.n_iter[b]) == int(ref.n_iter)

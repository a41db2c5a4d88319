"""`ops/optimize.minimize_bounded_chunked`, the host-chunked bounded L-BFGS,
and the lap-time method that runs through it.

Chunks must not change the iterates: on the port the chunked run equals
`minimize_bounded` bit for bit (x, f, n_iter, grad_norm) for chunk = 1, 7
and max_iter, with the zoom and the ladder line search, in float64 on the
curvature energy Γ² of the 25-cone ring with two instances, one of which
converges early; it builds one stepper and evaluates the objective exactly
as often.  Against the JAX package's `minimize_bounded_chunked` (x64) on a
bounded Rosenbrock-type objective, the iterate at the end of each chunk is
held at 1e-10, the per-step bound of tests/test_torch_optimize_zoom.py, with
the same iteration counts; a run that converges inside its first chunk ends
after the next chunk, which moves nothing, in both packages.  `minimise_lap_time` gives
the same line at chunk 2 and 50.
"""

import os

import jax
import numpy as np
import pytest
import torch

from lap_time_optimization_tpu.ops import optimize as jax_optimize
from lap_time_optimization_tpu_torch.models import load_vehicle
from lap_time_optimization_tpu_torch.ops import optimize
from lap_time_optimization_tpu_torch.optim import racing_line
from lap_time_optimization_tpu_torch.track import Track
from test_torch_optimize_zoom import ATOL, D, jax_rosen, torch_rosen
from test_torch_racing_line import REPO_DATA, ring_json

MAX_ITER = 40


@pytest.fixture(scope="module")
def ring(tmp_path_factory):
    return Track.load(ring_json(tmp_path_factory.mktemp("tracks")), 0.8)


@pytest.fixture(scope="module")
def gamma2_case(ring):
    """Γ² of the ring and two starts (2, size): the centre line, and the
    zoom's 100th iterate from it, which converges at tol 1e-6 after 15 more
    zoom iterations (13 ladder ones) while the centre line runs on to
    MAX_ITER."""
    obj = lambda a: racing_line.gamma2_objective(ring, a)
    centre = torch.full((1, ring.size), 0.5, dtype=torch.float64)
    mid = optimize.minimize_bounded(obj, centre, max_iter=100)
    return obj, torch.cat([centre, mid.x])


def _chunks(module, monkeypatch, log):
    """Record (x, it) after every chunk the module's `bounded_stepper` runs."""
    orig = module.bounded_stepper

    def recording(*a, **kw):
        init, run, fin = orig(*a, **kw)

        def run_logged(carry, n):
            carry = run(carry, n)
            log.append((carry[0].clone(), carry[2].clone()))
            return carry

        return init, run_logged, fin

    monkeypatch.setattr(module, "bounded_stepper", recording)


def _jax_chunks(monkeypatch, log):
    """As `_chunks` for the JAX package, whose chunks run jitted: a host
    callback inside each one records its carry."""
    orig = jax_optimize.bounded_stepper

    def recording(*a, **kw):
        init, run, fin = orig(*a, **kw)

        def run_logged(carry, n):
            carry = run(carry, n)
            jax.debug.callback(lambda x, it: log.append((np.asarray(x), int(it))), carry[0], carry[2])
            return carry

        return init, run_logged, fin

    monkeypatch.setattr(jax_optimize, "bounded_stepper", recording)


@pytest.mark.parametrize("chunk", [1, 7, MAX_ITER])
@pytest.mark.parametrize("linesearch", ["zoom", "ladder"])
def test_chunked_equals_unchunked(gamma2_case, linesearch, chunk, monkeypatch):
    """Bit-equal results, and the loop ends at the first chunk that moved
    no instance: the early row stops at 15 (zoom) or 13 (ladder)."""
    obj, x0 = gamma2_case
    ref = optimize.minimize_bounded(obj, x0, max_iter=MAX_ITER, linesearch=linesearch)
    log = []
    _chunks(optimize, monkeypatch, log)
    got = optimize.minimize_bounded_chunked(obj, x0, max_iter=MAX_ITER, linesearch=linesearch,
                                            chunk=chunk)
    assert ref.n_iter.tolist() == [MAX_ITER, 15 if linesearch == "zoom" else 13]
    for name, g, r in zip(got._fields, got, ref):
        assert torch.equal(g, r), name
    its = [it.tolist() for _, it in log]
    assert its[-1] == ref.n_iter.tolist() and its[-2] == its[-1]
    assert len(its) == -(-MAX_ITER // chunk) + 1


@pytest.mark.parametrize("linesearch", ["zoom", "ladder"])
def test_chunked_builds_one_stepper_and_adds_no_evaluation(gamma2_case, linesearch, monkeypatch):
    """One `GraphedValueAndGrad` (on the card: one capture per shape) for
    the whole chunked run, and as many objective calls as the unchunked
    run (with "zoom", one more f(x) in finalize in both)."""
    obj, x0 = gamma2_case
    calls = []

    def counted(a):
        calls.append(a.shape)
        return obj(a)

    built = []

    class Counting(optimize.GraphedValueAndGrad):
        def __init__(self, fun):
            super().__init__(fun)
            built.append(self)

    monkeypatch.setattr(optimize, "GraphedValueAndGrad", Counting)
    optimize.minimize_bounded(counted, x0, max_iter=MAX_ITER, linesearch=linesearch)
    n_ref, built_ref = len(calls), len(built)
    calls.clear()
    built.clear()
    optimize.minimize_bounded_chunked(counted, x0, max_iter=MAX_ITER, linesearch=linesearch, chunk=7)
    assert len(calls) == n_ref and len(built) == built_ref == int(linesearch == "zoom")


def test_chunked_matches_jax(monkeypatch):
    """x64, chunk 7, max_iter 14 on the bounded Rosenbrock-type objective:
    the iterate after each chunk within 1e-10 of JAX's, the same iteration
    counts, and the same result."""
    x0 = np.random.default_rng(11).uniform(0.05, 0.95, D)
    kw = dict(lo=0.0, hi=0.99, max_iter=14, tol=1e-9, chunk=7)
    j_log, t_log = [], []
    _jax_chunks(monkeypatch, j_log)
    _chunks(optimize, monkeypatch, t_log)
    ref = jax_optimize.minimize_bounded_chunked(jax_rosen, jax.numpy.asarray(x0), **kw)
    got = optimize.minimize_bounded_chunked(torch_rosen, torch.as_tensor(x0[None]), **kw)
    assert [it for _, it in j_log] == [int(it[0]) for _, it in t_log] == [7, 14]
    for (jx, _), (tx, _) in zip(j_log, t_log):
        np.testing.assert_allclose(tx[0].numpy(), jx, rtol=0, atol=ATOL)
    np.testing.assert_allclose(got.x[0].numpy(), np.asarray(ref.x), rtol=0, atol=ATOL)
    np.testing.assert_allclose(float(got.fun[0]), float(ref.fun), rtol=1e-12)
    assert int(got.n_iter[0]) == int(ref.n_iter) == 14


def test_convergence_inside_the_first_chunk_stops(monkeypatch):
    """A run that converges (tol 1e-9) inside its first chunk of 50: both
    packages run that chunk and one more, which moves nothing, and stop,
    with max_iter 200 far away."""
    x0 = np.random.default_rng(12).uniform(0.05, 0.95, D)
    kw = dict(lo=0.0, hi=0.99, max_iter=200, tol=1e-9, chunk=50)
    j_log, t_log = [], []
    _jax_chunks(monkeypatch, j_log)
    _chunks(optimize, monkeypatch, t_log)
    ref = jax_optimize.minimize_bounded_chunked(jax_rosen, jax.numpy.asarray(x0), **kw)
    got = optimize.minimize_bounded_chunked(torch_rosen, torch.as_tensor(x0[None]), **kw)
    n = int(ref.n_iter)
    assert 0 < n < 50 and int(got.n_iter[0]) == n
    assert [it for _, it in j_log] == [int(it[0]) for _, it in t_log] == [n, n]
    np.testing.assert_allclose(got.x[0].numpy(), np.asarray(ref.x), rtol=0, atol=ATOL)


def test_lap_time_chunks_equal(ring):
    """`minimise_lap_time` (tbr18, the ring, "fused": the gradient on
    "assoc", the CLI's route) through chunks of 2 and of 50, 5 iterations:
    the same line bit for bit."""
    veh = load_vehicle(os.path.join(REPO_DATA, "vehicles", "tbr18.json"))
    short = racing_line.minimise_lap_time(ring, veh, max_iter=5, solver="fused", chunk=2)
    whole = racing_line.minimise_lap_time(ring, veh, max_iter=5, solver="fused")
    assert int(whole.n_iter) == 5 and torch.isfinite(whole.fun)
    for name, a, b in zip(whole._fields, short, whole):
        assert torch.equal(a, b), name

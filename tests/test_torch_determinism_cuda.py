"""Reproducibility of the port's seeded searches on the card.

The spline evaluation gathers interval data per sample, and many samples
share an interval; `torch.gather`'s own backward sums their adjoints with
atomic adds, whose order changes from run to run on a CUDA device, so the
same seed gave different lines.  `ops/spline._KnotGather` reduces them in
a fixed order on the card.  Here: the masked reduction against
scatter_add on the card; two seeded `nonlinear` runs bit-equal; the zoom
L-BFGS with its value and gradient replayed from a CUDA graph equal to the
eager run; and the velocity solver's row roll (`ops/velocity._roll_rows`, a
gather whose indices are a permutation of each row, so each destination
receives exactly one add) giving bit-equal gradients run after run.

Imports neither JAX nor the JAX package:

    python -m pytest --noconftest tests/test_torch_determinism_cuda.py -q

Without a CUDA device every case skips.
"""

import os

import numpy as np
import pytest
import torch

from lap_time_optimization_tpu_torch.models import load_vehicle
from lap_time_optimization_tpu_torch.ops import spline, velocity
from lap_time_optimization_tpu_torch.optim import global_search
from lap_time_optimization_tpu_torch.track import Track

REPO_DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "data")


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the atomics being replaced exist only there)")


def _setup(dtype):
    track = Track.load(os.path.join(REPO_DATA, "tracks", "buckmore.json"), 0.99).to("cuda", dtype)
    return track, load_vehicle(os.path.join(REPO_DATA, "vehicles", "tbr18.json")).to("cuda", dtype)


@pytest.mark.cuda
def test_masked_adjoint_equals_scatter_on_the_card():
    """float64, 16 rows of 846 samples over 44 intervals: the masked sum
    within 1e-12 of scatter_add, and bit-equal on a second run."""
    _need_cuda()
    gen = torch.Generator(device="cuda").manual_seed(3)
    j = torch.sort(torch.randint(0, 44, (16, 846), device="cuda", generator=gen), dim=-1)[0]
    g = torch.randn((16, 11, 846), device="cuda", dtype=torch.float64, generator=gen)
    a = spline.knot_adjoint(g, j, 44, masked=True)
    ref = spline.knot_adjoint(g, j, 44, masked=False)
    assert float((a - ref).abs().max()) <= 1e-12
    assert torch.equal(a, spline.knot_adjoint(g, j, 44, masked=True))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["float32", "float64"])
def test_seeded_nonlinear_is_bit_equal(dtype):
    """Two `nonlinear(seed=0)` runs at a small budget on the fused route:
    the same best line bit for bit, and the same lap."""
    _need_cuda()
    track, veh = _setup(dtype)
    runs = [global_search.nonlinear(track, veh, seed=0, n_random=64, n_refine=2, max_iter=10,
                                    solver="fused") for _ in range(2)]
    assert torch.equal(runs[0][0], runs[1][0]) and runs[0][1] == runs[1][1]
    assert np.isfinite(runs[0][1])


@pytest.mark.cuda
@pytest.mark.parametrize("objective", ["gamma2", "compromise", "laptime"])
def test_graphed_zoom_equals_eager(objective, monkeypatch):
    """The zoom L-BFGS with its value and gradient replayed from a CUDA
    graph against the eager calls (on cuSOLVER, as the capture), float32 on
    buckmore 0.99: the curvature objective for 20 iterations, the
    compromise over 16 ε for 10 (batched dense solves), and the lap-time
    objective ("assoc") for 3; the same iterates bit for bit."""
    _need_cuda()
    from lap_time_optimization_tpu_torch.ops import optimize
    from lap_time_optimization_tpu_torch.optim import racing_line

    track, veh = _setup(torch.float32)
    k = 1
    if objective == "gamma2":
        fun, iters = (lambda a: racing_line.gamma2_objective(track, a)), 20
    elif objective == "compromise":
        eps = torch.linspace(0.0, 0.2, 16, device="cuda")
        fun, iters, k = (lambda a: racing_line.compromise_objective(track, a, eps)), 10, 16
    else:
        fun, iters = (lambda a: racing_line.lap_time_of(track, veh, a, "assoc")), 3
    x0 = torch.full((k, track.size), 0.5, dtype=torch.float32, device="cuda")
    graphed = optimize.minimize_bounded(fun, x0, max_iter=iters)
    monkeypatch.setattr(optimize, "GraphedValueAndGrad",
                        lambda f: (lambda x: optimize._value_and_grad(f, x)))
    linalg = torch.backends.cuda.preferred_linalg_library()
    torch.backends.cuda.preferred_linalg_library("cusolver")
    try:
        eager = optimize.minimize_bounded(fun, x0, max_iter=iters)
    finally:
        torch.backends.cuda.preferred_linalg_library(linalg)
    assert int(graphed.n_iter.max()) == iters
    assert torch.equal(graphed.x, eager.x) and torch.equal(graphed.n_iter, eager.n_iter)


@pytest.mark.cuda
def test_roll_rows_gradient_is_bit_equal():
    """The roll's indices are a permutation of every row, and its gradient
    (through the whole sequential profile) is bit-equal over two runs."""
    _need_cuda()
    track, veh = _setup(torch.float64)
    alphas = torch.as_tensor(np.random.default_rng(5).uniform(0.0, 0.99, (4, track.n_decongested)),
                             device="cuda")
    n = track.ns - 1
    shift = torch.tensor([0, 1, 300, n - 1], device="cuda")
    idx = (torch.arange(n, device="cuda")[None, :] - shift[:, None]) % n
    assert torch.equal(torch.sort(idx, dim=-1)[0], torch.arange(n, device="cuda").expand(4, n))
    grads = []
    for _ in range(2):
        a = alphas.clone().requires_grad_(True)
        s, k, length = global_search._geometry(track, a)
        rolled = velocity._roll_rows(k, shift)
        v = velocity.solve_profile(veh, s[:, :-1], k, length, True)
        (g,) = torch.autograd.grad(velocity.lap_time(s, v).sum() + rolled.sum(), a)
        grads.append(g)
    assert torch.equal(grads[0], grads[1])

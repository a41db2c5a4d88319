"""Kernel 3 (`csrc/velocity.cu`) against its plain PyTorch twin, on the card.

Imports neither JAX nor the JAX package, so it also runs where only the
port is installed:

    python -m pytest --noconftest tests/test_torch_velocity_cuda.py -q

Inputs are the racing-line searches': 256 seeded candidate lines on
buckmore at width 0.99 through the batched tridiag spline fit, tbr18 and
MX5, closed (N=846), open (the first 300 samples) and a ragged B=160.
Tolerance: |kernel − twin| ≤ tol·max(1, |twin|), tol 1e-12 in float64 and
1e-5 in float32 (the kernel rounds every product on its own, as the twin's
separate ops do).  Without a CUDA device every case skips: the kernel has
no CPU mode.
"""

import os

import numpy as np
import pytest
import torch

from lap_time_optimization_tpu_torch.models import load_vehicle
from lap_time_optimization_tpu_torch.ops import spline, velocity_batch
from lap_time_optimization_tpu_torch.optim import global_search
from lap_time_optimization_tpu_torch.track import Track

REPO_DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "data")
TOL = {torch.float32: 1e-5, torch.float64: 1e-12}


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")


def _geometry(dtype, batch=256):
    track = Track.load(os.path.join(REPO_DATA, "tracks", "buckmore.json"), 0.99).to("cuda", dtype)
    alphas = np.random.default_rng(11).uniform(0.0, 0.99, (batch, track.n_decongested))
    with torch.no_grad():
        s, k, length = global_search._geometry(track, torch.as_tensor(alphas, dtype=dtype, device="cuda"),
                                               spline.FIT_METHOD_CLOSED_BATCHED)
    return s[:, :-1], k, length


def _check(veh, s, k, s_max, closed, dtype):
    launches = velocity_batch.LAUNCHES
    got = velocity_batch.solve_profile_batch(veh, s, k, s_max, closed)
    torch.cuda.synchronize()
    assert velocity_batch.LAUNCHES == launches + 1
    ref = velocity_batch.solve_profile_batch_reference(veh, s, k, s_max, closed)
    assert got.device.type == "cuda" and got.shape == ref.shape
    assert torch.equal(torch.isnan(got), torch.isnan(ref))
    fin = torch.isfinite(ref)
    assert float(((got - ref).abs()[fin] / ref.abs()[fin].clamp(min=1.0)).max()) <= TOL[dtype]


DTYPES = pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["float32", "float64"])
VEHICLES = pytest.mark.parametrize("name", ["tbr18", "MX5"])


@pytest.mark.cuda
@DTYPES
@VEHICLES
def test_cuda_velocity_kernel_closed(dtype, name):
    _need_cuda()
    s, k, length = _geometry(dtype)
    _check(load_vehicle(name).to("cuda", dtype), s, k, length, True, dtype)


@pytest.mark.cuda
@DTYPES
@VEHICLES
def test_cuda_velocity_kernel_open(dtype, name):
    _need_cuda()
    s, k, length = _geometry(dtype)
    _check(load_vehicle(name).to("cuda", dtype), s[:, :300], k[:, :300].contiguous(), length, False, dtype)


@pytest.mark.cuda
@DTYPES
def test_cuda_velocity_kernel_ragged_and_shared_s(dtype):
    """B=160 (five 32-row blocks), and one s row shared by every candidate."""
    _need_cuda()
    s, k, length = _geometry(dtype, batch=160)
    veh = load_vehicle("tbr18").to("cuda", dtype)
    _check(veh, s, k, length, True, dtype)
    _check(veh, s[0].contiguous(), k, length[0], True, dtype)

"""Kernel 3 (`csrc/velocity.cu`) against its plain PyTorch twin, on the card.

Imports neither JAX nor the JAX package, so it also runs where only the
port is installed:

    python -m pytest --noconftest tests/test_torch_velocity_cuda.py -q

Inputs are the racing-line searches': seeded candidate lines on buckmore at
width 0.99 through the batched tridiag spline fit, tbr18 and MX5, closed
(N=846), open (the first 300 samples), at B = 1, 128, 256, 1024 and a ragged
1030, with every segment count the wrapper takes (1 to 16) and one to four
candidates per block; one s row shared by every candidate and a strided
s_max; and hard rows (NaN curvature samples, a NaN distance, a row all NaN,
constant curvature where every sample ties, the minimum at sample 0 and at
N-1) at N = 17, 300 and 846, closed and open.  Tolerance: |kernel − twin| ≤
tol·max(1, |twin|), tol 1e-12 in float64 and 1e-5 in float32 (the kernel
rounds every product on its own, as the twin's separate ops do), and the
NaN positions equal.  The arrays' placements: forced into the global
scratch, the kernel gives the shared placement's bits on the rows above;
and on seeded synthetic circuits past the shared ceiling (N = 11,999 in
float32, 5,999 in float64; `track.synthetic_circuit`) it
meets the twin, run on the CPU with numpy's correctly rounded sqrt (as the
card's), at the same tolerances.  Without a CUDA device every case skips:
the kernel has no CPU mode.
"""

import os

import numpy as np
import pytest
import torch

from lap_time_optimization_tpu_torch.models import load_vehicle
from lap_time_optimization_tpu_torch.ops import spline, velocity_batch
from lap_time_optimization_tpu_torch.optim import global_search
from lap_time_optimization_tpu_torch.track import Track, synthetic_circuit
from lap_time_optimization_tpu_torch.utils import profiling
from test_torch_velocity_schedule import hard_rows

REPO_DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "data")
TOL = {torch.float32: 1e-5, torch.float64: 1e-12}
ALL_SEGMENTS = range(1, velocity_batch.MAX_SEGMENTS + 1)


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


def _agrees(got, ref, dtype):
    assert got.device.type == "cuda" and got.shape == ref.shape
    assert torch.equal(torch.isnan(got), torch.isnan(ref))
    fin = torch.isfinite(ref)
    assert float(((got - ref).abs()[fin] / ref.abs()[fin].clamp(min=1.0)).max()) <= TOL[dtype]


def _check(veh, s, k, s_max, closed, dtype, segments=(None,), warps=(None,)):
    """The wrapper (one launch, counted) and `_launch` at every segment count
    and block shape asked for, each against one twin run."""
    launches = profiling.counts()["velocity_batch.launch"]
    got = velocity_batch.solve_profile_batch(veh, s, k, s_max, closed)
    torch.cuda.synchronize()
    assert profiling.counts()["velocity_batch.launch"] == launches + 1
    ref = velocity_batch.solve_profile_batch_reference(veh, s, k, s_max, closed)
    _agrees(got, ref, dtype)
    for P in segments:
        for W in warps:
            _agrees(velocity_batch._launch(veh, s, k, s_max, closed, warps=W, segments=P), ref, dtype)


DTYPES = pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["float32", "float64"])
VEHICLES = pytest.mark.parametrize("name", ["tbr18", "MX5"])


@pytest.mark.cuda
@DTYPES
@VEHICLES
def test_cuda_velocity_kernel_closed(dtype, name):
    _need_cuda()
    s, k, length = _geometry(dtype)
    _check(load_vehicle(name).to("cuda", dtype), s, k, length, True, dtype, ALL_SEGMENTS)


@pytest.mark.cuda
@DTYPES
@VEHICLES
def test_cuda_velocity_kernel_open(dtype, name):
    _need_cuda()
    s, k, length = _geometry(dtype)
    _check(load_vehicle(name).to("cuda", dtype), s[:, :300], k[:, :300].contiguous(), length, False, dtype,
           ALL_SEGMENTS)


@pytest.mark.cuda
@DTYPES
def test_cuda_velocity_kernel_ragged_and_shared_s(dtype):
    """B=160, one s row shared by every candidate, and a strided s_max."""
    _need_cuda()
    s, k, length = _geometry(dtype, batch=160)
    veh = load_vehicle("tbr18").to("cuda", dtype)
    _check(veh, s, k, length, True, dtype)
    _check(veh, s[0].contiguous(), k, length[0], True, dtype, (1, 4, 16))
    every_other = torch.stack([length, length], dim=1).reshape(-1)[::2]  # stride 2
    assert every_other.stride(0) == 2
    _check(veh, s, k, every_other, True, dtype, (1, 4, 16))


@pytest.mark.cuda
@DTYPES
@pytest.mark.parametrize("batch", [1, 128, 256, 1024, 1030])
def test_cuda_velocity_kernel_batch_sizes(dtype, batch):
    """The searches' batches (Bayesian init 128, a round 256, the selection
    1024), B=1 and a ragged 1030, at every segment count and block shape."""
    _need_cuda()
    s, k, length = _geometry(dtype, batch=batch)
    warps = range(1, velocity_batch.MAX_WARPS + 1)
    _check(load_vehicle("tbr18").to("cuda", dtype), s, k, length, True, dtype, ALL_SEGMENTS, warps)


@pytest.mark.cuda
@DTYPES
@pytest.mark.parametrize("closed", [True, False], ids=["closed", "open"])
@pytest.mark.parametrize("N", [17, 300, 846])
def test_cuda_velocity_kernel_hard_rows(dtype, closed, N):
    _need_cuda()
    s, k, length = hard_rows(*_geometry(dtype, batch=8), N)
    for name in ("tbr18", "MX5"):
        _check(load_vehicle(name).to("cuda", dtype), s, k, length, closed, dtype, ALL_SEGMENTS,
               range(1, velocity_batch.MAX_WARPS + 1))


@pytest.mark.cuda
@DTYPES
@VEHICLES
def test_cuda_velocity_global_scratch_is_the_shared_placement(dtype, name):
    """On buckmore's rows (N=846) the arrays sit in shared memory; forced
    into the global scratch, every segment count and block shape gives the
    same bits."""
    _need_cuda()
    s, k, length = _geometry(dtype)
    veh = load_vehicle(name).to("cuda", dtype)
    for closed, n in ((True, k.shape[1]), (False, 300)):
        kn = k[:, :n].contiguous()
        for P in (1, 4, 16):
            for W in range(1, velocity_batch.MAX_WARPS + 1):
                shared = velocity_batch._launch(veh, s[:, :n], kn, length, closed, warps=W, segments=P)
                forced = velocity_batch._launch(veh, s[:, :n], kn, length, closed, warps=W, segments=P,
                                                force_global=True)
                assert torch.equal(forced, shared), (closed, P, W)


def _cpu_twin(name, s, k, s_max, closed):
    """The twin on CPU copies with numpy's square root, which is correctly
    rounded as the card's is (see `solve_profile_batch_reference`)."""
    veh = load_vehicle(name).to("cpu", k.dtype)
    return velocity_batch.solve_profile_batch_reference(
        veh, s.cpu(), k.cpu(), s_max.cpu(), closed,
        sqrt=lambda x: torch.from_numpy(np.asarray(np.sqrt(x.numpy()))))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype, ns", [(torch.float32, 12000), (torch.float64, 6000)], ids=["float32", "float64"])
def test_cuda_velocity_kernel_past_the_shared_ceiling(dtype, ns):
    """A seeded synthetic circuit sampled once a metre, past the shared
    placement's ceiling (N = 11,622 in float32, 5,811 in float64): the
    global scratch against the twin, closed and open, both vehicles."""
    _need_cuda()
    track = Track.from_cones(*synthetic_circuit(ns), 0.99, name="synthetic").to("cuda", dtype)
    alphas = np.random.default_rng(11).uniform(0.1, 0.9, (4, track.n_decongested))
    with torch.no_grad():
        s, k, length = global_search._geometry(track, torch.as_tensor(alphas, dtype=dtype, device="cuda"),
                                               spline.FIT_METHOD_CLOSED_BATCHED)
    s = s[:, :-1]
    assert velocity_batch.smem_bytes(dtype, 1, k.shape[1]) == 0
    for name in ("tbr18", "MX5"):
        veh = load_vehicle(name).to("cuda", dtype)
        for closed in (True, False):
            launches = profiling.counts()["velocity_batch.launch"]
            got = velocity_batch.solve_profile_batch(veh, s, k, length, closed)
            assert profiling.counts()["velocity_batch.launch"] == launches + 1
            _agrees(got, _cpu_twin(name, s, k, length, closed).to("cuda"), dtype)

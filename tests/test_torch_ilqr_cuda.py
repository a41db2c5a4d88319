"""The hand-written CUDA iLQR kernels against their plain PyTorch twins, on the card.

Imports neither JAX nor the JAX package, so it also runs where only the
port is installed:

    python -m pytest --noconftest tests/test_torch_ilqr_cuda.py -q

Inputs are the main path's (MX5 on buckmore, horizon 10, 6 ladder rungs,
2 RK4 substeps, 846 table samples) at one iterate of a solve from the
reference state with seeded steering and multipliers; the batch kernel's
are 32 such states spread over the lap (the last 3 m before the seam, at
speeds from 4 to 12 m/s) with reg from 1e-6 to 1e2.  Tolerance:
|kernel − twin| ≤ tol·max(1, |twin|), tol 1e-10 in float64 and 1e-4 in
float32 (libdevice trig and the summation order differ).  Without a CUDA
device every case skips: the kernels have no CPU mode.
"""

import os

import numpy as np
import pytest
import torch

from lap_time_optimization_tpu_torch.models import load_vehicle
from lap_time_optimization_tpu_torch.models.bicycle import BicycleModel
from lap_time_optimization_tpu_torch.mpc import runner
from lap_time_optimization_tpu_torch.mpc import solver as S
from lap_time_optimization_tpu_torch.mpc import track as mpc_track
from lap_time_optimization_tpu_torch.ops import ilqr

REPO_DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "data")
TOL = {torch.float32: 1e-4, torch.float64: 1e-10}


BATCH = 32


def _inputs(dtype, tv, te, seed=1, batch=None):
    """The kernels' arguments (all but reg_b) at one (batch=None) or
    `batch` states, and the RK4 substeps."""
    device = torch.device("cuda")
    track = mpc_track.load("MX-5", "buckmore", "curvature", base_dir=REPO_DATA)
    model = BicycleModel(load_vehicle("MX5"), track, enable_torque_vectoring=tv,
                         enable_traction_ellipse=te).to(device, dtype)
    p = S.OCPParams.reference(dtype, device, lateral_margin=0.05)
    cfg = S.SolverConfig(horizon=10)
    rng = np.random.default_rng(seed)
    t = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype, device=device)
    x0 = runner.X0_REFERENCE
    if batch is not None:
        s_max = float(track.s_max)
        x0 = np.tile(x0, (batch, 1))
        x0[:, 0] = np.linspace(0.0, s_max, batch, endpoint=False)
        x0[-1, 0] = s_max - 3.0
        x0[:, 3] = np.linspace(4.0, 12.0, batch)
    lead = x0.shape[:-1]
    z0 = t(np.concatenate([x0, np.zeros(lead + (2,))], axis=-1))
    us = t(np.stack([rng.normal(0.0, 0.3, lead + (cfg.horizon,)),
                     np.full(lead + (cfg.horizon,), 0.05)], axis=-1))
    lams = t(rng.uniform(0.0, 2.0, lead + (cfg.horizon + 1, S.n_con(model))))
    zs = S._rollout(model, cfg, z0, us)
    rho, reg = t(cfg.rho_init), t(cfg.reg_init)
    args = [*S._kernel_inputs(model, p, cfg, zs, us, lams, rho), zs, us, lams,
            ilqr.tables_matrix(model), ilqr.ladder(cfg.n_linesearch, dtype, device),
            ilqr.scal_vector(model, p, cfg, rho, reg)]
    return [a.contiguous() for a in args], cfg.substeps


def _assert_close(got, ref, dtype):
    for g, r in zip(got, ref):
        assert g.device.type == "cuda" and g.shape == r.shape
        assert float(((g - r).abs() / r.abs().clamp(min=1.0)).max()) <= TOL[dtype]


CASES = pytest.mark.parametrize("tv, te", [(False, False), (False, True), (True, False)],
                                ids=["n_con14", "n_con16", "torque_vectoring"])
DTYPES = pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["float32", "float64"])


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")


@pytest.mark.cuda
@CASES
@DTYPES
def test_cuda_kernel_matches_twin(dtype, tv, te):
    _need_cuda()
    args, substeps = _inputs(dtype, tv, te)
    assert args[11].shape[1] == (16 if te else 14)
    launches = ilqr.LAUNCHES
    got = ilqr.backward_forward(*args, substeps=substeps)
    torch.cuda.synchronize()
    assert ilqr.LAUNCHES == launches + 1
    _assert_close(got, ilqr.backward_forward_reference(*args, substeps=substeps), dtype)


@pytest.mark.cuda
@CASES
@DTYPES
def test_cuda_batch_kernel_matches_twin(dtype, tv, te):
    _need_cuda()
    args, substeps = _inputs(dtype, tv, te, batch=BATCH)
    reg_b = torch.logspace(-6, 2, BATCH, dtype=dtype, device="cuda")
    launches, single = ilqr.BATCH_LAUNCHES, ilqr.LAUNCHES
    got = ilqr.backward_forward_batch(*args, reg_b, substeps=substeps)
    torch.cuda.synchronize()
    assert (ilqr.BATCH_LAUNCHES, ilqr.LAUNCHES) == (launches + 1, single)
    ref = ilqr.backward_forward_batch_reference(*args, reg_b, substeps=substeps)
    _assert_close(got, ref, dtype)
    assert torch.equal(got[3], ref[3])


@pytest.mark.cuda
@DTYPES
def test_cuda_batch_kernel_is_the_one_ocp_kernel_per_instance(dtype):
    """Instance b of the batch kernel equals the one-OCP kernel run on
    instance b with reg = reg_b[b]: the whole table is in every block, so
    there is no window edge to clamp at."""
    _need_cuda()
    args, substeps = _inputs(dtype, True, False, batch=BATCH)
    reg_b = torch.logspace(-6, 2, BATCH, dtype=dtype, device="cuda")
    got = ilqr.backward_forward_batch(*args, reg_b, substeps=substeps)
    scal = args[14]
    for b in range(BATCH):
        one = ilqr.backward_forward(*(a[b].contiguous() for a in args[:12]), *args[12:14],
                                    torch.cat([scal[:1], reg_b[b:b + 1], scal[2:]]),
                                    substeps=substeps)
        _assert_close([g[b] for g in got], one, dtype)

"""The hand-written CUDA iLQR kernel against its plain PyTorch twin, on the card.

Imports neither JAX nor the JAX package, so it also runs where only the
port is installed:

    python -m pytest --noconftest tests/test_torch_ilqr_cuda.py -q

Inputs are the main path's (MX5 on buckmore, horizon 10, 6 ladder rungs,
2 RK4 substeps, 846 table samples) at one iterate of a solve from the
reference state with seeded steering and multipliers.  Tolerance:
|kernel − twin| ≤ tol·max(1, |twin|), tol 1e-10 in float64 and 1e-4 in
float32 (libdevice trig and the summation order differ).  Without a CUDA
device every case skips: the kernel has no CPU mode.
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


def _inputs(dtype, tv, te, seed=1):
    device = torch.device("cuda")
    track = mpc_track.load("MX-5", "buckmore", "curvature", base_dir=REPO_DATA)
    model = BicycleModel(load_vehicle("MX5"), track, enable_torque_vectoring=tv,
                         enable_traction_ellipse=te).to(device, dtype)
    p = S.OCPParams.reference(dtype, device, lateral_margin=0.05)
    cfg = S.SolverConfig(horizon=10)
    rng = np.random.default_rng(seed)
    t = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype, device=device)
    z0 = t(np.concatenate([runner.X0_REFERENCE, np.zeros(2)]))
    us = t(np.stack([rng.normal(0.0, 0.3, cfg.horizon), np.full(cfg.horizon, 0.05)], axis=1))
    lams = t(rng.uniform(0.0, 2.0, (cfg.horizon + 1, S.n_con(model))))
    zs = S._rollout(model, cfg, z0, us)
    rho, reg = t(cfg.rho_init), t(cfg.reg_init)
    A, B = S._linearize_joint(model, cfg, zs, us)
    quads = S._quads_gauss_newton(model, p, zs[:-1], us, lams[:-1], rho)
    Vz, Vzz = S._terminal_quads_gauss_newton(model, p, zs[-1], lams[-1], rho)
    args = [A, B, *quads, Vz, Vzz, zs, us, lams, ilqr.tables_matrix(model),
            ilqr.ladder(cfg.n_linesearch, dtype, device), ilqr.scal_vector(model, p, cfg, rho, reg)]
    return [a.contiguous() for a in args], cfg.substeps


@pytest.mark.cuda
@pytest.mark.parametrize("tv, te", [(False, False), (False, True), (True, False)],
                         ids=["n_con14", "n_con16", "torque_vectoring"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["float32", "float64"])
def test_cuda_kernel_matches_twin(dtype, tv, te):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    args, substeps = _inputs(dtype, tv, te)
    assert args[11].shape[1] == (16 if te else 14)
    launches = ilqr.LAUNCHES
    got = ilqr.backward_forward(*args, substeps=substeps)
    torch.cuda.synchronize()
    assert ilqr.LAUNCHES == launches + 1
    ref = ilqr.backward_forward_reference(*args, substeps=substeps)
    for g, r in zip(got, ref):
        assert g.device.type == "cuda" and g.shape == r.shape
        assert float(((g - r).abs() / r.abs().clamp(min=1.0)).max()) <= TOL[dtype]

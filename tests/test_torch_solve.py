"""The solve wrapper's plain path and the packed constants, on the CPU.

* The plain solve (`ops.ilqr.solve_reference`, what `solver.solve` runs on
  CPU tensors) against the JAX package's `solve` on the XLA path in
  float64, at `SolverConfig.for_horizon(20)`: the long-horizon preset
  (ρ 200 → 400) whose numbers the CUDA kernel takes as arguments.
  Tolerance 1e-9, as tests/test_torch_closed_loop_batch.py holds a float64
  solve.
* The constants (`ops.ilqr.pack`) are packed once per closed loop and
  passed down: a solve with a pack equals a solve that packs its own, a
  loop packs once, and two loops whose models differ only in a flag each
  read their own pack (there is no cache that outlives a call).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lap_time_optimization_tpu.mpc import runner as jax_runner
from lap_time_optimization_tpu.mpc import solver as JS
from lap_time_optimization_tpu_torch.mpc import runner, solver as TS
from lap_time_optimization_tpu_torch.ops import ilqr
from lap_time_optimization_tpu_torch.utils import profiling
from test_torch_closed_loop_batch import _pair
from test_torch_ilqr import base  # noqa: F401  (fixture)


@pytest.mark.parametrize("n_con", [14, 16])
def test_plain_solve_matches_jax_long_horizon(base, n_con):  # noqa: F811
    jm, jp, tm, tp = _pair(base, "float64", te=(n_con == 16))
    rng = np.random.default_rng(5)
    z0 = np.concatenate([jax_runner.X0_REFERENCE, np.zeros(2)])
    z0[0] = 0.43 * float(base[1].s_max)
    us = np.stack([rng.normal(0.0, 0.2, 20), np.full(20, 0.05)], axis=1)
    lams = rng.uniform(0.0, 1.0, (21, n_con))
    cfg_j = JS.SolverConfig.for_horizon(20)
    cfg_t = TS.SolverConfig.for_horizon(20)
    assert (cfg_t.rho_init, cfg_t.rho_scale) == (cfg_j.rho_init, cfg_j.rho_scale) == (200.0, 2.0)
    ref = JS.solve(jm, jp, cfg_j, *map(jnp.asarray, (z0, us, lams)))
    launches = profiling.counts()["ilqr.solve"]
    got = TS.solve(tm, tp, cfg_t, *map(torch.from_numpy, (z0, us, lams)))
    assert profiling.counts()["ilqr.solve"] == launches
    for name in TS.SolveResult._fields:
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(ref, name)),
                                   rtol=1e-9, atol=1e-9, err_msg=name)


def test_solve_with_a_pack_equals_solve_without(base):  # noqa: F811
    _, _, tm, tp = _pair(base, "float64", tv=True, te=True)
    cfg = TS.SolverConfig(horizon=10, al_iters=1, ilqr_iters=2)
    z0 = torch.from_numpy(np.concatenate([jax_runner.X0_REFERENCE, np.zeros(2)]))
    us, lams = torch.full((10, 2), 0.05, dtype=torch.float64), torch.zeros(11, 16, dtype=torch.float64)
    pk = ilqr.pack(tm, tp, cfg)
    got = TS.solve(tm, tp, cfg, z0, us, lams, pack=pk)
    ref = TS.solve(tm, tp, cfg, z0, us, lams)
    assert all(torch.equal(g, r) for g, r in zip(got, ref))
    got_b = TS.solve_batch(tm, tp, cfg, z0[None], us[None], lams[None], pack=pk)
    assert all(torch.allclose(g[0], r, rtol=1e-12, atol=1e-12) for g, r in zip(got_b, ref))


def test_each_loop_packs_its_own_once(base, monkeypatch):  # noqa: F811
    """closed_loop packs once per call; with torque vectoring toggled, each
    loop's pack carries its own model's gain, and each loop equals the same
    cycles run with a pack built per solve."""
    packs = []
    pack = ilqr.pack

    def record(model, p, cfg):
        packs.append((model, pack(model, p, cfg)))
        return packs[-1][1]

    cfg = TS.SolverConfig(horizon=10, al_iters=1, ilqr_iters=2)
    x0 = torch.from_numpy(jax_runner.X0_REFERENCE.copy())
    results = {}
    for tv in (True, False):
        _, _, tm, tp = _pair(base, "float64", tv=tv)
        monkeypatch.setattr(ilqr, "pack", record)
        before = len(packs)
        results[tv] = runner.closed_loop(tm, tp, cfg, x0, 2)
        assert len(packs) == before + 1 and packs[-1][0] is tm
        ptv = float(packs[-1][1].scal_tail[-1])
        assert ptv == (float(tm.vehicle.ptv) if tv else 0.0)
        monkeypatch.setattr(ilqr, "pack", pack)
        out = runner._empty_result(x0, 2)
        runner._advance(tm, tp, cfg, runner._presolve(tm, tp, cfg, x0), out, 0, 2)
        assert all(torch.equal(a, b) for a, b in zip(results[tv], out))
    assert float(packs[0][1].scal_tail[-1]) != 0.0
    assert not torch.equal(results[True].xs, results[False].xs)

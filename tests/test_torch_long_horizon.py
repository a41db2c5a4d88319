"""Long horizons and long ladders, on the CPU.

The solve kernel takes any horizon and any number of line-search rungs, as
the JAX package does: past one block's shared memory (horizon 160 in
float32, 79 in float64, at 6 rungs) its growing arrays move to a global
workspace, and past 32 rungs a lane runs several rungs in turn.  The kernel
itself runs only on the card (tests/test_torch_ilqr_cuda.py); here

* the plain solve (`ops.ilqr.solve_reference`, what `solver.solve` runs on
  CPU tensors) is held against the JAX package's `solve` on the XLA path in
  float64 at those sizes: horizon 170, past the old float32 ceiling, with
  14 and 16 constraint rows, and 40 rungs at horizon 10, with one AL round
  of two iLQR iterations to keep it cheap.  Tolerance 1e-9, as
  tests/test_torch_solve.py holds a float64 solve;
* the wrapper's checks (`ops.ilqr._check_solve`, run before anything is
  built) take 33 rungs and horizon 1000 and still refuse 0 rungs.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lap_time_optimization_tpu.mpc import runner as jax_runner
from lap_time_optimization_tpu.mpc import solver as JS
from lap_time_optimization_tpu_torch.mpc import solver as TS
from lap_time_optimization_tpu_torch.ops import ilqr
from lap_time_optimization_tpu_torch.utils import profiling
from test_torch_closed_loop_batch import _pair
from test_torch_ilqr import base  # noqa: F401  (fixture)

TOL = 1e-9


def _inputs(s_max, horizon, n_con, seed=5):
    """(z0, us, lams) of one OCP from the reference state at 43% of the lap,
    with seeded steering and multipliers, as numpy float64 arrays."""
    rng = np.random.default_rng(seed)
    z0 = np.concatenate([jax_runner.X0_REFERENCE, np.zeros(2)])
    z0[0] = 0.43 * s_max
    us = np.stack([rng.normal(0.0, 0.2, horizon), np.full(horizon, 0.05)], axis=1)
    lams = rng.uniform(0.0, 1.0, (horizon + 1, n_con))
    return z0, us, lams


@pytest.mark.parametrize("horizon, n_linesearch, n_con", [(170, 6, 14), (170, 6, 16), (10, 40, 14)],
                         ids=["N170-14rows", "N170-16rows", "L40"])
def test_plain_solve_matches_jax(base, horizon, n_linesearch, n_con):  # noqa: F811
    jm, jp, tm, tp = _pair(base, "float64", te=(n_con == 16))
    args = _inputs(float(base[1].s_max), horizon, n_con)
    sizes = dict(horizon=horizon, n_linesearch=n_linesearch, al_iters=1, ilqr_iters=2)
    ref = JS.solve(jm, jp, JS.SolverConfig(**sizes, backend="xla"), *map(jnp.asarray, args))
    cfg = TS.SolverConfig(**sizes)
    pk = ilqr.pack(tm, tp, cfg)
    assert pk.alphas.shape == (n_linesearch,)
    assert ilqr._check_solve(cfg, *map(torch.from_numpy, args), pk) == ()
    launches = profiling.counts()["ilqr.solve"]
    got = TS.solve(tm, tp, cfg, *map(torch.from_numpy, args), pack=pk)
    assert profiling.counts()["ilqr.solve"] == launches
    assert got.us.shape == (horizon, 2) and got.lam.shape == (horizon + 1, n_con)
    for name in TS.SolveResult._fields:
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(ref, name)),
                                   rtol=TOL, atol=TOL, err_msg=name)


@pytest.mark.parametrize("horizon, n_linesearch, refused", [(10, 33, False), (1000, 6, False), (10, 0, True)],
                         ids=["L33", "N1000", "L0"])
def test_kernel_checks_take_any_horizon_and_ladder(horizon, n_linesearch, refused):
    """No horizon or ladder bound is left in the checks but a rung count
    below 1; nothing is built to check (the library stays unloaded)."""
    cfg = TS.SolverConfig(horizon=horizon, n_linesearch=n_linesearch)
    z0 = torch.zeros(10, dtype=torch.float64)
    us = torch.zeros(horizon, 2, dtype=torch.float64)
    lams = torch.zeros(horizon + 1, 14, dtype=torch.float64)
    pk = ilqr.Pack(torch.zeros(4, 846, dtype=torch.float64),
                   ilqr.ladder(n_linesearch, torch.float64, "cpu"),
                   torch.zeros(ilqr.NS - 2, dtype=torch.float64))
    if refused:
        with pytest.raises(ValueError, match="unsupported sizes"):
            ilqr._check_solve(cfg, z0, us, lams, pk)
    else:
        assert ilqr._check_solve(cfg, z0, us, lams, pk) == ()
    batch = ilqr._check_solve(dataclasses.replace(cfg, n_linesearch=max(n_linesearch, 1)),
                              z0.expand(3, 10).contiguous(), us.expand(3, horizon, 2).contiguous(),
                              lams.expand(3, horizon + 1, 14).contiguous(),
                              pk._replace(alphas=ilqr.ladder(max(n_linesearch, 1), torch.float64, "cpu")))
    assert batch == (3,)
    assert ilqr._lib is None

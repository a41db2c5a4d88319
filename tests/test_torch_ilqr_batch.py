"""Parity of the batch iLQR iteration's plain PyTorch twin with the JAX package.

`ops.ilqr.backward_forward_batch_reference` (the batch iteration of the
plain solve that `csrc/ilqr.cu`'s solve kernel is held against) gets the JAX side's own linearisation and
quadratics for three instances at s = 0, 0.43·s_max and s_max − 3 (the
last rolls over the lap seam), at different speeds, each with its own
Levenberg reg.  It is held against:

* the JAX package's Pallas batch kernel in interpret mode
  (`pallas_ilqr_batch.backward_forward_batch`), whose rollouts stay inside
  its per-instance table window here, so the two compute the same
  trajectories;
* the one-OCP twin run on each instance with that instance's reg;
* two places where the port reads the whole table and the JAX kernel's
  window does not give `MPCTrack._uinterp`, so the port follows the JAX
  XLA path (`vmap(solve)`) instead: a window too short for the rollouts,
  where the JAX kernel clamps its lookups at the window edge, and the last
  table cell, where the window wraps the vref table as if its sample n-1
  were sample 0 (it is for k, NL and NR, not for vref).  Both divergences
  are by design.

The comparisons run in float64 with 14 constraint rows (each
interpret-mode compile of the JAX kernel takes ~15 s on the CPU; the
float32 and 16-row batch paths are held to the JAX package by
test_torch_closed_loop_batch.py), at the tolerance of
tests/test_pallas_ilqr.py: 1e-11 for the trajectories, ten times that
(relative) for the cost.  The CUDA solve kernel itself runs only on a
GPU: test_torch_ilqr_cuda.py holds it against the plain solve there.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lap_time_optimization_tpu.models.bicycle import BicycleModel as JaxBicycle
from lap_time_optimization_tpu.mpc import runner as jax_runner
from lap_time_optimization_tpu.mpc import solver as JS
from lap_time_optimization_tpu.ops import pallas_ilqr as PK
from lap_time_optimization_tpu.ops import pallas_ilqr_batch as PKB
from lap_time_optimization_tpu_torch.mpc import solver as TS
from lap_time_optimization_tpu_torch.ops import ilqr
from lap_time_optimization_tpu_torch.utils import convert
from test_torch_ilqr import DTYPES, _numpy_fields, _solve_case, base  # noqa: F401  (fixture)

REG_B = (1e-6, 1e-2, 10.0)


@functools.partial(jax.jit, static_argnames=("cfg",))
def _jax_side(jm, jp, cfg, z0_b, us_b, lams_b, rho):
    """The batch kernel's per-instance inputs, as `solver._iterate_pallas_batch`
    builds them (solver.py:648-656)."""
    zs_b = jax.vmap(lambda z0, us: JS._rollout(jm, cfg, z0, us))(z0_b, us_b)
    A, B = jax.vmap(lambda zs, us: JS._linearize_joint(jm, cfg, zs, us))(zs_b, us_b)
    quads = jax.vmap(lambda zs, us, lams: jax.vmap(
        lambda z, u, lam: JS._quads_gauss_newton(jm, jp, z, u, lam, rho))(zs[:-1], us, lams[:-1])
    )(zs_b, us_b, lams_b)
    Vz, Vzz = jax.vmap(
        lambda zs, lams: JS._terminal_quads_gauss_newton(jm, jp, zs[-1], lams[-1], rho))(zs_b, lams_b)
    return zs_b, (A, B, *quads, Vz, Vzz)


_CASES = {}


def _case(base, dtype_name, te=False):
    """JAX model/params in `dtype`, and the batch kernel's inputs for three
    instances on both sides (the port's as CPU tensors); built once per
    (dtype, te)."""
    if (dtype_name, te) not in _CASES:
        _CASES[dtype_name, te] = _build_case(base, dtype_name, te)
    return _CASES[dtype_name, te]


def _build_case(base, dtype_name, te):
    jdt, tdt, tol = DTYPES[dtype_name]
    cast = lambda tree: jax.tree.map(
        lambda a: a.astype(jdt) if jnp.issubdtype(a.dtype, jnp.floating) else a, tree)
    veh, track = cast(base[0]), cast(base[1])
    jm = JaxBicycle(vehicle=veh, track=track, enable_traction_ellipse=te)
    jp = JS.OCPParams.reference(jdt, lateral_margin=0.05)
    tm = convert.model_from_numpy(_numpy_fields(veh), _numpy_fields(track),
                                  enable_traction_ellipse=te)
    tp = convert.ocp_params_from_numpy(_numpy_fields(jp))
    cfg = JS.SolverConfig(horizon=10, backend="xla")
    s_max = float(track.s_max)
    x0 = np.tile(jax_runner.X0_REFERENCE, (3, 1))
    x0[:, 0] = [0.0, 0.43 * s_max, s_max - 3.0]
    x0[:, 3] = [5.0, 7.0, 9.0]
    rng = np.random.default_rng(7)
    us = np.stack([rng.normal(0.0, 0.3, (3, 10)), np.full((3, 10), 0.05)], axis=-1)
    lams = rng.uniform(0.0, 2.0, (3, 11, JS.n_con(jm)))
    z0 = np.concatenate([x0, np.zeros((3, 2))], axis=1)
    rho = jnp.asarray(cfg.rho_init, jdt)
    zs, kernel_inputs = _jax_side(jm, jp, cfg, *(jnp.asarray(a, jdt) for a in (z0, us, lams)), rho)
    jax_args = (*kernel_inputs, zs, jnp.asarray(us, jdt), jnp.asarray(lams, jdt))
    t = lambda a: torch.from_numpy(np.array(a))
    tcfg = TS.SolverConfig(horizon=10)
    scal = ilqr.scal_vector(tm, tp, tcfg, t(rho), t(np.asarray(0.0, jdt)))
    inputs = [t(a) for a in jax_args] + [ilqr.tables_matrix(tm), ilqr.ladder(6, tdt, "cpu"), scal]
    reg_b = np.asarray(REG_B, jdt)
    return dict(jm=jm, jp=jp, cfg=cfg, jax_args=jax_args, rho=rho, inputs=inputs,
                reg_b=reg_b, tol=tol)


def _jax_kernel(c, **kw):
    jm, cfg = c["jm"], c["cfg"]
    dtype = c["jax_args"][0].dtype
    alphas = (10.0 ** jnp.linspace(0.0, -2.5, cfg.n_linesearch)).astype(dtype)
    return PKB.backward_forward_batch(
        *c["jax_args"], PK.tables_matrix(jm, dtype), alphas,
        PK.scal_vector(jm, c["jp"], cfg, c["rho"], 0.0, dtype), jnp.asarray(c["reg_b"]),
        N=cfg.horizon, L=cfg.n_linesearch, substeps=cfg.substeps, interpret=True, **kw)


def _twin(c):
    return ilqr.backward_forward_batch_reference(*c["inputs"], torch.from_numpy(c["reg_b"]),
                                                 substeps=2)


def _xla_al_cost(c, zs, us):
    """The JAX XLA path's AL cost of each instance's trajectory."""
    jm, jp, cfg, lams = c["jm"], c["jp"], c["cfg"], c["jax_args"][11]
    return np.asarray(jax.vmap(lambda z, u, lam: JS._total_al_cost(jm, jp, cfg, z, u, lam, c["rho"]))(
        zs, us, lams))


def test_batch_twin_matches_pallas_interpret(base):  # noqa: F811
    """(a) In-window inputs: the port's twin gives the JAX batch kernel's
    trajectories and `ok`, and its cost on the two instances whose rollouts
    stay off the last table cell; the third instance's cost is held to
    the XLA path's AL cost of the same trajectory (see the module note)."""
    c = _case(base, "float64")
    dtype = c["jax_args"][0].dtype
    np.testing.assert_array_equal(c["inputs"][12].numpy(), np.asarray(PK.tables_matrix(c["jm"], dtype)))
    got = _twin(c)
    zs, us, cost, ok = _jax_kernel(c)
    tol = c["tol"]
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(ok))
    assert np.all(np.asarray(ok) == 1.0)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(zs), rtol=tol, atol=tol)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(us), rtol=tol, atol=tol)
    np.testing.assert_allclose(got[2].numpy()[:2], np.asarray(cost)[:2], rtol=10 * tol)
    np.testing.assert_allclose(got[2].numpy()[2], _xla_al_cost(c, zs, us)[2], rtol=10 * tol)


@pytest.mark.parametrize("n_con", [14, 16])
def test_batch_twin_is_one_ocp_twin_per_instance(base, n_con):  # noqa: F811
    """(b) Instance b of the batch twin is the one-OCP twin at reg_b[b]
    (float64; only the summation order of batched products differs)."""
    c = _case(base, "float64", te=(n_con == 16))
    got = _twin(c)
    inputs, scal = c["inputs"], c["inputs"][14]
    for b, reg in enumerate(c["reg_b"]):
        scal_b = torch.cat([scal[:1], torch.tensor([reg], dtype=scal.dtype), scal[2:]])
        one = ilqr.backward_forward_reference(*(a[b] for a in inputs[:12]), *inputs[12:14], scal_b,
                                              substeps=2)
        for g, r in zip(got, one):
            np.testing.assert_allclose(g[b].numpy(), r.numpy(), rtol=1e-12, atol=1e-12)


def test_short_window_diverges_by_design(base):  # noqa: F811
    """(c) With a 16-sample window (it ends at each instance's own s) the
    JAX kernel clamps every forward lookup at the window edge; the port
    reads the whole table and keeps what the in-window JAX kernel gives."""
    c = _case(base, "float64")
    got = _twin(c)
    full = _jax_kernel(c)
    short = _jax_kernel(c, W=16)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(full[0]), rtol=1e-11, atol=1e-11)
    gap = np.abs(np.asarray(short[0]) - got[0].numpy()).max(axis=(1, 2))
    assert np.all(gap > 1e-6), gap


def test_last_table_cell_diverges_by_design(base):  # noqa: F811
    """The third instance's rollout crosses the last table cell.  There the
    JAX kernel's window reads vref[0] for vref[n-1]; the port and the XLA
    path read vref[n-1], and their AL costs agree."""
    c = _case(base, "float64")
    vref = c["inputs"][12][3]
    assert float(vref[-1]) != float(vref[0])
    got = _twin(c)
    zs, us, cost, _ = _jax_kernel(c)
    assert float(zs[2, 0, 0]) < float(c["jm"].track.s_max) < float(zs[2, -1, 0])
    np.testing.assert_allclose(got[2].numpy(), _xla_al_cost(c, zs, us), rtol=1e-12)
    assert abs(float(cost[2]) - float(got[2][2])) > 1e-3


def test_batch_dispatch_and_checks(base):  # noqa: F811
    """The solve wrapper on a batch: CPU tensors take the plain solve
    (the batch iteration twin inside); the kernel's checks reject what it
    does not take before anything is built."""
    tm, tp, cfg, pk, (z0, us, lams) = _solve_case(base, (3,))
    got = ilqr.solve(tm, tp, cfg, z0, us, lams, pk)
    ref = ilqr.solve_reference(tm, tp, cfg, z0, us, lams, pk)
    assert got[3].shape == (3,) and all(torch.equal(g, r) for g, r in zip(got, ref))
    assert ilqr._check_solve(cfg, z0, us, lams, pk) == (3,)
    with pytest.raises(ValueError, match="us_init: shape"):
        ilqr._check_solve(cfg, z0, us[:2].contiguous(), lams, pk)
    with pytest.raises(ValueError, match="lam_init: shape"):
        ilqr._check_solve(cfg, z0, us, lams[:, :10].contiguous(), pk)
    with pytest.raises(ValueError, match="alphas: shape"):
        ilqr._check_solve(cfg, z0, us, lams, pk._replace(alphas=pk.alphas[:5].contiguous()))
    with pytest.raises(ValueError, match="z0: shape"):
        ilqr._check_solve(cfg, z0[None], us, lams, pk)
    with pytest.raises(ValueError, match="scal_tail: torch.float32"):
        ilqr._check_solve(cfg, z0, us, lams, pk._replace(scal_tail=pk.scal_tail.float()))
    assert ilqr._lib is None

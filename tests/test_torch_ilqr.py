"""Parity of the fused iLQR iteration's plain PyTorch twin with the JAX package.

`ops.ilqr.backward_forward_reference` (the iteration of the plain solve
that `csrc/ilqr.cu`'s solve kernel is held against) gets the JAX side's
own linearisation and quadratics, and is held here against the JAX package's XLA path for the same iteration
(`_forward_pass(_backward_pass(...))`), and in test_torch_ilqr_pallas.py
against its Pallas kernel in interpret mode.  Tolerances are
those of tests/test_pallas_ilqr.py: 1e-11 in float64 and 1e-5 in float32
for the trajectories, ten times that (relative) for the cost; the sums run
in another order.  The CUDA solve kernel itself runs only on a GPU:
test_torch_ilqr_cuda.py holds it against the plain solve there.
"""

import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lap_time_optimization_tpu.models import load_vehicle as jax_load_vehicle
from lap_time_optimization_tpu.models.bicycle import BicycleModel as JaxBicycle
from lap_time_optimization_tpu.mpc import runner as jax_runner
from lap_time_optimization_tpu.mpc import solver as JS
from lap_time_optimization_tpu.mpc import track as jax_track
from lap_time_optimization_tpu.ops import pallas_ilqr as PK
from lap_time_optimization_tpu_torch.mpc import solver as TS
from lap_time_optimization_tpu_torch.ops import ilqr
from lap_time_optimization_tpu_torch.utils import convert

REPO_DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "data")
DTYPES = {"float32": (jnp.float32, torch.float32, 1e-5), "float64": (jnp.float64, torch.float64, 1e-11)}


def _numpy_fields(obj) -> dict:
    return {f.name: np.asarray(getattr(obj, f.name)) for f in dataclasses.fields(obj)}


@pytest.fixture(scope="module")
def base():
    if not os.path.isdir(os.path.join(REPO_DATA, "plots", "MX-5", "buckmore", "curvature")):
        pytest.skip("shipped curvature artifacts not available")
    veh = jax_load_vehicle(os.path.join(REPO_DATA, "vehicles", "MX5.json"))
    track = jax_track.load("MX-5", "buckmore", "curvature", base_dir=REPO_DATA)
    return veh, track


@functools.partial(jax.jit, static_argnames=("cfg",))
def _jax_side(jm, jp, cfg, z0, us, lams, rho, reg):
    """One compiled program: the rollout, the kernel's inputs, and the XLA
    path's iteration (`_forward_pass(_backward_pass(...))`) as reference."""
    zs = JS._rollout(jm, cfg, z0, us)
    A, B = JS._linearize_joint(jm, cfg, zs, us)
    quads = jax.vmap(lambda z, u, lam: JS._quads_gauss_newton(jm, jp, z, u, lam, rho))(zs[:-1], us, lams[:-1])
    Vz, Vzz = JS._terminal_quads_gauss_newton(jm, jp, zs[-1], lams[-1], rho)
    ks, Ks, _ = JS._backward_pass(jm, jp, cfg, zs, us, lams, rho, reg)
    return zs, (A, B, *quads, Vz, Vzz), JS._forward_pass(jm, jp, cfg, zs, us, ks, Ks, lams, rho)


def _case(base, dtype_name, tv=False, te=False):
    """JAX model/params in `dtype`, the port's twins of them, and the
    kernel's inputs at the first iteration of a solve from the reference
    state (seeded steering), computed on the JAX side."""
    jdt, tdt, tol = DTYPES[dtype_name]
    cast = lambda tree: jax.tree.map(
        lambda a: a.astype(jdt) if jnp.issubdtype(a.dtype, jnp.floating) else a, tree)
    veh, track = cast(base[0]), cast(base[1])
    jm = JaxBicycle(vehicle=veh, track=track, enable_torque_vectoring=tv, enable_traction_ellipse=te)
    jp = JS.OCPParams.reference(jdt, lateral_margin=0.05)
    tm = convert.model_from_numpy(_numpy_fields(veh), _numpy_fields(track),
                                  enable_torque_vectoring=tv, enable_traction_ellipse=te)
    tp = convert.ocp_params_from_numpy(_numpy_fields(jp))
    cfg = JS.SolverConfig(horizon=10, backend="xla")
    rng = np.random.default_rng(11)
    us = jnp.asarray(np.stack([rng.normal(0.0, 0.3, 10), np.full(10, 0.05)], axis=1), jdt)
    lams = jnp.asarray(rng.uniform(0.0, 2.0, (11, JS.n_con(jm))), jdt)
    z0 = jnp.concatenate([jnp.asarray(jax_runner.X0_REFERENCE, jdt), jnp.zeros(2, jdt)])
    rho, reg = jnp.asarray(cfg.rho_init, jdt), jnp.asarray(1e-6, jdt)
    zs, kernel_inputs, xla = _jax_side(jm, jp, cfg, z0, us, lams, rho, reg)
    t = lambda a: torch.from_numpy(np.array(a))
    tcfg = TS.SolverConfig(horizon=10)
    inputs = [t(a) for a in (*kernel_inputs, zs, us, lams)] + [
        ilqr.tables_matrix(tm), ilqr.ladder(tcfg.n_linesearch, tdt, "cpu"),
        ilqr.scal_vector(tm, tp, tcfg, t(rho), t(reg))]
    return dict(jm=jm, jp=jp, cfg=cfg, zs=zs, us=us, lams=lams, rho=rho, reg=reg,
                kernel_inputs=kernel_inputs, inputs=inputs, tol=tol, xla=xla)


def assert_close(got, ref, tol):
    zs, us, cost = got[:3]
    np.testing.assert_allclose(zs.numpy(), np.asarray(ref[1]), rtol=tol, atol=tol)
    np.testing.assert_allclose(us.numpy(), np.asarray(ref[2]), rtol=tol, atol=tol)
    np.testing.assert_allclose(float(cost), float(ref[0]), rtol=10 * tol)


def check_packing(c):
    """The packed tables and scalars are the JAX kernel's, ptv appended
    (XLA's division may round (n-1)/s_max one ulp apart)."""
    dtype = c["zs"].dtype
    np.testing.assert_array_equal(c["inputs"][12].numpy(), np.asarray(PK.tables_matrix(c["jm"], dtype)))
    np.testing.assert_allclose(
        c["inputs"][14][:PK.NS].numpy(),
        np.asarray(PK.scal_vector(c["jm"], c["jp"], c["cfg"], c["rho"], c["reg"], dtype))[0],
        rtol=2 * float(np.finfo(dtype).eps))


@pytest.mark.parametrize("n_con", [14, 16])
@pytest.mark.parametrize("dtype_name", ["float32", "float64"])
def test_twin_matches_xla(base, dtype_name, n_con):
    c = _case(base, dtype_name, te=(n_con == 16))
    assert c["inputs"][11].shape == (11, n_con)
    check_packing(c)
    got = ilqr.backward_forward_reference(*c["inputs"], substeps=c["cfg"].substeps)
    assert float(got[3]) == 1.0
    assert_close(got, c["xla"], c["tol"])


def test_twin_with_torque_vectoring_matches_xla(base):
    """Torque vectoring on, in float64: held against the XLA path only, since
    the JAX kernel's rollout drops the Mtv term."""
    c = _case(base, "float64", tv=True)
    assert float(c["inputs"][14][ilqr.NS - 1]) == float(c["jm"].vehicle.ptv) != 0.0
    got = ilqr.backward_forward_reference(*c["inputs"], substeps=c["cfg"].substeps)
    assert_close(got, c["xla"], c["tol"])


def test_twin_lookup_matches_uinterp(base):
    """The lookups the twin (and the kernel) read from the packed tables
    equal MPCTrack._uinterp on s ∈ [-10, 2·s_max], both lap wraps included."""
    c = _case(base, "float64")
    track = base[1]
    model, _, _ = ilqr._views(c["inputs"][14], c["inputs"][12], 14)
    s = np.linspace(-10.0, 2.0 * float(track.s_max), 997)
    for row, fn in enumerate(("curvature", "dist_left", "dist_right", "v_ref")):
        got = getattr(model.track, fn)(torch.as_tensor(s)).numpy()
        ref = np.asarray(track._uinterp(jnp.asarray(s), PK.tables_matrix(c["jm"], jnp.float64)[row]))
        np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-13, err_msg=fn)


def _solve_case(base, lead=()):
    """The port's float64 model, parameters, config and pack, and a warm
    start (z0, us_init, lam_init) with leading shape `lead`, on the CPU."""
    veh, track = base
    tm = convert.model_from_numpy(_numpy_fields(veh), _numpy_fields(track))
    tp = TS.OCPParams.reference(torch.float64, lateral_margin=0.05)
    cfg = TS.SolverConfig(horizon=10, al_iters=1, ilqr_iters=2)
    x0 = np.tile(jax_runner.X0_REFERENCE, lead + (1,))
    z0 = torch.from_numpy(np.concatenate([x0, np.zeros(lead + (2,))], axis=-1))
    us = torch.full(lead + (10, 2), 0.05, dtype=torch.float64)
    lams = torch.zeros(lead + (11, 14), dtype=torch.float64)
    return tm, tp, cfg, ilqr.pack(tm, tp, cfg), (z0, us, lams)


def test_backward_forward_dispatch_and_checks(base):
    """The solve wrapper on one OCP: CPU tensors take the plain solve (the
    iteration twins inside); the kernel's checks reject what it does not
    take before anything is built."""
    tm, tp, cfg, pk, (z0, us, lams) = _solve_case(base)
    got = ilqr.solve(tm, tp, cfg, z0, us, lams, pk)
    ref = ilqr.solve_reference(tm, tp, cfg, z0, us, lams, pk)
    assert len(got) == 5 and all(torch.equal(g, r) for g, r in zip(got, ref))
    assert ilqr._check_solve(cfg, z0, us, lams, pk) == ()
    with pytest.raises(ValueError, match="constraint count"):
        ilqr._check_solve(cfg, z0, us, torch.zeros(11, 15, dtype=torch.float64), pk)
    with pytest.raises(ValueError, match="us_init: shape"):
        ilqr._check_solve(cfg, z0, us[:9].contiguous(), lams, pk)
    with pytest.raises(ValueError, match="contiguous"):
        ilqr._check_solve(cfg, z0, us.t().contiguous().t(), lams, pk)
    with pytest.raises(TypeError, match="float32 or float64"):
        ilqr._check_solve(cfg, z0.half(), us, lams, pk)
    # any ladder length runs (past 32 rungs a lane runs several); none is refused
    assert ilqr._check_solve(dataclasses.replace(cfg, n_linesearch=33), z0, us, lams,
                             pk._replace(alphas=ilqr.ladder(33, torch.float64, "cpu"))) == ()
    with pytest.raises(ValueError, match="unsupported sizes"):
        ilqr._check_solve(dataclasses.replace(cfg, n_linesearch=0), z0, us, lams,
                          pk._replace(alphas=ilqr.ladder(0, torch.float64, "cpu")))
    with pytest.raises(NotImplementedError, match="hessian_mode"):
        ilqr._check_solve(dataclasses.replace(cfg, hessian_mode="exact"), z0, us, lams, pk)
    assert ilqr._lib is None

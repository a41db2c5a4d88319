"""Exact Hessians and the `accurate()` preset of the port against the JAX package.

* `SolverConfig.accurate` has JAX's fields.
* The exact quadraticisation (`solver._quads_exact`, `_terminal_quads_exact`:
  gradient and Hessian of the AL stage and terminal costs by `torch.func`)
  against JAX's `_quads_exact` and the exact terminal of `_backward_pass`
  (jax.grad / jax.hessian) at seeded states, float64, rtol 1e-10 (with an
  absolute floor of 1e-10 times the largest entry).  At λ + ρg = 0 the PHR
  term's derivative splits one half each way in both packages (`jnp.maximum`,
  `torch.maximum`), so a tied row adds ρ/4 · ∇g∇gᵀ to the Hessian, a
  fully active one ρ · ∇g∇gᵀ: the tie case is held to JAX's value.
* Exact-mode `solve` (horizon 4 and 10) and `solve_batch` (B=2) against JAX's
  XLA path in float64, tolerance 1e-10 on max |d| / max(1, |ref|) per output
  (`-s` prints the worst reading: 7.5e-13 at most when written).
* `accurate()` (Gauss-Newton) against JAX's in float64 at 1e-9, as
  tests/test_torch_solve.py holds the long-horizon preset.
* The solve kernel takes `accurate()`'s sizes and refuses exact mode.
"""

import dataclasses

import jax
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

RHO = 20.0
SOLVE_TOL = 1e-10


def _states(s_max, n, seed):
    """(z (n, NZ), u (n, NU), lam (n, 16)) at seeded states along the lap."""
    rng = np.random.default_rng(seed)
    x = np.stack([rng.uniform(0.0, s_max, n), rng.uniform(-0.3, 0.3, n), rng.uniform(-0.2, 0.2, n),
                  rng.uniform(3.0, 12.0, n), rng.uniform(-0.5, 0.5, n), rng.uniform(-0.5, 0.5, n),
                  rng.uniform(-0.3, 0.3, n), rng.uniform(-0.5, 0.9, n)], axis=1)
    z = np.concatenate([x, rng.uniform(-0.3, 0.3, (n, 2))], axis=1)
    return z, rng.uniform(-0.5, 0.5, (n, 2)), rng.uniform(0.0, 2.0, (n, 16))


@jax.jit
def _jax_quads(jm, jp, z, u, lam, rho):
    stage = jax.vmap(lambda z_, u_, l_: JS._quads_exact(jm, jp, z_, u_, l_, rho))(z, u, lam)
    tc = lambda l_: (lambda zz: JS.al_terminal_cost(jm, jp, zz, l_, rho))
    term = jax.vmap(lambda z_, l_: (jax.grad(tc(l_))(z_), jax.hessian(tc(l_))(z_)))(z, lam)
    return stage, term


def _torch_quads(tm, tp, z, u, lam, rho):
    t = lambda a: torch.as_tensor(np.asarray(a))
    rho = torch.tensor(rho, dtype=torch.float64)
    stage = TS._quads_exact(tm, tp, t(z), t(u), t(lam), rho)
    return stage, TS._terminal_quads_exact(tm, tp, t(z), t(lam), rho)


def _close(got, ref, rtol, label):
    got, ref = got.numpy(), np.asarray(ref)
    assert got.shape == ref.shape, label
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=rtol * max(1.0, float(np.abs(ref).max())),
                               err_msg=label)


def test_accurate_fields_equal_jax():
    for horizon in (10, 20):
        j, t = JS.SolverConfig.accurate(horizon), TS.SolverConfig.accurate(horizon)
        for f in dataclasses.fields(t):
            assert getattr(t, f.name) == getattr(j, f.name), f.name
    assert (t.substeps, t.al_iters, t.ilqr_iters, t.n_linesearch, t.rho_init, t.rho_scale) == (4, 4, 8, 8, 10.0, 5.0)


@pytest.mark.parametrize("te", [False, True])
def test_exact_quads_match_jax(base, te):  # noqa: F811
    jm, jp, tm, tp = _pair(base, "float64", tv=True, te=te)
    n_con = 16 if te else 14
    z, u, lam = _states(float(base[1].s_max), 6, seed=1 + te)
    lam = lam[:, :n_con]
    ref = _jax_quads(jm, jp, *map(jnp.asarray, (z, u, lam)), jnp.asarray(RHO))
    got = _torch_quads(tm, tp, z, u, lam, RHO)
    for label, g, r in zip(("lz", "lu", "lzz", "luu", "luz"), got[0], ref[0]):
        _close(g, r, 1e-10, label)
    for label, g, r in zip(("Vz", "Vzz"), got[1], ref[1]):
        _close(g, r, 1e-10, label)


def test_exact_quads_at_a_tie(base):  # noqa: F811
    """λ = −ρg on the box rows 3-9 (μ, vx, δ, throttle: the same arithmetic
    in both packages) with ρ = 16, a power of two, so ρg is exact and
    λ + ρg is exactly 0 in both, whether or not XLA contracts it into a
    fused multiply-add: the Hessian equals JAX's, and a tied row adds one
    quarter of what it adds when active."""
    rho = 16.0
    jm, jp, tm, tp = _pair(base, "float64")
    z, u, lam = _states(float(base[1].s_max), 3, seed=4)
    lam = np.zeros((3, 14))
    x = z[:, :8]
    p = {k: float(np.asarray(getattr(jp, k))) for k in ("mu_max", "steer_max", "throttle_max")}
    g = np.stack([x[:, 2] - p["mu_max"], -x[:, 2] - p["mu_max"], -x[:, 3],
                  x[:, 6] - p["steer_max"], -x[:, 6] - p["steer_max"],
                  x[:, 7] - p["throttle_max"], -x[:, 7] - p["throttle_max"]], axis=1)
    lam[:, 3:10] = -(rho * g)
    assert np.all(lam[:, 3:10] + rho * g == 0.0) and np.all(lam[:, 3:10] > 0.0)
    ref = _jax_quads(jm, jp, *map(jnp.asarray, (z, u, lam)), jnp.asarray(rho))
    got = _torch_quads(tm, tp, z, u, lam, rho)
    for label, gg, r in zip(("lz", "lu", "lzz", "luu", "luz"), got[0], ref[0]):
        _close(gg, r, 1e-10, f"tie {label}")
    # the same states with the box rows pushed just inside the active side
    active = _torch_quads(tm, tp, z, u, lam * (1.0 + 1e-9), rho)[0][2]
    tied = got[0][2]
    for i in (2, 3, 6, 7):  # μ, vx, δ, throttle: d g/d x_i = ±1 on their rows
        rows = 1 if i == 3 else 2
        np.testing.assert_allclose((active - tied)[:, i, i].numpy(), 0.75 * rho * rows, rtol=1e-9)


def _solve_inputs(s_max, horizon, n_con, lead=(), seed=0):
    rng = np.random.default_rng(seed)
    x0 = np.tile(jax_runner.X0_REFERENCE, lead + (1,))
    x0[..., 0] = s_max * (np.linspace(0.1, 0.6, lead[0]) if lead else 0.43)
    z0 = np.concatenate([x0, np.zeros(lead + (2,))], axis=-1)
    us = np.stack([rng.normal(0.0, 0.2, lead + (horizon,)), np.full(lead + (horizon,), 0.05)], axis=-1)
    return z0, us, rng.uniform(0.0, 1.0, lead + (horizon + 1, n_con))


def _assert_solve(got, ref, tol, label):
    worst = {}
    for name in TS.SolveResult._fields:
        g, r = getattr(got, name).numpy(), np.asarray(getattr(ref, name))
        assert g.shape == r.shape, name
        worst[name] = float((np.abs(g - r) / np.maximum(np.abs(r), 1.0)).max())
    print(f"{label}: max |d|/max(1,|ref|) " + ", ".join(f"{k} {v:.2e}" for k, v in worst.items())
          + f" (tol {tol:g})")
    assert max(worst.values()) <= tol, worst


@pytest.mark.parametrize("horizon", [4, 10])
def test_exact_solve_matches_jax(base, horizon):  # noqa: F811
    jm, jp, tm, tp = _pair(base, "float64", te=True)
    args = _solve_inputs(float(base[1].s_max), horizon, 16)
    ref = JS.solve(jm, jp, JS.SolverConfig(horizon=horizon, hessian_mode="exact", backend="xla"),
                   *map(jnp.asarray, args))
    launches = profiling.counts()["ilqr.solve"]
    got = TS.solve(tm, tp, TS.SolverConfig(horizon=horizon, hessian_mode="exact"),
                   *map(torch.from_numpy, args))
    assert profiling.counts()["ilqr.solve"] == launches
    _assert_solve(got, ref, SOLVE_TOL, f"exact solve h{horizon}")


def test_exact_solve_batch_matches_jax(base):  # noqa: F811
    jm, jp, tm, tp = _pair(base, "float64")
    args = _solve_inputs(float(base[1].s_max), 10, 14, lead=(2,), seed=3)
    ref = JS.solve_batch(jm, jp, JS.SolverConfig(horizon=10, hessian_mode="exact", backend="xla"),
                         *map(jnp.asarray, args))
    got = TS.solve_batch(tm, tp, TS.SolverConfig(horizon=10, hessian_mode="exact"),
                         *map(torch.from_numpy, args))
    _assert_solve(got, ref, SOLVE_TOL, "exact solve_batch B=2")


def test_accurate_solve_matches_jax(base):  # noqa: F811
    jm, jp, tm, tp = _pair(base, "float64")
    args = _solve_inputs(float(base[1].s_max), 10, 14, seed=5)
    ref = JS.solve(jm, jp, dataclasses.replace(JS.SolverConfig.accurate(), backend="xla"),
                   *map(jnp.asarray, args))
    got = TS.solve(tm, tp, TS.SolverConfig.accurate(), *map(torch.from_numpy, args))
    _assert_solve(got, ref, 1e-9, "accurate() solve")


def test_kernel_takes_accurate_and_refuses_exact(base):  # noqa: F811
    _, _, tm, tp = _pair(base, "float64")
    cfg = TS.SolverConfig.accurate()
    z0, us, lams = (torch.from_numpy(a) for a in _solve_inputs(float(base[1].s_max), 10, 14))
    pk = ilqr.pack(tm, tp, cfg)
    assert ilqr._check_solve(cfg, z0, us, lams, pk) == ()
    with pytest.raises(NotImplementedError, match="Gauss-Newton only.*plain path"):
        ilqr._check_solve(dataclasses.replace(cfg, hessian_mode="exact"), z0, us, lams, pk)
    with pytest.raises(ValueError, match="hessian_mode"):
        TS.solve(tm, tp, dataclasses.replace(cfg, hessian_mode="newton"), z0, us, lams)

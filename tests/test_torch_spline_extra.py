"""The port's trigonometric and tension spline bases (`ops/spline_extra.py`)
and the spline-basis comparison CLI (`cli/simplify.py`) against the JAX
package's, in float64 on the CPU.

The oracle cases of tests/test_spline_extra.py run on the port (exact
interpolation at the control sites, finite-difference derivatives, the
uniformly sampled circle reproduced exactly, the cubic spline as the τ→0
limit, high tension tightening toward the polygon), and the same numpy
points go through both packages.  Tolerances: fits and evaluations within
1e-9 absolute of JAX (coordinates ~10 m; the tension fit is a dense solve
of the moment system, whose LAPACK path differs between the packages),
curvature energy, arc length and gradients within 1e-9 relative, and the
CLI's metrics on buckmore within 1e-9 relative (lap 1e-8: tbr18's friction
circle, tests/test_torch_velocity.py).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lap_time_optimization_tpu.models import load_vehicle as jax_load_vehicle
from lap_time_optimization_tpu.ops import spline_extra as jax_extra
from lap_time_optimization_tpu.track import Track as JaxTrack
from lap_time_optimization_tpu_torch.cli import simplify
from lap_time_optimization_tpu_torch.ops import spline, spline_extra

REPO_DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "data")
FIT_ATOL, RTOL, LAP_RTOL = 1e-9, 1e-9, 1e-8


def circle_points(n, r=10.0):
    th = np.linspace(0.0, 2 * np.pi, n + 1)
    return np.stack([r * np.cos(th), r * np.sin(th)])


def wiggle_points(n=40, closed=True, seed=3):
    rng = np.random.default_rng(seed)
    th = np.linspace(0.0, 2 * np.pi, n, endpoint=False)
    r = 10.0 + rng.normal(0, 0.8, n)
    pts = np.stack([r * np.cos(th), r * np.sin(th)])
    if closed:
        pts = np.concatenate([pts, pts[:, :1]], axis=1)
    return pts


def _t(x):
    return torch.as_tensor(np.asarray(x), dtype=torch.float64)


def fd_check(ev, sp, u0, der, eps=1e-6, tol=1e-4):
    lo = ev(sp, _t(u0 - eps), der - 1)
    hi = ev(sp, _t(u0 + eps), der - 1)
    np.testing.assert_allclose(ev(sp, _t(u0), der).numpy(), ((hi - lo) / (2 * eps)).numpy(),
                               rtol=tol, atol=tol)


def _fit(kind, pts, closed, tension=0.7):
    if kind == "trig":
        return spline_extra.trig_fit(_t(pts), closed), jax_extra.trig_fit(jnp.asarray(pts), closed)
    return (spline_extra.tension_fit(_t(pts), closed, tension=tension),
            jax_extra.tension_fit(jnp.asarray(pts), closed, tension=tension))


class TestTrigSpline:
    def test_interpolates_closed(self):
        pts = wiggle_points(closed=True)
        sp = spline_extra.trig_fit(_t(pts), closed=True)
        np.testing.assert_allclose(spline_extra.trig_evaluate(sp, sp.nodes, 0).numpy(), pts, atol=1e-8)

    def test_interpolates_open(self):
        pts = wiggle_points(closed=False)[:, :17]
        sp = spline_extra.trig_fit(_t(pts), closed=False)
        np.testing.assert_allclose(spline_extra.trig_evaluate(sp, sp.nodes, 0).numpy(), pts, atol=1e-7)

    def test_exact_on_uniform_circle(self):
        r = 7.5
        sp = spline_extra.trig_fit(_t(circle_points(24, r=r)), closed=True)
        u = torch.linspace(0.0, float(sp.length), 257, dtype=torch.float64)
        pos = spline_extra.trig_evaluate(sp, u, 0).numpy()
        np.testing.assert_allclose(np.hypot(pos[0], pos[1]), r, rtol=1e-9)
        np.testing.assert_allclose(spline_extra.curvature(sp, u).numpy(), 1.0 / r, rtol=1e-8)

    def test_derivatives_match_fd(self):
        sp = spline_extra.trig_fit(_t(wiggle_points(closed=True)), closed=True)
        u0 = np.linspace(1.0, float(sp.length) - 1.0, 9)
        fd_check(spline_extra.trig_evaluate, sp, u0, der=1)
        fd_check(spline_extra.trig_evaluate, sp, u0, der=2, tol=1e-3)


class TestTensionSpline:
    def test_interpolates_both_topologies(self):
        for closed in (True, False):
            pts = wiggle_points(closed=closed)
            sp = spline_extra.tension_fit(_t(pts), closed=closed, tension=0.7)
            got = spline_extra.tension_evaluate(sp, spline.chord_lengths(_t(pts)), 0)
            np.testing.assert_allclose(got.numpy(), pts, atol=1e-8)

    def test_tau_to_zero_is_cubic(self):
        pts = _t(wiggle_points(closed=True))
        cub = spline.fit(pts, closed=True)
        ten = spline_extra.tension_fit(pts, closed=True, tension=1e-4)
        u = torch.linspace(0.0, float(cub.length), 201, dtype=torch.float64)
        np.testing.assert_allclose(spline_extra.tension_evaluate(ten, u, 0).numpy(),
                                   spline.evaluate(cub, u, 0).numpy(), atol=1e-6)
        np.testing.assert_allclose(spline_extra.tension_evaluate(ten, u, 1).numpy(),
                                   spline.evaluate(cub, u, 1).numpy(), atol=1e-5)

    def test_high_tension_tightens_to_polygon(self):
        pts = _t([[0, 1, 2, 3, 4, 5, 6, 7], [0, 1, -1, 1, -1, 1, -1, 0]])
        cub = spline.fit(pts, closed=False)
        ten = spline_extra.tension_fit(pts, closed=False, tension=8.0)
        u = torch.linspace(0.0, float(cub.length), 400, dtype=torch.float64)
        over_cub = float(torch.clamp_min(spline.evaluate(cub, u, 0)[1].abs() - 1.0, 0.0).max())
        over_ten = float(torch.clamp_min(spline_extra.tension_evaluate(ten, u, 0)[1].abs() - 1.0, 0.0).max())
        assert over_ten < 0.25 * over_cub

    def test_second_derivative_is_moment(self):
        sp = spline_extra.tension_fit(_t(wiggle_points(closed=True)), closed=True, tension=0.5)
        np.testing.assert_allclose(spline_extra.tension_evaluate(sp, sp.tk[:-1], 2).numpy(), sp.zj.numpy(),
                                   atol=1e-8)

    def test_derivatives_match_fd(self):
        sp = spline_extra.tension_fit(_t(wiggle_points(closed=True)), closed=True, tension=1.2)
        u0 = sp.tk[:-1].numpy()[3:8] + 0.37
        fd_check(spline_extra.tension_evaluate, sp, u0, der=1)
        fd_check(spline_extra.tension_evaluate, sp, u0, der=2, tol=1e-3)

    def test_bad_derivative_order_raises(self):
        sp = spline_extra.tension_fit(_t(wiggle_points(closed=True)), closed=True)
        with pytest.raises(ValueError, match="der"):
            spline_extra.tension_evaluate(sp, sp.tk[:3], 3)


@pytest.mark.parametrize("kind", ["trig", "tension"])
@pytest.mark.parametrize("closed", [True, False], ids=["closed", "open"])
def test_matches_jax(kind, closed):
    """Fit, evaluation at der 0-2 (off the nodes and across the seam),
    curvature, Γ² and arc length of the same points in both packages."""
    pts = wiggle_points(closed=closed)
    if kind == "trig" and not closed:
        pts = pts[:, :17]
    got, ref = _fit(kind, pts, closed)
    fields = ("coeffs", "nodes") if kind == "trig" else ("zj", "zj1", "h", "tk")
    for name in fields:
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(ref, name)),
                                   rtol=0, atol=FIT_ATOL, err_msg=name)
    # open: inside the ends, where the mirror extension's tangent vanishes
    length = float(ref.length)
    u = np.linspace(0.0, length, 333) + 0.25 if closed else np.linspace(0.02, 0.98, 333) * length
    ev_t, ev_j = ((spline_extra.trig_evaluate, jax_extra.trig_evaluate) if kind == "trig"
                  else (spline_extra.tension_evaluate, jax_extra.tension_evaluate))
    for der in (0, 1, 2):
        np.testing.assert_allclose(ev_t(got, _t(u), der).numpy(), np.asarray(ev_j(ref, jnp.asarray(u), der)),
                                   rtol=0, atol=FIT_ATOL * 10 ** der, err_msg=f"der {der}")
    np.testing.assert_allclose(spline_extra.curvature(got, _t(u), signed=True).numpy(),
                               np.asarray(jax_extra.curvature(ref, jnp.asarray(u), signed=True)),
                               rtol=RTOL, atol=1e-12)
    np.testing.assert_allclose(float(spline_extra.gamma2(got, _t(u))),
                               float(jax_extra.gamma2(ref, jnp.asarray(u))), rtol=RTOL)
    np.testing.assert_allclose(float(spline_extra.arc_length(got, _t(u))),
                               float(jax_extra.arc_length(ref, jnp.asarray(u))), rtol=RTOL)


@pytest.mark.parametrize("kind", ["trig", "tension"])
def test_gradient_matches_jax(kind):
    """d Γ²/d points through the fit and the evaluation (autograd vs
    jax.grad), closed, at a fixed sample grid."""
    pts = wiggle_points(closed=True)
    u = np.linspace(0.1, 60.0, 200)
    fit_t = spline_extra.trig_fit if kind == "trig" else spline_extra.tension_fit
    fit_j = jax_extra.trig_fit if kind == "trig" else jax_extra.tension_fit
    p = _t(pts).requires_grad_(True)
    (g,) = torch.autograd.grad(spline_extra.gamma2(fit_t(p, True), _t(u)), p)
    ref = jax.grad(lambda q: jax_extra.gamma2(fit_j(q, True), jnp.asarray(u)))(jnp.asarray(pts))
    scale = float(np.abs(np.asarray(ref)).max())
    np.testing.assert_allclose(g.numpy(), np.asarray(ref), rtol=0, atol=RTOL * scale)


class TestSimplifyCLI:
    """`cli/simplify.py --all --device cpu --dtype float64` on buckmore
    (width 0.8) with tbr18 against the JAX package's `analyse_basis`."""

    @pytest.fixture(scope="class")
    def results(self, tmp_path_factory):
        out = tmp_path_factory.mktemp("simplify")
        track, veh = (os.path.join(REPO_DATA, "tracks", "buckmore.json"),
                      os.path.join(REPO_DATA, "vehicles", "tbr18.json"))
        argv = [track, veh, "0.8", "--all", "--device", "cpu", "--dtype", "float64",
                "--output-dir", str(out)]
        try:
            import matplotlib  # noqa: F401
            argv.append("--plot-path")
        except ImportError:
            pass
        res = simplify.main(argv)
        from lap_time_optimization_tpu.cli import simplify as jax_simplify

        jtrack, jveh = JaxTrack.load(track, track_width=0.8), jax_load_vehicle(veh)
        ref = [jax_simplify.analyse_basis(b, jtrack, jveh) for b in jax_simplify.BASES]
        return res, ref, out, "--plot-path" in argv

    def test_metrics_match_jax(self, results):
        res, ref, _, _ = results
        assert [r["basis"] for r in res] == ["poly", "trig", "hyp"]
        for r, j in zip(res, ref):
            assert r["fit_residual_m"] < 1e-6 and 35.0 < r["lap_time_s"] < 60.0
            for key in ("gamma2", "path_length_m"):
                np.testing.assert_allclose(r[key], j[key], rtol=RTOL, err_msg=f"{r['basis']} {key}")
            np.testing.assert_allclose(r["lap_time_s"], j["lap_time_s"], rtol=LAP_RTOL, err_msg=r["basis"])
            np.testing.assert_allclose(r["samples"], j["samples"], rtol=0, atol=1e-8, err_msg=r["basis"])
            assert r["eval_throughput_per_s"] > 0.0
        # the cubic is the smoothest interpolant (it minimises ∫|x''|²)
        assert res[0]["gamma2"] <= min(r["gamma2"] for r in res) + 1e-9

    def test_plots_written(self, results):
        _, _, out, plotted = results
        if not plotted:
            pytest.skip("matplotlib is not importable")
        plot_dir = os.path.join(str(out), "plots", "tbr18", "buckmore", "simplify")
        for basis in ("poly", "trig", "hyp"):
            assert os.path.exists(os.path.join(plot_dir, f"path_{basis}.png"))

    def test_cuda_without_a_card_is_an_error(self):
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present")
        with pytest.raises(SystemExit, match="no CUDA device"):
            simplify.main([os.path.join(REPO_DATA, "tracks", "buckmore.json"),
                           os.path.join(REPO_DATA, "vehicles", "tbr18.json"), "--poly"])

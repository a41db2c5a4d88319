"""The port's racing-line CLI (`cli/race.py`, `python -m
lap_time_optimization_tpu_torch`) on the CPU, mirroring tests/test_cli.py's
TestRaceCLI: the tiny ring end to end with every artifact (and the plots
where matplotlib is importable), the artifacts read back by the port's NMPC
track loader, the estimated method, a `--config` override that steers the
compromise, the argument errors, and `cli/show_results.py`.  Numbers are
held to the JAX package in tests/test_torch_racing_line.py; here the
surface is.
"""

import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from lap_time_optimization_tpu_torch.cli import race, show_results
from lap_time_optimization_tpu_torch.mpc import track as mpc_track
from lap_time_optimization_tpu_torch.utils import io
from test_torch_racing_line import ring_json

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO_DATA = os.path.join(ROOT, "data")
TBR18 = os.path.join(REPO_DATA, "vehicles", "tbr18.json")
MX5 = os.path.join(REPO_DATA, "vehicles", "MX5.json")
HAS_MPL = importlib.util.find_spec("matplotlib") is not None


@pytest.fixture(scope="module")
def tiny_track_json(tmp_path_factory):
    return ring_json(tmp_path_factory.mktemp("tracks"))


def _run(track, vehicle, out_dir, *flags):
    return race.main([track, vehicle, "0.8", *flags, "--device", "cpu", "--output-dir", str(out_dir)])


class TestRaceCLI:
    def test_curvature_end_to_end(self, tiny_track_json, tmp_path):
        flags = ("--curvature", "--plot-all") if HAS_MPL else ("--curvature",)
        out = _run(tiny_track_json, TBR18, tmp_path, *flags)
        assert out["lap_time"] > 0 and out["length"] > 0 and out["alphas"].shape == (24,)
        d = out["artifact_dir"]
        assert d == io.artifact_dir(str(tmp_path), "tbr18", "tinyring", "curvature")
        for name in ("path", "left", "right", "widths", "velocities", "config"):
            assert os.path.isfile(os.path.join(d, f"{name}.json")), name
        if HAS_MPL:
            for png in ("path", "corners", "trajectory"):
                assert os.path.isfile(os.path.join(d, f"{png}.png")), png
        x, y = io.load_artifact(os.path.join(d, "path.json"))
        assert len(x) == len(y) > 50
        v = io.load_artifact(os.path.join(d, "velocities.json"))
        assert np.all(v > 0) and len(v) == len(x) - 1
        np.testing.assert_allclose(out["max_velocity"], v.max())

    def test_artifacts_feed_the_nmpc_track(self, tiny_track_json, tmp_path):
        """The artifact set round-trips through the port's `mpc/track.load`
        (the NMPC stage's input): finite tables over the lap."""
        out = _run(tiny_track_json, MX5, tmp_path, "--curvature", "--dtype", "float64")
        tables = mpc_track.load("MX-5", "tinyring", "curvature", base_dir=str(tmp_path))
        np.testing.assert_allclose(float(tables.s_max), out["length"], rtol=0.05)
        for name in ("k_vals", "nl_vals", "nr_vals", "vref_vals"):
            assert torch.isfinite(getattr(tables, name)).all(), name
        assert float(tables.nl_vals.min()) >= 0.0 and float(tables.vref_vals.min()) > 0.0

    def test_estimated(self, tiny_track_json, tmp_path):
        out = _run(tiny_track_json, TBR18, tmp_path, "--estimated")
        assert out["lap_time"] > 0

    def test_config_override_changes_run(self, tiny_track_json, tmp_path):
        """--config steers the run: a narrowed ε range forces a different
        compromise, and the effective config lands in the artifact dir."""
        narrow = {"compromise": {"eps_min": 0.19, "eps_max": 0.2, "n_grid": 4, "n_refine": 0}}
        wide = {"compromise": {"n_grid": 4, "n_refine": 0}}
        runs = []
        for name, cfg in (("a", wide), ("b", narrow)):
            path = tmp_path / f"{name}.json"
            path.write_text(json.dumps(cfg))
            runs.append(_run(tiny_track_json, TBR18, tmp_path / name, "--compromise", "--config", str(path),
                             "--dtype", "float64"))
        assert abs(runs[1]["length"] - runs[0]["length"]) > 1e-6
        with open(os.path.join(runs[1]["artifact_dir"], "config.json")) as fh:
            assert json.load(fh)["compromise"]["eps_min"] == 0.19

    @pytest.mark.parametrize("method", ["nonlinear", "bayes"])
    def test_search_small_budget(self, tiny_track_json, tmp_path, method):
        """The search methods go through the same CLI, with `--config`
        budgets cut to a few candidates and iterations (nonlinear over two
        seeds; on this 24-cone ring the Bayesian search's smooth proposals
        are NaN, as in JAX, and it runs on)."""
        path = tmp_path / "small.json"
        path.write_text(json.dumps({
            "nonlinear": {"n_random": 32, "n_refine": 2, "max_iter": 5},
            "bayes": {"n_init": 8, "n_local": 8, "n_uniform": 8, "max_rounds": 2, "polish_iters": 5}}))
        flags = ("--restarts", "2") if method == "nonlinear" else ()
        out = _run(tiny_track_json, TBR18, tmp_path, f"--{method}", "--config", str(path), *flags,
                   "--dtype", "float64")
        assert np.isfinite(out["lap_time"]) and out["lap_time"] > 0
        assert out["artifact_dir"] == io.artifact_dir(str(tmp_path), "tbr18", "tinyring", race.METHOD_DIRS[method])
        assert os.path.isfile(os.path.join(out["artifact_dir"], "velocities.json"))

    def test_rejects_unknown_track(self):
        with pytest.raises(FileNotFoundError):
            race.main(["nosuch.json", TBR18, "0.8", "--curvature", "--device", "cpu"])

    def test_requires_method(self, tiny_track_json):
        with pytest.raises(SystemExit):
            race.main([tiny_track_json, TBR18, "0.8"])

    def test_refuses_cuda_without_a_gpu(self, tiny_track_json, tmp_path):
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present")
        with pytest.raises(SystemExit, match="no CUDA device"):
            race.main([tiny_track_json, TBR18, "0.8", "--curvature", "--output-dir", str(tmp_path)])

    def test_module_entry_point(self, tiny_track_json, tmp_path):
        """`python -m lap_time_optimization_tpu_torch` in a fresh process."""
        out = subprocess.run(
            [sys.executable, "-m", "lap_time_optimization_tpu_torch", tiny_track_json, TBR18, "0.8",
             "--estimated", "--device", "cpu", "--solver", "fused", "--output-dir", str(tmp_path)],
            cwd=ROOT, capture_output=True, text=True, timeout=300)
        assert out.returncode == 0, out.stderr
        assert "=== Results" in out.stdout and "Lap time = " in out.stdout


@pytest.mark.skipif(not HAS_MPL, reason="matplotlib is not installed")
def test_show_results_plots_internals(tmp_path):
    from lap_time_optimization_tpu_torch.cli import mpc as cli_mpc

    sim_json = str(tmp_path / "sim.json")
    cli_mpc.main(["--curvature", "--device", "cpu", "--steps", "3", "--data-dir", REPO_DATA,
                  "--output", sim_json])
    out_png = str(tmp_path / "internals.png")
    show_results.main([sim_json, "--method", "curvature", "--data-dir", REPO_DATA, "--out", out_png])
    assert os.path.isfile(out_png) and os.path.getsize(out_png) > 10_000

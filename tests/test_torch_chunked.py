"""The port's chunked closed loop, its checkpoint, and the CLI's replay plots.

Mirrors tests/test_mpc.py::TestChunkedClosedLoop on the port, on the CPU:
the chunked loop is bit-identical to `closed_loop`; `steps=0` gives an
empty, well-formed result; an interrupted run resumes from its npz
checkpoint at the last complete chunk with the same trajectory; and a
checkpoint written under another model, track, OCP, solver config or x0 is
ignored, down to the model's flags alone.  The loops run a cheap solver
budget (1 AL round × 2 iLQR iterations): what is tested is the chunking and
the checkpoint, not the solver.  Then `cli/mpc.py --plot` writes both plots, as
tests/test_cli.py holds the JAX package's CLI.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from lap_time_optimization_tpu_torch.cli import mpc as cli_mpc
from lap_time_optimization_tpu_torch.models import load_vehicle
from lap_time_optimization_tpu_torch.models.bicycle import NU, NX, BicycleModel
from lap_time_optimization_tpu_torch.mpc import runner
from lap_time_optimization_tpu_torch.mpc import track as mpc_track
from lap_time_optimization_tpu_torch.mpc.solver import OCPParams, SolverConfig
from lap_time_optimization_tpu_torch.utils import checkpoint

REPO_DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "data")
CFG = SolverConfig(horizon=10, al_iters=1, ilqr_iters=2)


@pytest.fixture(scope="module")
def track():
    if not os.path.isdir(os.path.join(REPO_DATA, "plots", "MX-5", "buckmore", "curvature")):
        pytest.skip("shipped curvature artifacts not available")
    return mpc_track.load("MX-5", "buckmore", "curvature", base_dir=REPO_DATA)


def _model(track, **flags):
    return BicycleModel(load_vehicle("MX5"), track, **flags).double()


@pytest.fixture(scope="module")
def setup(track):
    return (_model(track), OCPParams.reference(torch.float64, lateral_margin=0.05),
            torch.as_tensor(runner.X0_REFERENCE))


def _assert_same(a, b):
    for name, x, y in zip(runner.SimResult._fields, a, b):
        assert torch.equal(x, y), name


@pytest.fixture
def counted(monkeypatch):
    """Counts of presolves and of control cycles the chunked loop runs."""
    calls = {"presolve": 0, "cycles": 0}
    presolve, advance = runner._presolve, runner._advance

    def count_presolve(*a, **k):
        calls["presolve"] += 1
        return presolve(*a, **k)

    def count_advance(model, p, cfg, carry, out, start, stop, *a):
        calls["cycles"] += stop - start
        return advance(model, p, cfg, carry, out, start, stop, *a)

    monkeypatch.setattr(runner, "_presolve", count_presolve)
    monkeypatch.setattr(runner, "_advance", count_advance)
    return calls


@pytest.mark.parametrize("steps, chunk", [(5, 2), (4, 2)], ids=["partial_last_chunk", "whole_chunks"])
def test_chunked_equals_single(setup, steps, chunk):
    model, p, x0 = setup
    _assert_same(runner.closed_loop(model, p, CFG, x0, steps),
                 runner.closed_loop_chunked(model, p, CFG, x0, steps, chunk=chunk))


def test_steps_zero(setup, counted):
    model, p, x0 = setup
    res = runner.closed_loop_chunked(model, p, CFG, x0, 0)
    assert res.xs.shape == (1, NX) and res.us.shape == (1, NU)
    assert res.costs.shape == (0,) and res.violations.shape == (0,) and res.sdot.shape == (0,)
    assert torch.equal(res.xs[0], x0) and torch.equal(res.us[0], torch.zeros(NU, dtype=x0.dtype))
    assert counted == {"presolve": 0, "cycles": 0}


def test_checkpoint_resume(setup, tmp_path, counted):
    """The first run saves after chunks 1 and 2 (done = 1, 2); a rerun
    resumes at done = 2, runs only the last chunk, and gives the same
    trajectory.  A checkpoint for other steps is ignored."""
    model, p, x0 = setup
    cp = str(tmp_path / "sim_checkpoint.npz")
    baseline = runner.closed_loop_chunked(model, p, CFG, x0, 3, chunk=1)
    first = runner.closed_loop_chunked(model, p, CFG, x0, 3, chunk=1, checkpoint_path=cp)
    assert checkpoint.exists(cp) and int(checkpoint.load(cp)["done"]) == 2
    counted.update(presolve=0, cycles=0)
    resumed = runner.closed_loop_chunked(model, p, CFG, x0, 3, chunk=1, checkpoint_path=cp)
    assert counted == {"presolve": 0, "cycles": 1}
    _assert_same(baseline, first)
    _assert_same(baseline, resumed)
    other = runner.closed_loop_chunked(model, p, CFG, x0, 2, chunk=1, checkpoint_path=cp)
    _assert_same(runner.closed_loop_chunked(model, p, CFG, x0, 2, chunk=1), other)


@pytest.mark.parametrize("change", ["solver_config", "torque_vectoring", "traction_ellipse",
                                    "vehicle", "ocp", "x0"])
def test_checkpoint_rejects_mismatch(setup, track, tmp_path, counted, change):
    """A checkpoint written under anything else at the same path, with the
    same steps and chunk, is ignored: the run starts over and matches a run
    without a checkpoint.  The model's flags alone are enough."""
    model, p, x0 = setup
    cp = str(tmp_path / "sim_checkpoint.npz")
    runner.closed_loop_chunked(model, p, CFG, x0, 2, chunk=1, checkpoint_path=cp)
    cfg = CFG
    if change == "solver_config":
        cfg = dataclasses.replace(CFG, ilqr_iters=CFG.ilqr_iters + 1)
    elif change in ("torque_vectoring", "traction_ellipse"):
        model = _model(track, **{f"enable_{change}": True})
    elif change == "vehicle":
        model = _model(track)
        model.vehicle.mass += 1.0
    elif change == "ocp":
        p = OCPParams.reference(torch.float64, lateral_margin=0.1)
    else:
        x0 = x0 + 0.01
    counted.update(presolve=0, cycles=0)
    resumed = runner.closed_loop_chunked(model, p, cfg, x0, 2, chunk=1, checkpoint_path=cp)
    assert counted == {"presolve": 1, "cycles": 2}
    _assert_same(runner.closed_loop_chunked(model, p, cfg, x0, 2, chunk=1), resumed)


def test_cli_writes_plots(tmp_path):
    """`--plot` writes the replay and internals figures beside the results."""
    out = tmp_path / "sim.json"
    cli_mpc.main(["--curvature", "--device", "cpu", "--steps", "3", "--data-dir", REPO_DATA,
                  "--output", str(out), "--plot"])
    for name in ("sim_replay.png", "sim_internals.png"):
        path = tmp_path / name
        assert path.is_file() and path.stat().st_size > 10_000, name


def test_vehicle_positions_follow_the_path(track):
    """On the line (n = 0, mu = 0) the replayed positions are the path
    samples, and the velocity is vx along the tangent."""
    from lap_time_optimization_tpu_torch.viz import visualiser

    idx = np.arange(0, track.s_grid.shape[0], 97)
    states = np.zeros((idx.size, NX))
    states[:, 0] = track.s_grid.numpy()[idx]
    states[:, 3] = 5.0
    pos, vel = visualiser.vehicle_positions(track, states)
    np.testing.assert_allclose(pos, track.path_xy.numpy()[:, idx].T, atol=1e-9)
    np.testing.assert_allclose(vel, 5.0 * track.path_tangent.numpy()[:, idx].T, atol=1e-9)

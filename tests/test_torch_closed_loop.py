"""The port's solver, closed loop and CLI against the JAX package.

Both sides run on bit-identical parameters (`utils/convert.py`).  The port
runs on the CPU, where `ops.ilqr.solve` takes its plain version.
Tolerances: a full float32 solve to rtol 1e-4 (tests/test_pallas_ilqr.py's
gate for two implementations of one solve), and the float64 closed loop to
1e-7: over 10 control cycles from the reference state the measured maximum
deviation of the states is 9e-16.
"""

import dataclasses
import json
import os
import subprocess
import sys

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
from lap_time_optimization_tpu_torch.cli import mpc as cli_mpc
from lap_time_optimization_tpu_torch.mpc import runner, solver as TS
from lap_time_optimization_tpu_torch.utils import convert, profiling

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO_DATA = os.path.join(ROOT, "data")
STEPS = 10


def _numpy_fields(obj) -> dict:
    return {f.name: np.asarray(getattr(obj, f.name)) for f in dataclasses.fields(obj)}


@pytest.fixture(scope="module")
def base():
    if not os.path.isdir(os.path.join(REPO_DATA, "plots", "MX-5", "buckmore", "curvature")):
        pytest.skip("shipped curvature artifacts not available")
    veh = jax_load_vehicle(os.path.join(REPO_DATA, "vehicles", "MX5.json"))
    track = jax_track.load("MX-5", "buckmore", "curvature", base_dir=REPO_DATA)
    return veh, track


def _pair(base, jdt):
    cast = lambda tree: jax.tree.map(
        lambda a: a.astype(jdt) if jnp.issubdtype(a.dtype, jnp.floating) else a, tree)
    veh, track = cast(base[0]), cast(base[1])
    jm = JaxBicycle(vehicle=veh, track=track)
    jp = JS.OCPParams.reference(jdt, lateral_margin=0.05)
    tm = convert.model_from_numpy(_numpy_fields(veh), _numpy_fields(track))
    return jm, jp, tm, convert.ocp_params_from_numpy(_numpy_fields(jp))


@pytest.fixture(scope="module")
def loops(base):
    """10 control cycles in float64 on both sides, and the port's solve
    kernel launches over its run."""
    jm, jp, tm, tp = _pair(base, jnp.float64)
    ref = jax_runner.closed_loop(jm, jp, JS.SolverConfig(horizon=10, backend="xla"),
                                 jnp.asarray(jax_runner.X0_REFERENCE), STEPS)
    before = profiling.counts()["ilqr.solve"]
    got = runner.closed_loop(tm, tp, TS.SolverConfig(horizon=10),
                             torch.as_tensor(runner.X0_REFERENCE), STEPS)
    return ref, got, tm, tp, profiling.counts()["ilqr.solve"] - before


def test_full_solve_matches_jax_f32(base):
    """One float32 solve (1 AL round, 2 iLQR iterations) from the reference
    state with a constant-throttle warm start: inputs and cost (rtol 1e-4)."""
    jm, jp, tm, tp = _pair(base, jnp.float32)
    cfg_j = JS.SolverConfig(horizon=10, al_iters=1, ilqr_iters=2, backend="xla")
    cfg_t = TS.SolverConfig(horizon=10, al_iters=1, ilqr_iters=2)
    z0 = np.concatenate([jax_runner.X0_REFERENCE, np.zeros(2)]).astype(np.float32)
    us = np.full((10, 2), 0.05, np.float32)
    lams = np.zeros((11, 14), np.float32)
    ref = JS.solve(jm, jp, cfg_j, jnp.asarray(z0), jnp.asarray(us), jnp.asarray(lams))
    got = TS.solve(tm, tp, cfg_t, torch.as_tensor(z0), torch.as_tensor(us), torch.as_tensor(lams))
    assert got.us.dtype == torch.float32
    np.testing.assert_allclose(got.us.numpy(), np.asarray(ref.us), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got.zs.numpy(), np.asarray(ref.zs), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(float(got.cost), float(ref.cost), rtol=1e-4)
    np.testing.assert_allclose(float(got.max_violation), float(ref.max_violation), rtol=1e-4, atol=1e-5)


def test_closed_loop_matches_jax_f64(loops):
    ref, got, _, _, _ = loops
    np.testing.assert_allclose(got.xs.numpy(), np.asarray(ref.xs), rtol=0, atol=1e-7)
    np.testing.assert_allclose(got.us.numpy(), np.asarray(ref.us), rtol=0, atol=1e-7)
    np.testing.assert_allclose(got.costs.numpy(), np.asarray(ref.costs), rtol=1e-7)
    np.testing.assert_allclose(got.violations.numpy(), np.asarray(ref.violations), rtol=1e-6, atol=1e-9)


def test_closed_loop_programs_match_jax_f64(loops):
    """The same 10 cycles through the programs of `mpc/runner` (the body a
    CUDA device captures as graphs, run uncaptured here), 3 cycles each and
    a tail of 1: JAX's trajectory at the tolerances above, and the eager
    loop's bits."""
    ref, got, tm, tp, _ = loops
    prog = runner._loop(tm, tp, TS.SolverConfig(horizon=10), torch.as_tensor(runner.X0_REFERENCE), STEPS, 3)
    for name, a, b in zip(runner.SimResult._fields, prog, got):
        assert torch.equal(a, b), name
    np.testing.assert_allclose(prog.xs.numpy(), np.asarray(ref.xs), rtol=0, atol=1e-7)
    np.testing.assert_allclose(prog.us.numpy(), np.asarray(ref.us), rtol=0, atol=1e-7)
    np.testing.assert_allclose(prog.costs.numpy(), np.asarray(ref.costs), rtol=1e-7)
    np.testing.assert_allclose(prog.violations.numpy(), np.asarray(ref.violations), rtol=1e-6, atol=1e-9)


def test_closed_loop_gates_and_schema(loops):
    """Monotone progress, the applied-state gate of bench.py (< 1e-2), the
    predicted-violation gate (< 0.02), no kernel launch on the CPU, and the
    reference `sim_results.json` schema."""
    _, got, tm, tp, launches = loops
    s = got.xs[:, 0].numpy()
    assert np.all(np.diff(s) > 0) and s[-1] > 4.0
    assert runner.applied_violation(tm, tp, got) < 1e-2
    assert float(got.violations.max()) < 0.02
    # on the CPU the plain solve runs: the kernel's counter stays put
    assert launches == 0
    data = runner.to_sim_results(tm, got)
    assert set(data) == {"x", "y", "u", "Fy", "alpha"}
    assert np.asarray(data["x"]).shape == (STEPS + 1, 8, 1)
    assert np.asarray(data["y"]).shape == (STEPS + 1, 8, 1)
    assert np.asarray(data["u"]).shape == (STEPS + 1, 2, 1)
    assert np.asarray(data["Fy"]).shape == (STEPS + 1, 2)
    assert np.asarray(data["alpha"]).shape == (STEPS + 1, 2)
    assert np.all(np.asarray(data["alpha"])[0] == 0.0)


def test_applied_violation_pairings(base, loops):
    """Both readings of the applied violation on the port's 10-cycle f64
    trajectory of the bench config: `pairing="jax"` equals the JAX
    package's `applied_violation` on the same trajectory (rtol 1e-12), and
    `"applied"` (each input with the state it was applied from and the
    u_prev the controller saw) is computed from those pairs directly."""
    _, got, tm, tp, _ = loops
    jm, jp, _, _ = _pair(base, jnp.float64)
    same = jax_runner.SimResult(*(jnp.asarray(a.numpy()) for a in got))
    ref = jax_runner.applied_violation(jm, jp, same)
    jax_reading = runner.applied_violation(tm, tp, got, pairing="jax")
    assert jax_reading == runner.applied_violation(tm, tp, got)
    np.testing.assert_allclose(jax_reading, ref, rtol=1e-12, atol=1e-15)
    applied = runner.applied_violation(tm, tp, got, pairing="applied")
    z = torch.cat([got.xs[:-1], got.us[:-1]], dim=-1)
    direct = max(float(TS.constraints(tm, tp, z[t], got.us[t + 1]).max()) for t in range(STEPS))
    assert applied == pytest.approx(direct, rel=1e-12, abs=1e-15)
    assert np.isfinite(applied) and applied < 1e-2
    with pytest.raises(ValueError, match="pairing"):
        runner.applied_violation(tm, tp, got, pairing="other")


def test_cli_writes_sim_results(tmp_path):
    out = tmp_path / "sim_results.json"
    result = cli_mpc.main(["--curvature", "--device", "cpu", "--steps", "3",
                           "--data-dir", REPO_DATA, "--output", str(out)])
    assert result.xs.dtype == torch.float32
    data = json.loads(out.read_text())
    assert np.asarray(data["x"]).shape == (4, 8, 1)
    assert np.asarray(data["u"]).shape == (4, 2, 1)
    conf = json.loads((tmp_path / "sim_results_config.json").read_text())
    assert conf["mpc"]["steps"] == 3


def test_cli_refuses_cuda_without_a_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit, match="no CUDA device"):
        cli_mpc.main(["--curvature", "--device", "cuda", "--steps", "1",
                      "--data-dir", REPO_DATA, "--output", str(tmp_path / "x.json")])


def test_package_imports_without_jax():
    """Every module of the port imports with jax absent (run in a clean
    interpreter, which blocks `import jax`)."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "import importlib, pkgutil\n"
        "import lap_time_optimization_tpu_torch as pkg\n"
        "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "assert not any(k == 'jax' or k.startswith('jax.') or k.startswith('lap_time_optimization_tpu.')\n"
        "               for k, v in sys.modules.items() if v is not None)\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"

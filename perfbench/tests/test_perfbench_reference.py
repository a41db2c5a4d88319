"""The benchmark's plain reference against the port's eager loop on the CPU.

The reference (`perfbench/reference/`) imports nothing of the port; here,
in float64, it has to give the port's eager closed loop (`runner._loop(...,
0)`: the presolve, then solve -> clip -> plant -> shift per cycle) at
horizon 10 and 20, from three starts, one 2 m before the lap's seam, and
the port's track tables from the same raw artifacts.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from perfbench import check  # noqa: E402
from perfbench.reference import model as ref_model  # noqa: E402
from perfbench.reference import solver as ref_solver  # noqa: E402

CYCLES = 10
# float64 on both sides, the same arithmetic in another order: roundoff,
# grown over the cycles by the solver's sensitivity (read ~1e-14 in the
# states and inputs, ~1e-12 in the costs).
TOL = 1e-9


def config(name):
    with open(os.path.join(ROOT, "perfbench", "configs", f"{name}.json")) as fh:
        return json.load(fh)


def port_setup(conf):
    from lap_time_optimization_tpu_torch.models.bicycle import BicycleModel
    from lap_time_optimization_tpu_torch.models.vehicle import PacejkaVehicle
    from lap_time_optimization_tpu_torch.mpc import track as mpc_track
    from lap_time_optimization_tpu_torch.mpc.solver import OCPParams, SolverConfig

    art = conf["artifacts"]
    track = mpc_track.load(art["vehicle"], art["track"], art["method"], base_dir=os.path.join(ROOT, art["base_dir"]))
    veh = PacejkaVehicle(name="MX-5", **{k: v for k, v in conf["vehicle"].items() if k != "name"})
    model = BicycleModel(veh, track).to(torch.float64)
    return model, OCPParams(**conf["ocp"]).to(torch.float64), SolverConfig(**conf["solver"])


def starts(s_max):
    x0 = np.tile(np.asarray([0.0, 0.0, 0.0, 5.0, 0.0, 0.0, 0.0, 0.1]), (3, 1))
    x0[1, [0, 1, 3]] = [600.0, 0.2, 7.0]
    x0[2, 0] = s_max - 2.0
    return x0


def test_tables_match_the_port():
    model, _, _ = port_setup(config("mx5_h10_f32"))
    ref = check.reference_model(config("mx5_h10_f32"), ROOT)
    t = model.track
    for mine, theirs in zip(ref.tables, (t.k_vals, t.nl_vals, t.nr_vals, t.vref_vals)):
        np.testing.assert_allclose(mine, theirs.numpy(), rtol=0, atol=1e-10)
    assert abs(float(ref.s_max) - float(t.s_max)) < 1e-9


@pytest.mark.parametrize("name", ["mx5_h10_f32", "mx5_h20_f64"])
def test_reference_follows_the_port_eager_loop(name):
    from lap_time_optimization_tpu_torch.mpc import runner

    conf = config(name)
    model, p, cfg = port_setup(conf)
    x0 = starts(float(model.track.s_max))
    sim = runner._loop(model, p, cfg, torch.as_tensor(x0), CYCLES, 0)
    ref = ref_solver.closed_loop(check.reference_model(conf, ROOT), check.reference_config(conf), x0, CYCLES)
    assert float(sim.xs[2, -1, 0]) > float(model.track.s_max)  # the third loop crossed the seam
    for field in ("xs", "us", "costs", "violations", "sdot"):
        got = getattr(sim, field).numpy()
        err = np.max(np.abs(got - ref[field]) / np.maximum(1.0, np.abs(ref[field])))
        assert err < TOL, f"{field}: {err}"
    # followed along the port's own loop, the reference gives it back
    fol = ref_solver.follow(check.reference_model(conf, ROOT), check.reference_config(conf),
                            sim.xs.numpy(), sim.us.numpy())
    assert np.max(np.abs(fol["us"] - sim.us.numpy()[:, 1:])) < TOL
    assert np.max(np.abs(fol["xs"] - sim.xs.numpy()[:, 1:])) < TOL


def test_tf32_rounding():
    a = np.asarray([1.0, 1.0 + 2.0**-10, 1.0 + 2.0**-11, 1.0 + 3 * 2.0**-11, -3.0 - 2.0**-12], dtype=np.float32)
    got = ref_model.round_tf32(a)
    np.testing.assert_array_equal(got, np.asarray([1.0, 1.0 + 2.0**-10, 1.0, 1.0 + 2.0**-9, -3.0], dtype=np.float32))

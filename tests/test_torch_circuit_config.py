"""The benchmark's full-length circuit configuration
(`perfbench/configs/mx5_circuit20832_h10_f32.json`) and its data, on the
CPU (no JAX):

- the shipped cones are `track.synthetic_circuit(20832, seed=0, lobes=36,
  width=10.0)` to the bit (`tools/make_circuit.py` writes them);
- the configuration is `mx5_h10_f32` key for key but its name and track;
- its racing-line table is longer than a block's shared memory holds in
  float32 at h10 (13,468 samples), and the traffic's starts lie on the lap;
- 3 cycles of `runner.closed_loop_batch` in float64 at B = 4 from the
  traffic's starts on the circuit, held to the plain reference's plant and
  to its own solve at the h20 f64 cell's limits.

The two sides build their tables apart from the raw artifacts.  At 20,832
points a dense periodic-spline moment solve takes ~3.5 GB and tens of
seconds, so here each side solves the same cyclic tridiagonal system
banded: the port by its own `spline.fit(method="tridiag")` (the benchmark's
runs take the port's dense default), the reference by a sparse solve of
the matrix `perfbench.reference.track.PeriodicSpline` builds, then the
reference's own resampling; its nearest-boundary distances are taken over
the few boundary samples a k-d tree finds nearest, not over all 20,831.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from lap_time_optimization_tpu_torch.models.bicycle import BicycleModel  # noqa: E402
from lap_time_optimization_tpu_torch.models.vehicle import PacejkaVehicle  # noqa: E402
from lap_time_optimization_tpu_torch.mpc import runner  # noqa: E402
from lap_time_optimization_tpu_torch.mpc import track as mpc_track  # noqa: E402
from lap_time_optimization_tpu_torch.mpc.solver import OCPParams, SolverConfig  # noqa: E402
from lap_time_optimization_tpu_torch.ops import spline  # noqa: E402
from lap_time_optimization_tpu_torch.track import synthetic_circuit  # noqa: E402
from perfbench import check, traffic  # noqa: E402
from perfbench.reference import model as ref_model  # noqa: E402
from perfbench.reference import track as ref_track  # noqa: E402

CONFIG = "mx5_circuit20832_h10_f32"
#: The longest (4, n) float32 table a block's shared memory holds beside one
#: h10 OCP slice (`csrc/ilqr.cu`'s solve_smem_bytes); past it the table stays
#: in global memory.
SHARED_TABLE_MAX = 13468
#: Keys that describe a configuration and do not enter a run.
DESCRIPTIVE = ("name", "source", "deployment", "assumed")


def load(*parts):
    with open(os.path.join(ROOT, *parts)) as fh:
        return json.load(fh)


def artifacts(conf):
    art = conf["artifacts"]
    return os.path.join(ROOT, art["base_dir"], "plots", art["vehicle"], art["track"], art["method"])


class BandedSpline(ref_track.PeriodicSpline):
    """The reference's periodic spline, its moment system (the matrix and
    right-hand side of `PeriodicSpline.__init__`) solved sparse."""

    def __init__(self, points):
        from scipy.sparse import coo_matrix
        from scipy.sparse.linalg import spsolve

        if not np.allclose(points[:, 0], points[:, -1]):
            points = np.concatenate([points, points[:, :1]], axis=1)
        seg = np.sqrt(np.sum(np.diff(points, axis=1) ** 2, axis=0))
        self.t = np.concatenate([[0.0], np.cumsum(seg)])
        self.length = self.t[-1]
        h = np.diff(self.t)
        p = points[:, :-1]
        m = h.shape[0]
        idx = np.arange(m)
        im1, ip1 = (idx - 1) % m, (idx + 1) % m
        rhs = (p[:, ip1] - p) / h - (p - p[:, im1]) / h[im1]
        A = coo_matrix((np.concatenate([h[im1] / 6.0, (h[im1] + h) / 3.0, h / 6.0]),
                        (np.tile(idx, 3), np.concatenate([im1, idx, ip1]))), shape=(m, m)).tocsc()
        M = np.stack([spsolve(A, r) for r in rhs])
        self.h, self.p, self.p1, self.M, self.M1 = h, p, p[:, ip1], M, M[:, ip1]


def nearest(path_xy, boundary_xy, k=4):
    """`ref_track.nearest`'s distances, each taken over the `k` boundary
    samples that a k-d tree finds nearest, which hold the nearest one, and
    not over all of them."""
    from scipy.spatial import cKDTree

    _, j = cKDTree(boundary_xy.T).query(path_xy.T, k=k)
    dx = path_xy[0][:, None] - boundary_xy[0][j]
    dy = path_xy[1][:, None] - boundary_xy[1][j]
    return np.sqrt(np.min(dx * dx + dy * dy, axis=1))


def reference_tables(directory):
    """`ref_track.Tables.from_artifacts`, with `BandedSpline` and `nearest`."""
    vel = ref_track.load_velocities(os.path.join(directory, "velocities.json"))
    n = len(vel)
    fit = lambda name: BandedSpline(ref_track.load_points(os.path.join(directory, f"{name}.json"))).resample(n)
    path_xy, k, s_max = fit("path")
    left_xy, right_xy = fit("left")[0], fit("right")[0]
    vref = ref_track.interp(np.linspace(0.0, s_max, n), np.linspace(0.0, s_max, n, endpoint=False), vel)
    return ref_track.Tables(k, nearest(path_xy, left_xy), nearest(path_xy, right_xy), vref, s_max)


def test_the_shipped_cones_are_the_seeded_circuit():
    left, right = synthetic_circuit(20832, seed=0, lobes=36, width=10.0)
    data = load("data", "tracks", "circuit20832.json")
    assert data["name"] == "circuit20832"
    np.testing.assert_array_equal(np.asarray([data["left"]["x"], data["left"]["y"]]), left)
    np.testing.assert_array_equal(np.asarray([data["right"]["x"], data["right"]["y"]]), right)


def test_the_configuration_is_mx5_h10_f32_on_another_track():
    conf, base = load("perfbench", "configs", f"{CONFIG}.json"), load("perfbench", "configs", "mx5_h10_f32.json")
    assert conf["name"] == CONFIG and conf["artifacts"]["track"] == "circuit20832"
    strip = lambda c: {k: v for k, v in c.items() if k not in DESCRIPTIVE}
    assert strip(conf) == {**strip(base), "artifacts": {**base["artifacts"], "track": "circuit20832"}}
    entry = {c["name"]: c for c in load("BENCHMARK.json")["configs"]}[CONFIG]
    assert entry["reduced"] == [] and entry["file"] == f"perfbench/configs/{CONFIG}.json"


def test_the_table_is_past_shared_memory_and_the_starts_on_the_lap():
    conf = load("perfbench", "configs", f"{CONFIG}.json")
    d = artifacts(conf)
    samples = len(load(d, "velocities.json")["velocities"])
    assert samples == 20831 > SHARED_TABLE_MAX
    xy = np.asarray([load(d, "path.json")["path"]["x"], load(d, "path.json")["path"]["y"]])
    line = float(np.sum(np.hypot(*np.diff(np.concatenate([xy, xy[:, :1]], axis=1), axis=1))))
    draw = load("perfbench", "traffic", "fleet4096_lap.json")["draw"]
    assert 20000.0 == draw["s"][1] < line < 20832.0


@pytest.fixture(scope="module")
def circuit():
    conf = load("perfbench", "configs", f"{CONFIG}.json")
    art = conf["artifacts"]
    closed = spline.FIT_METHOD_CLOSED
    spline.FIT_METHOD_CLOSED = "tridiag"
    try:
        track = mpc_track.load(art["vehicle"], art["track"], art["method"], base_dir=os.path.join(ROOT, art["base_dir"]))
    finally:
        spline.FIT_METHOD_CLOSED = closed
    return conf, track, reference_tables(artifacts(conf))


def test_three_cycles_on_the_circuit_match_the_reference(circuit):
    conf, track, tables = circuit
    assert track.k_vals.shape[0] == tables.k.shape[0] == 20831
    np.testing.assert_allclose(float(track.s_max), tables.s_max, rtol=1e-12)
    veh = PacejkaVehicle(name=conf["vehicle"]["name"], **{k: v for k, v in conf["vehicle"].items() if k != "name"})
    model = BicycleModel(veh, track).to("cpu", torch.float64)
    p, cfg = OCPParams(**conf["ocp"]).to("cpu", torch.float64), SolverConfig(**conf["solver"])
    tr = {**load("perfbench", "traffic", "fleet4096_lap.json"), "batch": 4}
    x0 = traffic.initial_states(tr, conf["x0"], tables, 0.5 * conf["vehicle"]["width"], 0, 0)
    res = runner.closed_loop_batch(model, p, cfg, torch.as_tensor(x0), 3)
    xs, us = res.xs.numpy(), res.us.numpy()
    assert xs.shape == (4, 4, 8) and np.all(np.isfinite(xs))
    ref = ref_model.Model(conf["vehicle"], conf["ocp"], tables, ref_model.Precision("float64"))
    limits = load("perfbench", "cells", "mx5_h20_f64.single.json")["limits"]
    du, dx = check.gaps(ref, check.reference_config(conf), xs, us, 3)
    dp = check.plant_gaps(ref, check.reference_config(conf), xs, us, x0)
    found = check.numbers(du, dx, dp, ("u_first", "x_first", "plant_max"))
    assert all(found[k] <= limits[k] for k in found), found
    assert float(np.max(du)) <= limits["u_first"] and float(np.max(dx)) <= limits["x_first"], (du, dx)

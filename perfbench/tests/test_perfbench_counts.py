"""The benchmark's frozen operation count against the one `chip_smoke.py`
computes for the kernel table, for both configurations' solver settings."""

import json
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from perfbench import counts  # noqa: E402


@pytest.mark.parametrize("name", ["mx5_h10_f32", "mx5_h20_f64"])
def test_solve_flops_match_chip_smoke(name):
    import chip_smoke
    from lap_time_optimization_tpu_torch.mpc.solver import SolverConfig

    with open(os.path.join(ROOT, "perfbench", "configs", f"{name}.json")) as fh:
        solver = json.load(fh)["solver"]
    assert counts.solve_flops(solver) == chip_smoke.solve_flops(SolverConfig(**solver))
    assert counts.solve_flops(solver, 16) == chip_smoke.solve_flops(SolverConfig(**solver), 16)


def test_bound_is_the_larger_of_operations_and_bytes():
    solver = {"horizon": 10, "n_linesearch": 6, "substeps": 2, "al_iters": 2, "ilqr_iters": 5}
    ops_ms = 1e3 * counts.solve_flops(solver) / counts.FLOP_PER_S["float32"]
    assert counts.bound_ms(solver, 1, 846, "float32") == pytest.approx(ops_ms)  # one OCP: operations
    many = 1e3 * counts.solve_bytes(solver, 10**6, 846, 4) / counts.HBM_BYTES_PER_S
    assert counts.bound_ms(solver, 10**6, 846, "float32") >= many

"""The full-length circuit's cell, `mx5_circuit20832_h10_f32.fleet4096`,
as the harness finds it by its files, and the reader of its per-layer
metric `global_table_pct.fleet` on hand-made trace summaries."""

import os
import sys
from types import SimpleNamespace

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from perfbench import run, trace  # noqa: E402

CELL = "mx5_circuit20832_h10_f32.fleet4096"
FLEET = "mx5_h10_f32.fleet4096"


def test_the_cell_loads_with_the_fleets_numbers_and_metrics():
    cell, fleet = run.Cell(CELL), run.Cell(FLEET)
    assert cell.config["name"] == "mx5_circuit20832_h10_f32" and cell.config["artifacts"]["track"] == "circuit20832"
    assert cell.entry["chips"] == 1 and cell.entry["traffic"] == "fleet4096_lap"
    assert cell.traffic == {**fleet.traffic, "draw": {**fleet.traffic["draw"], "s": [0.0, 20000.0]}}
    assert set(cell.limits) == set(fleet.limits) == {"u_first", "u_first_q75", "x_first", "plant_max"}
    assert [m["name"] for m in cell.end_to_end] == ["fleet_solves_per_s", "setup_s"]
    assert [m["name"] for m in cell.per_layer] == [
        "solve_kernel_ms.fleet", "solve_roofline_pct.fleet", "tail_ms_per_cycle.fleet", "kernels_per_cycle.fleet",
        "device_idle_pct.fleet", "global_table_pct.fleet"]
    assert [m["name"] for m in fleet.per_layer] == [m["name"] for m in cell.per_layer][:-1]
    for m in cell.per_layer:
        assert callable(run.reader(m["name"]))


def summary(kernels):
    """A trace summary of one 10-cycle request whose device ran `kernels`
    ((name, start ns, end ns))."""
    host = [(trace.REQUEST_SPAN, 0, 10_000)]
    return trace.Summary(kernels, host, cycles_per_request=10)


SOLVE = "void ilqr_solve_kernel<float, {}, false>(Params<float>)"
TAIL = "void cycle_tail_kernel<float>(TailParams<float>)"


@pytest.mark.parametrize("kernels, expect", [
    ([(SOLVE.format("true"), 0, 100), (SOLVE.format("true"), 200, 300), (TAIL, 300, 310)], 100.0),
    ([(SOLVE.format("false"), 0, 100), (TAIL, 300, 310)], 0.0),
    ([(SOLVE.format("true"), 0, 100), (SOLVE.format("false"), 200, 300)], 50.0),
    ([(SOLVE.format("true").replace("float", "double"), 0, 100)], 100.0),
    ([(TAIL, 300, 310)], None),
])
def test_global_table_pct_reads_the_instantiations(kernels, expect):
    read = run.reader("global_table_pct.fleet")
    assert read(SimpleNamespace(summary=summary(kernels))) == expect


def test_global_table_pct_is_silent_without_a_trace():
    assert run.reader("global_table_pct.fleet")(SimpleNamespace(summary=None)) is None

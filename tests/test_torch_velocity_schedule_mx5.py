"""Kernel 3's schedule against its twin on the searches' 1024 lines for
MX5: the cases of tests/test_torch_velocity_schedule.py (which holds tbr18
and the hard rows), in a file of their own so that `--dist loadfile` runs
them on another worker."""

import pytest

from test_torch_velocity_schedule import SEGMENTS, check_search_geometries, geometry  # noqa: F401  (fixture)


@pytest.mark.parametrize("P", SEGMENTS)
@pytest.mark.parametrize("closed", [True, False], ids=["closed", "open"])
@pytest.mark.parametrize("name", ["MX5"])
def test_schedule_equals_twin_on_search_geometries(name, closed, P, geometry):
    check_search_geometries(name, closed, P, geometry)

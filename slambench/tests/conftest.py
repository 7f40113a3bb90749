"""CPU tests of the benchmark harness (run: python -m pytest slambench/tests).
The tiny overrides shrink a cell to what the CPU can run in seconds; the
sizes that the card runs are only checked on the card (`cuda` marker)."""
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def tiny(cfg, work):
    """A cell cut to a CPU test's size: a 16 x 256 beam grid, 28 objects
    over +-15 m, 36 keyframes, a full solve every 4."""
    cfg["sensor"].update(rows=16, cols=256)
    cfg["world"].update(n_trees=24, n_poles=4, extent=15.0)
    cfg["slam"]["capacity"].update(n_keyframes_per_robot=40, n_cylinders=28)
    cfg["slam"]["solver"]["full_solve_every"] = 4
    cfg["pipeline"]["max_points_per_class"] = 4096
    work["traffic"]["path"].update(n_keyframes=36, extent=12.0, rows=2,
                                   step=1.5)
    work["judge"].update(sample_range=[1, 8])
    work["trace"]["keyframes"] = [2, 3]


@pytest.fixture
def shrink():
    return tiny


@pytest.fixture
def manifest():
    from slambench import run
    return run.load_json(ROOT, "BENCHMARK.json")

"""CPU tests of the benchmark (`python -m pytest benchmark/tests -q`).

Tests that need a card carry the `cuda` marker and skip inside the test
when there is none. Imports nothing of JAX."""

import pytest
import torch

# the small solves' many tiny ops run many times slower on several threads
torch.set_num_threads(1)

# small graphs of each family, for the CPU solves
SMALL = {
    "plaza2_shaped.random_jump2": dict(n_poses=150, n_landmarks=3, n_ranges=60),
    "tiers_shaped.odom_jump2": dict(n_robots=2, poses_per_robot=60,
                                    n_inter_ranges=30, n_landmark_ranges=10),
}


def small_cell(name: str, pool: int = 1):
    """The cell with the small graph of its family, its set of solves cut
    to `pool`."""
    from benchmark.core import cell as cells

    cell = cells.load(name)
    cell.config = dict(cell.config,
                       graph=dict(cell.config["graph"], **SMALL[name]))
    cell.traffic = dict(cell.traffic, pool=dict(cell.traffic["pool"],
                                                size=pool))
    return cell


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")

"""Fixtures of the benchmark's own tests (`python -m pytest portbench/tests`
from the repo root; the card tests run on the card and skip elsewhere)."""
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture
def card():
    """The card, or a skip where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def small_cell(name: str, crop: int = 32, dtype=None, **mix):
    """A cell at a test size on the CPU: its files as they are, the crop
    (and the mix's keys given) changed. `name` is a workload of
    BENCHMARK.json."""
    from portbench import harness
    from portbench.drivers.common import Cell

    cell = harness.find_cell(harness.spec(), name)
    config = dict(cell["config"], crop_size=crop)
    if dtype:
        config["dtype"] = dtype
    traffic = dict(cell["traffic"], **mix)
    return cell, Cell(name=name, config=config, traffic=traffic,
                      limits=cell["limits"], seed=2 ** 31 + 17, seconds=0.5,
                      device=torch.device("cpu"))


SERVE_SMALL = dict(pool_volumes=4, z_min=2, z_max=5, calibration_slices=4,
                   checked_volumes=3, profile_volumes=2, warmup_rounds=1)

"""CPU tests of the benchmark; tests marked ``gpu`` skip without a card."""
import copy
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (ROOT / "src", ROOT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

#: a cell's sizes cut so that a test run holds it: 4 lanes, W 512, k 64
TINY_CONFIG = dict(k_counters=64, k_majority=64, lanes=4, chunk=256, buffer_depth=2,
                   top_n=10)
TINY_MIX = dict(pool_items=1 << 17, epoch_items=1 << 14, block_items=1 << 12, max_id=5000)


def tiny(cell_name="k2000.epoch256m.zipf11", **mix):
    """A cell of the manifest at the tiny sizes (``mix`` overrides the mix)."""
    from sketchbench import harness
    cell = harness.Cell(cell_name)
    cell.config = dict(copy.deepcopy(cell.config), **TINY_CONFIG)
    cell.mix = dict(cell.mix, **dict(TINY_MIX, **mix))
    return cell


@pytest.fixture
def card():
    """The CUDA card, for tests that need it; skips where there is none."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")

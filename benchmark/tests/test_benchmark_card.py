"""On the card, at each cell's own size and load: the program's numbers pass
the cell's limits and the control's (the plain reference in TF32 in the
program's place) fail them, as do a training cell's faults. Each case runs
a short window of the cell (about half a minute). Skips without a card:

    python -m pytest benchmark/tests -m cuda -p no:cacheprovider
"""

import json

import pytest
import torch

from benchmark import calibrate
from benchmark.core import cell as cells
from benchmark.core import checks

SEED = 2 ** 31 + 11
CELLS = [w["name"] for w in json.loads(cells.SPEC.read_text())["workloads"]]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_and_faults_fail_the_limits(card, name):
    cell = cells.resolve(name)
    faults = cells.kind(cell.traffic["kind"]).FAULTS
    row = calibrate.readings(cell, SEED, 2.0, ("program", "control") + faults, card)
    assert row["calls"] and not row["failed"]
    ok, compared = checks.verdict(row["program"], cell.limits)
    assert ok, compared
    for side in ("control",) + faults:
        ok, compared = checks.verdict(row[side], cell.limits)
        assert not ok, (side, compared)

"""The check at the sizes of ``configs/resdet3d_tiny_test.py`` on the CPU:
the port against the benchmark's reference reads within the cells' limits;
the control (the reference one precision lower in the program's place) and
each fault a cell can have, planted under the timed path, turn ``correct``
false. The limits are the shipped cells' own."""

import json
from pathlib import Path

import pytest
import torch

from benchmark.families.resdet3d import faults_for
from benchmark.harness.main import run_cell
from benchmark.tests.tiny import TINY_CELLS, TINY_TRAFFIC, make_tiny

BENCH = Path(__file__).resolve().parents[1]
# the shipped cell whose limits each tiny cell takes
LIMITS_OF = {"tiny-occ-infer": "occ-infer-b2", "tiny-det-infer": "det-infer-b1", "tiny-occ-train": "occ-train-b1"}
SEED = 2 ** 31 + 101


def _bench(tmp_path_factory, cell):
    limits = json.loads((BENCH / "workloads" / f"{LIMITS_OF[cell]}.json").read_text())["limits"]
    if not limits:
        pytest.fail(f"{LIMITS_OF[cell]} has no limits")
    return make_tiny(tmp_path_factory.mktemp(cell), limits)


@pytest.mark.parametrize("cell", sorted(TINY_CELLS))
def test_the_port_reads_within_the_limits(tmp_path_factory, cell):
    torch.manual_seed(0)
    res = run_cell(cell, SEED, 0.2, False, device="cpu", bench=_bench(tmp_path_factory, cell))
    assert res["correct"], res["checks"]


@pytest.mark.parametrize("cell", sorted(TINY_CELLS))
def test_the_control_fails(tmp_path_factory, cell):
    res = run_cell(cell, SEED, 0.2, False, device="cpu", bench=_bench(tmp_path_factory, cell), control=True)
    assert not res["correct"], res["checks"]


CASES = [(cell, f) for cell in sorted(TINY_CELLS) for f in faults_for(TINY_TRAFFIC[TINY_CELLS[cell][1]])]


@pytest.mark.parametrize("cell,fault", CASES)
def test_each_fault_fails(tmp_path_factory, cell, fault):
    res = run_cell(cell, SEED, 0.2, False, device="cpu", bench=_bench(tmp_path_factory, cell), fault=fault)
    assert not res["correct"], (fault, res["checks"])

"""A cell of two ranks on the CPU (gloo, one process a rank), as the command
runs it: rank 0 prints the one result line, correct against the reference
over the global batch that every rank's record makes; the control and each
fault such a cell can have turn ``correct`` false; a rank that fails ends
the run with another exit code than 0, and soon.

The limits are the one-card training cell's. The ranks' runs compute in
float32: in bfloat16 two ranks at one scene each round otherwise than the
reference at two scenes, and the gaps (gradients of norms 0.01-0.03, losses
up to 0.013) would say nothing of whether the ranks compute what the
reference does, which float32 shows (to 5e-4). The control keeps the
configuration's bfloat16, which it lowers to float8."""

import json
import re
import subprocess
import sys
import time
from pathlib import Path

import pytest

from benchmark.families.resdet3d import faults_for
from benchmark.harness.main import run_cell
from benchmark.tests.tiny import TINY_RANKED, TINY_TRAFFIC, make_tiny

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
CELL = "tiny-occ-train-dp2"
SEED = 2 ** 31 + 203
LIMITS = json.loads((BENCH / "workloads" / "occ-train-b1.json").read_text())["limits"]

RANKED = """
import json, sys
from pathlib import Path
sys.path.insert(0, {root!r})
from benchmark.harness.main import run_cell
from benchmark.harness.ranks import Ranks
run = dict(cell={cell!r}, seed={seed}, seconds=0.2, trace=False)
plan = [dict(run, fault=f) for f in {child_faults!r}]
with Ranks(2, plan, "cpu", Path({bench!r}), 600) as group:
    res = run_cell(**run, fault={fault!r}, device="cpu", bench=Path({bench!r}), place=group.place())
print(json.dumps({{k: res[k] for k in ("correct", "checks", "readings")}}))
"""


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    return make_tiny(tmp_path_factory.mktemp("ranks"), LIMITS)


@pytest.fixture(scope="module")
def bench32(tmp_path_factory):
    bench = make_tiny(tmp_path_factory.mktemp("ranks32"), LIMITS)
    path = bench / "configs" / "tiny-occ.json"
    path.write_text(json.dumps(dict(json.loads(path.read_text()), compute_dtype="float32")))
    return bench


def test_the_command_prints_one_result_line_from_rank_0(bench32):
    code = ("import sys; sys.path.insert(0, %r)\nfrom pathlib import Path\nfrom benchmark.harness.main import main\n"
            "sys.exit(main(['--workload', %r, '--seed', '%d', '--seconds', '0.2', '--trace', '0'], "
            "bench=Path(%r), device='cpu'))" % (str(ROOT), CELL, SEED, str(bench32)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.strip().splitlines()
    assert sum('"correct"' in line for line in lines) == 1
    res = json.loads(lines[-1])
    assert res["correct"], res["checks"]
    assert res["device"] == {"platform": "cpu", "kind": "cpu", "count": 2, "memory_peak_bytes": 0}
    assert set(res["checks"]) == set(LIMITS) and list(res)[-1] == "checks"
    assert res["metrics"]["train_samples_per_s"]["value"] > 0


def _ranked(bench, fault=None, child_faults=(None,)):
    code = RANKED.format(root=str(ROOT), cell=CELL, seed=SEED, child_faults=list(child_faults), fault=fault,
                         bench=str(bench))
    return subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600, cwd=ROOT)


@pytest.mark.parametrize("fault", faults_for(TINY_TRAFFIC[TINY_RANKED[CELL][1]]))
def test_each_fault_of_a_cell_of_ranks_fails(bench32, fault):
    out = _ranked(bench32, fault, [fault])
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert not res["correct"], (fault, res["checks"])


def test_the_control_over_the_global_batch_fails(bench):
    res = run_cell(CELL, SEED, 0.2, False, device="cpu", bench=bench, control=True)
    assert not res["correct"], res["checks"]
    assert res["device"]["count"] == 1


def test_a_rank_that_fails_ends_the_run(bench32):
    t0 = time.monotonic()
    out = _ranked(bench32, None, ["no_such_fault"])
    assert out.returncode == 1 and time.monotonic() - t0 < 300, out.stderr[-3000:]
    # the watchdog sees the child's exit, or rank 0's collective fails first and rank 0 reports the child's code
    assert re.search(r"rank 1 exited with code 1|exit codes so far: \[1\]", out.stderr), out.stderr[-3000:]
    assert '"correct"' not in out.stdout

"""The tiny cells read what the harness read before model families and
ranks came in: the same readings and checks, of the program and of the
control, on fixed seeds, and the same keys of the run the metrics read
(less the hooks' and the host clock's decode times, whose metrics went, and
with the run's cards and the FPS exchange counters, which metrics read now).
The control's numbers are pinned to 2 %, as the CPU's thread count moves
their last digits."""

import json
from pathlib import Path

import pytest
import torch

import benchmark.harness.main as harness
from benchmark.tests.tiny import make_tiny

BENCH = Path(__file__).resolve().parents[1]
LIMITS_OF = {"tiny-occ-infer": "occ-infer-b2", "tiny-det-infer": "det-infer-b1", "tiny-occ-train": "occ-train-b1"}
SEEDS = {"tiny-occ-infer": 2 ** 31 + 7, "tiny-det-infer": 2 ** 31 + 8, "tiny-occ-train": 2 ** 31 + 9}
ZERO = {"depth_gap": 0.0, "intrinsics_gap": 0.0, "points_gap": 0.0}
PINNED = {
    ("tiny-occ-infer", False): dict(ZERO, occupancy_gap=0.0),
    ("tiny-occ-infer", True): {"depth_gap": 0.05446742984264538, "intrinsics_gap": 4.1131808539455144e-07,
                               "points_gap": 0.0, "occupancy_gap": 0.0},
    ("tiny-det-infer", False): dict(ZERO, occupancy_gap=0.0, head_gap=0.0, boxes_gap=0.0),
    ("tiny-det-infer", True): {"depth_gap": 0.04261623650877767, "intrinsics_gap": 1.5368159150003535e-06,
                               "points_gap": 0.0, "occupancy_gap": 0.18097176385229585,
                               "head_gap": 0.19935860401344224, "boxes_gap": 93.0},
    ("tiny-occ-train", False): dict(ZERO, loss_gap=0.0, grad_gap=0.0, update_gap=0.0, leaves=131.0,
                                    leaves_left_out=0.0),
    ("tiny-occ-train", True): {"depth_gap": 0.053868422962799076, "intrinsics_gap": 0.0, "points_gap": 0.0,
                               "loss_gap": 0.0, "grad_gap": 0.0, "update_gap": 0.0, "leaves": 131.0,
                               "leaves_left_out": 0.0},
}
INFER_KEYS = {"attention", "device_kind", "flops_per_unit", "fps_least_s", "frames_per_unit", "kind", "latencies_s",
              "samples_per_unit", "setup_s", "spans_ms", "units", "window_s", "chips"}
TRAIN_KEYS = INFER_KEYS - {"attention", "fps_least_s"}


@pytest.mark.parametrize("cell,control", sorted(PINNED))
def test_readings_and_run_keys_are_as_before(tmp_path, cell, control):
    limits = json.loads((BENCH / "workloads" / f"{LIMITS_OF[cell]}.json").read_text())["limits"]
    bench = make_tiny(tmp_path, limits)
    torch.manual_seed(0)
    res = harness.run_cell(cell, SEEDS[cell], 0.2, False, device="cpu", bench=bench, control=control)
    want = PINNED[(cell, control)]
    assert set(res["readings"]) == set(want)
    if control:
        assert res["readings"] == pytest.approx(want, rel=0.02)
    else:
        assert res["readings"] == want
    assert res["correct"] is not control and set(res["checks"]) == set(limits)
    keys = INFER_KEYS if "infer" in cell else TRAIN_KEYS
    assert set(res["run"]) == keys | (set() if control else {"fps_exchange"})

"""The port's benchmark entry point (``recondet3d_torch/tools/bench.py``) on
the CPU at ``configs/resdet3d_tiny_test.py`` sizes, as
``tests/test_bench_smoke.py`` runs ``bench.py``: the JSON line carries
``bench.py``'s keys with a finite throughput, and the operation count adds
the attention kernels' launches, which ``FlopCounterMode`` cannot see."""

import json

import numpy as np

from recondet3d_torch.ops import attention
from recondet3d_torch.tools import bench

KEYS = {"metric", "value", "unit", "vs_baseline", "mfu_pct", "ms_min", "ms_mean", "batch", "per_iter_ms"}


def test_bench_runs_at_tiny_size_on_the_cpu(capsys):
    assert bench.main(["--device", "cpu", "--size", "tiny", "--iters", "2", "--seed", "3"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    parts, rec = json.loads(lines[-2]), json.loads(lines[-1])
    assert set(rec) == KEYS
    assert np.isfinite(rec["value"]) and rec["value"] > 0 and rec["batch"] == 2 and len(rec["per_iter_ms"]) == 2
    assert rec["ms_min"] <= rec["ms_mean"] and rec["vs_baseline"] is None
    assert rec["mfu_pct"] is None  # no device peak applies to a CPU run
    assert "da3-small" in rec["metric"] and "2x56x84" in rec["metric"]
    # on the CPU attention runs the plain version, which FlopCounterMode counts itself
    assert parts["attention_kernels"] == 0 and parts["flops_per_request"] == parts["flop_counter_mode"] > 1e9


def test_attention_kernel_flops_count_every_launch():
    attention.reset_launch_counts()
    attention.flash_attention_fwd.launches_by_shape[(2, 24, 721, 721)] = 3
    attention.attention_fwd_cuda_core.launches_by_shape[(2, 16, 6, 6, 96)] = 4
    try:
        assert bench.attention_kernel_flops() == 3 * 4.0 * 2 * 24 * 721 * 721 * 64 + 4 * 4.0 * 2 * 16 * 6 * 6 * 96
    finally:
        attention.reset_launch_counts()

"""The full training -> evaluation loop through the port's CLIs, on the CPU
(mirrors tests/test_full_loop.py, with its gates unchanged).

Raw nuScenes tables of the structured fixture -> ``create_data`` -> ``train``
(occupancy and CenterHead losses, ``--device cpu``) -> checkpoint ->
``test`` -> devkit-free mAP/NDS. Marked ``slow`` as the JAX test is: 150
steps take a few minutes on a CPU.

The run starts from the JAX test's own initial weights, those of the JAX
CLI at its default seed 0 (``tests/jax_init.py`` makes them without JAX;
tests/test_torch_jax_init.py holds them to JAX's): a step-0 checkpoint in the
work dir, which the train CLI resumes from.

The gates are a property of the initial weights as much as of the code.
``tests/loop_seed_study.py`` runs this experiment from the JAX CLI's seeds
0-6 on images neither loader resizes: in bf16 the JAX package meets the
gates at seeds 0 and 4, the port at seed 0 on the CPU and on the card; in
fp32 the JAX package at 0 and 4, the port at 0, 3 and 4 on both devices. At
seed 4 in bf16 the JAX run's traffic-cone AP is 0.0222 (one matched box) and
the port's 0.0, so the port misses the gate that every present class scores.
In fp32 the first step's losses agree; after it every two runs part, the
port on the CPU and on the card as soon as the port and the JAX package:
rounding (bf16's, or the order of an fp32 sum) moves the cloud, the point
path's selections and the refinement's batch statistics magnify the move,
and each run ends with clouds of its own (PERF.md, Findings, PR 7). ``chip_smoke.py`` phase 18 runs this loop
on the card from the same seed-0 weights.
"""

import os
import re
import sys

import pytest

from nuscenes_fixture import make_fixture

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.slow
def test_full_detection_loop(tmp_path, capsys):
    root = str(tmp_path / "nusc")
    make_fixture(root, structured=True)

    from recondet3d_torch.cli.create_data import main as create_data_main

    assert create_data_main(["nuscenes", "--root-path", root, "--extra-tag", "tiny", "--version", "v1.0-mini"]) == 0
    ann = os.path.join(root, "tiny_infos_train.pkl")
    cfg = os.path.join(REPO, "configs", "resdet3d_tiny_centerhead_test.py")
    overrides = ["--cfg-options", f"data.train.ann_file={ann}", f"data.train.data_root={root}",
                 f"data.test.ann_file={ann}", f"data.test.data_root={root}"]

    from recondet3d_torch.cli.train import main as train_main

    wd = str(tmp_path / "wd")
    steps = os.environ.get("RECONDET3D_LOOP_STEPS", "150")
    from recondet3d_torch.cli.train import build_model_from_cfg
    from recondet3d_torch.core.config import load_py_config
    from jax_init import write_initial_checkpoint

    write_initial_checkpoint(build_model_from_cfg(load_py_config(cfg), device="cpu"), cfg, wd, int(steps))
    assert train_main([cfg, "--work-dir", wd, "--max-steps", steps, "--device", "cpu"] + overrides) == 0
    out = capsys.readouterr().out
    assert "at step 0" in out
    # the JAX test's gate on the normalised loss curve (losses over the first one)
    losses = [float(m.group(1)) for m in re.finditer(r" loss=([0-9.]+)", out)]
    assert len(losses) >= 2
    normalized = [l / losses[0] for l in losses]
    assert normalized[-1] < 0.25, f"normalized loss curve tail {normalized[-5:]}"

    from recondet3d_torch.train.checkpoints import latest_checkpoint

    ckpt = latest_checkpoint(wd)
    assert ckpt is not None

    from recondet3d_torch.cli.test import main as test_main

    assert test_main([cfg, "--checkpoint", ckpt, "--device", "cpu"] + overrides) == 0
    out = capsys.readouterr().out
    metrics = {m.group(1): float(m.group(2)) for m in re.finditer(r"pts_bbox_NuScenes/(\S+): ([0-9.]+)", out)}
    print(f"[full-loop torch] steps={steps} metrics={metrics}", file=sys.__stderr__)
    # the JAX test's memorisation gates (mAP averages all 10 classes, 3 present: its ceiling is 0.3)
    present = ["car_AP", "pedestrian_AP", "traffic_cone_AP"]
    assert sum(metrics[k] for k in present) / len(present) > 0.2, metrics
    assert metrics["car_AP"] > 0.35, metrics
    assert all(metrics[k] > 0.0 for k in present), metrics
    assert metrics["mAP"] > 0.06, metrics
    assert metrics["NDS"] > 0.1, metrics

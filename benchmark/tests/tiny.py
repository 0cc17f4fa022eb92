"""A benchmark folder at the sizes of ``configs/resdet3d_tiny_test.py``
(da3-small, two views of 56x84, small capacities), for runs of the harness
on the CPU: the shipped folder copied, with a tiny configuration, traffic
and cells added as files, and a ``BENCHMARK.json`` beside it."""

from __future__ import annotations

import copy
import json
import shutil
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent

TINY_MODEL = {
    "type": "ResDet3D",
    "reconstruction_backbone": {
        "type": "ReconstructionBackbone", "pretrained": "da3-small", "process_res": 56, "ref_view_strategy": "first",
        "use_ray_pose": False, "max_depth": 20.0, "freeze_da3": True,
        "filter_range": [-8.0, -8.0, -2.0, 8.0, 8.0, 2.0], "bq_anchor_points": 128, "bq_max_radius": 0.5,
        "bq_sample_num": 8, "num_points": 256, "gt_num_points": 512,
        "refinement": {"type": "SparseRefinement", "point_cloud_range": [-8.0, -8.0, -2.0, 8.0, 8.0, 2.0],
                       "voxel_size": [0.1, 0.1, 0.1], "max_voxels": 1024, "occ_max_voxels": 512,
                       "occ_feature_shape": [20, 20, 8], "sparse_shape": [40, 160, 160],
                       "unet_channels": [32, 48, 64, 96], "stage_caps": [1024, 512, 384, 256],
                       "encoder_out_channels": 16, "loss_type": "bce", "occupancy_loss_weight": 10.0}},
}
TINY_HEAD = {"type": "CenterHead", "in_channels": 16, "point_cloud_range": [-8.0, -8.0, -2.0, 8.0, 8.0, 2.0],
             "voxel_size": [0.1, 0.1, 0.1], "out_size_factor": 8,
             "tasks": [["car"], ["truck", "construction_vehicle"], ["pedestrian", "traffic_cone"]], "max_objs": 64,
             "loss_cls_weight": 1.0, "loss_bbox_weight": 0.25,
             "code_weights": [1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 0.2, 0.2]}
TINY_TRAFFIC = {
    "tiny-infer": {"kind": "infer", "batch": 2, "views": 2, "image_hw": [56, 84], "pool": 3, "warmup": 1,
                   "decode": False, "checked": 1, "check_from": 2, "profile_units": 2},
    "tiny-detect": {"kind": "infer", "batch": 1, "views": 2, "image_hw": [56, 84], "pool": 3, "warmup": 1,
                    "decode": True, "checked": 2, "check_from": 2, "profile_units": 2},
    "tiny-train": {"kind": "train", "batch": 1, "views": 2, "image_hw": [56, 84], "gt_points": 512, "pool": 3,
                   "checked_steps": 3, "schedule_steps": 100, "profile_units": 2},
}
TINY_TRAFFIC["tiny-train-dp2"] = dict(TINY_TRAFFIC["tiny-train"], ranks=2)
TINY_CELLS = {"tiny-occ-infer": ("tiny-occ", "tiny-infer"), "tiny-det-infer": ("tiny-det", "tiny-detect"),
              "tiny-occ-train": ("tiny-occ", "tiny-train")}
# cells of several ranks (one process a rank, gloo on the CPU)
TINY_RANKED = {"tiny-occ-train-dp2": ("tiny-occ", "tiny-train-dp2")}


def make_tiny(dst: Path, limits=None) -> Path:
    """The tiny benchmark folder under ``dst``; returns its ``benchmark``
    directory. ``limits`` (a dict) go into every tiny cell."""
    bench = dst / "benchmark"
    shutil.copytree(BENCH, bench, ignore=shutil.ignore_patterns("__pycache__"))
    base = json.loads((BENCH / "configs" / "resdet3d-det-nested-giant-large.json").read_text())
    for name, head in (("tiny-occ", None), ("tiny-det", TINY_HEAD)):
        cfg = copy.deepcopy(base)
        cfg["name"], cfg["model"] = name, copy.deepcopy(TINY_MODEL)
        cfg["model"]["pts_bbox_head"] = copy.deepcopy(head)
        cfg["weights"]["adjust"] = []
        (bench / "configs" / f"{name}.json").write_text(json.dumps(cfg))
    for name, traffic in TINY_TRAFFIC.items():
        (bench / "traffic" / f"{name}.json").write_text(json.dumps(traffic))
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    for cell, (config, traffic) in {**TINY_CELLS, **TINY_RANKED}.items():
        work = {"config": config, "traffic": traffic, "chips": 1, "why": "CPU test", "limits": limits or {}}
        (bench / "workloads" / f"{cell}.json").write_text(json.dumps(work))
        manifest["workloads"].append({"name": cell, "config": config, "traffic": traffic, "chips": 1,
                                      "why": "CPU test"})
        kind = "train" if "train" in cell else "infer"
        for m in manifest["end_to_end"] + manifest["per_layer"]:
            if "workloads" in m and any(c.startswith(("occ-train" if kind == "train" else "occ-infer"))
                                        or (c == "det-infer-b1" and cell.startswith("tiny-det"))
                                        for c in m["workloads"]):
                m["workloads"].append(cell)
    (dst / "BENCHMARK.json").write_text(json.dumps(manifest))
    return bench

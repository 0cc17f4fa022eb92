"""Dataset-driven evaluation (mAP/NDS) entry point (port of
``recondet3d/cli/test.py``; reference: tools/test.py:114-272 — build
dataset/model, run inference, dataset.evaluate -> nuScenes metrics).

    python -m recondet3d_torch.cli.test <config> --checkpoint <work-dir>/checkpoints/step_N.pt [--device cpu]

Builds the config's model (random weights from seed 0, as the JAX CLI's
``PRNGKey(0)`` init), loads the checkpoint's model state, runs
``simple_test`` and the head's ``decode`` on every sample of
``data.test``, pads the results to the dataset's length and prints
``key: value`` for every metric of ``NuScenesDataset.evaluate``. Runs on the
GPU unless ``--device cpu``.
"""

from __future__ import annotations

import argparse

import numpy as np

__all__ = ["parse_args", "main"]


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Evaluate ResDet3D")
    p.add_argument("config")
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--max-samples", type=int, default=None)
    p.add_argument("--cfg-options", nargs="*", default=[])
    p.add_argument("--eval", default="bbox")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p.parse_args(argv)


def main(argv=None):
    from recondet3d_torch.cli.train import build_model_from_cfg, data_iterator
    from recondet3d_torch.core.config import load_py_config, parse_cli_overrides
    from recondet3d_torch.data.nuscenes import NuScenesDataset
    from recondet3d_torch.train.checkpoints import load_checkpoint
    from recondet3d_torch.utils.device import resolve_device

    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = load_py_config(args.config, parse_cli_overrides(args.cfg_options))
    model = build_model_from_cfg(cfg, device=device)
    if model.pts_bbox_head is None:
        raise SystemExit("config has no pts_bbox_head; evaluation needs a detection head "
                         "(see configs/resdet3d_centerhead.py)")
    dcfg = cfg["data"]["test"]
    dataset = NuScenesDataset(ann_file=dcfg["ann_file"], data_root=dcfg.get("data_root", ""),
                              classes=dcfg.get("classes"), test_mode=True,
                              custom_eval_set=dcfg.get("custom_eval_set"))
    if args.checkpoint:
        model.load_state_dict(load_checkpoint(args.checkpoint, map_location=device)["model"])
    model.eval()

    it = data_iterator(dataset, num_points_gt=8, img_hw=(900, 1600), n_cams=6, epochs=1)
    results = []
    for i, batch in enumerate(it):
        if args.max_samples is not None and i >= args.max_samples:
            break
        out = model.simple_test(batch["img"].to(device), batch["cam2lidar_rts"].to(device))
        dets = model.pts_bbox_head.decode(out["det_preds"], class_names=dataset.CLASSES)
        results.extend(dets)
        print(f"sample {i}: {len(dets[0]['boxes_3d'])} boxes", flush=True)
    it.close()
    while len(results) < len(dataset):
        results.append(dict(boxes_3d=np.zeros((0, 9)), scores_3d=np.zeros(0), labels_3d=np.zeros(0, np.int64)))
    metrics = dataset.evaluate(results)
    for k, v in metrics.items():
        print(f"{k}: {v:.4f}")
    return 0


if __name__ == "__main__":
    main()

"""Dataset-driven batch inference saving per-sample pseudo point clouds
(port of ``recondet3d/cli/inference_mmdet3d.py``).

    python -m recondet3d_torch.cli.inference_mmdet3d --config configs/resdet3d_centerhead.py \\
        [--checkpoint <work-dir>/checkpoints/step_N.pt] [--max-samples 1] [--device cpu]

Builds the config's model as ``cli/test.py`` does (random weights from seed
0, as the JAX CLI's ``PRNGKey(0)`` init; a checkpoint's model state over
them), runs ``simple_test`` on every sample of ``data.test`` and writes
``{out_dir}/batch_{i}_pred_{j}_points.pcd`` with the valid pseudo points.
Runs on the GPU unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import os

import torch

__all__ = ["parse_args", "main"]


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="ResDet3D batch inference")
    p.add_argument("--config", required=True)
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--out-dir", default="output")
    p.add_argument("--max-samples", type=int, default=None)
    p.add_argument("--cfg-options", nargs="*", default=[])
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p.parse_args(argv)


def main(argv=None):
    from recondet3d_torch.cli.train import build_model_from_cfg, data_iterator
    from recondet3d_torch.core.config import load_py_config, parse_cli_overrides
    from recondet3d_torch.data.export import write_pcd
    from recondet3d_torch.data.nuscenes import NuScenesDataset
    from recondet3d_torch.train.checkpoints import load_checkpoint
    from recondet3d_torch.utils.device import resolve_device

    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = load_py_config(args.config, parse_cli_overrides(args.cfg_options))
    model = build_model_from_cfg(cfg, device=device)
    if args.checkpoint:
        model.load_state_dict(load_checkpoint(args.checkpoint, map_location=device)["model"])
    model.eval()

    dcfg = cfg["data"]["test"]
    dataset = NuScenesDataset(ann_file=dcfg["ann_file"], data_root=dcfg.get("data_root", ""),
                              classes=dcfg.get("classes"), test_mode=True)
    os.makedirs(args.out_dir, exist_ok=True)

    it = data_iterator(dataset, num_points_gt=8, img_hw=(900, 1600), n_cams=6, epochs=1)
    n = 0
    for bi, batch in enumerate(it):
        if args.max_samples is not None and bi >= args.max_samples:
            break
        out = model.simple_test(batch["img"].to(device), batch["cam2lidar_rts"].to(device))
        pts = out["pseudo_points"].float().cpu().numpy()
        msk = out["pseudo_valid"].cpu().numpy()
        for j in range(pts.shape[0]):
            path = os.path.join(args.out_dir, f"batch_{bi}_pred_{j}_points.pcd")
            write_pcd(path, pts[j][msk[j]])
            print(f"wrote {path} ({int(msk[j].sum())} points)", flush=True)
        n += 1
    it.close()
    print(f"done: {n} samples")
    return 0


if __name__ == "__main__":
    main()

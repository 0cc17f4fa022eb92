"""Dataset preparation (port of ``recondet3d/cli/create_data.py``;
reference: tools/create_data.py:12-298 — raw tables -> info pkls).

    python -m recondet3d_torch.cli.create_data nuscenes --root-path data/nuscenes_mini [--version v1.0-mini]

nuScenes is ported (host numpy, ``data/nuscenes``). The kitti, lyft, waymo
and indoor converters are ROADMAP item 15b: those choices raise
``NotImplementedError`` here.
"""

from __future__ import annotations

import argparse

__all__ = ["main"]


def main(argv=None):
    p = argparse.ArgumentParser(description="create dataset info files")
    p.add_argument("dataset", choices=["nuscenes", "kitti", "lyft", "waymo", "scannet", "s3dis", "sunrgbd"])
    p.add_argument("--root-path", required=True)
    p.add_argument("--version", default="v1.0-mini")
    p.add_argument("--extra-tag", default=None, help="info filename prefix (defaults to the dataset name)")
    p.add_argument("--max-sweeps", type=int, default=10)
    args = p.parse_args(argv)
    if args.extra_tag is None:
        args.extra_tag = args.dataset

    if args.dataset != "nuscenes":
        raise NotImplementedError(
            f"create_data {args.dataset}: the port converts nuScenes only; the {args.dataset} converter is "
            "ROADMAP item 15b (python -m recondet3d.cli.create_data runs it in the JAX package)")
    from recondet3d_torch.data.nuscenes import create_nuscenes_infos

    train, val = create_nuscenes_infos(args.root_path, info_prefix=args.extra_tag, version=args.version,
                                       max_sweeps=args.max_sweeps)
    print(f"wrote {train}\nwrote {val}")
    return 0


if __name__ == "__main__":
    main()

"""Dataset preparation (port of ``recondet3d/cli/create_data.py``;
reference: tools/create_data.py:12-298 — raw tables -> info pkls).

    python -m recondet3d_torch.cli.create_data {nuscenes,kitti,lyft,waymo,scannet,s3dis,sunrgbd} \
        --root-path <root> [--version v1.0-mini] [--extra-tag <prefix>] [--max-sweeps 10]

Every choice dispatches as the JAX package's does, to the port's host-numpy
converters under ``data/``; waymo reads the KITTI-format layout that
``data/waymo`` ``convert_tfrecords`` writes.
"""

from __future__ import annotations

import argparse

__all__ = ["main"]


def main(argv=None):
    p = argparse.ArgumentParser(description="create dataset info files")
    p.add_argument("dataset", choices=["nuscenes", "kitti", "lyft", "waymo",
                                       "scannet", "s3dis", "sunrgbd"])
    p.add_argument("--root-path", required=True)
    p.add_argument("--version", default="v1.0-mini")
    p.add_argument("--extra-tag", default=None,
                   help="info filename prefix (defaults to the dataset name)")
    p.add_argument("--max-sweeps", type=int, default=10)
    args = p.parse_args(argv)
    if args.extra_tag is None:
        args.extra_tag = args.dataset

    if args.dataset == "nuscenes":
        from recondet3d_torch.data.nuscenes import create_nuscenes_infos

        train, val = create_nuscenes_infos(
            args.root_path, info_prefix=args.extra_tag,
            version=args.version, max_sweeps=args.max_sweeps,
        )
        print(f"wrote {train}\nwrote {val}")
        return 0
    if args.dataset == "kitti":
        from recondet3d_torch.data.kitti.converter import create_kitti_infos

        for p in create_kitti_infos(args.root_path, info_prefix=args.extra_tag):
            print(f"wrote {p}")
        return 0
    if args.dataset == "lyft":
        from recondet3d_torch.data.lyft import create_lyft_infos

        version = args.version if "v1.01" in args.version else "v1.01-train"
        for p in create_lyft_infos(
            args.root_path, info_prefix=args.extra_tag,
            version=version, max_sweeps=args.max_sweeps,
        ):
            print(f"wrote {p}")
        return 0
    if args.dataset == "waymo":
        from recondet3d_torch.data.waymo import create_waymo_infos

        paths = create_waymo_infos(args.root_path, info_prefix=args.extra_tag)
        if not paths:
            raise FileNotFoundError(
                f"no ImageSets/*.txt under {args.root_path} — run the "
                "waymo-open-dataset TFRecord extraction (unavailable in this "
                "environment) to produce the KITTI-format layout first"
            )
        for p in paths:
            print(f"wrote {p}")
        return 0
    if args.dataset in ("scannet", "s3dis", "sunrgbd"):
        from recondet3d_torch.data.indoor import create_indoor_infos

        for p in create_indoor_infos(
            args.dataset, args.root_path, info_prefix=args.extra_tag
        ):
            print(f"wrote {p}")
        return 0
    raise NotImplementedError(
        f"unknown dataset {args.dataset!r}; supported: nuscenes, kitti, "
        "lyft, waymo (KITTI-format layout), scannet, s3dis, sunrgbd"
    )


if __name__ == "__main__":
    main()

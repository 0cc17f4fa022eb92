"""``da3`` CLI (port of ``recondet3d/cli/da3.py``): auto / image / images /
video / colmap inference through ``DepthAnything3``, the JAX CLI's arguments
plus ``--device`` (default ``cuda``; ``cpu`` runs the plain PyTorch path).

    python -m recondet3d_torch.cli.da3 images <dir> --export-dir out --export-format glb-npz
    python -m recondet3d_torch.cli.da3 colmap <dir with sparse/ or cameras.bin> --device cpu

``video`` reads its frames with OpenCV (cv2) and raises without it, naming
cv2. ``backend`` serves the model over HTTP with its web app
(``serve/backend.py``, the model on ``--device``), ``gallery`` the exported
results (``serve/gallery.py``):

    python -m recondet3d_torch.cli.da3 backend --model da3-small --device cpu --port 8000
    python -m recondet3d_torch.cli.da3 gallery --root da3_backend --port 8100
"""

from __future__ import annotations

import argparse
import glob
import os
import sys
from typing import List, Optional

import numpy as np

__all__ = ["main", "detect_input_type"]

IMAGE_EXTS = {".jpg", ".jpeg", ".png", ".bmp", ".webp", ".tif", ".tiff"}
VIDEO_EXTS = {".mp4", ".avi", ".mov", ".mkv", ".webm"}


def detect_input_type(path: str) -> str:
    """Input kind of a path: a COLMAP model, a directory of images, one image, a video."""
    if os.path.isdir(path):
        entries = os.listdir(path)
        if any(e in ("cameras.bin", "cameras.txt") for e in entries) or "sparse" in entries:
            return "colmap"
        if any(os.path.splitext(e)[1].lower() in IMAGE_EXTS for e in entries):
            return "images"
        raise ValueError(f"directory {path!r} contains no images")
    ext = os.path.splitext(path)[1].lower()
    if ext in IMAGE_EXTS:
        return "image"
    if ext in VIDEO_EXTS:
        return "video"
    raise ValueError(f"cannot detect input type of {path!r}")


def _gather_images(path: str) -> List[str]:
    if os.path.isdir(path):
        return sorted(f for f in glob.glob(os.path.join(path, "*")) if os.path.splitext(f)[1].lower() in IMAGE_EXTS)
    return [path]


def _video_frames(path: str, fps: float, max_frames: int, out_dir: str) -> List[str]:
    try:
        import cv2
    except ImportError as e:
        raise ImportError("da3 video reads its frames with OpenCV (cv2), which is not installed; extract the "
                          "frames and run `da3 images` on their directory") from e

    cap = cv2.VideoCapture(path)
    native_fps = cap.get(cv2.CAP_PROP_FPS) or 30.0
    step = max(1, int(round(native_fps / fps)))
    frames, i = [], 0
    os.makedirs(out_dir, exist_ok=True)
    while len(frames) < max_frames:
        ok, frame = cap.read()
        if not ok:
            break
        if i % step == 0:
            p = os.path.join(out_dir, f"frame_{len(frames):05d}.png")
            cv2.imwrite(p, frame)
            frames.append(p)
        i += 1
    cap.release()
    return frames


def _load_colmap(path: str):
    """COLMAP dir -> (image paths, extrinsics, intrinsics)."""
    from recondet3d_torch.data.export.colmap_io import read_cameras_bin, read_images_bin
    from recondet3d_torch.data.nuscenes.tables import quat_wxyz_to_matrix

    sparse = path
    for cand in (os.path.join(path, "sparse", "0"), os.path.join(path, "sparse"), path):
        if os.path.exists(os.path.join(cand, "cameras.bin")):
            sparse = cand
            break
    cams = read_cameras_bin(os.path.join(sparse, "cameras.bin"))
    imgs = read_images_bin(os.path.join(sparse, "images.bin"))
    img_dir = os.path.join(path, "images") if os.path.isdir(os.path.join(path, "images")) else path
    paths, exts, ixts = [], [], []
    for iid in sorted(imgs):
        rec = imgs[iid]
        fx, fy, cx, cy = cams[rec["camera_id"]]["params"]
        K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float32)
        E = np.eye(4, dtype=np.float32)
        E[:3, :3] = quat_wxyz_to_matrix(rec["qvec"])
        E[:3, 3] = rec["tvec"]
        paths.append(os.path.join(img_dir, rec["name"]))
        exts.append(E)
        ixts.append(K)
    return paths, np.stack(exts), np.stack(ixts)


def _run(args, images, extrinsics=None, intrinsics=None):
    from recondet3d_torch.api import DepthAnything3

    model = DepthAnything3.from_pretrained(args.model, cache_dir=args.cache_dir, device=args.device)
    pred = model.inference(
        images,
        extrinsics=extrinsics,
        intrinsics=intrinsics,
        infer_gs="gs" in args.export_format,
        use_ray_pose=args.use_ray_pose,
        ref_view_strategy=args.ref_view_strategy,
        process_res=args.process_res,
        export_dir=args.export_dir,
        export_format=args.export_format,
        conf_thresh_percentile=args.conf_thresh_percentile,
        num_max_points=args.num_max_points,
    )
    print(f"depth: {pred.depth.shape}, exported to {args.export_dir}")
    return pred


def _add_common(p: argparse.ArgumentParser):
    p.add_argument("input", help="image / directory / video / colmap dir")
    p.add_argument("--model", default="depth-anything/DA3NESTED-GIANT-LARGE")
    p.add_argument("--cache-dir", default="ckpts")
    p.add_argument("--export-dir", default="da3_output")
    p.add_argument("--export-format", default="glb")
    p.add_argument("--process-res", type=int, default=504)
    p.add_argument("--use-ray-pose", action="store_true")
    p.add_argument("--ref-view-strategy", default="saddle_balanced")
    p.add_argument("--conf-thresh-percentile", type=float, default=40.0)
    p.add_argument("--num-max-points", type=int, default=1_000_000)
    p.add_argument("--fps", type=float, default=1.0, help="video sampling fps")
    p.add_argument("--max-frames", type=int, default=32)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(prog="da3", description="Depth Anything 3 inference (recondet3d_torch)")
    sub = parser.add_subparsers(dest="command", required=True)
    for name in ("auto", "image", "images", "video", "colmap"):
        _add_common(sub.add_parser(name))
    backend = sub.add_parser("backend")
    backend.add_argument("--model", default="depth-anything/DA3NESTED-GIANT-LARGE")
    backend.add_argument("--cache-dir", default="ckpts")
    backend.add_argument("--host", default="127.0.0.1")
    backend.add_argument("--port", type=int, default=8000)
    backend.add_argument("--workdir", default="da3_backend")
    backend.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    gallery = sub.add_parser("gallery")
    gallery.add_argument("--root", default="da3_backend")
    gallery.add_argument("--host", default="127.0.0.1")
    gallery.add_argument("--port", type=int, default=8100)

    args = parser.parse_args(argv)
    if args.command == "backend":
        from recondet3d_torch.serve.backend import start_server

        start_server(model_name=args.model, cache_dir=args.cache_dir, host=args.host, port=args.port,
                     workdir=args.workdir, device=args.device)
        return 0
    if args.command == "gallery":
        from recondet3d_torch.serve.gallery import serve_gallery

        serve_gallery(args.root, host=args.host, port=args.port)
        return 0

    kind = args.command if args.command != "auto" else detect_input_type(args.input)
    if kind in ("image", "images"):
        _run(args, _gather_images(args.input))
    elif kind == "video":
        frames = _video_frames(args.input, args.fps, args.max_frames, os.path.join(args.export_dir, "frames"))
        _run(args, frames)
    elif kind == "colmap":
        paths, ext, ixt = _load_colmap(args.input)
        _run(args, paths, extrinsics=ext, intrinsics=ixt)
    return 0


if __name__ == "__main__":
    sys.exit(main())

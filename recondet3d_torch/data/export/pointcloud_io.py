"""Port of ``recondet3d/data/export/pointcloud_io.py`` (numpy, copied as it is: the
same prediction gives the same bytes in both packages).

PCD / PLY point-cloud writers and readers (pure numpy).

The reference writes .pcd via open3d (reference:
tools/inference_mmdet3d.py:286-289 saving batch_i_pred_j_points.pcd) and
gaussian .ply via its gsply helpers (depth_anything_3/utils/gsply.py).
This module implements the formats directly so outputs stay
bit-comparable without the open3d dependency.
"""

from __future__ import annotations

import struct
from typing import Optional, Tuple

import numpy as np

__all__ = ["write_pcd", "read_pcd", "write_ply", "read_ply", "write_gs_ply"]


def write_pcd(path: str, points: np.ndarray, colors: Optional[np.ndarray] = None,
              binary: bool = True) -> None:
    """Write an (N, 3) float point cloud (+ optional (N, 3) colors in [0,1])
    as PCD v0.7 (matching open3d's writer layout)."""
    pts = np.asarray(points, np.float32)
    n = len(pts)
    fields, sizes, types, counts = ["x", "y", "z"], [4, 4, 4], ["F", "F", "F"], [1, 1, 1]
    if colors is not None:
        fields, sizes, types, counts = fields + ["rgb"], sizes + [4], types + ["F"], counts + [1]
        c = np.clip(np.asarray(colors) * (255 if np.asarray(colors).max() <= 1.0 else 1), 0, 255)
        c = c.astype(np.uint32)
        rgb = (c[:, 0] << 16) | (c[:, 1] << 8) | c[:, 2]
        rgb_f = rgb.view(np.float32) if rgb.dtype.itemsize == 4 else rgb.astype(np.uint32).view(np.float32)
    header = (
        "# .PCD v0.7 - Point Cloud Data file format\n"
        "VERSION 0.7\n"
        f"FIELDS {' '.join(fields)}\n"
        f"SIZE {' '.join(map(str, sizes))}\n"
        f"TYPE {' '.join(types)}\n"
        f"COUNT {' '.join(map(str, counts))}\n"
        f"WIDTH {n}\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\nPOINTS {n}\n"
        f"DATA {'binary' if binary else 'ascii'}\n"
    )
    with open(path, "wb") as f:
        f.write(header.encode())
        if colors is not None:
            data = np.empty((n, 4), np.float32)
            data[:, :3] = pts
            data[:, 3] = rgb_f
        else:
            data = pts
        if binary:
            f.write(np.ascontiguousarray(data).tobytes())
        else:
            np.savetxt(f, data, fmt="%.8g")


def read_pcd(path: str) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Read a PCD file (ascii or binary, xyz[+rgb]) -> (points, colors|None)."""
    with open(path, "rb") as f:
        header = {}
        while True:
            line = f.readline().decode("ascii", "replace").strip()
            if line.startswith("#") or not line:
                continue
            key, _, val = line.partition(" ")
            header[key] = val
            if key == "DATA":
                break
        fields = header["FIELDS"].split()
        sizes = list(map(int, header["SIZE"].split()))
        types = header["TYPE"].split()
        n = int(header["POINTS"])
        np_types = {("F", 4): "f4", ("F", 8): "f8", ("U", 4): "u4",
                    ("U", 1): "u1", ("I", 4): "i4", ("U", 2): "u2"}
        dtype = np.dtype([
            (name, np_types[(t, s)]) for name, t, s in zip(fields, types, sizes)
        ])
        if header["DATA"] == "binary":
            arr = np.frombuffer(f.read(n * dtype.itemsize), dtype=dtype, count=n)
        else:
            raw = np.loadtxt(f, dtype=np.float64, max_rows=n).reshape(n, len(fields))
            arr = np.core.records.fromarrays(
                [raw[:, i].astype(dtype[i]) for i in range(len(fields))], dtype=dtype
            )
        pts = np.stack([arr["x"], arr["y"], arr["z"]], axis=1).astype(np.float32)
        colors = None
        if "rgb" in fields:
            rgb = arr["rgb"].view(np.uint32) if arr["rgb"].dtype.kind == "f" else arr["rgb"]
            colors = np.stack(
                [(rgb >> 16) & 255, (rgb >> 8) & 255, rgb & 255], axis=1
            ).astype(np.float32) / 255.0
        return pts, colors


def write_ply(path: str, points: np.ndarray, colors: Optional[np.ndarray] = None) -> None:
    """Simple binary-little-endian PLY point cloud."""
    pts = np.asarray(points, np.float32)
    n = len(pts)
    props = ["property float x", "property float y", "property float z"]
    if colors is not None:
        props += ["property uchar red", "property uchar green", "property uchar blue"]
    header = (
        "ply\nformat binary_little_endian 1.0\n"
        f"element vertex {n}\n" + "\n".join(props) + "\nend_header\n"
    )
    with open(path, "wb") as f:
        f.write(header.encode())
        if colors is not None:
            c = np.asarray(colors)
            if c.max() <= 1.0:
                c = c * 255
            c = np.clip(c, 0, 255).astype(np.uint8)
            row = np.zeros(n, dtype=[("xyz", np.float32, 3), ("rgb", np.uint8, 3)])
            row["xyz"] = pts
            row["rgb"] = c
            f.write(row.tobytes())
        else:
            f.write(pts.tobytes())


def read_ply(path: str):
    """Minimal binary PLY vertex reader -> dict of property arrays."""
    with open(path, "rb") as f:
        assert f.readline().strip() == b"ply"
        fmt = f.readline().split()[1]
        props, n = [], 0
        while True:
            line = f.readline().decode().strip()
            if line == "end_header":
                break
            parts = line.split()
            if parts[0] == "element" and parts[1] == "vertex":
                n = int(parts[2])
            elif parts[0] == "property":
                props.append((parts[2], parts[1]))
        np_map = {"float": "f4", "float32": "f4", "uchar": "u1", "uint8": "u1",
                  "double": "f8", "int": "i4"}
        dtype = np.dtype([(name, np_map[t]) for name, t in props])
        arr = np.frombuffer(f.read(n * dtype.itemsize), dtype=dtype, count=n)
        return {name: np.array(arr[name]) for name, _ in props}


# 3DGS PLY layout (graphdeco convention: x,y,z,nx,ny,nz,f_dc_*,f_rest_*,
# opacity (logit), scale_* (log), rot_* (wxyz))
def write_gs_ply(path: str, means, scales, rotations_wxyz, harmonics, opacities) -> None:
    """Write world-space gaussians in the standard 3DGS .ply layout
    (reference: utils/export/gs.py:export_to_gs_ply via gsply helpers)."""
    means = np.asarray(means, np.float32)
    n = len(means)
    d_sh = np.asarray(harmonics).shape[-1]
    n_rest = 3 * (d_sh - 1)
    names = (
        ["x", "y", "z", "nx", "ny", "nz"]
        + [f"f_dc_{i}" for i in range(3)]
        + [f"f_rest_{i}" for i in range(n_rest)]
        + ["opacity"]
        + [f"scale_{i}" for i in range(3)]
        + [f"rot_{i}" for i in range(4)]
    )
    dtype = np.dtype([(nm, np.float32) for nm in names])
    out = np.zeros(n, dtype=dtype)
    out["x"], out["y"], out["z"] = means.T
    h = np.asarray(harmonics, np.float32)  # (N, 3, d_sh)
    for i in range(3):
        out[f"f_dc_{i}"] = h[:, i, 0]
    rest = h[:, :, 1:].transpose(0, 2, 1).reshape(n, -1) if d_sh > 1 else None
    for i in range(n_rest):
        out[f"f_rest_{i}"] = rest[:, i]
    op = np.clip(np.asarray(opacities, np.float32), 1e-6, 1 - 1e-6)
    out["opacity"] = np.log(op / (1 - op))  # store logit
    sc = np.clip(np.asarray(scales, np.float32), 1e-10, None)
    for i in range(3):
        out[f"scale_{i}"] = np.log(sc[:, i])
    rw = np.asarray(rotations_wxyz, np.float32)
    for i in range(4):
        out[f"rot_{i}"] = rw[:, i]
    header = (
        "ply\nformat binary_little_endian 1.0\n"
        f"element vertex {n}\n"
        + "\n".join(f"property float {nm}" for nm in names)
        + "\nend_header\n"
    )
    with open(path, "wb") as f:
        f.write(header.encode())
        f.write(out.tobytes())

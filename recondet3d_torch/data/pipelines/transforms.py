"""Host-side data pipeline transforms (numpy/cv2): the port's copy of
``recondet3d/data/pipelines/transforms.py``, registered in the port's
``PIPELINES``.

Re-implementations of the transforms the ResDet3D configs use
(reference: projects/mmdet3d_plugin/datasets/pipelines/transform_3d.py —
PadMultiViewImage:126, NormalizeMultiviewImage:178,
ScaleImageMultiViewImage:214, PhotoMetricDistortionMultiViewImage:253,
ImageAug3D:21; and mmdetection3d/mmdet3d/datasets/pipelines/ —
LoadPointsFromFile:334, LoadMultiViewImageFromFiles:11,
LoadAnnotations3D:457, GlobalRotScaleTrans, RandomFlip3D,
PointsRangeFilter, ObjectNameFilter, PointShuffle, DefaultFormatBundle3D,
Collect3D). All operate on the results-dict protocol and run in the host
loader (device work happens in the model).

Image files are read through ``recondet3d_torch.data.image_io`` (binary PPM
without OpenCV, other formats through cv2, in cv2's BGR order as there).
The resizes, colour conversions and warps import cv2 when they run, as in
the JAX package: a host without OpenCV can run every other transform.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from recondet3d_torch.core.box3d import LiDARBoxes3D
from recondet3d_torch.core.registry import PIPELINES
from recondet3d_torch.data.image_io import imread_rgb

__all__ = [
    "Compose",
    "LoadPointsFromFile",
    "LoadMultiViewImageFromFiles",
    "LoadAnnotations3D",
    "PadMultiViewImage",
    "NormalizeMultiviewImage",
    "ScaleImageMultiViewImage",
    "PhotoMetricDistortionMultiViewImage",
    "GlobalRotScaleTrans",
    "RandomFlip3D",
    "PointsRangeFilter",
    "ObjectRangeFilter",
    "ObjectNameFilter",
    "PointShuffle",
    "DefaultFormatBundle3D",
    "Collect3D",
    "LoadPointsFromMultiSweeps",
    "ObjectNoise",
    "LoadMultiViewImageFromFilesWaymo",
    "MultiScaleFlipAug3D",
]


class Compose:
    def __init__(self, transforms: Sequence):
        self.transforms = [
            PIPELINES.build(t) if isinstance(t, dict) else t for t in transforms
        ]

    def __call__(self, results):
        for t in self.transforms:
            results = t(results)
            if results is None:
                return None
        return results


@PIPELINES.register()
class LoadPointsFromFile:
    def __init__(self, coord_type="LIDAR", load_dim=5, use_dim=(0, 1, 2),
                 shift_height=False, **kw):
        self.load_dim = load_dim
        self.use_dim = list(use_dim) if not isinstance(use_dim, int) else list(range(use_dim))

    def __call__(self, results):
        pts = np.fromfile(results["pts_filename"], np.float32)
        pts = pts.reshape(-1, self.load_dim)[:, self.use_dim]
        results["points"] = pts
        return results


@PIPELINES.register()
class LoadMultiViewImageFromFiles:
    def __init__(self, to_float32=False, color_type="unchanged"):
        self.to_float32 = to_float32

    def __call__(self, results):
        imgs = [imread_rgb(p)[..., ::-1] for p in results["img_filename"]]  # BGR, as cv2.imread
        img = np.stack(imgs, axis=-1)
        if self.to_float32:
            img = img.astype(np.float32)
        results["img"] = [img[..., i] for i in range(img.shape[-1])]
        results["img_shape"] = imgs[0].shape
        results["ori_shape"] = imgs[0].shape
        results["pad_shape"] = imgs[0].shape
        results["scale_factor"] = 1.0
        results["img_norm_cfg"] = dict(
            mean=np.zeros(3, np.float32), std=np.ones(3, np.float32), to_rgb=False
        )
        return results


@PIPELINES.register()
class LoadAnnotations3D:
    def __init__(self, with_bbox_3d=True, with_label_3d=True, **kw):
        self.with_bbox_3d = with_bbox_3d
        self.with_label_3d = with_label_3d

    def __call__(self, results):
        ann = results.get("ann_info", {})
        if self.with_bbox_3d:
            results["gt_bboxes_3d"] = LiDARBoxes3D(ann["gt_bboxes_3d"]) \
                if len(ann.get("gt_bboxes_3d", [])) else LiDARBoxes3D(np.zeros((0, 9)))
        if self.with_label_3d:
            results["gt_labels_3d"] = np.asarray(ann.get("gt_labels_3d", []), np.int64)
        return results


@PIPELINES.register()
class PadMultiViewImage:
    """Pad multi-view images to fixed size or size divisor
    (reference: transform_3d.py:126)."""

    def __init__(self, size=None, size_divisor=None, pad_val=0):
        self.size = size
        self.size_divisor = size_divisor
        self.pad_val = pad_val

    def __call__(self, results):
        padded = []
        for img in results["img"]:
            h, w = img.shape[:2]
            if self.size is not None:
                th, tw = self.size
            else:
                d = self.size_divisor
                th, tw = ((h + d - 1) // d) * d, ((w + d - 1) // d) * d
            out = np.full((th, tw) + img.shape[2:], self.pad_val, img.dtype)
            out[:h, :w] = img
            padded.append(out)
        results["img"] = padded
        results["img_shape"] = [i.shape for i in padded]
        results["pad_shape"] = [i.shape for i in padded]
        results["pad_size_divisor"] = self.size_divisor
        return results


@PIPELINES.register()
class NormalizeMultiviewImage:
    """(reference: transform_3d.py:178) mean/std normalize + BGR->RGB."""

    def __init__(self, mean, std, to_rgb=True):
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)
        self.to_rgb = to_rgb

    def __call__(self, results):
        out = []
        for img in results["img"]:
            img = img.astype(np.float32)
            if self.to_rgb:
                img = img[..., ::-1]
            out.append((img - self.mean) / self.std)
        results["img"] = out
        results["img_norm_cfg"] = dict(mean=self.mean, std=self.std, to_rgb=self.to_rgb)
        return results


@PIPELINES.register()
class ScaleImageMultiViewImage:
    """Resize all views by a fixed factor or to a target size and rescale
    lidar2img accordingly (reference: transform_3d.py:214)."""

    def __init__(self, scales=0.5):
        self.scales = scales

    def __call__(self, results):
        import cv2

        out, l2i = [], []
        for i, img in enumerate(results["img"]):
            h, w = img.shape[:2]
            if isinstance(self.scales, (tuple, list)):
                tw, th = self.scales
            else:
                th, tw = int(h * self.scales), int(w * self.scales)
            sy, sx = th / h, tw / w
            out.append(cv2.resize(img, (tw, th), interpolation=cv2.INTER_LINEAR))
            scale = np.eye(4)
            scale[0, 0], scale[1, 1] = sx, sy
            if "lidar2img" in results:
                l2i.append(scale @ results["lidar2img"][i])
        results["img"] = out
        if l2i:
            results["lidar2img"] = l2i
        results["img_shape"] = [i.shape for i in out]
        return results


@PIPELINES.register()
class PhotoMetricDistortionMultiViewImage:
    """Random brightness/contrast/saturation/hue/channel-swap
    (reference: transform_3d.py:253; same op order as mmdet's version)."""

    def __init__(self, brightness_delta=32, contrast_range=(0.5, 1.5),
                 saturation_range=(0.5, 1.5), hue_delta=18, seed=None):
        self.brightness_delta = brightness_delta
        self.contrast_lower, self.contrast_upper = contrast_range
        self.saturation_lower, self.saturation_upper = saturation_range
        self.hue_delta = hue_delta
        self.rng = np.random.default_rng(seed)

    def __call__(self, results):
        import cv2

        out = []
        for img in results["img"]:
            img = img.astype(np.float32)
            r = self.rng
            if r.integers(2):
                img += r.uniform(-self.brightness_delta, self.brightness_delta)
            contrast_first = r.integers(2)
            if contrast_first and r.integers(2):
                img *= r.uniform(self.contrast_lower, self.contrast_upper)
            hsv = cv2.cvtColor(np.clip(img, 0, 255).astype(np.uint8), cv2.COLOR_BGR2HSV).astype(np.float32)
            if r.integers(2):
                hsv[..., 1] *= r.uniform(self.saturation_lower, self.saturation_upper)
            if r.integers(2):
                hsv[..., 0] = (hsv[..., 0] + r.uniform(-self.hue_delta, self.hue_delta)) % 180
            img = cv2.cvtColor(np.clip(hsv, 0, 255).astype(np.uint8), cv2.COLOR_HSV2BGR).astype(np.float32)
            if not contrast_first and r.integers(2):
                img *= r.uniform(self.contrast_lower, self.contrast_upper)
            if r.integers(2):
                img = img[..., r.permutation(3)]
            out.append(img)
        results["img"] = out
        return results


@PIPELINES.register()
class GlobalRotScaleTrans:
    """Random rotation/scale/translation of points + boxes
    (reference: mmdet3d pipelines/transforms_3d.py GlobalRotScaleTrans)."""

    def __init__(self, rot_range=(-0.785, 0.785), scale_ratio_range=(0.95, 1.05),
                 translation_std=(0, 0, 0), seed=None):
        self.rot_range = rot_range
        self.scale_ratio_range = scale_ratio_range
        self.translation_std = np.asarray(translation_std, np.float64)
        self.rng = np.random.default_rng(seed)

    def __call__(self, results):
        angle = self.rng.uniform(*self.rot_range)
        scale = self.rng.uniform(*self.scale_ratio_range)
        trans = self.rng.normal(scale=self.translation_std, size=3)

        cos, sin = np.cos(angle), np.sin(angle)
        R = np.array([[cos, -sin, 0], [sin, cos, 0], [0, 0, 1]])
        pts = results["points"]
        pts[:, :3] = pts[:, :3] @ R.T * scale + trans
        results["points"] = pts
        if "gt_bboxes_3d" in results and len(results["gt_bboxes_3d"]):
            results["gt_bboxes_3d"].rotate(angle).scale(scale).translate(trans)
        results["pcd_rotation"] = R
        results["pcd_scale_factor"] = scale
        results["pcd_trans"] = trans
        return results


@PIPELINES.register()
class RandomFlip3D:
    """BEV flip of points/boxes (reference: mmdet3d RandomFlip3D)."""

    def __init__(self, sync_2d=False, flip_ratio_bev_horizontal=0.0,
                 flip_ratio_bev_vertical=0.0, seed=None, **kw):
        self.ph = flip_ratio_bev_horizontal
        self.pv = flip_ratio_bev_vertical
        self.rng = np.random.default_rng(seed)

    def __call__(self, results):
        # TTA (MultiScaleFlipAug3D) pre-sets the flip decisions; only
        # randomize when absent (reference: RandomFlip3D.__call__ — 'if
        # pcd_horizontal_flip not in input_dict' guards)
        if "pcd_horizontal_flip" in results:
            fh = bool(results["pcd_horizontal_flip"])
        else:
            fh = self.rng.random() < self.ph
        if "pcd_vertical_flip" in results:
            fv = bool(results["pcd_vertical_flip"])
        else:
            fv = self.rng.random() < self.pv
        pts = np.array(results["points"])  # copy: TTA branches share input
        if (fh or fv) and "gt_bboxes_3d" in results and len(results["gt_bboxes_3d"]):
            b = results["gt_bboxes_3d"]
            results["gt_bboxes_3d"] = type(b)(b.tensor.copy())
        if fh:
            pts[:, 1] = -pts[:, 1]
            if "gt_bboxes_3d" in results and len(results["gt_bboxes_3d"]):
                results["gt_bboxes_3d"].flip("horizontal")
        if fv:
            pts[:, 0] = -pts[:, 0]
            if "gt_bboxes_3d" in results and len(results["gt_bboxes_3d"]):
                results["gt_bboxes_3d"].flip("vertical")
        results["points"] = pts
        results["pcd_horizontal_flip"] = fh
        results["pcd_vertical_flip"] = fv
        return results


@PIPELINES.register()
class PointsRangeFilter:
    def __init__(self, point_cloud_range):
        self.pcr = np.asarray(point_cloud_range, np.float64)

    def __call__(self, results):
        pts = results["points"]
        m = np.all(pts[:, :3] >= self.pcr[:3], 1) & np.all(pts[:, :3] <= self.pcr[3:], 1)
        results["points"] = pts[m]
        return results


@PIPELINES.register()
class ObjectRangeFilter:
    def __init__(self, point_cloud_range):
        self.bev_range = np.asarray(point_cloud_range)[[0, 1, 3, 4]]

    def __call__(self, results):
        boxes = results["gt_bboxes_3d"]
        m = boxes.in_range_bev(self.bev_range)
        results["gt_bboxes_3d"] = boxes[m]
        results["gt_labels_3d"] = results["gt_labels_3d"][m]
        return results


@PIPELINES.register()
class ObjectNameFilter:
    def __init__(self, classes):
        self.classes = list(classes)

    def __call__(self, results):
        labels = results["gt_labels_3d"]
        m = (labels >= 0) & (labels < len(self.classes))
        results["gt_bboxes_3d"] = results["gt_bboxes_3d"][m]
        results["gt_labels_3d"] = labels[m]
        return results


@PIPELINES.register()
class PointShuffle:
    def __init__(self, seed=None):
        self.rng = np.random.default_rng(seed)

    def __call__(self, results):
        results["points"] = results["points"][self.rng.permutation(len(results["points"]))]
        return results


@PIPELINES.register()
class ImageAug3D:
    """Per-view resize/crop/flip/rotate with img_aug_matrix bookkeeping
    (reference: transform_3d.py:21-123 ImageAug3D — BEVFusion-style image
    augmentation; the 3x3 augmentation matrices let heads unproject
    through the augmented images)."""

    def __init__(self, final_dim=(256, 704), resize_lim=(0.38, 0.55),
                 bot_pct_lim=(0.0, 0.0), rot_lim=(0.0, 0.0), rand_flip=False,
                 is_train=True, seed=None):
        self.final_dim = final_dim
        self.resize_lim = resize_lim
        self.bot_pct_lim = bot_pct_lim
        self.rot_lim = rot_lim
        self.rand_flip = rand_flip
        self.is_train = is_train
        self.rng = np.random.default_rng(seed)

    def _sample(self, H, W):
        fH, fW = self.final_dim
        if self.is_train:
            resize = self.rng.uniform(*self.resize_lim)
            newW, newH = int(W * resize), int(H * resize)
            crop_h = int((1 - self.rng.uniform(*self.bot_pct_lim)) * newH) - fH
            crop_w = int(self.rng.uniform(0, max(0, newW - fW)))
            flip = self.rand_flip and self.rng.random() < 0.5
            rot = self.rng.uniform(*self.rot_lim)
        else:
            resize = np.mean(self.resize_lim)
            newW, newH = int(W * resize), int(H * resize)
            crop_h = int((1 - np.mean(self.bot_pct_lim)) * newH) - fH
            crop_w = int(max(0, newW - fW) / 2)
            flip, rot = False, 0.0
        crop = (crop_w, max(crop_h, 0), crop_w + fW, max(crop_h, 0) + fH)
        return resize, crop, flip, rot

    def __call__(self, results):
        import cv2

        fH, fW = self.final_dim
        out_imgs, mats = [], []
        for img in results["img"]:
            H, W = img.shape[:2]
            resize, crop, flip, rot = self._sample(H, W)
            im = cv2.resize(img, (int(W * resize), int(H * resize)))
            im = im[crop[1]:crop[3], crop[0]:crop[2]]
            pad_h, pad_w = fH - im.shape[0], fW - im.shape[1]
            if pad_h > 0 or pad_w > 0:
                im = np.pad(im, ((0, max(pad_h, 0)), (0, max(pad_w, 0)), (0, 0)))
            im = im[:fH, :fW]
            if flip:
                im = im[:, ::-1]
            if rot:
                M = cv2.getRotationMatrix2D((fW / 2, fH / 2), rot, 1.0)
                im = cv2.warpAffine(im, M, (fW, fH))
            out_imgs.append(im)
            A = np.eye(3)
            A[0, 0] = A[1, 1] = resize
            A[0, 2] -= crop[0]
            A[1, 2] -= crop[1]
            if flip:
                F = np.array([[-1, 0, fW], [0, 1, 0], [0, 0, 1.0]])
                A = F @ A
            if rot:
                th = -rot * np.pi / 180
                c, s = np.cos(th), np.sin(th)
                T1 = np.array([[1, 0, -fW / 2], [0, 1, -fH / 2], [0, 0, 1.0]])
                R = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1.0]])
                A = np.linalg.inv(T1) @ R @ T1 @ A
            mats.append(A)
        results["img"] = out_imgs
        results["img_aug_matrix"] = mats
        results["img_shape"] = [i.shape for i in out_imgs]
        return results


@PIPELINES.register()
class MyResize:
    """Keep-ratio multi-view resize with lidar2img rescale
    (reference: transform_3d.py:421-700 MyResize, the essential path)."""

    def __init__(self, img_scale=None, keep_ratio=True):
        self.img_scale = img_scale
        self.keep_ratio = keep_ratio

    def __call__(self, results):
        import cv2

        tw, th = self.img_scale
        out, l2i = [], []
        for i, img in enumerate(results["img"]):
            h, w = img.shape[:2]
            if self.keep_ratio:
                s = min(tw / w, th / h)
                nw, nh = int(w * s + 0.5), int(h * s + 0.5)
            else:
                nw, nh = tw, th
            out.append(cv2.resize(img, (nw, nh)))
            sx, sy = nw / w, nh / h
            S = np.eye(4)
            S[0, 0], S[1, 1] = sx, sy
            if "lidar2img" in results:
                l2i.append(S @ results["lidar2img"][i])
        results["img"] = out
        if l2i:
            results["lidar2img"] = l2i
        results["img_shape"] = [i.shape for i in out]
        results["scale_factor"] = np.array([sx, sy, sx, sy], np.float32)
        return results


@PIPELINES.register()
class MyNormalize(NormalizeMultiviewImage):
    """(reference: transform_3d.py:701 — same math as NormalizeMultiview)."""


@PIPELINES.register()
class MyPad(PadMultiViewImage):
    """(reference: transform_3d.py:739 — same behavior as PadMultiView)."""


@PIPELINES.register()
class MyFlip3D(RandomFlip3D):
    """(reference: transform_3d.py:806 — flip points/boxes + record flags)."""


@PIPELINES.register()
class DefaultFormatBundle3D:
    """Stack multi-view images to (N, H, W, 3) arrays (our format; the
    reference stacks channel-first DataContainers)."""

    def __init__(self, class_names=None, with_label=True):
        self.with_label = with_label

    def __call__(self, results):
        if "img" in results and isinstance(results["img"], list):
            results["img"] = np.stack(results["img"])
        return results


@PIPELINES.register()
class Collect3D:
    def __init__(self, keys, meta_keys=()):
        self.keys = keys
        self.meta_keys = meta_keys

    def __call__(self, results):
        out = {k: results[k] for k in self.keys if k in results}
        out["img_metas"] = {k: results[k] for k in self.meta_keys if k in results}
        return out


@PIPELINES.register()
class LoadPointsFromMultiSweeps:
    """Aggregate previous lidar sweeps into the key frame
    (reference: mmdet3d/datasets/pipelines/loading.py
    LoadPointsFromMultiSweeps:99-234 — key frame time channel zeroed,
    sweeps transformed by sensor2lidar R/t, dt in seconds appended at
    column 4, optional close-point removal, random sweep choice in train /
    nearest-N in test)."""

    def __init__(self, sweeps_num=10, load_dim=5, use_dim=(0, 1, 2, 4),
                 pad_empty_sweeps=False, remove_close=False, test_mode=False,
                 seed=None):
        self.sweeps_num = sweeps_num
        self.load_dim = load_dim
        self.use_dim = list(use_dim)
        self.pad_empty_sweeps = pad_empty_sweeps
        self.remove_close = remove_close
        self.test_mode = test_mode
        self.rng = np.random.default_rng(seed)

    @staticmethod
    def _remove_close(points, radius=1.0):
        keep = ~(
            (np.abs(points[:, 0]) < radius) & (np.abs(points[:, 1]) < radius)
        )
        return points[keep]

    def __call__(self, results):
        points = np.asarray(results["points"])
        if points.shape[1] < 5:
            points = np.concatenate(
                [points, np.zeros((len(points), 5 - points.shape[1]),
                                  points.dtype)], axis=1,
            )
        points[:, 4] = 0
        sweep_points = [points]
        ts = results["timestamp"]
        sweeps = results.get("sweeps", [])
        if self.pad_empty_sweeps and not sweeps:
            for _ in range(self.sweeps_num):
                sweep_points.append(
                    self._remove_close(points) if self.remove_close else points
                )
        else:
            if len(sweeps) <= self.sweeps_num:
                choices = np.arange(len(sweeps))
            elif self.test_mode:
                choices = np.arange(self.sweeps_num)
            else:
                choices = self.rng.choice(
                    len(sweeps), self.sweeps_num, replace=False
                )
            for idx in choices:
                sweep = sweeps[int(idx)]
                pts = np.fromfile(
                    sweep["data_path"], np.float32
                ).reshape(-1, self.load_dim).copy()
                if self.remove_close:
                    pts = self._remove_close(pts)
                pts[:, :3] = pts[:, :3] @ np.asarray(
                    sweep["sensor2lidar_rotation"]
                ).T
                pts[:, :3] += np.asarray(sweep["sensor2lidar_translation"])
                pts[:, 4] = ts - sweep["timestamp"] / 1e6
                sweep_points.append(pts.astype(points.dtype))
        out = np.concatenate(sweep_points, axis=0)[:, self.use_dim]
        results["points"] = out
        return results


@PIPELINES.register()
class ObjectNoise:
    """Per-object random rotation + translation with box-collision
    rejection, moving the contained points with the box
    (reference: transforms_3d.py ObjectNoise:359-411 wrapping the numba
    noise_per_object_v3_ in box_np_ops; the collision test here is a
    numpy separating-axis check on the rotated BEV rectangles — this is a
    host loader transform, so it must not dispatch per-sample device ops)."""

    def __init__(self, translation_std=(0.25, 0.25, 0.25),
                 global_rot_range=(0.0, 0.0),
                 rot_range=(-0.15707963267, 0.15707963267),
                 num_try=100, seed=None):
        self.translation_std = np.asarray(translation_std)
        self.rot_range = rot_range
        self.num_try = num_try
        self.rng = np.random.default_rng(seed)

    @staticmethod
    def _points_in_box(points, box):
        """(P, 3) x (7,) -> (P,) bool; z spans [z, z+dz] (bottom center)."""
        c, s = np.cos(box[6]), np.sin(box[6])
        px = points[:, 0] - box[0]
        py = points[:, 1] - box[1]
        lx = px * c + py * s
        ly = -px * s + py * c
        return (
            (np.abs(lx) <= box[3] / 2)
            & (np.abs(ly) <= box[4] / 2)
            & (points[:, 2] >= box[2])
            & (points[:, 2] <= box[2] + box[5])
        )

    def __call__(self, results):
        boxes = results["gt_bboxes_3d"]
        arr = boxes.tensor if hasattr(boxes, "tensor") else np.asarray(boxes)
        points = np.asarray(results["points"])
        n = len(arr)
        if n == 0:
            return results
        inside = np.stack(
            [self._points_in_box(points[:, :3], arr[i, :7]) for i in range(n)]
        )  # (n_boxes, n_points) bool
        for i in range(n):
            for _ in range(self.num_try):
                dt = self.rng.normal(0, self.translation_std)
                dr = self.rng.uniform(*self.rot_range)
                cand = arr[i].copy()
                cand[:3] += dt
                cand[6] += dr
                others = np.delete(arr, i, axis=0)
                if len(others) and self._collides(cand, others):
                    continue
                # rotate the object's points about its center, translate
                m = np.asarray(inside[i]).astype(bool)
                c, s = np.cos(dr), np.sin(dr)
                R = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
                rel = points[m, :3] - arr[i, :3]
                points[m, :3] = rel @ R.T + arr[i, :3] + dt
                arr[i] = cand
                break
        results["points"] = points
        if hasattr(boxes, "tensor"):
            boxes.tensor = arr
        else:
            results["gt_bboxes_3d"] = arr
        return results

    @staticmethod
    def _bev_corners(b):
        """(M, 7) -> (M, 4, 2) rotated BEV rectangle corners."""
        c, s = np.cos(b[:, 6]), np.sin(b[:, 6])
        ox = np.stack([b[:, 3], b[:, 3], -b[:, 3], -b[:, 3]], 1) / 2
        oy = np.stack([-b[:, 4], b[:, 4], b[:, 4], -b[:, 4]], 1) / 2
        x = b[:, 0:1] + ox * c[:, None] - oy * s[:, None]
        y = b[:, 1:2] + ox * s[:, None] + oy * c[:, None]
        return np.stack([x, y], -1)

    @classmethod
    def _collides(cls, box, others):
        """Separating-axis test between one rotated BEV rect and M others."""
        ca = cls._bev_corners(box[None])[0]  # (4, 2)
        cb = cls._bev_corners(others)  # (M, 4, 2)
        # candidate axes: edge normals of both rectangles (2 each)
        def axes(corners):
            e = np.diff(np.concatenate([corners, corners[..., :1, :]], -2), axis=-2)
            n = np.stack([-e[..., 1], e[..., 0]], -1)
            return n[..., :2, :]  # (.., 2, 2) two unique normals

        ax = np.concatenate(
            [np.broadcast_to(axes(ca), (len(others), 2, 2)), axes(cb)], axis=1
        )  # (M, 4, 2)
        pa = np.einsum("mkd,cd->mkc", ax, ca)  # (M, 4, 4)
        pb = np.einsum("mkd,mcd->mkc", ax, cb)
        sep = (pa.max(-1) < pb.min(-1)) | (pb.max(-1) < pa.min(-1))
        return bool((~sep.any(-1)).any())


@PIPELINES.register()
class LoadMultiViewImageFromFilesWaymo:
    """Waymo variant: pads the two shorter (886-row) side cameras up to
    img_scale rows with zeros so all 5 views stack
    (reference: transform_3d.py LoadMultiViewImageFromFilesWaymo:352-415)."""

    def __init__(self, to_float32=False, img_scale=None):
        self.to_float32 = to_float32
        self.img_scale = img_scale

    def _pad(self, img):
        if self.img_scale is not None and img.shape[0] != self.img_scale[0]:
            pad = np.zeros(
                (self.img_scale[0] - img.shape[0],) + img.shape[1:], img.dtype
            )
            img = np.concatenate([img, pad], axis=0)
        return img

    def __call__(self, results):
        imgs = [self._pad(np.ascontiguousarray(imread_rgb(p)[..., ::-1])) for p in results["img_filename"]]
        if self.to_float32:
            imgs = [i.astype(np.float32) for i in imgs]
        results["filename"] = results["img_filename"]
        results["img"] = imgs
        results["img_shape"] = imgs[0].shape
        results["ori_shape"] = imgs[0].shape
        results["pad_shape"] = imgs[0].shape
        results["img_norm_cfg"] = dict(
            mean=np.zeros(3, np.float32), std=np.ones(3, np.float32),
            to_rgb=False,
        )
        results["img_fields"] = ["img"]
        return results


@PIPELINES.register()
class MultiScaleFlipAug3D:
    """Test-time augmentation wrapper: runs the inner pipeline once per
    (scale, pts_scale, flip-direction, pcd flips) combination and stacks
    results per key (reference: mmdet3d/datasets/pipelines/
    test_time_aug.py MultiScaleFlipAug3D:11-120)."""

    def __init__(self, transforms, img_scale, pts_scale_ratio=1.0,
                 flip=False, flip_direction="horizontal",
                 pcd_horizontal_flip=False, pcd_vertical_flip=False):
        self.transforms = Compose(transforms)
        self.img_scale = img_scale if isinstance(img_scale, list) else [img_scale]
        self.pts_scale_ratio = (
            pts_scale_ratio if isinstance(pts_scale_ratio, list)
            else [float(pts_scale_ratio)]
        )
        self.flip = flip
        self.flip_direction = (
            flip_direction if isinstance(flip_direction, list)
            else [flip_direction]
        )
        self.pcd_horizontal_flip = pcd_horizontal_flip
        self.pcd_vertical_flip = pcd_vertical_flip

    def __call__(self, results):
        aug_data = []
        flip_aug = [True] if self.flip else [False]
        h_aug = [False, True] if self.flip and self.pcd_horizontal_flip else [False]
        v_aug = [False, True] if self.flip and self.pcd_vertical_flip else [False]
        for scale in self.img_scale:
            for pts_scale in self.pts_scale_ratio:
                for flip in flip_aug:
                    for h in h_aug:
                        for v in v_aug:
                            for direction in self.flip_direction:
                                r = dict(results)
                                r["scale"] = scale
                                r["flip"] = flip
                                r["pcd_scale_factor"] = pts_scale
                                r["flip_direction"] = direction
                                r["pcd_horizontal_flip"] = h
                                r["pcd_vertical_flip"] = v
                                data = self.transforms(r)
                                aug_data.append(data)
        return {
            key: [d[key] for d in aug_data] for key in aug_data[0]
        }

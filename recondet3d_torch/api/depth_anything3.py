"""DepthAnything3 public inference API (port of
``recondet3d/api/depth_anything3.py``): preprocess on the host -> forward
on the device -> Prediction -> Umeyama alignment to the input extrinsics ->
export.

``from_pretrained`` builds the preset on the card (``device="cuda"``, a
bf16 trunk) unless the caller passes ``device="cpu"`` (fp32, as the JAX
package picks bf16 on its accelerator and fp32 elsewhere). Weights come
from a local safetensors file in the upstream naming (``find_checkpoint``,
then ``download_checkpoint`` for hub names), loaded by
``load_da3_state_dict``; without one the model runs on random weights from
seed 0, flagged on the returned object. The forward's outputs reach the
host once (``data/output_processor.py``); extrinsics normalisation and the
alignment run in numpy on the host, as in the JAX package.
"""

from __future__ import annotations

import logging
import time
from typing import Optional, Sequence

import numpy as np
import torch

from recondet3d_torch.api.weights import download_checkpoint, find_checkpoint, load_da3_state_dict, load_safetensors
from recondet3d_torch.data.input_processor import InputProcessor
from recondet3d_torch.data.output_processor import OutputProcessor
from recondet3d_torch.models.da3.presets import MODEL_REGISTRY, build_da3
from recondet3d_torch.specs import Prediction
from recondet3d_torch.utils.device import resolve_device
from recondet3d_torch.utils.pose_align import align_poses_umeyama

__all__ = ["DepthAnything3"]

logger = logging.getLogger("recondet3d_torch.api")


def _affine_inverse_np(A):
    R = A[..., :3, :3]
    T = A[..., :3, 3:]
    Rt = np.swapaxes(R, -1, -2)
    out = np.tile(np.eye(4, dtype=A.dtype), A.shape[:-2] + (1, 1))
    out[..., :3, :3] = Rt
    out[..., :3, 3:] = -Rt @ T
    return out


def _to44(ext):
    if ext.shape[-2] == 3:
        out = np.tile(np.eye(4, dtype=ext.dtype), ext.shape[:-2] + (1, 1))
        out[..., :3, :] = ext
        return out
    return ext


class DepthAnything3:
    """Usage: ``DepthAnything3.from_pretrained("depth-anything/DA3-SMALL")``
    then ``.inference([img, ...])`` -> Prediction. ``DepthAnything3(model,
    name)`` wraps a DA3 net already built (and loaded) by the caller."""

    def __init__(self, model: torch.nn.Module, model_name: str, random_init: bool = False):
        self.model = model.eval()
        self.model_name = model_name
        self.random_init = random_init
        self.device = next(model.parameters()).device
        self.input_processor = InputProcessor()
        self.output_processor = OutputProcessor()

    @classmethod
    def from_pretrained(cls, name: str, cache_dir: str = "ckpts", dtype=None, checkpoint: Optional[str] = None,
                        with_gs: Optional[bool] = None, device="cuda") -> "DepthAnything3":
        dev = resolve_device(device)
        dtype = dtype or (torch.bfloat16 if dev.type == "cuda" else torch.float32)
        model = build_da3(name, dtype=dtype, with_gs=with_gs, device=dev)
        ckpt_path = checkpoint or find_checkpoint(name, cache_dir)
        if ckpt_path is None and "/" in name:
            ckpt_path = download_checkpoint(name, cache_dir)
        random_init = True
        if ckpt_path is not None:
            logger.info("loading weights from %s", ckpt_path)
            _, unfilled = load_da3_state_dict(model, load_safetensors(ckpt_path))
            if unfilled:
                logger.warning("%d params not found in checkpoint", len(unfilled))
            random_init = False
        else:
            logger.warning("no checkpoint found for %r in %r; running with random weights (depth values will be "
                           "meaningless)", name, cache_dir)
        return cls(model, name, random_init=random_init)

    @staticmethod
    def _normalize_extrinsics(ext: np.ndarray) -> np.ndarray:
        """First-camera-relative + median-translation scale normalization."""
        ext = _to44(ext.astype(np.float64))
        transform = _affine_inverse_np(ext[:1])
        ext_norm = ext @ transform
        c2ws = _affine_inverse_np(ext_norm)
        dists = np.linalg.norm(c2ws[:, :3, 3], axis=-1)
        median = max(float(np.median(dists)), 1e-1)
        ext_norm[:, :3, 3] /= median
        return ext_norm.astype(np.float32)

    def inference(
        self,
        image: Sequence,
        extrinsics: Optional[np.ndarray] = None,
        intrinsics: Optional[np.ndarray] = None,
        align_to_input_ext_scale: bool = True,
        infer_gs: bool = False,
        use_ray_pose: bool = False,
        ref_view_strategy: str = "saddle_balanced",
        process_res: int = 504,
        process_res_method: str = "upper_bound_resize",
        export_dir: Optional[str] = None,
        export_format: str = "mini_npz",
        export_feat_layers: Optional[Sequence[int]] = None,
        conf_thresh_percentile: float = 40.0,
        num_max_points: int = 1_000_000,
        show_cameras: bool = True,
        export_kwargs: Optional[dict] = None,
    ) -> Prediction:
        t0 = time.time()
        self.input_processor.process_res = process_res
        self.input_processor.process_res_method = process_res_method
        batch, ex, ix, raw_imgs = self.input_processor(image, extrinsics, intrinsics)
        logger.info("preprocess %.2fs shape=%s", time.time() - t0, batch.shape)

        ext_t = ixt_t = None
        if ex is not None:
            ext_t = torch.from_numpy(self._normalize_extrinsics(ex[0])[None]).to(self.device)
            ixt_t = torch.from_numpy(np.asarray(ix, np.float32)).to(self.device)

        t0 = time.time()
        with torch.inference_mode():
            out = self.model(torch.from_numpy(batch).to(self.device), ext_t, ixt_t,
                             export_feat_layers=tuple(export_feat_layers or ()), infer_gs=infer_gs,
                             use_ray_pose=use_ray_pose, ref_view_strategy=ref_view_strategy)
            prediction = self.output_processor(out)
        logger.info("forward %.2fs", time.time() - t0)

        if ex is not None:
            prediction.intrinsics = ix[0]
            _, _, scale, aligned = align_poses_umeyama(
                prediction.extrinsics, ex[0], ransac=len(ex[0]) >= 10, return_aligned=True, random_state=42,
            )
            if align_to_input_ext_scale:
                prediction.extrinsics = _to44(ex[0].astype(np.float64))[:, :3].astype(np.float32)
                prediction.depth = prediction.depth / scale
            else:
                prediction.extrinsics = aligned[:, :3].astype(np.float32)

        prediction.processed_images = raw_imgs

        if export_dir is not None:
            from recondet3d_torch.data.export import export

            kw = dict(export_kwargs or {})
            if "glb" in export_format:
                kw.update(conf_thresh_percentile=conf_thresh_percentile, max_points=num_max_points,
                          show_cameras=show_cameras)
            export(prediction, export_format, export_dir, device=self.device, **kw)
        return prediction

    @staticmethod
    def available_models():
        return list(MODEL_REGISTRY)

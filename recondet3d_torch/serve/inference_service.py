"""Local vs HTTP-backend inference client (port of
``recondet3d/serve/inference_service.py``; reference:
depth_anything_3/services/inference_service.py:28-239). The local route
builds the model on ``device`` (default the card)."""

from __future__ import annotations

import json
import time
import urllib.request
from typing import Optional, Sequence

__all__ = ["InferenceService"]


class InferenceService:
    def __init__(self, model_name: str, cache_dir: str = "ckpts",
                 backend_url: Optional[str] = None, device="cuda"):
        self.model_name = model_name
        self.cache_dir = cache_dir
        self.backend_url = backend_url
        self.device = device
        self._model = None

    def run_inference(self, images: Sequence[str], **kwargs):
        if self.backend_url:
            return self.run_backend_inference(images, **kwargs)
        return self.run_local_inference(images, **kwargs)

    def run_local_inference(self, images, **kwargs):
        if self._model is None:
            from recondet3d_torch.api import DepthAnything3

            self._model = DepthAnything3.from_pretrained(
                self.model_name, cache_dir=self.cache_dir, device=self.device
            )
        return self._model.inference(list(images), **kwargs)

    def run_backend_inference(self, images, poll_interval: float = 1.0,
                              timeout: float = 600.0, **kwargs):
        payload = dict(images=list(images), **{
            k: v for k, v in kwargs.items()
            if k in ("export_format", "process_res", "infer_gs",
                     "use_ray_pose", "ref_view_strategy")
        })
        req = urllib.request.Request(
            f"{self.backend_url}/inference",
            data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"},
        )
        with urllib.request.urlopen(req) as resp:
            task = json.loads(resp.read())
        task_id = task["task_id"]
        deadline = time.time() + timeout
        while time.time() < deadline:
            with urllib.request.urlopen(f"{self.backend_url}/status/{task_id}") as resp:
                status = json.loads(resp.read())
            if status["status"] == "done":
                return status["result"]
            if status["status"] == "failed":
                raise RuntimeError(f"backend task failed: {status['error']}")
            time.sleep(poll_interval)
        raise TimeoutError(f"backend task {task_id} timed out")

"""Model-resident inference HTTP backend (port of
``recondet3d/serve/backend.py``: the same routes and JSON contract; the
model lives on the manager's ``device``, the card unless ``device="cpu"``
is asked for, and ``/device-memory`` reads ``torch.cuda``).

Re-implementation of the reference FastAPI service
(reference: depth_anything_3/services/backend.py:99-1417 — ModelManager
keeping the model loaded, a worker-thread task queue, endpoints for
inference / task status / memory / health, stale-task cleanup, and a
gallery manifest). FastAPI/uvicorn are absent from this image, so the
same surface is served with the stdlib ThreadingHTTPServer — no
dependencies, same JSON contract:

  POST /inference        {"images": [paths...], "export_format": ...}
  GET  /status/<task_id>
  GET  /tasks
  GET  /health
  GET  /device-memory    (the reference's /gpu-memory)
  GET  /gallery/manifest

Plus the browser app replacing the reference's gradio UI (see
recondet3d_torch/serve/webapp.py for the page and feature map):

  GET  /app                     the single-page app
  POST /upload                  multipart images or video -> queued task
  GET  /files/<task>/<f>        download an export artifact
  GET  /scene/<task>/meta       scene summary + camera frusta
  GET  /scene/<task>/points.bin filtered [x y z r g b] float32 stream
  GET  /scene/<task>/depth/<i>.png | image/<i>.jpg | measure?view&u&v
  POST /scene/<task>/gs_video   render 3DGS novel-view video
"""

from __future__ import annotations

import json
import os
import threading
import time
import traceback
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from queue import Empty, Queue
from typing import Dict, Optional

import torch

from recondet3d_torch.utils.logger import get_logger

logger = get_logger("recondet3d_torch.serve")

__all__ = ["ModelManager", "start_server", "create_server"]

STALE_TASK_SECONDS = 3600


class ModelManager:
    """Keeps the DA3 model resident; runs queued inference tasks on a
    worker thread (reference: backend.py ModelManager + task loop).

    The model is built on ``device`` at the first task. There is no
    fallback: a manager asked for the card on a host without one fails that
    task with ``resolve_device``'s error."""

    def __init__(self, model_name: str, cache_dir: str = "ckpts", workdir: str = "da3_backend",
                 device="cuda"):
        self.model_name = model_name
        self.cache_dir = cache_dir
        self.device = device
        self.workdir = os.path.abspath(workdir)
        os.makedirs(self.workdir, exist_ok=True)
        self._model = None
        self._lock = threading.Lock()
        self.tasks: Dict[str, dict] = {}
        self.queue: "Queue[str]" = Queue()
        self._stop = threading.Event()
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._cleaner = threading.Thread(target=self._cleanup_loop, daemon=True)

    def start(self):
        self._worker.start()
        self._cleaner.start()

    def stop(self):
        self._stop.set()

    @property
    def model(self):
        with self._lock:
            if self._model is None:
                from recondet3d_torch.api import DepthAnything3

                logger.info(f"loading model {self.model_name} on {self.device}")
                self._model = DepthAnything3.from_pretrained(
                    self.model_name, cache_dir=self.cache_dir, device=self.device
                )
            return self._model

    def reload(self):
        with self._lock:
            self._model = None

    def submit(self, payload: dict) -> str:
        task_id = uuid.uuid4().hex[:12]
        self.tasks[task_id] = dict(
            id=task_id, status="queued", created=time.time(), payload=payload,
            result=None, error=None,
        )
        self.queue.put(task_id)
        return task_id

    def _run(self):
        while not self._stop.is_set():
            try:
                task_id = self.queue.get(timeout=0.5)
            except Empty:
                continue
            task = self.tasks.get(task_id)
            if task is None:
                continue
            task["status"] = "running"
            task["started"] = time.time()
            try:
                task["result"] = self._infer(task_id, task["payload"])
                task["status"] = "done"
            except Exception as e:  # noqa: BLE001
                # the error before the status: a poller that reads "failed" finds its error
                task["error"] = f"{e}\n{traceback.format_exc()}"
                task["status"] = "failed"
                logger.error(f"task {task_id} failed: {e}")
            task["finished"] = time.time()

    def _infer(self, task_id: str, payload: dict) -> dict:
        images = payload["images"]
        export_dir = os.path.join(self.workdir, "tasks", task_id)
        pred = self.model.inference(
            images,
            export_dir=export_dir,
            export_format=payload.get("export_format", "mini_npz"),
            process_res=int(payload.get("process_res", 504)),
            infer_gs=bool(payload.get("infer_gs", False)),
            use_ray_pose=bool(payload.get("use_ray_pose", False)),
            ref_view_strategy=payload.get("ref_view_strategy", "saddle_balanced"),
        )
        # persist the scene arrays for the web app's viewer/measure/3DGS
        # endpoints (reference keeps workspaces per reconstruction,
        # app/gradio_app.py:40-156)
        from recondet3d_torch.serve.scene_store import save_scene

        save_scene(export_dir, pred)
        return dict(
            export_dir=export_dir,
            depth_shape=list(pred.depth.shape),
            num_views=int(pred.depth.shape[0]),
        )

    def _cleanup_loop(self):
        """Drop stale finished tasks (reference: backend.py:392-457)."""
        while not self._stop.is_set():
            now = time.time()
            stale = [
                tid for tid, t in list(self.tasks.items())
                if t["status"] in ("done", "failed")
                and now - t.get("finished", now) > STALE_TASK_SECONDS
            ]
            for tid in stale:
                self.tasks.pop(tid, None)
            self._stop.wait(60)

    def device_memory(self) -> dict:
        """Device memory of the manager's card (the reference's /gpu-memory,
        backend.py:1235): bytes the caching allocator holds for tensors and
        the card's total. A CPU manager has no such counts (None)."""
        dev = torch.device(self.device)
        if dev.type != "cuda":
            return {"bytes_in_use": None, "bytes_limit": None, "platform": dev.type, "kind": None}
        try:
            idx = dev.index if dev.index is not None else torch.cuda.current_device()
            return {
                "bytes_in_use": torch.cuda.memory_stats(idx).get("allocated_bytes.all.current", 0),
                "bytes_limit": torch.cuda.mem_get_info(idx)[1],
                "platform": "cuda",
                "kind": torch.cuda.get_device_name(idx),
            }
        except Exception as e:  # noqa: BLE001
            return {"error": str(e)}

    def gallery_manifest(self) -> list:
        tasks_dir = os.path.join(self.workdir, "tasks")
        if not os.path.isdir(tasks_dir):
            return []
        out = []
        for tid in sorted(os.listdir(tasks_dir)):
            d = os.path.join(tasks_dir, tid)
            out.append(dict(task_id=tid, files=sorted(os.listdir(d))))
        return out


def create_server(manager: ModelManager, host: str = "127.0.0.1", port: int = 8000):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet
            logger.info("%s " + fmt, self.address_string(), *args)

        def _json(self, obj, code=200):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path in ("/", "/dashboard"):
                html = _dashboard_html(manager)
                body = html.encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/html")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            elif self.path == "/health":
                self._json({"status": "ok", "model": manager.model_name})
            elif self.path in ("/device-memory", "/gpu-memory"):
                self._json(manager.device_memory())
            elif self.path == "/tasks":
                self._json(
                    {tid: {k: t[k] for k in ("status", "created")}
                     for tid, t in manager.tasks.items()}
                )
            elif self.path.startswith("/status/"):
                tid = self.path.split("/")[-1]
                t = manager.tasks.get(tid)
                if t is None:
                    self._json({"error": "unknown task"}, 404)
                else:
                    self._json({k: t[k] for k in ("id", "status", "result", "error")})
            elif self.path == "/gallery/manifest":
                self._json(manager.gallery_manifest())
            elif self.path == "/app":
                from recondet3d_torch.serve.webapp import app_html

                body = app_html().encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/html")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            elif self.path.startswith("/scene/"):
                from recondet3d_torch.serve.webapp import handle_scene_get

                try:
                    body, ctype, code = handle_scene_get(manager, self.path)
                except Exception as e:  # noqa: BLE001
                    body = json.dumps({"error": str(e)}).encode()
                    ctype, code = "application/json", 500
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            elif self.path.startswith("/files/"):
                # /files/<task_id>/<filename> — confined to the tasks dir
                parts = self.path.split("/", 3)
                if len(parts) != 4 or "/" in parts[3] or ".." in self.path:
                    return self._json({"error": "bad path"}, 400)
                root = os.path.join(manager.workdir, "tasks")
                full = os.path.realpath(os.path.join(root, parts[2], parts[3]))
                if not full.startswith(os.path.realpath(root) + os.sep) or \
                        not os.path.isfile(full):
                    return self._json({"error": "not found"}, 404)
                data = open(full, "rb").read()
                ctype = {
                    ".png": "image/png", ".jpg": "image/jpeg",
                    ".glb": "model/gltf-binary", ".json": "application/json",
                }.get(os.path.splitext(full)[1], "application/octet-stream")
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)
            else:
                self._json({"error": "not found"}, 404)

        def do_POST(self):
            if self.path == "/upload":
                ctype = self.headers.get("Content-Type", "")
                if "multipart/form-data" not in ctype:
                    return self._json({"error": "multipart form required"}, 400)
                length = int(self.headers.get("Content-Length", 0))
                body = self.rfile.read(length)
                files, fields = _parse_multipart(body, ctype)
                if not files:
                    return self._json({"error": "no images uploaded"}, 400)
                updir = os.path.join(
                    manager.workdir, "uploads", uuid.uuid4().hex[:12]
                )
                os.makedirs(updir, exist_ok=True)
                paths = []
                for field, name, data in files:
                    safe = os.path.basename(name) or f"img{len(paths)}.png"
                    p = os.path.join(updir, safe)
                    with open(p, "wb") as f:
                        f.write(data)
                    if field == "video":
                        # server-side frame extraction (reference:
                        # app/modules/file_handlers.py video inputs)
                        interval = float(fields.get("s_time_interval", 1.0))
                        paths.extend(_extract_video_frames(p, updir, interval))
                    else:
                        paths.append(p)
                if not paths:
                    return self._json({"error": "no frames extracted"}, 400)
                task_id = manager.submit(dict(
                    images=paths,
                    export_format=fields.get("export_format", "depth_vis"),
                    infer_gs=fields.get("infer_gs", "0") == "1",
                    ref_view_strategy=fields.get(
                        "ref_view_strategy", "saddle_balanced"),
                ))
                self._json({"task_id": task_id, "status": "queued"})
            elif self.path.startswith("/scene/"):
                from recondet3d_torch.serve.webapp import handle_scene_post

                length = int(self.headers.get("Content-Length", 0))
                try:
                    payload = json.loads(self.rfile.read(length) or b"{}")
                except json.JSONDecodeError:
                    return self._json({"error": "bad json"}, 400)
                try:
                    body, ctype, code = handle_scene_post(
                        manager, self.path, payload)
                except Exception as e:  # noqa: BLE001
                    body = json.dumps({"error": str(e)}).encode()
                    ctype, code = "application/json", 500
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            elif self.path == "/inference":
                length = int(self.headers.get("Content-Length", 0))
                try:
                    payload = json.loads(self.rfile.read(length) or b"{}")
                except json.JSONDecodeError:
                    return self._json({"error": "bad json"}, 400)
                if not payload.get("images"):
                    return self._json({"error": "'images' required"}, 400)
                task_id = manager.submit(payload)
                self._json({"task_id": task_id, "status": "queued"})
            elif self.path == "/reload":
                manager.reload()
                self._json({"status": "reloading"})
            else:
                self._json({"error": "not found"}, 404)

    return ThreadingHTTPServer((host, port), Handler)


def _dashboard_html(manager: ModelManager) -> str:
    """Status dashboard (reference: backend.py serves a dashboard HTML
    page with model/task/GPU status)."""
    mem = manager.device_memory()
    rows = "".join(
        f"<tr><td>{tid}</td><td>{t['status']}</td>"
        f"<td>{time.strftime('%H:%M:%S', time.localtime(t['created']))}</td></tr>"
        for tid, t in sorted(manager.tasks.items())
    )
    in_use = (mem.get("bytes_in_use") or 0) / 2 ** 30
    limit = (mem.get("bytes_limit") or 0) / 2 ** 30
    return f"""<!doctype html><html><head><title>recondet3d backend</title>
<style>body{{font-family:monospace;margin:2em}}table{{border-collapse:collapse}}
td,th{{border:1px solid #888;padding:4px 10px}}</style></head><body>
<h2>recondet3d inference backend</h2>
<p>model: <b>{manager.model_name}</b> &middot; platform: {mem.get('platform', '?')}
&middot; HBM: {in_use:.2f} / {limit:.2f} GiB</p>
<p>POST /inference {{"images": [...]}} &middot; GET /status/&lt;id&gt; &middot;
GET /tasks &middot; GET /device-memory &middot; GET /gallery/manifest</p>
<h3>tasks ({len(manager.tasks)})</h3>
<table><tr><th>id</th><th>status</th><th>created</th></tr>{rows}</table>
</body></html>"""


def _parse_multipart(body: bytes, content_type: str):
    """Minimal multipart/form-data parser (stdlib-only; the cgi module is
    deprecated). Returns ([(field, filename, bytes)], {field: value})."""
    import re

    m = re.search(r'boundary="?([^";]+)"?', content_type)
    if not m:
        return [], {}
    boundary = m.group(1).encode()
    files, fields = [], {}
    for part in body.split(b"--" + boundary):
        part = part.strip(b"\r\n")
        if not part or part == b"--":
            continue
        if b"\r\n\r\n" not in part:
            continue
        head, data = part.split(b"\r\n\r\n", 1)
        head_s = head.decode(errors="replace")
        name_m = re.search(r'name="([^"]*)"', head_s)
        file_m = re.search(r'filename="([^"]*)"', head_s)
        if file_m and file_m.group(1):
            files.append((name_m.group(1) if name_m else "",
                          file_m.group(1), data))
        elif name_m:
            fields[name_m.group(1)] = data.decode(errors="replace").strip()
    return files, fields


def _extract_video_frames(video_path: str, out_dir: str, interval_s: float,
                          max_frames: int = 32) -> list:
    """Sample frames from an uploaded video every ``interval_s`` seconds
    (reference: app/modules/file_handlers.py + services/input_handlers.py
    video handling). Reads the video with OpenCV (cv2); raises without it."""
    try:
        import cv2
    except ImportError as e:
        raise ImportError("video upload extracts its frames with OpenCV (cv2), which is not installed") from e

    cap = cv2.VideoCapture(video_path)
    fps = cap.get(cv2.CAP_PROP_FPS) or 30.0
    step = max(1, round(fps * max(interval_s, 1e-3)))
    paths = []
    idx = 0
    while len(paths) < max_frames:
        ok, frame = cap.read()
        if not ok:
            break
        if idx % step == 0:
            p = os.path.join(out_dir, f"frame_{len(paths):04d}.jpg")
            cv2.imwrite(p, frame)
            paths.append(p)
        idx += 1
    cap.release()
    return paths


def start_server(model_name: str, cache_dir: str = "ckpts", host: str = "127.0.0.1",
                 port: int = 8000, workdir: str = "da3_backend", device="cuda"):
    manager = ModelManager(model_name, cache_dir, workdir, device=device)
    manager.start()
    server = create_server(manager, host, port)
    logger.info(f"serving on http://{host}:{port}")
    try:
        server.serve_forever()
    finally:
        manager.stop()

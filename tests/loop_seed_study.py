"""tests/test_full_loop.py's experiment from several initial draws, on images
that both packages' loaders read unchanged.

    python tests/loop_seed_study.py --package torch --device cuda --seeds 0-6 --out study.jsonl
    python tests/loop_seed_study.py --package jax --seeds 0,4 --out study.jsonl
    python tests/loop_seed_study.py --package torch --device cpu --seeds 4 --cfg-options compute_dtype=float32

The structured fixture (``nuscenes_fixture.make_fixture(structured=True)``)
with each 90x160 image written as a 900x1600 binary PPM, every pixel
repeated 10x10: the loaders' size, so neither resizes and both read the same
bytes (the loaders' own resizes differ by 1 of 255). Then, for each seed,
the package's ``create_data`` -> ``train`` (150 steps, one checkpoint at the
end) -> ``test``, and the JAX test's gates on the result. The JAX package
draws its weights from ``--seed``; the port starts from the same weights
(``jax_init.py``: a step-0 checkpoint its train CLI resumes from). One JSON
line a seed: the first step's losses, the loss and gradient norm of every
step, the normalised final loss, the metrics and whether the gates hold. The port runs on ``--device``; the JAX package
on the CPU. Only ``--package jax`` imports JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import re
import shutil
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
CONFIG = os.path.join(REPO, "configs", "resdet3d_tiny_centerhead_test.py")
PRESENT = ("car_AP", "pedestrian_AP", "traffic_cone_AP")
STEPS = 150  # tests/test_full_loop.py's
sys.path[:0] = [REPO, HERE]


def gates(losses, metrics):
    """tests/test_full_loop.py's gates: (passed, values)."""
    normalized = losses[-1] / losses[0] if len(losses) >= 2 else None
    present_mean = float(np.mean([metrics.get(k, 0.0) for k in PRESENT]))
    ok = (normalized is not None and normalized < 0.25 and metrics.get("car_AP", 0.0) > 0.35
          and present_mean > 0.2 and all(metrics.get(k, 0.0) > 0.0 for k in PRESENT)
          and metrics.get("mAP", 0.0) > 0.06 and metrics.get("NDS", 0.0) > 0.1)
    return ok, dict(normalized_loss=normalized, present_mean_ap=present_mean)


def write_fixture(root: str, package: str) -> str:
    import nuscenes_fixture

    def write_ppm(path, rgb):
        big = np.ascontiguousarray(np.repeat(np.repeat(rgb, 10, 0), 10, 1), np.uint8)
        with open(path, "wb") as f:
            f.write(b"P6\n%d %d\n255\n" % (big.shape[1], big.shape[0]))
            f.write(big.tobytes())

    saved = nuscenes_fixture._write_jpeg
    nuscenes_fixture._write_jpeg = write_ppm
    try:
        nuscenes_fixture.make_fixture(root, structured=True)
    finally:
        nuscenes_fixture._write_jpeg = saved
    if package == "jax":
        from recondet3d.cli.create_data import main as create_data
    else:
        from recondet3d_torch.cli.create_data import main as create_data
    with contextlib.redirect_stdout(io.StringIO()):
        if create_data(["nuscenes", "--root-path", root, "--extra-tag", "tiny", "--version", "v1.0-mini"]):
            raise RuntimeError("create_data failed")
    return os.path.join(root, "tiny_infos_train.pkl")


def run_seed(package, device, seed, root, ann, extra, work):
    ov = ["--cfg-options", f"data.train.ann_file={ann}", f"data.train.data_root={root}",
          f"data.test.ann_file={ann}", f"data.test.data_root={root}"] + list(extra)
    wd = os.path.join(work, f"wd_{package}_{seed}")
    t0 = time.perf_counter()
    train_out, test_out = io.StringIO(), io.StringIO()
    if package == "jax":
        from recondet3d.cli.test import main as test_main
        from recondet3d.cli.train import main as train_main
        from recondet3d.train import latest_checkpoint

        with contextlib.redirect_stdout(train_out):
            train_main([CONFIG, "--work-dir", wd, "--max-steps", str(STEPS), "--seed", str(seed), "--num-devices",
                        "1", "--checkpoint-interval", "0"] + ov)
        with contextlib.redirect_stdout(test_out):
            test_main([CONFIG, "--checkpoint", latest_checkpoint(wd)] + ov)
    else:
        import jax_init
        from recondet3d_torch.cli.test import main as test_main
        from recondet3d_torch.cli.train import build_model_from_cfg, main as train_main
        from recondet3d_torch.core.config import load_py_config, parse_cli_overrides
        from recondet3d_torch.train.checkpoints import latest_checkpoint

        cfg = load_py_config(CONFIG, parse_cli_overrides(list(extra)))
        jax_init.write_initial_checkpoint(build_model_from_cfg(cfg, device=device), CONFIG, wd, STEPS, seed=seed)
        with contextlib.redirect_stdout(train_out):
            if train_main([CONFIG, "--work-dir", wd, "--max-steps", str(STEPS), "--device", device,
                           "--checkpoint-interval", "0"] + ov):
                raise RuntimeError("train CLI failed")
        with contextlib.redirect_stdout(test_out):
            if test_main([CONFIG, "--checkpoint", latest_checkpoint(wd), "--device", device] + ov):
                raise RuntimeError("test CLI failed")
    logged = [{k: float(v) for k, v in re.findall(r"(\S+)=(\S+)", line)}
              for line in re.findall(r"^step \d+: (.*)$", train_out.getvalue(), re.M)]
    metrics = {m.group(1): float(m.group(2))
               for m in re.finditer(r"pts_bbox_NuScenes/(\S+): ([0-9.naif-]+)", test_out.getvalue())}
    losses = [h["loss"] for h in logged]
    ok, values = gates(losses, metrics)
    shutil.rmtree(wd, ignore_errors=True)
    return dict(package=package, device=device if package != "jax" else "cpu", seed=seed, options=list(extra),
                steps=len(logged), first_step=logged[0] if logged else None, losses=losses,
                grad_norms=[h["grad_norm"] for h in logged], **values,
                metrics={k: metrics.get(k) for k in PRESENT + ("mAP", "NDS")}, gates_passed=ok,
                seconds=time.perf_counter() - t0)


def parse_seeds(text):
    out = []
    for part in text.split(","):
        lo, _, hi = part.partition("-")
        out += list(range(int(lo), int(hi or lo) + 1))
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--package", choices=("torch", "jax"), default="torch")
    p.add_argument("--device", default="cuda", help="the port's device (the JAX package runs on the CPU)")
    p.add_argument("--seeds", default="0-6", help="e.g. 0-6 or 0,4")
    p.add_argument("--cfg-options", nargs="*", default=[], help="config overrides, e.g. compute_dtype=float32")
    p.add_argument("--out", default=None, help="append the JSON lines to this file as well")
    args = p.parse_args(argv)
    work = tempfile.mkdtemp(prefix="recondet3d_seed_study_")
    try:
        root = os.path.join(work, "nusc")
        ann = write_fixture(root, args.package)
        for seed in parse_seeds(args.seeds):
            line = json.dumps(run_seed(args.package, args.device, seed, root, ann, args.cfg_options, work))
            print(line, flush=True)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(line + "\n")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

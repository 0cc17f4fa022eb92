"""ResDet3D training entry point (port of ``recondet3d/cli/train.py``).

    python -m recondet3d_torch.cli.train configs/resdet3d_tiny_centerhead_test.py --work-dir work_dirs/tiny \\
        [--max-steps N] [--resume-from CKPT] [--checkpoint-interval N] [--device cpu] [--num-devices N] \\
        [--autoscale-lr] [--cfg-options k=v ...]

Config -> model (``build_model_from_cfg``) -> nuScenes dataset -> ``Trainer``
over ``data_iterator``'s batches, one sample a device a step, with a log
line ``step N: loss=... grad_norm=... <each loss>=... steps_per_sec=...`` a
step and the final checkpoint in ``<work-dir>/checkpoints``. Runs on the
GPU unless ``--device cpu``.

Data parallelism (``--num-devices N``, as the JAX CLI's mesh of N devices):
one process a device, a global batch of N samples a step (rank r reads
the r-th of each, so the samples go in the JAX CLI's order), ``total_steps``
counted in global batches, the batch statistics over the global batch
(``train/trainer.py``) and ``--autoscale-lr`` scaling the rate by N / 8.
Without a launcher the CLI starts its N workers itself
(``torch.multiprocessing.spawn``: NCCL on ``cuda:0`` .. ``cuda:N-1``, or
gloo on the CPU with ``--device cpu``); under ``torchrun`` it joins the
group it finds there. Where fewer than N CUDA devices are visible it
raises, naming both counts: it never trains on fewer devices or on the CPU
instead. Only rank 0 prints the log lines and writes checkpoints.

Resume (``--resume-from``, or else the work dir's latest checkpoint)
restores the model, the optimizer and the step, then trains on to the
configured total, the data taken up where the checkpoint left it (mmcv's
resume). The JAX CLI restores the step too but then runs the full count
again from the first sample.

Weights: DA3 from ``reconstruction_backbone.cache_dir`` when a checkpoint
is found there (``api/weights.py``), else random from ``--seed`` with a
warning, as the JAX CLI does; everything else random from ``--seed``.

``build_model_from_cfg`` builds every shipped ``configs/*.py``:

    from recondet3d_torch.core.config import load_py_config
    from recondet3d_torch.cli.train import build_model_from_cfg
    model = build_model_from_cfg(load_py_config("configs/resdet3d_centerhead.py"), device="cuda")
"""

from __future__ import annotations

import argparse
import itertools
import os
import socket
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np
import torch

from recondet3d_torch.parallel import autoscale_lr, init_distributed, is_main_process, make_mesh, process_device
from recondet3d_torch.utils.device import resolve_device

__all__ = ["build_model_from_cfg", "parse_args", "data_iterator", "main"]

_REF_TUPLES = ("point_cloud_range", "voxel_size", "occ_feature_shape", "sparse_shape", "unet_channels", "stage_caps",
               "soft_vfe")
_REF_INTS = ("max_num_points", "max_voxels", "occ_max_voxels", "occ_max_num_points", "encoder_out_channels")
# a field the JAX module declares and never reads (SparseRefinement.loss_weight): accepted and dropped
_REF_UNREAD = ("loss_weight",)
_BK_CASTS = (("process_res", int), ("num_points", int), ("gt_num_points", int), ("bq_anchor_points", int),
             ("bq_sample_num", int), ("max_depth", float), ("bq_max_radius", float), ("voxel_pre_reduce", float),
             ("pre_reduce_cap", int), ("ref_view_strategy", str), ("use_ray_pose", bool), ("freeze_da3", bool))
_BK_KNOWN = {"type", "pretrained", "cache_dir", "refinement", "filter_range", "remat_policy"}
_BK_KNOWN |= {k for k, _ in _BK_CASTS}


def build_model_from_cfg(cfg, device="cuda", generator: Optional[torch.Generator] = None):
    """A ``ResDet3D`` from a loaded config (``load_py_config``), in eval
    mode, with random weights from ``generator`` (default: seed 0 on
    ``device``; ``device="meta"`` builds shapes only).

    ``compute_dtype`` (default bfloat16) is the compute dtype of DA3's trunk
    and of the refinement; ``reconstruction_backbone.freeze_da3=False``
    builds DA3 for fine-tuning (fp32 master parameters, activations
    recomputed in the backward pass by ``reconstruction_backbone.remat_policy``:
    ``block``, the default, ``global``, ``attn`` or ``dots``; on the train
    CLI ``--cfg-options model.reconstruction_backbone.remat_policy=dots``
    sets it). Unknown refinement, backbone or head keys
    raise ValueError, as in the JAX package."""
    from recondet3d_torch.models.da3 import build_da3
    from recondet3d_torch.models.detect import ReconstructionBackbone, ResDet3D
    from recondet3d_torch.models.detect.centerhead import CenterHead, init_head_parameters_
    from recondet3d_torch.models.refine.refinement import SparseRefinement, init_refinement_parameters_

    dev = resolve_device(device)
    draw = dev.type != "meta"
    if generator is None and draw:
        generator = torch.Generator(device=dev).manual_seed(0)
    m = cfg["model"]
    rb = m["reconstruction_backbone"]
    dtype = getattr(torch, str(cfg.get("compute_dtype", "bfloat16")))
    freeze = bool(rb.get("freeze_da3", True))

    ref_cfg = dict(rb.get("refinement", {}) or {})
    ref_cfg.pop("type", None)
    ref_kwargs = {}
    for keys, cast in ((_REF_TUPLES, tuple), (_REF_INTS, int), (("loss_type",), str),
                       (("occupancy_loss_weight",), float), (("use_color",), bool)):
        for key in keys:
            if key in ref_cfg:
                ref_kwargs[key] = cast(ref_cfg.pop(key))
    for key in _REF_UNREAD:
        ref_cfg.pop(key, None)
    if ref_cfg:  # typo'd or unsupported keys must not silently fall to defaults
        raise ValueError(f"unknown refinement config keys {sorted(ref_cfg)} — supported keys are the "
                         "SparseRefinement constructor arguments")
    ref_kwargs.setdefault("stage_caps", (40960, 32768, 24576, 16384))
    ref_kwargs.setdefault("max_voxels", 40960)

    bk_kwargs = {key: cast(rb[key]) for key, cast in _BK_CASTS if key in rb}
    if "filter_range" in rb:
        bk_kwargs["filter_range"] = tuple(rb["filter_range"])
    unknown_rb = set(rb) - _BK_KNOWN
    if unknown_rb:
        raise ValueError(f"unknown reconstruction_backbone config keys {sorted(unknown_rb)}")

    head_cfg = dict(m.get("pts_bbox_head") or {})
    if head_cfg:
        kind = head_cfg.pop("type", "CenterHead")
        if kind != "CenterHead":
            raise ValueError(f"unsupported pts_bbox_head type {kind!r}")
        for key in ("point_cloud_range", "voxel_size", "code_weights"):
            if key in head_cfg:
                head_cfg[key] = tuple(head_cfg[key])
        if "tasks" in head_cfg:
            head_cfg["tasks"] = tuple(tuple(t) for t in head_cfg["tasks"])

    tuned = dict(remat_policy=str(rb.get("remat_policy", "block")))
    if not freeze:
        tuned.update(param_dtype=torch.float32, remat=True)
    da3 = build_da3(rb.get("pretrained", "da3-large"), dtype=dtype, device=dev, generator=generator, with_gs=False,
                    **tuned)  # no Gaussian-splat head: the detector never calls it
    refinement = SparseRefinement(dtype=dtype, device=dev, **ref_kwargs)
    head = None
    if head_cfg:
        # the flax head infers its input width from the BEV features and never reads ``in_channels`` (the tiny
        # config's 32 meets 16-channel features there); a torch convolution needs it, so it is the refinement's
        head_cfg["in_channels"] = refinement.middle_encoder.bev_channels
        head = CenterHead(device=dev, **head_cfg)
    if draw:
        init_refinement_parameters_(refinement, generator)
        if head is not None:
            init_head_parameters_(head, generator)
    backbone = ReconstructionBackbone(da3=da3, refinement=refinement, **bk_kwargs)
    class_names = tuple(cfg.get("class_names") or ())
    return ResDet3D(reconstruction_backbone=backbone, pts_bbox_head=head, class_names=class_names).eval()


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Train ResDet3D")
    p.add_argument("config", help="python config file (mmcv-style dict config)")
    p.add_argument("--work-dir", default=None)
    p.add_argument("--resume-from", default=None)
    p.add_argument("--seed", type=int, default=0)
    # accepted for reference-CLI parity (train_mmdet3d.py:92-94): every random draw comes from --seed
    p.add_argument("--deterministic", action="store_true")
    p.add_argument("--max-steps", type=int, default=None)
    p.add_argument(
        "--checkpoint-interval", type=int, default=None,
        help="steps between mid-run checkpoints (default: one per epoch); 0 saves only the final checkpoint — "
        "at flagship scale each save writes several GB")
    p.add_argument("--autoscale-lr", action="store_true")
    p.add_argument("--num-devices", type=int, default=None,
                   help="data-parallel devices, one process and one sample each (default: the launcher's world "
                        "size, or 1)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--cfg-options", nargs="*", default=[])
    return p.parse_args(argv)


def _load_sample(dataset, i, num_points_gt, img_hw, n_cams, max_objs):
    """Sample ``i`` as numpy, each array with a leading batch axis of 1."""
    from recondet3d_torch.data.image_io import imread_rgb, resize_bilinear

    d = dataset.get_data_info(i)
    imgs = [resize_bilinear(imread_rgb(p), img_hw) for p in d["img_filename"][:n_cams]]
    img = np.stack(imgs)[None].astype(np.float32)
    c2l = np.stack(d["cam2lidar_rts"][:n_cams])[None].astype(np.float32)
    pts = np.fromfile(d["pts_filename"], np.float32).reshape(-1, 5)[:, :3]
    gt = np.zeros((1, num_points_gt, 3), np.float32)
    n = min(len(pts), num_points_gt)
    gt[0, :n] = pts[:n]
    sample = dict(img=img, cam2lidar_rts=c2l, gt_points=gt)
    if max_objs > 0:  # detection-head training: padded GT boxes
        ann = dataset.get_ann_info(i)
        boxes = np.asarray(ann["gt_bboxes_3d"], np.float32)
        boxes = boxes.reshape(len(boxes), -1) if len(boxes) else np.zeros((0, 9), np.float32)
        if boxes.shape[1] < 9:  # with_velocity=False: pad vx, vy = 0
            boxes = np.pad(boxes, ((0, 0), (0, 9 - boxes.shape[1])))
        labels = np.asarray(ann["gt_labels_3d"], np.int64).reshape(-1)
        keep = labels >= 0
        boxes, labels = boxes[keep][:max_objs], labels[keep][:max_objs]
        nb = len(boxes)
        bb = np.zeros((1, max_objs, 9), np.float32)
        ll = np.zeros((1, max_objs), np.int32)
        vv = np.zeros((1, max_objs), bool)
        bb[0, :nb] = boxes
        ll[0, :nb] = labels[:nb]
        vv[0, :nb] = True
        sample.update(gt_bboxes_3d=bb, gt_labels_3d=ll, gt_bboxes_valid=vv)
    return sample


def data_iterator(dataset, num_points_gt: int, img_hw, n_cams: int, epochs: int, batch_size: int = 1,
                  max_objs: int = 0, start: int = 0, rank: int = 0, num_ranks: int = 1):
    """Host-side loader: batches of ``batch_size`` samples, dicts of CPU
    tensors ``img`` (B, n_cams, H, W, 3) float32 RGB 0..255 resized to
    ``img_hw``, ``cam2lidar_rts`` (B, n_cams, 4, 4), ``gt_points``
    (B, num_points_gt, 3) (the sweep's first points, zero-padded) and, with
    ``max_objs``, ``gt_bboxes_3d`` (B, max_objs, 9), ``gt_labels_3d`` and
    ``gt_bboxes_valid`` (B, max_objs). Samples go in dataset order,
    ``epochs`` times over, from sample ``start`` of that sequence: the JAX
    iterator's order and values (images resized by
    ``image_io.resize_bilinear``, the same bits as cv2.resize). With
    ``num_ranks`` > 1 the sequence is cut into global batches of
    ``batch_size * num_ranks`` samples and this iterator yields ``rank``'s
    share of each (samples ``rank * batch_size`` .. of it, ``shard_batch``'s
    split); ``start`` counts samples of the whole sequence.

    One sample is loaded ahead on a worker thread (file reads, decode and
    resize release the GIL), the port's stand-in for the JAX package's
    native prefetch loader."""
    order = itertools.islice((i for _ in range(epochs) for i in range(len(dataset))), start, None)
    if num_ranks > 1:
        order = (i for j, i in enumerate(order) if (j // batch_size) % num_ranks == rank)
    load = lambda i: _load_sample(dataset, i, num_points_gt, tuple(img_hw), n_cams, max_objs)  # noqa: E731
    pool = ThreadPoolExecutor(max_workers=1, thread_name_prefix="recondet3d-loader")
    try:
        nxt = next(order, None)
        pending = pool.submit(load, nxt) if nxt is not None else None
        bucket = []
        while pending is not None:
            sample = pending.result()
            nxt = next(order, None)
            pending = pool.submit(load, nxt) if nxt is not None else None
            bucket.append(sample)
            if len(bucket) == batch_size:
                yield {k: torch.from_numpy(np.concatenate([s[k] for s in bucket])) for k in bucket[0]}
                bucket = []
    finally:
        pool.shutdown(wait=True, cancel_futures=True)


def _load_pretrained_da3(model, rb_cfg, say=print):
    """DA3 weights from the config's ``cache_dir`` (reference: api.py:76-90,
    PyTorchModelHubMixin into ckpts/): a checkpoint found there, or fetched
    from the hub for an ``org/name`` preset, fills the DA3 net; without one
    the net keeps its random weights and a warning says so."""
    from recondet3d_torch.api.weights import download_checkpoint, find_checkpoint, load_da3_state_dict, \
        load_safetensors

    cache_dir = rb_cfg.get("cache_dir")
    if not cache_dir:
        return
    name = rb_cfg.get("pretrained", "da3-large")
    ckpt = find_checkpoint(name, cache_dir)
    if ckpt is None and "/" in name:
        ckpt = download_checkpoint(name, cache_dir)
    if ckpt is None:
        say(f"WARNING: no DA3 checkpoint for {name!r} in {cache_dir!r}; training with randomly initialized DA3",
              flush=True)
        return
    unused, unfilled = load_da3_state_dict(model.reconstruction_backbone.da3, load_safetensors(ckpt))
    if unfilled:
        say(f"WARNING: {len(unfilled)} DA3 params not in checkpoint", flush=True)
    if unused:
        say(f"WARNING: {len(unused)} checkpoint tensors not used", flush=True)
    say(f"loaded DA3 weights from {ckpt}", flush=True)


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _check_devices(device, n: int, local: Optional[int] = None) -> None:
    """Refuse where fewer CUDA devices are visible than this host's ``local``
    processes need (default ``n``, all of them: the CLI starts them itself).
    Under a launcher ``local`` is the launcher's count on this host, so a
    group across hosts is held to each host's own devices."""
    local = n if local is None else local
    if torch.device(device).type == "cuda" and torch.cuda.device_count() < local:
        where = "" if local == n else f" ({local} of them on this host)"
        raise RuntimeError(f"--num-devices {n} needs {local} CUDA devices{where}, but {torch.cuda.device_count()} "
                           "are visible; pass --device cpu to train on the CPU")


def _worker(rank: int, argv, n: int, port: int) -> None:
    """One of the N processes that ``main`` starts without a launcher."""
    args = parse_args(argv)
    os.environ["LOCAL_RANK"] = str(rank)
    init_distributed(args.device, init_method=f"tcp://127.0.0.1:{port}", world_size=n, rank=rank)
    try:
        _train(args)
    finally:
        torch.distributed.destroy_process_group()


def main(argv=None):
    args = parse_args(argv)
    n = args.num_devices
    launched = "RANK" in os.environ and "WORLD_SIZE" in os.environ  # torchrun's environment
    if n is not None and n > 1 and not launched:
        _check_devices(args.device, n)
        torch.multiprocessing.spawn(_worker, args=(argv, n, _free_port()), nprocs=n, join=True)
        return 0
    if not launched:
        return _train(args)
    world = int(os.environ["WORLD_SIZE"])
    if n is not None and n != world:
        raise ValueError(f"--num-devices {n} under a launcher of {world} processes")
    _check_devices(args.device, world, int(os.environ.get("LOCAL_WORLD_SIZE", world)))
    init_distributed(args.device)
    try:
        return _train(args)
    finally:
        torch.distributed.destroy_process_group()


def _train(args):
    from recondet3d_torch.core.config import load_py_config, parse_cli_overrides
    from recondet3d_torch.data.nuscenes import NuScenesDataset
    from recondet3d_torch.train import Trainer
    from recondet3d_torch.train.checkpoints import latest_checkpoint, load_checkpoint

    device = resolve_device(process_device(args.device))
    main_process = is_main_process()
    say = print if main_process else (lambda *a, **k: None)
    cfg = load_py_config(args.config, parse_cli_overrides(args.cfg_options))
    work_dir = args.work_dir or cfg.get("work_dir") or os.path.join(
        "work_dirs", os.path.splitext(os.path.basename(args.config))[0])
    os.makedirs(work_dir, exist_ok=True)

    np.random.seed(args.seed)
    torch.manual_seed(args.seed)
    model = build_model_from_cfg(cfg, device=device, generator=torch.Generator(device=device).manual_seed(args.seed))

    inner = cfg["data"]["train"].get("dataset", cfg["data"]["train"])  # a CBGSDataset holds it under 'dataset'
    dataset = NuScenesDataset(ann_file=inner["ann_file"], data_root=inner.get("data_root", ""),
                              classes=inner.get("classes"), load_interval=inner.get("load_interval", 1),
                              with_velocity=bool(inner.get("with_velocity", True)))
    total_epochs = int(cfg.get("total_epochs", 8))
    mesh = make_mesh()
    bs = mesh.shape["data"]  # the global batch: one sample a device
    if mesh.group is not None:
        say(f"data parallel: {bs} ranks over {torch.distributed.get_backend()}, a global batch of {bs}", flush=True)
    # a step consumes a global batch, so the configured epochs are len(dataset) * epochs / bs steps
    total_steps = args.max_steps or max(1, -(-len(dataset) * total_epochs // bs))
    opt = cfg.get("optimizer", {})
    lr = float(opt.get("lr", 1e-3))
    if args.autoscale_lr:  # reference: tools/train_mmdet3d.py:190-192, lr * total batch / 8
        lr = autoscale_lr(lr, 1, mesh)
    trainer = Trainer(
        model=model, total_steps=total_steps, lr=lr, weight_decay=float(opt.get("weight_decay", 0.01)),
        grad_clip=float(cfg.get("optimizer_config", {}).get("grad_clip", {}).get("max_norm", 100.0)),
        work_dir=work_dir, mesh=mesh,
        checkpoint_interval=((args.checkpoint_interval or None) if args.checkpoint_interval is not None
                             else max(1, len(dataset) // bs)))
    state = trainer.init_state()
    resume = args.resume_from or latest_checkpoint(work_dir)
    if resume:
        load_checkpoint(resume, target=state, map_location=device)
        say(f"resumed from {resume} at step {state.step}", flush=True)
    else:
        _load_pretrained_da3(model, cfg["model"]["reconstruction_backbone"], say)

    # enough passes over the data to fill total_steps global batches
    epochs_needed = max(total_epochs, -(-total_steps * bs // max(len(dataset), 1)))
    head = model.pts_bbox_head
    it = data_iterator(dataset, num_points_gt=model.reconstruction_backbone.gt_num_points, img_hw=(900, 1600),
                       n_cams=6, epochs=epochs_needed, batch_size=1,
                       max_objs=int(head.max_objs) if head is not None else 0, start=state.step * bs,
                       rank=mesh.data_index, num_ranks=bs)

    def log(step, m):
        # the JAX CLI's line: the step's metrics by name (a jitted step returns its dict sorted), then steps_per_sec
        keys = sorted(k for k in m if k != "steps_per_sec") + ["steps_per_sec"]
        say(f"step {step}: " + " ".join(f"{k}={m[k]:.4f}" for k in keys), flush=True)

    if state.step < total_steps:
        state, _ = trainer.run(state, it, max_steps=total_steps - state.step, log_fn=log, sharded=True)
    it.close()
    path = trainer.save_checkpoint(state)
    say(f"saved {path}", flush=True)
    return 0


if __name__ == "__main__":
    main()

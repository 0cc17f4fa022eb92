"""One run of one cell: set-up, the measured window, the traced stretch, the
check against the reference, and the result line.

Everything that belongs to a cell is found by name: the cell's file
``benchmark/workloads/<cell>.json`` names its configuration
(``benchmark/configs/<config>.json``) and its traffic
(``benchmark/traffic/<traffic>.json``); ``BENCHMARK.json`` lists the metrics
the cell reports, and each metric is read by ``benchmark/metrics/<name>.py``.
"""

from __future__ import annotations

import contextlib
import copy
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

import torch

from benchmark.harness import check as chk
from benchmark.harness.trace import profile_stretch
from benchmark.harness.inputs import make_pool, sub_seed
from benchmark.harness.refview import Recorder
from benchmark.harness.weights import make_weights_

__all__ = ["ROOT", "BANNED", "banned_modules", "cell_files", "cell_metrics", "run_cell", "main"]

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"
BANNED = ("jax", "jaxlib", "flax", "recondet3d")


class NoDevice(RuntimeError):
    pass


def banned_modules(names=None) -> List[str]:
    """The banned top-level names among ``names`` (default: the loaded
    modules), each module's name cut at its first dot and compared whole."""
    names = sys.modules if names is None else names
    return sorted({n.split(".")[0] for n in names if n.split(".")[0] in BANNED})


def _json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def cell_files(cell: str, bench: Path = BENCH) -> Dict:
    """The cell's workload, configuration and traffic files, read."""
    work = _json(bench / "workloads" / f"{cell}.json")
    return {"workload": work, "config": _json(bench / "configs" / f"{work['config']}.json"),
            "traffic": _json(bench / "traffic" / f"{work['traffic']}.json")}


def load_reader(name: str, bench: Path = BENCH):
    """The reader module of metric ``name``: ``benchmark/metrics/<name>.py``."""
    path = bench / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_metrics(cell: str, manifest: Dict, bench: Path = BENCH) -> Dict[str, List]:
    """{'end_to_end': [(name, unit, reader)], 'per_layer': [...]}: the
    metrics ``BENCHMARK.json`` gives this cell (those without a
    ``workloads`` key go to every cell)."""
    out = {}
    for part in ("end_to_end", "per_layer"):
        out[part] = [(m["name"], m["unit"], load_reader(m["name"], bench)) for m in manifest[part]
                     if "workloads" not in m or cell in m["workloads"]]
    return out


def _log(*parts):
    print(*parts, file=sys.stderr, flush=True)


def _smi() -> Optional[str]:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,clocks.sm,power.draw,power.limit,temperature.gpu",
                               "--format=csv,noheader"], capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return None


def _module(model, dotted: str):
    mod = model
    for part in dotted.split("."):
        mod = getattr(mod, part, None)
        if mod is None:
            return None
    return mod


class _Hooks:
    """CUDA-event hooks (pre and post forward) on the modules each metric's
    ``HOOKS`` names; ``ms()`` sums each metric's pairs."""

    def __init__(self, model, wanted: Dict[str, List[str]]):
        self.pairs: Dict[str, List] = {k: [] for k in wanted}
        self.handles = []
        for key, paths in wanted.items():
            for path in paths:
                mod = _module(model, path)
                if mod is None:
                    continue

                def pre(_m, _a, key=key):
                    ev = torch.cuda.Event(enable_timing=True)
                    ev.record()
                    self.pairs[key].append([ev, None])

                def post(_m, _a, _o, key=key):
                    ev = torch.cuda.Event(enable_timing=True)
                    ev.record()
                    self.pairs[key][-1][1] = ev

                self.handles += [mod.register_forward_pre_hook(pre), mod.register_forward_hook(post)]

    def remove(self):
        for h in self.handles:
            h.remove()

    def ms(self) -> Dict[str, float]:
        torch.cuda.synchronize()
        return {k: sum(a.elapsed_time(b) for a, b in v) for k, v in self.pairs.items() if v}


def build_program(cfg: Dict, seed: int, device):
    """The program's model, built by the training CLI's config function
    ``build_model_from_cfg``, then given the benchmark's weights."""
    from recondet3d_torch.cli.train import build_model_from_cfg

    prog_cfg = {"model": copy.deepcopy(cfg["model"]), "compute_dtype": cfg["compute_dtype"],
                "class_names": list(cfg["class_names"])}
    model = build_model_from_cfg(prog_cfg, device=device,
                                 generator=torch.Generator(device=device).manual_seed(sub_seed(seed, 9)))
    make_weights_(model, sub_seed(seed, 0), cfg["weights"]["adjust"])
    return model


def build_reference(cfg: Dict, seed: int, device):
    from benchmark.reference.model import build

    ref = build(cfg, device)
    make_weights_(ref, sub_seed(seed, 0), cfg["weights"]["adjust"])
    return ref


def optim_kwargs(cfg: Dict, traffic: Dict) -> Dict:
    o = cfg["optimizer"]
    return dict(lr=o["lr"], weight_decay=o["weight_decay"], grad_clip=o["grad_clip"],
                total_steps=int(traffic["schedule_steps"]), frozen_patterns=tuple(o["frozen"]))


class InferClient:
    """A request: ``simple_test`` on one pool entry, then, with a head,
    ``pts_bbox_head.decode`` on the host; ``decode_s`` holds the host seconds
    of each decode."""

    def __init__(self, model, pool, traffic):
        self.model, self.pool = model, pool
        self.decode = bool(traffic.get("decode"))
        self.decode_s: List[float] = []

    def __call__(self, i: int):
        item = self.pool[i % len(self.pool)]
        out = self.model.simple_test(item["img"], item["cam2lidar_rts"], depth_override=item["depth"])
        decoded = None
        if self.decode:
            t0 = time.perf_counter()
            decoded = self.model.pts_bbox_head.decode(out["det_preds"])
            self.decode_s.append(time.perf_counter() - t0)
        return out, decoded


TRAIN_KEYS = ("img", "cam2lidar_rts", "gt_points")


def anchor_training_depth(model) -> Dict:
    """``forward_train`` takes no depth override: DA3 still runs on the
    images, and the point path then takes the step's anchored depth (set in
    the returned dict), as ``depth_override`` does in a request. With random
    weights DA3's own depth would give every seed another cloud, and so
    another amount of work."""
    bk = model.reconstruction_backbone
    inner, step = bk.predict_depth, {"depth": None}

    def predict_depth(img):
        _, intr, da3_out = inner(img)
        return step["depth"].float(), intr, da3_out

    bk.predict_depth = predict_depth
    return step


class TrainClient:
    """A step: ``Trainer.run`` over one pool entry (one global batch)."""

    def __init__(self, model, pool, cfg, traffic):
        from recondet3d_torch.train.trainer import Trainer

        kw = optim_kwargs(cfg, traffic)
        self.trainer = Trainer(model=model, total_steps=kw["total_steps"], lr=kw["lr"],
                               weight_decay=kw["weight_decay"], grad_clip=kw["grad_clip"],
                               frozen_patterns=kw["frozen_patterns"])
        self.state = self.trainer.init_state()
        self.model, self.pool = model, pool
        self.anchor = anchor_training_depth(model)

    def __call__(self, i: int):
        item = self.pool[i % len(self.pool)]
        self.anchor["depth"] = item["depth"]
        batch = {k: item[k] for k in TRAIN_KEYS}
        self.state, history = self.trainer.run(self.state, iter([batch]), max_steps=1)
        return history[-1]


class RefTrainClient:
    """The control's step: the reference's ``forward_train``, the sum of its
    losses, backward and its copy of the optimizer."""

    def __init__(self, model, pool, cfg, traffic):
        from benchmark.reference.optim import build_optimizer

        self.optimizer = build_optimizer(model.named_parameters(), **optim_kwargs(cfg, traffic))
        self.trainer = self
        self.model, self.pool = model, pool
        self.anchor = anchor_training_depth(model)

    def __call__(self, i: int):
        item = self.pool[i % len(self.pool)]
        self.anchor["depth"] = item["depth"]
        batch = {k: item[k] for k in TRAIN_KEYS}
        self.model.train()
        self.optimizer.zero_grad()
        losses, _ = self.model(return_loss=True, **batch)
        total = sum(losses.values())
        total.backward()
        self.optimizer.step()
        return {"loss": total.detach()}


def _train_check_steps(model, client: TrainClient, steps: int, picks: Recorder) -> Dict:
    """The first ``steps`` steps through the window's own call, each on its
    own batch, with what the check needs from each (``picks``: DA3's
    reference view of each step)."""
    bk = model.reconstruction_backbone
    opt = client.trainer.optimizer
    seen: Dict = {}

    def on_da3(_m, _a, out):
        seen["da3_depth"] = out["depth"].detach().float().clone()
        seen["intrinsics"] = out["intrinsics"].detach().float().clone()

    def on_refinement(_m, args):
        seen["points"], seen["valid"] = args[0].detach().clone(), args[1].detach().clone()

    hooks = [bk.da3.register_forward_hook(on_da3), bk.refinement.register_forward_pre_hook(on_refinement)]
    before = {n: p.detach().clone() for n, p in zip(opt.names, opt.params)}
    rec = {"steps": [], "losses": []}
    try:
        for s in range(steps):
            metrics = client(s)
            rec["steps"].append(dict(seen, ref_view=picks.take()))
            rec["losses"].append(float(metrics["loss"]))
            if s == 0:
                b1 = opt.b1(0)
                rec["grad"] = {n: float(torch.linalg.vector_norm(m.double())) / (1 - b1)
                               for n, m in zip(opt.names, opt.mu)}
    finally:
        for h in hooks:
            h.remove()
    rec["change"] = {n: float(torch.linalg.vector_norm((p.detach() - before[n]).double()))
                     for n, p in zip(opt.names, opt.params)}
    return rec


def run_cell(cell: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
             fault: Optional[Callable] = None, t_start: Optional[float] = None, bench: Path = BENCH,
             control: bool = False) -> Dict:
    """One run of ``cell``; returns the result record (the result line's
    keys, and ``readings``). ``fault(model, client)`` breaks the timed path
    underneath (the harness's own tests); ``control`` puts the reference,
    computed one precision lower, in the program's place."""
    t_start = time.perf_counter() if t_start is None else t_start
    phases = {"imports": time.perf_counter() - t_start}

    def phase(name):  # seconds since the last phase ended, for the info line
        phases[name] = time.perf_counter() - t_start - sum(phases.values())

    files = cell_files(cell, bench)
    work, cfg, traffic = files["workload"], files["config"], files["traffic"]
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    if on_card and (not torch.cuda.is_available() or torch.cuda.device_count() < int(work.get("chips", 1))):
        raise NoDevice(f"{cell} needs {work.get('chips', 1)} CUDA device(s); "
                       f"torch.cuda.is_available()={torch.cuda.is_available()}")
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    manifest = _json(bench.parent / "BENCHMARK.json")
    metrics = cell_metrics(cell, manifest, bench)
    kind = traffic["kind"]

    if control:
        from benchmark.reference import vit as vit_module
        from benchmark.reference.lowp import lower_precision

        model = build_reference(cfg, seed, dev)
    else:
        from recondet3d_torch.models.da3 import vit as vit_module

        model = build_program(cfg, seed, dev)
    picks = Recorder(vit_module)
    sync()
    phase("model")
    pool = make_pool(traffic, cfg, seed, dev)
    sync()
    phase("inputs")
    if kind == "infer":
        client = InferClient(model, pool, traffic)
    else:
        client = (RefTrainClient if control else TrainClient)(model, pool, cfg, traffic)
    if fault is not None:
        fault(model, client)
    phase("client")
    timed = client
    if control:
        def timed(i, _d=client):
            with lower_precision():
                return _d(i)

    checked = sorted({int(i) for i in torch.randint(0, int(traffic.get("check_from", 4)),
                                                    (int(traffic.get("checked", 1)),),
                                                    generator=torch.Generator().manual_seed(sub_seed(seed, 3)))})
    train_rec = None
    if kind == "infer":
        for w in range(int(traffic.get("warmup", 2))):
            timed(w)
        client.decode_s.clear()
    elif control:
        with lower_precision():
            train_rec = _train_check_steps(model, client, int(traffic["checked_steps"]), picks)
    else:
        train_rec = _train_check_steps(model, client, int(traffic["checked_steps"]), picks)
    sync()
    if not control:
        from recondet3d_torch.ops import attention as attn_ops, fps as fps_ops

        attn_ops.reset_launch_counts()
        fps_ops.reset_launch_counts()
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    smi_before = _smi() if on_card else None
    setup_s = time.perf_counter() - t_start
    phase("warmup")

    # the measured window: a closed loop of one client
    hooks, span_ctx = None, None
    if trace:
        from recondet3d_torch.utils import stage_timer

        wanted = {name: list(getattr(r, "HOOKS", ())) for name, _, r in metrics["per_layer"] if getattr(r, "HOOKS", ())}
        hooks = _Hooks(model, wanted) if on_card else None
        span_ctx = stage_timer.collect() if on_card else None
    spans: Dict = {}
    kept: Dict[int, Dict] = {}
    lat: List[float] = []
    min_units = max(checked) + 1 if kind == "infer" else 1
    ctx = span_ctx if span_ctx is not None else contextlib.nullcontext()
    with ctx as spans_out:
        w0 = time.perf_counter()
        i = 0
        while True:
            r0 = time.perf_counter()
            res = timed(i)
            sync()
            r1 = time.perf_counter()
            lat.append(r1 - r0)
            if kind == "infer" and i in checked:
                kept[i] = dict(chk.infer_outputs(*res), ref_view=picks.take())
            i += 1
            if r1 - w0 >= seconds and i >= min_units:
                break
        window_s = time.perf_counter() - w0
    if span_ctx is not None:
        spans = dict(spans_out)
    units = i
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    info = {"cell": cell, "seed": seed, "units": units, "window_s": window_s, "setup_s": setup_s,
            "setup_phases_s": phases, "memory_peak_bytes": peak, "nvidia_smi_before": smi_before, "nvidia_smi_after": _smi() if on_card else None}
    if not control:
        from recondet3d_torch.ops import attention as attn_ops, fps as fps_ops

        info["attention_launches"] = {w.__name__: {str(k): v for k, v in w.launches_by_shape.items()}
                                      for w in (attn_ops.flash_attention_fwd, attn_ops.attention_fwd_cuda_core,
                                                attn_ops.attention_fwd_short, attn_ops.flash_attention_bwd_dq,
                                                attn_ops.flash_attention_bwd_dkv)}
        fn = fps_ops.furthest_point_sample_cuda
        info["fps_launches"] = {str(k): v for k, v in getattr(fn, "launches_by_shape", {}).items()}
        info["valid_points_last_request"] = {k: [int(c) for c in v] for k, v in
                                             model.reconstruction_backbone.last_stage_counts.items()}
    run = {"kind": kind, "units": units, "window_s": window_s, "setup_s": setup_s, "latencies_s": lat,
           "frames_per_unit": int(traffic["batch"]) * int(traffic["views"]), "samples_per_unit": int(traffic["batch"]),
           "spans_ms": spans, "hooks_ms": hooks.ms() if hooks is not None else {},
           "decode_s": list(getattr(client, "decode_s", []))}
    if hooks is not None:
        hooks.remove()
    profile = None
    if trace and on_card:
        profile = run["profile"] = profile_stretch(lambda j: (timed(units + j), sync()),
                                                   int(traffic.get("profile_units", 3)))
        info["profile_kernels_top"] = sorted(profile["kernels_by_name"].items(), key=lambda kv: -kv[1])[:25]
    print(json.dumps({"info": info}), flush=True)
    picks.remove()

    # the check: the program freed, the reference at the stated precision
    readings_all: List[Dict[str, float]] = []
    items = {j: pool[j % len(pool)] for j in kept}
    batches = pool[:int(traffic.get("checked_steps", 0))]
    del model, client, timed
    sync()
    if on_card:
        torch.cuda.empty_cache()
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    from benchmark.counts import attention as attn_count, fps as fps_count
    from benchmark.counts.flops import FlopCount
    from benchmark.reference import sampling as ref_sampling

    ref = build_reference(cfg, seed, dev)
    flops = FlopCount()
    fps_calls = ref_sampling.CALLS = []
    t_ref = time.perf_counter()
    try:
        if kind == "infer":
            for j in sorted(kept):
                readings_all.append(chk.infer_readings(ref, kept[j], items[j], flops if not readings_all else None))
        else:
            readings_all.append(chk.train_readings(ref, train_rec, batches, optim_kwargs(cfg, traffic), flops))
    finally:
        ref_sampling.CALLS = None
    ref_s = time.perf_counter() - t_ref
    del ref
    readings = {k: max(r[k] for r in readings_all) for k in readings_all[0]}
    limits = {k: float(v) for k, v in work.get("limits", {}).items()}
    correct = bool(limits) and chk.verdict(readings, limits)

    # the counts behind rooflines and mfu, per request or step
    rb = cfg["model"]["reconstruction_backbone"]
    if kind == "infer":
        from benchmark.reference.input_processor import compute_process_shape

        ph, pw = compute_process_shape(*traffic["image_hw"], int(rb["process_res"]))[2:]
        run["attention"] = attn_count.least_seconds(attn_count.launches(rb["pretrained"], int(traffic["batch"]),
                                                                        int(traffic["views"]), ph, pw))
        run["fps_least_s"] = fps_count.least_seconds(fps_calls) / max(len(kept), 1)
    run["flops_per_unit"] = flops.total
    run["device_kind"] = torch.cuda.get_device_name(dev) if on_card else "cpu"

    part = "per_layer" if trace else "end_to_end"
    values = {}
    for name, unit, reader in metrics[part]:
        v = reader.read(run)
        if v is not None:
            values[name] = {"value": float(v), "unit": unit}
    device = {"platform": "gpu" if on_card else "cpu", "kind": run["device_kind"], "count": 1,
              "memory_peak_bytes": int(peak)}
    if profile is not None:
        device.update(busy_s=profile["busy_s"], window_s=profile["window_s"])
    result = {"correct": correct, "attempted": units, "failed": 0, "metrics": values, "device": device}
    if profile is not None:
        result["breakdown"] = {"device_ops": profile["device_ops"], "idle_gaps": profile["idle_gaps"]}
    result["checks"] = {k: {"value": readings.get(k), "limit": limits[k]} for k in sorted(limits)}
    result["readings"] = readings
    result["reference_s"] = ref_s
    return result


def main(argv=None, t_start: Optional[float] = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="Run one benchmark cell once and print its result line.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        res = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), t_start=t_start)
    except NoDevice as e:
        _log(f"benchmark: {e}")
        return 2
    found = banned_modules()
    if found:
        _log(f"benchmark: modules that must not load are loaded: {found}")
        return 3
    extra = {k: res.pop(k) for k in ("readings", "reference_s")}
    print(json.dumps({"readings": extra["readings"], "reference_s": extra["reference_s"]}), flush=True)
    for k, c in res["checks"].items():
        _log(f"check {k} {c['value']!r} limit {c['limit']!r}")
    line = {k: res[k] for k in ("correct", "attempted", "failed", "metrics", "device")}
    if "breakdown" in res:
        line["breakdown"] = res["breakdown"]
    line["checks"] = res["checks"]
    print(json.dumps(line), flush=True)
    return 0

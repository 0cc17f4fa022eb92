"""The ResDet3D family: how the harness builds, drives and checks a
configuration whose ``model.type`` is ``ResDet3D`` (DA3 depth -> point path
-> sparse refinement -> optional CenterHead).

A request is ``simple_test`` on one pool entry (B scenes of the six-camera
rig, ``harness/inputs.py``) with the anchored depth as ``depth_override``,
then, with a head, ``pts_bbox_head.decode`` on the host. A training step is
``Trainer.run`` over one pool entry, DA3 frozen, the point path on the
step's anchored depth. Under data parallelism each rank trains its own
entries (drawn from the seed and the rank) and the Trainer wraps the model
in ``DistributedDataParallel``.

The check (``readings``) recomputes DA3 with the reference view the run
picked (``harness/refview.py``), then follows the program's state a stage at
a time, because FPS and the ball query turn a rounding difference into
another point set: the point path runs on the program's intrinsics and the
benchmark's depth, the refinement on the program's selected points, the
head on the reference's own BEV features, the decode on the reference's own
head outputs. Training: step 1's DA3 and point path, scene by scene, then
the refinement's steps over the global batch (every rank's points, in rank
order, as one batch) with the reference's own optimizer.
"""

from __future__ import annotations

import contextlib
import copy
import sys
from typing import Dict, List, Optional

import torch

from benchmark.harness.check import boxes_gap, max_rel, median, points_gap, rel_l2
from benchmark.harness.inputs import make_pool, sub_seed
from benchmark.harness.refview import Recorder, forced
from benchmark.harness.weights import make_weights_

__all__ = ["Family", "FAULTS", "faults_for", "build_program", "build_reference"]

TRAIN_KEYS = ("img", "cam2lidar_rts", "gt_points")


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
    ``pts_bbox_head.decode`` on the host."""

    def __init__(self, model, pool, traffic):
        self.model, self.pool = model, pool
        self.decode = bool(traffic.get("decode"))

    def __call__(self, i: int):
        item = self.pool[i % len(self.pool)]
        out = self.model.simple_test(item["img"], item["cam2lidar_rts"], depth_override=item["depth"])
        decoded = self.model.pts_bbox_head.decode(out["det_preds"]) if self.decode else None
        return out, decoded


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
    """A step: ``Trainer.run`` over one pool entry (this rank's share of the
    global batch; the Trainer joins the process group's ranks)."""

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
        self.state, history = self.trainer.run(self.state, iter([batch]), max_steps=1, sharded=True)
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


def train_check_steps(model, client, steps: int, picks: Recorder) -> Dict:
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


def infer_outputs(out: Dict, decoded) -> Dict:
    """What a request produced, kept for the check: DA3 depth and
    intrinsics, the selected points, the occupancy logits, the head's raw
    outputs and the decoded boxes (detached; results on the host stay)."""
    aux = out["aux"]
    kept = {"depth": aux["da3"]["depth"].float().clone(), "intrinsics": aux["da3"]["intrinsics"].float().clone(),
            "points": out["pseudo_points"].clone(), "valid": out["pseudo_valid"].clone(),
            "occupancy": aux["occupancy_logits"].clone()}
    if out.get("det_preds") is not None:
        kept["head"] = [{k: v.clone() for k, v in p.items()} for p in out["det_preds"]]
        kept["boxes"] = decoded
    return kept


@torch.no_grad()
def infer_readings(ref, kept: Dict, item: Dict, flops=None) -> Dict[str, float]:
    """The numbers of one request: the reference's DA3 from the images, its
    point path from the program's intrinsics and the benchmark's depth, its
    refinement from the program's points, its head and decode from there."""
    bk = ref.reconstruction_backbone
    ctx = flops if flops is not None else contextlib.nullcontext()
    gaps: List[float] = []
    with ctx, forced(kept.get("ref_view"), gaps):
        depth, intr, _ = bk.predict_depth(item["img"])
    r = {"depth_gap": rel_l2(kept["depth"], depth), "intrinsics_gap": rel_l2(kept["intrinsics"], intr)}
    if gaps:
        r["ref_view_score_gap"] = max(gaps)
    pts, msk = bk.points_from_depth(item["depth"].float(), kept["intrinsics"], item["img"], item["cam2lidar_rts"])
    r["points_gap"] = points_gap(kept["points"], kept["valid"], pts, msk)
    with ctx:
        _, _, aux = bk.refinement(kept["points"], kept["valid"])
    r["occupancy_gap"] = max_rel(kept["occupancy"], aux["occupancy_logits"])
    if "head" in kept:
        with ctx:
            preds = ref.pts_bbox_head(aux["bev_features"])
        r["head_gap"] = max(max_rel(p[k], q[k]) for p, q in zip(kept["head"], preds) for k in q)
        r["boxes_gap"] = boxes_gap(kept["boxes"], ref.pts_bbox_head.decode(preds))
    return r


def _cat(parts: List[Dict], key: str) -> torch.Tensor:
    return torch.cat([p[key] for p in parts])


def train_readings(ref, recs: List[Dict], batches: List[List[Dict]], optim_kwargs: Dict,
                   flops=None) -> Dict[str, float]:
    """The numbers of the first steps of training. ``recs`` holds, by rank,
    what the program's steps produced (``train_check_steps``): per step DA3's
    depth and intrinsics, the selected points (from the step's anchored
    depth) and the loss; the first gradient by leaf (from the optimizer's
    first moment after one step) and each leaf's change after the steps.
    ``batches`` holds, by rank, the step's pool entries. The reference checks
    step 1's DA3 (depth and intrinsics) over the global batch (every rank's
    scenes as one batch: DA3's scale alignment takes its statistics over the
    whole batch, under data parallelism over every rank's) and its point path
    from the program's intrinsics, then follows the refinement's steps from
    the program's points of every rank as one batch with its own optimizer.
    Gaps of scenes and of ranks are taken at their worst."""
    from benchmark.reference.optim import build_optimizer

    ref.train()
    bk = ref.reconstruction_backbone
    ctx = flops if flops is not None else contextlib.nullcontext()
    firsts, ones = [rec["steps"][0] for rec in recs], [mine[0] for mine in batches]
    views = [f.get("ref_view") for f in firsts]
    img, intr_prog = _cat(ones, "img"), _cat(firsts, "intrinsics")
    gaps: List[float] = []
    with torch.no_grad(), ctx, forced(None if any(v is None for v in views) else torch.cat(views), gaps):
        depth, intr, _ = bk.predict_depth(img)
    with torch.no_grad():
        pts, msk = bk.points_from_depth(_cat(ones, "depth").float(), intr_prog, img, _cat(ones, "cam2lidar_rts"))
    depth_prog, pts_prog, valid_prog = _cat(firsts, "da3_depth"), _cat(firsts, "points"), _cat(firsts, "valid")
    scenes = [slice(b, b + 1) for b in range(img.shape[0])]
    r = {"depth_gap": max(rel_l2(depth_prog[b], depth[b]) for b in scenes),
         "intrinsics_gap": max(rel_l2(intr_prog[b], intr[b]) for b in scenes),
         "points_gap": max(points_gap(pts_prog[b], valid_prog[b], pts[b], msk[b]) for b in scenes)}
    if gaps:
        r["ref_view_score_gap"] = max(gaps)
    opt = build_optimizer(ref.named_parameters(), **optim_kwargs)
    trained = dict(zip(opt.names, opt.params))
    before = {n: p.detach().clone() for n, p in trained.items()}
    losses, g1 = [], {}
    for s in range(len(recs[0]["steps"])):
        steps = [rec["steps"][s] for rec in recs]
        opt.zero_grad()
        with (ctx if s == 0 else contextlib.nullcontext()):
            _, parts, _ = bk.refinement(_cat(steps, "points"), _cat(steps, "valid"),
                                        gt_points=_cat([mine[s] for mine in batches], "gt_points"),
                                        return_loss=True)
            total = sum(parts.values())
            total.backward()
        opt.step()
        losses.append(float(total.detach()))
        if s == 0:
            b1 = opt.b1(0)
            g1 = {n: float(torch.linalg.vector_norm(m.double())) / (1 - b1) for n, m in zip(opt.names, opt.mu)}
    change = {n: float(torch.linalg.vector_norm((p.detach() - before[n]).double())) for n, p in trained.items()}
    r["loss_gap"] = max(abs(a - b) / max(abs(b), 1e-30) for rec in recs for a, b in zip(rec["losses"], losses))
    med_g = median(g1.values())
    r["grad_gap"] = max(abs(rec["grad"][n] - g) / max(g, med_g, 1e-30) for rec in recs for n, g in g1.items())
    moved = [n for n, g in g1.items() if g >= 1e-3 * med_g]
    med_c = median(change[n] for n in moved)
    r["update_gap"] = max(abs(rec["change"][n] - change[n]) / max(change[n], med_c, 1e-30)
                          for rec in recs for n in moved)
    worst = sorted((abs(rec["grad"][n] - g) / max(g, med_g, 1e-30), n) for rec in recs for n, g in g1.items())[-3:]
    print("readings: leaves of the largest first-gradient gaps", worst, file=sys.stderr, flush=True)
    r["leaves"] = float(len(g1))
    r["leaves_left_out"] = float(len(g1) - len(moved))
    return r


def _move(x, device):
    """Tensors in nested dicts and lists, on ``device``."""
    if torch.is_tensor(x):
        return x.to(device)
    if isinstance(x, dict):
        return {k: _move(v, device) for k, v in x.items()}
    if isinstance(x, list):
        return [_move(v, device) for v in x]
    return x


class Family:
    """One run's ResDet3D side, driven by ``harness/main.py`` phase by phase:
    ``build``, ``make_inputs``, ``make_client``, ``warm_up``, ``keep`` (each
    checked request of the window), ``reset_counters`` / ``counters``,
    ``info``, ``record`` (this rank's share of the check, gathered to rank 0),
    ``free``, then on rank 0 ``readings`` and ``counts``.

    ``control`` puts the reference, computed one precision lower, in the
    program's place; for a cell of several ranks it runs in one process over
    the global batch (every rank's entries side by side)."""

    def __init__(self, cfg: Dict, traffic: Dict, seed: int, device, control: bool = False, rank: int = 0,
                 ranks: int = 1):
        self.cfg, self.traffic, self.seed, self.device = cfg, traffic, seed, torch.device(device)
        self.control, self.rank, self.ranks = control, rank, ranks
        self.kind = traffic["kind"]
        self.kept: Dict[int, Dict] = {}
        self.rec: Optional[Dict] = None
        self.model = self.client = self.picks = None
        self.fps_calls = None

    # set-up
    def build(self) -> None:
        if self.control:
            from benchmark.reference import vit as vit_module

            self.model = build_reference(self.cfg, self.seed, self.device)
        else:
            from recondet3d_torch.models.da3 import vit as vit_module

            self.model = build_program(self.cfg, self.seed, self.device)
        self.picks = Recorder(vit_module)

    def _pool(self, rank: Optional[int], count: Optional[int] = None) -> List[Dict]:
        """Rank ``rank``'s pool; ``None``: the global batch's (the ranks'
        entries side by side)."""
        if rank is not None:
            return make_pool(self.traffic, self.cfg, self.seed, self.device, rank=rank, count=count)
        pools = [self._pool(r, count) for r in range(int(self.traffic.get("ranks", 1)))]
        return [{k: torch.cat([p[i][k] for p in pools]) for k in pools[0][i]} for i in range(len(pools[0]))]

    def make_inputs(self) -> None:
        whole = self.control and int(self.traffic.get("ranks", 1)) > 1
        self.pool = self._pool(None if whole else self.rank)

    def make_client(self):
        if self.kind == "infer":
            self.client = InferClient(self.model, self.pool, self.traffic)
        else:
            self.client = (RefTrainClient if self.control else TrainClient)(self.model, self.pool, self.cfg,
                                                                           self.traffic)
        return self.client

    def precision(self):
        """The context the control computes in (one precision lower); none for the program."""
        if not self.control:
            return contextlib.nullcontext()
        from benchmark.reference.lowp import lower_precision

        return lower_precision()

    def warm_up(self, timed) -> None:
        """Infer: ``warmup`` requests. Train: the checked steps, recorded."""
        if self.kind == "infer":
            for w in range(int(self.traffic.get("warmup", 2))):
                timed(w)
        else:
            with self.precision():
                self.rec = train_check_steps(self.model, self.client, int(self.traffic["checked_steps"]), self.picks)

    # the window
    def keep(self, i: int, res) -> None:
        self.kept[i] = dict(infer_outputs(*res), ref_view=self.picks.take())

    def reset_counters(self) -> None:
        if self.control:
            return
        from recondet3d_torch.ops import attention as attn_ops, fps as fps_ops

        attn_ops.reset_launch_counts()
        fps_ops.reset_launch_counts()

    def counters(self) -> Dict:
        """Counts the program made in the window (read once, after it)."""
        if self.control:
            return {}
        from recondet3d_torch.ops import fps as fps_ops

        return {"fps_exchange": fps_ops.exchange_counts()}

    def info(self) -> Dict:
        if self.control:
            return {}
        from recondet3d_torch.ops import attention as attn_ops, fps as fps_ops

        fn = fps_ops.furthest_point_sample_cuda
        return {"attention_launches": {w.__name__: {str(k): v for k, v in w.launches_by_shape.items()}
                                       for w in (attn_ops.flash_attention_fwd, attn_ops.attention_fwd_cuda_core,
                                                 attn_ops.attention_fwd_short, attn_ops.flash_attention_bwd_dq,
                                                 attn_ops.flash_attention_bwd_dkv)},
                "fps_launches": {str(k): v for k, v in getattr(fn, "launches_by_shape", {}).items()},
                "valid_points_last_request": {k: [int(c) for c in v] for k, v in
                                              self.model.reconstruction_backbone.last_stage_counts.items()}}

    def record(self, to_host: bool = False):
        """This rank's share of the check (on the host when it is to be
        gathered to another process)."""
        rec = self.kept if self.kind == "infer" else self.rec
        return _move(rec, "cpu") if to_host else rec

    def free(self) -> None:
        self.picks.remove()
        self.model = self.client = self.picks = None

    # the check, on rank 0
    def readings(self, records: List, flops) -> List[Dict[str, float]]:
        """The numbers of the check, one dict per checked request (infer) or
        one for the checked steps (train); ``records`` holds each rank's
        ``record()``. The reference runs at the stated precision, TF32 off."""
        from benchmark.reference import sampling as ref_sampling

        if self.device.type == "cuda":
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        records = [_move(r, self.device) for r in records]
        ref = build_reference(self.cfg, self.seed, self.device)
        self.fps_calls = ref_sampling.CALLS = []
        out: List[Dict[str, float]] = []
        try:
            if self.kind == "infer":
                kept = records[0]
                for j in sorted(kept):
                    out.append(infer_readings(ref, kept[j], self.pool[j % len(self.pool)], flops if not out else None))
            else:
                steps = int(self.traffic["checked_steps"])
                batches = [self.pool[:steps]] + [self._pool(r, steps) for r in range(1, len(records))]
                out.append(train_readings(ref, records, batches, optim_kwargs(self.cfg, self.traffic), flops))
        finally:
            ref_sampling.CALLS = None
        return out

    def counts(self) -> Dict:
        """The counts behind rooflines, per request: the attention launches of
        the configuration's DA3 at the traffic's shapes, and the least time of
        the FPS calls the reference made on the checked requests."""
        if self.kind != "infer":
            return {}
        from benchmark.counts import attention as attn_count, fps as fps_count
        from benchmark.reference.input_processor import compute_process_shape

        rb = self.cfg["model"]["reconstruction_backbone"]
        ph, pw = compute_process_shape(*self.traffic["image_hw"], int(rb["process_res"]))[2:]
        return {"attention": attn_count.least_seconds(attn_count.launches(rb["pretrained"], int(self.traffic["batch"]),
                                                                           int(self.traffic["views"]), ph, pw)),
                "fps_least_s": fps_count.least_seconds(self.fps_calls or []) / max(len(self.kept), 1)}


# faults planted underneath the timed path (the harness's tests and calibrate.py): each is
# ``fault(model, client)``, applied to the built program before set-up's first request or step

def half_batch(model, client):
    """Half of the batch left out: the request runs on the first half of its
    scenes and hands their outputs out for the rest as well."""
    inner = model.simple_test

    def simple_test(img, cam2lidar_rts, depth_override=None):
        h = max(1, img.shape[0] // 2)
        out = inner(img[:h], cam2lidar_rts[:h], depth_override=None if depth_override is None else depth_override[:h])
        reps = -(-img.shape[0] // h)

        def fill(x):
            if torch.is_tensor(x) and x.dim() > 0 and x.shape[0] == h:
                return torch.cat([x] * reps)[:img.shape[0]]
            if isinstance(x, dict):
                return {k: fill(v) for k, v in x.items()}
            if isinstance(x, list):
                return [fill(v) for v in x]
            return x

        return fill(out)

    model.simple_test = simple_test


def altered_logit(model, client):
    """One occupancy logit of the first scene moved by 1.0 where the refinement produces it."""
    bev = model.reconstruction_backbone.refinement.bev_height_occupancy

    def post(_m, _a, out):
        out = out.clone()
        out.view(-1)[0] += 1.0
        return out

    bev.register_forward_hook(post)


def altered_box(model, client):
    """The first decoded box of the first scene moved by 1 m."""
    head = model.pts_bbox_head
    inner = head.decode

    def decode(*a, **k):
        res = inner(*a, **k)
        if len(res[0]["boxes_3d"]):
            res[0]["boxes_3d"] = res[0]["boxes_3d"].copy()
            res[0]["boxes_3d"][0, 0] += 1.0
        return res

    head.decode = decode


def frozen_step(model, client):
    """The optimizer's step returns with the state unchanged."""
    opt = client.trainer.optimizer
    inner = opt.step

    def step():
        saved = [p.detach().clone() for p in opt.params]
        norm = inner()
        with torch.no_grad():
            for p, s in zip(opt.params, saved):
                p.copy_(s)
        return norm

    opt.step = step


def _ddp(client):
    """The ``DistributedDataParallel`` module the Trainer's step drives."""
    from torch.nn.parallel import DistributedDataParallel

    cells = client.trainer._step_fn.__closure__ or ()
    return next(c.cell_contents for c in cells if isinstance(c.cell_contents, DistributedDataParallel))


def exchange_left_out(model, client):
    """The gradients' exchange between ranks left out: each rank steps on its own gradient."""

    def local(_state, bucket):
        fut = torch.futures.Future()
        fut.set_result(bucket.buffer())
        return fut

    _ddp(client).register_comm_hook(None, local)


def half_ranks(model, client):
    """Half of the global batch left out: the gradient is the mean over the
    first half of the ranks' scenes alone."""
    import torch.distributed as dist

    def first_half(group, bucket):
        n = dist.get_world_size(group)
        buf = bucket.buffer()
        if dist.get_rank(group) >= n // 2:
            buf.zero_()
        buf.div_(n // 2)
        return dist.all_reduce(buf, group=group, async_op=True).get_future().then(lambda f: f.value()[0])

    ddp = _ddp(client)
    ddp.register_comm_hook(ddp.process_group, first_half)


FAULTS = {"half_batch": half_batch, "altered_logit": altered_logit, "altered_box": altered_box,
          "frozen_step": frozen_step, "exchange_left_out": exchange_left_out, "half_ranks": half_ranks}


def faults_for(traffic: Dict) -> List[str]:
    """The faults a cell of this traffic can have."""
    if traffic["kind"] == "train":
        return ["frozen_step"] + (["exchange_left_out", "half_ranks"] if int(traffic.get("ranks", 1)) > 1 else [])
    return (["altered_logit"] + (["half_batch"] if int(traffic["batch"]) > 1 else [])
            + (["altered_box"] if traffic.get("decode") else []))

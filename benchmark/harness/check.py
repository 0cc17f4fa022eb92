"""How ``correct`` is decided: what the timed path produced, held against the
plain reference (``benchmark/reference``) at the timed sizes.

The reference runs once the window has closed and the program is freed. It
recomputes DA3 from the benchmark's images and weights, with the reference
view the program picked (``refview.py``; how far that pick lies from the
reference's own is printed as ``ref_view_score_gap``); for the stages
after DA3 it follows the program's own state one stage at a time, because
FPS and the ball query turn a rounding difference into another point set:
the point path runs on the program's intrinsics and the benchmark's depth,
the refinement on the program's selected points, the head on the
reference's own BEV features, the decode on the reference's own head
outputs. Each stage is compared by itself (``PERF.md`` lists the numbers,
the readings they were set from and the limits).
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List

import torch

from benchmark.harness.refview import forced

__all__ = ["rel_l2", "max_rel", "points_gap", "boxes_gap", "infer_outputs", "infer_readings", "train_readings",
           "verdict"]


def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double(), b.double()
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b).clamp(min=1e-30))


def max_rel(a: torch.Tensor, b: torch.Tensor) -> float:
    """The largest elementwise gap over the reference's largest magnitude."""
    a, b = a.double(), b.double()
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))


def points_gap(p: torch.Tensor, v: torch.Tensor, p_ref: torch.Tensor, v_ref: torch.Tensor, tol: float = 1e-4) -> float:
    """The share of output slots (B, P) where the program and the reference
    disagree: one valid and the other not, or both valid and a coordinate
    more than ``tol`` m apart."""
    both = v & v_ref
    far = (p[..., :3].double() - p_ref[..., :3].double()).abs().amax(-1) > tol
    bad = (v != v_ref) | (both & far)
    return float(bad.double().mean())


def boxes_gap(res: List[Dict], res_ref: List[Dict], tol: float = 1e-3) -> float:
    """The decoded boxes with no equal box on the other side, counted over
    the scenes and both sides: equal is the same label, the score within
    ``tol`` and every box field within ``tol`` (metres, radians, m/s), in
    any order (equal scores may come out in either order)."""
    unmatched = 0
    for r, q in zip(res, res_ref):
        a = torch.cat([torch.as_tensor(r["boxes_3d"]).double().reshape(-1, 9),
                       torch.as_tensor(r["scores_3d"]).double().reshape(-1, 1)], 1)
        b = torch.cat([torch.as_tensor(q["boxes_3d"]).double().reshape(-1, 9),
                       torch.as_tensor(q["scores_3d"]).double().reshape(-1, 1)], 1)
        la, lb = torch.as_tensor(r["labels_3d"]).reshape(-1), torch.as_tensor(q["labels_3d"]).reshape(-1)
        ok = ((a[:, None] - b[None]).abs().amax(-1) <= tol) & (la[:, None] == lb[None])
        used = torch.zeros(b.shape[0], dtype=torch.bool)
        for i in range(a.shape[0]):
            free = (ok[i] & ~used).nonzero()
            if len(free):
                used[free[0, 0]] = True
            else:
                unmatched += 1
        unmatched += int((~used).sum())
    return float(unmatched)


def infer_outputs(out: Dict, decoded) -> Dict:
    """What a request produced, kept for the check: DA3 depth and
    intrinsics, the selected points, the occupancy logits, the head's raw
    outputs and the decoded boxes (detached; results on the host stay). The
    caller adds DA3's reference view (``ref_view``)."""
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


def train_readings(ref, prog: Dict, batches: List[Dict], optim_kwargs: Dict, flops=None) -> Dict[str, float]:
    """The numbers of the first steps of training. ``prog`` holds what the
    program's steps produced: per step DA3's depth and intrinsics, the
    selected points (from the step's anchored depth) and the loss; the first
    gradient by leaf (from the optimizer's first moment after one step) and
    each leaf's change after the steps. The reference checks step 1's DA3
    (depth and intrinsics) and point path, then
    follows the refinement's steps from the program's points with its own
    optimizer."""
    from benchmark.reference.optim import build_optimizer

    ref.train()
    bk = ref.reconstruction_backbone
    ctx = flops if flops is not None else contextlib.nullcontext()
    steps = prog["steps"]
    gaps: List[float] = []
    with torch.no_grad(), ctx, forced(steps[0].get("ref_view"), gaps):
        depth, intr, _ = bk.predict_depth(batches[0]["img"])
    r = {"depth_gap": rel_l2(steps[0]["da3_depth"], depth), "intrinsics_gap": rel_l2(steps[0]["intrinsics"], intr)}
    if gaps:
        r["ref_view_score_gap"] = max(gaps)
    with torch.no_grad():
        pts, msk = bk.points_from_depth(batches[0]["depth"].float(), steps[0]["intrinsics"], batches[0]["img"],
                                        batches[0]["cam2lidar_rts"])
    r["points_gap"] = points_gap(steps[0]["points"], steps[0]["valid"], pts, msk)
    opt = build_optimizer(ref.named_parameters(), **optim_kwargs)
    trained = dict(zip(opt.names, opt.params))
    before = {n: p.detach().clone() for n, p in trained.items()}
    losses, g1 = [], {}
    for s, (step, batch) in enumerate(zip(steps, batches)):
        opt.zero_grad()
        with (ctx if s == 0 else contextlib.nullcontext()):
            _, parts, _ = bk.refinement(step["points"], step["valid"], gt_points=batch["gt_points"],
                                        return_loss=True)
            total = sum(parts.values())
            total.backward()
        opt.step()
        losses.append(float(total.detach()))
        if s == 0:
            b1 = opt.b1(0)
            g1 = {n: float(torch.linalg.vector_norm(m.double())) / (1 - b1) for n, m in zip(opt.names, opt.mu)}
    change = {n: float(torch.linalg.vector_norm((p.detach() - before[n]).double())) for n, p in trained.items()}
    r["loss_gap"] = max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(prog["losses"], losses))
    med_g = _median(g1.values())
    r["grad_gap"] = max(abs(prog["grad"][n] - g) / max(g, med_g, 1e-30) for n, g in g1.items())
    moved = [n for n, g in g1.items() if g >= 1e-3 * med_g]
    med_c = _median(change[n] for n in moved)
    r["update_gap"] = max(abs(prog["change"][n] - change[n]) / max(change[n], med_c, 1e-30) for n in moved)
    r["leaves"] = float(len(g1))
    r["leaves_left_out"] = float(len(g1) - len(moved))
    return r


def verdict(readings: Dict[str, float], limits: Dict[str, float]) -> bool:
    """True when every limited number is finite and within its limit."""
    return all(k in readings and math.isfinite(readings[k]) and readings[k] <= lim for k, lim in limits.items())


def _median(values) -> float:
    v = sorted(values)
    return v[len(v) // 2] if v else 0.0


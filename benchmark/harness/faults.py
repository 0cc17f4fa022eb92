"""Faults planted underneath the timed path, to show that the check turns
``correct`` false: each is a function ``fault(model, client)`` that breaks
the built program before set-up's first request or step.

- ``half_batch``: half of the batch left out: the request runs on the first
  half of its scenes and hands their outputs out for the rest as well;
- ``altered_logit``: one occupancy logit of the first scene moved by 1.0 where
  the refinement produces it;
- ``altered_box``: the first decoded box of the first scene moved by 1 m;
- ``frozen_step``: the optimizer's step returns with the state unchanged.

A one-chip cell has no exchange between chips to leave out.
"""

from __future__ import annotations

import torch

__all__ = ["FAULTS", "faults_for"]


def half_batch(model, client):
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
    bev = model.reconstruction_backbone.refinement.bev_height_occupancy

    def post(_m, _a, out):
        out = out.clone()
        out.view(-1)[0] += 1.0
        return out

    bev.register_forward_hook(post)


def altered_box(model, client):
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


FAULTS = {"half_batch": half_batch, "altered_logit": altered_logit, "altered_box": altered_box,
          "frozen_step": frozen_step}


def faults_for(kind: str, batch: int, decode: bool):
    """The faults a cell of this kind can have."""
    if kind == "train":
        return ["frozen_step"]
    names = ["altered_logit"] + (["half_batch"] if batch > 1 else []) + (["altered_box"] if decode else [])
    return names

"""How a random-weight DA3 behaves under fine-tuning steps on the card.

    python -m recondet3d_torch.tools.finetune_divergence [steps]

Runs ``steps`` (default 8) AdamW steps of the full-width fine-tuning
configuration (da3-large unfrozen, lr 1e-4, one scene of six 900x1600
views, 40,000 GT points) for two seeds, once with the weights as the
initializers give them and once with the depth head's last convolution
scaled by 0.1, and prints per step the loss, the gradient norm, the range
of the predicted depth and the points a scene keeps. With the weights as
built the depth maximum grows by orders of magnitude a step until exp()
overflows; from then on every DA3 gradient is NaN although the inf pixel
is masked out of the cloud (0 * inf in the backward pass). Needs CUDA.
"""

from __future__ import annotations

import json
import sys

import numpy as np
import torch

from recondet3d_torch.data.anchor_scene import rig_cam2lidar
from recondet3d_torch.models.detect import build_resdet3d
from recondet3d_torch.train import Trainer

REFINEMENT = dict(max_voxels=40960, occ_max_voxels=65536, stage_caps=(40960, 32768, 24576, 16384))


def batch(seed: int):
    rng = np.random.default_rng(seed)
    img = rng.uniform(0.0, 255.0, size=(1, 6, 900, 1600, 3)).astype(np.float32)
    gt = rng.uniform(-50, 50, (1, 40000, 3)).astype(np.float32)
    gt[..., 2] = rng.uniform(-4, 2, (1, 40000))
    return {k: torch.from_numpy(v).cuda() for k, v in dict(img=img, cam2lidar_rts=rig_cam2lidar(1), gt_points=gt).items()}


def trial(scale: float, seed: int, steps: int):
    model = build_resdet3d("da3-large", dtype=torch.bfloat16, device="cuda",
                           generator=torch.Generator(device="cuda").manual_seed(seed), refinement=REFINEMENT,
                           voxel_pre_reduce=0.1, freeze_da3=False)
    with torch.no_grad():
        model.reconstruction_backbone.da3.head.scratch.output_conv2._modules["2"].weight.mul_(scale)
    trainer = Trainer(model=model, total_steps=1000, lr=1e-4, frozen_patterns=())
    data = batch(500)
    for step in range(steps):
        model.train()
        trainer.optimizer.zero_grad()
        losses, aux = model(return_loss=True, **data)
        depth = aux["da3"]["depth"].float()
        total = sum(losses.values())
        total.backward()
        bad = sum(not bool(torch.isfinite(p.grad).all()) for p in model.parameters() if p.grad is not None)
        norm = trainer.optimizer.step()
        print(json.dumps(dict(depth_head_scale=scale, seed=seed, step=step, loss=total.item(), grad_norm=norm.item(),
                              depth_min=depth.min().item(), depth_max=depth.max().item(),
                              points_kept=int(aux["pseudo_valid"].sum()), non_finite_gradients=bad)), flush=True)
        if bad:
            break


def main() -> int:
    if not torch.cuda.is_available():
        print("finetune_divergence: CUDA is not available", file=sys.stderr)
        return 1
    steps = int(sys.argv[1]) if len(sys.argv) > 1 else 8
    for scale in (1.0, 0.1):
        for seed in (1, 2):
            trial(scale, seed, steps)
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())

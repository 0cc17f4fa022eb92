"""BEV height-occupancy U-Net (port of
``recondet3d/models/refine/bev_unet.py``).

Input projection -> encoder 256 -> 512 -> 1024 -> 2048 (stride 2 after the
first stage) with channel attention and residuals -> decoder with bilinear
upsampling and skip concatenation -> 1x1 compression to the height levels.
Public layout channels-last, (B, H, W, C) in and (B, H, W, 32) fp32 logits
out, as in the JAX package; NCHW inside. Module names follow the flax tree
(``enc0_conv1``, ``enc0_bn1``, ``attn0.fc1``, ``occ_head0_conv``, ...).
Convolutions run in ``dtype`` with fp32 parameters; batch norms (eps 1e-3;
running statistics in eval mode, batch statistics in train mode) and the
last convolution run in fp32.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from recondet3d_torch.utils.interpolation import interpolate_nchw

__all__ = ["BEVHeightOccupancy", "FlaxBatchNorm2d"]


class _Conv(nn.Conv2d):
    """Conv2d with fp32 parameters that computes in ``compute_dtype``."""

    def __init__(self, cin, cout, k, stride=1, padding=0, compute_dtype=torch.float32, device=None):
        super().__init__(cin, cout, k, stride=stride, padding=padding, device=device)
        self.compute_dtype = compute_dtype

    def forward(self, x):
        dt = self.compute_dtype
        return F.conv2d(x.to(dt), self.weight.to(dt), self.bias.to(dt), self.stride, self.padding)


class FlaxBatchNorm2d(nn.Module):
    """Batch norm over NCHW in fp32, as flax's ``nn.BatchNorm`` (the U-Net's:
    eps 1e-3, momentum 0.99). Eval mode: the running statistics. Train mode:
    the batch mean and biased variance, and ``running = momentum * running +
    (1 - momentum) * batch`` with, as in flax, the biased variance
    (``F.batch_norm`` would move ``running_var`` towards the unbiased one)."""

    def __init__(self, channels, device=None, momentum: float = 0.99, eps: float = 1e-3):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.weight = nn.Parameter(torch.ones(channels, device=device))
        self.bias = nn.Parameter(torch.zeros(channels, device=device))
        self.register_buffer("running_mean", torch.zeros(channels, device=device))
        self.register_buffer("running_var", torch.ones(channels, device=device))

    def forward(self, x):
        x = x.float()
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias,
                                training=False, eps=self.eps)
        with torch.no_grad():
            var, mean = torch.var_mean(x, dim=(0, 2, 3), unbiased=False)
            self.running_mean.mul_(self.momentum).add_(mean, alpha=1 - self.momentum)
            self.running_var.mul_(self.momentum).add_(var, alpha=1 - self.momentum)
        return F.batch_norm(x, None, None, self.weight, self.bias, training=True, eps=self.eps)


class _ChannelAttention(nn.Module):
    """Global average pool -> 1x1 conv -> ReLU -> 1x1 conv -> sigmoid."""

    def __init__(self, channels, dtype, device=None):
        super().__init__()
        self.fc1 = _Conv(channels, channels // 4, 1, compute_dtype=dtype, device=device)
        self.fc2 = _Conv(channels // 4, channels, 1, compute_dtype=dtype, device=device)

    def forward(self, x):
        g = x.mean(dim=(2, 3), keepdim=True)
        return torch.sigmoid(self.fc2(F.relu(self.fc1(g))))


class BEVHeightOccupancy(nn.Module):
    """``bug_compatible_relu_logits=True`` reproduces the reference's
    compression loop, which reaches the target channel count inside a
    conv + BN + ReLU block (logits >= 0); the default ends in a bare 1x1
    convolution with unbounded logits."""

    def __init__(
        self,
        in_channels: int = 256,
        unet_channels: Sequence[int] = (256, 512, 1024, 2048),
        occ_feature_shape: Sequence[int] = (180, 180, 32),  # (X, Y, C)
        use_residual: bool = True,
        use_attention: bool = True,
        bug_compatible_relu_logits: bool = False,
        dtype=torch.float32,
        device=None,
    ):
        super().__init__()
        ch = list(unet_channels)
        self.ch, self.dtype = ch, dtype
        self.use_residual, self.use_attention = use_residual, use_attention
        conv = lambda cin, cout, k, **kw: _Conv(cin, cout, k, compute_dtype=dtype, device=device, **kw)
        self.input_proj = conv(in_channels, ch[0], 1)
        for i in range(len(ch) - 1):
            in_ch, out_ch = ch[i], ch[i + 1]
            if i == 0:
                setattr(self, f"enc{i}_conv1", conv(in_ch, in_ch, 3, padding=1))
                setattr(self, f"enc{i}_bn1", FlaxBatchNorm2d(in_ch, device))
                setattr(self, f"enc{i}_conv2", conv(in_ch, out_ch, 3, padding=1))
            else:
                setattr(self, f"enc{i}_conv1", conv(in_ch, out_ch, 3, stride=2, padding=1))
                setattr(self, f"enc{i}_bn1", FlaxBatchNorm2d(out_ch, device))
                setattr(self, f"enc{i}_conv2", conv(out_ch, out_ch, 3, padding=1))
            setattr(self, f"enc{i}_bn2", FlaxBatchNorm2d(out_ch, device))
            if use_attention:
                setattr(self, f"attn{i}", _ChannelAttention(out_ch, dtype, device))
        cur = ch[-1]
        for i in range(len(ch) - 1):
            if i == 0:
                out_ch = ch[-2]
            else:
                cur += ch[len(ch) - (i + 1)]  # the skip: enc_feats[len - (i + 1)] has ch[len - (i + 1)] channels
                out_ch = ch[-(i + 2)]
            setattr(self, f"dec{i}_conv1", conv(cur, out_ch, 3, padding=1))
            setattr(self, f"dec{i}_bn1", FlaxBatchNorm2d(out_ch, device))
            setattr(self, f"dec{i}_conv2", conv(out_ch, out_ch, 3, padding=1))
            setattr(self, f"dec{i}_bn2", FlaxBatchNorm2d(out_ch, device))
            cur = out_ch

        target = int(occ_feature_shape[2])
        cur, k = ch[0], 0
        more = (lambda c: c > target) if bug_compatible_relu_logits else (lambda c: max(c // 2, target) > target)
        while more(cur):
            nxt = max(cur // 2, target)
            setattr(self, f"occ_head{k}_conv", conv(cur, nxt, 1))
            setattr(self, f"occ_head{k}_bn", FlaxBatchNorm2d(nxt, device))
            cur, k = nxt, k + 1
        self.n_head = k
        self.occ_head_final = None
        if not bug_compatible_relu_logits or cur != target:
            self.occ_head_final = _Conv(cur, target, 1, compute_dtype=torch.float32, device=device)

    def _m(self, name):
        return getattr(self, name)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, H, W, in_channels) -> logits (B, H, W, occ channels) fp32."""
        ch = self.ch
        x = self.input_proj(x.permute(0, 3, 1, 2))
        enc_feats = [x]
        for i in range(len(ch) - 1):
            h = self._m(f"enc{i}_conv1")(enc_feats[-1])
            h = F.relu(self._m(f"enc{i}_bn1")(h))
            h = self._m(f"enc{i}_conv2")(h)
            h = F.relu(self._m(f"enc{i}_bn2")(h))
            if self.use_attention:
                h = h * self._m(f"attn{i}")(h)
            if self.use_residual and i != 0 and ch[i] == ch[i + 1]:
                h = h + enc_feats[-1]
            enc_feats.append(h)

        h = enc_feats[-1]
        for i in range(len(ch) - 1):
            if i > 0:
                skip = enc_feats[len(enc_feats) - (i + 1)]
                h = interpolate_nchw(h, tuple(skip.shape[-2:]), mode="bilinear", align_corners=False)
                h = torch.cat([h, skip.to(h.dtype)], dim=1)
            h = F.relu(self._m(f"dec{i}_bn1")(self._m(f"dec{i}_conv1")(h)))
            h = F.relu(self._m(f"dec{i}_bn2")(self._m(f"dec{i}_conv2")(h)))

        for k in range(self.n_head):
            h = F.relu(self._m(f"occ_head{k}_bn")(self._m(f"occ_head{k}_conv")(h)))
        if self.occ_head_final is not None:
            h = self.occ_head_final(h)
        return h.float().permute(0, 2, 3, 1)

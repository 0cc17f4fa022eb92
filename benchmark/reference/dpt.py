"""DPT dense-prediction heads, fp32 (port of ``recondet3d/models/da3/dpt.py``
``DPT`` and ``DualDPT``).

The public tensors keep the JAX layouts (tokens (B, S, N, C), outputs
(B, S, H', W') and channels-last ray maps); the convolutions run NCHW.
Module names follow the upstream DA3 state dict (``projects.i``,
``resize_layers.i``, ``scratch.refinenetK``, ``scratch.output_conv2.0``, ...).
DualDPT's auxiliary levels 0-2 are dead at inference and, as in the JAX
package, are not built.
"""

from __future__ import annotations

import functools
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from benchmark.reference.interpolation import interpolate_nchw

__all__ = ["DPT", "DualDPT", "apply_activation", "create_uv_grid",
           "position_grid_to_embed"]


def apply_activation(x, activation: str):
    a = activation.lower()
    if a == "exp":
        return torch.exp(x)
    if a == "expp1":
        return torch.exp(x) + 1
    if a == "expm1":
        return torch.expm1(x)
    if a == "relu":
        return F.relu(x)
    if a == "sigmoid":
        return torch.sigmoid(x)
    if a == "softplus":
        return F.softplus(x)
    if a == "tanh":
        return torch.tanh(x)
    return x


def create_uv_grid(width: int, height: int, aspect_ratio: Optional[float] = None) -> np.ndarray:
    """(height, width, 2) normalized UV grid."""
    if aspect_ratio is None:
        aspect_ratio = float(width) / float(height)
    diag = (aspect_ratio ** 2 + 1.0) ** 0.5
    span_x, span_y = aspect_ratio / diag, 1.0 / diag
    xs = np.linspace(-span_x * (width - 1) / width, span_x * (width - 1) / width, width)
    ys = np.linspace(-span_y * (height - 1) / height, span_y * (height - 1) / height, height)
    uu, vv = np.meshgrid(xs, ys)
    return np.stack([uu, vv], axis=-1).astype(np.float32)


def position_grid_to_embed(pos_grid: np.ndarray, embed_dim: int, omega_0: float = 100.0) -> np.ndarray:
    """(H, W, 2) -> (H, W, embed_dim) sincos embedding."""
    H, W, _ = pos_grid.shape
    flat = pos_grid.reshape(-1, 2)

    def sincos(pos):
        omega = np.arange(embed_dim // 4, dtype=np.float64) / (embed_dim / 4.0)
        omega = 1.0 / omega_0 ** omega
        out = np.einsum("m,d->md", pos, omega)
        return np.concatenate([np.sin(out), np.cos(out)], axis=1)

    emb = np.concatenate([sincos(flat[:, 0]), sincos(flat[:, 1])], axis=-1)
    return emb.reshape(H, W, embed_dim).astype(np.float32)


@functools.lru_cache(maxsize=16)
def _uv_embed_chw(ph: int, pw: int, channels: int, aspect: float, ratio: float, device: torch.device):
    """The constant UV embedding as a (C, h, w) fp32 tensor, made once per
    shape and device: rebuilding it and copying it from pageable host memory
    on every call cost about 4 % of a nested-giant request on an H100
    (PERF.md, Findings)."""
    pe = position_grid_to_embed(create_uv_grid(pw, ph, aspect_ratio=aspect), channels) * ratio
    with torch.inference_mode(False):  # usable outside inference mode too
        return torch.from_numpy(np.ascontiguousarray(pe.transpose(2, 0, 1))).to(device)


def _add_pos_embed(x, W, H, ratio=0.1):
    """x (N, C, h, w) + the UV sincos embedding of an (h, w) grid with the image's aspect."""
    pe = _uv_embed_chw(x.shape[-2], x.shape[-1], x.shape[1], W / H, ratio, x.device)
    return x + pe.to(x.dtype)[None]


def _interp(x, size):
    """bilinear, align_corners=True (the reference's custom_interpolate)."""
    return interpolate_nchw(x, tuple(size), mode="bilinear", align_corners=True)


def _conv3(cin, cout, device, bias=True, stride=1):
    return nn.Conv2d(cin, cout, 3, stride=stride, padding=1, bias=bias, device=device)


class _ChannelLayerNorm(nn.LayerNorm):
    """LayerNorm over the channel dim of an NCHW map."""

    def forward(self, x):
        return super().forward(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)


class _HeadConv2(nn.Module):
    """conv3 -> [LN] -> relu -> conv1, indexed like the reference's Sequential
    (``0`` conv, ``2`` LN or the last conv, ``5`` the last conv after an LN)."""

    def __init__(self, cin, mid, out, use_ln=False, device="cuda"):
        super().__init__()
        self.add_module("0", _conv3(cin, mid, device))
        self.use_ln = use_ln
        if use_ln:
            self.add_module("2", _ChannelLayerNorm(mid, eps=1e-5, device=device))
        self.add_module("5" if use_ln else "2", nn.Conv2d(mid, out, 1, device=device))

    def forward(self, x):
        x = self._modules["0"](x)
        if self.use_ln:
            x = self._modules["2"](x)
            return self._modules["5"](F.relu(x))
        return self._modules["2"](F.relu(x))


class ResidualConvUnit(nn.Module):
    def __init__(self, features, device="cuda"):
        super().__init__()
        self.conv1 = _conv3(features, features, device)
        self.conv2 = _conv3(features, features, device)

    def forward(self, x):
        return self.conv2(F.relu(self.conv1(F.relu(x)))) + x


class FeatureFusionBlock(nn.Module):
    def __init__(self, features, has_residual=True, device="cuda"):
        super().__init__()
        self.resConfUnit1 = ResidualConvUnit(features, device) if has_residual else None
        self.resConfUnit2 = ResidualConvUnit(features, device)
        self.out_conv = nn.Conv2d(features, features, 1, device=device)

    def forward(self, x, lateral=None, size: Optional[Tuple[int, int]] = None):
        y = x
        if self.resConfUnit1 is not None and lateral is not None:
            y = y + self.resConfUnit1(lateral)
        y = self.resConfUnit2(y)
        if size is None:
            size = (y.shape[-2] * 2, y.shape[-1] * 2)
        return self.out_conv(_interp(y, size))


class _DPTCommon(nn.Module):
    """Token norm + stage projection/resizing + the rn convs, shared by the heads."""

    def __init__(self, dim_in, features, out_channels: Sequence[int], patch_size=14, pos_embed=False,
                 down_ratio=1, norm_type="idt", device="cuda"):
        super().__init__()
        self.dim_in = dim_in
        self.features = features
        self.patch_size = patch_size
        self.pos_embed = pos_embed
        self.down_ratio = down_ratio
        oc = tuple(out_channels)
        self.norm = nn.LayerNorm(dim_in, eps=1e-5, device=device) if norm_type == "layer" else None
        self.projects = nn.ModuleList(nn.Conv2d(dim_in, c, 1, device=device) for c in oc)
        self.resize_layers = nn.ModuleList([
            nn.ConvTranspose2d(oc[0], oc[0], 4, stride=4, device=device),
            nn.ConvTranspose2d(oc[1], oc[1], 2, stride=2, device=device),
            nn.Identity(),
            _conv3(oc[3], oc[3], device, stride=2),
        ])
        self.scratch = nn.Module()
        for i, c in enumerate(oc):
            setattr(self.scratch, f"layer{i + 1}_rn", _conv3(c, features, device, bias=False))

    def _pyramid(self, feats, H, W, patch_start_idx):
        """Tokens -> the four fusion-pyramid maps (after the rn convs), NCHW fp32."""
        B, S, N, C = feats[0][0].shape
        ph, pw = H // self.patch_size, W // self.patch_size
        rn = []
        for si in range(4):
            x = feats[si][0].reshape(B * S, N, C).float()[:, patch_start_idx:]
            if self.norm is not None:
                x = self.norm(x)
            x = x.reshape(B * S, ph, pw, C).permute(0, 3, 1, 2)
            x = self.projects[si](x)
            if self.pos_embed:
                x = _add_pos_embed(x, W, H)
            x = self.resize_layers[si](x)
            rn.append(getattr(self.scratch, f"layer{si + 1}_rn")(x))
        return rn

    def _fuse(self, rn, suffix=""):
        s = self.scratch
        out = getattr(s, f"refinenet4{suffix}")(rn[3], size=rn[2].shape[-2:])
        out = getattr(s, f"refinenet3{suffix}")(out, rn[2], size=rn[1].shape[-2:])
        out = getattr(s, f"refinenet2{suffix}")(out, rn[1], size=rn[0].shape[-2:])
        return getattr(s, f"refinenet1{suffix}")(out, rn[0])

    def _add_refinenets(self, suffix, device):
        for i in range(1, 5):
            setattr(self.scratch, f"refinenet{i}{suffix}", FeatureFusionBlock(self.features, i != 4, device))

    def _out_hw(self, H, W):
        ph, pw = H // self.patch_size, W // self.patch_size
        return int(ph * self.patch_size / self.down_ratio), int(pw * self.patch_size / self.down_ratio)


class DPT(_DPTCommon):
    """Main head (+conf if output_dim > 1) + optional sky head. Returns
    {head_name, head_name_conf?, sky?} of shape (B, S, H', W')."""

    def __init__(self, dim_in, output_dim, features, out_channels, patch_size=14, pos_embed=False,
                 down_ratio=1, norm_type="idt", activation="exp", conf_activation="expp1",
                 head_name="depth", use_sky_head=True, sky_name="sky", sky_activation="relu",
                 device="cuda"):
        super().__init__(dim_in, features, out_channels, patch_size, pos_embed, down_ratio, norm_type, device)
        self.output_dim = output_dim
        self.activation = activation
        self.conf_activation = conf_activation
        self.head_name = head_name
        self.sky_name = sky_name
        self.sky_activation = sky_activation
        self._add_refinenets("", device)
        self.scratch.output_conv1 = _conv3(features, features // 2, device)
        self.scratch.output_conv2 = _HeadConv2(features // 2, 32, output_dim, device=device)
        self.scratch.sky_output_conv2 = _HeadConv2(features // 2, 32, 1, device=device) if use_sky_head else None

    def forward(self, feats, H: int, W: int, patch_start_idx: int = 0) -> Dict[str, torch.Tensor]:
        B, S = feats[0][0].shape[:2]
        out = self._fuse(self._pyramid(feats, H, W, patch_start_idx))
        h_out, w_out = self._out_hw(H, W)
        fused = _interp(self.scratch.output_conv1(out), (h_out, w_out))
        if self.pos_embed:
            fused = _add_pos_embed(fused, W, H)
        logits = self.scratch.output_conv2(fused)
        outs: Dict[str, torch.Tensor] = {}
        if self.output_dim > 1:
            outs[self.head_name] = apply_activation(logits[:, 0], self.activation).reshape(B, S, h_out, w_out)
            outs[f"{self.head_name}_conf"] = apply_activation(logits[:, -1], self.conf_activation).reshape(
                B, S, h_out, w_out)
        else:
            outs[self.head_name] = apply_activation(logits[:, 0], self.activation).reshape(B, S, h_out, w_out)
        if self.scratch.sky_output_conv2 is not None:
            sky = self.scratch.sky_output_conv2(fused)[:, 0]
            outs[self.sky_name] = apply_activation(sky, self.sky_activation).reshape(B, S, h_out, w_out)
        return outs


class DualDPT(_DPTCommon):
    """DPT with an independent auxiliary pyramid: returns depth+conf and
    ray+ray_conf (the aux branch stays at the refinenet1 scale)."""

    def __init__(self, dim_in, output_dim, features, out_channels, patch_size=14, pos_embed=True,
                 down_ratio=1, norm_type="layer", activation="exp", conf_activation="expp1",
                 head_names=("depth", "ray"), aux_pyramid_levels=4, aux_out1_conv_num=5, device="cuda"):
        super().__init__(dim_in, features, out_channels, patch_size, pos_embed, down_ratio, norm_type, device)
        self.activation = activation
        self.conf_activation = conf_activation
        self.head_names = tuple(head_names)
        self.aux_level = aux_pyramid_levels - 1
        f = features
        self._add_refinenets("", device)
        self._add_refinenets("_aux", device)
        self.scratch.output_conv1 = _conv3(f, f // 2, device)
        self.scratch.output_conv2 = _HeadConv2(f // 2, 32, output_dim, device=device)
        chans = {5: [f // 2, f, f // 2, f, f // 2], 3: [f // 2, f, f // 2], 1: [f // 2]}[aux_out1_conv_num]
        convs, cin = [], f
        for c in chans:
            convs.append(_conv3(cin, c, device))
            cin = c
        lvl = str(self.aux_level)
        self.scratch.output_conv1_aux = nn.ModuleDict({lvl: nn.ModuleList(convs)})
        self.scratch.output_conv2_aux = nn.ModuleDict({lvl: _HeadConv2(cin, 32, 7, use_ln=True, device=device)})

    def forward(self, feats, H: int, W: int, patch_start_idx: int = 0,
                with_aux: bool = True) -> Dict[str, torch.Tensor]:
        """``with_aux=False`` skips the ray branch, whose outputs a caller
        with a camera decoder drops unused."""
        B, S = feats[0][0].shape[:2]
        head_main, head_aux = self.head_names
        rn = self._pyramid(feats, H, W, patch_start_idx)
        h_out, w_out = self._out_hw(H, W)

        fused = _interp(self.scratch.output_conv1(self._fuse(rn)), (h_out, w_out))
        if self.pos_embed:
            fused = _add_pos_embed(fused, W, H)
        logits = self.scratch.output_conv2(fused)
        outs = {
            head_main: apply_activation(logits[:, 0], self.activation).reshape(B, S, h_out, w_out),
            f"{head_main}_conf": apply_activation(logits[:, -1], self.conf_activation).reshape(B, S, h_out, w_out),
        }
        if not with_aux:
            return outs

        aux = self._fuse(rn, "_aux")
        for conv in self.scratch.output_conv1_aux[str(self.aux_level)]:
            aux = conv(aux)
        if self.pos_embed:
            aux = _add_pos_embed(aux, W, H)
        aux_logits = self.scratch.output_conv2_aux[str(self.aux_level)](aux)  # (BS, 7, ah, aw)
        ah, aw = aux_logits.shape[-2:]
        outs[head_aux] = aux_logits[:, :-1].permute(0, 2, 3, 1).reshape(B, S, ah, aw, 6)
        outs[f"{head_aux}_conf"] = apply_activation(aux_logits[:, -1], self.conf_activation).reshape(B, S, ah, aw)
        return outs



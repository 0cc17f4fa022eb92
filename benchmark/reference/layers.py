"""DINOv2 ViT building blocks (port of ``recondet3d/models/da3/layers.py``).

Parameter names follow the upstream DA3 torch state dict (``norm1``,
``attn.qkv``, ``ls1.gamma``, ``mlp.w12``, ...), so that the weight bridge
(``recondet3d_torch/api/weights.py``) maps them one to one onto the JAX tree.

Precision follows the JAX package: the trunk's products (patch embed,
qkv/proj/MLP, LayerScale) run in the module's ``dtype`` (bf16 on the card).
Their parameters are stored in ``param_dtype``: by default ``dtype`` itself
(the inference build), or fp32 for a model that is trained, whose fp32
master parameters are cast to ``dtype`` at use as flax casts
``param_dtype`` to ``dtype`` (an AdamW step of 1e-4 is lost in bf16).
``LayerNormFp32`` computes in fp32 and casts back. Attention goes through
``ops.attention.flash_attention`` (the hand-written kernels on CUDA
tensors, forward and backward).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from benchmark.reference.attention import attention

__all__ = [
    "LayerNormFp32",
    "Linear",
    "Mlp",
    "SwiGLUFFNFused",
    "LayerScale",
    "PatchEmbed",
    "Attention",
    "Block",
    "rope_2d",
    "rope_tables",
    "apply_rope_tables",
]


class LayerNormFp32(nn.LayerNorm):
    """LayerNorm computed in fp32 (autocast semantics), cast back to the input
    dtype. Its parameters stay fp32."""

    def forward(self, x):
        return F.layer_norm(x.float(), self.normalized_shape, self.weight, self.bias, self.eps).to(x.dtype)


class Linear(nn.Linear):
    """``nn.Linear`` computing in ``dtype`` with parameters stored in
    ``param_dtype`` (default: ``dtype``, and then the casts are no-ops)."""

    def __init__(self, in_features, out_features, bias=True, dtype=torch.float32, param_dtype=None, device="cuda"):
        super().__init__(in_features, out_features, bias=bias, dtype=param_dtype or dtype, device=device)
        self.compute_dtype = dtype

    def forward(self, x):
        dt = self.compute_dtype
        return F.linear(x, self.weight.to(dt), None if self.bias is None else self.bias.to(dt))


class Mlp(nn.Module):
    """fc1 -> exact-erf GELU -> fc2."""

    def __init__(self, in_features, hidden_features, out_features=None, dtype=torch.float32, param_dtype=None,
                 device="cuda"):
        super().__init__()
        out_features = out_features or in_features
        self.fc1 = Linear(in_features, hidden_features, dtype=dtype, param_dtype=param_dtype, device=device)
        self.fc2 = Linear(hidden_features, out_features, dtype=dtype, param_dtype=param_dtype, device=device)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class SwiGLUFFNFused(nn.Module):
    """SwiGLU FFN with the fused w12 layout and the 2/3-rounded-to-8 hidden
    size (``hidden_features`` is the pre-adjustment dim * mlp_ratio)."""

    def __init__(self, in_features, hidden_features, out_features=None, dtype=torch.float32, param_dtype=None,
                 device="cuda"):
        super().__init__()
        out_features = out_features or in_features
        hidden = (int(hidden_features * 2 / 3) + 7) // 8 * 8
        self.w12 = Linear(in_features, 2 * hidden, dtype=dtype, param_dtype=param_dtype, device=device)
        self.w3 = Linear(hidden, out_features, dtype=dtype, param_dtype=param_dtype, device=device)

    def forward(self, x):
        x1, x2 = self.w12(x).chunk(2, dim=-1)
        return self.w3(F.silu(x1) * x2)


class LayerScale(nn.Module):
    def __init__(self, dim, init_values=1e-5, dtype=torch.float32, device="cuda"):
        super().__init__()
        self.init_values = init_values
        self.gamma = nn.Parameter(torch.full((dim,), float(init_values), dtype=dtype, device=device))

    def forward(self, x):
        return x * self.gamma.to(x.dtype)


class PatchEmbed(nn.Module):
    """(B, H, W, 3) -> (B, N, C) via a patch-size conv (NCHW inside)."""

    def __init__(self, patch_size=14, embed_dim=768, dtype=torch.float32, param_dtype=None, device="cuda"):
        super().__init__()
        self.compute_dtype = dtype
        self.proj = nn.Conv2d(3, embed_dim, patch_size, stride=patch_size, dtype=param_dtype or dtype, device=device)

    def forward(self, x):
        dt, p = self.compute_dtype, self.proj
        y = F.conv2d(x.permute(0, 3, 1, 2).to(dt), p.weight.to(dt), p.bias.to(dt), p.stride)
        return y.flatten(2).transpose(1, 2)


def _rot_half(x):
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([-x2, x1], dim=-1)


def rope_2d(tokens: torch.Tensor, positions: torch.Tensor, base_frequency: float = 100.0):
    """2D rotary embedding on (B, H, N, D) given integer positions (B, N, 2):
    the head dim is split in half for (y, x), each half rotated 1D-RoPE style."""
    D = tokens.shape[-1]
    d = D // 2
    exponents = torch.arange(0, d, 2, dtype=torch.float32, device=tokens.device) / d
    inv_freq = 1.0 / (base_frequency ** exponents)

    def apply_axis(tok, pos_1d):
        ang = pos_1d[..., None].float() * inv_freq
        ang = torch.cat([ang, ang], dim=-1)
        cos = torch.cos(ang)[:, None].to(tok.dtype)
        sin = torch.sin(ang)[:, None].to(tok.dtype)
        return tok * cos + _rot_half(tok) * sin

    ty, tx = tokens.chunk(2, dim=-1)
    return torch.cat([apply_axis(ty, positions[..., 0]), apply_axis(tx, positions[..., 1])], dim=-1)


def rope_tables(positions: torch.Tensor, D: int, base_frequency: float = 100.0):
    """(cos, sin) tables (..., N, D) in fp32 for ``rope_2d``-identical rotation."""
    d = D // 2
    exponents = torch.arange(0, d, 2, dtype=torch.float32, device=positions.device) / d
    inv_freq = 1.0 / (base_frequency ** exponents)
    ang_y = positions[..., 0:1].float() * inv_freq
    ang_x = positions[..., 1:2].float() * inv_freq
    ang = torch.cat([ang_y, ang_y, ang_x, ang_x], dim=-1)
    return torch.cos(ang), torch.sin(ang)


def apply_rope_tables(tokens: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """Apply ``rope_tables`` to (B, H, N, D) tokens in the tokens' dtype."""
    shape = tokens.shape
    D = shape[-1]
    t = tokens.reshape(*shape[:-1], 2, 2, D // 4)
    rot = torch.stack([-t[..., 1, :], t[..., 0, :]], dim=-2).reshape(shape)
    return tokens * cos.to(tokens.dtype) + rot * sin.to(tokens.dtype)


class Attention(nn.Module):
    def __init__(self, dim, num_heads, qkv_bias=True, proj_bias=True, qk_norm=False, use_rope=False,
                 rope_freq=100.0, dtype=torch.float32, param_dtype=None, device="cuda"):
        super().__init__()
        self.num_heads = num_heads
        self.use_rope = use_rope
        self.rope_freq = rope_freq
        head_dim = dim // num_heads
        self.qkv = Linear(dim, 3 * dim, bias=qkv_bias, dtype=dtype, param_dtype=param_dtype, device=device)
        if qk_norm:
            self.q_norm = LayerNormFp32(head_dim, eps=1e-5, device=device)
            self.k_norm = LayerNormFp32(head_dim, eps=1e-5, device=device)
        else:
            self.q_norm = self.k_norm = None
        self.proj = Linear(dim, dim, bias=proj_bias, dtype=dtype, param_dtype=param_dtype, device=device)

    def forward(self, x, pos=None, kv_len=None, rope_tabs=None):
        B, N, C = x.shape
        H = self.num_heads
        D = C // H
        q, k, v = self.qkv(x).reshape(B, N, 3, H, D).permute(2, 0, 3, 1, 4).unbind(0)
        if self.q_norm is not None:
            q = self.q_norm(q)
            k = self.k_norm(k)
        if self.use_rope and rope_tabs is not None:
            cos, sin = rope_tabs
            q = apply_rope_tables(q, cos, sin)
            k = apply_rope_tables(k, cos, sin)
        elif self.use_rope and pos is not None:
            q = rope_2d(q, pos, self.rope_freq)
            k = rope_2d(k, pos, self.rope_freq)
        o = attention(q, k, v, kv_len=kv_len).transpose(1, 2).reshape(B, N, H * D)
        return self.proj(o)


class Block(nn.Module):
    """Pre-norm transformer block with LayerScale.

    ``remat_attn`` (the ViT's ``remat_policy="attn"``, the JAX package's
    ``nn.remat(Attention)``): while a graph is recorded the attention
    sub-path (qkv, QK-norm, RoPE, flash, proj) runs under
    ``torch.utils.checkpoint`` and is recomputed in the backward pass;
    ``norm1``, the FFN and the norms keep their activations."""

    def __init__(self, dim, num_heads, mlp_ratio=4.0, qkv_bias=True, proj_bias=True,
                 init_values: Optional[float] = 1.0, qk_norm=False, use_rope=False, rope_freq=100.0,
                 ffn_layer="mlp", ln_eps=1e-6, dtype=torch.float32, param_dtype=None, remat_attn: bool = False,
                 device="cuda"):
        super().__init__()
        pdt = param_dtype or dtype
        self.remat_attn = remat_attn
        self.norm1 = LayerNormFp32(dim, eps=ln_eps, device=device)
        self.attn = Attention(dim, num_heads, qkv_bias, proj_bias, qk_norm, use_rope, rope_freq,
                              dtype=dtype, param_dtype=pdt, device=device)
        ls = init_values is not None
        self.ls1 = LayerScale(dim, init_values, dtype=pdt, device=device) if ls else None
        self.norm2 = LayerNormFp32(dim, eps=ln_eps, device=device)
        ffn = SwiGLUFFNFused if ffn_layer == "swiglufused" else Mlp
        self.mlp = ffn(dim, int(dim * mlp_ratio), dtype=dtype, param_dtype=pdt, device=device)
        self.ls2 = LayerScale(dim, init_values, dtype=pdt, device=device) if ls else None

    def forward(self, x, pos=None, kv_len=None, rope_tabs=None):
        if self.remat_attn and torch.is_grad_enabled():
            h = checkpoint(self.attn, self.norm1(x), pos=pos, kv_len=kv_len, rope_tabs=rope_tabs, use_reentrant=False)
        else:
            h = self.attn(self.norm1(x), pos=pos, kv_len=kv_len, rope_tabs=rope_tabs)
        if self.ls1 is not None:
            h = self.ls1(h)
        x = x + h
        h2 = self.mlp(self.norm2(x))
        if self.ls2 is not None:
            h2 = self.ls2(h2)
        return x + h2



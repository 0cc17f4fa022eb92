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

Tensor parallelism: ``parallel/tp.py`` ``shard_params`` leaves ``Attention``,
``Mlp`` and ``SwiGLUFFNFused`` with their shard of the weights and a ``tp``
(the ``model`` group); each then runs on its local heads / hidden slice and
sums its output over the group once, before LayerScale and the residual.
``tp`` is None otherwise, and the forward is the one-process one.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from recondet3d_torch.ops.attention import flash_attention

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
    "set_attn_impl",
    "init_parameters_",
]


class LayerNormFp32(nn.LayerNorm):
    """LayerNorm computed in fp32 (autocast semantics), cast back to the input
    dtype. Its parameters stay fp32."""

    def forward(self, x, tp=None):
        w, b = self.weight, self.bias
        if tp is not None:  # shared by heads split over the model group: its gradient is the sum over the group
            w, b = tp.enter(w), tp.enter(b)
        return F.layer_norm(x.float(), self.normalized_shape, w, b, self.eps).to(x.dtype)


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
        self.tp = None  # parallel/tp.py ModelParallel once sharded

    def forward(self, x):
        if self.tp is None:
            return self.fc2(F.gelu(self.fc1(x)))
        return self.tp.exit(self.fc2, F.gelu(self.fc1(self.tp.enter(x))))


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
        self.tp = None  # parallel/tp.py ModelParallel once sharded

    def forward(self, x):
        if self.tp is None:
            x1, x2 = self.w12(x).chunk(2, dim=-1)
            return self.w3(F.silu(x1) * x2)
        x1, x2 = self.w12(self.tp.enter(x)).chunk(2, dim=-1)  # this rank's slice of each half
        return self.tp.exit(self.w3, F.silu(x1) * x2)


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
        self.attn_impl = "auto"  # switched only by set_attn_impl
        head_dim = dim // num_heads
        self.qkv = Linear(dim, 3 * dim, bias=qkv_bias, dtype=dtype, param_dtype=param_dtype, device=device)
        if qk_norm:
            self.q_norm = LayerNormFp32(head_dim, eps=1e-5, device=device)
            self.k_norm = LayerNormFp32(head_dim, eps=1e-5, device=device)
        else:
            self.q_norm = self.k_norm = None
        self.proj = Linear(dim, dim, bias=proj_bias, dtype=dtype, param_dtype=param_dtype, device=device)
        self.tp = None  # parallel/tp.py ModelParallel once sharded: this rank's heads only

    def forward(self, x, pos=None, kv_len=None, rope_tabs=None):
        B, N, C = x.shape
        D = C // self.num_heads
        tp = self.tp
        H = self.num_heads if tp is None else self.num_heads // tp.size
        if tp is not None:
            x = tp.enter(x)
        q, k, v = self.qkv(x).reshape(B, N, 3, H, D).permute(2, 0, 3, 1, 4).unbind(0)
        if self.q_norm is not None:
            q = self.q_norm(q, tp)
            k = self.k_norm(k, tp)
        if self.use_rope and rope_tabs is not None:
            cos, sin = rope_tabs
            q = apply_rope_tables(q, cos, sin)
            k = apply_rope_tables(k, cos, sin)
        elif self.use_rope and pos is not None:
            q = rope_2d(q, pos, self.rope_freq)
            k = rope_2d(k, pos, self.rope_freq)
        o = flash_attention(q, k, v, kv_len=kv_len, impl=self.attn_impl).transpose(1, 2).reshape(B, N, H * D)
        return self.proj(o) if tp is None else tp.exit(self.proj, o)


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


def set_attn_impl(model: nn.Module, impl: str) -> None:
    """Switch every attention layer of ``model`` to ``impl`` ('auto' | 'plain')."""
    for m in model.modules():
        if isinstance(m, Attention):
            m.attn_impl = impl


@torch.no_grad()
def init_parameters_(model: nn.Module, generator: torch.Generator) -> None:
    """Random init from ``generator`` following the JAX package's flax
    initializers: lecun-normal (std 1/sqrt(fan_in)) weights for every
    Linear/Conv/ConvTranspose, zero biases, unit LayerNorm, LayerScale at its
    init value; the ViT tokens are set by ``DinoViT.init_tokens_``. Numbers
    are drawn on the generator's device and copied to each parameter."""
    gdev = generator.device

    def normal_(p, std):
        p.copy_(torch.randn(p.shape, generator=generator, device=gdev, dtype=torch.float32) * std)

    for m in model.modules():
        if isinstance(m, (nn.Linear, nn.Conv2d, nn.ConvTranspose2d)):
            w = m.weight
            if isinstance(m, nn.ConvTranspose2d):
                # the JAX package stores these kernels in the torch layout (I, O, k, k), and flax's lecun-normal
                # reads that array as HWIO: fan_in = k * I * O
                fan_in = w.shape[0] * w.shape[1] * w.shape[2]
            else:
                fan_in = w[0].numel()
            normal_(w, fan_in ** -0.5)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.LayerNorm):
            if m.weight is not None:
                m.weight.fill_(1.0)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, LayerScale):
            m.gamma.fill_(m.init_values)
        if hasattr(m, "init_tokens_"):
            m.init_tokens_(normal_)

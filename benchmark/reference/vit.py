"""DINOv2 ViT with alternating per-view / cross-view attention (port of
``recondet3d/models/da3/vit.py``): camera token at slot 0 from
``alt_start``, QK-norm from ``qknorm_start``, 2D RoPE from ``rope_start``,
reference-view reorder for S >= 3 views and ``cat_token`` outputs.

Local attention batches views ((B*S, N, C)); global attention concatenates
them into one sequence ((B, S*N, C)); both are one flash-attention call.

``remat=True`` recomputes activations in the backward pass instead of
keeping them, while a graph is recorded, by the JAX package's four
``remat_policy`` names:

- ``block`` (default): every block under ``torch.utils.checkpoint``, so a
  fine-tuning step holds one block's activations at a time;
- ``global``: only the global-attention blocks (``i >= alt_start``, odd
  ``i``); the local blocks keep their activations and are not recomputed;
- ``attn``: in every block only the attention sub-path (``Block.remat_attn``);
- ``dots``: every block under selective checkpointing that keeps the outputs
  of the products without batch dims (``aten.mm`` / ``aten.addmm``: the
  qkv, proj and FFN projections) and recomputes everything else, the JAX
  package's ``dots_with_no_batch_dims_saveable``. The flash kernels are
  launched through ctypes, invisible to that policy, so their forward runs
  again on recompute, as the Pallas call does under the JAX policy; its
  outputs are new tensors each time.

Every policy runs each checkpointed block's forward twice and its backward
once; none changes the arithmetic. ``param_dtype`` stores the trunk's
parameters wider than it computes (fp32 master parameters for training, see
``layers.py``).
"""

from __future__ import annotations

import functools
import math
from typing import List, Sequence, Tuple

import torch
import torch.nn as nn
from torch.utils.checkpoint import CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts

from benchmark.reference.layers import Block, LayerNormFp32, PatchEmbed, rope_tables
from benchmark.reference.constants import THRESH_FOR_REF_SELECTION
from benchmark.reference.interpolation import interpolate_nchw

__all__ = [
    "DinoViT",
    "VIT_PRESETS",
    "REMAT_POLICIES",
    "check_remat_policy",
    "saddle_balanced_scores",
    "select_reference_view",
    "reorder_by_reference",
    "restore_original_order",
]

VIT_PRESETS = {
    "vits": dict(embed_dim=384, depth=12, num_heads=6),
    "vitb": dict(embed_dim=768, depth=12, num_heads=12),
    "vitl": dict(embed_dim=1024, depth=24, num_heads=16),
    "vitg": dict(embed_dim=1536, depth=40, num_heads=24),
}


REMAT_POLICIES = ("block", "global", "attn", "dots")

_SAVED_PRODUCTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)  # what F.linear reaches


def _dots_policy(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in _SAVED_PRODUCTS else CheckpointPolicy.PREFER_RECOMPUTE


def check_remat_policy(policy: str) -> str:
    """``policy`` if it is one of ``REMAT_POLICIES``; ValueError otherwise
    (the JAX package takes a name it does not know as ``block``)."""
    if policy not in REMAT_POLICIES:
        raise ValueError(f"unknown remat_policy {policy!r}; one of {', '.join(REMAT_POLICIES)}")
    return policy


def _normalize_metric(m, dim=1, eps=1e-8):
    mn = m.amin(dim=dim, keepdim=True)
    mx = m.amax(dim=dim, keepdim=True)
    return (m - mn) / (mx - mn + eps)


def saddle_balanced_scores(x: torch.Tensor) -> torch.Tensor:
    """(B, S) scores of ``saddle_balanced`` from the class tokens of x
    (B, S, N, C); the least is the reference view."""
    S = x.shape[1]
    cls = x[:, :, 0].float()
    feat = cls / torch.linalg.norm(cls, dim=-1, keepdim=True)
    eye = torch.eye(S, device=x.device)[None]
    sim = torch.einsum("bsc,btc->bst", feat, feat)
    sim_score = torch.sum(sim - eye, dim=-1) / (S - 1)
    feat_norm = torch.linalg.norm(cls, dim=-1)
    feat_var = torch.var(feat, dim=-1, unbiased=False)
    return (torch.abs(_normalize_metric(sim_score) - 0.5) + torch.abs(_normalize_metric(feat_norm) - 0.5)
            + torch.abs(_normalize_metric(feat_var) - 0.5))


def select_reference_view(x: torch.Tensor, strategy: str = "saddle_balanced") -> torch.Tensor:
    """Pick a reference view per batch from class tokens. x: (B, S, N, C) ->
    (B,) int64."""
    B, S = x.shape[:2]
    if S <= 1 or strategy == "first":
        return torch.zeros((B,), dtype=torch.long, device=x.device)
    if strategy == "middle":
        return torch.full((B,), S // 2, dtype=torch.long, device=x.device)

    if strategy == "saddle_balanced":
        return torch.argmin(saddle_balanced_scores(x), dim=1)

    cls = x[:, :, 0].float()
    feat = cls / torch.linalg.norm(cls, dim=-1, keepdim=True)
    eye = torch.eye(S, device=x.device)[None]
    if strategy == "saddle_sim_range":
        sim = torch.einsum("bsc,btc->bst", feat, feat) - eye
        rng = sim.amax(dim=-1) - sim.amin(dim=-1)
        return torch.argmax(rng, dim=1)

    raise ValueError(f"unknown ref view strategy {strategy!r}")


def _reorder_indices(b_idx: torch.Tensor, S: int) -> torch.Tensor:
    """(B, S) gather indices placing view b_idx first, the others in order."""
    pos = torch.arange(S, device=b_idx.device)[None].expand(b_idx.shape[0], S)
    idx = torch.where((pos > 0) & (pos <= b_idx[:, None]), pos - 1, pos)
    idx = idx.clone()
    idx[:, 0] = b_idx
    return idx


def _restore_indices(b_idx: torch.Tensor, S: int) -> torch.Tensor:
    pos = torch.arange(S, device=b_idx.device)[None].expand(b_idx.shape[0], S)
    idx = torch.where(pos < b_idx[:, None], pos + 1, pos)
    return torch.where(pos == b_idx[:, None], torch.zeros_like(idx), idx)


def _gather_views(x, idx):
    return x[torch.arange(x.shape[0], device=x.device)[:, None], idx]


def reorder_by_reference(x, b_idx):
    return _gather_views(x, _reorder_indices(b_idx, x.shape[1]))


def restore_original_order(x, b_idx):
    return _gather_views(x, _restore_indices(b_idx, x.shape[1]))


def _clear_pe_cache(module, _keys):
    module._pe_cache.clear()


class DinoViT(nn.Module):
    """Multi-view DINOv2 trunk returning features at ``out_layers``."""

    def __init__(self, name_preset="vits", out_layers: Sequence[int] = (5, 7, 9, 11), alt_start=-1,
                 qknorm_start=-1, rope_start=-1, rope_freq=100.0, cat_token=True, patch_size=14,
                 img_size=518, num_register_tokens=0, interpolate_offset=0.1, dtype=torch.float32,
                 param_dtype=None, remat: bool = False, remat_policy: str = "block", device="cuda"):
        super().__init__()
        pdt = param_dtype or dtype
        self.remat = remat
        self.remat_policy = check_remat_policy(remat_policy)
        p = VIT_PRESETS[name_preset]
        self.embed_dim = C = p["embed_dim"]
        self.depth = p["depth"]
        self.num_heads = p["num_heads"]
        self.out_layers = tuple(out_layers)
        self.alt_start = alt_start
        self.rope_start = rope_start
        self.rope_freq = rope_freq
        self.cat_token = cat_token
        self.patch_size = patch_size
        self.num_register_tokens = num_register_tokens
        self.interpolate_offset = interpolate_offset
        self.dtype = dtype
        ffn = "swiglufused" if name_preset == "vitg" else "mlp"

        self.patch_embed = PatchEmbed(patch_size, C, dtype=dtype, param_dtype=pdt, device=device)
        num_patches = (img_size // patch_size) ** 2
        self.cls_token = nn.Parameter(torch.zeros(1, 1, C, dtype=pdt, device=device))
        self.camera_token = (
            nn.Parameter(torch.zeros(1, 2, C, dtype=pdt, device=device)) if alt_start != -1 else None
        )
        # fp32: the bicubic resize runs in the storage dtype, as in the JAX package
        self.pos_embed = nn.Parameter(torch.zeros(1, num_patches + 1, C, device=device))
        self._pe_cache = {}
        self.blocks = nn.ModuleList(
            Block(
                C, self.num_heads, mlp_ratio=4.0, init_values=1.0,
                qk_norm=(qknorm_start != -1 and i >= qknorm_start),
                use_rope=(rope_start != -1 and i >= rope_start),
                rope_freq=rope_freq, ffn_layer=ffn, ln_eps=1e-6, dtype=dtype, param_dtype=pdt,
                remat_attn=remat and remat_policy == "attn", device=device,
            )
            for i in range(self.depth)
        )
        self.norm = LayerNormFp32(C, eps=1e-5, device=device)
        # whatever replaces the parameter's storage drops the resized copy kept by _interp_pos_embed
        self.register_load_state_dict_post_hook(_clear_pe_cache)

    def _apply(self, fn, *args, **kwargs):
        self._pe_cache.clear()
        return super()._apply(fn, *args, **kwargs)

    def init_tokens_(self, normal_):
        """JAX initializers: cls/pos zeros, camera token N(0, 1)."""
        self.cls_token.zero_()
        self.pos_embed.zero_()
        if self.camera_token is not None:
            normal_(self.camera_token, 1.0)

    def _interp_pos_embed(self, n_tokens: int, height: int, width: int) -> torch.Tensor:
        """Bicubic pos-embed resize with torch's scale-factor kludge.

        Without autograd the result is kept per grid size until the
        parameter changes: torch's bicubic kernel runs one thread per output
        pixel over all channels, slow at ViT-g width (PERF.md, Findings).
        The key holds the parameter's storage and version, so an optimizer
        step (in place) makes a new entry; ``load_state_dict`` and
        ``.to()`` / ``_apply`` clear the cache. With autograd on (a training
        step) nothing is kept and the resize is part of the graph."""
        N = self.pos_embed.shape[1] - 1
        if n_tokens - 1 == N and width == height:
            return self.pos_embed
        gh, gw = height // self.patch_size, width // self.patch_size
        key = (gh, gw, self.pos_embed.device, self.pos_embed.data_ptr(), self.pos_embed._version)
        if not torch.is_grad_enabled() and key in self._pe_cache:
            return self._pe_cache[key]
        M = int(math.sqrt(N))
        cls_pe = self.pos_embed[:, :1]
        patch_pe = self.pos_embed[:, 1:].reshape(1, M, M, self.embed_dim).permute(0, 3, 1, 2)
        scale = None
        if self.interpolate_offset:
            scale = ((gh + self.interpolate_offset) / M, (gw + self.interpolate_offset) / M)
        patch_pe = interpolate_nchw(patch_pe, (gh, gw), mode="bicubic", scale=scale)
        patch_pe = patch_pe.permute(0, 2, 3, 1).reshape(1, gh * gw, self.embed_dim)
        pe = torch.cat([cls_pe, patch_pe], dim=1)
        if not torch.is_grad_enabled():
            self._pe_cache = {key: pe}
        return pe

    def _checkpointed(self, is_global: bool) -> bool:
        """Whether a block runs under a block-level checkpoint ('attn' checkpoints inside the block)."""
        if not self.remat or self.remat_policy == "attn":
            return False
        return is_global or self.remat_policy != "global"

    def forward(self, x, cam_token=None, export_feat_layers: Sequence[int] = (),
                ref_view_strategy: str = "saddle_balanced"):
        """x: (B, S, H, W, 3). Returns (feats, aux_feats):
        feats = list over out_layers of (patch_tokens (B,S,Np,C'), camera_token (B,S,C'));
        aux_feats = normed patch tokens for export_feat_layers (in the
        reference-view order, as the JAX package returns them)."""
        B, S, H, W, _ = x.shape
        C = self.embed_dim
        ph, pw = H // self.patch_size, W // self.patch_size
        n_tok = ph * pw + 1
        dt = self.dtype

        tokens = self.patch_embed(x.reshape(B * S, H, W, 3))
        cls = self.cls_token.to(dt).expand(B * S, 1, C)
        tokens = torch.cat([cls, tokens], dim=1)
        tokens = tokens + self._interp_pos_embed(n_tok, H, W).to(dt)
        xt = tokens.reshape(B, S, n_tok, C)

        # RoPE positions: patches (y, x) + 1, special token (0, 0); global
        # attention uses all-ones patch positions. One table pair per grid,
        # shared by every rope block.
        use_rope = self.rope_start != -1
        l_tabs = g_tabs = None
        if use_rope:
            dev = x.device
            yy, xx = torch.meshgrid(torch.arange(ph, device=dev), torch.arange(pw, device=dev), indexing="ij")
            patch_pos = torch.stack([yy.reshape(-1), xx.reshape(-1)], dim=-1)
            special = torch.zeros((1, 2), dtype=patch_pos.dtype, device=dev)
            l_pos = torch.cat([special, patch_pos + 1], dim=0)
            g_pos = torch.cat([special, torch.ones_like(patch_pos)], dim=0)
            D = C // self.num_heads
            l_tabs = tuple(t[None, None].to(dt) for t in rope_tables(l_pos, D, self.rope_freq))
            g_tabs = tuple(
                t.repeat(S, 1).reshape(1, 1, S * n_tok, D).to(dt) for t in rope_tables(g_pos, D, self.rope_freq)
            )

        alt = self.alt_start
        do_reorder = alt != -1 and S >= THRESH_FOR_REF_SELECTION
        b_idx = None
        local_x = xt
        outputs: List[Tuple[torch.Tensor, torch.Tensor]] = []
        aux_outputs: List[torch.Tensor] = []

        for i, blk in enumerate(self.blocks):
            if do_reorder and i == alt - 1:
                b_idx = select_reference_view(xt, strategy=ref_view_strategy)
                xt = reorder_by_reference(xt, b_idx)
                local_x = reorder_by_reference(local_x, b_idx)

            if alt != -1 and i == alt:
                if cam_token is not None:
                    ct = cam_token.to(dt)
                else:
                    ref = self.camera_token[:, :1].expand(B, 1, C)
                    src = self.camera_token[:, 1:].expand(B, S - 1, C)
                    ct = torch.cat([ref, src], dim=1).to(dt)
                xt = torch.cat([ct[:, :, None], xt[:, :, 1:]], dim=2)

            rope_on = use_rope and i >= self.rope_start
            is_global = alt != -1 and i >= alt and i % 2 == 1
            tokens_in = xt.reshape(B, S * n_tok, C) if is_global else xt.reshape(B * S, n_tok, C)
            tabs = (g_tabs if is_global else l_tabs) if rope_on else None
            if self._checkpointed(is_global) and torch.is_grad_enabled():
                ctx = {} if self.remat_policy != "dots" else dict(
                    context_fn=functools.partial(create_selective_checkpoint_contexts, _dots_policy))
                xt = checkpoint(blk, tokens_in, rope_tabs=tabs, use_reentrant=False, **ctx).reshape(B, S, n_tok, C)
            else:
                xt = blk(tokens_in, rope_tabs=tabs).reshape(B, S, n_tok, C)
            if not is_global:
                local_x = xt

            if i in self.out_layers:
                out_x = torch.cat([local_x, xt], dim=-1) if self.cat_token else xt
                if do_reorder and b_idx is not None:
                    out_x = restore_original_order(out_x, b_idx)
                outputs.append((out_x[:, :, 0], out_x))
            if i in export_feat_layers:
                aux_outputs.append(xt)

        # final norm: on cat_token outputs only the current-feature half is normed
        start = 1 + self.num_register_tokens
        feats = []
        for cam_tok, out_x in outputs:
            if out_x.shape[-1] == C:
                normed = self.norm(out_x)
            else:
                normed = torch.cat([out_x[..., :C], self.norm(out_x[..., C:])], dim=-1)
            feats.append((normed[..., start:, :], cam_tok))
        aux = [self.norm(a)[..., start:, :] for a in aux_outputs]
        return feats, aux

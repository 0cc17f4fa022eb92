"""Sparse 3D convolution on fixed-capacity active sets (port of
``recondet3d/ops/sparse_conv.py``).

Active voxels live in fixed-capacity buffers: features (N, C) and coords
(N, 4) [b, z, y, x], invalid rows marked by coords < 0. A convolution is
one (rows, K) row gather plus one ``torch.matmul`` (the JAX package too
computes it outside any hand-written kernel).

The contracts are those of the JAX functions: a neighbour-map entry is the
row of the neighbour or N; a strided conv ranks its output cells by
ascending (b, y, x, z) id and keeps the lowest ``max_out`` of the batch.
The lookups are one sort plus ``torch.searchsorted`` over linear cell ids;
no table over the dense grid is built, and nothing is read back from the
device.

Gradients follow the JAX package's custom VJP (``_conv_core``, ``:361-404``):
the backward of the row gather is itself a gather through ``bwd_map``
(entry (n, k) = the output row that reads input row n at tap k), not
autograd's scatter-add of M * K rows with atomics, so gradients are the
same from run to run; the weight gradient is one fp32 product over the
re-gathered rows. A submanifold map is symmetric, so its ``bwd_map`` is
the map itself with the taps mirrored (a flip of the weights).

``subm_conv_apply(form="pair")`` gathers only the negative half of the taps
and the center and delivers each pair's mirror contribution with one
index-add; its backward (``_PairConvCore``) is the same pair form with the
flipped, transposed kernel for the features and two half gathers for the
weights, as in the JAX package's custom VJP. ``gathered_conv_apply`` is the
gather form for any (M, K) map, differentiated by autograd.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

__all__ = [
    "SparseTensor",
    "sort_by_column",
    "build_neighbor_map",
    "subm_conv_apply",
    "gathered_conv_apply",
    "sparse_conv_downsample",
    "sparse_tensor_from_voxels",
    "to_dense_bev",
]


class SparseTensor(NamedTuple):
    """Fixed-capacity sparse voxel tensor."""

    features: torch.Tensor  # (N, C)
    coords: torch.Tensor  # (N, 4) int32 [b, z, y, x]; -1 rows = padding
    grid: Tuple[int, int, int]  # (Z, Y, X)
    batch_size: int

    @property
    def valid(self) -> torch.Tensor:
        return self.coords[:, 0] >= 0


def _triple(v) -> Tuple[int, int, int]:
    if isinstance(v, (tuple, list)):
        return tuple(int(x) for x in v)
    return (int(v),) * 3


def _kernel_offsets(kernel) -> np.ndarray:
    kz, ky, kx = kernel
    return np.stack(np.meshgrid(np.arange(kz), np.arange(ky), np.arange(kx), indexing="ij"), axis=-1).reshape(-1, 3)


def _column_ids(b, z, y, x, grid) -> torch.Tensor:
    """Column-major linear id ((b*Y + y)*X + x)*Z + z (int64): sorting by it
    groups each vertical (b, y, x) column with z ascending."""
    Z, Y, X = grid
    return ((b * Y + y) * X + x) * Z + z


def sort_by_column(st: SparseTensor) -> SparseTensor:
    """Permute the active set into (b, y, x, z) order, invalid rows last."""
    c = st.coords.long()
    sentinel = st.batch_size * st.grid[0] * st.grid[1] * st.grid[2]
    ids = torch.where(st.valid, _column_ids(c[:, 0], c[:, 1], c[:, 2], c[:, 3], st.grid),
                      torch.full_like(c[:, 0], sentinel))
    order = torch.sort(ids, stable=True).indices
    return SparseTensor(st.features[order], st.coords[order], st.grid, st.batch_size)


def build_neighbor_map(st: SparseTensor, kernel=3) -> torch.Tensor:
    """(N, K) int64 gather rows for a submanifold conv: entry (n, k) is the
    row of the active voxel at offset (k - pad) from voxel n, or N when it
    is absent or n is padding. Tap order k = (iz * ky + iy) * kx + ix. Any
    row order of the active set will do."""
    kernel = _triple(kernel)
    Z, Y, X = st.grid
    N = st.coords.shape[0]
    dev = st.coords.device
    offsets = _kernel_offsets(kernel)
    if offsets.shape[0] % 2 != 1:
        raise ValueError("build_neighbor_map expects odd kernels")
    pad = (np.asarray(kernel) - 1) // 2
    c = st.coords.long()
    valid = st.valid
    sentinel = st.batch_size * Z * Y * X

    ids = torch.where(valid, _column_ids(c[:, 0], c[:, 1], c[:, 2], c[:, 3], st.grid),
                      torch.full_like(c[:, 0], sentinel))
    sids, srow = torch.sort(ids)

    offs = torch.from_numpy(offsets - pad).to(dev)  # (K, 3) zyx
    nz = c[:, None, 1] + offs[None, :, 0]
    ny = c[:, None, 2] + offs[None, :, 1]
    nx = c[:, None, 3] + offs[None, :, 2]
    ok = valid[:, None] & (nz >= 0) & (nz < Z) & (ny >= 0) & (ny < Y) & (nx >= 0) & (nx < X)
    q = torch.where(ok, _column_ids(c[:, None, 0], nz, ny, nx, st.grid), torch.full_like(nz, sentinel))
    pos = torch.searchsorted(sids, q.reshape(-1)).clamp(max=N - 1).reshape(q.shape)
    hit = ok & (sids[pos] == q)
    return torch.where(hit, srow[pos], torch.full_like(pos, N))


def _linear_ids(coords: torch.Tensor, grid, batch_size: int) -> torch.Tensor:
    """[b, z, y, x] -> int64 id ((b*Z + z)*Y + y)*X + x; invalid rows ->
    the sentinel batch_size * Z * Y * X."""
    Z, Y, X = grid
    c = coords.long()
    ids = ((c[:, 0] * Z + c[:, 1]) * Y + c[:, 2]) * X + c[:, 3]
    return torch.where(c[:, 0] >= 0, ids, torch.full_like(ids, batch_size * Z * Y * X))


def _lookup_rows(active_ids: torch.Tensor, query_ids: torch.Tensor, sentinel: int) -> torch.Tensor:
    """For each query id the row of the matching active id, or N if absent
    or the sentinel: one sort of the active ids and ``torch.searchsorted``
    (the rows of the JAX package's dense table and merged-sort lookups)."""
    N = active_ids.shape[0]
    sids, srow = torch.sort(active_ids)
    pos = torch.searchsorted(sids, query_ids).clamp(max=max(N - 1, 0))
    hit = (sids[pos] == query_ids) & (query_ids != sentinel) if N else torch.zeros_like(query_ids, dtype=torch.bool)
    return torch.where(hit, srow[pos], torch.full_like(query_ids, N))


def _gather_matmul(features: torch.Tensor, gather_map: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """out[m] = sum_k features[map(m, k)] @ W[k]; map entries == N (a zero
    row) mark missing neighbours. Weights are cast to the features' dtype."""
    N, Cin = features.shape
    M, K = gather_map.shape
    padded = torch.cat([features, features.new_zeros((1, Cin))], dim=0)
    gathered = padded[gather_map].reshape(M, K * Cin)
    return gathered @ weight.to(features.dtype).reshape(K * Cin, -1)


class _ConvCore(torch.autograd.Function):
    """``_gather_matmul`` with a gather-form backward (see the module docstring)."""

    @staticmethod
    def forward(ctx, features, gather_map, bwd_map, weight, flip_bwd: bool):
        ctx.save_for_backward(features, gather_map, bwd_map, weight)
        ctx.flip_bwd = flip_bwd
        return _gather_matmul(features, gather_map, weight)

    @staticmethod
    def backward(ctx, g):
        features, gather_map, bwd_map, weight = ctx.saved_tensors
        df = dw = None
        if ctx.needs_input_grad[0]:
            wb = weight.flip(0) if ctx.flip_bwd else weight
            df = _gather_matmul(g.to(features.dtype), bwd_map, wb.transpose(1, 2))
        if ctx.needs_input_grad[3]:
            M, K = gather_map.shape
            padded = torch.cat([features, features.new_zeros((1, features.shape[1]))], dim=0)
            gathered = padded[gather_map].reshape(M, -1).float()
            dw = (gathered.t() @ g.float()).reshape(weight.shape).to(weight.dtype)
        return df, None, None, dw, None


def _pair_matmul(features: torch.Tensor, half_map: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """Exact submanifold conv from the half map (the negative taps and the
    center, ``nbr_map[:, :K//2 + 1]``): the gathered half through
    W[0..K//2], plus, for each found pair (n, k < K//2) with m =
    half_map[n, k], F[n] @ W[K-1-k] added into row m."""
    N, Cin = features.shape
    Hc = half_map.shape[1]
    H = Hc - 1
    Cout = weight.shape[-1]
    w = weight.to(features.dtype)
    padded = torch.cat([features, features.new_zeros((1, Cin))], dim=0)
    out = padded[half_map].reshape(N, Hc * Cin) @ w[:Hc].reshape(Hc * Cin, Cout)
    w_rev = w[Hc:].flip(0)  # w_rev[k] = W[K-1-k], k < H
    t = (features @ w_rev.permute(1, 0, 2).reshape(Cin, H * Cout)).reshape(N * H, Cout)
    mirror = out.new_zeros((N + 1, Cout)).index_add_(0, half_map[:, :H].reshape(-1), t)  # row N: missing pairs
    return out + mirror[:N]


class _PairConvCore(torch.autograd.Function):
    """``_pair_matmul`` with the JAX package's pair-form backward: dF is the
    pair form of the flipped, transposed kernel; dW comes from the two half
    gathers (the negative taps and the center from F at the map's rows, the
    mirror taps from g at the map's rows)."""

    @staticmethod
    def forward(ctx, features, half_map, weight):
        ctx.save_for_backward(features, half_map, weight)
        return _pair_matmul(features, half_map, weight)

    @staticmethod
    def backward(ctx, g):
        features, half_map, weight = ctx.saved_tensors
        H = half_map.shape[1] - 1
        df = dw = None
        if ctx.needs_input_grad[0]:
            df = _pair_matmul(g.to(features.dtype), half_map, weight.flip(0).transpose(1, 2))
        if ctx.needs_input_grad[2]:
            Cin = features.shape[1]
            gath_f = torch.cat([features, features.new_zeros((1, Cin))])[half_map].float()  # (N, Hc, Cin)
            gath_g = torch.cat([g, g.new_zeros((1, g.shape[1]))])[half_map[:, :H]].float()  # (N, H, Cout)
            g32 = g.float()
            dw_neg = torch.einsum("nhc,nd->hcd", gath_f, g32)
            dw_pos = torch.einsum("nc,nhd->hcd", features.float(), gath_g)
            dw = torch.cat([dw_neg, dw_pos.flip(0)]).to(weight.dtype)
        return df, None, dw


def subm_conv_apply(features: torch.Tensor, nbr_map: torch.Tensor, weight: torch.Tensor,
                    bias: Optional[torch.Tensor] = None, *, form: str = "full") -> torch.Tensor:
    """Apply a (K, Cin, Cout) kernel on a submanifold neighbour map:
    features (N, Cin), nbr_map (N, K) -> (N, Cout). ``form="full"``: one
    (N, K) gather and one product; ``form="pair"``: the half gather and the
    mirror index-add (the same result up to the order of fp32 sums)."""
    if nbr_map.shape[0] != features.shape[0]:
        raise ValueError("subm conv requires square maps")
    if form == "pair":
        out = _PairConvCore.apply(features, nbr_map[:, : nbr_map.shape[1] // 2 + 1], weight)
    elif form == "full":
        out = _ConvCore.apply(features, nbr_map, nbr_map, weight, True)
    else:
        raise ValueError(f"unknown subm conv form {form!r}")
    if bias is not None:
        out = out + bias.to(features.dtype)
    return out


def gathered_conv_apply(features: torch.Tensor, gather_map: torch.Tensor, weight: torch.Tensor,
                        bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Gather-form conv for any (M, K) map (entries == N missing):
    out[m] = sum_k features[map(m, k)] @ W[k]."""
    out = _gather_matmul(features, gather_map, weight)
    if bias is not None:
        out = out + bias.to(features.dtype)
    return out


def _out_grid(grid, kernel, stride, padding) -> Tuple[int, int, int]:
    return tuple((g + 2 * p - k) // s + 1 for g, k, s, p in zip(grid, kernel, stride, padding))


def _downsample_gather_map(coords, *, grid, batch_size, kernel, stride, padding, max_out, with_bwd=True):
    """Output coords (max_out, 4), (max_out, K) gather rows: entry (m, k)
    is the input row whose voxel sits at tap k of output voxel m, or N; and
    (``with_bwd``; else None) the (N, K) backward rows: entry (n, k) is the
    output row that reads input row n at tap k, or max_out.

    Each input voxel lists its <= prod((k-1)//s + 1) candidate output
    cells; one sort of their column-major ids dedups and ranks them."""
    oZ, oY, oX = out_grid = _out_grid(grid, kernel, stride, padding)
    N = coords.shape[0]
    dev = coords.device
    K = int(np.prod(kernel))
    D = [(k - 1) // s + 1 for k, s in zip(kernel, stride)]
    js = torch.from_numpy(np.stack(np.meshgrid(*[np.arange(d) for d in D], indexing="ij"), -1).reshape(-1, 3)).to(dev)
    KC = js.shape[0]
    s = torch.tensor(stride, device=dev)
    p = torch.tensor(padding, device=dev)
    kk = torch.tensor(kernel, device=dev)
    out_dims = torch.tensor(out_grid, device=dev)

    c = coords.long()
    izyx = c[:, 1:4]
    base = torch.div(izyx + p, s, rounding_mode="floor")
    o_zyx = base[:, None, :] - js[None]  # (N, KC, 3)
    tap = izyx[:, None, :] + p - o_zyx * s
    ok = ((tap >= 0) & (tap < kk) & (o_zyx >= 0) & (o_zyx < out_dims)).all(dim=-1)
    ok &= (c[:, 0] >= 0)[:, None]
    sentinel = batch_size * oZ * oY * oX
    out_cell = _column_ids(c[:, None, 0], o_zyx[..., 0], o_zyx[..., 1], o_zyx[..., 2], out_grid)
    flat = torch.where(ok, out_cell, torch.full_like(out_cell, sentinel)).reshape(-1)  # (N * KC,)

    sids, sort_ix = torch.sort(flat)
    is_first = torch.ones_like(sids, dtype=torch.bool)
    is_first[1:] = sids[1:] != sids[:-1]
    svalid = sids != sentinel
    rank = torch.cumsum((is_first & svalid).long(), dim=0) - 1
    svalid &= rank < max_out
    rank = torch.where(svalid, rank, torch.full_like(rank, max_out)).clamp(max=max_out)
    uniq = torch.full((max_out + 1,), sentinel, dtype=torch.long, device=dev)
    uniq[torch.where(is_first & svalid, rank, torch.full_like(rank, max_out))] = sids
    uniq = uniq[:max_out]
    m = torch.empty_like(rank)
    m[sort_ix] = rank  # (N * KC,) output row of each candidate, max_out = none

    out_valid = uniq != sentinel
    ob = uniq // (oZ * oY * oX)
    rem = uniq % (oZ * oY * oX)
    oy = rem // (oX * oZ)
    ox = (rem % (oX * oZ)) // oZ
    oz = rem % oZ
    out_coords = torch.stack([ob, oz, oy, ox], dim=-1)
    out_coords = torch.where(out_valid[:, None], out_coords, torch.full_like(out_coords, -1)).to(torch.int32)

    # transpose-scatter: candidate (n, j) that landed in output row m fills
    # gather slot (m, tap); at most one input cell exists per (m, tap)
    tap_lin = (tap[..., 0] * kernel[1] + tap[..., 1]) * kernel[2] + tap[..., 2]
    mm = m.reshape(N, KC)
    slot = torch.where(mm < max_out, mm * K + tap_lin, torch.full_like(mm, max_out * K))
    rows = torch.full((max_out * K + 1,), N, dtype=torch.long, device=dev)
    rows[slot.reshape(-1)] = torch.arange(N, device=dev)[:, None].expand(N, KC).reshape(-1)
    if not with_bwd:
        return out_coords, rows[: max_out * K].reshape(max_out, K), None, out_grid
    # the same pairs seen from the input row: (n, tap) -> m
    bslot = torch.where(mm < max_out, torch.arange(N, device=dev)[:, None] * K + tap_lin, torch.full_like(mm, N * K))
    brows = torch.full((N * K + 1,), max_out, dtype=torch.long, device=dev)
    brows[bslot.reshape(-1)] = mm.reshape(-1)
    return out_coords, rows[: max_out * K].reshape(max_out, K), brows[: N * K].reshape(N, K), out_grid


def sparse_conv_downsample(st: SparseTensor, weight: torch.Tensor, bias: Optional[torch.Tensor] = None, *,
                           kernel=3, stride=2, padding=1, max_out: int) -> SparseTensor:
    """Strided sparse conv producing a new (smaller) active set of
    ``max_out`` rows, sorted by (b, y, x, z), invalid rows last."""
    kernel, stride, padding = _triple(kernel), _triple(stride), _triple(padding)
    needs_grad = torch.is_grad_enabled() and (st.features.requires_grad or weight.requires_grad)
    with torch.no_grad():
        out_coords, gather_rows, bwd_rows, out_grid = _downsample_gather_map(
            st.coords, grid=st.grid, batch_size=st.batch_size, kernel=kernel, stride=stride, padding=padding,
            max_out=int(max_out), with_bwd=needs_grad)
    if needs_grad:
        out = _ConvCore.apply(st.features, gather_rows, bwd_rows, weight, False)
    else:
        out = _gather_matmul(st.features, gather_rows, weight)
    if bias is not None:
        out = out + bias.to(out.dtype)
    out = torch.where((out_coords[:, 0] >= 0)[:, None], out, torch.zeros_like(out))
    return SparseTensor(out, out_coords, out_grid, st.batch_size)


def sparse_tensor_from_voxels(voxel_features: torch.Tensor, coors: torch.Tensor, grid_zyx, batch_size: int):
    """Build from (N, C) features + (N, 4) [b, z, y, x] coords."""
    Z, Y, X = grid_zyx
    return SparseTensor(voxel_features, coors.to(torch.int32), (int(Z), int(Y), int(X)), int(batch_size))


def to_dense_bev(st: SparseTensor) -> torch.Tensor:
    """Densify and fold depth into channels: (B, Y, X, C*Z) channels-last,
    channel index c*Z + z."""
    Z, Y, X = st.grid
    N, C = st.features.shape
    B = st.batch_size
    c = st.coords.long()
    valid = st.valid
    feats = torch.where(valid[:, None], st.features, torch.zeros_like(st.features))
    dense = st.features.new_zeros((B + 1, Y, X, Z, C))  # plane B takes the invalid rows
    b = torch.where(valid, c[:, 0], torch.full_like(c[:, 0], B))
    zz, yy, xx = (torch.where(valid, c[:, i], torch.zeros_like(c[:, i])) for i in (1, 2, 3))
    dense[b, yy, xx, zz] = feats
    return dense[:B].transpose(-1, -2).reshape(B, Y, X, C * Z)

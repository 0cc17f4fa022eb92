"""Real spherical harmonics: evaluation and rotation (port of
``recondet3d/utils/sh.py``).

Rotation matrices for each degree come by projection: real SH of degree l
span a (2l+1)-dim rotation-invariant space, so the basis evaluated at a
fixed set of directions and at their rotated images gives the linear map
D(R) through a precomputed pseudo-inverse. The directions are the JAX
package's, drawn from ``np.random.default_rng(1234)``, and the basis at
them is evaluated in fp32 as there, so both packages use the same
pseudo-inverses. Basis: the 3DGS ("graphdeco") real-SH convention, the one
the splat renderer uses.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

__all__ = ["eval_sh_basis", "rotate_sh", "SH_C0"]

SH_C0 = 0.28209479177387814
_C1 = 0.4886025119029199
_C2 = (
    1.0925484305920792,
    -1.0925484305920792,
    0.31539156525252005,
    -1.0925484305920792,
    0.5462742152960396,
)
_C3 = (
    -0.5900435899266435,
    2.890611442640554,
    -0.4570457994644658,
    0.3731763325901154,
    -0.4570457994644658,
    1.445305721320277,
    -0.5900435899266435,
)


def eval_sh_basis(dirs: torch.Tensor, degree: int) -> torch.Tensor:
    """Evaluate the real SH basis at unit directions.

    dirs: (..., 3) -> (..., (degree+1)**2), 3DGS channel ordering."""
    x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    out = [torch.full_like(x, SH_C0)]
    if degree >= 1:
        out += [-_C1 * y, _C1 * z, -_C1 * x]
    if degree >= 2:
        xx, yy, zz = x * x, y * y, z * z
        xy, yz, xz = x * y, y * z, x * z
        out += [
            _C2[0] * xy,
            _C2[1] * yz,
            _C2[2] * (2.0 * zz - xx - yy),
            _C2[3] * xz,
            _C2[4] * (xx - yy),
        ]
    if degree >= 3:
        xx, yy, zz = x * x, y * y, z * z
        out += [
            _C3[0] * y * (3 * xx - yy),
            _C3[1] * x * y * z,
            _C3[2] * y * (4 * zz - xx - yy),
            _C3[3] * z * (2 * zz - 3 * xx - 3 * yy),
            _C3[4] * x * (4 * zz - xx - yy),
            _C3[5] * z * (xx - yy),
            _C3[6] * x * (xx - 3 * yy),
        ]
    return torch.stack(out, dim=-1)


@functools.lru_cache(maxsize=8)
def _sample_dirs_and_pinv(degree: int):
    """Fixed sample directions + pinv of their per-degree SH evaluations (numpy)."""
    rng = np.random.default_rng(1234)
    n = max(16, 4 * (degree + 1) ** 2)
    v = rng.normal(size=(n, 3))
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    basis = eval_sh_basis(torch.from_numpy(v.astype(np.float32)), degree).numpy()
    pinvs = {}
    for l in range(degree + 1):
        sl = slice(l * l, (l + 1) * (l + 1))
        pinvs[l] = np.linalg.pinv(basis[:, sl])
    return v.astype(np.float32), pinvs


def rotate_sh(sh: torch.Tensor, rotations: torch.Tensor) -> torch.Tensor:
    """Rotate SH coefficient vectors into a rotated frame.

    sh: (..., n) with n = (deg+1)^2; rotations: (..., 3, 3) (e.g. cam2world
    R), broadcast against sh's leading dims. Returns coefficients c' with
    sum_i c'_i Y_i(u) = sum_i c_i Y_i(R^T u).
    """
    n = sh.shape[-1]
    degree = int(np.sqrt(n)) - 1
    v_np, pinvs = _sample_dirs_and_pinv(degree)
    v = torch.from_numpy(v_np).to(sh.device)  # (K, 3)
    R = rotations.float()
    vr = torch.einsum("...ji,kj->...ki", R, v)  # directions R^T u: (..., K, 3)
    basis_r = eval_sh_basis(vr, degree)  # (..., K, n)
    outs = []
    for l in range(degree + 1):
        sl = slice(l * l, (l + 1) * (l + 1))
        Dl = torch.einsum("mk,...kj->...mj", torch.from_numpy(pinvs[l]).to(sh.device), basis_r[..., sl])
        outs.append(torch.einsum("...ij,...j->...i", Dl, sh[..., sl].float()))
    return torch.cat(outs, dim=-1).to(sh.dtype)

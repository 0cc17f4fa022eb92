"""The hand-written FPS kernel against its plain PyTorch version on a GPU:
identical index sequences (FPS is chaotic, so nothing weaker means
anything), one counted launch per call, and the plain switch launching
none. Skips without a card. The file imports neither JAX nor the JAX
package, so it also runs where they are absent
(``python -m pytest --noconftest -m cuda tests/test_torch_fps_cuda.py``)."""

import numpy as np
import pytest
import torch

from recondet3d_torch.ops.sampling import furthest_point_sample


def t(a):
    return torch.from_numpy(np.array(a, order="C"))


# (n, k, valid share, clusters the kernel must use): one cluster, a 393,216-row buffer whose valid points fit
# one cluster, the same buffer all valid (two clusters), fewer valid points than K, none valid, a million rows
@pytest.mark.cuda
@pytest.mark.parametrize("n,k,valid_share,clusters", [(5000, 300, 0.7, 1), (393216, 2000, 0.2, 1),
                                                      (393216, 1500, 1.0, 2), (64, 100, 0.5, 1),
                                                      (3000, 50, 0.0, 1), (1000000, 200, 1.0, 5)])
def test_fps_cuda_kernel_matches_plain(n, k, valid_share, clusters):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the FPS kernel is CUDA only")
    from recondet3d_torch.ops.fps import furthest_point_sample_cuda, reset_launch_counts

    rng = np.random.default_rng(n)
    pts = t(rng.uniform(-50, 50, (n, 3)).astype(np.float32)).cuda()
    valid = t(rng.random(n) < valid_share).cuda()
    reset_launch_counts()
    got = furthest_point_sample(pts, k, valid)
    torch.cuda.synchronize()
    assert furthest_point_sample_cuda.launches == 1
    ctrl = furthest_point_sample_cuda.last_ctrl.tolist()
    assert ctrl[2] == 16 and ctrl[3] == clusters  # the cluster size it ran with, the clusters it used
    ref = furthest_point_sample(pts, k, valid, impl="plain")
    assert furthest_point_sample_cuda.launches == 1
    assert torch.equal(got, ref)


@pytest.mark.cuda
def test_fps_cuda_kernel_refuses_what_it_cannot_hold():
    """A cloud larger than the clusters' shared memory raises instead of falling
    back; so does a tensor the kernel does not take."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the FPS kernel is CUDA only")
    from recondet3d_torch.ops.fps import furthest_point_sample_cuda

    big = torch.zeros((3_000_000, 3), device="cuda")
    with pytest.raises(ValueError, match="do not fit"):
        furthest_point_sample(big, 8)
    pts = torch.zeros((100, 3), device="cuda")
    with pytest.raises(ValueError, match="fp32"):
        furthest_point_sample_cuda(pts.double(), torch.ones(100, dtype=torch.bool, device="cuda"),
                                   torch.zeros(1, dtype=torch.int32, device="cuda"), 4)

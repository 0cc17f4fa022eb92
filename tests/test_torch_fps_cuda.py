"""The hand-written FPS kernel against its plain PyTorch version on a GPU:
identical index sequences (FPS is chaotic, so nothing weaker means
anything), one counted launch per call, the plain switch launching none,
and the kernel's count of its exchanges. Skips without a card. The file imports neither JAX nor the JAX
package, so it also runs where they are absent
(``python -m pytest --noconftest -m cuda tests/test_torch_fps_cuda.py``)."""

import numpy as np
import pytest
import torch

from recondet3d_torch.ops.sampling import furthest_point_sample


def t(a):
    return torch.from_numpy(np.array(a, order="C"))


# (n, k, valid share, clusters the kernel must use): one cluster, a 393,216-row buffer whose valid points fit
# one cluster, the same buffer all valid (two clusters), fewer valid points than K, none valid, a million rows;
# past the 1,404,928 rows 7 clusters hold on chip: one row over, 3 M rows, and 3 M rows of which a third are
# valid (5 clusters, nothing in device memory)
@pytest.mark.cuda
@pytest.mark.parametrize("n,k,valid_share,clusters", [(5000, 300, 0.7, 1), (393216, 2000, 0.2, 1),
                                                      (393216, 1500, 1.0, 2), (64, 100, 0.5, 1),
                                                      (3000, 50, 0.0, 1), (1000000, 200, 1.0, 5),
                                                      (1404929, 200, 1.0, 7), (3000000, 100, 1.0, 7),
                                                      (3000000, 100, 0.33, 5)])
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
    assert 1 <= ctrl[4] <= k - 1  # its exchanges
    ref = furthest_point_sample(pts, k, valid, impl="plain")
    assert furthest_point_sample_cuda.launches == 1
    assert torch.equal(got, ref)


@pytest.mark.cuda
def test_fps_cuda_kernel_refuses_what_it_cannot_hold():
    """A cloud past the 23-bit index packing raises instead of falling back;
    so does a tensor the kernel does not take."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the FPS kernel is CUDA only")
    from recondet3d_torch.ops.fps import MAX_POINTS, furthest_point_sample_cuda

    big = torch.zeros((MAX_POINTS + 1, 3), device="cuda")
    with pytest.raises(ValueError, match="1..8388606"):
        furthest_point_sample(big, 8)
    pts = torch.zeros((100, 3), device="cuda")
    with pytest.raises(ValueError, match="fp32"):
        furthest_point_sample_cuda(pts.double(), torch.ones(100, dtype=torch.bool, device="cuda"),
                                   torch.zeros(1, dtype=torch.int32, device="cuda"), 4)


def _kernel_and_plain(pts, valid, k):
    """The kernel's indices, its launch's exchanges, and the plain version's indices."""
    from recondet3d_torch.ops.fps import furthest_point_sample_cuda

    got = furthest_point_sample(pts, k, valid)
    exchanges = furthest_point_sample_cuda.last_ctrl.tolist()[4]
    return got, exchanges, furthest_point_sample(pts, k, valid, impl="plain")


# (name, n, k, valid share, cloud): integer coordinates in a small box, so that many min-distances are equal at the
# candidate list's bound and every valid point is picked before K (then every later pick repeats one index);
# fewer valid points than K; none valid; shares of the 8 points a CTA sends or fewer (16 x 8 = 128 valid points in
# all, and 100); one row; the production anchor and final FPS (the buffers without pre-reduce, their valid counts)
@pytest.mark.cuda
@pytest.mark.parametrize("name,n,k,valid_share,cloud", [
    ("ties_at_the_bound", 6000, 2500, 0.8, "grid8"), ("ties_small_box", 3000, 3000, 1.0, "grid3"),
    ("fewer_valid_than_k", 3000, 1000, 0.1, "uniform"), ("none_valid", 3000, 64, 0.0, "uniform"),
    ("share_of_top_or_fewer", 128, 200, 1.0, "uniform"), ("share_below_top", 400, 150, 0.25, "uniform"),
    ("one_row", 1, 5, 1.0, "uniform"), ("one_row_invalid", 1, 3, 0.0, "uniform"),
    ("production_anchors", 846720, 25000, 0.115, "street"), ("production_final", 425088, 40000, 0.182, "street")])
def test_fps_cuda_candidate_list_matches_plain(name, n, k, valid_share, cloud):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the FPS kernel is CUDA only")
    rng = np.random.default_rng(sum(map(ord, name)))
    if cloud.startswith("grid"):
        half = int(cloud[4:])
        pts = rng.integers(-half, half + 1, (n, 3)).astype(np.float32)
    elif cloud == "street":  # a street's extent: 108 m x 108 m, 8 m high, denser near the rig
        r = 54.0 * rng.random(n) ** 2
        a = rng.uniform(0, 2 * np.pi, n)
        pts = np.stack([r * np.cos(a), r * np.sin(a), rng.uniform(-5, 3, n)], 1).astype(np.float32)
    else:
        pts = rng.uniform(-50, 50, (n, 3)).astype(np.float32)
    valid = rng.random(n) < valid_share
    got, exchanges, ref = _kernel_and_plain(t(pts).cuda(), t(valid).cuda(), k)
    assert torch.equal(got, ref)
    assert 1 <= exchanges <= k - 1


@pytest.mark.cuda
def test_fps_cuda_exchange_counts():
    """The device counter: each launch adds its K - 1 selections and its
    exchanges (at least one, at most K - 1); the reset clears them."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the FPS kernel is CUDA only")
    from recondet3d_torch.ops.fps import exchange_counts, furthest_point_sample_cuda, reset_launch_counts

    rng = np.random.default_rng(7)
    reset_launch_counts()
    assert exchange_counts() == {"selections": 0, "exchanges": 0}
    per_call = []
    for n, k in ((20000, 3000), (5000, 700), (300, 2), (10, 1)):
        pts = t(rng.uniform(-30, 30, (n, 3)).astype(np.float32)).cuda()
        furthest_point_sample(pts, k, torch.ones(n, dtype=torch.bool, device="cuda"))
        per_call.append(furthest_point_sample_cuda.last_ctrl.tolist()[4])
        assert (1 <= per_call[-1] <= k - 1) if k >= 2 else per_call[-1] == 0
    assert exchange_counts() == {"selections": 2999 + 699 + 1, "exchanges": sum(per_call)}
    assert per_call[0] < 2999 / 10  # a spread cloud: many selections a exchange
    reset_launch_counts()
    assert exchange_counts() == {"selections": 0, "exchanges": 0}

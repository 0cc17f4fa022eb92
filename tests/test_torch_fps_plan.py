"""The FPS kernel's launch plan (``ops/fps.py`` ``launch_plan``), in pure
Python: the clusters a buffer of N rows is launched with, each CTA's
capacity and shared memory, the overflow a CTA keeps in device memory once
N exceeds what the clusters an H100 holds at once keep on chip, and the
refusals outside 1..``MAX_POINTS``. The kernel decides on the card how many
of the launched clusters a cloud's valid points need; the plan is for N
valid rows."""

import pytest

from recondet3d_torch.ops.fps import CLUSTER, CTA_MAX_POINTS, MAX_CLUSTERS, MAX_POINTS, REG_POINTS, launch_plan

MOST_ROWS = MAX_CLUSTERS * CLUSTER * CTA_MAX_POINTS  # 7 clusters of 16 CTAs, each at its full shared memory


@pytest.mark.parametrize("n,clusters,cta_cap,smem_points,overflow", [
    (1000, 1, 63, 0, 0),                  # a small cloud: one cluster, every point in registers
    (393216, 2, 12288, 7168, 0),          # the pre-reduce buffer (anchors and final FPS of the main path)
    (425088, 3, 8856, 3736, 0),           # the union buffer without pre-reduce
    (846720, 5, 10584, 5464, 0),          # 6 views of 280 x 504: the production anchors without pre-reduce
    (MOST_ROWS, 7, 12544, 7424, 0),       # the most rows the clusters an H100 runs at once hold on chip
    (MOST_ROWS + 1, 7, 12544, 7424, 1),   # one row past: a CTA keeps one point in device memory
    (1406496, 7, 12544, 7424, 14),        # 6 views of 364 x 644 (process_res 644) without pre-reduce
    (3_000_000, 7, 12544, 7424, 14242),
    (5_000_000, 7, 12544, 7424, 32099),   # the Pallas kernel's stated ceiling
    (MAX_POINTS, 7, 12544, 7424, 62355),  # the most the 23-bit index packing takes
])
def test_launch_plan(n, clusters, cta_cap, smem_points, overflow):
    plan = launch_plan(n)
    assert (plan.clusters, plan.cta_cap, plan.smem_points, plan.overflow) == (clusters, cta_cap, smem_points,
                                                                              overflow)
    share = plan.cta_cap + plan.overflow
    assert plan.clusters * CLUSTER * share >= n > (plan.clusters - 1) * CLUSTER * CTA_MAX_POINTS
    assert plan.clusters * CLUSTER * (share - 1) < n  # the fewest points a CTA can own
    assert plan.overflow == 0 or (plan.clusters == MAX_CLUSTERS and plan.cta_cap == CTA_MAX_POINTS)
    assert plan.smem_points == max(0, plan.cta_cap - REG_POINTS)
    assert plan.smem_bytes == 2048 + 16 * plan.cta_cap + 4 * plan.smem_points <= 232448


def test_launch_plan_refuses():
    assert MAX_POINTS == (1 << 23) - 2 >= 5_000_000
    with pytest.raises(ValueError, match="1..8388606"):
        launch_plan(MAX_POINTS + 1)
    with pytest.raises(ValueError):
        launch_plan(0)

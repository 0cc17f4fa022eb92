"""The FPS kernel's launch plan (``ops/fps.py`` ``launch_plan``), in pure
Python: the clusters a buffer of N rows is launched with, each CTA's
capacity and shared memory, and the refusals above ``MAX_POINTS`` and
beyond the clusters an H100 holds at once. The kernel decides on the card
how many of the launched clusters a cloud's valid points need; the plan is
for N valid rows."""

import pytest

from recondet3d_torch.ops.fps import CLUSTER, CTA_MAX_POINTS, MAX_CLUSTERS, MAX_POINTS, REG_POINTS, launch_plan

MOST_ROWS = MAX_CLUSTERS * CLUSTER * CTA_MAX_POINTS  # 7 clusters of 16 CTAs, each at its full shared memory


@pytest.mark.parametrize("n,clusters,cta_cap,smem_points", [
    (1000, 1, 63, 0),                  # a small cloud: one cluster, every point in registers
    (393216, 2, 12288, 7168),          # the pre-reduce buffer (anchors and final FPS of the main path)
    (425088, 3, 8856, 3736),           # the union buffer without pre-reduce
    (MOST_ROWS, 7, 12544, 7424),       # the most rows the clusters an H100 runs at once can hold
])
def test_launch_plan(n, clusters, cta_cap, smem_points):
    plan = launch_plan(n)
    assert (plan.clusters, plan.cta_cap, plan.smem_points) == (clusters, cta_cap, smem_points)
    assert plan.clusters * CLUSTER * plan.cta_cap >= n > (plan.clusters - 1) * CLUSTER * CTA_MAX_POINTS
    assert plan.smem_points == max(0, plan.cta_cap - REG_POINTS)
    assert plan.smem_bytes == 2048 + 16 * plan.cta_cap + 4 * plan.smem_points <= 232448


def test_launch_plan_refuses():
    with pytest.raises(ValueError, match="1..4194302"):
        launch_plan(MAX_POINTS + 1)
    with pytest.raises(ValueError):
        launch_plan(0)
    with pytest.raises(ValueError, match="do not fit the shared memory of 7 clusters"):
        launch_plan(MOST_ROWS + 1)
    with pytest.raises(ValueError, match="do not fit"):
        launch_plan(3_000_000)

"""Ops of the port: attention, the point ops, voxelization, scatter and the
kernel build. The exports are the counterparts of ``recondet3d/ops``'s
(``attention_plain`` for ``attention_xla``); importing them builds no kernel."""

from recondet3d_torch.ops.attention import attention_plain, flash_attention, multi_head_attention
from recondet3d_torch.ops.ball_query import ball_query
from recondet3d_torch.ops.grouping import gather_points, group_points, three_interpolate, three_nn
from recondet3d_torch.ops.knn import knn
from recondet3d_torch.ops.sampling import furthest_point_sample, furthest_point_sample_with_dist
from recondet3d_torch.ops.scatter import DynamicScatter, dynamic_scatter
from recondet3d_torch.ops.voxelize import (
    Voxelization,
    compute_grid_size,
    dynamic_voxelize,
    voxel_centers,
    voxelize,
)

"""nuScenes tables, info-pkl converter, dataset and GT database (the port's
copy of ``recondet3d/data/nuscenes``: host numpy, no JAX)."""

from recondet3d_torch.data.nuscenes.converter import CAM_TYPES, create_nuscenes_infos, obtain_sensor2top
from recondet3d_torch.data.nuscenes.dataset import CBGSDataset, NuScenesDataset
from recondet3d_torch.data.nuscenes.tables import NuScenesTables, quat_wxyz_to_matrix

__all__ = ["CAM_TYPES", "create_nuscenes_infos", "obtain_sensor2top", "CBGSDataset", "NuScenesDataset",
           "NuScenesTables", "quat_wxyz_to_matrix"]

"""nuScenes tables, info-pkl converter, dataset, GT database and the nuImages COCO exporter (the port's
copy of ``recondet3d/data/nuscenes``: host numpy, no JAX)."""

from recondet3d_torch.data.nuscenes.converter import CAM_TYPES, create_nuscenes_infos, obtain_sensor2top
from recondet3d_torch.data.nuscenes.dataset import CBGSDataset, NuScenesDataset
from recondet3d_torch.data.nuscenes.nuimage_converter import NUIMAGE_NAME_MAPPING, NUS_CATEGORIES, export_nuimages_to_coco
from recondet3d_torch.data.nuscenes.tables import NuScenesTables, quat_wxyz_to_matrix

__all__ = ["CAM_TYPES", "create_nuscenes_infos", "obtain_sensor2top", "CBGSDataset", "NuScenesDataset",
           "NuScenesTables", "quat_wxyz_to_matrix", "NUIMAGE_NAME_MAPPING", "NUS_CATEGORIES", "export_nuimages_to_coco"]

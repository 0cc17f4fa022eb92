"""KITTI info-pkl converter (the port's copy of ``recondet3d/data/kitti``)."""

from recondet3d_torch.data.kitti.converter import camera_to_lidar_boxes, create_kitti_infos, parse_calib, parse_label

__all__ = ["camera_to_lidar_boxes", "create_kitti_infos", "parse_calib", "parse_label"]

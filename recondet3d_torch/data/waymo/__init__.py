"""Waymo converter: TFRecords -> KITTI layout -> info pkls (the port's copy of ``recondet3d/data/waymo``)."""

from recondet3d_torch.data.waymo.converter import convert_tfrecords, create_waymo_infos

__all__ = ["convert_tfrecords", "create_waymo_infos"]

"""ScanNet / SUN RGB-D / S3DIS converters, datasets and the indoor AP (the port's copy of
``recondet3d/data/indoor``)."""

from recondet3d_torch.data.indoor.converter import (
    S3DIS_CLASSES,
    S3DISData,
    SCANNET_CLASSES,
    SUNRGBD_CLASSES,
    ScanNetData,
    SUNRGBDData,
    create_indoor_infos,
)
from recondet3d_torch.data.indoor.dataset import (
    S3DISDataset,
    ScanNetDataset,
    SUNRGBDDataset,
    average_precision,
    indoor_eval,
)

"""Lyft Level-5 converter, dataset and IoU mAP (the port's copy of ``recondet3d/data/lyft``)."""

from recondet3d_torch.data.lyft.converter import LYFT_CLASSES, create_lyft_infos
from recondet3d_torch.data.lyft.dataset import LyftDataset, lyft_map

__all__ = ["LYFT_CLASSES", "create_lyft_infos", "LyftDataset", "lyft_map"]

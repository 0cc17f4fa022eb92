from recondet3d_torch.models.da3.cam import CameraDec, CameraEnc
from recondet3d_torch.models.da3.dpt import DPT, DualDPT
from recondet3d_torch.models.da3.net import DepthAnything3Net, NestedDepthAnything3Net
from recondet3d_torch.models.da3.presets import MODEL_REGISTRY, PRESETS, build_da3
from recondet3d_torch.models.da3.vit import DinoViT

"""The port's own copies of the JAX package's ``core`` modules: config and
registries, 3D box structures and multi-class box NMS."""

from recondet3d_torch.core.box3d import (
    Box3DMode,
    CameraBoxes3D,
    DepthBoxes3D,
    LiDARBoxes3D,
    convert_box_mode,
    limit_period,
)
from recondet3d_torch.core.config import (
    ConfigDict,
    apply_overrides,
    create_object,
    load_config,
    load_py_config,
    merge_dicts,
    resolve_inheritance,
)
from recondet3d_torch.core.post_processing import box3d_multiclass_nms, xywhr2xyxyr
from recondet3d_torch.core.registry import (
    ASSIGNERS,
    BACKBONES,
    BBOX_CODERS,
    DATASETS,
    DETECTORS,
    HOOKS,
    LOSSES,
    MATCH_COSTS,
    MIDDLE_ENCODERS,
    PIPELINES,
    Registry,
    VOXEL_ENCODERS,
)

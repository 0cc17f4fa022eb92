"""Framework-wide constants (own copy of ``recondet3d/utils/constants.py``)."""

# Minimum number of views before reference-view selection/reordering kicks in.
THRESH_FOR_REF_SELECTION = 3

# ImageNet normalization used by the input processor.
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)

# DA3 processing resolution and ViT patch size.
DEFAULT_PROCESS_RES = 504
PATCH_SIZE = 14

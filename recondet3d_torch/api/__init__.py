"""Public API of the port: ``DepthAnything3`` and the weight bridge."""

from recondet3d_torch.api.depth_anything3 import DepthAnything3

__all__ = ["DepthAnything3"]

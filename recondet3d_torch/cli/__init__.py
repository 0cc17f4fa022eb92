"""Command-line entry points of the port (``python -m recondet3d_torch.cli.<tool>``): create_data,
train, test, da3, inference_nuscenes, inference_mmdet3d, check_model_memory, vis_occupancy, gt_vis."""

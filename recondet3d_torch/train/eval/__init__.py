from recondet3d_torch.train.eval.nuscenes_eval import DetectionBox, accumulate, calc_ap, calc_tp, evaluate_nuscenes

__all__ = ["DetectionBox", "accumulate", "calc_ap", "calc_tp", "evaluate_nuscenes"]

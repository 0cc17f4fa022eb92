"""Device ms a request in the CenterHead: CUDA events in a forward hook on
``pts_bbox_head``."""

LAYER = "detection head"
MOVES = "frames_per_s"
UNIT = "ms"
HOOKS = ("pts_bbox_head",)


def read(run):
    ms = run["hooks_ms"].get("det_head_ms")
    return None if ms is None or run["kind"] != "infer" else ms / run["units"]

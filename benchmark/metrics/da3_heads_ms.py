"""Device ms a request in DA3's heads: CUDA events in forward hooks on the
DualDPT head, the camera decoder and the metric DPT head (with the sky head)."""

LAYER = "DA3 heads"
MOVES = "frames_per_s"
UNIT = "ms"
HOOKS = ("reconstruction_backbone.da3.da3.head", "reconstruction_backbone.da3.da3.cam_dec",
         "reconstruction_backbone.da3.da3_metric.head")


def read(run):
    ms = run["hooks_ms"].get("da3_heads_ms")
    return None if ms is None or run["kind"] != "infer" else ms / run["units"]

"""Device ms a request in DA3's ViT trunks: CUDA events in forward hooks on
the any-view ViT-g and the metric ViT-L, summed over the window's requests."""

LAYER = "DA3 trunks"
MOVES = "frames_per_s"
UNIT = "ms"
HOOKS = ("reconstruction_backbone.da3.da3.backbone.pretrained",
         "reconstruction_backbone.da3.da3_metric.backbone.pretrained")


def read(run):
    ms = run["hooks_ms"].get("da3_trunk_ms")
    return None if ms is None or run["kind"] != "infer" else ms / run["units"]

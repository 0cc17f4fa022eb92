"""Device ms a request in the refinement: the program's spans voxelize_vfe +
sparse_encoder + bev_unet."""

LAYER = "refinement"
MOVES = "frames_per_s"
UNIT = "ms"
SPANS = ("voxelize_vfe", "sparse_encoder", "bev_unet")


def read(run):
    spans = run["spans_ms"]
    if run["kind"] != "infer" or not any(s in spans for s in SPANS):
        return None
    return sum(spans.get(s, 0.0) for s in SPANS) / run["units"]

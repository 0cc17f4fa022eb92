"""Device ms a request in DA3's ViT trunks by the program's span
``da3_trunk`` (any-view and metric)."""

LAYER = "DA3 trunks"
MOVES = "frames_per_s"
UNIT = "ms"


def read(run):
    ms = run["spans_ms"].get("da3_trunk")
    return None if ms is None or run["kind"] != "infer" else ms / run["units"]

"""Device ms a request in DA3's heads by the program's span ``da3_heads``
(the head, the camera estimation and the sky clamp of each branch)."""

LAYER = "DA3 heads"
MOVES = "frames_per_s"
UNIT = "ms"


def read(run):
    ms = run["spans_ms"].get("da3_heads")
    return None if ms is None or run["kind"] != "infer" else ms / run["units"]

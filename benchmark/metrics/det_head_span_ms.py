"""Device ms a request in the CenterHead by the program's span ``det_head``."""

LAYER = "detection head"
MOVES = "frames_per_s"
UNIT = "ms"


def read(run):
    ms = run["spans_ms"].get("det_head")
    return None if ms is None or run["kind"] != "infer" else ms / run["units"]

"""Device ms a request in DA3: the program's span ``da3`` (``predict_depth``:
the input processor, both trunks and heads, the scale alignment)."""

LAYER = "DA3"
MOVES = "frames_per_s"
UNIT = "ms"


def read(run):
    ms = run["spans_ms"].get("da3")
    return None if ms is None or run["kind"] != "infer" else ms / run["units"]

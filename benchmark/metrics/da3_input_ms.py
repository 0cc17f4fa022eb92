"""Device ms a request in DA3's input processor: the program's span
``da3_input`` (``process_tensor_batch``: resize, crop, normalise)."""

LAYER = "input processor"
MOVES = "frames_per_s"
UNIT = "ms"


def read(run):
    ms = run["spans_ms"].get("da3_input")
    return None if ms is None or run["kind"] != "infer" else ms / run["units"]

"""Device ms a step in the frozen DA3: the program's span ``da3`` inside the
training forward, the part of ``train_forward_ms`` that trains nothing."""

LAYER = "DA3"
MOVES = "train_samples_per_s"
UNIT = "ms"


def read(run):
    ms = run["spans_ms"].get("da3")
    return None if ms is None or run["kind"] != "train" else ms / run["units"]

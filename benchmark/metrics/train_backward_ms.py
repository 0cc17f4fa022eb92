"""Device ms a step in the backward: the Trainer's span ``backward``."""

LAYER = "training"
MOVES = "train_samples_per_s"
UNIT = "ms"


def read(run):
    ms = run["spans_ms"].get("backward")
    return None if ms is None or run["kind"] != "train" else ms / run["units"]

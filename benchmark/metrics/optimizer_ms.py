"""Device ms a step in the clip and AdamW update: the Trainer's span
``optimizer``."""

LAYER = "training"
MOVES = "train_samples_per_s"
UNIT = "ms"


def read(run):
    ms = run["spans_ms"].get("optimizer")
    return None if ms is None or run["kind"] != "train" else ms / run["units"]

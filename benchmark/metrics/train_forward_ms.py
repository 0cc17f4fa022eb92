"""Device ms a step in the training forward: the Trainer's span ``forward``
(DA3 frozen, the point path, the refinement and its loss)."""

LAYER = "model in training"
MOVES = "train_samples_per_s"
UNIT = "ms"


def read(run):
    ms = run["spans_ms"].get("forward")
    return None if ms is None or run["kind"] != "train" else ms / run["units"]

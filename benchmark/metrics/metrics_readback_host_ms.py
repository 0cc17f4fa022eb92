"""Host ms a step blocked reading the step's metrics to the host: the
program's span ``metrics_readback`` in ``Trainer.run`` (it waits for the
step's device work)."""

LAYER = "training"
MOVES = "train_samples_per_s"
UNIT = "ms"


def read(run):
    ms = run["spans_ms"].get("metrics_readback/host_ms")
    return None if ms is None or run["kind"] != "train" else ms / run["units"]

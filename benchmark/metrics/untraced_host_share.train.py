"""The share of a train step's host time that no layer span covers: the
program's span ``train_step`` less its child spans (``/host_self_ms``) over
the span (``/host_ms``), summed over the window's steps."""

LAYER = "entry"
MOVES = "train_samples_per_s"
UNIT = "share"


def read(run):
    spans = run["spans_ms"]
    total = spans.get("train_step/host_ms")
    if not total or run["kind"] != "train":
        return None
    return spans["train_step/host_self_ms"] / total

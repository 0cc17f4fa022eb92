"""The share of a request's host time that no layer span covers: the
program's span ``request`` less its child spans (``/host_self_ms``) over the
span (``/host_ms``), summed over the window's requests."""

LAYER = "entry"
MOVES = "frames_per_s"
UNIT = "share"


def read(run):
    spans = run["spans_ms"]
    total = spans.get("request/host_ms")
    if not total or run["kind"] != "infer":
        return None
    return spans["request/host_self_ms"] / total

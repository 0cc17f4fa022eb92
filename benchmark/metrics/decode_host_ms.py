"""Host ms a request in ``pts_bbox_head.decode`` by the program's span
``decode`` (top-K, BEV NMS, results to the host)."""

LAYER = "detection head"
MOVES = "latency_p90_ms"
UNIT = "ms"


def read(run):
    ms = run["spans_ms"].get("decode/host_ms")
    return None if ms is None or run["kind"] != "infer" else ms / run["units"]

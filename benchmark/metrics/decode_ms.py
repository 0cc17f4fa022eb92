"""Host ms a request in ``pts_bbox_head.decode`` (top-K, BEV NMS, results to
the host), by the host clock around each call of the window."""

LAYER = "detection head"
MOVES = "frames_per_s"
UNIT = "ms"


def read(run):
    d = run["decode_s"]
    return 1e3 * sum(d) / len(d) if d else None

"""Host ms a request in the point path: the program's spans unprojection +
pre_reduce + ball_query_downsample + fps_downsample by the host clock, beside
``point_path_ms``'s device ms (the per-scene loop's host cost)."""

LAYER = "point path"
MOVES = "frames_per_s"
UNIT = "ms"
SPANS = ("unprojection", "pre_reduce", "ball_query_downsample", "fps_downsample")


def read(run):
    spans = run["spans_ms"]
    keys = [s + "/host_ms" for s in SPANS]
    if run["kind"] != "infer" or not any(k in spans for k in keys):
        return None
    return sum(spans.get(k, 0.0) for k in keys) / run["units"]

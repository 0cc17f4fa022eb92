"""Device ms a request in the point path: the program's spans
unprojection + pre_reduce + ball_query_downsample + fps_downsample."""

LAYER = "point path"
MOVES = "frames_per_s"
UNIT = "ms"
SPANS = ("unprojection", "pre_reduce", "ball_query_downsample", "fps_downsample")


def read(run):
    spans = run["spans_ms"]
    if run["kind"] != "infer" or not any(s in spans for s in SPANS):
        return None
    return sum(spans.get(s, 0.0) for s in SPANS) / run["units"]

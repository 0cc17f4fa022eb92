"""The share of a request's time in which no kernel ran on the device, in the
infer cells: one less the device's busy time a request (kernel intervals
merged, from the profiler's trace of the stretch after the window) over the
request's time in the traced run's measured window, which runs without the
profiler and so without its cost on the host."""

LAYER = "device"
MOVES = "frames_per_s"
UNIT = "share"


def read(run):
    prof = run.get("profile")
    if prof is None or run["kind"] != "infer":
        return None
    return 1.0 - (prof["busy_s"] / prof["units"]) / (run["window_s"] / run["units"])

"""The FPS kernel's share of its roofline: the least time of a request's
selections (benchmark/counts/fps.py, with rows, valid rows and K counted by
the benchmark's reference on the checked request) over the device time of
the FPS kernels in the traced stretch, a request's worth."""

LAYER = "FPS kernel"
MOVES = "frames_per_s"
UNIT = "%"
KERNELS = ("fps_kernel",)


def read(run):
    prof = run.get("profile")
    if prof is None or run["kind"] != "infer" or not run.get("fps_least_s"):
        return None
    dev = sum(s for n, s in prof["kernels_by_name"].items() if any(k in n for k in KERNELS)) / prof["units"]
    return None if dev <= 0 else 100.0 * run["fps_least_s"] / dev

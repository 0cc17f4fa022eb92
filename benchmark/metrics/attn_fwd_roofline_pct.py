"""The attention kernels' share of their roofline: the least time of a
request's attention (benchmark/counts/attention.py, from the configuration's
shapes) over the device time of the kernels that do it in the traced
stretch, a request's worth."""

LAYER = "attention kernels"
MOVES = "frames_per_s"
UNIT = "%"
KERNELS = ("flash_fwd_kernel", "cc_fwd_kernel", "cc_short_fwd_kernel")


def read(run):
    prof = run.get("profile")
    if prof is None or run["kind"] != "infer" or "attention" not in run:
        return None
    dev = sum(s for n, s in prof["kernels_by_name"].items() if any(k in n for k in KERNELS)) / prof["units"]
    return None if dev <= 0 else 100.0 * run["attention"]["least_s"] / dev

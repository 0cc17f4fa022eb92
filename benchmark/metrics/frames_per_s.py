"""Camera frames completed over the whole window's time (a request of B
scenes is 6 * B frames)."""

UNIT = "frames/s"


def read(run):
    if run["kind"] != "infer":
        return None
    return run["units"] * run["frames_per_unit"] / run["window_s"]

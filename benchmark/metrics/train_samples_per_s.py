"""Scenes trained over the whole window's time."""

UNIT = "samples/s"


def read(run):
    if run["kind"] != "train":
        return None
    return run["units"] * run["samples_per_unit"] / run["window_s"]

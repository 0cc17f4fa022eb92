"""The FPS kernel's selections a cluster exchange over the window: the
program's device counters (``ops/fps.py`` ``exchange_counts()``), reset
before the window and read once after it. Higher is fewer waits on the
cluster's exchange for the same selections."""

LAYER = "FPS kernel"
MOVES = "frames_per_s"
UNIT = "selections"


def read(run):
    counts = run.get("fps_exchange")
    if run["kind"] != "infer" or not counts or not counts["exchanges"]:
        return None
    return counts["selections"] / counts["exchanges"]

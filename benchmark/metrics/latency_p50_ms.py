"""The median of every request of the window, each timed from its send to
its return with its host results: beside the 90th percentile, a steadier
reading of the same requests, since a run on a busy host moves its tail
more than its middle."""

import statistics

LAYER = "entry"
MOVES = "latency_p90_ms"
UNIT = "ms"


def read(run):
    lat = run["latencies_s"]
    if run["kind"] != "infer" or not lat:
        return None
    return 1e3 * statistics.median(lat)

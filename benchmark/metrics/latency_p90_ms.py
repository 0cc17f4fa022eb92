"""The 90th percentile of every request of the window, each timed from its
send to its return with its host results (a closed loop of one client)."""

import statistics

UNIT = "ms"


def read(run):
    lat = run["latencies_s"]
    if run["kind"] != "infer" or len(lat) < 2:
        return None
    return 1e3 * statistics.quantiles(lat, n=10, method="inclusive")[8]

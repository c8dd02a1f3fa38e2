"""The 95th percentile, by nearest rank, over every batch of the window
of the time from the call into the entry for that batch to the host
seeing its completion event, in ms."""

import math


def value(w) -> float:
    lat = sorted(w.latencies_s)
    return 1e3 * lat[max(0, math.ceil(0.95 * len(lat)) - 1)]

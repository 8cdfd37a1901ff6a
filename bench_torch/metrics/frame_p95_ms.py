"""95th percentile of every window frame's latency (call to count read
and device synchronized), nearest rank, ms."""

import math


def read(ctx):
    lat = sorted(ctx.latencies_s)
    return lat[math.ceil(0.95 * len(lat)) - 1] * 1e3

"""``score_p95_ms``: the 95th percentile of every request in the window,
each timed from its call to its scores as a host array (host clock;
linear interpolation between order statistics)."""

import statistics


def read(ctx):
    lat = ctx.window.latencies_s
    if not lat:
        return None
    if len(lat) == 1:
        return 1e3 * lat[0]
    return 1e3 * statistics.quantiles(lat, n=100, method="inclusive")[94]

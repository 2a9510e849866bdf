"""tile_p95_ms: the 95th percentile over every tile of the window of
the host-clock time from its first call to the end of its
synchronize (linear interpolation between order statistics)."""

import statistics


def read(run):
    times = [(t.end - t.start) * 1e3 for t in run.tiles]
    if len(times) < 20:
        return None
    return statistics.quantiles(times, n=20, method='inclusive')[18]

"""The 95th percentile of every image's latency in the window, in ms (the
call to its totals on the host). Read only from 200 images on: ten beyond
the percentile. In a batched cell an image is one call, a whole batch."""

import statistics

MIN_IMAGES = 200


def read(run):
    if run.images < MIN_IMAGES:
        return None
    return statistics.quantiles(run.latencies_s, n=100, method="inclusive")[94] * 1e3

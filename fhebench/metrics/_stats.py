"""The statistics the readers share."""

import statistics


def rate(w, name=None):
    """Operations completed over the whole window, divided by the window
    (host clock, the window ending on a synchronize)."""
    return w.ops / w.window_s if w.ops else None


def median(values):
    return statistics.median(values) if values else None


def p95(values):
    """The 95th percentile by statistics.quantiles (exclusive method),
    over every value; None under 20 values, where it would be a maximum."""
    if len(values) < 20:
        return None
    return statistics.quantiles(values, n=20)[18]

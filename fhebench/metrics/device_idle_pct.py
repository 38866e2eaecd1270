"""The share of the traced window in which no operation runs on the
card, from the profiler's device trace."""


def read(w, name):
    t = w.trace
    if t is None or not t.window_s or not t.dev_ns:
        return None
    return 100.0 * (t.window_s - t.busy_s) / t.window_s

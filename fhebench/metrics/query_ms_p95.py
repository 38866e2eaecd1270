"""The 95th percentile of the same latency over all queries of the
window (the run prints its sample count on stderr)."""

import sys

from fhebench.metrics._stats import p95


def read(w, name):
    print(f"query_ms_p95: {len(w.latencies_ms)} queries", file=sys.stderr)
    return p95(w.latencies_ms)

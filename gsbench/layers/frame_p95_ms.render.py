"""The 95th percentile (ms) of the frame latencies of the measured window:
the viewer's tail, which the host's clock spreads too widely between runs
to hold to a bound (PERF.md, section 2)."""
UNIT = "ms"


def read(rec):
    return rec["window"]["p95_ms"] if rec["kind"] == "render" else None

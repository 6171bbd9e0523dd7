"""End to end: 95th percentile of a call's latency, issue to result."""
from portbench.readers import call_p95_ms as read  # noqa: F401

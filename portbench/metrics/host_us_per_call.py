"""Public entries: host microseconds per call, issue to return."""
from portbench.readers import host_us_per_call as read  # noqa: F401

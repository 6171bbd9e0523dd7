"""End to end: set-up seconds, process start to the first timed call."""
from portbench.readers import setup_s as read  # noqa: F401

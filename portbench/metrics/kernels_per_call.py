"""Engine ladder and routing: device kernels per call (profiler)."""
from portbench.readers import kernels_per_call as read  # noqa: F401

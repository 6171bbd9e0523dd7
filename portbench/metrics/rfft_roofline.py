"""CUDA kernels: the real FFT's bound over the device time it took, in %."""
from portbench.readers import roofline_pct as read  # noqa: F401

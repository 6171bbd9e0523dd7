"""CUDA kernels: MiB of device buffers the program allocates per call."""
from portbench.program import counter_per_call

read = counter_per_call("alloc_bytes", 1.0 / (1 << 20))

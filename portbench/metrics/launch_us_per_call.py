"""CUDA kernels, host side: self µs of the alloc, launch, tree and cufft
spans per call (traced)."""
from portbench.program import span_us_per_call

read = span_us_per_call("alloc", "launch", "tree", "cufft")

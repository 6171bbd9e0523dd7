"""End to end: STFT frames per second of the window."""
from portbench.readers import rate

read = rate("frames")

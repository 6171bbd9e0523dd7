"""End to end: complex points transformed per second of the window."""
from portbench.readers import rate

read = rate("points")

"""Public entries: self µs of the entry's root span per call (traced)."""
from portbench.program import span_us_per_call

read = span_us_per_call()

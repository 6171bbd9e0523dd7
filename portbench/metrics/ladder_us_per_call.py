"""Engine ladder and routing: self µs of the ladder, route, frame, args
and table spans per call (traced)."""
from portbench.program import span_us_per_call

read = span_us_per_call("ladder", "route", "frame", "args", "table")

"""Engine ladder and routing: host-table builds (cache misses) per call."""
from portbench.program import counter_per_call

read = counter_per_call("table_builds")

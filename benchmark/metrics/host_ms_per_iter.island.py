"""Host time of an iteration on the four-card island cell, averaged over
the ranks (it moves ``steps_per_s.island``).  The reader of
``host_ms_per_iter``."""
from benchmark.harness import spec

read = spec.metric_reader("host_ms_per_iter")

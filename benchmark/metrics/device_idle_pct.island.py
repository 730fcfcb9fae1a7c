"""The card's idle share on the four-card island cell, averaged over the
ranks (it moves ``steps_per_s.island``).  The reader of
``device_idle_pct``."""
from benchmark.harness import spec

read = spec.metric_reader("device_idle_pct")

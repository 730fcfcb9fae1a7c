"""K1's share of its roofline on the four-card island cell, at the
particles of one card, averaged over the ranks (it moves
``steps_per_s.island``).  The reader of ``k1_roofline``."""
from benchmark.harness import spec

read = spec.metric_reader("k1_roofline")

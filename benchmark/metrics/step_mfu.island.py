"""The SGLD step's share of the float32 peak on the four-card island
cell: each rank's own particles, averaged over the ranks (it moves
``steps_per_s.island``).  The reader of ``step_mfu``."""
from benchmark.harness import spec

read = spec.metric_reader("step_mfu")

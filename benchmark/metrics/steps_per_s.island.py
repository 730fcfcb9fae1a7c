"""Chain-steps completed a second on the four-card island cell, where
every iteration waits for the slowest of four processes: a metric of its
own, since its runs spread four times as widely as one card's.  The
reader of ``steps_per_s``."""
from benchmark.harness import spec

read = spec.metric_reader("steps_per_s")

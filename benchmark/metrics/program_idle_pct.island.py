"""The card's idle share inside the program's ``sgmcmc.fit_scan`` spans
on the four-card island cell, averaged over the ranks (it moves
``steps_per_s.island``).  The reader of ``program_idle_pct``."""
from benchmark.harness import spec

read = spec.metric_reader("program_idle_pct")

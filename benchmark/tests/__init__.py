"""CPU tests of the benchmark (and one that runs on the card)."""

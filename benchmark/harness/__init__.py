"""The benchmark's harness: set-up, the measured window, the trace, the
correctness check and the result line."""

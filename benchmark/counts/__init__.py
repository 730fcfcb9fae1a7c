"""Frozen operation and byte counts and the chip's published peaks: the
yardstick of the roofline and MFU metrics.  Each count is of the
algorithm's work, computed from a launch's or a step's shapes, and names
the source lines it was read from."""

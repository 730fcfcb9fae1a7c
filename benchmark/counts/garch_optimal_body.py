"""Operations of the GARCH(1,1) body with the locally optimal kernel per
particle and window step (``csrc/garch_body.cuh``: propose 19, reweight
10, statistic 30, and 2 more update operations for the fourth
statistic), frozen from ``chip_smoke.py:300-304``
(``K1_BODY_OPS["garch_optimal"] = 61``)."""

BODY_OPS = 61

"""Operations of the SVM body per particle and window step
(``csrc/svm_body.cuh``: propose 3, reweight 14, statistic 18), frozen
from ``chip_smoke.py:293`` (``K1_BODY_OPS["svm"] = 35``)."""

BODY_OPS = 35

"""Operations of the SVM body per particle and window step
(``csrc/svm_body.cuh``: propose 3, reweight 14, statistic 18), frozen
from ``chip_smoke.py:293`` (``K1_BODY_OPS["svm"] = 35``).

PaRIS's backward step (``counts/paris.py``) reads the statistic's share
and the transition log-density ``log N(x'; A x, Q)`` a pair
(``models/svm.py`` ``_prior_log_density``: ``x' - A x`` 2, its square 1,
the scaling by ``Q^-1`` and ``-1/2`` 2, the two constant terms 2)."""

BODY_OPS = 35
STAT_OPS = 18
TRANSITION_OPS = 7

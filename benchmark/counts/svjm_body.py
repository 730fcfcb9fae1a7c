"""Operations of the SVJM body per particle and window step
(``csrc/svjm_body.cuh``: propose 11, the jump's compare and select, two
squares, two reciprocals, a sum, a square root and the step; reweight 14,
the SVM's emission; statistic 70, the two branch variances, the log-ratio
of the branch densities with its two logarithms, the clipped sigmoids of
the responsibility and of pJ with their two exponentials, the three
mixture scores and the emission's score; and 2 update operations for each
of the two statistics beyond the SVM's three), frozen from
``chip_smoke.py:319`` (``K1_BODY_OPS["svjm"] = 99``).  With the frame's 25
and two in-kernel normals of 63 a particle-step is 250 operations."""

BODY_OPS = 99

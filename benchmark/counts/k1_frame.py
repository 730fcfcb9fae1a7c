"""Operations of the fused window's frame per particle and window step,
whatever the model body: the weights' max (1), the exponential shift (2),
the prefix sum and CDF (3), the resampling position (2), about 11 search
compares and the update of state and statistics (6).  Counted in
``csrc/fused_window.cuh`` and frozen from ``chip_smoke.py:286-294``
(``K1_OPS = 60`` for the SVM, less its body of 35: ``K1_FRAME_OPS``).
The few float64 operations count at the float32 rate.

``RNG_OPS`` is one standard normal drawn in the kernel: half a
Philox4x32-10 call (98 integer operations, counted at the float32 rate)
and one Box-Muller transform (14, log and cos counted as one each), frozen
from ``chip_smoke.py:299`` (``RNG_OPS = 49 + 14``)."""

FRAME_OPS = 25
RNG_OPS = 49 + 14

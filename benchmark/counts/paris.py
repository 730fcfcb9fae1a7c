"""Float32 operations of the whole SGLD step under PaRIS per particle and
window step, from shapes (``ops/smoothers.py`` ``make_paris_step``: the
resampling of the particles alone, the proposal and reweighting, then the
backward step over every pair of the previous and the new particles):

* forward: the frame (``k1_frame.FRAME_OPS``), the model's body without
  its statistic (``BODY_OPS - STAT_OPS`` of ``<body>_body.py``) and one
  standard normal a noise dimension (``k1_frame.RNG_OPS``);
* N pairs: the model's transition log-density (``TRANSITION_OPS``), its
  sum with the previous weight (1), the max, shift and exponential (3),
  and the float64 prefix sum, division and rounding of the backward CDF
  (3, float64 counted at the float32 rate as in ``k1_frame``);
* ``n_tilde`` backward draws: the search (``log2 N + 1`` compares, as
  ``resample_apply.ops``), the statistic (``STAT_OPS``), its scaling and
  its sum with the ancestor's statistic (2 H);
* the mean over the draws (H).

The prior's score and the Langevin update are not counted, so the share
is a lower bound.  The counts of a Poyiadjis O(N) step are
``step.py``'s."""
from . import k1_frame

PAIR_OPS = 1 + 3 + 3


def ops_per_particle_step(body, N, Z, n_tilde, H):
    """``body``: the model's ``<body>_body`` count module."""
    forward = (k1_frame.FRAME_OPS + body.BODY_OPS - body.STAT_OPS
               + Z * k1_frame.RNG_OPS)
    pairs = N * (body.TRANSITION_OPS + PAIR_OPS)
    draws = n_tilde * (N.bit_length() + 1 + body.STAT_OPS + 2 * H)
    return forward + pairs + draws + H


def ops(chain_steps, W, N, body, Z, n_tilde, H):
    """Operations of ``chain_steps`` SGLD steps (chains x iterations) of a
    ``W``-step window over ``N`` particles."""
    return chain_steps * W * N * ops_per_particle_step(body, N, Z, n_tilde,
                                                       H)

"""Float32 operations of the whole SGLD step per particle and window
step: the fused window's frame and the model's body (``k1_frame``,
``<body>_body``) and one standard normal per noise dimension
(``k1_frame.RNG_OPS``), whoever draws it.  The count is of the
algorithm's work from shapes: the same whether K1 or the unfused smoother
runs it.  The multinomial resampler's uniforms, the window layout, the
prior's score and the Langevin update (a few operations a chain) are not
counted, so the share is a lower bound."""
from . import k1_frame


def ops_per_particle_step(body_ops, Z=1):
    return k1_frame.FRAME_OPS + body_ops + Z * k1_frame.RNG_OPS


def ops(chain_steps, W, N, body_ops, Z=1):
    """Operations of ``chain_steps`` SGLD steps (chains x iterations) of a
    ``W``-step window over ``N`` particles."""
    return chain_steps * W * N * ops_per_particle_step(body_ops, Z)

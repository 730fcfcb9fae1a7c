"""sgmcmc_tpu_torch — the PyTorch / CUDA port of ``sgmcmc_tpu``.

Same package layout as the JAX package (``models/``, ``ops/``,
``inference/``, ``utils/``, ``metrics/``, ``evaluation/``, ``io/``), so
every module's counterpart sits at the same path.  Tensors carry an explicit leading chain axis, randomness comes from
an explicit ``torch.Generator``, and the fused buffered particle-smoother
window runs as a hand-written CUDA kernel (``ops/cuda/fused_pf.py``,
sources in ``csrc/``) when its inputs live on a CUDA device.

This package never imports JAX.
"""

__version__ = "0.1.0"

_EXPORTS = {
    "Sampler": "sgmcmc_tpu_torch.inference.samplers",
    "SVMSampler": "sgmcmc_tpu_torch.inference.samplers",
    "LGSSMSampler": "sgmcmc_tpu_torch.inference.samplers",
    "GARCHSampler": "sgmcmc_tpu_torch.inference.samplers",
    "SVJMSampler": "sgmcmc_tpu_torch.inference.samplers",
    "SeqSampler": "sgmcmc_tpu_torch.inference.samplers",
    "SeqSVMSampler": "sgmcmc_tpu_torch.inference.samplers",
    "SeqGARCHSampler": "sgmcmc_tpu_torch.inference.samplers",
    "SeqSVJMSampler": "sgmcmc_tpu_torch.inference.samplers",
    "SeqLGSSMSampler": "sgmcmc_tpu_torch.inference.samplers",
    "GaussHMMSampler": "sgmcmc_tpu_torch.inference.samplers",
    "ARPHMMSampler": "sgmcmc_tpu_torch.inference.samplers",
    "SeqGaussHMMSampler": "sgmcmc_tpu_torch.inference.samplers",
    "SeqARPHMMSampler": "sgmcmc_tpu_torch.inference.samplers",
    "pack_sequences": "sgmcmc_tpu_torch.inference.samplers",
    "sampler_for_model": "sgmcmc_tpu_torch.inference.samplers",
    "ModelAPI": "sgmcmc_tpu_torch.models.registry",
    "get_model": "sgmcmc_tpu_torch.models.registry",
    "BaseEvaluator": "sgmcmc_tpu_torch.evaluation.evaluator",
    "SamplerEvaluator": "sgmcmc_tpu_torch.evaluation.evaluator",
    "OfflineEvaluator": "sgmcmc_tpu_torch.evaluation.evaluator",
}

__all__ = ["__version__", *_EXPORTS]


def __getattr__(name):
    if name in _EXPORTS:
        import importlib
        return getattr(importlib.import_module(_EXPORTS[name]), name)
    raise AttributeError(
        f"module 'sgmcmc_tpu_torch' has no attribute {name!r}")


def __dir__():
    return sorted(__all__)

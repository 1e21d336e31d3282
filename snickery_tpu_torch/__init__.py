"""snickery_tpu_torch: the unit-selection synthesiser in PyTorch and CUDA.

A port of ``snickery_tpu`` (JAX, the reference) to PyTorch with kernels
written by hand for NVIDIA Hopper.  It imports ``torch`` and never ``jax``;
the jax-free modules of ``snickery_tpu`` (config, const, utils, voicedb,
oracle, io) are shared as they are.

Public API:
    from snickery_tpu_torch import Synthesiser, load_config
"""

from snickery_tpu.config import SnickeryConfig, load_config

__all__ = ["SnickeryConfig", "Synthesiser", "load_config"]


def __getattr__(name):
    # lazy: importing the package loads neither torch nor the kernels
    if name == "Synthesiser":
        from snickery_tpu_torch.synth import Synthesiser
        return Synthesiser
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

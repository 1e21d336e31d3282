"""snickery_tpu_torch: the unit-selection synthesiser in PyTorch and CUDA.

A port of ``snickery_tpu`` (JAX, the reference) to PyTorch with kernels
written by hand for NVIDIA Hopper.  It imports ``torch`` and never ``jax``,
and nothing of ``snickery_tpu``: the jax-free modules it needs (config,
const, utils, io, voicedb, oracle) are copies kept here with the same names,
file formats and numerics, so one config file and one ``.voicedb`` directory
serve both packages.

Public API:
    from snickery_tpu_torch import Synthesiser, load_config

Entry points: ``python -m snickery_tpu_torch.cli {synth,merge,info,serve}``
and ``python -m snickery_tpu_torch.server`` (console scripts
``snickery-torch`` and ``snickery-torch-serve``).
"""

from snickery_tpu_torch.config import SnickeryConfig, load_config

__all__ = ["SnickeryConfig", "Synthesiser", "load_config"]


def __getattr__(name):
    # lazy: importing the package loads neither torch nor the kernels
    if name == "Synthesiser":
        from snickery_tpu_torch.synth import Synthesiser
        return Synthesiser
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

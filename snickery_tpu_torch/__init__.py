"""snickery_tpu_torch: the unit-selection synthesiser in PyTorch and CUDA.

A port of ``snickery_tpu`` (JAX, the reference) to PyTorch with kernels
written by hand for NVIDIA Hopper.  It imports ``torch`` and never ``jax``,
and nothing of ``snickery_tpu``: the jax-free modules it needs (config,
const, utils, io, voicedb, oracle, the epoch detector and its C++ source)
are copies kept here with the same names, file formats and numerics, so one
config file and one ``.voicedb`` directory serve both packages.

Public API:
    from snickery_tpu_torch import Synthesiser, load_config, train_voice

Entry points: ``python -m snickery_tpu_torch.extract`` (a directory of
wavs to the pitchmark and stream files ``train`` reads), ``python -m
snickery_tpu_torch.cli {train,synth,evaluate,merge,info,serve}``, ``python
-m snickery_tpu_torch.server`` (console scripts ``snickery-torch`` and
``snickery-torch-serve``) and ``python -m
snickery_tpu_torch.bench_corpus_prep`` (the throughput of that front end).
"""

from snickery_tpu_torch.config import SnickeryConfig, load_config

__version__ = "0.1.0"

__all__ = ["SnickeryConfig", "Synthesiser", "__version__", "load_config", "train_voice"]


def __getattr__(name):
    # lazy: importing the package loads neither torch nor the kernels
    if name == "Synthesiser":
        from snickery_tpu_torch.synth import Synthesiser
        return Synthesiser
    if name == "train_voice":
        from snickery_tpu_torch.train import train_voice
        return train_voice
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

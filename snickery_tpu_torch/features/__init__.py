"""Acoustic feature extraction of the port, in PyTorch (and numpy / scipy
for the epochs), with the JAX package's ``snickery_tpu.features`` exports:

- ``stft``:      fixed-rate framing, windowed rfft / irfft (``torch.fft``)
- ``mel``:       mel filterbank, log-mel spectrogram, MFCC
- ``magphase``:  pitch-synchronous mag / real / imag / lf0 analysis and
                 resynthesis
- ``world``:     mgc / bap / lf0 analysis, fixed-rate <-> epoch-rate resampling
- ``epochs``:    pitch epoch (GCI) detection and f0 tracking
- ``smoothing``: join smoothing of a feature trajectory

The entry points take ``device`` ("cuda" by default, raising where CUDA is
absent; "cpu" runs the same code on the host).
"""

from snickery_tpu_torch.features.stft import frame_signal, stft, stft_mag, istft, hann
from snickery_tpu_torch.features.mel import mel_filterbank, mfcc, log_mel_spectrogram
from snickery_tpu_torch.features.magphase import (
    magphase_analysis,
    magphase_synthesis,
)
from snickery_tpu_torch.features.epochs import (
    detect_epochs, detect_epochs_batch, f0_from_epochs)
from snickery_tpu_torch.features.smoothing import smooth_joins

__all__ = [
    "frame_signal", "stft", "stft_mag", "istft", "hann",
    "mel_filterbank", "mfcc", "log_mel_spectrogram",
    "magphase_analysis", "magphase_synthesis",
    "detect_epochs", "detect_epochs_batch", "f0_from_epochs",
    "smooth_joins",
]

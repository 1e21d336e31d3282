"""Mel filterbank, log-mel spectrogram and MFCC in PyTorch.

Counterpart of ``snickery_tpu/features/mel.py``: the filterbank and DCT
matrices are the same numpy code (equal bit for bit).  The spectrogram, the
filterbank and the DCT run in float64 from the f32 wave to the f32 output,
for the reason features/magphase.py gives (in f32 a weak band is set by the
transform's rounding noise, so two f32 analyses differ there at random).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from snickery_tpu_torch.features.stft import as_f32, frame_signal, hann


def _hz_to_mel(f):
    return 2595.0 * np.log10(1.0 + np.asarray(f) / 700.0)


def _mel_to_hz(m):
    return 700.0 * (10.0 ** (np.asarray(m) / 2595.0) - 1.0)


@functools.lru_cache(maxsize=32)
def mel_filterbank(
    n_mels: int,
    n_fft: int,
    sample_rate: int,
    fmin: float = 0.0,
    fmax: float | None = None,
) -> np.ndarray:
    """Triangular mel filterbank -> (n_fft//2+1, n_mels) float32 matrix."""
    fmax = fmax or sample_rate / 2.0
    n_bins = n_fft // 2 + 1
    mel_pts = np.linspace(_hz_to_mel(fmin), _hz_to_mel(fmax), n_mels + 2)
    hz_pts = _mel_to_hz(mel_pts)
    bin_freqs = np.linspace(0.0, sample_rate / 2.0, n_bins)
    fb = np.zeros((n_bins, n_mels), dtype=np.float32)
    for m in range(n_mels):
        lo, ctr, hi = hz_pts[m], hz_pts[m + 1], hz_pts[m + 2]
        up = (bin_freqs - lo) / max(ctr - lo, 1e-8)
        down = (hi - bin_freqs) / max(hi - ctr, 1e-8)
        fb[:, m] = np.maximum(0.0, np.minimum(up, down))
    # Slaney-style area normalisation keeps levels comparable across bands.
    enorm = 2.0 / (hz_pts[2:] - hz_pts[:-2])
    fb *= enorm[None, :].astype(np.float32)
    return fb


@functools.lru_cache(maxsize=32)
def dct_matrix(n_mels: int, n_ceps: int) -> np.ndarray:
    """Orthonormal DCT-II -> (n_mels, n_ceps) float32 matrix."""
    k = np.arange(n_ceps)[None, :]
    n = np.arange(n_mels)[:, None]
    mat = np.cos(np.pi * k * (2 * n + 1) / (2 * n_mels))
    mat *= np.sqrt(2.0 / n_mels)
    mat[:, 0] *= np.sqrt(0.5)
    return mat.astype(np.float32)


def log_mel_spectrogram(
    wave,
    sample_rate: int,
    n_mels: int = 80,
    frame_len: int = 400,
    hop: int = 160,
    n_fft: int = 512,
    floor_db: float | None = None,
    device="cuda",
) -> torch.Tensor:
    """(n_frames, n_mels) log-mel energies on ``device``.

    ``floor_db``: clamp band energies at ``max(mel) * 10^(-floor_db/10)``
    (a relative floor) instead of the absolute 1e-10; the evaluation metrics
    need it (see evaluate.py)."""
    return _log_mel64(wave, sample_rate, n_mels, frame_len, hop, n_fft, floor_db,
                      device).float()


def _log_mel64(wave, sample_rate, n_mels, frame_len, hop, n_fft, floor_db,
               device) -> torch.Tensor:
    """:func:`log_mel_spectrogram` in float64."""
    x = as_f32(wave, device).double()
    spec = torch.fft.rfft(frame_signal(x, frame_len, hop) * hann(frame_len, x.dtype, x.device),
                          n=n_fft, dim=-1)
    power = spec.real ** 2 + spec.imag ** 2
    fb = torch.from_numpy(mel_filterbank(n_mels, n_fft, sample_rate)).to(power)
    mel = power @ fb
    if floor_db is None:
        return torch.log(torch.clamp(mel, min=1e-10))
    floor = torch.clamp(mel.max() * 10.0 ** (-floor_db / 10.0), min=1e-30)
    return torch.log(torch.maximum(mel, floor))


def mfcc(
    wave,
    sample_rate: int,
    n_ceps: int = 13,
    n_mels: int = 40,
    frame_len: int = 400,
    hop: int = 160,
    n_fft: int = 512,
    floor_db: float | None = None,
    device="cuda",
) -> torch.Tensor:
    """(n_frames, n_ceps) MFCCs on ``device`` (``floor_db``: see
    :func:`log_mel_spectrogram`)."""
    logmel = _log_mel64(wave, sample_rate, n_mels, frame_len, hop, n_fft, floor_db, device)
    return (logmel @ torch.from_numpy(dct_matrix(n_mels, n_ceps)).to(logmel)).float()

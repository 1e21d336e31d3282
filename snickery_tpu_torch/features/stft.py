"""Fixed-rate framing, STFT and inverse STFT in PyTorch.

Counterpart of ``snickery_tpu/features/stft.py``: the same windows, tail
padding and Hann-squared COLA normalisation.  :func:`stft` returns a complex
tensor (the JAX package's rule against fetching complex arrays was a fault
of its TPU runtime).  The entry points take ``device`` ("cuda" by default;
it raises where CUDA is absent); :func:`frame_signal` follows its input.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from snickery_tpu_torch.features.dft import irdft, rdft
from snickery_tpu_torch.utils import torch_device


def as_f32(x, device) -> torch.Tensor:
    """A float32 tensor of ``x`` (array or tensor) on ``device``."""
    dev = torch_device(device)
    if not isinstance(x, torch.Tensor):
        x = np.asarray(x, dtype=np.float32)
        x = torch.from_numpy(x if x.flags.writeable else x.copy())
    return x.to(device=dev, dtype=torch.float32)


def hann(length: int, dtype=torch.float32, device="cuda") -> torch.Tensor:
    """Periodic Hann window (OLA-COLA)."""
    n = torch.arange(length, dtype=dtype, device=torch_device(device))
    return 0.5 - 0.5 * torch.cos(2.0 * math.pi * n / length)


def hann_symmetric(length: int, dtype=torch.float32, device="cuda") -> torch.Tensor:
    """Symmetric Hann (np.hanning): the unit tapers' window."""
    dev = torch_device(device)
    if length == 1:
        return torch.ones(1, dtype=dtype, device=dev)
    n = torch.arange(length, dtype=dtype, device=dev)
    return 0.5 - 0.5 * torch.cos(2.0 * math.pi * n / (length - 1))


def frame_signal(wave: torch.Tensor, frame_len: int, hop: int) -> torch.Tensor:
    """Slice ``wave`` (n,) into overlapping frames -> (n_frames, frame_len),
    the tail zero-padded so that every sample is covered."""
    n = wave.shape[0]
    n_frames = max(1, int(np.ceil(max(n - frame_len, 0) / hop)) + 1)
    wave = torch.nn.functional.pad(wave, (0, (n_frames - 1) * hop + frame_len - n))
    idx = (torch.arange(n_frames, device=wave.device)[:, None] * hop
           + torch.arange(frame_len, device=wave.device)[None, :])
    return wave[idx]


def stft(wave, frame_len: int, hop: int, n_fft: int | None = None,
         device="cuda") -> torch.Tensor:
    """STFT -> complex (n_frames, n_fft//2 + 1) on ``device``."""
    wave = as_f32(wave, device)
    frames = frame_signal(wave, frame_len, hop) * hann(frame_len, wave.dtype, wave.device)
    re, im = rdft(frames, n_fft or frame_len)
    return torch.complex(re, im)


def stft_mag(wave, frame_len: int, hop: int, n_fft: int | None = None,
             device="cuda") -> torch.Tensor:
    """|STFT| -> float32 (n_frames, n_fft//2 + 1) on ``device``."""
    return stft(wave, frame_len, hop, n_fft, device).abs()


def istft(spec, frame_len: int, hop: int, n_samples: int, device="cuda") -> torch.Tensor:
    """Inverse STFT with Hann-squared COLA normalisation -> (n_samples,)."""
    if not isinstance(spec, torch.Tensor):
        spec = torch.from_numpy(np.array(spec, dtype=np.complex64))
    spec = spec.to(torch_device(device))
    frames = irdft(spec.real.float(), spec.imag.float(), frame_len)
    win = hann(frame_len, frames.dtype, frames.device)
    frames = frames * win
    n_frames = frames.shape[0]
    out_len = (n_frames - 1) * hop + frame_len
    idx = (torch.arange(n_frames, device=frames.device)[:, None] * hop
           + torch.arange(frame_len, device=frames.device)[None, :]).reshape(-1)
    out = torch.zeros(out_len, dtype=frames.dtype, device=frames.device)
    out.index_add_(0, idx, frames.reshape(-1))
    norm = torch.zeros_like(out).index_add_(0, idx, (win * win).expand(n_frames, -1).reshape(-1))
    out = out / torch.clamp(norm, min=1e-8)
    if out_len >= n_samples:
        return out[:n_samples]
    return torch.nn.functional.pad(out, (0, n_samples - out_len))

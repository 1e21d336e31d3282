"""Real DFT and its inverse: thin wrappers on ``torch.fft``.

Counterpart of ``snickery_tpu/features/dft.py``, with the same signatures
and the same ``n_fft`` rule (zero-pad or truncate the last axis, as rfft's
``n=``).  The JAX package writes the transform as a matmul only because the
FFT's first execution on its TPU runtime paid a plan compile of minutes;
that matmul carries an absolute error of about 1e-5 * sqrt(N) * max|x| in
f32, which an FFT does not, so the port calls the FFT.

The products that follow the transforms (filterbanks, warps, DCTs) run in
float64 in the port, where a card's TF32 never applies.
"""

from __future__ import annotations

import torch


def rdft(frames: torch.Tensor, n_fft: int | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Real DFT of the last axis -> (re, im), each (..., n_fft//2 + 1)."""
    spec = torch.fft.rfft(frames, n=n_fft or frames.shape[-1], dim=-1)
    return spec.real, spec.imag


def irdft(re: torch.Tensor, im: torch.Tensor, n_fft: int) -> torch.Tensor:
    """Inverse of :func:`rdft` -> (..., n_fft) real frames."""
    assert re.shape[-1] == n_fft // 2 + 1, (re.shape, n_fft)
    return torch.fft.irfft(torch.complex(re, im), n=n_fft, dim=-1)


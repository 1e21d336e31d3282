"""Magphase-style pitch-synchronous analysis and resynthesis in PyTorch.

Counterpart of ``snickery_tpu/features/magphase.py``: the same four streams
(``mag`` = mel-warped log magnitude, ``real`` / ``imag`` = mel-warped cos /
sin of the phase, ``lf0`` from the epoch grid), the same two-period frames
under an asymmetric Hann window, rotated so that the epoch sits at sample 0,
and the same windowed overlap-add in resynthesis.  The transform is
``torch.fft`` (see features/dft.py).  The analysis runs in float64 from the
f32 wave to its f32 streams: in f32 a weak band's value is set by the
transform's rounding noise (about 1e-7 of the frame's peak), so two f32
analyses (the JAX package's and this one, or the card's and the CPU's)
differ there at random, while in float64 every band is its own value.
Resynthesis runs in f32.  The overlap-add is ``index_add_``, which on a card
adds in no fixed order, so two runs there agree to f32 rounding, not bit for
bit.

The epoch axis is padded to a multiple of 128 by repeating the last epoch,
as the JAX package pads it for its compile buckets: that padding sets the
last real epoch's ``next_gap`` (to 1), so results depend on it.
"""

from __future__ import annotations

import numpy as np
import torch

from snickery_tpu_torch.features.dft import irdft, rdft
from snickery_tpu_torch.features.mel import mel_filterbank
from snickery_tpu_torch.features.stft import as_f32
from snickery_tpu_torch.utils import torch_device


def _warp_matrix(n_bins: int, n_out: int, sample_rate: int) -> np.ndarray:
    """Row-normalised mel warp (n_bins, n_out): averages FFT bins per band."""
    fb = mel_filterbank(n_out, (n_bins - 1) * 2, sample_rate).copy()
    col = fb.sum(axis=0, keepdims=True)
    return (fb / np.maximum(col, 1e-8)).astype(np.float32)


def _unwarp_matrix(n_bins: int, n_out: int, sample_rate: int) -> np.ndarray:
    """Pseudo-inverse warp (n_out, n_bins): spreads band values back to bins."""
    fb = mel_filterbank(n_out, (n_bins - 1) * 2, sample_rate).copy()
    row = fb.sum(axis=1, keepdims=True)
    return (fb / np.maximum(row, 1e-8)).T.astype(np.float32)


def bucket_epochs(epoch_samples: np.ndarray) -> np.ndarray:
    """The epochs padded to a multiple of 128 (at least 128) by repeating
    the last one, as the JAX package buckets them."""
    e = len(epoch_samples)
    ep = max(128, ((e + 127) // 128) * 128)
    return np.concatenate([epoch_samples, np.full(ep - e, epoch_samples[-1], np.int32)])


def _on(matrix: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """The (f32) matrix on ``like``'s device, in ``like``'s dtype."""
    return torch.from_numpy(matrix).to(device=like.device, dtype=like.dtype)


def _hann_ramps(rel: torch.Tensor, pg: torch.Tensor, ng: torch.Tensor) -> torch.Tensor:
    """Asymmetric Hann: a rising half-cosine over ``pg`` samples before the
    epoch, a falling one over ``ng`` after it."""
    left = 0.5 + 0.5 * torch.cos(torch.pi * torch.clamp(-rel / pg, 0.0, 1.0))
    right = 0.5 + 0.5 * torch.cos(torch.pi * torch.clamp(rel / ng, 0.0, 1.0))
    return torch.where(rel < 0, left, right)


def _epoch_frames(wave: torch.Tensor, epochs: torch.Tensor, prev_gap: torch.Tensor,
                  next_gap: torch.Tensor, frame_max: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Two-period frames centred at each epoch under the asymmetric Hann ->
    (windowed frames (E, frame_max), window (E, frame_max)), in the wave's
    dtype."""
    n, dt = wave.shape[0], wave.dtype
    offs = torch.arange(frame_max, dtype=torch.int64, device=wave.device) - frame_max // 2
    idx = epochs.long()[:, None] + offs[None, :]
    valid = (idx >= 0) & (idx < n)
    gathered = wave[torch.clamp(idx, 0, n - 1)]
    pg = torch.clamp(prev_gap[:, None].to(dt), min=1.0)
    ng = torch.clamp(next_gap[:, None].to(dt), min=1.0)
    win = _hann_ramps(offs[None, :].to(dt), pg, ng) * valid.to(dt)
    return gathered * win, win


def _gaps(e: torch.Tensor, first: torch.Tensor, last: torch.Tensor):
    """(prev_gap, next_gap) of the epochs ``e``, with ``first`` as the gap
    before the first epoch and ``last`` after the last, both at least 1."""
    prev_gap = torch.diff(e, prepend=(e[:1] - first))
    next_gap = torch.diff(e, append=(e[-1:] + last))
    return torch.clamp(prev_gap, min=1), torch.clamp(next_gap, min=1)


def magphase_analysis_frames(wave: torch.Tensor, epochs: torch.Tensor, frame_max: int,
                             n_fft: int, n_mag: int, n_phase: int,
                             sample_rate: int) -> dict[str, torch.Tensor]:
    """Batched analysis on the inputs' device, in float64: the f32 wave and
    epoch positions (E,) -> f32 mag (E, n_mag), real and imag (E, n_phase)."""
    e = epochs.to(torch.int32)
    if e.shape[0] > 1:
        first, last = e[1:2] - e[:1], e[-1:] - e[-2:-1]
    else:
        first = last = torch.full((1,), 64, dtype=torch.int32, device=e.device)
    prev_gap, next_gap = _gaps(e, first, last)
    frames, _ = _epoch_frames(wave.double(), e, prev_gap, next_gap, frame_max)
    # rotate the frame so that the epoch sits at sample 0: no linear phase
    # ramp, a slowly varying phase spectrum that survives band averaging
    half_pad = (n_fft - frame_max) // 2
    frames = torch.fft.ifftshift(torch.nn.functional.pad(frames, (half_pad, half_pad)), dim=-1)
    spec_re, spec_im = rdft(frames, n_fft)
    magnitude = torch.sqrt(spec_re * spec_re + spec_im * spec_im)
    n_bins = n_fft // 2 + 1
    warp_mag = _on(_warp_matrix(n_bins, n_mag, sample_rate), magnitude)
    warp_ph = _on(_warp_matrix(n_bins, n_phase, sample_rate), magnitude)
    mag = torch.log(torch.clamp(magnitude @ warp_mag, min=1e-8))
    inv_mag = 1.0 / torch.clamp(magnitude, min=1e-8)
    real = (spec_re * inv_mag) @ warp_ph
    imag = (spec_im * inv_mag) @ warp_ph
    return {"mag": mag.float(), "real": real.float(), "imag": imag.float()}


def frame_max_for(sample_rate: int, fmin: float) -> int:
    """Frame length: the power of two at or above two periods at ``fmin``."""
    return int(2 ** np.ceil(np.log2(2 * sample_rate / fmin)))


def magphase_analysis(
    wave: np.ndarray,
    epoch_samples: np.ndarray,
    sample_rate: int,
    n_mag: int = 60,
    n_phase: int = 45,
    fmin: float = 50.0,
    n_fft: int | None = None,
    device="cuda",
) -> dict[str, np.ndarray]:
    """Full analysis on ``device``: wave + epochs -> {mag, real, imag, lf0}
    numpy streams."""
    from snickery_tpu_torch.features.epochs import f0_from_epochs

    dev = torch_device(device)
    epoch_samples = np.asarray(epoch_samples, dtype=np.int32)
    if len(epoch_samples) == 0:
        return {
            "mag": np.zeros((0, n_mag), np.float32),
            "real": np.zeros((0, n_phase), np.float32),
            "imag": np.zeros((0, n_phase), np.float32),
            "lf0": np.zeros((0, 1), np.float32),
        }
    frame_max = frame_max_for(sample_rate, fmin)
    out = magphase_analysis_frames(
        as_f32(wave, dev), torch.from_numpy(bucket_epochs(epoch_samples)).to(dev),
        frame_max=frame_max, n_fft=n_fft or frame_max, n_mag=n_mag, n_phase=n_phase,
        sample_rate=sample_rate)
    e = len(epoch_samples)
    result = {k: v[:e].cpu().numpy() for k, v in out.items()}
    result["lf0"] = f0_from_epochs(epoch_samples, sample_rate, fmin=fmin)
    return result


def magphase_synthesis_frames(mag: torch.Tensor, real: torch.Tensor, imag: torch.Tensor,
                              epochs: torch.Tensor, frame_max: int, n_fft: int,
                              n_samples: int, sample_rate: int, wsum_floor: float = 0.3,
                              overlap: int = 0) -> torch.Tensor:
    """Resynthesise on the inputs' device: streams + target epoch grid ->
    waveform (n_samples,).  Spectra are un-warped to full resolution,
    inverse-transformed, windowed over the target epoch gaps (``overlap``
    extra periods a side) and overlap-added at the target epochs; samples
    whose summed window weight is under ``wsum_floor`` are attenuated
    rather than boosted.  The un-warp products run in float64, as the
    analysis' do (a card's TF32 never applies there)."""
    n_bins = n_fft // 2 + 1
    mag = mag.double()
    magnitude = torch.exp(mag @ _on(_unwarp_matrix(n_bins, mag.shape[-1], sample_rate),
                                    mag)).float()
    unwarp_ph = _on(_unwarp_matrix(n_bins, real.shape[-1], sample_rate), mag)
    re = (real.double() @ unwarp_ph).float()
    im = (imag.double() @ unwarp_ph).float()
    scale = magnitude / torch.sqrt(torch.clamp(re * re + im * im, min=1e-8))
    frames = irdft(re * scale, im * scale, n_fft)
    frames = torch.fft.fftshift(frames, dim=-1)[:, n_fft // 2 - frame_max // 2:
                                                n_fft // 2 + frame_max // 2]
    e = epochs.to(torch.int32)
    sixty_four = torch.full((1,), 64, dtype=torch.int32, device=e.device)
    prev_gap, next_gap = _gaps(e, sixty_four, sixty_four)
    offs = torch.arange(frame_max, dtype=torch.int64, device=e.device) - frame_max // 2
    win = _hann_ramps(offs[None, :].float(), prev_gap[:, None].float() * (1 + overlap),
                      next_gap[:, None].float() * (1 + overlap))
    idx = e.long()[:, None] + offs[None, :]
    valid = ((idx >= 0) & (idx < n_samples)).float()
    at = torch.clamp(idx, 0, n_samples - 1).reshape(-1)
    out = torch.zeros(n_samples, dtype=torch.float32, device=e.device)
    out.index_add_(0, at, (frames * win * valid).reshape(-1))
    wsum = torch.zeros_like(out).index_add_(0, at, (win * valid).reshape(-1))
    return out / torch.clamp(wsum, min=wsum_floor)


def magphase_synthesis(
    streams: dict[str, np.ndarray],
    sample_rate: int,
    target_lf0: np.ndarray | None = None,
    fmin: float = 50.0,
    n_samples: int | None = None,
    epoch_samples: np.ndarray | None = None,
    wsum_floor: float = 0.3,
    overlap: int = 0,
    device="cuda",
) -> np.ndarray:
    """Resynthesise a waveform from {mag, real, imag, lf0} streams on
    ``device``.

    The epoch grid is ``epoch_samples`` when given (copy-synthesis on the
    natural grid), else integrated from lf0 (``target_lf0``, when given,
    imposes the target's f0 contour on the streams' spectra)."""
    dev = torch_device(device)
    if epoch_samples is not None:
        epochs = np.asarray(epoch_samples, dtype=np.int64)
        if len(epochs) == 0:
            return np.zeros(0, np.float32)
        periods = np.diff(epochs, append=epochs[-1:] + 64).astype(np.float64)
    else:
        lf0 = np.asarray(target_lf0 if target_lf0 is not None else streams["lf0"])
        lf0 = lf0.reshape(-1)
        if len(lf0) == 0:
            return np.zeros(0, np.float32)
        periods = sample_rate / np.maximum(np.exp(lf0), 1e-3)
        periods = np.clip(periods, 2, 2 * sample_rate / fmin)
        epochs = np.cumsum(periods).astype(np.int64)
    total = int(epochs[-1] + periods[-1]) if n_samples is None else n_samples
    frame_max = frame_max_for(sample_rate, fmin)
    wave = magphase_synthesis_frames(
        *(as_f32(streams[s], dev) for s in ("mag", "real", "imag")),
        torch.from_numpy(epochs.astype(np.int32)).to(dev),
        frame_max=frame_max, n_fft=frame_max, n_samples=total, sample_rate=sample_rate,
        wsum_floor=wsum_floor, overlap=overlap)
    return wave.cpu().numpy()

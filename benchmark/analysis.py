"""Magphase analysis of many utterances at once on the device: a frozen,
batched torch copy of ``snickery_tpu_torch.features.magphase.
magphase_analysis`` and of ``features.epochs.f0_from_epochs``.

Every epoch of every utterance is one row: a two-period frame under the
asymmetric Hann window over its own utterance's samples, rotated so that the
epoch sits at sample 0, transformed in float64 and mel-warped into ``mag``
(log magnitude), ``real`` and ``imag`` (cos and sin of the phase).  Each
utterance's epoch axis is treated as the source pads it (a multiple of 128,
the last epoch repeated), which sets the last epoch's ``next_gap`` to 1
unless the count is a multiple of 128.  So each row equals the source's
analysis of that utterance alone (held so by ``benchmark/tests/test_harness_data.py``);
the port's bench groups utterances with silence between them instead, which
changes the first and last row of each.  ``lf0`` is the log of the
epoch-interval frequency, the last epoch repeating its predecessor's; the
generator's f0 stays within 80-140 Hz, inside the source's voiced range, so
the source's interpolation over unvoiced intervals never applies (checked).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

FMIN, FMAX = 50.0, 400.0


def _hz_to_mel(f):
    return 2595.0 * np.log10(1.0 + np.asarray(f) / 700.0)


def _mel_to_hz(m):
    return 700.0 * (10.0 ** (np.asarray(m) / 2595.0) - 1.0)


@functools.lru_cache(maxsize=8)
def mel_filterbank(n_mels: int, n_fft: int, sample_rate: int) -> np.ndarray:
    """Triangular, area-normalised mel filterbank (n_fft//2+1, n_mels) f32."""
    n_bins = n_fft // 2 + 1
    hz_pts = _mel_to_hz(np.linspace(_hz_to_mel(0.0), _hz_to_mel(sample_rate / 2.0), n_mels + 2))
    bin_freqs = np.linspace(0.0, sample_rate / 2.0, n_bins)
    fb = np.zeros((n_bins, n_mels), dtype=np.float32)
    for m in range(n_mels):
        lo, ctr, hi = hz_pts[m], hz_pts[m + 1], hz_pts[m + 2]
        up = (bin_freqs - lo) / max(ctr - lo, 1e-8)
        down = (hi - bin_freqs) / max(hi - ctr, 1e-8)
        fb[:, m] = np.maximum(0.0, np.minimum(up, down))
    fb *= (2.0 / (hz_pts[2:] - hz_pts[:-2]))[None, :].astype(np.float32)
    return fb


def warp_matrix(n_bins: int, n_out: int, sample_rate: int) -> np.ndarray:
    """Column-normalised mel warp (n_bins, n_out) f32: averages bins a band."""
    fb = mel_filterbank(n_out, (n_bins - 1) * 2, sample_rate).copy()
    return (fb / np.maximum(fb.sum(axis=0, keepdims=True), 1e-8)).astype(np.float32)


def frame_max_for(sample_rate: int, fmin: float = FMIN) -> int:
    return int(2 ** np.ceil(np.log2(2 * sample_rate / fmin)))


def epoch_gaps(utt: torch.Tensor, pos: torch.Tensor):
    """(prev_gap, next_gap) int64 of epochs given as (utterance, sample)
    pairs in utterance then sample order (at least two an utterance), each
    utterance's axis padded as the source pads it."""
    n = pos.shape[0]
    dev = pos.device
    counts = torch.bincount(utt)
    first = torch.cumsum(counts, 0) - counts                 # row of each utterance's first epoch
    row = torch.arange(n, device=dev)
    k = row - first[utt]                                     # index within the utterance
    e_u = counts[utt]
    prev_gap = torch.empty_like(pos)
    next_gap = torch.empty_like(pos)
    prev_gap[1:] = pos[1:] - pos[:-1]
    next_gap[:-1] = pos[1:] - pos[:-1]
    start, last = k == 0, k == e_u - 1
    # the gap before an utterance's first epoch is its second gap
    nxt = torch.clamp(row + 1, max=n - 1)
    prev_gap = torch.where(start, pos[nxt] - pos, prev_gap)
    # after the last: the padding's 0 gap, or the last real gap when the
    # count is a multiple of 128 (no padding)
    prv = torch.clamp(row - 1, min=0)
    next_gap = torch.where(last, torch.where(e_u % 128 == 0, pos - pos[prv],
                                             torch.zeros_like(pos)), next_gap)
    return torch.clamp(prev_gap, min=1), torch.clamp(next_gap, min=1)


def magphase_rows(waves: torch.Tensor, utt: torch.Tensor, pos: torch.Tensor,
                  sample_rate: int, n_mag: int = 60, n_phase: int = 45) -> torch.Tensor:
    """(E, n_mag + 2 n_phase) f32 [mag | real | imag] of the epochs (utterance
    ``utt``, sample ``pos``) of ``waves`` (n_utts, n) f32."""
    frame_max = frame_max_for(sample_rate)
    n = waves.shape[1]
    prev_gap, next_gap = epoch_gaps(utt, pos)
    offs = torch.arange(frame_max, dtype=torch.int64, device=pos.device) - frame_max // 2
    idx = pos[:, None] + offs[None, :]
    valid = (idx >= 0) & (idx < n)
    flat = waves.reshape(-1).double()
    gathered = flat[utt[:, None] * n + torch.clamp(idx, 0, n - 1)]
    rel = offs[None, :].double()
    pg = prev_gap[:, None].double()
    ng = next_gap[:, None].double()
    left = 0.5 + 0.5 * torch.cos(torch.pi * torch.clamp(-rel / pg, 0.0, 1.0))
    right = 0.5 + 0.5 * torch.cos(torch.pi * torch.clamp(rel / ng, 0.0, 1.0))
    frames = gathered * torch.where(rel < 0, left, right) * valid.double()
    spec = torch.fft.rfft(torch.fft.ifftshift(frames, dim=-1), n=frame_max, dim=-1)
    spec_re, spec_im = spec.real, spec.imag
    magnitude = torch.sqrt(spec_re * spec_re + spec_im * spec_im)
    n_bins = frame_max // 2 + 1

    def on(m):
        return torch.from_numpy(m).to(device=magnitude.device, dtype=torch.float64)

    warp_mag = on(warp_matrix(n_bins, n_mag, sample_rate))
    warp_ph = on(warp_matrix(n_bins, n_phase, sample_rate))
    mag = torch.log(torch.clamp(magnitude @ warp_mag, min=1e-8))
    inv = 1.0 / torch.clamp(magnitude, min=1e-8)
    real = (spec_re * inv) @ warp_ph
    imag = (spec_im * inv) @ warp_ph
    return torch.cat([mag.float(), real.float(), imag.float()], dim=1)


def lf0_rows(utt: torch.Tensor, pos: torch.Tensor, sample_rate: int) -> torch.Tensor:
    """(E, 1) f32 log-f0 of each epoch from its interval to the next (the
    last epoch of an utterance takes its predecessor's).  Raises where an
    interval lies outside the source's voiced range."""
    n = pos.shape[0]
    row = torch.arange(n, device=pos.device)
    same_next = torch.zeros(n, dtype=torch.bool, device=pos.device)
    same_next[:-1] = utt[1:] == utt[:-1]
    ival = torch.zeros(n, dtype=torch.float64, device=pos.device)
    ival[:-1] = (pos[1:] - pos[:-1]).double()
    src = torch.where(same_next, row, torch.clamp(row - 1, min=0))
    freq = sample_rate / torch.clamp(ival[src], min=1.0)
    if not bool(((freq >= FMIN) & (freq <= FMAX)).all()):
        raise ValueError("an epoch interval lies outside the voiced range")
    return torch.log(torch.clamp(freq, min=1e-3)).float()[:, None]

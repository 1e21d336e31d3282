"""A float64 numpy analysis of the epoch frames, and the two rules that hold
an f32 analysis to it (numpy only: no jax, no torch).

The frames are those of ``features/magphase.py`` and ``features/world.py``
(the same epochs, bucketed to a multiple of 128 by repeating the last one,
the same gaps, asymmetric Hann and rotation); the transform is ``np.fft`` in
float64 and the warps, filterbanks and DCTs are the packages' f32 matrices
applied in float64.

- **Rule (a), agreement on strong bands**: two f32 analyses agree within
  ``RULE_A_ATOL`` on the bands within ``STRONG_NATS`` of their frame's
  strongest band in the float64 analysis (for ``real`` / ``imag`` the
  strength is the log of the magnitude warped by the phase warp), beyond
  what the reference analysis itself misses the float64 one by there.
- **Rule (b), accuracy elsewhere**: an analysis is no farther from the
  float64 one than a reference analysis is, in max and in p99.
"""

from __future__ import annotations

import numpy as np
from scipy.ndimage import maximum_filter1d, minimum_filter1d

RULE_A_ATOL = 1e-3
STRONG_NATS = 6.0


def _mel_filterbank(n_mels, n_fft, sample_rate):
    fmax = sample_rate / 2.0
    n_bins = n_fft // 2 + 1
    hz_to_mel = lambda f: 2595.0 * np.log10(1.0 + np.asarray(f) / 700.0)   # noqa: E731
    mel_pts = np.linspace(hz_to_mel(0.0), hz_to_mel(fmax), n_mels + 2)
    hz_pts = 700.0 * (10.0 ** (mel_pts / 2595.0) - 1.0)
    bin_freqs = np.linspace(0.0, sample_rate / 2.0, n_bins)
    fb = np.zeros((n_bins, n_mels), dtype=np.float32)
    for m in range(n_mels):
        lo, ctr, hi = hz_pts[m], hz_pts[m + 1], hz_pts[m + 2]
        up = (bin_freqs - lo) / max(ctr - lo, 1e-8)
        down = (hi - bin_freqs) / max(hi - ctr, 1e-8)
        fb[:, m] = np.maximum(0.0, np.minimum(up, down))
    fb *= (2.0 / (hz_pts[2:] - hz_pts[:-2]))[None, :].astype(np.float32)
    return fb


def warp(n_bins, n_out, sample_rate):
    fb = _mel_filterbank(n_out, (n_bins - 1) * 2, sample_rate)
    return (fb / np.maximum(fb.sum(axis=0, keepdims=True), 1e-8)).astype(np.float32)


def dct(n_mels, n_ceps):
    k = np.arange(n_ceps)[None, :]
    n = np.arange(n_mels)[:, None]
    mat = np.cos(np.pi * k * (2 * n + 1) / (2 * n_mels)) * np.sqrt(2.0 / n_mels)
    mat[:, 0] *= np.sqrt(0.5)
    return mat.astype(np.float32)


def _frames(wave, epochs, frame_max, first, last):
    e = np.asarray(epochs, np.int64)
    n_e = len(e)
    ep = max(128, ((n_e + 127) // 128) * 128)
    e = np.concatenate([e, np.full(ep - n_e, e[-1])])
    prev_gap = np.maximum(np.diff(e, prepend=e[0] - first), 1)
    next_gap = np.maximum(np.diff(e, append=e[-1] + last), 1)
    offs = np.arange(frame_max) - frame_max // 2
    idx = e[:, None] + offs[None, :]
    n = len(wave)
    valid = (idx >= 0) & (idx < n)
    gathered = np.asarray(wave, np.float64)[np.clip(idx, 0, n - 1)]
    rel = offs[None, :].astype(np.float64)
    pg = np.maximum(prev_gap[:, None], 1.0)
    ng = np.maximum(next_gap[:, None], 1.0)
    left = 0.5 + 0.5 * np.cos(np.pi * np.clip(-rel / pg, 0.0, 1.0))
    right = 0.5 + 0.5 * np.cos(np.pi * np.clip(rel / ng, 0.0, 1.0))
    return (gathered * np.where(rel < 0, left, right) * valid)[:n_e]


def frame_max_for(sample_rate, fmin=50.0):
    return int(2 ** np.ceil(np.log2(2 * sample_rate / fmin)))


def magphase64(wave, epochs, sample_rate, n_mag=60, n_phase=45, fmin=50.0):
    """{mag, real, imag} in float64, and ``strength_ph``: the log of the
    magnitude under the phase warp (rule (a)'s mask for real / imag)."""
    fm = frame_max_for(sample_rate, fmin)
    e = np.asarray(epochs, np.int64)
    first, last = (e[1] - e[0], e[-1] - e[-2]) if len(e) > 1 else (64, 64)
    frames = np.fft.ifftshift(_frames(wave, e, fm, first, last), axes=-1)
    spec = np.fft.rfft(frames, axis=-1)
    mag = np.abs(spec)
    n_bins = fm // 2 + 1
    w_mag, w_ph = warp(n_bins, n_mag, sample_rate), warp(n_bins, n_phase, sample_rate)
    unit = spec / np.maximum(mag, 1e-8)
    return {"mag": np.log(np.maximum(mag @ w_mag, 1e-8)), "real": unit.real @ w_ph,
            "imag": unit.imag @ w_ph, "strength_ph": np.log(np.maximum(mag @ w_ph, 1e-8))}


def world64(wave, epochs, sample_rate, n_mgc=60, n_bap=5, fmin=50.0, halfwidth=8):
    """{mgc, bap, logmel} in float64 (``logmel``: the warped log magnitude
    that the DCT reads)."""
    fm = frame_max_for(sample_rate, fmin)
    power = np.abs(np.fft.rfft(_frames(wave, epochs, fm, 64, 64), axis=-1)) ** 2
    n_bins = power.shape[1]
    logmel = 0.5 * np.log(np.maximum(power @ warp(n_bins, max(2 * n_mgc, 40), sample_rate),
                                     1e-16))
    upper = maximum_filter1d(power, 2 * halfwidth + 1, axis=1, mode="constant", cval=-np.inf)
    lower = minimum_filter1d(power, 2 * halfwidth + 1, axis=1, mode="constant", cval=np.inf)
    ratio = np.clip(lower / np.maximum(upper, 1e-16), 1e-5, 1.0)
    edges = np.linspace(0, n_bins, n_bap + 1).astype(int)
    bands = np.zeros((n_bins, n_bap))
    for b in range(n_bap):
        lo, hi = edges[b], max(edges[b + 1], edges[b] + 1)
        bands[lo:hi, b] = 1.0 / (hi - lo)
    return {"mgc": logmel @ dct(logmel.shape[1], n_mgc), "bap": 0.5 * np.log(ratio) @ bands,
            "logmel": logmel}


def log_mel64(wave, sample_rate, n_mels=80, frame_len=400, hop=160, n_fft=512,
              floor_db=None):
    """The log-mel spectrogram of ``features/mel.py`` in float64."""
    x = np.asarray(wave, np.float64)
    n = len(x)
    n_frames = max(1, int(np.ceil(max(n - frame_len, 0) / hop)) + 1)
    x = np.pad(x, (0, (n_frames - 1) * hop + frame_len - n))
    idx = np.arange(n_frames)[:, None] * hop + np.arange(frame_len)[None, :]
    win = 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(frame_len) / frame_len)
    power = np.abs(np.fft.rfft(x[idx] * win, n=n_fft, axis=-1)) ** 2
    mel = power @ _mel_filterbank(n_mels, n_fft, sample_rate).astype(np.float64)
    floor = 1e-10 if floor_db is None else max(mel.max() * 10.0 ** (-floor_db / 10.0), 1e-30)
    return np.log(np.maximum(mel, floor))


def strong(strength: np.ndarray, nats: float = STRONG_NATS) -> np.ndarray:
    """Bands within ``nats`` of their frame's strongest band."""
    return strength >= strength.max(axis=1, keepdims=True) - nats


def rule_a(got, want, mask, truth=None, atol: float = RULE_A_ATOL) -> float:
    """Max |got - want| on ``mask``; raises AssertionError above ``atol``.

    With ``truth`` (the float64 analysis) the allowance at each entry is
    ``atol`` plus how far ``want`` itself is from the truth there: the JAX
    package's matmul DFT misses the float64 analysis by up to a few 1e-3 on
    some strong real / imag bands, and an exact analysis cannot be nearer to
    it than that.  Returns the largest excess over ``atol`` alone."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    d = np.abs(got - want)
    allow = atol + (np.abs(want - truth) if truth is not None else 0.0)
    bad = (d > allow) & mask
    assert not bad.any(), (
        f"rule (a): {int(bad.sum())} strong-band entries beyond the allowance, worst "
        f"{float((d - allow)[mask].max()):.3e} over")
    return float(d[mask].max()) if mask.any() else 0.0


def distances(x, ref) -> tuple[float, float]:
    """(max, p99) of |x - ref| over every entry."""
    d = np.abs(np.asarray(x, np.float64) - ref)
    return float(d.max()), float(np.percentile(d, 99))


def rule_b(got, reference, truth, slack: float = 0.0) -> tuple:
    """Distances of ``got`` and ``reference`` from ``truth``; raises
    AssertionError where ``got`` is farther in max or in p99 (beyond
    ``slack``, a relative allowance)."""
    dg, dr = distances(got, truth), distances(reference, truth)
    assert dg[0] <= dr[0] * (1 + slack) and dg[1] <= dr[1] * (1 + slack), (
        f"rule (b): max / p99 {dg} farther than the reference's {dr}")
    return dg, dr

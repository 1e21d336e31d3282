"""Objective quality evaluation of the port.

Counterpart of ``snickery_tpu/evaluate.py``, with the same parameters and
the same numpy code around the spectra (speech mask, DTW, NSIM map, f0
pairing): mel-cepstral distortion (MCD) between synthesised and reference
audio with DTW alignment, the NSIM neurogram similarity, the prosody trio
VDE / GPE / FFE, and a join-discontinuity measure (spectral flux at unit
boundaries against flux within units).  The spectra (MFCC, mel neurogram,
STFT magnitude) are computed in PyTorch on ``device`` ("cuda" by default;
it raises where CUDA is absent).
"""

from __future__ import annotations

import numpy as np
import torch

from snickery_tpu_torch.features.mel import mfcc

_MCD_CONST = 10.0 / np.log(10.0) * np.sqrt(2.0)
# MCD analysis parameters (the JAX package's): a long window (64 ms) and wide
# mel bands (25) integrate several harmonics a band, and a relative -60 dB
# band floor stops empty between-harmonic bands flipping to the numerical
# floor
_MCD_FRAME = 1024
_MCD_HOP = 256
_MCD_NMELS = 25
_MCD_FLOOR_DB = 60.0
_NSIM_NMELS = 32


def _mfcc(wave: np.ndarray, sr: int, n_ceps: int = 13, device="cuda") -> np.ndarray:
    return mfcc(np.asarray(wave, np.float32), sr, n_ceps=n_ceps, n_mels=_MCD_NMELS,
                frame_len=_MCD_FRAME, hop=_MCD_HOP, n_fft=_MCD_FRAME,
                floor_db=_MCD_FLOOR_DB, device=device).cpu().numpy()


def dtw_path(cost: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """DTW over a frame-distance matrix -> aligned index pairs.

    Anti-diagonal sweep: every cell (i, j) on diagonal s = i + j depends
    only on diagonals s-1 (up, left) and s-2 (diag), so each diagonal is one
    numpy slice-min; the backtrack breaks ties diag, up, left.
    """
    t1, t2 = cost.shape
    acc = np.full((t1 + 1, t2 + 1), np.inf)
    acc[0, 0] = 0.0
    for s in range(2, t1 + t2 + 1):
        i_lo = max(1, s - t2)
        i_hi = min(t1, s - 1)
        if i_lo > i_hi:
            continue
        i = np.arange(i_lo, i_hi + 1)
        j = s - i
        best = np.minimum(acc[i - 1, j - 1],
                          np.minimum(acc[i - 1, j], acc[i, j - 1]))
        acc[i, j] = cost[i - 1, j - 1] + best
    # backtrack
    i, j = t1, t2
    path_i, path_j = [], []
    while i > 0 and j > 0:
        path_i.append(i - 1)
        path_j.append(j - 1)
        choices = (acc[i - 1, j - 1], acc[i - 1, j], acc[i, j - 1])
        step = int(np.argmin(choices))
        if step == 0:
            i, j = i - 1, j - 1
        elif step == 1:
            i -= 1
        else:
            j -= 1
    return np.asarray(path_i[::-1]), np.asarray(path_j[::-1])


def _speech_mask(wave: np.ndarray, n_frames: int,
                 frame_len: int = _MCD_FRAME, hop: int = _MCD_HOP,
                 floor_db: float = 40.0) -> np.ndarray:
    """(n_frames,) bool: frames whose RMS is within floor_db of the peak
    (MCD is computed over speech frames only: in silences the log-mel
    energies sit at the floor and their swings drown the envelope)."""
    n = len(wave)
    rms = np.empty(n_frames, np.float32)
    for t in range(n_frames):
        seg = wave[t * hop: min(t * hop + frame_len, n)]
        rms[t] = np.sqrt(np.mean(seg * seg)) if len(seg) else 0.0
    peak = rms.max() if n_frames else 0.0
    if peak <= 0:
        return np.zeros(n_frames, bool)
    return rms > peak * 10.0 ** (-floor_db / 20.0)


def mel_cepstral_distortion(synth_wave: np.ndarray, ref_wave: np.ndarray, sr: int,
                            n_ceps: int = 13, device="cuda") -> float:
    """MCD (dB) between two waveforms: speech frames only (see
    :func:`_speech_mask`), DTW-aligned, c0 (energy) excluded."""
    a = _mfcc(synth_wave, sr, n_ceps, device)
    b = _mfcc(ref_wave, sr, n_ceps, device)
    a = a[_speech_mask(np.asarray(synth_wave, np.float32), len(a))][:, 1:]
    b = b[_speech_mask(np.asarray(ref_wave, np.float32), len(b))][:, 1:]
    if len(a) < 2 or len(b) < 2:
        return float("nan")
    cost = np.sqrt(((a[:, None, :] - b[None, :, :]) ** 2).sum(-1))
    pi, pj = dtw_path(cost)
    diff = a[pi] - b[pj]
    return float(_MCD_CONST * np.mean(np.sqrt((diff ** 2).sum(-1))))


def _neurogram(wave: np.ndarray, sr: int, device="cuda") -> np.ndarray:
    """(frames, 32) peak-normalised mel-magnitude 'neurogram' on the MCD
    analysis grid (magnitude, power^0.5, not log with a floor: a floor makes
    NSIM a cliff on harmonic material).  The filterbank product runs in
    float64, as the analysis' do (a card's TF32 never applies there)."""
    from snickery_tpu_torch.features.mel import mel_filterbank
    from snickery_tpu_torch.features.stft import stft

    power = (stft(wave, _MCD_FRAME, _MCD_HOP, _MCD_FRAME, device).abs() ** 2).double()
    mel = (power @ torch.from_numpy(mel_filterbank(_NSIM_NMELS, _MCD_FRAME, sr)).to(power)).float()
    return torch.sqrt(mel / torch.clamp(mel.max(), min=1e-30)).cpu().numpy()


def _gauss_blur_3x3(x: np.ndarray) -> np.ndarray:
    """Separable 3x3 Gaussian (sigma=0.5) moving window, edge-replicated."""
    w = np.exp(-0.5 * (np.arange(-1, 2) / 0.5) ** 2)
    w /= w.sum()
    p = np.pad(x, 1, mode="edge")
    x = w[0] * p[:-2, 1:-1] + w[1] * p[1:-1, 1:-1] + w[2] * p[2:, 1:-1]
    p = np.pad(x, ((0, 0), (1, 1)), mode="edge")
    return w[0] * p[:, :-2] + w[1] * p[:, 1:-1] + w[2] * p[:, 2:]


def nsim(synth_wave: np.ndarray, ref_wave: np.ndarray, sr: int, device="cuda") -> float:
    """Neurogram similarity (NSIM, the ViSQOL similarity kernel), ~[0, 1].

    32-band normalised mel-magnitude neurograms on the MCD grid, speech
    frames only, DTW-aligned, then the NSIM map
        l(r,d) * s(r,d) = (2 mu_r mu_d + C1)/(mu_r^2 + mu_d^2 + C1)
                        * (cov_rd + C2)/(sigma_r sigma_d + C2)
    with 3x3 Gaussian moving-window moments and the ViSQOL constants
    C1 = (0.01 L)^2, C2 = (0.03 L)^2 / 2 for reference dynamic range L.
    1.0 = identical neurograms; uncorrelated noise scores near 0.
    """
    d = _neurogram(synth_wave, sr, device)
    r = _neurogram(ref_wave, sr, device)
    d = d[_speech_mask(np.asarray(synth_wave, np.float32), len(d))]
    r = r[_speech_mask(np.asarray(ref_wave, np.float32), len(r))]
    if len(d) < 2 or len(r) < 2:
        return float("nan")
    cost = np.sqrt(((d[:, None, :] - r[None, :, :]) ** 2).sum(-1))
    pi, pj = dtw_path(cost)
    d, r = d[pi], r[pj]
    lum_range = float(r.max() - r.min())
    if lum_range <= 0:
        return float("nan")
    c1 = (0.01 * lum_range) ** 2
    c2 = (0.03 * lum_range) ** 2 / 2.0
    mu_d, mu_r = _gauss_blur_3x3(d), _gauss_blur_3x3(r)
    var_d = _gauss_blur_3x3(d * d) - mu_d * mu_d
    var_r = _gauss_blur_3x3(r * r) - mu_r * mu_r
    cov = _gauss_blur_3x3(d * r) - mu_d * mu_r
    sig = np.sqrt(np.maximum(var_d, 0.0) * np.maximum(var_r, 0.0))
    lum = (2.0 * mu_r * mu_d + c1) / (mu_r ** 2 + mu_d ** 2 + c1)
    struct = (cov + c2) / (sig + c2)
    return float(np.mean(lum * struct))


def f0_metrics(synth_wave: np.ndarray, ref_wave: np.ndarray, sr: int,
               device="cuda") -> dict:
    """The prosody-error trio between synthesised and reference audio:
    ``vde`` (voicing decision error), ``gpe`` (gross pitch error: both
    voiced, f0 off by more than 20%), ``ffe`` (their union) and
    ``f0_rmse_hz`` over both-voiced pairs.  Frames are aligned with the MFCC
    DTW of the MCD, then mapped to the 10 ms f0 grid by frame-centre time.
    """
    from snickery_tpu_torch.features.epochs import track_f0_autocorr

    sw = np.asarray(synth_wave, np.float32)
    rw = np.asarray(ref_wave, np.float32)
    f0a, ca, _ = track_f0_autocorr(sw, sr)
    f0b, cb, _ = track_f0_autocorr(rw, sr)
    a = _mfcc(sw, sr, device=device)
    b = _mfcc(rw, sr, device=device)
    if len(a) < 2 or len(b) < 2 or not len(f0a) or not len(f0b):
        return {"vde": float("nan"), "gpe": float("nan"),
                "ffe": float("nan"), "f0_rmse_hz": float("nan")}
    cost = np.sqrt(((a[:, None, 1:] - b[None, :, 1:]) ** 2).sum(-1))
    pi, pj = dtw_path(cost)
    # MFCC frame index -> nearest f0 frame (different hops; map via the
    # frame-centre sample position)
    ia = np.searchsorted(ca, pi * _MCD_HOP + _MCD_FRAME // 2)
    ib = np.searchsorted(cb, pj * _MCD_HOP + _MCD_FRAME // 2)
    ia = np.clip(ia, 0, len(f0a) - 1)
    ib = np.clip(ib, 0, len(f0b) - 1)
    # collapse duplicate (ia, ib) pairs introduced by the hop mismatch
    pairs = np.unique(np.stack([ia, ib], axis=1), axis=0)
    va = f0a[pairs[:, 0]]
    vb = f0b[pairs[:, 1]]
    voiced_a = va > 0
    voiced_b = vb > 0
    n = len(pairs)
    vde_mask = voiced_a != voiced_b
    both = voiced_a & voiced_b
    if both.any():
        rel = np.abs(va[both] - vb[both]) / vb[both]
        gpe_mask = rel > 0.20
        f0_rmse = float(np.sqrt(np.mean((va[both] - vb[both]) ** 2)))
        gpe = float(gpe_mask.sum()) / n
    else:
        gpe, f0_rmse = float("nan"), float("nan")
    vde = float(vde_mask.sum()) / n
    ffe = vde + (gpe if np.isfinite(gpe) else 0.0)
    return {"vde": vde, "gpe": gpe, "ffe": ffe, "f0_rmse_hz": f0_rmse}


def join_discontinuity(wave: np.ndarray, sr: int, join_samples: np.ndarray,
                       width: int = 256, device="cuda") -> dict:
    """Spectral flux at unit joins vs within units.

    Returns dict(boundary_flux, interior_flux, ratio); a ratio near 1 means
    joins are as smooth as natural frame-to-frame evolution.
    """
    from snickery_tpu_torch.features.stft import stft_mag

    hop = width // 2
    spec = stft_mag(np.asarray(wave, np.float32), width, hop, device=device).cpu().numpy()
    if len(spec) < 3:
        return {"boundary_flux": float("nan"), "interior_flux": float("nan"),
                "ratio": float("nan")}
    flux = np.sqrt(((np.diff(spec, axis=0)) ** 2).sum(-1))
    frame_of = np.clip(np.asarray(join_samples) // hop, 1, len(flux) - 1)
    is_boundary = np.zeros(len(flux), bool)
    is_boundary[frame_of - 1] = True
    is_boundary[np.clip(frame_of, 0, len(flux) - 1)] = True
    b = float(flux[is_boundary].mean()) if is_boundary.any() else float("nan")
    i = float(flux[~is_boundary].mean()) if (~is_boundary).any() else float("nan")
    return {"boundary_flux": b, "interior_flux": i,
            "ratio": b / i if i else float("nan")}

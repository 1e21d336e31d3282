"""Pitch epoch (GCI) detection and f0 tracking, in numpy and scipy.

A copy of ``snickery_tpu/features/epochs.py`` (numpy and scipy only, kept
here because the port imports nothing of the JAX package), with the same
names and numerics:

1. low-pass the signal to isolate the glottal pulse structure,
2. track f0 by normalised autocorrelation (frame-based),
3. place epoch marks at pitch-synchronous negative peaks within voiced
   regions, and at a constant default period through unvoiced regions.

``detect_epochs`` and ``detect_epochs_batch`` dispatch to the port's own
build of the C++ detector (``snickery_tpu_torch.native``) when it loads,
and fall back to this Python code when it does not (``use_native=False``
asks for the Python code).
"""

from __future__ import annotations

import numpy as np
from scipy import signal as sps


def _lowpass(wave: np.ndarray, sr: int, cutoff: float = 1000.0) -> np.ndarray:
    b, a = sps.butter(4, cutoff / (sr / 2.0), btype="low")
    return sps.filtfilt(b, a, wave).astype(np.float32)


def track_f0_autocorr(
    wave: np.ndarray,
    sr: int,
    fmin: float = 50.0,
    fmax: float = 400.0,
    frame_sec: float = 0.040,
    hop_sec: float = 0.010,
    voicing_threshold: float = 0.30,
) -> tuple[np.ndarray, np.ndarray, float]:
    """Frame-based f0 via normalised autocorrelation.

    Returns (f0_hz per frame [0 where unvoiced], frame centre samples, hop_sec).
    """
    frame = int(round(frame_sec * sr))
    hop = int(round(hop_sec * sr))
    lag_min = max(2, int(sr / fmax))
    lag_max = min(frame - 1, int(sr / fmin))
    x = _lowpass(wave, sr)
    n_frames = max(1, (len(x) - frame) // hop + 1)
    f0 = np.zeros(n_frames, dtype=np.float32)
    centers = np.zeros(n_frames, dtype=np.int64)

    # Two-stage search (mirrors native/epochs.cpp track_f0): a coarse pass on
    # a decimated copy of the 1 kHz-low-passed frame locates the
    # autocorrelation peak at ~1/D² of the full cost, then the exact
    # full-rate autocorrelation is evaluated only in a ±D-lag window around
    # it.  Decimating to >= 4 kHz loses no usable correlation structure for
    # a 1 kHz-band signal.
    D = 1
    while sr / (D * 2) >= 4000.0 and lag_min // (D * 2) >= 4:
        D *= 2
    frame_d = frame // D
    lag_min_d = max(1, lag_min // D)
    lag_max_d = min(frame_d - 1, lag_max // D)

    for i in range(n_frames):
        seg = x[i * hop: i * hop + frame].astype(np.float64)
        centers[i] = i * hop + frame // 2
        seg = seg - seg.mean()
        denom = np.dot(seg, seg)
        if denom < 1e-10:
            continue

        lo, hi = lag_min, lag_max          # refine window (full when D == 1)
        if D > 1 and lag_max_d >= lag_min_d:
            seg_d = x[i * hop: i * hop + frame_d * D: D].astype(np.float64)
            seg_d = seg_d - seg_d.mean()
            if np.dot(seg_d, seg_d) < 1e-10:
                continue
            ac_d = sps.correlate(seg_d, seg_d, mode="full")[frame_d - 1:]
            window_d = ac_d[lag_min_d:lag_max_d + 1]
            if window_d.size == 0:
                continue
            best_d = lag_min_d + int(np.argmax(window_d))
            lo = max(lag_min, best_d * D - D - 1)
            hi = min(lag_max, best_d * D + D + 1)

        if hi - lo > 32:
            # wide window (D == 1 i.e. low sample rates): FFT correlation
            ac = sps.correlate(seg, seg, mode="full")[frame - 1:]
            ac = (ac / (denom + 1e-12))[lo:hi + 1]
        else:
            lags = np.arange(lo, hi + 1)
            ac = np.array([np.dot(seg[: frame - lag], seg[lag:])
                           for lag in lags])
            ac = ac / (denom + 1e-12)
        best = int(np.argmax(ac))
        if ac[best] >= voicing_threshold:
            lag = lo + best
            # parabolic interpolation around the peak for sub-sample accuracy
            if 0 < best < ac.size - 1:
                y0, y1, y2 = ac[best - 1], ac[best], ac[best + 1]
                denom2 = y0 - 2 * y1 + y2
                if abs(denom2) > 1e-12:
                    lag = lag + 0.5 * (y0 - y2) / denom2
            f0[i] = sr / lag
    return f0, centers, hop_sec


def detect_epochs(
    wave: np.ndarray,
    sr: int,
    fmin: float = 50.0,
    fmax: float = 400.0,
    unvoiced_period_sec: float = 0.005,
    use_native: bool = True,
) -> np.ndarray:
    """Detect pitch epochs -> sorted int32 sample positions.

    Voiced regions: one mark per glottal cycle at the local negative peak of
    the low-passed signal.  Unvoiced regions: constant-rate marks every
    ``unvoiced_period_sec`` so the epoch grid covers the whole utterance.
    """
    if use_native:
        try:
            from snickery_tpu_torch.native import native_detect_epochs
            out = native_detect_epochs(wave, sr, fmin, fmax, unvoiced_period_sec)
            if out is not None:
                return out
        except ImportError:
            pass
    wave = np.asarray(wave, dtype=np.float32)
    if len(wave) < int(0.05 * sr):
        step = max(1, int(unvoiced_period_sec * sr))
        return np.arange(0, len(wave), step, dtype=np.int32)

    f0, centers, hop_sec = track_f0_autocorr(wave, sr, fmin, fmax)
    x = _lowpass(wave, sr)
    n = len(wave)

    def local_f0(pos: float) -> float:
        idx = int(np.clip(pos / (hop_sec * sr), 0, len(f0) - 1))
        return float(f0[idx])

    marks: list[int] = []
    pos = 0.0
    default_step = unvoiced_period_sec * sr
    while pos < n - 1:
        cur_f0 = local_f0(pos)
        if cur_f0 > 0:
            period = sr / cur_f0
            # search for the negative peak in a window around pos+period
            lo = int(max(pos + 0.75 * period, pos + 2))
            hi = int(min(pos + 1.25 * period, n))
            if hi - lo < 2:
                nxt = pos + period
            else:
                nxt = lo + int(np.argmin(x[lo:hi]))
            marks.append(int(round(nxt)))
            pos = float(nxt)
        else:
            nxt = pos + default_step
            if nxt < n:
                marks.append(int(round(nxt)))
            pos = nxt
    marks_arr = np.unique(np.asarray(marks, dtype=np.int64))
    marks_arr = marks_arr[(marks_arr >= 0) & (marks_arr < n)]
    return marks_arr.astype(np.int32)


def detect_epochs_batch(
    waves: list,
    sr: int,
    n_threads: int = 8,
    **kwargs,
) -> list:
    """Whole-corpus :func:`detect_epochs` (the REAPER-equivalent prep stage,
    SURVEY.md §2.9 — the reference shells out to one REAPER process per
    file).

    Preferred path: ONE native batch call (`snickery_detect_epochs_batch`)
    over the concatenated corpus — no per-utterance python/ctypes dispatch,
    which matters on the single-core bench VM.  Fallback: a thread pool of
    scalar calls (the ctypes foreign call releases the GIL, so this scales
    with cores on multi-core prep hosts).  All paths are bit-identical per
    utterance (verified: tests/test_native.py).
    """
    use_native = kwargs.pop("use_native", True)
    if use_native and len(waves) > 0:
        try:
            from snickery_tpu_torch.native import native_detect_epochs_batch
            out = native_detect_epochs_batch(waves, sr, **kwargs)
            if out is not None:
                return out
        except ImportError:
            pass
    if len(waves) <= 1 or n_threads <= 1:
        return [detect_epochs(w, sr, use_native=use_native, **kwargs)
                for w in waves]
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max_workers=n_threads) as ex:
        return list(ex.map(
            lambda w: detect_epochs(w, sr, use_native=use_native, **kwargs),
            waves))


def f0_from_epochs(
    epoch_samples: np.ndarray,
    sr: int,
    fmin: float = 50.0,
    fmax: float = 400.0,
) -> np.ndarray:
    """Per-epoch log-f0 from inter-epoch intervals.

    Intervals whose implied frequency is outside [fmin, fmax] are treated as
    unvoiced and reported as the interpolated lf0 (so the stream is smooth, as
    magphase does with its continuous-lf0 convention); a separate voicing
    decision can be made by thresholding the interval itself.

    Returns (n_epochs, 1) float32 lf0 (natural log Hz).
    """
    e = np.asarray(epoch_samples, dtype=np.float64)
    n = len(e)
    if n == 0:
        return np.zeros((0, 1), dtype=np.float32)
    ivals = np.diff(e)
    inst = np.zeros(n, dtype=np.float64)
    if n > 1:
        freq = sr / np.maximum(ivals, 1.0)
        inst[:-1] = freq
        inst[-1] = freq[-1]
    else:
        inst[:] = (fmin + fmax) / 2
    voiced = (inst >= fmin) & (inst <= fmax)
    if voiced.any():
        idx = np.arange(n)
        inst = np.interp(idx, idx[voiced], inst[voiced])
    else:
        inst[:] = np.sqrt(fmin * fmax)
    return np.log(np.maximum(inst, 1e-3)).astype(np.float32).reshape(-1, 1)

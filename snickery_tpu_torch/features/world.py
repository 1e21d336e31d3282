"""Fixed-rate <-> epoch-rate resampling for hybrid (DNN-target) inputs.

A copy of the numpy half of ``snickery_tpu/features/world.py`` (which
cannot be imported without jax: ``snickery_tpu.features`` imports it), with
the same float64 maths and the same emission rule, so that streaming
synthesis from fixed-rate frames (BASELINE config #4) runs where jax is
absent:

- :func:`resample_to_fixed`, :func:`resample_to_epochs`;
- :func:`epoch_grid_from_lf0`, :func:`fixed_to_epoch_targets`;
- :class:`StreamingEpochResampler`, the incremental form of
  :func:`fixed_to_epoch_targets` that ``Synthesiser.synth_streaming`` uses.
"""

from __future__ import annotations

import numpy as np


def resample_to_fixed(
    feats_epoch: np.ndarray,       # (E, d) epoch-rate features
    epochs: np.ndarray,            # (E,) epoch sample positions
    sample_rate: int,
    frameshift: float = 0.005,
) -> np.ndarray:
    """Epoch-rate -> fixed-rate stream (linear interpolation at frame times).

    The reference's extraction wrote BOTH epoch-rate and fixed-rate stream
    variants (SURVEY.md §3.3); Merlin-style DNNs consume/predict the
    fixed-rate ones.
    """
    feats_epoch = np.asarray(feats_epoch, np.float32)
    epochs = np.asarray(epochs, np.float64)
    if len(epochs) == 0:
        return np.zeros((0, feats_epoch.shape[1]), np.float32)
    hop = frameshift * sample_rate
    n_frames = int(np.floor(epochs[-1] / hop)) + 1
    t = np.arange(n_frames) * hop
    out = np.empty((n_frames, feats_epoch.shape[1]), np.float32)
    for j in range(feats_epoch.shape[1]):
        out[:, j] = np.interp(t, epochs, feats_epoch[:, j].astype(np.float64))
    return out


def resample_to_epochs(
    feats_fixed: np.ndarray,       # (N, d) fixed-rate features
    epochs: np.ndarray,            # (E,) target epoch sample positions
    sample_rate: int,
    frameshift: float = 0.005,
) -> np.ndarray:
    """Fixed-rate -> epoch-rate (linear interpolation at epoch times)."""
    feats_fixed = np.asarray(feats_fixed, np.float32)
    t_frames = np.arange(len(feats_fixed)) * frameshift * sample_rate
    epochs = np.asarray(epochs, np.float64)
    out = np.empty((len(epochs), feats_fixed.shape[1]), np.float32)
    for j in range(feats_fixed.shape[1]):
        out[:, j] = np.interp(epochs, t_frames, feats_fixed[:, j].astype(np.float64))
    return out


def epoch_grid_from_lf0(
    lf0: np.ndarray,               # (N,) fixed-rate log-f0 trajectory
    sample_rate: int,
    frameshift: float = 0.005,
    fmin: float = 50.0,
    fmax: float = 500.0,
) -> np.ndarray:
    """Integrate a fixed-rate lf0 contour into pitch-synchronous epoch
    positions (samples).  This is how hybrid fixed-rate DNN targets get an
    epoch grid: t_{k+1} = t_k + period(f0(t_k)).
    """
    lf0 = np.asarray(lf0, np.float64).reshape(-1)
    n = len(lf0)
    total = n * frameshift * sample_rate
    f0 = np.clip(np.exp(lf0), fmin, fmax)
    hop = frameshift * sample_rate
    epochs = []
    t = 0.0
    while t < total:
        epochs.append(t)
        idx = min(int(t / hop), n - 1)
        t += sample_rate / f0[idx]
    return np.asarray(np.round(epochs), np.int64)


def fixed_to_epoch_targets(
    feats_fixed: np.ndarray,       # (N, d) fixed-rate stacked streams
    lf0_column: int,
    sample_rate: int,
    frameshift: float = 0.005,
) -> tuple[np.ndarray, np.ndarray]:
    """Hybrid-input conversion: fixed-rate DNN outputs -> epoch-rate targets.

    Returns (epoch-rate features (E, d), epoch sample positions (E,)).
    """
    epochs = epoch_grid_from_lf0(
        feats_fixed[:, lf0_column], sample_rate, frameshift)
    feats = resample_to_epochs(feats_fixed, epochs, sample_rate, frameshift)
    return feats, epochs


class StreamingEpochResampler:
    """Incremental :func:`fixed_to_epoch_targets`: fixed-rate DNN-output
    chunks arrive one at a time, epoch-rate target rows come out as soon as
    their surrounding frames exist.

    This is the front half of BASELINE config #4 as specified ("DNN-
    predicted target features ... STREAMING synthesis"): the lf0
    integration phase ``t`` carries across chunk boundaries, so the
    concatenated output is bit-identical to the one-shot batch conversion
    (tests/test_torch_streaming.py holds it to the JAX package's copy).

    Protocol: ``push(frames) -> (E_i, d) rows``, then one ``flush()`` for
    the tail (mirrors the batch function's end-of-signal clamping).
    """

    def __init__(self, lf0_column: int, sample_rate: int,
                 frameshift: float = 0.005, fmin: float = 50.0,
                 fmax: float = 500.0):
        self.lf0_column = lf0_column
        self.sr = sample_rate
        self.hop = frameshift * sample_rate
        self.fmin, self.fmax = fmin, fmax
        self.buf = None              # retained fixed-rate frames
        self.base = 0                # global index of buf[0]
        self.n_seen = 0              # total frames received
        self.t = 0.0                 # next epoch time (samples, unrounded)
        self.epochs: list[int] = []  # emitted epoch positions (diagnostics)

    def _row_at(self, e: float, clamp: bool) -> np.ndarray:
        """Linear interpolation at (rounded) epoch position e, matching the
        np.interp semantics of resample_to_epochs (f64 maths, last-value
        clamping past the final frame)."""
        n = self.n_seen
        if (clamp and e >= (n - 1) * self.hop) or n == 1:
            return np.asarray(self.buf[n - 1 - self.base], np.float32)
        i = int(np.floor(e / self.hop))
        a = self.buf[i - self.base].astype(np.float64)
        b = self.buf[i + 1 - self.base].astype(np.float64)
        slope = (b - a) / self.hop
        return (a + slope * (e - i * self.hop)).astype(np.float32)

    def _emit(self, limit_t: float, clamp: bool) -> np.ndarray:
        out = []
        while self.t < limit_t:
            e = float(np.round(self.t))
            out.append(self._row_at(e, clamp))
            self.epochs.append(int(e))
            idx = min(int(self.t / self.hop), self.n_seen - 1)
            lf0 = float(self.buf[idx - self.base, self.lf0_column])
            f0 = min(max(np.exp(lf0), self.fmin), self.fmax)
            self.t += self.sr / f0
        return (np.stack(out) if out
                else np.zeros((0, self.buf.shape[1] if self.buf is not None
                               else 0), np.float32))

    def push(self, frames: np.ndarray) -> np.ndarray:
        frames = np.asarray(frames, np.float32)
        if frames.ndim != 2:
            raise ValueError("push expects (n_frames, d)")
        self.buf = (frames if self.buf is None
                    else np.concatenate([self.buf, frames]))
        self.n_seen += len(frames)
        # emit every epoch whose ROUNDED position has both interp
        # neighbours in hand: round(t) <= t + 0.5, so stop half a sample
        # short of the last complete frame interval
        limit = (self.n_seen - 1) * self.hop - 0.5
        out = self._emit(limit, clamp=False)
        # drop frames no epoch can need again (floor((t - 0.5) / hop)) —
        # clamped to frames actually received, else `base` would run ahead
        # of the append position when t points past the available data
        keep_from = min(max(self.base, int((self.t - 0.5) // self.hop)),
                        self.n_seen)
        if keep_from > self.base:
            self.buf = self.buf[keep_from - self.base:]
            self.base = keep_from
        return out

    def flush(self) -> np.ndarray:
        """Tail epochs up to the batch function's total = n * hop, with
        end-of-signal clamping (np.interp holds the last frame value)."""
        if self.buf is None or self.n_seen == 0:
            return np.zeros((0, 0), np.float32)
        return self._emit(self.n_seen * self.hop, clamp=True)

"""Numpy-made voices at the real feature widths, for smoke runs on a card
and for the card tests: no audio files and no analysis, only seeded random
walks shaped like the features a built voice holds.

- ``make_utterances``: epoch-rate utterances (config-3 / config-5 style);
- ``make_halfphone_utterances`` with ``phone_means``: labelled utterances
  with HalfphoneSegment labels and quinphone contexts (config-2 style).

Both return ``UtteranceData`` lists for ``voicedb.build.build_voicedb``.
"""

from __future__ import annotations

import numpy as np

from snickery_tpu_torch.io.labels import HalfphoneSegment
from snickery_tpu_torch.voicedb.build import UtteranceData

SR = 16000
DATADIMS = {"mag": 60, "real": 45, "imag": 45, "lf0": 1}
KD = sum(DATADIMS.values())
N_PHONES = 40            # 40 phones -> 80 halfphones (_L, _R)


def make_utterances(rng, n_utts: int, n_epochs, prefix: str):
    """Synthetic epoch-rate utterances: a smooth f0 contour gives
    80-160-sample periods; features are an AR(1) walk per utterance (so
    natural joins matter); waves are low-amplitude noise of matching length."""
    n_epochs = np.broadcast_to(np.asarray(n_epochs), (n_utts,))
    E = int(n_epochs.max())
    a = np.float32(0.95)
    x = rng.standard_normal((n_utts, KD), dtype=np.float32)
    feats = np.empty((n_utts, E, KD), np.float32)
    for e in range(E):
        feats[:, e] = x
        x = a * x + np.float32(np.sqrt(1 - a * a)) * rng.standard_normal(
            (n_utts, KD), dtype=np.float32)
    phase = rng.uniform(0, 2 * np.pi, (n_utts, 1))
    rate = rng.uniform(0.005, 0.02, (n_utts, 1))
    periods = np.rint(120 + 40 * np.sin(rate * np.arange(E)[None, :] + phase)).astype(np.int64)
    feats[:, :, -1] = np.log(SR / periods).astype(np.float32)        # lf0
    utts = []
    for u in range(n_utts):
        n = int(n_epochs[u])
        epochs = 160 + np.cumsum(periods[u, :n]) - periods[u, 0]
        wave = 0.05 * rng.standard_normal(int(epochs[-1]) + 200, dtype=np.float32)
        utts.append(UtteranceData(
            basename=f"{prefix}{u:05d}", wave=wave, epochs=epochs.astype(np.int32),
            features=np.ascontiguousarray(feats[u, :n]),
            lf0=feats[u, :n, -1].copy()))
    return utts


def phone_means(seed: int) -> np.ndarray:
    """One mean feature vector per halfphone (80, KD): same-name units are
    acoustically alike, other names far."""
    return 1.5 * np.random.default_rng(seed).standard_normal((2 * N_PHONES, KD)).astype(np.float32)


def make_halfphone_utterances(rng, n_utts: int, n_phones: int, prefix: str,
                              means: np.ndarray):
    """Labelled synthetic utterances: random phone sequences of 6-14 epochs
    a phone, split into two halfphones at the middle epoch; features are the
    halfphone's mean plus an AR(1) walk; segment bounds sit on epochs;
    quinphone contexts padded with "xx"."""
    utts = []
    for u in range(n_utts):
        phones = rng.integers(0, N_PHONES, n_phones)
        lens = rng.integers(6, 15, n_phones)
        E = int(lens.sum()) + 2
        hp = np.empty(E, np.int64)
        hp[0] = 2 * phones[0]
        bounds = []                         # (first epoch, end epoch, halfphone)
        e = 1
        for p, n in zip(phones, lens):
            mid = e + n // 2
            bounds += [(e, mid, 2 * p), (mid, e + n, 2 * p + 1)]
            hp[e:mid], hp[mid:e + n] = 2 * p, 2 * p + 1
            e += n
        hp[-1] = hp[-2]
        walk = np.empty((E, KD), np.float32)
        x = rng.standard_normal(KD, dtype=np.float32)
        for i in range(E):
            walk[i] = x
            x = 0.9 * x + np.float32(np.sqrt(1 - 0.81)) * rng.standard_normal(KD, dtype=np.float32)
        periods = rng.integers(80, 161, E)
        epochs = 160 + np.cumsum(periods) - periods[0]
        feats = means[hp] + 0.5 * walk
        feats[:, -1] = np.log(SR / periods)
        names = [f"p{p}" for p in phones]
        segs = []
        for j, (a, b, h) in enumerate(bounds):
            i = j // 2
            ctx = tuple(names[i + o] if 0 <= i + o < n_phones else "xx" for o in (-2, -1, 0, 1, 2))
            segs.append(HalfphoneSegment(epochs[a] / SR, epochs[b] / SR,
                                         f"p{h // 2}_{'LR'[h % 2]}", names[i], "LR"[h % 2], ctx))
        utts.append(UtteranceData(
            basename=f"{prefix}{u:05d}", wave=0.05 * rng.standard_normal(
                int(epochs[-1]) + 200, dtype=np.float32),
            epochs=epochs.astype(np.int32), features=feats.astype(np.float32),
            lf0=feats[:, -1].copy(), halfphones=segs))
    return utts

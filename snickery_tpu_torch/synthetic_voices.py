"""Numpy-made voices at the real feature widths, for smoke runs on a card
and for the card tests: seeded random walks shaped like the features a
built voice holds, and speech-like waves for the analysis and voice-building
path.

- ``ar1_walks``: the feature walks alone (kernel sweeps);
- ``make_utterances``: epoch-rate utterances (config-3 / config-5 style);
- ``make_halfphone_utterances`` with ``phone_means``: labelled utterances
  with HalfphoneSegment labels and quinphone contexts (config-2 style);
- ``synth_utterance``: a speech-like wave and its halfphone segments (the
  generator of tests/toyvoice.py), for wav corpora that ``train`` analyses.

``make_utterances`` and ``make_halfphone_utterances`` return
``UtteranceData`` lists for ``voicedb.build.build_voicedb``.
"""

from __future__ import annotations

import numpy as np

from snickery_tpu_torch.io.labels import HalfphoneSegment
from snickery_tpu_torch.voicedb.build import UtteranceData

SR = 16000
DATADIMS = {"mag": 60, "real": 45, "imag": 45, "lf0": 1}
KD = sum(DATADIMS.values())
N_PHONES = 40            # 40 phones -> 80 halfphones (_L, _R)


def ar1_walks(rng, n_walks: int, length: int, dim: int) -> np.ndarray:
    """(n_walks, length, dim) f32 stationary AR(1) walks of unit variance and
    lag-1 correlation 0.95: neighbouring rows are near-duplicates, as the
    consecutive epochs of an utterance are."""
    a = np.float32(0.95)
    x = rng.standard_normal((n_walks, dim), dtype=np.float32)
    feats = np.empty((n_walks, length, dim), np.float32)
    for e in range(length):
        feats[:, e] = x
        x = a * x + np.float32(np.sqrt(1 - a * a)) * rng.standard_normal(
            (n_walks, dim), dtype=np.float32)
    return feats


def make_utterances(rng, n_utts: int, n_epochs, prefix: str):
    """Synthetic epoch-rate utterances: a smooth f0 contour gives
    80-160-sample periods; features are an AR(1) walk per utterance (so
    natural joins matter); waves are low-amplitude noise of matching length."""
    n_epochs = np.broadcast_to(np.asarray(n_epochs), (n_utts,))
    E = int(n_epochs.max())
    feats = ar1_walks(rng, n_utts, E, KD)
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


# the speech-like generator: 21 phone classes with formant-style spectra.
# Vowels/sonorants: two 'formant' peaks over 12 harmonics that MOVE within
# each segment; fricatives: mostly high-harmonic energy + noise; stops:
# silence gap then a burst.  Deterministic per phone class.
N_HARM = 12
VOWELS = ["a", "e", "i", "o", "u", "ae", "ii", "uu", "oo", "er",
          "m", "n", "l", "r", "w"]
FRICS = ["s", "f", "sh", "z"]
STOPS = ["t", "k"]
PHONES = VOWELS + FRICS + STOPS
# (formant-1 harmonic, formant-2 harmonic) start -> end per vowel-like phone
_FMT = {
    "a": ((2, 5), (2, 6)), "e": ((2, 7), (3, 7)), "i": ((1, 8), (1, 9)),
    "o": ((1, 4), (2, 4)), "u": ((1, 3), (1, 2)), "ae": ((3, 6), (2, 6)),
    "ii": ((1, 9), (2, 9)), "uu": ((1, 2), (1, 3)), "oo": ((2, 4), (1, 5)),
    "er": ((2, 5), (3, 4)), "m": ((1, 2), (1, 2)), "n": ((1, 3), (1, 3)),
    "l": ((2, 4), (2, 5)), "r": ((2, 3), (3, 3)), "w": ((1, 2), (2, 3)),
}


def synth_utterance(seed: int, n_segments: int = 8, seg_sec: float = 0.15):
    """Random phone sequence -> (wave, segments): harmonic stacks with
    in-segment formant motion, per-segment amplitude envelopes, fricative
    noise and stop gaps and bursts; variable pitch periods and
    non-stationary in-segment spectra.  A copy of tests/toyvoice.py's
    generator: the same seed gives the same wave and segments."""
    rng = np.random.default_rng(seed)
    phones = [PHONES[i] for i in rng.integers(0, len(PHONES), n_segments)]
    seg_len = int(seg_sec * SR)
    n = seg_len * n_segments
    t = np.arange(n) / SR
    f0 = 110.0 + 30.0 * np.sin(2 * np.pi * (0.4 + 0.2 * rng.random()) * t + rng.random() * 6)
    phase = 2 * np.pi * np.cumsum(f0) / SR
    wave = np.zeros(n)
    u = np.linspace(0.0, 1.0, seg_len)           # in-segment position
    # per-segment amplitude envelope: soft attack + decay
    env = np.minimum(1.0, u / 0.12) * (1.0 - 0.35 * u)
    for si, ph in enumerate(phones):
        sl = slice(si * seg_len, (si + 1) * seg_len)
        if ph in STOPS:
            # closure silence then a decaying broadband burst
            seg = np.zeros(seg_len)
            b0 = int(0.55 * seg_len)
            burst = rng.standard_normal(seg_len - b0) * np.exp(
                -np.arange(seg_len - b0) / (0.012 * SR))
            seg[b0:] = 0.5 * burst
            # light voicing tail into the next phone
            seg += 0.08 * np.sin(phase[sl]) * (u > 0.8)
        elif ph in FRICS:
            depth = {"s": 0.9, "f": 0.75, "sh": 0.8, "z": 0.55}[ph]
            noise = rng.standard_normal(seg_len)
            # crude spectral shaping: difference = high-pass-ish
            noise = np.diff(noise, prepend=noise[:1])
            seg = depth * 0.35 * noise
            if ph == "z":                        # voiced fricative
                seg += 0.25 * np.sin(phase[sl])
            seg *= env
        else:
            (a1, a2), (b1, b2) = _FMT[ph]
            f1 = a1 + (b1 - a1) * u              # formants glide in-segment
            f2 = a2 + (b2 - a2) * u
            h = np.arange(1, N_HARM + 1, dtype=np.float64)[:, None]
            bump = (0.6 * np.exp(-0.5 * ((h - f1[None, :]) / 1.0) ** 2)
                    + 0.4 * np.exp(-0.5 * ((h - f2[None, :]) / 1.2) ** 2))
            amps = bump * (1.0 / np.sqrt(h))     # (N_HARM, seg_len)
            seg = np.sum(amps * np.sin(h * phase[sl][None, :]), axis=0)
            seg *= env
        wave[sl] = seg
    wave *= 0.9 / max(np.abs(wave).max(), 1e-6) * 0.7
    segments = []
    for si, ph in enumerate(phones):
        s0 = si * seg_len / SR
        s1 = (si + 1) * seg_len / SR
        mid = 0.5 * (s0 + s1)
        prev = phones[si - 1] if si else "xx"
        prev2 = phones[si - 2] if si > 1 else "xx"
        nxt = phones[si + 1] if si < n_segments - 1 else "xx"
        nxt2 = phones[si + 2] if si < n_segments - 2 else "xx"
        quin = (prev2, prev, ph, nxt, nxt2)
        segments.append(HalfphoneSegment(s0, mid, f"{ph}_L", ph, "L", quin))
        segments.append(HalfphoneSegment(mid, s1, f"{ph}_R", ph, "R", quin))
    return wave.astype(np.float32), segments

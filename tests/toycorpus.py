"""A wav corpus on disk for the port's voice-building tests: speech-like
utterances (``snickery_tpu_torch.synthetic_voices.synth_utterance``, the
generator of tests/toyvoice.py), their HTS labels (one full-context line a
phone, in 100 ns units), a JSON config, and the corpus span that natural
synthesis of a training utterance reconstructs.  Numpy and the port's I/O only,
so the card tests can use it where jax is absent."""

from __future__ import annotations

import json
import os

import numpy as np

from snickery_tpu_torch.io.speech import write_wave
from snickery_tpu_torch.synthetic_voices import SR, synth_utterance

STREAMS = {"mag": 60, "real": 45, "imag": 45, "lf0": 1}


def write_label(segments, path: str) -> None:
    """One ``start end ll^l-c+r=rr@1`` line a phone (pairs of halfphones)."""
    with open(path, "w") as f:
        for left, right in zip(segments[::2], segments[1::2]):
            s0, s1 = (int(round(t * 1e7)) for t in (left.start_sec, right.end_sec))
            ll, l, c, r, rr = left.quinphone
            f.write(f"{s0} {s1} {ll}^{l}-{c}+{r}={rr}@1\n")


def write_corpus(root, seeds, n_segments: int = 5, prefix: str = "utt",
                 pad_silence: int = 0) -> list[str]:
    """``<root>/wav/<prefix>NN.wav`` and ``<root>/lab/<prefix>NN.lab`` for each
    seed (``pad_silence`` zero samples before and after the wave); returns
    the basenames."""
    names = []
    for d in ("wav", "lab"):
        os.makedirs(os.path.join(root, d), exist_ok=True)
    for i, seed in enumerate(seeds):
        name = f"{prefix}{i:02d}"
        wave, segs = synth_utterance(seed, n_segments=n_segments)
        if pad_silence:
            z = np.zeros(pad_silence, np.float32)
            wave = np.concatenate([z, wave, z])
            shift = pad_silence / SR
            segs = [type(s)(s.start_sec + shift, s.end_sec + shift, *list(s.__dict__.values())[2:])
                    for s in segs]
        write_wave(wave, os.path.join(root, "wav", name + ".wav"), SR)
        write_label(segs, os.path.join(root, "lab", name + ".lab"))
        names.append(name)
    return names


def copy_reference(db, ids, taper: int, n: int) -> np.ndarray:
    """The corpus span that natural synthesis of corpus units ``ids``
    reconstructs: ``n`` samples from ``taper`` before the first unit's
    epoch (zero-padded past the corpus's ends)."""
    start = int(db.cutpoints[ids[0], 1]) - taper
    span = np.asarray(db.waves[max(start, 0):start + n], np.float32)
    return np.pad(span, (max(-start, 0), n - len(span) - max(-start, 0)))


def write_config(path, root, **over) -> str:
    """A JSON voice config over the corpus at ``root``; returns its path."""
    cfg = dict(workdir=os.path.join(root, "work"), wav_datadir=os.path.join(root, "wav"),
               lab_datadir=os.path.join(root, "lab"), stream_list=list(STREAMS),
               datadims=dict(STREAMS), sample_rate=SR, n_candidates=8, taper_length=32,
               length_buckets=[64, 128, 256], voice_name="corpus")
    cfg.update(over)
    with open(path, "w") as f:
        json.dump(cfg, f)
    return str(path)

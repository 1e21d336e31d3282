"""The inputs of a run, made from its seed on the device: the voices'
utterances (wave, pitch marks, features) and the pool of held-out target
utterances.  A voice is to unit selection what weights are to a model.

Each voice and the target pool draw from a ``torch.Generator`` of their own,
seeded from the run's seed and the voice's number (or "targets"), so the
targets are never utterances of a voice.  Waves are rendered a chunk of
utterances at a time (:mod:`benchmark.speech`), their epochs analysed a group
of at most ``GROUP_EPOCHS`` rows at a time (:mod:`benchmark.analysis`), and
each utterance's arrays are copied to the host once.
"""

from __future__ import annotations

import hashlib
import time

import numpy as np
import torch

from benchmark import analysis, speech

GROUP_EPOCHS = 131072
CHUNK_SAMPLES = 12_000_000


def sub_seed(seed: int, *tags) -> int:
    """A 63-bit seed of its own for ``tags`` under the run's ``seed``."""
    h = hashlib.sha256(repr((int(seed),) + tags).encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


def utterances(n_utts: int, n_segments: int, seed: int, device, seg_sec: float = 0.15,
               sample_rate: int = speech.SR) -> list:
    """``n_utts`` utterances of ``n_segments`` segments: dicts of ``wave``
    (n,) f32, ``epochs`` (E,) int32 and ``features`` (E, 151) f32
    ``[mag 60 | real 45 | imag 45 | lf0 1]``, as host arrays."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    n = speech.seg_len(seg_sec) * n_segments
    chunk = max(1, CHUNK_SAMPLES // n)
    out = []
    for c0 in range(0, n_utts, chunk):
        c = min(chunk, n_utts - c0)
        waves, cycles = speech.render(*speech.draw(gen, c, n_segments, seg_sec))
        utt, pos = speech.pitch_marks(cycles)
        del cycles
        counts = torch.bincount(utt, minlength=c).cpu().tolist()
        starts = np.concatenate([[0], np.cumsum(counts)]).tolist()
        feats, i = [], 0
        while i < c:
            # whole utterances a group: each frame reads its own utterance
            j = i + 1
            while j < c and starts[j + 1] - starts[i] <= GROUP_EPOCHS:
                j += 1
            lo, hi = starts[i], starts[j]
            u = utt[lo:hi] - i
            rows = analysis.magphase_rows(waves[i:j], u, pos[lo:hi], sample_rate)
            feats.append(torch.cat([rows, analysis.lf0_rows(u, pos[lo:hi], sample_rate)], 1))
            i = j
        feats = torch.cat(feats).cpu().numpy()
        pos_h = pos.to(torch.int32).cpu().numpy()
        waves_h = waves.cpu().numpy()
        start = 0
        for i in range(c):
            e = counts[i]
            out.append({"wave": waves_h[i], "epochs": pos_h[start: start + e],
                        "features": feats[start: start + e]})
            start += e
        del waves, utt, pos
    return out


def cell_data(config: dict, traffic: dict, seed: int, device, log):
    """(voices: a list of utterance lists, one a voice; pool: the held-out
    target utterances) of a cell, made from ``seed``."""
    data = config["data"]
    t0 = time.perf_counter()
    voices = [utterances(data["utterances_per_voice"], data["segments"],
                         sub_seed(seed, "voice", v), device, data["seg_sec"],
                         data["sample_rate"])
              for v in range(data["voices"])]
    pool = utterances(traffic["pool"], traffic["pool_segments"], sub_seed(seed, "targets"),
                      device, data["seg_sec"], data["sample_rate"])
    need = traffic["epochs"]["max"]
    short = min(len(u["epochs"]) for u in pool)
    if short < need:
        raise ValueError(f"a target utterance has {short} epochs, the traffic cuts {need}")
    units = sum(len(u["epochs"]) - 2 for utts in voices for u in utts)
    secs = sum(len(u["wave"]) for utts in voices for u in utts) / data["sample_rate"]
    log(f"setup data: {len(voices)} voice(s), {units} units, {secs:.1f} s of audio, "
        f"{len(pool)} target utterances, {time.perf_counter() - t0:.2f} s")
    return voices, pool

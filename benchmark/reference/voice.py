"""The reference's voice: epoch units cut from the utterance arrays, the
normalisation and stream weighting worked out again.

Unit semantics (the program's documented contract, one epoch a unit):
unit ``j`` of an utterance with epochs ``e`` and feature rows ``f`` (E rows)
is its centre epoch ``1 + j`` for ``j < E - 2``: target row ``f[1 + j]``,
left join context ``f[1 + j]``, right join context ``f[2 + j]``, audio span
``[e[1 + j], e[2 + j])`` of the utterance's wave.  Unit ids number the units
in corpus order: voice after voice, utterance after utterance.  A target
trajectory of E rows gives the E - 2 unit-rate targets ``f[1 : E - 1]``.
Targets and unit rows are standardised by the mean and (population) standard
deviation of the unit rows, join contexts by those of all left and right
contexts together (each voice's left contexts, then its right ones, voice
after voice), and each stream is scaled by the square root of its weight.
The statistics follow the voice builder's rule, which the port holds equal
bit for bit to the JAX package's: numpy's float32 mean and standard
deviation of the float32 rows, in that row order.  That float32 sum runs
row after row, so over a million rows a column's deviation is off the exact
one by up to about 7e-4 of itself; an exact float64 statistic would move the
costs of a whole path by about 1e-3, as far as the control does, so the
reference keeps the builder's rule (see ``PERF.md``).  Everything after the
statistics is float64.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass
class RefVoice:
    feats: np.ndarray          # (M, kd) f32 unit rows as cut (host)
    jr: np.ndarray             # (M, kd) f32 right join contexts as cut (host)
    fw: torch.Tensor           # (M, kd) f64 standardised, weighted unit rows
    jlw: torch.Tensor          # (M, kd) f64 weighted left contexts
    jrw: torch.Tensor          # (M, kd) f64 weighted right contexts
    cut_start: torch.Tensor    # (M,) int64 into ``waves``
    cut_end: torch.Tensor
    waves: torch.Tensor        # (S,) f32, the utterances' waves end to end
    voice_rows: list           # [(first unit id, end unit id)] a voice
    mean_t: torch.Tensor
    std_t: torch.Tensor
    sqrt_wt: torch.Tensor

    def targets(self, features: np.ndarray) -> torch.Tensor:
        """(E - 2, kd) f64 standardised, weighted unit-rate targets of an
        epoch-rate trajectory (E, kd)."""
        t = torch.from_numpy(np.asarray(features[1: len(features) - 1], np.float32))
        t = t.to(self.fw.device, torch.float64)
        return (t - self.mean_t) / self.std_t * self.sqrt_wt


def stream_weights(datadims: dict, streams: list, weights: list) -> np.ndarray:
    """(kd,) the weight of each column: stream ``i`` has ``weights[i]``."""
    return np.concatenate([np.full(datadims[s], float(w)) for s, w in zip(streams, weights)])


def build(voices: list, datadims: dict, streams: list, target_weights: list,
          join_weights: list, device) -> RefVoice:
    """The reference voice of ``voices``: a list (one a voice) of lists of
    utterances, each a dict with ``wave`` (n,) f32, ``epochs`` (E,) int and
    ``features`` (E, kd) f32."""
    feats, jr, c0, c1, rows = [], [], [], [], []
    offset = unit = 0
    for utts in voices:
        first = unit
        for u in utts:
            f, e = u["features"], np.asarray(u["epochs"], np.int64)
            E = len(e)
            feats.append(f[1: E - 1])
            jr.append(f[2: E])
            c0.append(e[1: E - 1] + offset)
            c1.append(e[2: E] + offset)
            offset += len(u["wave"])
            unit += E - 2
        rows.append((first, unit))
    feats = np.ascontiguousarray(np.concatenate(feats), np.float32)
    jr = np.ascontiguousarray(np.concatenate(jr), np.float32)
    joins = np.concatenate([x[a:b] for a, b in rows for x in (feats, jr)])
    stats = [feats.mean(axis=0), np.maximum(feats.std(axis=0), 1e-8),
             joins.mean(axis=0), np.maximum(joins.std(axis=0), 1e-8)]
    del joins
    mean_t, std_t, mean_j, std_j = (
        torch.from_numpy(x.astype(np.float32)).to(device, torch.float64) for x in stats)
    f64 = torch.from_numpy(feats).to(device, torch.float64)
    jr64 = torch.from_numpy(jr).to(device, torch.float64)
    sqrt_wt = torch.from_numpy(np.sqrt(stream_weights(datadims, streams, target_weights)))
    sqrt_wj = torch.from_numpy(np.sqrt(stream_weights(datadims, streams, join_weights)))
    sqrt_wt, sqrt_wj = sqrt_wt.to(device), sqrt_wj.to(device)
    waves = torch.from_numpy(np.concatenate([np.asarray(u["wave"], np.float32)
                                             for utts in voices for u in utts])).to(device)
    return RefVoice(
        feats=feats, jr=jr,
        fw=(f64 - mean_t) / std_t * sqrt_wt,
        jlw=(f64 - mean_j) / std_j * sqrt_wj,
        jrw=(jr64 - mean_j) / std_j * sqrt_wj,
        cut_start=torch.from_numpy(np.concatenate(c0)).to(device),
        cut_end=torch.from_numpy(np.concatenate(c1)).to(device),
        waves=waves, voice_rows=rows, mean_t=mean_t, std_t=std_t, sqrt_wt=sqrt_wt)

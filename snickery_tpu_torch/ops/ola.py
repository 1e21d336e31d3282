"""Waveform concatenation: gather + crossfade overlap-add, batched over B.

Counterpart of ``snickery_tpu.ops.ola``.  Placement semantics are the same:
a unit's nominal span ``[cut1, cut2)`` is extracted with ``taper`` extra
samples on each side, spans are placed back to back, and neighbouring
fragments overlap by ``2 * taper`` samples under complementary float32
raised-cosine ramps, so corpus-consecutive units reconstruct the corpus.

The JAX version works at 128-sample row granularity with masked rolls, a
shape chosen around a TPU gather limit.  Here every fragment sample is
gathered directly and summed into the output with ``index_add_``; only the
output has to match.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def host_overlap_add(waves: np.ndarray, cut_start: np.ndarray,
                     cut_end: np.ndarray, taper: int) -> np.ndarray:
    """Numpy overlap-add of one utterance from host audio (a copy of
    ``snickery_tpu.ops.ola.host_overlap_add``, which cannot be imported
    without jax)."""
    cut_start = np.asarray(cut_start, np.int64)
    cut_end = np.asarray(cut_end, np.int64)
    spans = cut_end - cut_start
    total = int(2 * taper + spans.sum())
    out = np.zeros(total, np.float32)
    n = len(waves)
    t2 = float(2 * taper)
    anchor = taper
    for c1, c2, span in zip(cut_start, cut_end, spans):
        L = int(span) + 2 * taper
        s0 = int(c1) - taper
        frag = np.zeros(L, np.float32)
        lo, hi = max(s0, 0), min(s0 + L, n)
        if hi > lo:
            frag[lo - s0: hi - s0] = waves[lo:hi]
        pos = np.arange(L, dtype=np.float32)
        rise = 0.5 - 0.5 * np.cos(np.pi * np.clip((pos + 0.5) / t2, 0.0, 1.0))
        fall = 0.5 - 0.5 * np.cos(np.pi * np.clip((L - pos - 0.5) / t2, 0.0, 1.0))
        out[anchor - taper: anchor - taper + L] += frag * np.minimum(rise, fall)
        anchor += int(span)
    return out


def overlap_add_units(waves, cut_start, cut_end, n_units, max_frag: int,
                      out_len: int, taper: int, wave_scale=1.0):
    """Concatenate selected units of B utterances.

    ``waves`` (S,) corpus audio, float32 or int16 (audio = waves *
    ``wave_scale``); ``cut_start``/``cut_end`` (B, U) anchor and end samples;
    ``n_units`` (B,) live units (slots at or past it contribute nothing);
    ``max_frag`` the longest fragment including ``2 * taper``.
    Returns (audio (B, out_len) f32, total samples (B,) int64).
    """
    B, U = cut_start.shape
    dev = cut_start.device
    live = (torch.arange(U, device=dev)[None, :]
            < torch.as_tensor(n_units, device=dev).reshape(B, 1))
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    span = torch.where(live, (cut_end - cut_start).long(), zero)
    anchors = taper + torch.cumsum(span, dim=1) - span
    total = 2 * taper + span.sum(dim=1)
    frag_len = torch.where(live, span + 2 * taper, zero)

    p = torch.arange(max_frag, device=dev)
    src = cut_start.long()[:, :, None] - taper + p                 # (B, U, F)
    inside = p < frag_len[:, :, None]
    in_corpus = (src >= 0) & (src < waves.shape[0])
    x = waves[src.clamp(0, waves.shape[0] - 1)].to(torch.float32)
    x = x * torch.as_tensor(wave_scale, dtype=torch.float32, device=dev)

    pos = p.to(torch.float32)
    L = frag_len.to(torch.float32)[:, :, None]
    t2 = float(2 * taper)
    rise = 0.5 - 0.5 * torch.cos(math.pi * torch.clamp((pos + 0.5) / t2, 0.0, 1.0))
    fall = 0.5 - 0.5 * torch.cos(math.pi * torch.clamp((L - pos - 0.5) / t2, 0.0, 1.0))
    dst = anchors[:, :, None] - taper + p                         # (B, U, F)
    keep = inside & in_corpus & (dst < out_len)
    vals = torch.where(keep, x * torch.minimum(rise, fall), 0.0)
    flat = torch.where(keep, dst + (torch.arange(B, device=dev) * out_len)[:, None, None],
                       zero)
    out = torch.zeros(B * out_len, dtype=torch.float32, device=dev)
    out.index_add_(0, flat.reshape(-1), vals.reshape(-1))
    return out.reshape(B, out_len), total

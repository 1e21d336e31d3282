"""Device half of the raw-feature layout, in PyTorch.

The host half, :func:`build_raw_blocks`, is numpy and shared with the JAX
package (``snickery_tpu.voicedb.device_layout``); its docstring describes
the ``(q, kd + 2)`` block ``[data kd | sqn | ptr]``.  The pointer column
holds int32 BITS inside the f32 array: it is read with ``.view(torch.int32)``
and never converted or used in arithmetic.
"""

from __future__ import annotations

import torch

from snickery_tpu.voicedb.device_layout import build_raw_blocks

__all__ = ["affine_rows", "build_raw_blocks", "gather_join_contexts"]


def affine_rows(x, mean, std, w, valid=None, pad_value=0.0):
    """``((x - mean) / std) * w`` over trailing-dim rows, invalid rows pinned
    to ``pad_value * w`` (same op order as the JAX and numpy paths)."""
    v = ((x - mean) / std) * w
    if valid is None:
        return v
    return torch.where(valid[..., None], v, torch.tensor(
        pad_value, dtype=torch.float32, device=w.device) * w)


def gather_join_contexts(raw_rows, raw_block, idx, dj,
                         mean_j, std_j, sqrt_wj, valid):
    """(jl, jr) normalised + weighted join contexts for candidate units.

    ``raw_rows`` are the candidates' gathered raw block rows: their first
    ``dj`` columns are join_left and their last column the jr-exception
    pointer, so jr costs one gather at ``ptr > 0 ? ptr : idx + 1``.
    Invalid (padding) candidates get zero contexts.
    """
    ptr = raw_rows[..., -1].view(torch.int32)
    g = torch.where(ptr > 0, ptr, idx + 1)
    jr_raw = raw_block[g.long(), :dj]
    return (affine_rows(raw_rows[..., :dj], mean_j, std_j, sqrt_wj, valid, 0.0),
            affine_rows(jr_raw, mean_j, std_j, sqrt_wj, valid, 0.0))

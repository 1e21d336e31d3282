"""Raw-feature layout of the resident voice: the host half in numpy
(:func:`build_raw_blocks`, :func:`identity_affine`, copied from
``snickery_tpu.voicedb.device_layout`` bit for bit) and the device half in
PyTorch.

The DB's join contexts are redundant with its target rows: ``join_left[u]``
is the first ``dj`` columns of unit u's row and ``join_right[u]`` is, for
contiguous units, the next unit's ``join_left``; the exceptions (one or so
per utterance) are found by exact comparison.  So the device holds one raw
block instead of features and both join matrices::

    rows [0, m_s)          raw target_feats rows (padding rows 0)
    row  m_s               halo (zeros): a safe landing for ``u + 1`` gathers
    rows [m_s+1, q)        exception join_right rows (first dj columns)
    column kd              (with ``affine``) squared norm of the normalised row
    last column            jr-exception pointer: 0 for regular rows, else the
                           row holding this unit's true join_right, as int32
                           BITS inside the f32 array

The pointer column is read with ``.view(torch.int32)`` and never converted or
used in arithmetic.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["affine_rows", "build_raw_blocks", "gather_join_contexts",
           "identity_affine"]


def build_raw_blocks(
    feats_raw: np.ndarray,     # (m, kd) RAW (unnormalised) unit target features
    jr_raw: np.ndarray,        # (m, dj) RAW join_right rows
    mp: int,                   # padded unit count (multiple of ndb)
    ndb: int = 1,              # db-mesh axis size (shard count)
    affine: tuple | None = None,  # (mean (kd,), std (kd,), sqrt_w (kd,)):
                                  # ALSO bake ||((x-mean)/std)*w||^2 into an
                                  # extra sqn column (see below)
) -> tuple[np.ndarray, int, int]:
    """Build the per-shard raw blocks described in the module docstring.

    Returns ``(blocks (ndb * q, width) f32, q, m_s)`` where ``m_s = mp/ndb``
    is the DB rows per shard and ``q`` the total block rows per shard.
    Sharding ``blocks`` as ``P("db", None)`` gives each device its own
    ``(q, width)`` block with block-LOCAL exception pointers.

    ``width`` is ``kd + 1`` (``[data | ptr]``), or ``kd + 2``
    (``[data | sqn | ptr]``) when ``affine`` is given: column ``kd`` then
    carries the precomputed squared norm of the affine-normalised row
    (padding rows take the 1e6-sentinel norm so they can never win
    preselection).  Baking sqn into the block at voice-prep removes BOTH
    the per-step fused reduce over the whole DB and the lane-padded
    ``(n_chunks, chunk, 1)`` HBM operand the kernel otherwise needs (128x
    padding blowup on the trailing singleton — 4 GiB at 8.4M units; see
    the round-4 capacity OOM analysis in ARCHITECTURE.md).  The pointer
    column stays LAST either way, so ``gather_join_contexts`` is
    layout-agnostic.
    """
    feats_raw = np.ascontiguousarray(feats_raw, np.float32)
    jr_raw = np.ascontiguousarray(jr_raw, np.float32)
    m, kd = feats_raw.shape
    dj = jr_raw.shape[1]
    assert dj <= kd, (dj, kd)
    assert mp % ndb == 0 and mp >= m, (mp, ndb, m)
    m_s = mp // ndb

    # irregular-jr mask by EXACT comparison (the regular case is a bitwise
    # copy of the same source row, so float equality is the right test)
    if m:
        nxt = np.zeros((m, dj), np.float32)
        nxt[: m - 1] = feats_raw[1:, :dj]
        exc_mask = np.any(jr_raw != nxt, axis=1)
        exc_mask[m - 1] = True                     # no successor row
    else:
        exc_mask = np.zeros(0, bool)

    shard_exc: list[np.ndarray] = []
    for s in range(ndb):
        lo, hi = s * m_s, min((s + 1) * m_s, m)
        ids = (np.nonzero(exc_mask[lo:hi])[0] + lo
               if hi > lo else np.zeros(0, np.int64))
        last = (s + 1) * m_s - 1                   # shard's last row, global
        if last < m - 1:
            # its ``u + 1`` falls in the NEXT shard: route through the
            # exception table too (jr_raw holds the true row either way)
            ids = np.union1d(ids, [last])
        shard_exc.append(ids.astype(np.int64))
    e_pad = max([len(i) for i in shard_exc] + [1])
    q = m_s + 1 + e_pad

    width = kd + 1 if affine is None else kd + 2
    ptr_col = width - 1
    if affine is not None:
        mean, std, w = (np.asarray(a, np.float32) for a in affine[:3])
        # same elementwise op order as affine_rows (f32 throughout);
        # the row reduce is numpy (pairwise) vs XLA — LSB-level rounding
        # differences are absorbed by the preselect rank margin and the
        # exact-f32 rescore downstream (fidelity gates re-verified after
        # this change; see tests/test_device_layout.py)
        v = ((feats_raw - mean) / std) * w
        sqn_real = np.sum(v * v, axis=1, dtype=np.float32)
        sent = np.float32(1e6) * w
        sqn_sentinel = np.float32(np.sum(sent * sent, dtype=np.float32))

    blocks = np.zeros((ndb * q, width), np.float32)
    for s in range(ndb):
        base, lo = s * q, s * m_s
        hi = min(lo + m_s, m)
        if hi > lo:
            blocks[base: base + (hi - lo), :kd] = feats_raw[lo:hi]
        if affine is not None:
            # real rows get their norm; DB padding rows [hi-lo, m_s) the
            # never-wins sentinel (halo/exception tail rows stay 0 — the
            # grid never visits them)
            if hi > lo:
                blocks[base: base + (hi - lo), kd] = sqn_real[lo:hi]
            blocks[base + (hi - lo): base + m_s, kd] = sqn_sentinel
        ids = shard_exc[s]
        if len(ids):
            blocks[base + m_s + 1: base + m_s + 1 + len(ids), :dj] = jr_raw[ids]
            ptrs = (m_s + 1 + np.arange(len(ids), dtype=np.int32))
            blocks[base + (ids - lo), ptr_col] = ptrs.view(np.float32)
    return blocks, q, m_s


def affine_rows(x, mean, std, w, valid=None, pad_value=0.0):
    """``((x - mean) / std) * w`` over trailing-dim rows, invalid rows pinned
    to ``pad_value * w`` (same op order as the JAX and numpy paths)."""
    v = ((x - mean) / std) * w
    if valid is None:
        return v
    return torch.where(valid[..., None], v, pad_value * w)


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


def identity_affine(d: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(mean=0, std=1, w=1) vectors — raw == normalised == weighted.  For
    tests and synthetic callers whose features are already in model space."""
    return (np.zeros(d, np.float32), np.ones(d, np.float32),
            np.ones(d, np.float32))

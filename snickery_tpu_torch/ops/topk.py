"""Top-k preselect helpers in PyTorch (counterpart of ``snickery_tpu.ops.topk``).

- :func:`preselect_margin`: the rank-margin policy, unchanged.
- :func:`order_topk_positions`: canonical (value, id) candidate order, an
  exact port of the JAX function.
- :func:`smallest_k`: exact k smallest (value, column) pairs per row, the
  selection (and cross-chunk merge) primitive of the plain preselects.
- :func:`topk_preselect`: plain chunked-matmul preselect over a normalised
  (or raw + affine) DB, the non-zero-transient form, with the fused
  quinphone penalties and voice partition.  The kernel form is in
  :mod:`snickery_tpu_torch.ops.cuda_topk`.
- :func:`quinphone_penalties`, :func:`halfphone_exact_rank`,
  :func:`halfphone_lattice_mask`: the halfphone helpers, exact ports.
"""

from __future__ import annotations

import numpy as np
import torch

from snickery_tpu_torch.const import (BIG_PENALTY, ID_RANK_PENALTY, PRESELECT_MARGIN,
                                PRESELECT_MARGIN_SPLIT3CAT,
                                QUINPHONE_CONTEXT_WEIGHTS, QUINPHONE_SCALE)
from snickery_tpu_torch.voicedb.device_layout import affine_rows


def preselect_margin(use_kernel: bool, mm_precision: str,
                     halfphone: bool = False, zero_transient: bool = False,
                     override: int = -1) -> int:
    """Extra preselect rank slots (same policy as the JAX package).

    The zero-transient kernel ranks with the DB affine folded into the
    targets, a differently rounded f32 expression than the exact rescore, so
    it selects k + margin and the caller keeps the exact top k.
    ``override`` >= 0 forces the margin (config key ``preselect_margin``).
    """
    if override >= 0:
        return override
    if use_kernel and (mm_precision != "highest" or zero_transient):
        if mm_precision == "split3cat":
            return PRESELECT_MARGIN_SPLIT3CAT
        return PRESELECT_MARGIN
    return 0


def _sortable_key(vals: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """int64 keys whose order is the (value, column) lexicographic order.

    The f32 bits map to an int32 that sorts like the float (negative values
    get their magnitude bits flipped; -0.0 is folded onto +0.0 first), and
    the column fills the low 32 bits.  Keys are unique per row, so a top-k
    over them is exact and deterministic, and :func:`_from_key` recovers
    both parts bit for bit."""
    bits = (vals + 0.0).view(torch.int32)
    key32 = bits ^ ((bits >> 31) & 0x7FFFFFFF)
    return (key32.to(torch.int64) << 32) | cols.to(torch.int64)


def _from_key(keys: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    key32 = (keys >> 32).to(torch.int32)
    bits = key32 ^ ((key32 >> 31) & 0x7FFFFFFF)
    return bits.view(torch.float32), keys & 0xFFFFFFFF


def smallest_k(scores: torch.Tensor, k: int, cols: torch.Tensor | None = None
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """The k smallest (value, column) pairs of each row of ``scores`` (T, C),
    ascending, lowest column first on equal values.  ``cols`` gives the
    column ids, (C,) or (T, C), distinct within a row (default 0..C-1).
    Returns (values (T, k) f32, columns (T, k) int64)."""
    if cols is None:
        cols = torch.arange(scores.shape[1], device=scores.device)
    keys = torch.topk(_sortable_key(scores, cols), k, dim=1, largest=False,
                      sorted=True).values
    return _from_key(keys)


def topk_preselect(targets: torch.Tensor, db: torch.Tensor, k: int,
                   chunk: int = 8192,
                   db_affine: tuple | None = None,
                   linguistic: tuple | None = None,
                   partition: tuple | None = None,
                   ling_weights: tuple | None = None
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k nearest DB rows per target row (exact), plain PyTorch.

    ``targets`` (T, d) and ``db`` (M, d) are normalised and weighted, or,
    with ``db_affine = (mean, std, sqrt_w, n_real)``, ``db`` holds RAW rows
    that are normalised chunk by chunk here, rows >= n_real pinned to the
    1e6 never-wins sentinel.  Scores are squared distances minus ||t||^2.
    ``linguistic = (tgt_codes (T,), tgt_ctx (T, 5), db_codes (M,),
    db_ctx (M, 5))`` adds :func:`quinphone_penalties` (weights
    ``ling_weights = (w0..w4, scale)``, default the const values) chunk by
    chunk; ``partition = (tgt_part (T,), db_part (M,))`` sets +inf where
    the ids differ.
    Returns (indices (T, k) int32, scores (T, k) f32) ascending by
    (score, index).
    """
    M = db.shape[0]
    if M % chunk:
        raise ValueError(f"db rows {M} must be a multiple of chunk {chunk}")
    if not 1 <= k <= M:
        raise ValueError(f"k={k} must lie in [1, {M}]")
    w_ctx, scale = (None, None) if ling_weights is None else (ling_weights[:5],
                                                              ling_weights[5])
    vals, cols = [], []
    for lo in range(0, M, chunk):
        db_c = db[lo:lo + chunk]
        if db_affine is not None:
            mean, std, w, n_real = db_affine
            valid = torch.arange(lo, lo + chunk, device=db.device) < n_real
            db_c = affine_rows(db_c, mean, std, w, valid, 1e6)
        sq_c = torch.sum(db_c * db_c, dim=-1)
        scores = sq_c[None, :] - 2.0 * (targets @ db_c.T)
        if linguistic is not None:
            tc, tx, dc, dx = linguistic
            scores = scores + quinphone_penalties(
                tc, tx, dc[lo:lo + chunk], dx[lo:lo + chunk],
                context_weights=w_ctx, scale=scale)
        if partition is not None:
            tp, dp = partition
            scores = torch.where(tp[:, None] != dp[None, lo:lo + chunk],
                                 float("inf"), scores)
        v, c = smallest_k(scores, min(k, chunk),
                          torch.arange(lo, lo + chunk, device=db.device))
        vals.append(v)
        cols.append(c)
    v, c = smallest_k(torch.cat(vals, 1), k, torch.cat(cols, 1))
    return c.to(torch.int32), v


def order_topk_positions(vals: torch.Tensor, ids: torch.Tensor,
                         k: int) -> torch.Tensor:
    """Positions of the k smallest (value, id) pairs per row of (T, n),
    ascending: k argmin sweeps, ties in value broken by the lowest id, the
    float64 oracle's (value, index) convention.  An exact port of
    ``snickery_tpu.ops.topk.order_topk_positions``, including its behaviour
    on exhausted rows (all +inf and already extracted) and for k > n
    (zero-filled)."""
    T, n = vals.shape
    iota = torch.arange(n, dtype=torch.int32, device=vals.device).expand(T, n)
    big = 2 ** 30               # python scalars: no host-to-device copies
    v, idd = vals, ids.to(torch.int32)
    outs = []
    for _ in range(min(k, n)):
        m = v.min(dim=1).values
        tied = v == m[:, None]
        sel_id = torch.where(tied, idd, big).min(dim=1).values
        hit = tied & (idd == sel_id[:, None])
        pos = torch.where(hit, iota, n).min(dim=1).values
        outs.append(torch.clamp(pos, max=n - 1))
        # retire the extracted entry: value -> +inf AND id -> big
        v = torch.where(hit, float("inf"), v)
        idd = torch.where(hit, big, idd)
    outp = torch.stack(outs, dim=1)
    if outp.shape[1] < k:
        outp = torch.nn.functional.pad(outp, (0, k - outp.shape[1]))
    return outp.to(torch.int64)


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(np.float32(x), device=like.device)


def quinphone_penalties(target_codes: torch.Tensor, target_contexts: torch.Tensor,
                        db_codes: torch.Tensor, db_contexts: torch.Tensor,
                        code_mismatch_penalty: float = ID_RANK_PENALTY,
                        context_weights: tuple | None = None,
                        scale: float | None = None) -> torch.Tensor:
    """(T, M) additive linguistic-preselection penalties, ``hard + soft *
    scale`` as ``snickery_tpu.ops.topk.quinphone_penalties`` computes them:
    ``code_mismatch_penalty`` where the halfphone codes differ, plus the
    weighted count of quinphone context slots that differ."""
    if context_weights is None:
        context_weights = QUINPHONE_CONTEXT_WEIGHTS
    if scale is None:
        scale = QUINPHONE_SCALE
    zero = _f32(0.0, target_codes)
    hard = torch.where(target_codes[:, None] != db_codes[None, :],
                       _f32(code_mismatch_penalty, target_codes), zero)
    w = torch.tensor(np.asarray(context_weights, np.float32), device=target_codes.device)
    mism = (target_contexts[:, None, :] != db_contexts[None, :, :]).to(torch.float32)
    soft = torch.einsum("tmc,c->tm", mism, w)
    return hard + soft * _f32(float(scale), soft)


def halfphone_exact_rank(sq_exact: torch.Tensor, kernel_scores: torch.Tensor,
                         mism: torch.Tensor, ctx_cand: torch.Tensor,
                         tgt_ctx: torch.Tensor, ling_weights: tuple | None
                         ) -> torch.Tensor:
    """Exact-f32 ranking key of pooled halfphone candidates: squared
    distance + ``ID_RANK_PENALTY`` on an identity mismatch + ``w * scale``
    per differing context slot; +inf where the preselect slot was dead.
    The same constants and summation order as the JAX function."""
    if ling_weights is None:
        ling_weights = (*QUINPHONE_CONTEXT_WEIGHTS, QUINPHONE_SCALE)
    *ctx_w, scale = ling_weights
    pen = _f32(ID_RANK_PENALTY, sq_exact) * mism.to(torch.float32)
    cmism = ctx_cand != tgt_ctx[..., None, :]
    for c, w in enumerate(ctx_w):
        if w:
            pen = pen + _f32(w * scale, sq_exact) * cmism[..., c].to(torch.float32)
    return torch.where(torch.isinf(kernel_scores), float("inf"), sq_exact + pen)


def halfphone_lattice_mask(ac: torch.Tensor, mism: torch.Tensor) -> torch.Tensor:
    """Identity fallback rule on lattice target costs, in mask form: a
    mismatched candidate is raised to at least ``BIG_PENALTY`` only at steps
    where a live same-name candidate exists; elsewhere the acoustic costs
    stay as they are (see the JAX function for the f32 rationale)."""
    has_match = torch.any(~mism & torch.isfinite(ac), dim=-1)
    return torch.where(mism & has_match[..., None],
                       torch.maximum(ac, _f32(BIG_PENALTY, ac)), ac)

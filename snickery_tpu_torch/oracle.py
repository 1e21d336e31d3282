"""Float64 numpy oracle: the CPU reference implementation (a copy of
``snickery_tpu.oracle``, which the port's card runs are gated on).

The acceptance criterion is ">=99% unit-sequence agreement vs the CPU
reference" (BASELINE.json).  The upstream reference was not available
(SURVEY.md provenance warning), so this module
serves as the reference-side implementation: a deliberately simple,
loop-level float64 numpy implementation of exactly the algorithm the
reference implements per SURVEY.md §3.2 — KD-tree-equivalent exhaustive
preselection, weighted-Euclidean target/join costs, full O(T·N²) Viterbi —
against which the TPU pipeline's selected unit sequences are scored.

No jax imports here: this file must stay an independent oracle.
"""

from __future__ import annotations

import numpy as np

BIG = 1.0e10


def preselect(targets: np.ndarray, db: np.ndarray, k: int,
              extra: np.ndarray | None = None) -> tuple[np.ndarray, np.ndarray]:
    """Exhaustive k-nearest preselection (== KDTree.query on the same data).

    targets (T, d), db (M, d): both already normalised and sqrt-weight scaled.
    Returns (indices (T, k), squared distances (T, k)) in ascending order,
    ties broken by lower index (numpy stable argsort via distance then index).
    """
    t64 = targets.astype(np.float64)
    d64 = db.astype(np.float64)
    T = len(t64)
    idx = np.zeros((T, k), np.int64)
    dist = np.zeros((T, k), np.float64)
    for t in range(T):
        diff = d64 - t64[t][None, :]
        sq = np.einsum("md,md->m", diff, diff)
        if extra is not None:
            sq = sq + extra[t]
        order = np.argsort(sq, kind="stable")[:k]
        idx[t] = order
        dist[t] = sq[order]
    return idx, dist


def preselect_fast(targets: np.ndarray, db: np.ndarray, k: int,
                   extra: np.ndarray | None = None,
                   n_threads: int = 16) -> tuple[np.ndarray, np.ndarray]:
    """GEMM-identity variant of :func:`preselect` (still float64, still
    exhaustive, still first-k-by-(value, index) tie-breaking): ||t-u||^2 =
    ||t||^2 - 2 t.u + ||u||^2 via blocked, threaded f64 matmuls (numpy
    releases the GIL inside dgemm), and selection via np.partition + a
    tie-inclusive mask instead of a full-width sort.  Identical results to
    :func:`preselect` (cross-checked in tests/test_ops.py); ~20x faster at
    1M units — the bench's at-scale agreement gate."""
    from concurrent.futures import ThreadPoolExecutor

    t64 = targets.astype(np.float64)
    T = len(t64)
    M = len(db)
    tsq = (t64 * t64).sum(axis=1)[:, None]
    sq = np.empty((T, M), np.float64)
    blocks = [(lo, min(lo + 131072, M)) for lo in range(0, M, 131072)]

    def fill(b):
        lo, hi = b
        d64 = db[lo:hi].astype(np.float64)
        sq[:, lo:hi] = ((d64 * d64).sum(axis=1)[None, :]
                        - 2.0 * t64 @ d64.T + tsq)

    with ThreadPoolExecutor(max_workers=n_threads) as ex:
        list(ex.map(fill, blocks))
    if extra is not None:
        sq = sq + extra

    # kth smallest value per row, then all indices with value <= kth in
    # index order: identical set AND order semantics to a stable argsort
    # (ties at the boundary resolve to the lowest indices)
    kth = np.partition(sq, k - 1, axis=1)[:, k - 1]
    idx = np.zeros((T, k), np.int64)
    dist = np.zeros((T, k), np.float64)
    for t in range(T):
        cand = np.flatnonzero(sq[t] <= kth[t])        # index order
        vals = sq[t, cand]
        keep = np.lexsort((cand, vals))[:k]           # (value, index) order
        idx[t] = cand[keep]
        dist[t] = vals[keep]
    return idx, dist


def viterbi(
    target_costs: np.ndarray,    # (T, N) float64
    join_left: np.ndarray,       # (T, N, dj)
    join_right: np.ndarray,      # (T, N, dj)
    join_cost_weight: float = 1.0,
    search_epsilon: float = 0.0,
) -> tuple[np.ndarray, float]:
    """Classic O(T·N²) DP with first-minimum tie-breaking (np.argmin)."""
    T, N = target_costs.shape
    tc = target_costs.astype(np.float64)
    jl = join_left.astype(np.float64)
    jr = join_right.astype(np.float64)
    cost = tc[0].copy()
    back = np.zeros((T, N), np.int64)
    for t in range(1, T):
        diff = jr[t - 1][:, None, :] - jl[t][None, :, :]
        dists = np.sqrt(np.maximum(np.einsum("ijd,ijd->ij", diff, diff), 0.0))
        running = cost.copy()
        if search_epsilon > 0.0:
            running[running > running.min() + search_epsilon] = BIG
        trans = running[:, None] + join_cost_weight * dists
        back[t] = np.argmin(trans, axis=0)
        cost = trans[back[t], np.arange(N)] + tc[t]
    path = np.zeros(T, np.int64)
    path[T - 1] = int(np.argmin(cost))
    for t in range(T - 1, 0, -1):
        path[t - 1] = back[t, path[t]]
    return path, float(cost[path[T - 1]])


def greedy(
    target_costs: np.ndarray,
    join_left: np.ndarray,
    join_right: np.ndarray,
    join_cost_weight: float = 1.0,
) -> tuple[np.ndarray, float]:
    """Greedy online selection oracle."""
    T, N = target_costs.shape
    path = np.zeros(T, np.int64)
    path[0] = int(np.argmin(target_costs[0]))
    total = float(target_costs[0, path[0]])
    ctx = join_right[0, path[0]].astype(np.float64)
    for t in range(1, T):
        d = np.sqrt(np.maximum(
            ((join_left[t].astype(np.float64) - ctx[None, :]) ** 2).sum(-1), 0.0))
        score = target_costs[t] + join_cost_weight * d
        path[t] = int(np.argmin(score))
        total += float(score[path[t]])
        ctx = join_right[t, path[t]].astype(np.float64)
    return path, total


def overlap_add(
    waves: np.ndarray,
    cut_start: np.ndarray,
    cut_end: np.ndarray,
    taper: int,
) -> np.ndarray:
    """Reference-style python OLA loop with the same crossfade semantics as
    ops/ola.py (complementary raised-cosine ramps over 2*taper samples)."""
    spans = (cut_end - cut_start).astype(np.int64)
    total = int(spans.sum()) + 2 * taper
    out = np.zeros(total, np.float64)
    t2 = 2 * taper
    ramp = 0.5 - 0.5 * np.cos(np.pi * (np.arange(t2) + 0.5) / t2)
    anchor = taper
    n = len(waves)
    for s, e, span in zip(cut_start, cut_end, spans):
        L = int(span) + t2
        src0 = int(s) - taper
        frag = np.zeros(L, np.float64)
        lo = max(src0, 0)
        hi = min(src0 + L, n)
        if hi > lo:
            frag[lo - src0: hi - src0] = waves[lo:hi]
        win = np.ones(L)
        win[:t2] = np.minimum(win[:t2], ramp)
        win[-t2:] = np.minimum(win[-t2:], ramp[::-1])
        dst0 = anchor - taper
        out[dst0: dst0 + L] += frag * win
        anchor += int(span)
    return out.astype(np.float32)


def synth_pipeline(
    targets_w: np.ndarray,        # (T, D) normalised + sqrt-weighted targets
    db_feats_w: np.ndarray,       # (M, D) normalised + sqrt-weighted DB features
    db_jl_w: np.ndarray,          # (M, dj)
    db_jr_w: np.ndarray,
    n_candidates: int,
    join_cost_weight: float = 1.0,
    search_epsilon: float = 0.0,
    use_greedy: bool = False,
    extra: np.ndarray | None = None,
    fast_preselect: bool = False,
    lattice_penalty: np.ndarray | None = None,
) -> tuple[np.ndarray, float]:
    """End-to-end selection oracle -> (unit ids (T,), total cost).

    ``extra`` (T, M): additive preselect-ranking penalties (linguistic
    preselection) — they decide WHO preselects, not the lattice costs.
    ``lattice_penalty`` (T, M): penalties that DO follow candidates into the
    lattice target costs (the halfphone identity fallback rule — matches
    synth.synth_pipeline_step).
    """
    pre = preselect_fast if fast_preselect else preselect
    cand_idx, cand_sq = pre(targets_w, db_feats_w, n_candidates, extra=extra)
    if extra is not None:
        # recompute pure acoustic distances for the selected candidates
        T = len(targets_w)
        tc = np.zeros_like(cand_sq)
        for t in range(T):
            diff = db_feats_w[cand_idx[t]].astype(np.float64) - targets_w[t][None, :]
            tc[t] = np.sqrt(np.maximum(np.einsum("nd,nd->n", diff, diff), 0.0))
    else:
        tc = np.sqrt(np.maximum(cand_sq, 0.0))
    if lattice_penalty is not None:
        # MASK semantics (matches synth.synth_pipeline_step): a penalised
        # candidate is excluded (BIG) only at steps where an unpenalised
        # candidate exists; at steps where every candidate is penalised the
        # costs stay untouched so the acoustically best fallback wins.
        # (Adding the penalty instead is equivalent in exact arithmetic —
        # a constant added to every candidate of a step shifts all paths
        # equally — but would make the device's f32 costs absorb the
        # acoustic detail the fallback choice depends on.)
        pen = np.take_along_axis(lattice_penalty, cand_idx, axis=1)
        has_match = (pen == 0).any(axis=1)
        tc = np.where((pen > 0) & has_match[:, None], np.maximum(tc, BIG), tc)
    jl = db_jl_w[cand_idx]
    jr = db_jr_w[cand_idx]
    if use_greedy:
        path, cost = greedy(tc, jl, jr, join_cost_weight)
    else:
        path, cost = viterbi(tc, jl, jr, join_cost_weight, search_epsilon)
    return cand_idx[np.arange(len(path)), path], cost

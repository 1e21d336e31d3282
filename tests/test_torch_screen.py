"""The screened sparse epilogue of the CUDA preselect kernels, modelled in
numpy, against the plain twin's exact selection.

The kernels (``snickery_tpu_torch/csrc/topk_preselect.cuh``) no longer offer
every score of a tile to the k-slot lists.  A finished score is compared
with its target's worst kept score (``<=`` in the cheap test, the exact
(score, row) order where that hits) and only the survivors go to a bounded queue,
which the warps drain in whatever order the entries landed; entries that
find the queue full stay pending, are screened again against the lowered
worst and queued again, until none is left.  That is exact only if the
top-k under a total order does not depend on the order of insertion, and
if a stale (larger) worst score only lets more through.  The model below
does the same with tiles offered in turn, a seeded shuffle of every drain,
a queue of a few entries and, optionally, a worst score read one tile late;
it must return exactly ``cuda_topk._exact_select``'s ids and scores.  The
edge cases of ``kernel_check.EDGE_CASES`` run here through the twin, which
also shows that their score ramps do what their names say.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from snickery_tpu_torch.kernel_check import EDGE_CASES, EDGE_K, run_edge_case
from snickery_tpu_torch.ops import cuda_topk

INT_MAX = np.iinfo(np.int32).max


def screened_topk(scores, k, tile_rows, cap, seed, stale=False, splits=1, pair=False):
    """(ids (T, k) int32, values (T, k) f32) of the model: per DB split a
    list of k (score, row) pairs a target, (+inf, INT_MAX) when empty; the
    splits' lists merged under the same order; dead slots read (+inf, 0).
    ``pair``: the screen compares (score, row) with the worst kept pair, as
    the kernels do, instead of ``score <= worst score``."""
    rng = np.random.default_rng(seed)
    T, M = scores.shape
    rows_per_split = -(-M // splits)
    lists = []
    for lo in range(0, M, rows_per_split):
        lv = np.full((T, k), np.inf, np.float32)
        li = np.full((T, k), INT_MAX, np.int64)
        seen = lv[:, k - 1].copy()          # the worst scores the screen reads
        seen_i = li[:, k - 1].copy()        # and their rows

        def insert(t, v, u):
            if not (v < lv[t, k - 1] or (v == lv[t, k - 1] and u < li[t, k - 1])):
                return
            p = int(np.sum((lv[t] < v) | ((lv[t] == v) & (li[t] < u))))
            lv[t, p + 1:], li[t, p + 1:] = lv[t, p:-1].copy(), li[t, p:-1].copy()
            lv[t, p], li[t, p] = v, u

        hi = min(lo + rows_per_split, M)
        for r0 in range(lo, hi, tile_rows):
            tile = scores[:, r0:min(r0 + tile_rows, hi)]
            worst = seen if stale else lv[:, k - 1]
            worst_i = seen_i if stale else li[:, k - 1]
            if pair:
                rows = np.arange(r0, r0 + tile.shape[1])[None, :]
                ok = (tile < worst[:, None]) | ((tile == worst[:, None])
                                                & (rows < worst_i[:, None]))
            else:
                ok = tile <= worst[:, None]
            tt, rr = np.nonzero(np.isfinite(tile) & ok)
            pending = [(int(t), float(tile[t, r]), r0 + int(r)) for t, r in zip(tt, rr)]
            seen, seen_i = lv[:, k - 1].copy(), li[:, k - 1].copy()
            while pending:
                order = rng.permutation(len(pending))
                queue = [pending[i] for i in order[:cap]]
                rest = [pending[i] for i in order[cap:]]
                for t, v, u in queue:
                    insert(t, np.float32(v), u)
                # what did not fit is screened again, against the lowered worst
                pending = [(t, v, u) for t, v, u in rest
                           if v < lv[t, k - 1] or (v == lv[t, k - 1]
                                                   and (u < li[t, k - 1] or not pair))]
        lists.append((lv, li))
    lv = np.concatenate([a for a, _ in lists], 1)
    li = np.concatenate([b for _, b in lists], 1)
    order = np.lexsort((li, lv), axis=1)[:, :k]
    v, i = np.take_along_axis(lv, order, 1), np.take_along_axis(li, order, 1)
    return np.where(np.isinf(v), 0, i).astype(np.int32), v


def twin_topk(scores, k):
    s = torch.from_numpy(scores)
    T, M = s.shape
    ids, vals = cuda_topk._exact_select(
        T, k, M, lambda t0, t1, lo, hi: s[t0:t1, lo:hi], None, None, False, None,
        t_block=5, chunk=7)
    return ids.numpy(), vals.numpy()


def make_scores(kind, T, M, seed):
    rng = np.random.default_rng(seed)
    s = rng.standard_normal((T, M)).astype(np.float32)
    if kind == "ties":                      # a handful of values: ties everywhere
        s = rng.integers(0, 4, (T, M)).astype(np.float32)
    elif kind == "duplicates":              # every row twice, some thrice
        s[:, M // 2:] = s[:, :M - M // 2]
        s[:, 1::5] = s[:, 0:1]
    elif kind == "inf_rows":                # masked rows; some targets keep < k rows
        s[rng.random((T, M)) < 0.6] = np.inf
        s[0] = np.inf
        s[1, 3:] = np.inf
    elif kind == "falling":                 # every score passes the screen
        s = (-np.arange(M, dtype=np.float32))[None, :] + 0.25 * s
    elif kind == "rising":                  # none after the first k rows
        s = np.arange(M, dtype=np.float32)[None, :] + 0.25 * s
    elif kind == "identical":
        s[:] = 1.5
    return s


KINDS = ["random", "ties", "duplicates", "inf_rows", "falling", "rising", "identical"]


@pytest.mark.parametrize("pair", [False, True], ids=["score", "pair"])
@pytest.mark.parametrize("stale", [False, True], ids=["fresh", "stale"])
@pytest.mark.parametrize("cap", [3, 16, 10 ** 6], ids=["cap3", "cap16", "no_overflow"])
@pytest.mark.parametrize("kind", KINDS)
def test_screened_epilogue_is_the_exact_topk(kind, cap, stale, pair):
    """Tiles offered in turn, survivors drained in a shuffled order and in
    parts when the queue overflows: exactly the twin's ids and scores."""
    T, M, k = 9, 157, 6
    scores = make_scores(kind, T, M, seed=len(kind) + cap % 7)
    want_i, want_v = twin_topk(scores, k)
    for seed in range(3):
        for splits in (1, 3):
            got_i, got_v = screened_topk(scores, k, tile_rows=16, cap=cap, seed=seed,
                                         stale=stale, splits=splits, pair=pair)
            np.testing.assert_array_equal(got_i, want_i)
            np.testing.assert_array_equal(got_v, want_v)


@pytest.mark.parametrize("kind", ["falling", "rising"])
def test_screen_lets_through_what_its_name_says(kind):
    """On falling scores every finite score of a tile passes the screen; on
    rising scores nothing does once the lists are full."""
    T, M, k, tile = 4, 96, 5, 16
    scores = make_scores(kind, T, M, seed=2)
    lv = np.sort(scores[:, :tile], 1)[:, :k]      # the lists after the first tile
    nxt = scores[:, tile:2 * tile]
    passed = int((nxt <= lv[:, k - 1:k]).sum())
    assert passed == (T * tile if kind == "falling" else 0)


@settings(max_examples=60, deadline=None)
@given(T=st.integers(1, 5), M=st.integers(1, 70), k=st.integers(1, 8),
       tile=st.sampled_from([1, 4, 16]), cap=st.integers(1, 40), splits=st.integers(1, 4),
       levels=st.integers(1, 6), inf_share=st.sampled_from([0.0, 0.3, 0.9]),
       stale=st.booleans(), pair=st.booleans(), seed=st.integers(0, 2 ** 16))
def test_screened_epilogue_hypothesis(T, M, k, tile, cap, splits, levels, inf_share, stale,
                                      pair, seed):
    """Small shapes with few score levels (ties everywhere), masked rows,
    any queue size, any number of splits, any drain order."""
    k = min(k, M)
    rng = np.random.default_rng(seed)
    scores = rng.integers(0, levels, (T, M)).astype(np.float32)
    scores[rng.random((T, M)) < inf_share] = np.inf
    want_i, want_v = twin_topk(scores, k)
    got_i, got_v = screened_topk(scores, k, tile, cap, seed, stale=stale,
                                 splits=min(splits, M), pair=pair)
    np.testing.assert_array_equal(got_i, want_i)
    np.testing.assert_array_equal(got_v, want_v)


@pytest.mark.parametrize("zt", [True, False], ids=["zt", "dv"])
@pytest.mark.parametrize("precision", ["highest", "split3cat"])
@pytest.mark.parametrize("edge", sorted(e for e in EDGE_CASES if not e.endswith("_splits")))
def test_edge_cases_on_the_twin(edge, precision, zt):
    """The card's edge cases run on the CPU through the twin (both sides of
    the comparison are the twin here), so their inputs and their own checks
    are exercised without a card."""
    err, nbad, dead = run_edge_case(edge, "cpu", precision, zt)
    assert err == 0.0 and nbad == 0
    k = EDGE_CASES[edge][3] or EDGE_K[precision]
    assert dead == (32 * (k - k // 2) + 8 * k if edge == "starved" else 0)


@pytest.mark.parametrize("kind", ["falling", "rising"])
def test_edge_case_ramps_order_the_rows(kind, monkeypatch):
    """"falling": the k best rows of every target are the last k, the last
    one first; "rising": the first k in order."""
    seen = {}
    real = cuda_topk.cuda_topk_preselect

    def spy(*a, **kw):
        seen["ids"] = real(*a, **kw)[0]
        return seen["ids"], real(*a, **kw)[1]

    monkeypatch.setattr("snickery_tpu_torch.kernel_check.cuda_topk_preselect", spy)
    run_edge_case(kind, "cpu", "highest", True)
    T, M, _, _, _ = EDGE_CASES[kind]
    k = EDGE_K["highest"]
    want = torch.arange(M - 1, M - 1 - k, -1) if kind == "falling" else torch.arange(k)
    assert torch.equal(seen["ids"].long(), want[None, :].expand(T, k))


# ---------------------------------------------------------------------------
# The "stream" selection's bulk-filled lists: a target's survivors of a DB
# tile are sorted by a warp's bitonic network and merged with its sorted list
# (or, FEW of them or fewer, inserted one at a time); a split's first tile
# passes every finite score and so fills the empty lists in bulk; a queue
# instead defers a warm tile's few survivors (the model's ``bucket``: they
# wait until they no longer fit or the split ends; any order of insertion
# gives the same top-k); pass 2 merges a target's split lists with gw warps,
# each merging its share of the lists in turn, then the first warp merging
# the others'.  The networks below are
# the kernel's (bitonic_step, bitonic_sort, merge_sorted in
# csrc/topk_preselect.cuh) element for element: a warp's 64 pairs, element
# i = 2 lane + r.

FEW = 8                  # the kernel's FEW
BUCKET = 8               # pairs the model defers a target before merging them
SLOTS = 64               # a warp's sequence: two pairs a lane
FLT_MAX = np.float32(np.finfo(np.float32).max)


def bitonic_step(v, x, s, d):
    """Element i against i ^ d; the lower index keeps the less pair where
    the block of s elements holding i sorts ascending."""
    i = np.arange(SLOTS)
    pv, px = v[i ^ d], x[i ^ d]
    keep_min = ((i & d) == 0) == ((i & s) == 0)
    p_less = (pv < v) | ((pv == v) & (px < x))
    m_less = (v < pv) | ((v == pv) & (x < px))
    take = np.where(keep_min, p_less, m_less)
    return np.where(take, pv, v), np.where(take, px, x)


def bitonic_sort(v, x, W):
    s = 2
    while s <= W:
        d = s // 2
        while d:
            v, x = bitonic_step(v, x, s, d)
            d //= 2
        s *= 2
    return v, x


def merge_sorted(l, lx, c, cx):
    """The 64 least pairs of two ascending sequences: element i against
    element 63 - i of c, then the last stage's half-cleaners."""
    rc, rcx = c[::-1], cx[::-1]
    take = (rc < l) | ((rc == l) & (rcx < lx))
    l, lx = np.where(take, rc, l), np.where(take, rcx, lx)
    d = SLOTS // 2
    while d:
        l, lx = bitonic_step(l, lx, SLOTS, d)
        d //= 2
    return l, lx


def padded(v, x, n=SLOTS):
    out_v = np.full(n, np.inf, np.float32)
    out_x = np.full(n, INT_MAX, np.int64)
    out_v[:len(v)], out_x[:len(x)] = v, x
    return out_v, out_x


def merge_batch(lv, li, cv, ci):
    """The kernel's merge_batch on one target's list (lv, li) of k slots,
    in place, with n <= 64 survivors (cv, ci) in any order."""
    k, n = len(lv), len(cv)
    if n <= FEW:
        for v, u in zip(cv, ci):
            if v < lv[-1] or (v == lv[-1] and u < li[-1]):
                p = int(np.sum((lv < v) | ((lv == v) & (li < u))))
                lv[p + 1:], li[p + 1:] = lv[p:-1].copy(), li[p:-1].copy()
                lv[p], li[p] = v, u
        return
    W = 2
    while W < n:
        W *= 2
    c, cx = bitonic_sort(*padded(cv, ci), W)
    assert np.all(c[:-1] <= c[1:]) and np.all(np.isinf(c[n:]))
    l, lx = merge_sorted(*padded(lv, li), c, cx)
    lv[:], li[:] = l[:k], lx[:k]


def bulk_topk(scores, k, tile_rows, splits, seed, gw=1, bucket=0):
    """(ids (T, k) int32, values (T, k) f32) of the model: per split of the
    rows, lists filled tile by tile (the screen reads each list's worst
    pair at the tile's start, +inf capped at FLT_MAX as screen_bits caps
    it), survivors merged in batches of 64 in a shuffled order, or with
    ``bucket`` held back while the target's bucket has room and the split
    has tiles left (and the bucket inserted first when it is flushed); then
    pass 2 with gw warps a target."""
    rng = np.random.default_rng(seed)
    T, M = scores.shape
    per = -(-M // splits)
    parts = []
    for lo in range(0, M, per):
        lv = np.full((T, k), np.inf, np.float32)
        li = np.full((T, k), INT_MAX, np.int64)
        held = [[] for _ in range(T)]
        hi = min(lo + per, M)
        for r0 in range(lo, hi, tile_rows):
            r1 = min(r0 + tile_rows, hi)
            last = r1 == hi
            tile, rows = scores[:, r0:r1], np.arange(r0, r1)
            w, wi = np.minimum(lv[:, -1], FLT_MAX)[:, None], li[:, -1][:, None]
            ok = (tile < w) | ((tile == w) & (rows[None, :] < wi))
            for t in range(T):
                got = rng.permutation(np.nonzero(ok[t])[0])
                if bucket and not last and len(held[t]) + len(got) <= bucket:
                    held[t] += [(tile[t, c], rows[c]) for c in got]
                    continue
                if held[t]:
                    merge_batch(lv[t], li[t], *map(np.array, zip(*held[t])))
                    held[t] = []
                for b in range(0, len(got), 64):
                    sel = got[b:b + 64]
                    merge_batch(lv[t], li[t], tile[t, sel], rows[sel])
            assert np.all(np.isfinite(lv) | (li == INT_MAX))      # +inf never enters
        parts.append((lv, li))
    out_v = np.empty((T, k), np.float32)
    out_i = np.empty((T, k), np.int64)
    for t in range(T):
        warps = []
        for w in range(gw):
            l, lx = padded([], [])
            for s in range(w, len(parts), gw):
                c, cx = padded(parts[s][0][t], parts[s][1][t])
                if cx[0] != INT_MAX:                               # an empty list is skipped
                    l, lx = merge_sorted(l, lx, c, cx)
            warps.append((l, lx))
        l, lx = warps[0]
        for c, cx in warps[1:]:
            l, lx = merge_sorted(l, lx, c, cx)
        out_v[t], out_i[t] = l[:k], np.where(lx[:k] == INT_MAX, 0, lx[:k])
    return out_i.astype(np.int32), out_v


def smallest_k_np(scores, k):
    from snickery_tpu_torch.ops.topk import smallest_k
    v, c = smallest_k(torch.from_numpy(scores), k)
    return torch.where(torch.isinf(v), 0, c).int().numpy(), v.numpy()


def bulk_scores(kind, T, M, seed, levels=None, inf_share=0.0):
    rng = np.random.default_rng(seed)
    s = make_scores(kind, T, M, seed) if kind in KINDS else None
    if kind == "levels":                    # few values: ties everywhere
        s = rng.integers(0, levels, (T, M)).astype(np.float32)
    elif kind == "falling_steps":           # a falling stream with repeated steps
        s = np.repeat(-np.arange(-(-M // 3), dtype=np.float32), 3)[None, :M].repeat(T, 0)
    if inf_share:
        s[rng.random((T, M)) < inf_share] = np.inf
    return np.ascontiguousarray(s, np.float32)


@pytest.mark.parametrize("kind", KINDS + ["falling_steps"])
@pytest.mark.parametrize("k,splits", [(1, 1), (40, 1), (40, 5), (64, 2), (64, 7)],
                         ids=["k1", "k40", "k40_cold_short", "k64", "k64_cold_short"])
def test_bulk_fill_is_the_exact_topk(kind, k, splits):
    """Tiles of 128, 64 and 16 rows, with and without buckets, a first tile
    that fills the lists in bulk, falling streams (every score survives),
    ties, bit-identical duplicates, +inf rows, splits shorter than k: the
    (score, row) top-k."""
    T, M = 5, 300
    scores = bulk_scores(kind, T, M, seed=k + splits)
    want = smallest_k_np(scores, k)
    for tile_rows, gw, bucket in ((128, 1, BUCKET), (64, 4, 0), (16, 2, BUCKET)):
        got = bulk_topk(scores, k, tile_rows, splits, seed=k, gw=gw, bucket=bucket)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])


@settings(max_examples=60, deadline=None)
@given(T=st.integers(1, 3), M=st.integers(1, 260), k=st.integers(1, 64),
       tile=st.sampled_from([16, 64, 128]), splits=st.integers(1, 6),
       gw=st.sampled_from([1, 2, 8]), bucket=st.sampled_from([0, BUCKET]),
       kind=st.sampled_from(["levels", "random", "falling", "duplicates", "identical",
                             "falling_steps"]),
       levels=st.integers(1, 6), inf_share=st.sampled_from([0.0, 0.3, 0.95]),
       seed=st.integers(0, 2 ** 16))
def test_bulk_fill_hypothesis(T, M, k, tile, splits, gw, bucket, kind, levels, inf_share,
                              seed):
    """Any k from 1 to MAX_K, any split count (cold splits shorter than k
    among them), any merge order: equal to smallest_k under the (score,
    row) order, dead slots (+inf, 0)."""
    k = min(k, M)
    scores = bulk_scores(kind, T, M, seed, levels, inf_share)
    want = smallest_k_np(scores, k)
    got = bulk_topk(scores, k, tile, min(splits, M), seed, gw, bucket)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("n", [4, 5, 17, 33, 63, 64])
def test_bitonic_network_sorts_and_merges(n):
    """The sort of n pairs over the next power of two, and the merge of two
    ascending sequences, on pairs with many ties: the ascending order, and
    the 64 least of the union."""
    rng = np.random.default_rng(n)
    v = rng.integers(0, 5, n).astype(np.float32)
    x = rng.permutation(1000)[:n]
    W = 1 << (n - 1).bit_length()
    sv, sx = bitonic_sort(*padded(v, x), W)
    order = np.lexsort((x, v))
    np.testing.assert_array_equal(sv[:n], v[order])
    np.testing.assert_array_equal(sx[:n], x[order])
    lv = np.sort(rng.integers(0, 5, 64).astype(np.float32))
    lx = np.arange(2000, 2064)
    mv, mx = merge_sorted(lv, lx, sv, sx)
    allv, allx = np.concatenate([lv, sv[:n]]), np.concatenate([lx, sx[:n]])
    order = np.lexsort((allx, allv))[:64]
    np.testing.assert_array_equal(mv, allv[order])
    np.testing.assert_array_equal(mx, allx[order])

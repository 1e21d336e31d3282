"""The preselect kernel's wrapper and plain twin vs the JAX Pallas kernel.

On the CPU the wrapper runs the plain twin (``topk_preselect_zt_plain``);
the Pallas kernel runs in interpret mode, as tests/test_pallas_topk.py runs
it.  The kernel itself runs only on a CUDA card, in
tests/test_torch_cuda_kernel.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from snickery_tpu.const import QUINPHONE_CONTEXT_WEIGHTS, QUINPHONE_SCALE
from snickery_tpu.ops.pallas_topk import pallas_topk_preselect
from snickery_tpu.synth import BACKOFF_LING_WEIGHTS
from snickery_tpu.voicedb.device_layout import build_raw_blocks
from snickery_tpu_torch.ops import cuda_topk
from snickery_tpu_torch.ops.cuda_topk import (cuda_topk_preselect, pack_meta,
                                              split_plan,
                                              topk_preselect_zt_plain)

DEFAULT_LING_WEIGHTS = (*QUINPHONE_CONTEXT_WEIGHTS, QUINPHONE_SCALE)
VARIANTS = {"part": (True, None), "ling": (False, DEFAULT_LING_WEIGHTS),
            "ling_part": (True, BACKOFF_LING_WEIGHTS)}


def _voice(seed, m, M, kd, dup=False):
    """Raw [data | sqn | ptr] block with jr exceptions and padding rows."""
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((m, kd)).astype(np.float32)
    if dup:
        feats[100:140] = feats[50]
    jr = np.empty((m, kd), np.float32)
    jr[:-1] = feats[1:]
    jr[-1] = rng.standard_normal(kd)
    jr[39::40] = rng.standard_normal((len(jr[39::40]), kd))
    aff = ((0.1 * rng.standard_normal(kd)).astype(np.float32),
           rng.uniform(0.5, 2.0, kd).astype(np.float32),
           rng.uniform(0.2, 1.0, kd).astype(np.float32))
    raw, _, _ = build_raw_blocks(feats, jr, M, affine=aff)
    return rng, raw, aff


@pytest.mark.parametrize("m,dup", [(8192 - 700, False), (8192, True)])
def test_zt_plain_matches_pallas_interpret(m, dup):
    """T=256, M=8192, kd=151, k=40: identical id sets; scores (with comp
    added back) rtol 1e-5 / atol 1e-3 -- f32 sums of 151 products in another
    order, on scores of magnitude ~1e2.

    With 41 bit-identical DB rows (50 and 100..139) the Pallas stream
    select may keep any members of that class at the k boundary (it
    replaces the first of several equal worst slots); the port keeps the
    lowest indices.  There ids are compared up to the class, and the
    port's members must be the class's lowest."""
    Tn, M, kd, k = 256, 8192, 151, 40
    rng, raw, aff = _voice(7 + m, m, M, kd, dup)
    targets = rng.standard_normal((Tn, kd)).astype(np.float32)
    ri, rv = pallas_topk_preselect(
        jnp.asarray(targets), jnp.asarray(raw), k=k, interpret=True,
        mm_precision="highest", sort=True, zero_transient=True, m_rows=M,
        db_affine=(*map(jnp.asarray, aff), jnp.int32(m)))
    gi, gv = cuda_topk_preselect(torch.from_numpy(targets), torch.from_numpy(raw),
                                 k, tuple(map(torch.from_numpy, aff)), M)
    ri, rv, gi, gv = np.asarray(ri), np.asarray(rv), gi.numpy(), gv.numpy()
    assert gi.dtype == np.int32 and gv.dtype == np.float32
    assert (gi < m).all(), "padding rows must never be selected"
    alias = np.arange(M)
    if dup:
        klass = np.r_[50, 100:140]
        alias[klass] = 50
        for row in gi:
            members = np.sort(row[np.isin(row, klass)])
            np.testing.assert_array_equal(members, klass[:len(members)])
    o_r, o_g = np.argsort(alias[ri], 1), np.argsort(alias[gi], 1)
    np.testing.assert_array_equal(np.take_along_axis(alias[gi], o_g, 1),
                                  np.take_along_axis(alias[ri], o_r, 1))
    np.testing.assert_allclose(np.take_along_axis(gv, o_g, 1),
                               np.take_along_axis(rv, o_r, 1), rtol=1e-5, atol=1e-3)
    # ascending (score, index) order, lowest index first on ties
    assert (np.diff(gv, axis=1) >= 0).all()
    tie = np.diff(gv, axis=1) == 0
    assert (np.diff(gi.astype(np.int64), axis=1)[tie] > 0).all()


def _labels(rng, T, M, m):
    """Halfphone codes (20 names), quinphone contexts (9 phones) and voice
    ids (3 voices) for targets and DB rows, with the hard cases: 8 targets
    whose code no DB row carries (the fallback pool), 6 targets of a voice
    with 5 rows (fewer than k: starved slots), 2 of a voice with none, and
    padding rows [m, M) labelled -1 as the synthesiser pads them."""
    tc = rng.integers(0, 20, T).astype(np.int32)
    tc[:8] = 99
    tx = rng.integers(0, 9, (T, 5)).astype(np.int32)
    tv = rng.integers(0, 3, T).astype(np.int32)
    tv[10:16] = 3
    tv[16:18] = 4
    dc = rng.integers(0, 20, M).astype(np.int32)
    dx = rng.integers(0, 9, (M, 5)).astype(np.int32)
    dv = rng.integers(0, 3, M).astype(np.int32)
    dv[rng.choice(m, 5, replace=False)] = 3
    dc[m:], dx[m:], dv[m:] = -1, -1, -1
    return tc, tx, tv, dc, dx, dv


def _assert_topk_equal(gi, gv, ri, rv):
    """Per row after (score, id) sorting: scores within rtol 1e-5 / atol 1e-3
    (penalised scores sit near 2^24, where the f32 ulp is 2), (+inf, 0) in
    the same slots, and the same ids below the row's worst kept score; only
    slots tied with the worst may hold other members of the tie."""
    og, orr = np.lexsort((gi, gv), axis=1), np.lexsort((ri, rv), axis=1)
    gi, gv = np.take_along_axis(gi, og, 1), np.take_along_axis(gv, og, 1)
    ri, rv = np.take_along_axis(ri, orr, 1), np.take_along_axis(rv, orr, 1)
    np.testing.assert_allclose(gv, rv, rtol=1e-5, atol=1e-3)
    dead = np.isinf(rv)
    assert (gi[dead] == 0).all() and (ri[dead] == 0).all()
    worst = np.where(dead, -np.inf, rv).max(1, keepdims=True)
    below = ~dead & (rv < worst - (1e-5 * np.abs(worst) + 1e-3))
    for g, r, b in zip(gi, ri, below):
        assert set(g[b]) == set(r[b])


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_masked_plain_matches_pallas_interpret(variant):
    """The twin's fused partition mask and quinphone penalties vs the Pallas
    kernel's (zero-transient, interpret mode), T=256, M=8192 (two chunks),
    kd=24, k=12: the same scores and ids, (+inf, 0) in starved slots, no
    voice leaks."""
    partition, weights = VARIANTS[variant]
    Tn, M, kd, k, m = 256, 8192, 24, 12, 8192 - 300
    rng, raw, aff = _voice(17, m, M, kd)
    targets = rng.standard_normal((Tn, kd)).astype(np.float32)
    tc, tx, tv, dc, dx, dv = _labels(rng, Tn, M, m)
    J = jnp.asarray
    ri, rv = pallas_topk_preselect(
        J(targets), J(raw), k=k, interpret=True, mm_precision="highest",
        sort=True, zero_transient=True, m_rows=M,
        db_affine=(*map(J, aff), jnp.int32(m)),
        partition=(J(tv), J(dv)) if partition else None,
        linguistic=(J(tc), J(tx), J(dc), J(dx)) if weights else None,
        ling_weights=weights)
    P = torch.from_numpy
    gi, gv = cuda_topk_preselect(
        P(targets), P(raw), k, tuple(map(P, aff)), M,
        tgt_meta=pack_meta(P(tc), P(tx), P(tv)), db_meta=pack_meta(P(dc), P(dx), P(dv)),
        partition=partition, ling_weights=weights)
    gi, gv = gi.numpy(), gv.numpy()
    _assert_topk_equal(gi, gv, np.asarray(ri), np.asarray(rv))
    live = np.isfinite(gv)
    assert (gi[live] < m).all(), "padding rows must never be selected"
    if partition:
        assert (dv[gi][live] == np.broadcast_to(tv[:, None], gi.shape)[live]).all()
        assert np.isinf(gv[10:18, 5:]).all() and (gi[10:18, 5:] == 0).all()
        assert np.isinf(gv[16:18]).all()
    else:
        assert live.all()
    if weights:
        # a same-name row ranks first wherever the target's voice has one
        pool = (dc[None, :m] == tc[:, None]) & (
            (dv[None, :m] == tv[:, None]) if partition else True)
        has = pool.any(1)
        assert has[8:].mean() > 0.8 and not has[:8].any()
        assert (dc[gi[has, 0]] == tc[has]).all()


@pytest.mark.parametrize("variant", [None, *sorted(VARIANTS)])
def test_zt_plain_blocking_invariant(variant):
    """The twin's target blocking and DB chunking do not change its result,
    including a ragged last chunk and m_rows short of the block, with and
    without the fused masks."""
    rng, raw, aff = _voice(3, 3000, 3000, 24)
    tg = torch.from_numpy(rng.standard_normal((100, 24)).astype(np.float32))
    kw = {}
    if variant:
        tc, tx, tv, dc, dx, dv = map(torch.from_numpy, _labels(rng, 100, 3000, 2900))
        kw = dict(tgt_meta=pack_meta(tc, tx, tv), db_meta=pack_meta(dc, dx, dv),
                  partition=VARIANTS[variant][0], ling_weights=VARIANTS[variant][1])
    args = (tg, torch.from_numpy(raw), 12, tuple(map(torch.from_numpy, aff)), 2900)
    i0, v0 = topk_preselect_zt_plain(*args, **kw)
    i1, v1 = topk_preselect_zt_plain(*args, t_block=7, chunk=333, **kw)
    assert torch.equal(i0, i1) and torch.equal(v0, v1)
    assert (i0 < 2900).all()


def test_pack_meta_layout_and_kernel_names():
    codes = torch.tensor([3, -1], dtype=torch.int32)
    ctx = torch.arange(10, dtype=torch.int64).reshape(2, 5)
    vids = torch.tensor([7, 0])
    m = pack_meta(codes, ctx, vids)
    assert m.dtype == torch.int32 and m.shape == (2, cuda_topk.META_WIDTH)
    assert m.tolist() == [[3, 0, 1, 2, 3, 4, 7, 0], [-1, 5, 6, 7, 8, 9, 0, 0]]
    names = {cuda_topk.kernel_name(p, q) for p in (False, True) for q in (False, True)}
    assert names == set(cuda_topk.KERNELS.values()) and len(names) == 4
    assert cuda_topk.kernel_name(False, False) == cuda_topk.KERNEL
    assert cuda_topk.penalty_constants((0.3, 10.0, 0.0, 10.0, 1.0, 100.0)) == (
        float(np.float32(0.3 * 100.0)), 1000.0, 0.0, 1000.0, 100.0)


def test_wrapper_rejects_bad_inputs():
    rng, raw, aff = _voice(4, 1000, 1024, 24)
    tg = torch.from_numpy(rng.standard_normal((10, 24)).astype(np.float32))
    R, A = torch.from_numpy(raw), tuple(map(torch.from_numpy, aff))
    with pytest.raises(TypeError):
        cuda_topk_preselect(tg.double(), R, 8, A, 1024)
    with pytest.raises(ValueError, match="width"):
        cuda_topk_preselect(tg, R[:, :-1].contiguous(), 8, A, 1024)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_topk_preselect(tg.t().contiguous().t(), R, 8, A, 1024)
    with pytest.raises(ValueError, match="k="):
        cuda_topk_preselect(tg, R, cuda_topk.MAX_K + 1, A, 1024)
    with pytest.raises(ValueError, match="m_rows"):
        cuda_topk_preselect(tg, R, 8, A, R.shape[0] + 1)
    with pytest.raises(ValueError, match="db_affine"):
        cuda_topk_preselect(tg, R, 8, A[:2], 1024)
    with pytest.raises(ValueError, match="device"):
        cuda_topk_preselect(tg.to("meta"), R.to("meta"), 8,
                            tuple(a.to("meta") for a in A), 1024)
    tm = torch.zeros((10, cuda_topk.META_WIDTH), dtype=torch.int32)
    dm = torch.zeros((1024, cuda_topk.META_WIDTH), dtype=torch.int32)
    with pytest.raises(ValueError, match="tgt_meta and db_meta"):
        cuda_topk_preselect(tg, R, 8, A, 1024, partition=True)
    with pytest.raises(ValueError, match="db_meta"):
        cuda_topk_preselect(tg, R, 8, A, 1024, tgt_meta=tm, db_meta=dm[:1000],
                            partition=True)
    with pytest.raises(ValueError, match="tgt_meta"):
        cuda_topk_preselect(tg, R, 8, A, 1024, tgt_meta=tm.long(), db_meta=dm,
                            ling_weights=DEFAULT_LING_WEIGHTS)


@pytest.mark.parametrize("variant", [None, *sorted(VARIANTS)])
def test_cpu_tensors_take_the_plain_twin(variant):
    """A CPU tensor goes through the twin and never counts a kernel launch."""
    rng, raw, aff = _voice(5, 512, 512, 16)
    tg = torch.from_numpy(rng.standard_normal((9, 16)).astype(np.float32))
    kw = {}
    if variant:
        tc, tx, tv, dc, dx, dv = map(torch.from_numpy, _labels(rng, 9, 512, 500))
        kw = dict(tgt_meta=pack_meta(tc, tx, tv), db_meta=pack_meta(dc, dx, dv),
                  partition=VARIANTS[variant][0], ling_weights=VARIANTS[variant][1])
    before = dict(cuda_topk.LAUNCH_COUNTS)
    a = cuda_topk_preselect(tg, torch.from_numpy(raw), 6,
                            tuple(map(torch.from_numpy, aff)), 512, **kw)
    b = topk_preselect_zt_plain(tg, torch.from_numpy(raw), 6,
                                tuple(map(torch.from_numpy, aff)), 512, **kw)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert dict(cuda_topk.LAUNCH_COUNTS) == before


@pytest.mark.parametrize("tile_rows,db_tile_rows", [(128, 128), (64, 128), (128, 64), (64, 64)],
                         ids=["highest128", "highest64", "split128", "split64"])
@pytest.mark.parametrize("T,m_rows", [(128, 1_056_768), (2048, 1_056_768),
                                      (65536, 1_056_768), (300, 8229), (1, 40),
                                      (64, 1_048_576), (300, 65573), (2048, 8_388_624)])
def test_split_plan_covers_the_db(T, m_rows, tile_rows, db_tile_rows):
    """The kernel's tile shapes: 128 or 64 targets a CTA, DB tiles of 128
    rows at "highest" and 64 at the split precisions."""
    splits, rows = split_plan(T, m_rows, n_sm=132, tile_rows=tile_rows,
                              db_tile_rows=db_tile_rows)
    assert rows % db_tile_rows == 0
    assert (splits - 1) * rows < m_rows <= splits * rows    # none empty
    tiles = -(-T // tile_rows)
    assert splits == 1 or rows >= cuda_topk.MIN_SPLIT_ROWS
    # where the target tiles alone leave SMs idle, the splits fill at least
    # half a wave (as far as splits of MIN_SPLIT_ROWS or more allow) and at
    # most the four waves the plan looks at
    most = max(1, m_rows // cuda_topk.MIN_SPLIT_ROWS)
    if tiles < 132:
        assert min(132 // 2, tiles * most // 2) <= tiles * splits <= 4 * 132 + tiles


@pytest.mark.parametrize("T,m_rows", [(300, 8229), (128, 1_056_768), (65536, 1_048_576),
                                      (1, 40), (64, 129)])
def test_split_plan_of_packed3_is_whole_blocks(T, m_rows):
    """A packed3 split is a whole number of 128-row blocks (the wrapper plans
    it with BLOCK_ROWS as the DB tile), at either target tile."""
    for tile_rows in (128, 64):
        splits, rows = split_plan(T, m_rows, n_sm=132, tile_rows=tile_rows,
                                  db_tile_rows=cuda_topk.BLOCK_ROWS)
        assert rows % 128 == 0 and rows % 64 == 0
        assert (splits - 1) * rows < m_rows <= splits * rows


@pytest.mark.parametrize("precision", ["highest", "split3", "split3cat"])
@pytest.mark.parametrize("partition", [False, True], ids=["nopart", "part"])
@pytest.mark.parametrize("presplit", [False, True], ids=["f32", "presplit"])
def test_launch_shape_clusters_tiles_that_share_rows(precision, partition, presplit):
    """Pass 1 runs as clusters of CLUSTER_CTAS target tiles only at a split
    precision, on f32 rows (not the pre-split operand), without the
    partition mask and with two tiles or more; the grid is then padded with
    dead tiles to a whole number of clusters, by fewer than a cluster."""
    c = cuda_topk.CLUSTER_CTAS
    shares = precision != "highest" and not partition and not presplit
    for n_tiles in (*range(1, 2 * c + 2), 512, 513):
        cluster, grid = cuda_topk.launch_shape(n_tiles, precision, partition, presplit)
        if shares and n_tiles >= 2:
            assert cluster == c
            assert grid % c == 0 and n_tiles <= grid < n_tiles + c
        else:
            assert (cluster, grid) == (1, n_tiles)


def test_launch_shape_at_the_main_path_shapes():
    """The batch step (512 tiles of 128 targets), an odd count (300 targets:
    3 tiles, one dead tile added), a stream chunk (one tile) and a
    multi-voice step (partition)."""
    c = cuda_topk.CLUSTER_CTAS
    assert c == 2
    assert cuda_topk.launch_shape(512, "split3cat", False, False) == (2, 512)
    assert cuda_topk.launch_shape(3, "split3cat", False, False) == (2, 4)
    assert cuda_topk.launch_shape(32, "split3", False, False) == (2, 32)
    assert cuda_topk.launch_shape(1, "split3cat", False, False) == (1, 1)
    assert cuda_topk.launch_shape(128, "split3cat", True, False) == (1, 128)
    assert cuda_topk.launch_shape(512, "split3cat", False, True) == (1, 512)
    assert cuda_topk.launch_shape(512, "highest", False, False) == (1, 512)

"""PyTorch port ops vs the JAX package (and the float64 oracle) on the CPU.

Each test draws its inputs with numpy from its own seed and hands the same
arrays to the JAX function and to its counterpart in ``snickery_tpu_torch``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from snickery_tpu import oracle
from snickery_tpu.ops import ola as jola
from snickery_tpu.ops import topk as jtopk
from snickery_tpu.ops import viterbi as jvit
from snickery_tpu.synth import BACKOFF_LING_WEIGHTS
from snickery_tpu.voicedb import device_layout as jlayout
from snickery_tpu_torch.ops import ola as tola
from snickery_tpu_torch.ops import topk as ttopk
from snickery_tpu_torch.ops import viterbi as tvit
from snickery_tpu_torch.voicedb import device_layout as tlayout


def T(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _affine(rng, d):
    return ((0.1 * rng.standard_normal(d)).astype(np.float32),
            rng.uniform(0.5, 2.0, d).astype(np.float32),
            rng.uniform(0.2, 1.0, d).astype(np.float32))


# ------------------------------------------------------------- device layout
def test_affine_rows_matches_jax():
    """Same elementwise op order: equal to 1 ulp, padding rows pinned to
    pad_value * w."""
    rng = np.random.default_rng(1)
    x = (3 * rng.standard_normal((5, 7, 24))).astype(np.float32)
    mean, std, w = _affine(rng, 24)
    valid = rng.random((5, 7)) < 0.7
    ref = np.asarray(jlayout.affine_rows(jnp.asarray(x), mean, std, w,
                                         jnp.asarray(valid), 1e6))
    got = tlayout.affine_rows(T(x), T(mean), T(std), T(w), T(valid), 1e6).numpy()
    np.testing.assert_array_max_ulp(got, ref, maxulp=1)
    ref0 = np.asarray(jlayout.affine_rows(jnp.asarray(x), mean, std, w))
    got0 = tlayout.affine_rows(T(x), T(mean), T(std), T(w)).numpy()
    np.testing.assert_array_max_ulp(got0, ref0, maxulp=1)


@pytest.mark.parametrize("affine", [False, True])
def test_gather_join_contexts_matches_jax(affine):
    """Join contexts from the raw block (jr through the int32-bit pointer
    column, ``u + 1`` otherwise; zero contexts for padding), equal to 1 ulp,
    for both block widths (kd + 1 and [data | sqn | ptr])."""
    rng = np.random.default_rng(2)
    m, mp, kd, dj = 300, 384, 24, 24
    feats = rng.standard_normal((m, kd)).astype(np.float32)
    jr = np.empty((m, dj), np.float32)
    jr[:-1] = feats[1:, :dj]
    jr[::37] = rng.standard_normal((len(jr[::37]), dj))    # exceptions
    aff = _affine(rng, kd)
    raw, _, _ = jlayout.build_raw_blocks(feats, jr, mp, affine=aff if affine else None)
    idx = rng.integers(0, mp, (11, 9)).astype(np.int32)
    rows = raw[idx]
    mj, sj, wj = _affine(rng, dj)
    valid = idx < m
    ref = jlayout.gather_join_contexts(jnp.asarray(rows), jnp.asarray(raw),
                                       jnp.asarray(idx), dj, mj, sj, wj,
                                       jnp.asarray(valid))
    got = tlayout.gather_join_contexts(T(rows), T(raw), T(idx), dj, T(mj),
                                       T(sj), T(wj), T(valid))
    for r, g in zip(ref, got):
        np.testing.assert_array_max_ulp(g.numpy(), np.asarray(r), maxulp=1)


# --------------------------------------------------------------------- top-k
@pytest.mark.parametrize("k", [30, 45])
def test_order_topk_positions_matches_jax(k):
    """Exact: the same positions as the JAX sweep, including heavy value
    ties, +inf (partition-starved) slots, exhausted rows and k > n."""
    rng = np.random.default_rng(3)
    Tn, n = 64, 40
    vals = rng.standard_normal((Tn, n)).astype(np.float32)
    vals[vals > 1.2] = np.inf
    vals[7] = np.tile(vals[7, :8], 5)
    vals[9] = np.inf
    ids = np.argsort(rng.standard_normal((Tn, n)), axis=-1).astype(np.int32)
    ids[11] = ids[11] // 4                                 # repeated ids
    ref = np.asarray(jtopk.order_topk_positions(jnp.asarray(vals),
                                                jnp.asarray(ids), k))
    got = ttopk.order_topk_positions(T(vals), T(ids), k).numpy()
    np.testing.assert_array_equal(got, ref)


def test_smallest_k_is_exact_lexicographic():
    """The packed-key selection of the plain preselects: (value, column)
    order exactly, negative values, -0.0 == +0.0 and ties included."""
    rng = np.random.default_rng(4)
    vals = rng.integers(-4, 5, (50, 300)).astype(np.float32) * 0.5
    vals[0, :10] = -0.0
    vals[1] = -1e30
    cols = rng.permutation(1000)[:300]
    v, c = ttopk.smallest_k(T(vals), 17, T(cols))
    order = np.lexsort((np.broadcast_to(cols, vals.shape), vals), axis=-1)[:, :17]
    np.testing.assert_array_equal(c.numpy(), cols[order])
    np.testing.assert_array_equal(v.numpy(), np.take_along_axis(vals, order, 1))


@pytest.mark.parametrize("with_affine", [False, True])
def test_topk_preselect_matches_jax(with_affine):
    """Plain chunked preselect vs the JAX XLA preselect: identical ids,
    scores rtol 1e-5 (f32 products summed in another order)."""
    rng = np.random.default_rng(5)
    Tn, M, d, k, chunk = 37, 2048, 24, 10, 512
    targets = rng.standard_normal((Tn, d)).astype(np.float32)
    db = rng.standard_normal((M, d)).astype(np.float32)
    if with_affine:
        mean, std, w = _affine(rng, d)
        n_real = M - 300
        j_aff = (jnp.asarray(mean), jnp.asarray(std), jnp.asarray(w), jnp.int32(n_real))
        t_aff = (T(mean), T(std), T(w), n_real)
    else:
        j_aff = t_aff = None
    ri, rv = jtopk.topk_preselect(jnp.asarray(targets), jnp.asarray(db), k=k,
                                  chunk=chunk, db_affine=j_aff)
    gi, gv = ttopk.topk_preselect(T(targets), T(db), k, chunk=chunk,
                                  db_affine=t_aff)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(ri))
    np.testing.assert_allclose(gv.numpy(), np.asarray(rv), rtol=1e-5, atol=1e-4)
    if with_affine:
        assert (gi.numpy() < n_real).all()
    else:
        ref_idx, _ = oracle.preselect(targets, db, k)
        np.testing.assert_array_equal(gi.numpy(), ref_idx)


@pytest.mark.parametrize("masks", ["ling", "part", "ling_part"])
def test_topk_preselect_fused_masks_match_jax(masks):
    """Plain chunked preselect with the quinphone penalties and/or the voice
    partition vs the JAX XLA preselect: identical ids, scores rtol 1e-5
    (penalised scores sit near 2^24); partition ids never leak."""
    rng = np.random.default_rng(6)
    Tn, M, d, k, chunk = 37, 2048, 24, 10, 512
    targets = rng.standard_normal((Tn, d)).astype(np.float32)
    db = rng.standard_normal((M, d)).astype(np.float32)
    tc, dc = rng.integers(0, 12, Tn).astype(np.int32), rng.integers(0, 12, M).astype(np.int32)
    tx, dx = (rng.integers(0, 6, (n, 5)).astype(np.int32) for n in (Tn, M))
    tp, dp = rng.integers(0, 3, Tn).astype(np.int32), rng.integers(0, 3, M).astype(np.int32)
    weights = BACKOFF_LING_WEIGHTS if masks == "ling_part" else None
    jkw, tkw = {}, {}
    if "ling" in masks:
        jkw["linguistic"] = tuple(map(jnp.asarray, (tc, tx, dc, dx)))
        tkw["linguistic"] = tuple(map(T, (tc, tx, dc, dx)))
        jkw["ling_weights"] = tkw["ling_weights"] = weights
    if "part" in masks:
        jkw["partition"] = (jnp.asarray(tp), jnp.asarray(dp))
        tkw["partition"] = (T(tp), T(dp))
    ri, rv = jtopk.topk_preselect(jnp.asarray(targets), jnp.asarray(db), k=k,
                                  chunk=chunk, **jkw)
    gi, gv = ttopk.topk_preselect(T(targets), T(db), k, chunk=chunk, **tkw)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(ri))
    np.testing.assert_allclose(gv.numpy(), np.asarray(rv), rtol=1e-5, atol=1e-4)
    if "part" in masks:
        assert (dp[gi.numpy()] == tp[:, None]).all()


def test_halfphone_helpers_match_jax():
    """quinphone_penalties, halfphone_exact_rank and halfphone_lattice_mask:
    bit-equal to the JAX functions, with dead (+inf) slots, rows without a
    same-name candidate and both weight sets."""
    rng = np.random.default_rng(8)
    Tn, M, n = 9, 40, 12
    tc, dc = rng.integers(0, 4, Tn).astype(np.int32), rng.integers(0, 4, M).astype(np.int32)
    tx, dx = (rng.integers(0, 3, (r, 5)).astype(np.int32) for r in (Tn, M))
    for w in (None, BACKOFF_LING_WEIGHTS, (0.3, 10.0, 0.0, 10.0, 1.0, 7.0)):
        kw = {} if w is None else dict(context_weights=w[:5], scale=w[5])
        ref = np.asarray(jtopk.quinphone_penalties(*map(jnp.asarray, (tc, tx, dc, dx)), **kw))
        got = ttopk.quinphone_penalties(*map(T, (tc, tx, dc, dx)), **kw).numpy()
        np.testing.assert_array_equal(got, ref)
        sq = (100 * rng.random((Tn, n))).astype(np.float32)
        scores = rng.standard_normal((Tn, n)).astype(np.float32)
        scores[2, 5:] = np.inf
        mism = rng.random((Tn, n)) < 0.4
        mism[3] = True
        ctx_c = rng.integers(0, 3, (Tn, n, 5)).astype(np.int32)
        ref = np.asarray(jtopk.halfphone_exact_rank(
            jnp.asarray(sq), jnp.asarray(scores), jnp.asarray(mism),
            jnp.asarray(ctx_c), jnp.asarray(tx), w))
        got = ttopk.halfphone_exact_rank(T(sq), T(scores), T(mism), T(ctx_c), T(tx), w)
        np.testing.assert_array_equal(got.numpy(), ref)
        ac = np.where(np.isinf(scores), np.inf, np.sqrt(sq))
        ref = np.asarray(jtopk.halfphone_lattice_mask(jnp.asarray(ac), jnp.asarray(mism)))
        got = ttopk.halfphone_lattice_mask(T(ac), T(mism)).numpy()
        np.testing.assert_array_equal(got, ref)
        assert (got[3] == ac[3]).all(), "no same-name candidate: costs stay acoustic"


@pytest.mark.parametrize("zero_transient", [False, True])
@pytest.mark.parametrize("precision", ["highest", "split3", "split3cat"])
def test_preselect_margin_policy_matches_jax(precision, zero_transient):
    for use_kernel in (False, True):
        for override in (-1, 0, 7):
            assert ttopk.preselect_margin(
                use_kernel, precision, zero_transient=zero_transient,
                override=override) == jtopk.preselect_margin(
                use_kernel, precision, zero_transient=zero_transient,
                override=override)


# ------------------------------------------------------------------- Viterbi
def _lattice(seed, Tn, N, dj, scale=5.0):
    rng = np.random.default_rng(seed)
    return (rng.random((Tn, N)).astype(np.float32) * scale,
            rng.standard_normal((Tn, N, dj)).astype(np.float32),
            rng.standard_normal((Tn, N, dj)).astype(np.float32))


@pytest.mark.parametrize("squared", [False, True])
def test_viterbi_matches_jax_and_oracle(squared):
    """Batched port vs the JAX scan per utterance (and the f64 oracle for
    Euclidean joins): identical paths, costs rtol 1e-5."""
    lat = [_lattice(10 + b, 50, 16, 8) for b in range(3)]
    tc, jl, jr = (np.stack(x) for x in zip(*lat))
    paths, costs = tvit.viterbi_decode(T(tc), T(jl), T(jr), join_cost_weight=0.7,
                                       squared_joins=squared)
    for b in range(3):
        p, c = jvit.viterbi_decode(jnp.asarray(tc[b]), jnp.asarray(jl[b]),
                                   jnp.asarray(jr[b]), join_cost_weight=0.7,
                                   squared_joins=squared)
        np.testing.assert_array_equal(paths[b].numpy(), np.asarray(p))
        np.testing.assert_allclose(float(costs[b]), float(c), rtol=1e-5)
        if not squared:
            rp, rc = oracle.viterbi(tc[b], jl[b], jr[b], join_cost_weight=0.7)
            np.testing.assert_array_equal(paths[b].numpy(), rp)
            np.testing.assert_allclose(float(costs[b]), rc, rtol=1e-5)


def test_viterbi_epsilon_pruning_matches_jax():
    """Pruning that bites (epsilon 0.3) selects what the JAX scan selects;
    a huge epsilon changes nothing."""
    tc, jl, jr = _lattice(20, 30, 12, 6, scale=1.0)
    for eps in (0.3, 1e9):
        p, c = tvit.viterbi_decode(T(tc)[None], T(jl)[None], T(jr)[None],
                                   search_epsilon=eps)
        rp, rc = jvit.viterbi_decode(jnp.asarray(tc), jnp.asarray(jl),
                                     jnp.asarray(jr), search_epsilon=eps)
        np.testing.assert_array_equal(p[0].numpy(), np.asarray(rp))
        np.testing.assert_allclose(float(c[0]), float(rc), rtol=1e-5)
    p0, c0 = tvit.viterbi_decode(T(tc)[None], T(jl)[None], T(jr)[None])
    np.testing.assert_array_equal(p0.numpy(), p.numpy())
    assert abs(float(c0[0]) - float(c[0])) < 1e-5


def test_viterbi_padding_invariance_batched():
    """Junk in padded steps changes nothing, per utterance of a batch of
    different lengths, and matches the JAX scan with ``length`` (dead steps
    return state 0)."""
    Tn, N, dj, pad = 20, 8, 4, 12
    tc, jl, jr = _lattice(30, Tn, N, dj, scale=1.0)
    tc_p = np.pad(tc, ((0, pad), (0, 0)), constant_values=123.0)
    jl_p = np.pad(jl, ((0, pad), (0, 0), (0, 0)), constant_values=9.0)
    jr_p = np.pad(jr, ((0, pad), (0, 0), (0, 0)), constant_values=-7.0)
    p0, c0 = tvit.viterbi_decode(T(tc)[None], T(jl)[None], T(jr)[None])
    lengths = torch.tensor([Tn, Tn - 5])
    p1, c1 = tvit.viterbi_decode(T(np.stack([tc_p, tc_p])), T(np.stack([jl_p, jl_p])),
                                 T(np.stack([jr_p, jr_p])), length=lengths)
    np.testing.assert_array_equal(p1[0, :Tn].numpy(), p0[0].numpy())
    assert abs(float(c0[0]) - float(c1[0])) < 1e-4
    for b, n in enumerate(lengths.tolist()):
        rp, rc = jvit.viterbi_decode(jnp.asarray(tc_p), jnp.asarray(jl_p),
                                     jnp.asarray(jr_p), length=n)
        np.testing.assert_array_equal(p1[b].numpy(), np.asarray(rp))
        np.testing.assert_allclose(float(c1[b]), float(rc), rtol=1e-5)


@pytest.mark.parametrize("squared", [False, True])
def test_greedy_matches_jax_and_oracle(squared):
    lat = [_lattice(40 + b, 40, 10, 5, scale=3.0) for b in range(2)]
    tc, jl, jr = (np.stack(x) for x in zip(*lat))
    lengths = torch.tensor([40, 33])
    paths, costs = tvit.greedy_decode(T(tc), T(jl), T(jr), join_cost_weight=0.5,
                                      length=lengths, squared_joins=squared)
    for b, n in enumerate(lengths.tolist()):
        p, c = jvit.greedy_decode(jnp.asarray(tc[b]), jnp.asarray(jl[b]),
                                  jnp.asarray(jr[b]), join_cost_weight=0.5,
                                  length=n, squared_joins=squared)
        np.testing.assert_array_equal(paths[b].numpy(), np.asarray(p))
        np.testing.assert_allclose(float(costs[b]), float(c), rtol=1e-5)
    if not squared:
        rp, rc = oracle.greedy(tc[0], jl[0], jr[0], join_cost_weight=0.5)
        np.testing.assert_array_equal(paths[0].numpy(), rp)
        np.testing.assert_allclose(float(costs[0]), rc, rtol=1e-5)


# ----------------------------------------------------------------------- OLA
def _ola_case(seed):
    rng = np.random.default_rng(seed)
    corpus = rng.standard_normal(5000).astype(np.float32)
    starts = np.asarray([[10, 900, 3777, 4801, 450],        # corpus edges
                         [500, 900, 1300, 1700, 0]])         # natural run + pad
    ends = starts + np.asarray([[300, 411, 129, 190, 333],
                                [400, 400, 400, 400, 0]])
    return corpus, starts, ends, np.asarray([5, 4])


@pytest.mark.parametrize("waves_int16", [False, True])
def test_ola_matches_jax_and_host(waves_int16):
    """Batched OLA vs the JAX row-granular OLA and the numpy host OLA, per
    utterance: corpus-boundary clipping, padded units, int16 corpora with
    wave_scale; atol 1e-6 x peak."""
    corpus, starts, ends, n_units = _ola_case(50)
    taper, max_frag, out_len = 24, 512, 4096
    scale = np.float32(1.0)
    waves = corpus
    if waves_int16:
        scale = np.float32(np.abs(corpus).max() / 32767.0)
        waves = np.round(corpus / scale).astype(np.int16)
    audio, totals = tola.overlap_add_units(
        T(waves), T(starts), T(ends), T(n_units), max_frag=max_frag,
        out_len=out_len, taper=taper, wave_scale=T(np.asarray(scale)))
    peak = float(np.abs(corpus).max())
    for b in range(2):
        ref, rt = jola.overlap_add_units(
            jnp.asarray(waves), jnp.asarray(starts[b]), jnp.asarray(ends[b]),
            n_units=jnp.int32(n_units[b]), max_frag=max_frag, out_len=out_len,
            taper=taper, wave_scale=jnp.float32(scale))
        assert int(totals[b]) == int(rt)
        np.testing.assert_allclose(audio[b].numpy(), np.asarray(ref), atol=1e-6 * peak)
        n = n_units[b]
        host = tola.host_overlap_add(waves.astype(np.float32) * scale,
                                     starts[b, :n], ends[b, :n], taper)
        assert len(host) == int(totals[b])
        np.testing.assert_allclose(audio[b, :len(host)].numpy(), host, atol=1e-6 * peak)
        np.testing.assert_allclose(host, jola.host_overlap_add(
            waves.astype(np.float32) * scale, starts[b, :n], ends[b, :n], taper),
            atol=0)


def test_ola_reconstructs_natural_run():
    n = 6000
    corpus = np.sin(np.arange(n) / 40.0).astype(np.float32)
    taper = 32
    starts = (500 + 400 * np.arange(10))[None]
    audio, total = tola.overlap_add_units(
        T(corpus), T(starts), T(starts + 400), torch.tensor([10]), max_frag=512,
        out_len=8192, taper=taper)
    total = int(total[0])
    assert total == 4000 + 2 * taper
    ref = oracle.overlap_add(corpus, starts[0], starts[0] + 400, taper)
    np.testing.assert_allclose(audio[0, :total].numpy(), ref, atol=1e-5)
    np.testing.assert_allclose(audio[0, 2 * taper: total - 2 * taper].numpy(),
                               corpus[500 + taper: 500 + 4000 - taper], atol=1e-5)

"""The bf16-split preselect precisions ("split3", "split3cat") and the
host-OLA mode in ``snickery_tpu_torch`` on the CPU, against the JAX package.

- The kernel's plain twin at each split precision vs the zero-transient
  Pallas kernel in interpret mode (ports of tests/test_pallas_topk.py:174,
  :200, :234 and :279 in their zero-transient form): scores of shared ids
  within 1e-3 plus one f32 ulp, and differing ids only at near-ties of the
  k-th score.
- Both twins held to a float64 evaluation of ``hh + hl + lh``.
- Config 3 at ``preselect_precision="split3cat"`` through the port's
  ``Synthesiser`` vs the JAX one through the Pallas kernel (interpret mode),
  and vs the float64 oracle (port of tests/test_e2e.py:286).
- ``preload_all_waves=False``: audio concatenated on the host, equal to the
  JAX package's and to the port's device OLA.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from snickery_tpu import oracle
from snickery_tpu.ops.pallas_topk import pallas_topk_preselect
from snickery_tpu.synth import Synthesiser as JaxSynthesiser
from snickery_tpu.voicedb.device_layout import build_raw_blocks
from snickery_tpu_torch.kernel_check import (PROBE_RTOL, split_probe_error,
                                             split_probe_operands)
from snickery_tpu_torch.ops import cuda_topk
from snickery_tpu_torch.ops.cuda_topk import (cross_products, cuda_topk_preselect,
                                              split_bf16, split_scores64,
                                              topk_preselect_zt_plain)
from snickery_tpu_torch.synth import Synthesiser
from tests.toyvoice import build_toy_voice, prepare_toy_utts, toy_config

F32_EPS = float(np.finfo(np.float32).eps)
SCORE_ATOL = 1e-3          # f32 sums of 3 kd products taken in another order,
                           # on scores of magnitude ~1e2
SPLITS = {"split3cat": 48, "split3": 40}   # precision: k (n_cand 30 + margin)


def _block(seed, m, M, kd, dup):
    """Raw [data | sqn | ptr] block with jr exceptions, padding rows and,
    with ``dup``, 41 bit-identical rows (50 and 100..139)."""
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


def _split_scores64(targets, raw, aff, ids):
    """Float64 ranking scores (comp included) of the rows ``ids`` (T, k):
    ``sqn - 2 * (hh + hl + lh)`` on the bf16 splits of the f32-prescaled
    targets and the rows, the value both sides round."""
    t, a = torch.from_numpy(targets), tuple(map(torch.from_numpy, aff))
    rows = torch.from_numpy(raw)[torch.from_numpy(np.array(ids)).long()]
    comp = 2.0 * ((t * (a[2] / a[1])[None, :]).double() @ a[0].double())
    return (split_scores64(t, rows, a) + comp[:, None]).numpy()


def _assert_near(targets, raw, aff, gi, gv, ri, rv):
    """Per row: shared ids' scores within SCORE_ATOL + one ulp; an id kept by
    one side only must score, in float64 on the bf16 products, within the
    same tolerance of the other side's k-th score (a near-tie)."""
    s_g = _split_scores64(targets, raw, aff, gi)
    s_r = _split_scores64(targets, raw, aff, ri)
    for t in range(len(gi)):
        shared, a, b = np.intersect1d(gi[t], ri[t], return_indices=True)
        tol = SCORE_ATOL + F32_EPS * np.abs(rv[t, b])
        assert (np.abs(gv[t, a] - rv[t, b]) <= tol).all(), t
        kth_g, kth_r = s_g[t].max(), s_r[t].max()
        tie = SCORE_ATOL + F32_EPS * abs(kth_r)
        only_g = ~np.isin(gi[t], ri[t])
        only_r = ~np.isin(ri[t], gi[t])
        assert only_g.sum() == only_r.sum()
        assert (s_g[t, only_g] >= kth_r - tie).all(), t
        assert (s_r[t, only_r] >= kth_g - tie).all(), t


@pytest.mark.parametrize("precision", sorted(SPLITS))
@pytest.mark.parametrize("m,dup", [(8192 - 700, False), (8192, True)])
def test_split_twin_matches_pallas_interpret(precision, m, dup):
    """T=256, M=8192 (two Pallas chunks), kd=151: the port's twin and the
    zero-transient Pallas kernel at the same split precision keep the same
    ids up to near-ties, with scores within 1e-3 + 1 ulp.  Padding rows are
    never selected."""
    Tn, M, kd, k = 256, 8192, 151, SPLITS[precision]
    rng, raw, aff = _block(11 + m, m, M, kd, dup)
    targets = rng.standard_normal((Tn, kd)).astype(np.float32)
    ri, rv = pallas_topk_preselect(
        jnp.asarray(targets), jnp.asarray(raw), k=k, interpret=True,
        mm_precision=precision, sort=True, zero_transient=True, m_rows=M,
        db_affine=(*map(jnp.asarray, aff), jnp.int32(m)))
    gi, gv = cuda_topk_preselect(torch.from_numpy(targets), torch.from_numpy(raw), k,
                                 tuple(map(torch.from_numpy, aff)), M, precision=precision)
    gi, gv = gi.numpy(), gv.numpy()
    assert gi.dtype == np.int32 and gv.dtype == np.float32
    assert (gi < m).all(), "padding rows must never be selected"
    assert (np.diff(gv, axis=1) >= 0).all()
    _assert_near(targets, raw, aff, gi, gv, np.asarray(ri), np.asarray(rv))


def test_split3_and_split3cat_twins_agree():
    """The two split precisions form the same three products (port of
    tests/test_pallas_topk.py:174): id sets equal up to near-ties, scores of
    shared ids within 1e-3 + 1 ulp."""
    Tn, M, kd, k = 256, 8192, 151, 40
    rng, raw, aff = _block(31, M, M, kd, False)
    targets = rng.standard_normal((Tn, kd)).astype(np.float32)
    P = torch.from_numpy
    args = (P(targets), P(raw), k, tuple(map(P, aff)), M)
    i3, v3 = topk_preselect_zt_plain(*args, precision="split3")
    ic, vc = topk_preselect_zt_plain(*args, precision="split3cat")
    _assert_near(targets, raw, aff, i3.numpy(), v3.numpy(), ic.numpy(), vc.numpy())


@pytest.mark.parametrize("precision", sorted(SPLITS))
def test_split_twin_vs_oracle(precision):
    """Against the float64 oracle on the same raw rows (port of
    tests/test_pallas_topk.py:200): the top-k sets overlap > 0.99 and the
    compensated scores are squared distances to bf16-split accuracy."""
    Tn, M, kd, k = 128, 4096, 60, 16
    rng, raw, aff = _block(32, M, M, kd, False)
    targets = rng.standard_normal((Tn, kd)).astype(np.float32)
    mean, std, w = aff
    db = ((raw[:M, :kd] - mean) / std) * w
    gi, gv = topk_preselect_zt_plain(torch.from_numpy(targets), torch.from_numpy(raw), k,
                                     tuple(map(torch.from_numpy, aff)), M,
                                     precision=precision)
    ref_idx, ref_sq = oracle.preselect(targets, db, k)
    overlap = np.mean([len(np.intersect1d(a, b)) / k for a, b in zip(gi.numpy(), ref_idx)])
    assert overlap > 0.99, overlap
    sq = gv.numpy().astype(np.float64) + (targets.astype(np.float64) ** 2).sum(-1, keepdims=True)
    np.testing.assert_allclose(np.sort(sq, 1), np.sort(ref_sq, 1), rtol=5e-3, atol=5e-3)


def test_split_twins_hold_to_float64_products():
    """Both twins' dot products equal a float64 evaluation of hh + hl + lh to
    1e-6 relative, on operands built so that the lo * lo products the split
    drops add up to 2.7e-6 - 2.5e-5 relative: a twin that multiplied in full
    f32 would fail (checked below)."""
    t2, rows = split_probe_operands()
    kd = rows.shape[1]
    block = torch.nn.functional.pad(rows, (0, 2)).expand(len(t2), -1, -1)   # sqn 0
    identity = (torch.zeros(kd), torch.ones(kd), torch.ones(kd))
    ref = -0.5 * split_scores64(t2, block, identity)             # (T, n) float64
    scale = (t2.double().abs() @ rows.double().abs().T)
    for precision in sorted(SPLITS):
        got = cross_products(t2, rows, precision).double()
        assert ((got - ref).abs() <= 1e-6 * scale).all(), precision
    full = (t2 @ rows.T).double()
    assert ((full - ref).abs() > 1e-6 * scale).any(), "the operands must tell f32 apart"


@pytest.mark.parametrize("precision", ["split3cat", "split3", "highest"])
def test_preselect_on_split_probe(precision):
    """The card's probe through the preselect wrapper on the CPU (the
    twin): at a split precision the scores of the k best rows equal the
    float64 hh + hl + lh to 1e-6 relative; at "highest" they miss it."""
    err = split_probe_error("cpu", precision)
    if precision == "highest":
        assert err > PROBE_RTOL
    else:
        assert err <= PROBE_RTOL


def test_split_bf16_rounds_like_jax():
    """hi and lo are JAX's astype(bfloat16) of x and of x - hi, bit for bit,
    on values that round up, down and to even."""
    rng = np.random.default_rng(6)
    x = np.concatenate([rng.standard_normal(4096).astype(np.float32),
                        np.float32([1 + 2 ** -8, 1 + 3 * 2 ** -8, -(1 + 2 ** -8), 0.0])])
    jh = jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32)
    jl = (jnp.asarray(x) - jh).astype(jnp.bfloat16).astype(jnp.float32)
    hi, lo = split_bf16(torch.from_numpy(x))
    np.testing.assert_array_equal(hi.numpy(), np.asarray(jh))
    np.testing.assert_array_equal(lo.numpy(), np.asarray(jl))


def test_split_precision_with_masks_raises():
    """A split precision composes with the fused masks: the wrapper runs
    (on the CPU, the twin) and each variant has its own entry point, twelve
    in all; what still raises is an unknown precision (ValueError) and a
    fused mask without its metadata rows."""
    rng, raw, aff = _block(4, 1000, 1024, 24, False)
    tg = torch.from_numpy(rng.standard_normal((10, 24)).astype(np.float32))
    meta = torch.zeros((1024, cuda_topk.META_WIDTH), dtype=torch.int32)
    args = (tg, torch.from_numpy(raw), 8, tuple(map(torch.from_numpy, aff)), 1024)
    for partition, weights in ((True, None), (False, (1.0, 10.0, 0.0, 10.0, 1.0, 100.0))):
        ids, scores = cuda_topk_preselect(*args, tgt_meta=meta[:10], db_meta=meta,
                                          partition=partition, ling_weights=weights,
                                          precision="split3cat")
        assert ids.shape == scores.shape == (10, 8) and bool(torch.isfinite(scores).all())
        with pytest.raises(ValueError, match="tgt_meta and db_meta"):
            cuda_topk_preselect(*args, partition=partition, ling_weights=weights,
                                precision="split3")
    with pytest.raises(ValueError, match="precision"):
        cuda_topk.kernel_name(False, False, "bf16")
    assert {cuda_topk.kernel_name(False, False, p) for p in SPLITS} == set(
        cuda_topk.SPLIT_KERNELS.values())
    names = {cuda_topk.kernel_name(p, q, prec) for prec in cuda_topk.PRECISIONS
             for p in (False, True) for q in (False, True)}
    assert names == set(cuda_topk.ALL_KERNELS) and len(names) == 12


# ----------------------------------------------------- the Synthesiser paths
@pytest.fixture(scope="module")
def voice():
    cfg, db, utts = build_toy_voice(halfphone=False, multiepoch=1)
    held = prepare_toy_utts(1, seed0=901)[0]
    return cfg, db, utts, held


@pytest.fixture(scope="module")
def split3cat(voice):
    cfg, db, _, _ = voice
    c = toy_config(preselect_precision="split3cat")
    return (Synthesiser(c, db, device="cpu"),
            JaxSynthesiser(toy_config(preselect_precision="split3cat",
                                      use_pallas="interpret"), db=db))


def test_split3cat_synth_matches_jax_pallas_interpret(voice, split3cat):
    """Config 3 at split3cat: ``synth_from_features`` and ``synth_batch``
    give the JAX Synthesiser's unit ids (its Pallas kernel in interpret
    mode) and audio within 1e-5."""
    cfg, db, utts, held = voice
    ts, js = split3cat
    feats = [utts[0].features, held.features]
    for f in feats:
        a, b = js.synth_from_features(f), ts.synth_from_features(f)
        np.testing.assert_array_equal(b["unit_ids"], a["unit_ids"])
        np.testing.assert_allclose(b["wave"], a["wave"], atol=1e-5)
    for a, b in zip(js.synth_batch(feats), ts.synth_batch(feats)):
        np.testing.assert_array_equal(b["unit_ids"], a["unit_ids"])
        assert len(b["wave"]) == len(a["wave"])


def test_split3cat_agreement_vs_oracle(voice, split3cat):
    """Port of tests/test_e2e.py:286: a held-out target (seed 901) through
    the split3cat ranking, exact rescore and margin 18 agrees >= 0.99 with
    the float64 oracle."""
    cfg, db, _, held = voice
    ts = split3cat[0]
    ids = ts.synth_from_features(held.features)["unit_ids"]
    tgt, _ = ts.targets_from_features(held.features)
    tw = (((tgt - db.mean_target) / db.std_target) * ts._sqrt_wt).astype(np.float32)
    feats = db.normalised_features().astype(np.float32) * ts._sqrt_wt[None, :]
    jl, jr = db.normalised_joins()
    ids_ref, _ = oracle.synth_pipeline(
        tw, feats, (jl * ts._sqrt_wj).astype(np.float32),
        (jr * ts._sqrt_wj).astype(np.float32),
        n_candidates=min(cfg.n_candidates, ts.n_units_padded),
        join_cost_weight=cfg.join_cost_weight)
    assert (ids == ids_ref).mean() >= 0.99


@pytest.mark.parametrize("waves_dtype", ["float32", "int16"])
def test_host_ola_matches_jax_and_device_ola(voice, waves_dtype):
    """``preload_all_waves=False``: the device holds a 128-sample
    placeholder, the step returns exact totals and the audio is concatenated
    on the host from the float32 corpus (int16 quantisation applies only to
    device-resident waves).  Equal to the JAX package's host OLA and to the
    port's own device OLA of float32 waves, to 1e-6."""
    cfg, db, utts, held = voice
    host_cfg = toy_config(preload_all_waves=False, waves_dtype=waves_dtype)
    ts = Synthesiser(host_cfg, db, device="cpu")
    assert ts.device_db.waves.shape == (128,) and not ts.device_db.waves.any()
    js = JaxSynthesiser(host_cfg, db=db)
    dev = Synthesiser(cfg, db, device="cpu")
    feats = [utts[2].features, held.features]
    for f in feats:
        a, b, c = (s.synth_from_features(f) for s in (js, ts, dev))
        np.testing.assert_array_equal(b["unit_ids"], c["unit_ids"])
        np.testing.assert_allclose(b["wave"], a["wave"], atol=1e-6)
        np.testing.assert_allclose(b["wave"], c["wave"], atol=1e-6)
    for a, b in zip(js.synth_batch(feats), ts.synth_batch(feats)):
        np.testing.assert_array_equal(b["unit_ids"], a["unit_ids"])
        np.testing.assert_allclose(b["wave"], a["wave"], atol=1e-6)


def test_unknown_precision_is_refused(voice):
    cfg, db, *_ = voice
    with pytest.raises(ValueError, match="preselect_precision"):
        Synthesiser(dataclasses.replace(cfg, preselect_precision="bf16"), db, device="cpu")

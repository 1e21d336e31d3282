"""A split precision ("split3cat", "split3") together with the fused masks
(the voice partition of a merged DB, the quinphone penalties of a halfphone
voice, both) in ``snickery_tpu_torch`` on the CPU, against the JAX package:

- the preselect kernel's plain twin vs the zero-transient Pallas kernel in
  interpret mode: dead slots (+inf, 0) in the same places, scores of shared
  ids within 1e-3 plus one f32 ulp (penalised scores sit near 2^23-2^24,
  ulp 1-2), and an id kept by one side only a near-tie of the other side's
  k-th score, judged in float64 on the three bf16 products plus penalties;
- the ``Synthesiser`` at each split precision on a halfphone voice, a merged
  epoch voice and two merged halfphone voices vs the JAX ``Synthesiser``
  through the Pallas kernel (interpret mode): the same unit ids as the
  port's own "highest" run, and the JAX package's ids, audio within 1e-5 and
  costs as tests/test_torch_halfphone.py holds them, except where the JAX
  Viterbi, whose join distances carry f32 cancellation noise, takes a path
  that is dearer in float64: there the port's path must be the cheaper one,
  by less than that noise (it is so at "highest" too).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from snickery_tpu.const import QUINPHONE_CONTEXT_WEIGHTS, QUINPHONE_SCALE
from snickery_tpu.ops.pallas_topk import pallas_topk_preselect
from snickery_tpu.synth import BACKOFF_LING_WEIGHTS
from snickery_tpu.synth import Synthesiser as JaxSynthesiser
from snickery_tpu.voicedb.multivoice import merge_voicedbs
from snickery_tpu_torch.kernel_check import scores64
from snickery_tpu_torch.ops.cuda_topk import cuda_topk_preselect, pack_meta
from snickery_tpu_torch.synth import Synthesiser
from snickery_tpu_torch.voicedb.device_layout import build_raw_blocks
from tests.toyvoice import build_toy_voice, prepare_toy_utts

F32_EPS = float(np.finfo(np.float32).eps)
SCORE_ATOL = 1e-3
VARIANTS = {"part": (True, None),
            "ling": (False, (*QUINPHONE_CONTEXT_WEIGHTS, QUINPHONE_SCALE)),
            "ling_part": (True, BACKOFF_LING_WEIGHTS)}
SPLITS = {"split3cat": 12, "split3": 10}     # precision: k


def _block_and_labels(seed, Tn, M, m, kd):
    """Raw [data | sqn | ptr] block with jr exceptions, duplicated rows and
    padding rows [m, M) labelled -1; labels from 20 halfphone codes, 9
    phones and 3 voices, with 8 targets whose code no row carries, 6 of a
    voice with 5 rows (starved slots) and 2 of a voice with none."""
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((m, kd)).astype(np.float32)
    feats[100:140] = feats[50]
    jr = np.empty((m, kd), np.float32)
    jr[:-1] = feats[1:]
    jr[-1] = rng.standard_normal(kd)
    aff = ((0.1 * rng.standard_normal(kd)).astype(np.float32),
           rng.uniform(0.5, 2.0, kd).astype(np.float32),
           rng.uniform(0.2, 1.0, kd).astype(np.float32))
    raw, _, _ = build_raw_blocks(feats, jr, M, affine=aff)
    targets = rng.standard_normal((Tn, kd)).astype(np.float32)
    tc = rng.integers(0, 20, Tn).astype(np.int32)
    tc[:8] = 99
    tx = rng.integers(0, 9, (Tn, 5)).astype(np.int32)
    tv = rng.integers(0, 3, Tn).astype(np.int32)
    tv[10:16], tv[16:18] = 3, 4
    dc = rng.integers(0, 20, M).astype(np.int32)
    dx = rng.integers(0, 9, (M, 5)).astype(np.int32)
    dv = rng.integers(0, 3, M).astype(np.int32)
    dv[rng.choice(m, 5, replace=False)] = 3
    dc[m:], dx[m:], dv[m:] = -1, -1, -1
    return raw, aff, targets, (tc, tx, tv, dc, dx, dv)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("precision", sorted(SPLITS))
def test_split_masked_twin_matches_pallas_interpret(precision, variant):
    """T=256, M=8192 (two Pallas chunks), kd=24: the twin at a split
    precision with the variant's masks vs the Pallas kernel's."""
    partition, weights = VARIANTS[variant]
    Tn, M, kd, k, m = 256, 8192, 24, SPLITS[precision], 8192 - 300
    raw, aff, targets, (tc, tx, tv, dc, dx, dv) = _block_and_labels(
        10 * sorted(SPLITS).index(precision) + sorted(VARIANTS).index(variant), Tn, M, m, kd)
    J, P = jnp.asarray, torch.from_numpy
    ri, rv = pallas_topk_preselect(
        J(targets), J(raw), k=k, interpret=True, mm_precision=precision,
        sort=True, zero_transient=True, m_rows=M,
        db_affine=(*map(J, aff), jnp.int32(m)),
        partition=(J(tv), J(dv)) if partition else None,
        linguistic=(J(tc), J(tx), J(dc), J(dx)) if weights else None,
        ling_weights=weights)
    masks = dict(tgt_meta=pack_meta(P(tc), P(tx), P(tv)),
                 db_meta=pack_meta(P(dc), P(dx), P(dv)),
                 partition=partition, ling_weights=weights)
    gi, gv = cuda_topk_preselect(P(targets), P(raw), k, tuple(map(P, aff)), M,
                                 precision=precision, **masks)
    ri, rv = torch.from_numpy(np.array(ri)).long(), torch.from_numpy(np.array(rv))
    gi = gi.long()
    assert bool((gv[:, 1:] >= gv[:, :-1]).all())
    dead_g, dead_r = torch.isinf(gv), torch.isinf(rv)
    assert torch.equal(dead_g.sum(1), dead_r.sum(1))
    assert not gi[dead_g].any() and not ri[dead_r].any()
    live = ~dead_g
    assert bool((gi[live] < m).all()), "padding rows must never be selected"
    if partition:
        assert bool((P(dv)[gi][live] == P(tv)[:, None].expand_as(gi)[live]).all())
        assert bool(dead_g[10:18, 5:].all() and dead_g[16:18].all())
    s_g = scores64(P(raw), tuple(map(P, aff)), P(targets), gi, masks, precision)
    s_r = scores64(P(raw), tuple(map(P, aff)), P(targets), ri, masks, precision)
    for t in range(Tn):
        g, r = gi[t][live[t]].numpy(), ri[t][~dead_r[t]].numpy()
        shared, a, b = np.intersect1d(g, r, return_indices=True)
        tol = SCORE_ATOL + 2 * F32_EPS * np.abs(rv[t, b].numpy())
        assert (np.abs(gv[t, a].numpy() - rv[t, b].numpy()) <= tol).all(), t
        if len(shared) == len(g):
            continue
        kth_g = s_g[t][live[t]].max().item()
        kth_r = s_r[t][~dead_r[t]].max().item()
        tie = SCORE_ATOL + 2 * F32_EPS * max(abs(kth_g), abs(kth_r))
        only_g, only_r = ~np.isin(g, r), ~np.isin(r, g)
        assert (s_g[t][live[t]].numpy()[only_g] >= kth_r - tie).all(), t
        assert (s_r[t][~dead_r[t]].numpy()[only_r] >= kth_g - tie).all(), t


# ----------------------------------------------------- the Synthesiser paths
def _voice(kind):
    if kind == "merged_epoch":
        cfg, db_a, _ = build_toy_voice(halfphone=False, n_utts=2)
        _, db_b, _ = build_toy_voice(halfphone=False, n_utts=3)
        return cfg, merge_voicedbs([db_a, db_b], names=["alice", "bob"])
    cfg, db, _ = build_toy_voice(halfphone=True, n_utts=3 if kind == "halfphone" else 2)
    if kind == "halfphone":
        return cfg, db
    _, db_b, _ = build_toy_voice(halfphone=True, n_utts=3)
    return dataclasses.replace(cfg, n_candidates=6), merge_voicedbs([db, db_b],
                                                                  names=["alice", "bob"])


def _path_cost64(cfg, db, synth, tgt, ids):
    f64 = np.float64
    tw = ((tgt - db.mean_target) / db.std_target) * synth._sqrt_wt
    fw = (((db.unit_features[ids] - db.mean_target) / db.std_target) * synth._sqrt_wt).astype(f64)
    jl = (((db.join_left[ids] - db.mean_join) / db.std_join) * synth._sqrt_wj).astype(f64)
    jr = (((db.join_right[ids] - db.mean_join) / db.std_join) * synth._sqrt_wj).astype(f64)
    jcw = cfg.join_cost_weight
    c64 = (np.sqrt(((fw - tw) ** 2).sum(-1)).sum()
           + jcw * np.sqrt(((jl[1:] - jr[:-1]) ** 2).sum(-1)).sum())
    noise = jcw * np.sqrt(16 * F32_EPS * ((jl[1:] ** 2).sum(-1) + (jr[:-1] ** 2).sum(-1))).sum()
    return c64, noise


@pytest.mark.parametrize("precision", sorted(SPLITS))
@pytest.mark.parametrize("kind", ["halfphone", "merged_epoch", "merged_halfphone"])
def test_split_masked_synth_matches_jax_pallas_interpret(kind, precision):
    cfg, db = _voice(kind)
    cfg = dataclasses.replace(cfg, preselect_precision=precision)
    ts = Synthesiser(cfg, db, device="cpu")
    js = JaxSynthesiser(dataclasses.replace(cfg, use_pallas="interpret"), db=db)
    halfphone = kind != "merged_epoch"
    held = prepare_toy_utts(2, halfphone=halfphone, seed0=930)
    voices = ["bob", "alice"] if kind != "halfphone" else None
    if halfphone:
        tk = [ts.halfphone_targets_from_features(u.features, u.epochs, u.halfphones)
              for u in held]
        feats, segs = [t for t, _ in tk], [s for _, s in tk]
    else:
        feats, segs = [u.features for u in held], None
    ref = js.synth_batch(feats, voices=voices, segments_list=segs)
    got = ts.synth_batch(feats, voices=voices, segments_list=segs)
    exact = Synthesiser(dataclasses.replace(cfg, preselect_precision="highest"), db,
                        device="cpu").synth_batch(feats, voices=voices, segments_list=segs)
    for i, (a, b, h) in enumerate(zip(ref, got, exact)):
        np.testing.assert_array_equal(b["unit_ids"], h["unit_ids"])
        tgt = feats[i] if halfphone else ts.targets_from_features(feats[i])[0]
        c64, noise = _path_cost64(cfg, db, ts, tgt, b["unit_ids"])
        np.testing.assert_allclose(b["total_cost"], c64, rtol=1e-5, atol=1e-4)
        if voices:
            assert (db.voice_ids[b["unit_ids"]] == ts._voice_code(voices[i])).all()
        assert len(b["unit_ids"]) == len(a["unit_ids"])
        if np.array_equal(b["unit_ids"], a["unit_ids"]):
            assert len(b["wave"]) == len(a["wave"])
            np.testing.assert_allclose(b["wave"], a["wave"], atol=1e-5)
            assert abs(a["total_cost"] - b["total_cost"]) <= 1e-5 * abs(b["total_cost"]) + noise
        else:
            c_jax, noise_jax = _path_cost64(cfg, db, ts, tgt, a["unit_ids"])
            assert c64 <= c_jax * (1 + 1e-12) and c_jax - c64 <= noise_jax, (c64, c_jax)
            assert (b["unit_ids"] == a["unit_ids"]).mean() >= 0.9
    single = ts.synth_from_features(feats[0], target_segments=segs[0] if segs else None,
                                    voice=voices[0] if voices else None)
    np.testing.assert_array_equal(single["unit_ids"], got[0]["unit_ids"])

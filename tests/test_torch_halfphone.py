"""Halfphone voices, merged multi-voice DBs and their composition through
``snickery_tpu_torch.Synthesiser`` on the CPU (the preselect kernel's plain
twin with the fused quinphone penalties and voice partition), against the JAX
``Synthesiser`` through its XLA path and through the Pallas kernel in
interpret mode, and against the float64 oracle.

Costs are held as tests/test_torch_synth.py holds them: the port's total to
the float64 path cost of its own ids (rtol 1e-5), the JAX total to the
port's within the f32 cancellation bound of the JAX join distances.
"""

import dataclasses

import numpy as np
import pytest
import torch

from snickery_tpu import oracle
from snickery_tpu.const import ID_RANK_PENALTY
from snickery_tpu.synth import Synthesiser as JaxSynthesiser
from snickery_tpu.voicedb.multivoice import merge_voicedbs
from snickery_tpu_torch.synth import (DeviceDB, Synthesiser,
                                      device_db_from_numpy,
                                      synth_pipeline_step)
from snickery_tpu_torch.voicedb.device_layout import build_raw_blocks
from tests.toyvoice import build_toy_voice, prepare_toy_utts, toy_config

F32_EPS = float(np.finfo(np.float32).eps)
MODES = [False, "interpret"]      # the JAX preselect: XLA path, Pallas kernel


def _hp_config(**over):
    return toy_config(target_representation="halfphone", **over)


@pytest.fixture(scope="module")
def hp():
    cfg, db, utts = build_toy_voice(halfphone=True)
    held = prepare_toy_utts(1, halfphone=True, seed0=900)[0]
    ts = Synthesiser(cfg, db, device="cpu")
    targets = [ts.halfphone_targets_from_features(u.features, u.epochs, u.halfphones)
               for u in (*utts, held)]
    return cfg, db, targets, ts


@pytest.fixture(scope="module")
def jax_hp(hp):
    cfg, db, _, _ = hp
    return {mode: JaxSynthesiser(_hp_config(use_pallas=mode), db=db) for mode in MODES}


def _path_cost64(cfg, db, synth, tgt, ids):
    tw = ((tgt - db.mean_target) / db.std_target) * synth._sqrt_wt
    f64 = np.float64
    fw = (((db.unit_features[ids] - db.mean_target) / db.std_target)
          * synth._sqrt_wt).astype(f64)
    jl = (((db.join_left[ids] - db.mean_join) / db.std_join) * synth._sqrt_wj).astype(f64)
    jr = (((db.join_right[ids] - db.mean_join) / db.std_join) * synth._sqrt_wj).astype(f64)
    jcw = cfg.join_cost_weight
    c64 = (np.sqrt(((fw - tw) ** 2).sum(-1)).sum()
           + jcw * np.sqrt(((jl[1:] - jr[:-1]) ** 2).sum(-1)).sum())
    noise = jcw * np.sqrt(16 * F32_EPS * ((jl[1:] ** 2).sum(-1)
                                          + (jr[:-1] ** 2).sum(-1))).sum()
    return c64, noise


def _assert_same(cfg, db, ts, a, b, tgt):
    """Equal ids and lengths, waves within 1e-5, costs as stated above."""
    np.testing.assert_array_equal(b["unit_ids"], a["unit_ids"])
    assert b["n_units"] == a["n_units"] == len(tgt)
    assert len(b["wave"]) == len(a["wave"])
    np.testing.assert_allclose(b["wave"], a["wave"], atol=1e-5)
    c64, noise = _path_cost64(cfg, db, ts, tgt, b["unit_ids"])
    np.testing.assert_allclose(b["total_cost"], c64, rtol=1e-5, atol=1e-4)
    assert abs(a["total_cost"] - b["total_cost"]) <= 1e-5 * abs(b["total_cost"]) + noise


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("which", [0, 4])        # a corpus utterance, held out
def test_halfphone_synth_from_features_matches_jax(hp, jax_hp, mode, which):
    cfg, db, targets, ts = hp
    tgt, kept = targets[which]
    a = jax_hp[mode].synth_from_features(tgt, target_segments=kept)
    b = ts.synth_from_features(tgt, target_segments=kept)
    _assert_same(cfg, db, ts, a, b, tgt)
    want = np.asarray([ts._unit_vocab.get(s.name, -1) for s in kept])
    if which == 0:
        assert (db.unit_code[b["unit_ids"]] == want).mean() > 0.95
        assert b["total_cost"] == 0.0, "the natural path must cost exactly 0"


@pytest.mark.parametrize("mode", MODES)
def test_halfphone_synth_batch_matches_jax(hp, jax_hp, mode):
    cfg, db, targets, ts = hp
    sel = [targets[i] for i in (0, 2, 4)]
    feats, segs = [t for t, _ in sel], [s for _, s in sel]
    ref = jax_hp[mode].synth_batch(feats, segments_list=segs)
    got = ts.synth_batch(feats, segments_list=segs)
    for a, b, (tgt, kept) in zip(ref, got, sel):
        _assert_same(cfg, db, ts, a, b, tgt)
        single = ts.synth_from_features(tgt, target_segments=kept)
        np.testing.assert_array_equal(b["unit_ids"], single["unit_ids"])


@pytest.mark.parametrize("method", ["quinphone_backoff", "acoustic"])
def test_preselection_methods_match_jax(hp, method):
    cfg, db, targets, _ = hp
    cfg_m = _hp_config(preselection_method=method)
    js, ts = JaxSynthesiser(cfg_m, db=db), Synthesiser(cfg_m, db, device="cpu")
    assert ts._use_ling() == (method != "acoustic")
    assert ts._ling_weights() == js._ling_weights()
    for tgt, kept in (targets[1], targets[4]):
        _assert_same(cfg, db, ts, js.synth_from_features(tgt, target_segments=kept),
                     ts.synth_from_features(tgt, target_segments=kept), tgt)


def test_halfphone_needs_segments(hp):
    _, _, targets, ts = hp
    with pytest.raises(ValueError):
        ts.synth_from_features(targets[0][0])
    with pytest.raises(ValueError):
        ts.synth_batch([targets[0][0]])


def test_halfphone_targets_match_jax(hp, jax_hp):
    cfg, db, _, ts = hp
    utt = prepare_toy_utts(1, halfphone=True, seed0=101)[0]
    a = jax_hp[False].halfphone_targets_from_features(utt.features, utt.epochs, utt.halfphones)
    b = ts.halfphone_targets_from_features(utt.features, utt.epochs, utt.halfphones)
    np.testing.assert_array_equal(b[0], a[0])
    assert b[1] == a[1]


# ---------------------------------------------------------------- multi-voice
@pytest.fixture(scope="module")
def two_voices():
    cfg, db_a, utts_a = build_toy_voice(halfphone=False, n_utts=2)
    _, db_b, utts_b = build_toy_voice(halfphone=False, n_utts=2)
    merged = merge_voicedbs([db_a, db_b], names=["alice", "bob"])
    return (cfg, merged, utts_a, utts_b, JaxSynthesiser(cfg, db=merged),
            Synthesiser(cfg, merged, device="cpu"))


def test_multivoice_api_matches_jax(two_voices):
    """The multi-voice API of tests/test_multivoice.py: a voice is required,
    an unknown name raises KeyError, ids equal the JAX ids and never leak."""
    cfg, merged, utts_a, utts_b, js, ts = two_voices
    assert ts.is_multivoice
    for synth in (js, ts):
        with pytest.raises(ValueError):
            synth.synth_from_features(utts_a[0].features)
        with pytest.raises(KeyError):
            synth.synth_from_features(utts_a[0].features, voice="nobody")
        with pytest.raises(ValueError):
            synth.synth_batch([utts_a[0].features])
    for voice, utt in [("alice", utts_a[0]), ("bob", utts_b[0]), (1, utts_b[1]),
                       ("alice", utts_b[1])]:
        a = js.synth_from_features(utt.features, voice=voice)
        b = ts.synth_from_features(utt.features, voice=voice)
        np.testing.assert_array_equal(b["unit_ids"], a["unit_ids"])
        np.testing.assert_allclose(b["wave"], a["wave"], atol=1e-5)
        assert (merged.voice_ids[b["unit_ids"]] == ts._voice_code(voice)).all()
    feats = [utts_a[0].features, utts_b[0].features, utts_a[1].features]
    voices = ["alice", "bob", "bob"]
    for r, a, b in zip(voices, js.synth_batch(feats, voices=voices),
                       ts.synth_batch(feats, voices=voices)):
        np.testing.assert_array_equal(b["unit_ids"], a["unit_ids"])
        np.testing.assert_allclose(b["wave"], a["wave"], atol=1e-5)
        assert (merged.voice_ids[b["unit_ids"]] == ts._voice_code(r)).all()


def test_multivoice_rejects_short_voices(two_voices):
    cfg, merged, *_ = two_voices
    n_min = int(np.bincount(merged.voice_ids).min())
    with pytest.raises(ValueError, match="fewer than"):
        Synthesiser(dataclasses.replace(cfg, n_candidates=n_min + 1), merged,
                    device="cpu")


def test_halfphone_multivoice_matches_jax():
    """Merged halfphone voices: partition and penalties fused in one
    preselect; ids equal the JAX ids, no voice leaks, the halfphone identity
    survives (tests/test_multivoice.py::test_halfphone_multivoice_merge_and_synth)."""
    cfg_a, db_a, utts_a = build_toy_voice(halfphone=True, n_utts=2)
    _, db_b, utts_b = build_toy_voice(halfphone=True, n_utts=2)
    merged = merge_voicedbs([db_a, db_b], names=["alice", "bob"])
    cfg = dataclasses.replace(cfg_a, n_candidates=6)
    js, ts = JaxSynthesiser(cfg, db=merged), Synthesiser(cfg, merged, device="cpu")
    ta, ka = ts.halfphone_targets_from_features(
        utts_a[0].features, utts_a[0].epochs, utts_a[0].halfphones)
    tb, kb = ts.halfphone_targets_from_features(
        utts_b[0].features, utts_b[0].epochs, utts_b[0].halfphones)
    with pytest.raises(ValueError):
        ts.synth_from_features(tb, target_segments=kb)
    a = js.synth_from_features(tb, target_segments=kb, voice="bob")
    b = ts.synth_from_features(tb, target_segments=kb, voice="bob")
    _assert_same(cfg, merged, ts, a, b, tb)
    assert (merged.voice_ids[b["unit_ids"]] == 1).all()
    want = np.asarray([ts._unit_vocab[s.name] for s in kb])
    assert (merged.unit_code[b["unit_ids"]] == want).mean() > 0.9
    ref = js.synth_batch([ta, tb], segments_list=[ka, kb], voices=["alice", "bob"])
    got = ts.synth_batch([ta, tb], segments_list=[ka, kb], voices=["alice", "bob"])
    for v, (r, g, t) in enumerate(zip(ref, got, (ta, tb))):
        _assert_same(cfg, merged, ts, r, g, t)
        assert (merged.voice_ids[g["unit_ids"]] == v).all()


# ------------------------------------------------------- fallback precision
def test_halfphone_fallback_keeps_f32_precision():
    """tests/test_e2e.py::test_halfphone_fallback_keeps_f32_precision against
    the port's step on a hand-built DeviceDB: two steps on a 256-unit DB,
    where only units 8 and 9 carry the step-0 name and nothing carries the
    step-1 name.  Step 0: a closer mismatched unit must lose to the
    same-name unit 9 (lattice mask).  Step 1: the acoustically best fallback,
    unit 5, must win over four slightly worse fallbacks of lower id, all
    within one f32 ulp of 1e10 (ID_RANK_PENALTY = 2^24 keeps their order).
    Ids equal the float64 oracle's."""
    d, M, T, k = 4, 256, 2, 4
    feats = np.full((M, d), 100.0, np.float32)
    feats[0:4, 0] = [11.0, 12.0, 13.0, 14.0]
    feats[0:4, 1:] = 0.0
    feats[5] = [10.0, 0, 0, 0]
    feats[8] = [0, 90.0, 0, 0]
    feats[9] = [0, 89.0, 0, 0]
    codes = np.full(M, 7, np.int32)
    codes[8] = codes[9] = 0
    targets = np.zeros((T, d), np.float32)
    targets[0] = [50.0, 0, 0, 0]
    tgt_codes = np.asarray([0, 3], np.int32)
    taper = 4
    cut1 = (np.arange(M, dtype=np.int32) * 8) + 16
    cut2 = cut1 + 8
    zeros, ones = np.zeros(d, np.float32), np.ones(d, np.float32)
    raw, _, _ = build_raw_blocks(feats, np.zeros((M, d), np.float32), M, ndb=1,
                                 affine=(zeros, ones, ones))
    db = device_db_from_numpy(dict(
        raw=raw, n_real=np.int32(M), cut1=cut1, cut2=cut2,
        waves=np.zeros(int(cut2[-1]) + 64, np.float32), wave_scale=np.float32(1.0),
        mean_t=zeros, std_t=ones, sqrt_wt=ones, mean_j=zeros, std_j=ones,
        sqrt_wj=ones, codes=codes, ctx=np.zeros((M, 5), np.int32),
        vids=np.zeros(M, np.int32)), "cpu")
    assert isinstance(db, DeviceDB)
    unit_ids, _, _, _ = synth_pipeline_step(
        db, torch.from_numpy(targets)[None], torch.tensor([T]),
        torch.from_numpy(tgt_codes)[None], torch.zeros((1, T, 5), dtype=torch.int32),
        torch.zeros((1, T), dtype=torch.int32), n_cand=k, jcw=0.0, eps=0.0,
        max_frag=8 + 2 * taper, out_len=128, taper=taper, halfphone=True)
    id_pen = (tgt_codes[:, None] != codes[None, :]) * float(ID_RANK_PENALTY)
    ids_ref, _ = oracle.synth_pipeline(
        targets.astype(np.float64), feats.astype(np.float64),
        np.zeros((M, d)), np.zeros((M, d)), n_candidates=k, join_cost_weight=0.0,
        extra=id_pen, lattice_penalty=id_pen)
    ids = unit_ids[0].numpy()
    assert ids[0] == 9, f"same-name unit must win step 0, got {ids[0]}"
    assert ids[1] == 5, f"best fallback must win step 1, got {ids[1]}"
    np.testing.assert_array_equal(ids, ids_ref)

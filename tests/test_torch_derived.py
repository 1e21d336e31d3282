"""The derived DB operand (config ``zero_transient: 0``) in
``snickery_tpu_torch`` on the CPU, against the JAX package:

- ``derive_operand`` against the JAX wrapper's derivation (``affine_rows``,
  the row norms, ``split3cat_db``'s bf16 halves);
- the derived twin vs ``pallas_topk_preselect(..., db_affine=...)`` without
  ``zero_transient`` (the derived branch, interpret mode) at the three
  precisions x {no mask, partition, penalties, both}: the same dead slots
  (+inf, 0), no padding row ever selected, scores within rtol/atol 1e-4
  ("highest") or 2e-3 (the splits), and an id kept by one side only a
  near-tie of the other side's k-th score in float64;
- the derived twin vs the zero-transient twin (port of
  tests/test_pallas_topk.py:234);
- the operand form and the rank margin the port resolves from the config,
  as the JAX steps resolve them;
- ``Synthesiser`` with ``zero_transient: 0`` vs the JAX ``Synthesiser``
  (``use_pallas="interpret"``) on the epoch, halfphone and merged toy
  voices, through ``synth_from_features``, ``synth_batch`` and
  ``synth_streaming``: the same unit ids and audio to f32 rounding, except
  where a near-tie sends one side down another path, which must then be no
  dearer in float64 for the port;
- the port's HTTP server and CLI on a config with ``zero_transient: 0``.
"""

import base64
import dataclasses
import functools
import json
import threading
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from snickery_tpu.const import QUINPHONE_CONTEXT_WEIGHTS, QUINPHONE_SCALE
from snickery_tpu.ops.pallas_topk import pallas_topk_preselect, split3cat_db
from snickery_tpu.ops.topk import preselect_margin as jax_margin
from snickery_tpu.ops.topk import zero_transient_default as jax_zt_default
from snickery_tpu.synth import BACKOFF_LING_WEIGHTS
from snickery_tpu.synth import Synthesiser as JaxSynthesiser
from snickery_tpu.voicedb.device_layout import affine_rows as jax_affine_rows
from snickery_tpu.voicedb.multivoice import merge_voicedbs
from snickery_tpu_torch import synth as synth_mod
from snickery_tpu_torch.cli import main as port_cli
from snickery_tpu_torch.io.speech import put_speech
from snickery_tpu_torch.kernel_check import scores64
from snickery_tpu_torch.ops import cuda_topk
from snickery_tpu_torch.ops.cuda_topk import (cuda_topk_preselect, derive_operand, pack_meta,
                                              presplit_width, split_bf16,
                                              topk_preselect_dv_plain,
                                              topk_preselect_zt_plain)
from snickery_tpu_torch.ops.topk import preselect_margin, resolve_zero_transient
from snickery_tpu_torch.server import SynthHTTPServer
from snickery_tpu_torch.synth import Synthesiser
from snickery_tpu_torch.voicedb.device_layout import build_raw_blocks
from tests.toyvoice import build_toy_voice, prepare_toy_utts

F32_EPS = float(np.finfo(np.float32).eps)
PRECISIONS = ("highest", "split3", "split3cat")
TOL = {"highest": 1e-4, "split3": 2e-3, "split3cat": 2e-3}
K = {"highest": 10, "split3": 10, "split3cat": 12}
VARIANTS = {"none": (False, None), "part": (True, None),
            "ling": (False, (*QUINPHONE_CONTEXT_WEIGHTS, QUINPHONE_SCALE)),
            "ling_part": (True, BACKOFF_LING_WEIGHTS)}
P = torch.from_numpy
J = jnp.asarray


def _block_and_labels(seed, Tn, M, m, kd):
    """Raw [data | sqn | ptr] block of m real rows padded to M, with
    duplicated rows; labels from 20 halfphone codes, 9 phones and 3 voices,
    with 8 targets whose code no row carries, 6 of a voice with 5 rows
    (starved slots) and 2 of a voice with none; padding rows labelled -1."""
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


# -------------------------------------------------------------- the operand
@pytest.mark.parametrize("precision", PRECISIONS)
def test_derive_operand_matches_jax(precision):
    """The operand is the JAX ``affine_rows`` of the raw rows bit for bit
    (padding rows 1e6 * sqrt_w); at split3cat its halves are the bf16 hi
    and lo of ``split3cat_db``, bit for bit, zero past kd; the row norms are
    the f32 sums of squares to a few ulps (another summation order)."""
    m, M, kd = 1000, 1024, 151
    raw, aff, _, _ = _block_and_labels(3, 4, M, m, kd)
    op, sqn = derive_operand(P(raw), tuple(map(P, aff)), m, M, precision)
    ref = np.asarray(jax_affine_rows(J(raw[:M, :kd]), *map(J, aff),
                                     jnp.arange(M) < m, 1e6))
    assert sqn.dtype == torch.float32 and sqn.shape == (M,)
    np.testing.assert_allclose(sqn.numpy(), (ref.astype(np.float64) ** 2).sum(-1),
                               rtol=4 * kd * F32_EPS)
    if precision != "split3cat":
        assert op.dtype == torch.float32 and op.shape == (M, kd) and op.is_contiguous()
        np.testing.assert_array_equal(op.numpy(), ref)
        return
    kp = presplit_width(kd) // 2
    assert op.dtype == torch.bfloat16 and op.shape == (M, 2 * kp) == (M, 320)
    cat = np.asarray(split3cat_db(J(ref)).astype(jnp.float32))       # [hi | hi | lo]
    got = op.float().numpy()
    np.testing.assert_array_equal(got[:, :kd], cat[:, :kd])
    np.testing.assert_array_equal(got[:, kp:kp + kd], cat[:, 2 * kd:3 * kd])
    assert not got[:, kd:kp].any() and not got[:, kp + kd:].any()
    hi, lo = split_bf16(torch.from_numpy(ref.copy()))
    np.testing.assert_array_equal(got[:, :kd], hi.numpy())
    np.testing.assert_array_equal(got[:, kp:kp + kd], lo.numpy())


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("precision", PRECISIONS)
def test_derived_twin_matches_pallas_interpret(precision, variant):
    """T=256, M=8192 (two Pallas chunks), kd 24 (16 with masks), 300
    padding rows: the derived twin vs the Pallas kernel's derived branch."""
    partition, weights = VARIANTS[variant]
    masked = partition or weights is not None
    Tn, M, k = 256, 8192, K[precision]
    kd, m = (16 if masked else 24), M - 300
    raw, aff, targets, (tc, tx, tv, dc, dx, dv) = _block_and_labels(
        10 * PRECISIONS.index(precision) + sorted(VARIANTS).index(variant), Tn, M, m, kd)
    ri, rv = pallas_topk_preselect(
        J(targets), J(raw[:M, :kd]), k=k, interpret=True, mm_precision=precision,
        sort=True, db_affine=(*map(J, aff), jnp.int32(m)),
        partition=(J(tv), J(dv)) if partition else None,
        linguistic=(J(tc), J(tx), J(dc), J(dx)) if weights else None,
        ling_weights=weights)
    masks = {}
    if masked:
        masks = dict(tgt_meta=pack_meta(P(tc), P(tx), P(tv)),
                     db_meta=pack_meta(P(dc), P(dx), P(dv)),
                     partition=partition, ling_weights=weights)
    op, sqn = derive_operand(P(raw), tuple(map(P, aff)), m, M, precision)
    gi, gv = cuda_topk_preselect(P(targets), op, k, None, M, precision=precision,
                                 zero_transient=False, sqn=sqn, **masks)
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
    s_g = scores64(op, None, P(targets), gi, masks, precision, sqn)
    s_r = scores64(op, None, P(targets), ri, masks, precision, sqn)
    tol = TOL[precision]
    for t in range(Tn):
        g, r = gi[t][live[t]].numpy(), ri[t][~dead_r[t]].numpy()
        shared, a, b = np.intersect1d(g, r, return_indices=True)
        np.testing.assert_allclose(gv[t, a].numpy(), rv[t, b].numpy(), rtol=tol, atol=tol)
        if len(shared) == len(g):
            continue
        kth_g = s_g[t][live[t]].max().item()
        kth_r = s_r[t][~dead_r[t]].max().item()
        tie = tol * (1.0 + max(abs(kth_g), abs(kth_r)))
        only_g, only_r = ~np.isin(g, r), ~np.isin(r, g)
        assert (s_g[t][live[t]].numpy()[only_g] >= kth_r - tie).all(), t
        assert (s_r[t][~dead_r[t]].numpy()[only_r] >= kth_g - tie).all(), t


@pytest.mark.parametrize("precision", PRECISIONS)
def test_derived_twin_matches_zero_transient_twin(precision):
    """Port of tests/test_pallas_topk.py:234: the derived operand and the
    raw block with the affine folded into the targets select the same
    candidates (set overlap > 0.99; the zero-transient scores get comp
    back), scores of equal ids within 1e-4 / 2e-3; padding never wins."""
    Tn, M, kd, k = 256, 8192, 24, 10
    m = M - 700
    raw, aff, targets, _ = _block_and_labels(81 + PRECISIONS.index(precision), Tn, M, m, kd)
    A = tuple(map(P, aff))
    i_zt, v_zt = topk_preselect_zt_plain(P(targets), P(raw), k, A, M, precision=precision)
    op, sqn = derive_operand(P(raw), A, m, M, precision)
    i_d, v_d = topk_preselect_dv_plain(P(targets), op, sqn, k, M, precision=precision)
    i_zt, i_d, v_zt, v_d = (x.numpy() for x in (i_zt, i_d, v_zt, v_d))
    assert (i_d < m).all() and (i_zt < m).all(), "padding rows must never be selected"
    overlap = np.mean([len(np.intersect1d(i_zt[t], i_d[t])) / k for t in range(Tn)])
    assert overlap > 0.99, overlap
    same = i_zt == i_d
    tol = TOL[precision]
    np.testing.assert_allclose(v_zt[same], v_d[same], rtol=tol, atol=tol)


def test_derived_wrapper_checks_its_operand():
    """The derived form takes sqn and no affine, an f32 operand of width kd
    at highest / split3 and a bf16 one of presplit_width(kd) at split3cat;
    a CPU tensor runs the twin and counts no launch."""
    m, M, kd = 500, 512, 24
    raw, aff, targets, _ = _block_and_labels(4, 9, M, m, kd)
    A, tg = tuple(map(P, aff)), P(targets)
    op, sqn = derive_operand(P(raw), A, m, M, "highest")
    before = dict(cuda_topk.LAUNCH_COUNTS)
    assert torch.equal(cuda_topk_preselect(tg, op, 6, None, M, zero_transient=False,
                                           sqn=sqn)[0],
                       topk_preselect_dv_plain(tg, op, sqn, 6, M)[0])
    assert dict(cuda_topk.LAUNCH_COUNTS) == before
    with pytest.raises(ValueError, match="sqn goes with"):
        cuda_topk_preselect(tg, op, 6, None, M, sqn=sqn)
    with pytest.raises(ValueError, match="sqn goes with"):
        cuda_topk_preselect(tg, op, 6, None, M, zero_transient=False)
    with pytest.raises(ValueError, match="db_affine"):
        cuda_topk_preselect(tg, op, 6, A, M, zero_transient=False, sqn=sqn)
    with pytest.raises(TypeError, match="bfloat16"):
        cuda_topk_preselect(tg, op, 6, None, M, zero_transient=False, sqn=sqn,
                            precision="split3cat")
    with pytest.raises(ValueError, match="width"):
        cuda_topk_preselect(tg, op[:, :-1].contiguous(), 6, None, M,
                            zero_transient=False, sqn=sqn)
    with pytest.raises(ValueError, match="sqn must be"):
        cuda_topk_preselect(tg, op, 6, None, M, zero_transient=False, sqn=sqn[:100])
    split_op, _ = derive_operand(P(raw), A, m, M, "split3cat")
    assert split_op.shape[1] == presplit_width(kd) == 64
    names = {cuda_topk.kernel_name(p, q, prec, zt) for zt in (True, False)
             for prec in PRECISIONS for p in (False, True) for q in (False, True)}
    assert names == set(cuda_topk.ALL_KERNELS) and len(names) == 24
    assert cuda_topk.kernel_name(True, True, "split3cat", False) == \
        "topk_preselect_dv_split3cat_ling_part"


# ------------------------------------------------------ policy and margins
@pytest.mark.parametrize("margin", [-1, 7])
@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("zero_transient", [-1, 0, 1])
def test_resolved_form_and_margin_match_jax(zero_transient, precision, margin, monkeypatch):
    """The operand form and the rank margin, resolved from the config keys
    as ``snickery_tpu/synth.py:165-169`` resolves them with the Pallas
    kernel on, for epoch and halfphone voices; and a step of the port's
    Synthesiser calls the kernel wrapper in that form with that k."""
    zt_jax = (jax_zt_default(True, precision) if zero_transient < 0
              else bool(True and zero_transient))
    zt = resolve_zero_transient(zero_transient, precision)
    assert zt == zt_jax
    for halfphone in (False, True):
        assert preselect_margin(True, precision, halfphone, zero_transient=zt,
                                override=margin) == jax_margin(
            True, precision, halfphone, zero_transient=zt_jax, override=margin)
    cfg, db = _voice("epoch")
    ts = Synthesiser(dataclasses.replace(cfg, zero_transient=zero_transient,
                                         preselect_precision=precision,
                                         preselect_margin=margin), db, device="cpu")
    calls = []
    real = synth_mod.cuda_topk_preselect

    def spy(*args, **kw):
        calls.append((args[2], kw.get("zero_transient", True)))
        return real(*args, **kw)

    monkeypatch.setattr(synth_mod, "cuda_topk_preselect", spy)
    ts.synth_from_features(prepare_toy_utts(1, seed0=960)[0].features)
    k = min(cfg.n_candidates + jax_margin(True, precision, False, zero_transient=zt_jax,
                                          override=margin), ts.n_units_padded)
    assert calls == [(k, zt_jax)]


# ------------------------------------------------------ the Synthesiser paths
@functools.cache
def _voice(kind):
    """(config, VoiceDB) of a toy voice: epoch units, halfphone units, or two
    epoch voices merged."""
    if kind == "merged_epoch":
        cfg, db_a, _ = build_toy_voice(halfphone=False, n_utts=2)
        _, db_b, _ = build_toy_voice(halfphone=False, n_utts=3)
        return cfg, merge_voicedbs([db_a, db_b], names=["alice", "bob"])
    cfg, db, _ = build_toy_voice(halfphone=kind == "halfphone", n_utts=4)
    return cfg, db


def _path_cost64(cfg, db, synth, tgt, ids):
    """Float64 target + join cost of a unit path (tests/test_torch_synth.py)."""
    f64 = np.float64
    tw = ((tgt - db.mean_target) / db.std_target) * synth._sqrt_wt
    fw = (((db.unit_features[ids] - db.mean_target) / db.std_target) * synth._sqrt_wt).astype(f64)
    jl = (((db.join_left[ids] - db.mean_join) / db.std_join) * synth._sqrt_wj).astype(f64)
    jr = (((db.join_right[ids] - db.mean_join) / db.std_join) * synth._sqrt_wj).astype(f64)
    return (np.sqrt(((fw - tw) ** 2).sum(-1)).sum()
            + cfg.join_cost_weight * np.sqrt(((jl[1:] - jr[:-1]) ** 2).sum(-1)).sum())


def _assert_matches(cfg, db, ts, tgt, got, ref):
    """The same ids and audio to f32 rounding, or (a near-tie at the
    margin-free boundary sent one side elsewhere) a path that is no dearer
    in float64 for the port and mostly the same units."""
    assert len(got["unit_ids"]) == len(ref["unit_ids"])
    if np.array_equal(got["unit_ids"], ref["unit_ids"]):
        assert len(got["wave"]) == len(ref["wave"])
        np.testing.assert_allclose(got["wave"], ref["wave"], atol=1e-5)
        return
    c_port = _path_cost64(cfg, db, ts, tgt, got["unit_ids"])
    c_jax = _path_cost64(cfg, db, ts, tgt, ref["unit_ids"])
    assert c_port <= c_jax * (1 + 1e-12), (c_port, c_jax)
    assert (got["unit_ids"] == ref["unit_ids"]).mean() >= 0.9


def _pair(kind, precision, **over):
    cfg, db = _voice(kind)
    cfg = dataclasses.replace(cfg, zero_transient=0, preselect_precision=precision, **over)
    return (cfg, db, Synthesiser(cfg, db, device="cpu"),
            JaxSynthesiser(dataclasses.replace(cfg, use_pallas="interpret"), db=db))


def _spy_derive(monkeypatch):
    """Count the port's operand derivations (the derived path ran)."""
    calls = []
    real = synth_mod.derive_operand

    def spy(*args, **kw):
        calls.append(args[-1])
        return real(*args, **kw)

    monkeypatch.setattr(synth_mod, "derive_operand", spy)
    return calls


CASES = {"epoch-highest": ("epoch", "highest"), "epoch-split3cat": ("epoch", "split3cat"),
         "halfphone-highest": ("halfphone", "highest"), "merged-split3": ("merged_epoch", "split3")}


@pytest.mark.parametrize("case", sorted(CASES))
def test_derived_synth_matches_jax_pallas_interpret(case, monkeypatch):
    """``synth_batch`` of two held-out utterances and ``synth_from_features``
    of the first, at zero_transient 0, vs the JAX Synthesiser through the
    Pallas kernel's derived branch (interpret mode); at "highest" with no
    rank margin (k = n_candidates)."""
    kind, precision = CASES[case]
    cfg, db, ts, js = _pair(kind, precision)
    calls = _spy_derive(monkeypatch)
    halfphone = kind == "halfphone"
    held = prepare_toy_utts(2, halfphone=halfphone, seed0=970)
    voices = ["bob", "alice"] if kind == "merged_epoch" else None
    if halfphone:
        tk = [ts.halfphone_targets_from_features(u.features, u.epochs, u.halfphones)
              for u in held]
        feats, segs = [t for t, _ in tk], [s for _, s in tk]
    else:
        feats, segs = [u.features for u in held], None
    got = ts.synth_batch(feats, voices=voices, segments_list=segs)
    assert calls == [precision]
    ref = js.synth_batch(feats, voices=voices, segments_list=segs)
    for i, (g, r) in enumerate(zip(got, ref)):
        tgt = feats[i] if halfphone else ts.targets_from_features(feats[i])[0]
        _assert_matches(cfg, db, ts, tgt, g, r)
        if voices:
            assert (db.voice_ids[g["unit_ids"]] == ts._voice_code(voices[i])).all()
    kw = dict(target_segments=segs[0] if segs else None, voice=voices[0] if voices else None)
    single, ref1 = ts.synth_from_features(feats[0], **kw), js.synth_from_features(feats[0], **kw)
    np.testing.assert_array_equal(single["unit_ids"], got[0]["unit_ids"])
    _assert_matches(cfg, db, ts, feats[0] if halfphone else ts.targets_from_features(feats[0])[0],
                    single, ref1)


def _stream(synth, chunks, **kw):
    audio = list(synth.synth_streaming(iter(chunks), **kw))
    return audio, synth.last_stream_unit_ids


@pytest.mark.parametrize("case", ["epoch-highest", "epoch-split3cat", "merged-split3"])
def test_derived_streaming_matches_jax_pallas_interpret(case, monkeypatch):
    """``synth_streaming`` at zero_transient 0 (epoch-rate chunks of 24
    units) vs the JAX package's, chunk by chunk: the same ids and audio to
    f32 rounding, and the exact sample total."""
    kind, precision = CASES[case]
    cfg, db, ts, js = _pair(kind, precision)
    calls = _spy_derive(monkeypatch)
    kw = {"voice": "alice"} if kind == "merged_epoch" else {}
    feats = prepare_toy_utts(1, seed0=975)[0].features[1:-1]
    chunks = [feats[i:i + 24] for i in range(0, len(feats), 24)]
    (audio_t, ids_t), (audio_j, ids_j) = _stream(ts, chunks, **kw), _stream(js, chunks, **kw)
    assert calls == [precision] * len(ids_t)
    assert len(ids_t) == len(ids_j)
    for a, b in zip(ids_t, ids_j):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(audio_t, audio_j):
        np.testing.assert_allclose(a, b, atol=1e-5)
    ids = np.concatenate(ids_t)
    spans = (db.cutpoints[ids, 2] - db.cutpoints[ids, 1]).astype(np.int64)
    assert sum(len(a) for a in audio_t) == 2 * cfg.taper_length + int(spans.sum())
    if kind == "merged_epoch":
        assert (db.voice_ids[ids] == ts._voice_code("alice")).all()


# ------------------------------------------------------- server and CLI
def test_server_at_zero_transient_0(monkeypatch):
    """One POST /synth to the port's server on a Synthesiser at
    zero_transient 0 answers the direct call's ids and audio."""
    cfg, db = _voice("epoch")
    ts = Synthesiser(dataclasses.replace(cfg, zero_transient=0), db, device="cpu")
    calls = _spy_derive(monkeypatch)
    feats = prepare_toy_utts(1, seed0=980)[0].features.astype(np.float32)
    httpd = SynthHTTPServer(ts, host="127.0.0.1", port=0, max_wait_ms=5.0)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        req = urllib.request.Request(
            f"http://127.0.0.1:{httpd.server_address[1]}/synth",
            data=json.dumps({"features_b64": base64.b64encode(feats.tobytes()).decode()}).encode(),
            headers={"Content-Type": "application/json"})
        out = json.load(urllib.request.urlopen(req, timeout=300))
    finally:
        httpd.shutdown()
        httpd.server_close()
    assert calls == ["highest"]
    ref = ts.synth_from_features(feats)
    np.testing.assert_array_equal(np.asarray(out["unit_ids"]), ref["unit_ids"])
    wave = np.frombuffer(base64.b64decode(out["wave_b64"]), np.float32)
    np.testing.assert_allclose(wave, ref["wave"], atol=1e-6)


def test_cli_at_zero_transient_0(tmp_path, monkeypatch):
    """``snickery_tpu_torch.cli synth`` on a config file with
    ``zero_transient: 0`` (DNN-target stream files): its units.npy equal a
    direct ``synth_from_features`` at zero_transient 0."""
    cfg, db = _voice("epoch")
    db.save(str(tmp_path / "work" / "dvtoy.voicedb"))
    held = prepare_toy_utts(2, seed0=985)
    slices = {"mag": (0, 60), "real": (60, 105), "imag": (105, 150), "lf0": (150, 151)}
    for i, u in enumerate(held):
        for s, (a, b) in slices.items():
            (tmp_path / "pred" / s).mkdir(parents=True, exist_ok=True)
            put_speech(u.features[:, a:b], str(tmp_path / "pred" / s / f"p{i}.{s}"))
    cfg_d = dict(dataclasses.asdict(cfg), workdir=str(tmp_path / "work"),
                 voice_name="dvtoy", test_data_dir=str(tmp_path / "pred"), zero_transient=0)
    (tmp_path / "dv.json").write_text(json.dumps(cfg_d))
    calls = _spy_derive(monkeypatch)
    out = tmp_path / "out"
    assert port_cli(["synth", "-c", str(tmp_path / "dv.json"), "-o", str(out),
                     "--device", "cpu", "--dump-units"]) == 0
    assert calls == ["highest"] * len(held)
    ts = Synthesiser(dataclasses.replace(cfg, zero_transient=0), db, device="cpu")
    for i, u in enumerate(held):
        np.testing.assert_array_equal(np.load(out / f"p{i}.units.npy"),
                                      ts.synth_from_features(u.features)["unit_ids"])

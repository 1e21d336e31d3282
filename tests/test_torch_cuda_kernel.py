"""The port on a CUDA card: the preselect kernel (its masked variants, its
split-precision variants and the two composed, in both operand forms and
in every selection form) against its plain twin, and the synthesiser on the card against the same
synthesiser on the CPU, for epoch, halfphone and merged voices, at the
split precisions, on the derived operand, and streaming.

Marked ``cuda``; each test skips where no card is visible.  This file
imports no jax, so it also runs on a GPU host without jax, where the
repository's conftest (which configures jax) is left out:

    python -m pytest -m cuda --noconftest -p no:cacheprovider tests/test_torch_cuda_kernel.py
"""

import numpy as np
import pytest
import torch

from snickery_tpu_torch.config import SnickeryConfig
from snickery_tpu_torch.const import QUINPHONE_CONTEXT_WEIGHTS, QUINPHONE_SCALE
from snickery_tpu_torch.voicedb.build import UtteranceData, build_voicedb
from snickery_tpu_torch.voicedb.device_layout import build_raw_blocks
from snickery_tpu_torch.voicedb.multivoice import merge_voicedbs
from snickery_tpu_torch.kernel_check import (EDGE_CASES, PROBE_RTOL, compare, pileup_block,
                                             run_edge_case, split_probe_error)
from snickery_tpu_torch.ops import cuda_topk
from snickery_tpu_torch.ops.cuda_topk import (cuda_topk_preselect, derive_operand, pack_meta,
                                              topk_preselect_zt_plain)
from snickery_tpu_torch.synth import BACKOFF_LING_WEIGHTS, Synthesiser
from snickery_tpu_torch.synthetic_voices import make_halfphone_utterances, phone_means

KD = 151
VARIANTS = {"part": (True, None), "ling": (False, (*QUINPHONE_CONTEXT_WEIGHTS, QUINPHONE_SCALE)),
            "ling_part": (True, BACKOFF_LING_WEIGHTS)}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run this file on the GPU host)")
    return torch.device("cuda")


def _block(seed, M, dup, kd=KD):
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((M, kd)).astype(np.float32)
    if dup:
        feats[100:140] = feats[50]
    jr = np.zeros_like(feats)
    jr[:-1] = feats[1:]
    aff = ((0.1 * rng.standard_normal(kd)).astype(np.float32),
           rng.uniform(0.5, 2.0, kd).astype(np.float32),
           rng.uniform(0.2, 1.0, kd).astype(np.float32))
    raw, _, _ = build_raw_blocks(feats, jr, M, affine=aff)
    return rng, raw, aff


@pytest.mark.cuda
@pytest.mark.parametrize("T,M,dup", [(128, 8192, False), (300, 8229, False),
                                     (256, 8192, True), (2048, 65536, False)])
def test_kernel_matches_plain(cuda_device, T, M, dup):
    """Same card tensors through the kernel and the twin: id sets equal,
    lowest index first among the duplicated rows, scores within 1e-3 (f32
    sums of 151 products, possibly in another order)."""
    rng, raw, aff = _block(T + M, M, dup)
    tg = torch.from_numpy(rng.standard_normal((T, KD)).astype(np.float32)).to(cuda_device)
    R = torch.from_numpy(raw).to(cuda_device)
    A = tuple(torch.from_numpy(a).to(cuda_device) for a in aff)
    before = cuda_topk.LAUNCH_COUNTS[cuda_topk.KERNEL]
    ki, kv = cuda_topk_preselect(tg, R, 40, A, M)
    assert cuda_topk.LAUNCH_COUNTS[cuda_topk.KERNEL] == before + 1
    pi, pv = topk_preselect_zt_plain(tg, R, 40, A, M)
    torch.cuda.synchronize()
    ks, ko = torch.sort(ki.long(), 1)
    ps, po = torch.sort(pi.long(), 1)
    assert torch.equal(ks, ps)
    torch.testing.assert_close(torch.gather(kv, 1, ko), torch.gather(pv, 1, po),
                               rtol=0, atol=1e-3)
    assert bool((kv[:, 1:] >= kv[:, :-1]).all()), "kernel output ascending"


@pytest.mark.cuda
@pytest.mark.parametrize("zt", [True, False], ids=["zt", "dv"])
@pytest.mark.parametrize("edge", sorted(EDGE_CASES))
def test_kernel_matches_plain_at_the_edges(cuda_device, edge, zt):
    """The 128 x 128 tiles' edges and the screened epilogue's at "highest"
    (kernel_check.EDGE_CASES: ragged T and M over one split and several,
    kd 453 at k 64 with the 64-target tile, scores falling with the row index
    so that the survivor queue overflows on every tile, rising scores,
    bit-identical rows, a starved voice): the rule of kernel_check.compare."""
    name = cuda_topk.kernel_name(edge == "starved", False, "highest", zt)
    before = cuda_topk.LAUNCH_COUNTS[name]
    run_edge_case(edge, cuda_device, "highest", zt)
    assert cuda_topk.LAUNCH_COUNTS[name] > before


@pytest.mark.cuda
@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("T,M,kd", [(128, 65536, KD), (300, 8229, 3 * KD), (2048, 65536, 3 * KD)])
def test_masked_kernel_matches_plain(cuda_device, variant, T, M, kd):
    """The partition / quinphone-penalty variants against the twin on the
    same card tensors, with a voice of 6 rows (starved slots (+inf, 0)), a
    voice of none and a code no row carries: ids and scores equal (the
    kernel and the twin sum in the same order on this card, so penalised
    scores near 2^24 agree too; a swap would need an exact f32 tie)."""
    partition, weights = VARIANTS[variant]
    rng, raw, aff = _block(T + M + kd, M, False, kd)
    tc = rng.integers(0, 80, T).astype(np.int32)
    tc[:16] = 80
    tv = rng.integers(0, 7, T).astype(np.int32)
    tv[16:48], tv[48:56] = 7, 9
    dv = rng.integers(0, 7, M).astype(np.int32)
    dv[rng.choice(M, 6, replace=False)] = 7
    D = lambda a: torch.from_numpy(a).to(cuda_device)
    tm = pack_meta(D(tc), D(rng.integers(0, 40, (T, 5)).astype(np.int32)), D(tv))
    dm = pack_meta(D(rng.integers(0, 80, M).astype(np.int32)),
                   D(rng.integers(0, 40, (M, 5)).astype(np.int32)), D(dv))
    tg = D(rng.standard_normal((T, kd)).astype(np.float32))
    kw = dict(tgt_meta=tm, db_meta=dm, partition=partition, ling_weights=weights)
    name = cuda_topk.kernel_name(partition, weights is not None)
    before = cuda_topk.LAUNCH_COUNTS[name]
    ki, kv = cuda_topk_preselect(tg, D(raw), 30, tuple(map(D, aff)), M, **kw)
    assert cuda_topk.LAUNCH_COUNTS[name] == before + 1
    pi, pv = topk_preselect_zt_plain(tg, D(raw), 30, tuple(map(D, aff)), M, **kw)
    torch.cuda.synchronize()
    assert torch.equal(ki, pi) and torch.equal(kv, pv)
    if partition:
        assert bool(torch.isinf(kv[16:48, 6:]).all()) and not bool(ki[16:56, 6:].any())
        assert bool(torch.isinf(kv[48:56]).all())
        live = torch.isfinite(kv)
        assert torch.equal(dm[ki.long(), 6][live], tm[:, 6, None].expand_as(ki)[live])


def _utterances(seed, n_utts, n_epochs):
    """Numpy-made epoch utterances: AR(1) feature walks, 80-160-sample
    periods, low-amplitude noise waves."""
    rng = np.random.default_rng(seed)
    utts = []
    for u in range(n_utts):
        x = np.empty((n_epochs, KD), np.float32)
        x[0] = rng.standard_normal(KD)
        for e in range(1, n_epochs):
            x[e] = 0.95 * x[e - 1] + 0.31 * rng.standard_normal(KD)
        periods = rng.integers(80, 161, n_epochs)
        epochs = 160 + np.cumsum(periods) - periods[0]
        x[:, -1] = np.log(16000 / periods)
        utts.append(UtteranceData(
            basename=f"u{u}", epochs=epochs.astype(np.int32), features=x,
            wave=0.05 * rng.standard_normal(int(epochs[-1]) + 200).astype(np.float32),
            lf0=x[:, -1].copy()))
    return utts


@pytest.mark.cuda
def test_synthesiser_on_card_matches_cpu(cuda_device):
    """The whole step on the card (kernel, Viterbi, OLA) gives the CPU
    path's unit ids, costs (rtol 1e-5) and audio (atol 1e-5)."""
    cfg = SnickeryConfig(
        stream_list=["mag", "real", "imag", "lf0"],
        datadims={"mag": 60, "real": 45, "imag": 45, "lf0": 1},
        n_candidates=30, taper_length=50, join_cost_weight=0.7,
        length_buckets=[256])
    db = build_voicedb(cfg, _utterances(1, 40, 202))
    held = [u.features for u in _utterances(2, 3, 258)]
    gpu, cpu = Synthesiser(cfg, db, device=cuda_device), Synthesiser(cfg, db, device="cpu")
    before = cuda_topk.LAUNCH_COUNTS[cuda_topk.KERNEL]
    out_g = gpu.synth_batch(held)
    assert cuda_topk.LAUNCH_COUNTS[cuda_topk.KERNEL] == before + 1
    for g, c in zip(out_g, cpu.synth_batch(held)):
        np.testing.assert_array_equal(g["unit_ids"], c["unit_ids"])
        np.testing.assert_allclose(g["total_cost"], c["total_cost"], rtol=1e-5)
        np.testing.assert_allclose(g["wave"], c["wave"], atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["halfphone", "merged_halfphone", "merged_epoch"])
def test_masked_synthesiser_on_card_matches_cpu(cuda_device, kind):
    """Halfphone and merged voices: the whole step on the card gives the CPU
    path's ids, costs (rtol 1e-5) and audio (atol 1e-5), through the
    variant the voice needs, with no unit from another voice."""
    cfg = SnickeryConfig(
        stream_list=["mag", "real", "imag", "lf0"],
        datadims={"mag": 60, "real": 45, "imag": 45, "lf0": 1},
        n_candidates=20, taper_length=50, join_cost_weight=0.7,
        length_buckets=[128, 256],
        target_representation="epoch" if kind == "merged_epoch" else "halfphone")
    dbs, held, feats, segs = [], [], [], None
    for v in range(1 if kind == "halfphone" else 2):
        if kind == "merged_epoch":
            dbs.append(build_voicedb(cfg, _utterances(20 + v, 12, 202)))
            feats += [u.features for u in _utterances(30 + v, 2, 150)]
        else:
            rng, means = np.random.default_rng(10 + v), phone_means(50 + v)
            dbs.append(build_voicedb(cfg, make_halfphone_utterances(rng, 30, 40, f"c{v}", means)))
            held += make_halfphone_utterances(rng, 2, 40, f"h{v}", means)
    db = dbs[0] if kind == "halfphone" else merge_voicedbs(dbs, names=["a", "b"])
    voices = None if kind == "halfphone" else ["a", "a", "b", "b"]
    gpu, cpu = Synthesiser(cfg, db, device=cuda_device), Synthesiser(cfg, db, device="cpu")
    if held:
        tgts = [gpu.halfphone_targets_from_features(u.features, u.epochs, u.halfphones)
                for u in held]
        feats, segs = [t for t, _ in tgts], [s for _, s in tgts]
    name = cuda_topk.kernel_name(kind != "halfphone", kind != "merged_epoch")
    before = cuda_topk.LAUNCH_COUNTS[name]
    out_g = gpu.synth_batch(feats, voices=voices, segments_list=segs)
    assert cuda_topk.LAUNCH_COUNTS[name] == before + 1
    out_c = cpu.synth_batch(feats, voices=voices, segments_list=segs)
    for i, (g, c) in enumerate(zip(out_g, out_c)):
        np.testing.assert_array_equal(g["unit_ids"], c["unit_ids"])
        np.testing.assert_allclose(g["total_cost"], c["total_cost"], rtol=1e-5)
        np.testing.assert_allclose(g["wave"], c["wave"], atol=1e-5)
        if voices:
            assert (db.voice_ids[g["unit_ids"]] == gpu._voice_code(voices[i])).all()


@pytest.mark.cuda
@pytest.mark.parametrize("precision,k", [("split3cat", 48), ("split3", 40)])
@pytest.mark.parametrize("T,M", [(128, 8192), (300, 8229), (2048, 65536)])
def test_split_kernel_matches_plain(cuda_device, precision, k, T, M):
    """The tensor-core split variants against the twin on the same card
    tensors, with duplicated rows: scores of shared ids within 1e-3 + 1 ulp
    (f32 sums in another order), id sets equal except on at most 1% of rows,
    where the differing ids are near-ties of the k-th score in float64."""
    rng, raw, aff = _block(T + M + k, M, True)
    tg = torch.from_numpy(rng.standard_normal((T, KD)).astype(np.float32)).to(cuda_device)
    R = torch.from_numpy(raw).to(cuda_device)
    A = tuple(torch.from_numpy(a).to(cuda_device) for a in aff)
    name = cuda_topk.kernel_name(False, False, precision)
    before = cuda_topk.LAUNCH_COUNTS[name]
    compare(tg, R, A, M, k, precision)
    assert cuda_topk.LAUNCH_COUNTS[name] == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("zt", [True, False], ids=["zt", "dv"])
@pytest.mark.parametrize("precision", ["split3cat", "split3"])
@pytest.mark.parametrize("edge", sorted(EDGE_CASES))
def test_split_kernel_matches_plain_at_the_edges(cuda_device, edge, precision, zt):
    """The same edges at the split precisions (the wgmma tiles of 64 DB rows
    x 128 or 64 targets, two consumer warpgroups sharing the lists): the
    rule of kernel_check.compare."""
    name = cuda_topk.kernel_name(edge == "starved", False, precision, zt)
    before = cuda_topk.LAUNCH_COUNTS[name]
    run_edge_case(edge, cuda_device, precision, zt)
    assert cuda_topk.LAUNCH_COUNTS[name] > before


@pytest.mark.cuda
@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("precision,k", [("split3cat", 48), ("split3", 40)])
@pytest.mark.parametrize("T,M,kd", [(300, 8229, KD), (2048, 65536, 3 * KD)])
def test_split_masked_kernel_matches_plain(cuda_device, variant, precision, k, T, M, kd):
    """The six split x mask entry points against the twin on the same card
    tensors, with duplicated rows, a voice of k // 2 rows (starved slots
    (+inf, 0)), a voice of none and a code no row carries: the rule of
    kernel_check.compare (scores within max(1e-3, the tensor cores'
    accumulation bound) + 1 ulp, near-ties judged in float64 on the three
    bf16 products plus the penalties)."""
    partition, weights = VARIANTS[variant]
    rng, raw, aff = _block(T + M + kd + k, M, True, kd)
    tc = rng.integers(0, 80, T).astype(np.int32)
    tc[:16] = 80
    tv = rng.integers(0, 7, T).astype(np.int32)
    tv[16:48], tv[48:56] = 7, 9
    dv = rng.integers(0, 7, M).astype(np.int32)
    dv[rng.choice(M, k // 2, replace=False)] = 7
    D = lambda a: torch.from_numpy(a).to(cuda_device)
    tm = pack_meta(D(tc), D(rng.integers(0, 40, (T, 5)).astype(np.int32)), D(tv))
    dm = pack_meta(D(rng.integers(0, 80, M).astype(np.int32)),
                   D(rng.integers(0, 40, (M, 5)).astype(np.int32)), D(dv))
    tg = D(rng.standard_normal((T, kd)).astype(np.float32))
    name = cuda_topk.kernel_name(partition, weights is not None, precision)
    assert name == f"topk_preselect_zt_{precision}_{variant}"
    before = cuda_topk.LAUNCH_COUNTS[name]
    _, _, dead = compare(tg, D(raw), tuple(map(D, aff)), M, k, precision, tgt_meta=tm,
                         db_meta=dm, partition=partition, ling_weights=weights)
    assert cuda_topk.LAUNCH_COUNTS[name] == before + 1
    if partition:
        assert dead == 32 * (k - k // 2) + 8 * k


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["split3cat", "split3"])
@pytest.mark.parametrize("kind", ["halfphone", "merged_halfphone", "merged_epoch"])
def test_split_masked_synthesiser_on_card_matches_cpu(cuda_device, kind, precision):
    """Halfphone and merged voices at a split precision: the whole step on
    the card, through the split x mask variant the voice needs, gives the CPU
    path's ids and audio (atol 1e-5): the rank margin and the exact f32
    rescore absorb the kernel's rounding."""
    cfg = SnickeryConfig(
        stream_list=["mag", "real", "imag", "lf0"],
        datadims={"mag": 60, "real": 45, "imag": 45, "lf0": 1},
        n_candidates=20, taper_length=50, join_cost_weight=0.7,
        length_buckets=[128, 256], preselect_precision=precision,
        target_representation="epoch" if kind == "merged_epoch" else "halfphone")
    dbs, held, feats, segs = [], [], [], None
    for v in range(1 if kind == "halfphone" else 2):
        if kind == "merged_epoch":
            dbs.append(build_voicedb(cfg, _utterances(40 + v, 12, 202)))
            feats += [u.features for u in _utterances(50 + v, 2, 150)]
        else:
            rng, means = np.random.default_rng(60 + v), phone_means(70 + v)
            dbs.append(build_voicedb(cfg, make_halfphone_utterances(rng, 30, 40, f"c{v}", means)))
            held += make_halfphone_utterances(rng, 2, 40, f"h{v}", means)
    db = dbs[0] if kind == "halfphone" else merge_voicedbs(dbs, names=["a", "b"])
    voices = None if kind == "halfphone" else ["a", "a", "b", "b"]
    gpu, cpu = Synthesiser(cfg, db, device=cuda_device), Synthesiser(cfg, db, device="cpu")
    if held:
        tgts = [gpu.halfphone_targets_from_features(u.features, u.epochs, u.halfphones)
                for u in held]
        feats, segs = [t for t, _ in tgts], [s for _, s in tgts]
    name = cuda_topk.kernel_name(kind != "halfphone", kind != "merged_epoch", precision)
    before = cuda_topk.LAUNCH_COUNTS[name]
    out_g = gpu.synth_batch(feats, voices=voices, segments_list=segs)
    assert cuda_topk.LAUNCH_COUNTS[name] == before + 1
    out_c = cpu.synth_batch(feats, voices=voices, segments_list=segs)
    for i, (g, c) in enumerate(zip(out_g, out_c)):
        np.testing.assert_array_equal(g["unit_ids"], c["unit_ids"])
        np.testing.assert_allclose(g["wave"], c["wave"], atol=1e-5)
        if voices:
            assert (db.voice_ids[g["unit_ids"]] == gpu._voice_code(voices[i])).all()


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["split3cat", "split3", "highest"])
def test_kernel_on_split_probe(cuda_device, precision):
    """On operands where the lo * lo products the split drops exceed the f32
    rounding, the split kernels' scores equal the float64 hh + hl + lh to
    1e-6 relative; the "highest" kernel (full f32 products) misses it."""
    err = split_probe_error(cuda_device, precision)
    if precision == "highest":
        assert err > PROBE_RTOL
    else:
        assert err <= PROBE_RTOL


def _epoch_config(**over):
    return SnickeryConfig(
        stream_list=["mag", "real", "imag", "lf0"],
        datadims={"mag": 60, "real": 45, "imag": 45, "lf0": 1},
        n_candidates=30, taper_length=50, join_cost_weight=0.7,
        length_buckets=[64, 256], **over)


@pytest.mark.cuda
def test_split3cat_synthesiser_on_card_matches_cpu(cuda_device):
    """Config 3 at split3cat: the whole step on the card (the split3cat
    kernel, rescore, Viterbi, OLA) gives the CPU path's unit ids and audio
    (atol 1e-5): the margin absorbs the kernel's rounding."""
    cfg = _epoch_config(preselect_precision="split3cat")
    db = build_voicedb(cfg, _utterances(1, 40, 202))
    held = [u.features for u in _utterances(2, 3, 258)]
    gpu, cpu = Synthesiser(cfg, db, device=cuda_device), Synthesiser(cfg, db, device="cpu")
    name = cuda_topk.kernel_name(False, False, "split3cat")
    before = cuda_topk.LAUNCH_COUNTS[name]
    out_g = gpu.synth_batch(held)
    assert cuda_topk.LAUNCH_COUNTS[name] == before + 1
    for g, c in zip(out_g, cpu.synth_batch(held)):
        np.testing.assert_array_equal(g["unit_ids"], c["unit_ids"])
        np.testing.assert_allclose(g["wave"], c["wave"], atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["highest", "split3cat"])
def test_streaming_on_card_matches_cpu(cuda_device, precision):
    """synth_streaming on the card (pinned asynchronous fetches, the kernel
    once a chunk) gives the CPU stream's unit ids per chunk and its audio
    (atol 1e-5), with the host OLA as well as the device one."""
    db = build_voicedb(_epoch_config(), _utterances(1, 40, 202))
    feats = _utterances(3, 1, 300)[0].features[1:-1]
    chunks = [feats[i:i + 32] for i in range(0, len(feats), 32)]
    for preload in (True, False):
        cfg = _epoch_config(preselect_precision=precision, preload_all_waves=preload)
        runs = []
        for device in (cuda_device, "cpu"):
            synth = Synthesiser(cfg, db, device=device)
            audio = list(synth.synth_streaming(iter(chunks)))
            runs.append((audio, synth.last_stream_unit_ids))
        (audio_g, ids_g), (audio_c, ids_c) = runs
        assert len(ids_g) == len(ids_c) == len(chunks)
        for g, c in zip(ids_g, ids_c):
            np.testing.assert_array_equal(g, c)
        for g, c in zip(audio_g, audio_c):
            np.testing.assert_allclose(g, c, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["none", *sorted(VARIANTS)])
@pytest.mark.parametrize("precision,k", [("highest", 30), ("split3", 40), ("split3cat", 48)])
def test_derived_kernel_matches_plain(cuda_device, variant, precision, k):
    """The twelve derived-operand entry points against their twin on the
    same card tensors (the rule of kernel_check.compare), at kd 151 (T=300 x
    M=8229) and kd 453 (2048 x 65536; the pre-split split3cat operand has
    1,920-byte rows there), with duplicated rows, the last 37 rows padding
    (never selected), a voice of k // 2 rows (starved slots (+inf, 0)), a
    voice of none and a code no row carries."""
    partition, weights = VARIANTS.get(variant, (False, None))
    name = cuda_topk.kernel_name(partition, weights is not None, precision, False)
    assert name.startswith("topk_preselect_dv")
    for T, M, kd in ((300, 8229, KD), (2048, 65536, 3 * KD)):
        rng, raw, aff = _block(T + M + kd + k, M, True, kd)
        n_real = M - 37
        D = lambda a: torch.from_numpy(a).to(cuda_device)
        op, sqn = derive_operand(D(raw), tuple(map(D, aff)), n_real, M, precision)
        if precision == "split3cat":
            assert op.dtype == torch.bfloat16 and (op.shape[1] * 2) % 16 == 0
        kw = {}
        if variant != "none":
            tc = rng.integers(0, 80, T).astype(np.int32)
            tc[:16] = 80
            tv = rng.integers(0, 7, T).astype(np.int32)
            tv[16:48], tv[48:56] = 7, 9
            dc = rng.integers(0, 80, M).astype(np.int32)
            dx = rng.integers(0, 40, (M, 5)).astype(np.int32)
            dv = rng.integers(0, 7, M).astype(np.int32)
            dv[rng.choice(n_real, k // 2, replace=False)] = 7
            dc[n_real:], dx[n_real:], dv[n_real:] = -1, -1, -1
            kw = dict(tgt_meta=pack_meta(D(tc), D(rng.integers(0, 40, (T, 5)).astype(np.int32)),
                                         D(tv)),
                      db_meta=pack_meta(D(dc), D(dx), D(dv)), partition=partition,
                      ling_weights=weights)
        tg = D(rng.standard_normal((T, kd)).astype(np.float32))
        before = cuda_topk.LAUNCH_COUNTS[name]
        _, _, dead = compare(tg, op, None, M, k, precision, sqn=sqn, n_real=n_real, **kw)
        assert cuda_topk.LAUNCH_COUNTS[name] == before + 1
        if partition:
            assert dead == 32 * (k - k // 2) + 8 * k


@pytest.mark.cuda
@pytest.mark.parametrize("precision,kd", [("highest", 737), ("split3", 705),
                                          ("split3cat", 705), ("split3cat", 3000)])
def test_derived_kernel_refuses_a_shape_without_room(cuda_device, precision, kd):
    """A kd whose pass 1 needs more than a block's 227 KB of shared memory
    even at its 64-target tile (partial_smem: at k 8 the resident targets
    and, at a split precision, a ring of two stages) is refused before any
    launch."""
    rng, raw, aff = _block(kd, 256, False, kd)
    D = lambda a: torch.from_numpy(a).to(cuda_device)
    op, sqn = derive_operand(D(raw), tuple(map(D, aff)), 256, 256, precision)
    tg = D(rng.standard_normal((64, kd)).astype(np.float32))
    before = dict(cuda_topk.LAUNCH_COUNTS)
    with pytest.raises(ValueError, match="shared memory"):
        cuda_topk_preselect(tg, op, 8, None, 256, precision=precision, zero_transient=False,
                            sqn=sqn)
    assert dict(cuda_topk.LAUNCH_COUNTS) == before


@pytest.mark.cuda
@pytest.mark.parametrize("precision,kd", [("highest", 736), ("split3", 704), ("split3cat", 704)])
def test_derived_kernel_at_the_widest_kd_with_room(cuda_device, precision, kd):
    """The widest kd that still finds room (the 64-target tile; at a split
    precision a ring of only two stages) runs and agrees with the twin."""
    rng, raw, aff = _block(kd, 1000, True, kd)
    D = lambda a: torch.from_numpy(a).to(cuda_device)
    op, sqn = derive_operand(D(raw), tuple(map(D, aff)), 1000, 1000, precision)
    tg = D(rng.standard_normal((100, kd)).astype(np.float32))
    compare(tg, op, None, 1000, 8, precision, sqn=sqn)


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["highest", "split3", "split3cat"])
def test_derived_synthesiser_on_card_matches_cpu(cuda_device, precision):
    """Config 3 at zero_transient 0: the whole step on the card (the
    operand derived on the card, the derived kernel, rescore, Viterbi, OLA)
    gives the CPU path's unit ids and audio (atol 1e-5), and so does a
    stream at split3cat; of the preselect entry points only the derived one
    launches, once, beside one launch each of the Viterbi and the
    overlap-add kernels."""
    cfg = _epoch_config(preselect_precision=precision, zero_transient=0)
    db = build_voicedb(cfg, _utterances(1, 40, 202))
    held = [u.features for u in _utterances(2, 3, 258)]
    gpu, cpu = Synthesiser(cfg, db, device=cuda_device), Synthesiser(cfg, db, device="cpu")
    name = cuda_topk.kernel_name(False, False, precision, zero_transient=False)
    before = dict(cuda_topk.LAUNCH_COUNTS)
    out_g = gpu.synth_batch(held)
    after = dict(cuda_topk.LAUNCH_COUNTS)
    want = {name: 1, "viterbi_decode": 1, "overlap_add": 1}
    if precision == "split3":            # f32 rows, many target tiles: a clustered launch
        want[f"{name}.cluster{cuda_topk.CLUSTER_CTAS}"] = 1
    assert {n: after[n] - before.get(n, 0) for n in after if after[n] != before.get(n, 0)} == want
    for g, c in zip(out_g, cpu.synth_batch(held)):
        np.testing.assert_array_equal(g["unit_ids"], c["unit_ids"])
        np.testing.assert_allclose(g["wave"], c["wave"], atol=1e-5)
    if precision == "split3cat":
        feats = held[0][1:-1]
        chunks = [feats[i:i + 32] for i in range(0, len(feats), 32)]
        audio_g = list(gpu.synth_streaming(iter(chunks)))
        audio_c = list(cpu.synth_streaming(iter(chunks)))
        for g, c in zip(gpu.last_stream_unit_ids, cpu.last_stream_unit_ids):
            np.testing.assert_array_equal(g, c)
        for g, c in zip(audio_g, audio_c):
            np.testing.assert_allclose(g, c, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("zt", [True, False], ids=["zt", "dv"])
@pytest.mark.parametrize("variant", ["none", *sorted(VARIANTS)])
@pytest.mark.parametrize("precision,k", [("highest", 30), ("split3", 40), ("split3cat", 48)])
@pytest.mark.parametrize("select", ["phase", "packed", "packed3", "packed3diag"])
def test_select_kernel_matches_plain(cuda_device, select, precision, k, variant, zt):
    """Every selection variant entry point against its twin on the same
    card tensors (the rule of kernel_check.compare at the selection: 127 ulp
    more on a packed score, flags equal at "highest"), T=300 x M=8229 x kd
    151 with duplicated rows, a run of 10 near-duplicates inside one
    128-row block under 16 targets, the last 37 rows padding, a voice of
    k // 2 rows, a voice of none and a code no row carries.  At "highest"
    kernel and twin are equal exactly; "phase" equals the stream kernel bit
    for bit; "packed3" returns the stream kernel's result where a flag is
    raised (and launches it) and the packed one where none is."""
    T, M = 300, 8229
    partition, weights = VARIANTS.get(variant, (False, None))
    rng = np.random.default_rng(17 + k)
    n_real = M - 37
    feats = rng.standard_normal((n_real, KD)).astype(np.float32)
    feats[100:140] = feats[50]
    aff = ((0.1 * rng.standard_normal(KD)).astype(np.float32),
           rng.uniform(0.5, 2.0, KD).astype(np.float32),
           rng.uniform(0.2, 1.0, KD).astype(np.float32))
    tg = rng.standard_normal((T, KD)).astype(np.float32)
    pileup_block(feats, tg, aff, start=512, run=10, n_targets=16, seed=3)
    jr = np.zeros_like(feats)
    jr[:-1] = feats[1:]
    raw, _, _ = build_raw_blocks(feats, jr, M, affine=aff)
    D = lambda a: torch.from_numpy(a).to(cuda_device)
    tg, R, A = D(tg), D(raw), tuple(map(D, aff))
    kw = {}
    if variant != "none":
        tc = rng.integers(0, 80, T).astype(np.int32)
        tc[:16] = 80
        tv = rng.integers(0, 7, T).astype(np.int32)
        tv[16:48], tv[48:56] = 7, 9
        dc = rng.integers(0, 80, M).astype(np.int32)
        dx = rng.integers(0, 40, (M, 5)).astype(np.int32)
        dv = rng.integers(0, 7, M).astype(np.int32)
        dv[rng.choice(n_real, k // 2, replace=False)] = 7
        dc[n_real:], dx[n_real:], dv[n_real:] = -1, -1, -1
        kw = dict(tgt_meta=pack_meta(D(tc), D(rng.integers(0, 40, (T, 5)).astype(np.int32)),
                                     D(tv)),
                  db_meta=pack_meta(D(dc), D(dx), D(dv)), partition=partition,
                  ling_weights=weights)
    if zt:
        block, sqn, form = R, None, dict(db_affine=A)
    else:
        block, sqn = derive_operand(R, A, n_real, M, precision)
        form = dict(db_affine=None, zero_transient=False, sqn=sqn)
    name = cuda_topk.kernel_name(partition, weights is not None, precision, zt, select)
    assert name.endswith("_" + select.removesuffix("diag"))
    before = cuda_topk.LAUNCH_COUNTS[name]
    err, nbad, dead = compare(tg, block, A if zt else None, M, k, precision, sqn=sqn,
                              n_real=None if partition else n_real, select=select, **kw)
    assert cuda_topk.LAUNCH_COUNTS[name] == before + 1
    if precision == "highest":
        assert err == 0.0 and nbad == 0
    if partition:
        assert dead == 32 * (k - k // 2) + 8 * k

    def kernel(sel):
        return cuda_topk_preselect(tg, block, k=k, m_rows=M, precision=precision, select=sel,
                                   **form, **kw)

    stream = kernel("stream")
    if select == "phase":
        for x, y in zip(kernel("phase"), stream):
            assert torch.equal(x, y)
        return
    packed = kernel("packed")
    ids, vals, flags = kernel("packed3diag")
    assert flags.dtype == torch.int32 and flags.shape == (T,)
    if variant == "none":
        assert bool(flags[:16].all()), "the pile-up targets must raise the flag"
    if select == "packed3diag":
        clear = flags == 0
        assert torch.equal(ids[clear], packed[0][clear])
        assert torch.equal(vals[clear], packed[1][clear])
    elif select == "packed3":
        stream_name = cuda_topk.kernel_name(partition, weights is not None, precision, zt)
        before = cuda_topk.LAUNCH_COUNTS[stream_name]
        got = kernel("packed3")
        fell_back = bool(flags.any())
        assert cuda_topk.LAUNCH_COUNTS[stream_name] == before + fell_back
        for x, y in zip(got, stream if fell_back else packed):
            assert torch.equal(x, y)


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["split3cat", "split3"])
def test_phase_kernel_on_split_probe(cuda_device, precision):
    """The phase epilogue returns the scores the split product formed: on
    the probe they equal the float64 hh + hl + lh to 1e-6 relative."""
    assert split_probe_error(cuda_device, precision, select="phase") <= PROBE_RTOL


@pytest.mark.cuda
def test_packed3_without_pileup_takes_no_fallback(cuda_device):
    """Independent rows, k 8 over 512 blocks: no block holds three of a
    target's best, no flag is raised, "packed3" launches only its own entry
    point and returns the "packed" result."""
    rng, raw, aff = _block(91, 65536, False)
    D = lambda a: torch.from_numpy(a).to(cuda_device)
    tg, R, A = D(rng.standard_normal((128, KD)).astype(np.float32)), D(raw), tuple(map(D, aff))
    before = dict(cuda_topk.LAUNCH_COUNTS)
    got = cuda_topk_preselect(tg, R, 8, A, 65536, select="packed3")
    after = dict(cuda_topk.LAUNCH_COUNTS)
    assert {n: after[n] - before.get(n, 0) for n in after if after[n] != before.get(n, 0)} == {
        "topk_preselect_zt_packed3": 1}
    for x, y in zip(got, cuda_topk_preselect(tg, R, 8, A, 65536, select="packed")):
        assert torch.equal(x, y)


@pytest.mark.cuda
@pytest.mark.parametrize("zt", [True, False], ids=["zt", "dv"])
@pytest.mark.parametrize("precision", ["highest", "split3cat"])
@pytest.mark.parametrize("case", ["span_unaligned", "span_gaps", "span_padding_only"])
def test_partition_kernel_over_voice_spans(cuda_device, case, precision, zt):
    """The partition kernels scanning only each target tile's voice spans
    (kernel_ab.SPAN_CASES: voices of 1,000 / 5,003 / 37 rows, ids with gaps
    and a voice in two runs, a shard of padding only; tiles of two voices,
    dead targets that rank the padding rows) against the twin that scans
    every row: equal at "highest", within the split rule at "split3cat"."""
    from snickery_tpu_torch import kernel_ab
    x, block, aff, m_rows, k, prec, kw = kernel_ab.span_case(case, cuda_device, precision, zt)
    kw.pop("zero_transient", None)
    err, nbad, dead = compare(x, block, aff, m_rows, k, prec, **kw)
    if prec == "highest":
        assert err == 0.0 and nbad == 0


def _cluster_delta(before):
    """The launch counts that moved since ``before``."""
    after = dict(cuda_topk.LAUNCH_COUNTS)
    return {n: after[n] - before.get(n, 0) for n in after if after[n] != before.get(n, 0)}


@pytest.mark.cuda
@pytest.mark.parametrize("precision,k,variant,zt,T", [
    ("split3cat", 48, "none", True, 256), ("split3cat", 48, "none", True, 384),
    ("split3cat", 48, "none", True, 300), ("split3", 40, "none", True, 256),
    ("split3", 40, "none", True, 300), ("split3cat", 48, "ling", True, 256),
    ("split3", 40, "none", False, 256)])
def test_clustered_kernel_equals_its_tiles_alone(cuda_device, precision, k, variant, zt, T):
    """Target tiles run as thread-block clusters (each DB stage split once
    and shared between the CTAs of a cluster; 300 targets make an odd tile
    count at split3cat, padded with a dead tile) give the ids and scores,
    bit for bit, of the same targets run one tile at a time (one CTA a
    cluster): a score is the same wgmma chain over the same bf16 values and
    the selection is exact."""
    M = 8229
    rng, raw, aff = _block(T + k + len(variant), M, True)
    D = lambda a: torch.from_numpy(a).to(cuda_device)
    tg = D(rng.standard_normal((T, KD)).astype(np.float32))
    kw = {}
    if variant == "ling":
        kw = dict(tgt_meta=pack_meta(D(rng.integers(0, 80, T).astype(np.int32)),
                                     D(rng.integers(0, 40, (T, 5)).astype(np.int32)),
                                     D(np.zeros(T, np.int32))),
                  db_meta=pack_meta(D(rng.integers(0, 80, M).astype(np.int32)),
                                    D(rng.integers(0, 40, (M, 5)).astype(np.int32)),
                                    D(np.zeros(M, np.int32))),
                  ling_weights=VARIANTS["ling"][1])
    R, A = D(raw), tuple(map(D, aff))
    if not zt:
        R, sqn = derive_operand(R, A, M, M, precision)
        kw.update(zero_transient=False, sqn=sqn)
        A = None
    name = cuda_topk.kernel_name(False, variant == "ling", precision, zt)
    run = lambda a, b: cuda_topk_preselect(
        tg[a:b].contiguous(), R, k, A, M, precision=precision,
        **{key: (v[a:b].contiguous() if key == "tgt_meta" else v) for key, v in kw.items()})
    before = dict(cuda_topk.LAUNCH_COUNTS)
    ids, scores = run(0, T)
    assert _cluster_delta(before) == {name: 1, f"{name}.cluster2": 1}
    tt = cuda_topk._kernel().snk_topk_tile_rows(
        KD, k, int(variant != "none"), cuda_topk.PRECISIONS.index(precision), 0, T)
    step = -(-T // -(-T // tt))          # chunks of one tile each, tiles of tt rows
    before = dict(cuda_topk.LAUNCH_COUNTS)
    alone = [run(a, min(a + step, T)) for a in range(0, T, step)]
    assert _cluster_delta(before) == {name: len(alone)}
    assert torch.equal(ids, torch.cat([i for i, _ in alone]))
    assert torch.equal(scores.view(torch.int32), torch.cat([v for _, v in alone]).view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["chunk", "part"])
def test_cluster_launch_only_where_tiles_share_rows(cuda_device, case):
    """A 64-target stream chunk (one tile) launches without clusters and
    gives, bit for bit, the rows of the same targets in a clustered call of
    two tiles ("split3": 64-target tiles either way); a partition call (each
    tile scans its own voices' rows) launches without clusters and matches
    the twin under the rule of kernel_check.compare."""
    M = 8229
    rng, raw, aff = _block(M + len(case), M, True)
    D = lambda a: torch.from_numpy(a).to(cuda_device)
    R, A = D(raw), tuple(map(D, aff))
    if case == "chunk":
        name = cuda_topk.kernel_name(False, False, "split3")
        tg = D(rng.standard_normal((128, KD)).astype(np.float32))
        before = dict(cuda_topk.LAUNCH_COUNTS)
        ids, scores = cuda_topk_preselect(tg[:64].contiguous(), R, 40, A, M, precision="split3")
        assert _cluster_delta(before) == {name: 1}
        both = cuda_topk_preselect(tg, R, 40, A, M, precision="split3")
        assert _cluster_delta(before) == {name: 2, f"{name}.cluster2": 1}
        assert torch.equal(ids, both[0][:64])
        assert torch.equal(scores.view(torch.int32), both[1][:64].view(torch.int32))
        return
    T = 300
    zeros = lambda *n: D(np.zeros(n, np.int32))
    kw = dict(tgt_meta=pack_meta(zeros(T), zeros(T, 5), D(rng.integers(0, 7, T).astype(np.int32))),
              db_meta=pack_meta(zeros(M), zeros(M, 5), D(rng.integers(0, 7, M).astype(np.int32))),
              partition=True)
    tg = D(rng.standard_normal((T, KD)).astype(np.float32))
    before = dict(cuda_topk.LAUNCH_COUNTS)
    compare(tg, R, A, M, 48, "split3cat", **kw)
    assert _cluster_delta(before) == {cuda_topk.kernel_name(True, False, "split3cat"): 1}

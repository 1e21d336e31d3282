"""The port on a CUDA card: the preselect kernel (its masked variants, its
split-precision variants and the two composed) against its plain twin, and
the synthesiser on the card against the same synthesiser on the CPU, for
epoch, halfphone and merged voices, at the split precisions, and streaming.

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
from snickery_tpu_torch.kernel_check import PROBE_RTOL, compare, split_probe_error
from snickery_tpu_torch.ops import cuda_topk
from snickery_tpu_torch.ops.cuda_topk import (cuda_topk_preselect, pack_meta,
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

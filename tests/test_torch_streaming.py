"""Streaming synthesis (BASELINE config #4) in ``snickery_tpu_torch`` on the
CPU, against the JAX package: the port's copy of the fixed-rate resampler,
and ``Synthesiser.synth_streaming`` at precisions "highest" (JAX through
XLA) and "split3cat" (JAX through the Pallas kernel in interpret mode),
epoch-rate and fixed-rate, on the tests/toyvoice.py voices.  Ports of
tests/test_features.py:173 and tests/test_e2e.py:213, :229 and :323.
"""

import dataclasses

import numpy as np
import pytest

from snickery_tpu.features import world as jax_world
from snickery_tpu.synth import Synthesiser as JaxSynthesiser
from snickery_tpu.voicedb.multivoice import merge_voicedbs
from snickery_tpu_torch.features import world
from snickery_tpu_torch.synth import Synthesiser
from tests.toyvoice import build_toy_voice, prepare_toy_utts, toy_config

FS = 0.005                      # fixed-rate frame shift, seconds
JAX_MODES = {"highest": False, "split3cat": "interpret"}


@pytest.fixture(scope="module")
def voice():
    cfg, db, utts = build_toy_voice(halfphone=False, multiepoch=1)
    held = prepare_toy_utts(1, seed0=905)[0]
    return cfg, db, utts, held


def _lf0_col(cfg):
    return [a for (n, a, _) in cfg.stream_slices if n == "lf0"][0]


def _fixed_frames(seed, N=300, d=9, lf0_col=4):
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((N, d)).astype(np.float32)
    feats[:, lf0_col] = np.log(110 + 50 * np.sin(np.arange(N) / 25.0))
    return rng, feats


@pytest.mark.parametrize("chunking", [1, 5, 37, 300, "random"])
def test_streaming_resampler_bit_equal_to_jax(chunking):
    """Port of tests/test_features.py:173: the port's StreamingEpochResampler
    gives the JAX package's rows and epochs bit for bit over the same
    chunking, and both reproduce the one-shot conversion's epoch grid."""
    rng, feats = _fixed_frames(7)
    N, lf0_col = len(feats), 4
    if chunking == "random":
        cuts = np.sort(rng.choice(np.arange(1, N), 40, replace=False))
        chunks = np.split(feats, cuts)
    else:
        chunks = [feats[i:i + chunking] for i in range(0, N, chunking)]
    ours = world.StreamingEpochResampler(lf0_col, 16000, FS)
    ref = jax_world.StreamingEpochResampler(lf0_col, 16000, FS)
    for c in chunks:
        np.testing.assert_array_equal(ours.push(c), ref.push(c))
    np.testing.assert_array_equal(ours.flush(), ref.flush())
    assert ours.epochs == ref.epochs
    _, ref_epochs = world.fixed_to_epoch_targets(feats, lf0_col, 16000, FS)
    np.testing.assert_array_equal(np.asarray(ours.epochs, np.int64), ref_epochs)


def test_resampling_functions_bit_equal_to_jax(voice):
    """The one-shot conversions: resample_to_fixed / _to_epochs,
    epoch_grid_from_lf0 and fixed_to_epoch_targets equal the JAX package's."""
    cfg, db, utts, held = voice
    fixed = world.resample_to_fixed(held.features, held.epochs, cfg.sample_rate, FS)
    np.testing.assert_array_equal(
        fixed, jax_world.resample_to_fixed(held.features, held.epochs, cfg.sample_rate, FS))
    col = _lf0_col(cfg)
    np.testing.assert_array_equal(
        world.epoch_grid_from_lf0(fixed[:, col], cfg.sample_rate, FS),
        jax_world.epoch_grid_from_lf0(fixed[:, col], cfg.sample_rate, FS))
    for a, b in zip(world.fixed_to_epoch_targets(fixed, col, cfg.sample_rate, FS),
                    jax_world.fixed_to_epoch_targets(fixed, col, cfg.sample_rate, FS)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(
        world.resample_to_epochs(fixed, held.epochs, cfg.sample_rate, FS),
        jax_world.resample_to_epochs(fixed, held.epochs, cfg.sample_rate, FS))


def _stream(synth, chunks, **kw):
    audio = list(synth.synth_streaming(iter(chunks), **kw))
    return audio, [ids.copy() for ids in synth.last_stream_unit_ids]


def _assert_same_stream(a, b):
    """Identical unit ids per chunk; yielded chunks of equal length within
    1e-5."""
    (audio_a, ids_a), (audio_b, ids_b) = a, b
    assert len(ids_a) == len(ids_b)
    for x, y in zip(ids_a, ids_b):
        np.testing.assert_array_equal(y, x)
    assert [len(x) for x in audio_a] == [len(y) for y in audio_b]
    for x, y in zip(audio_a, audio_b):
        np.testing.assert_allclose(y, x, atol=1e-5)


@pytest.mark.parametrize("precision", sorted(JAX_MODES))
@pytest.mark.parametrize("rate", ["epoch", "fixed"])
def test_streaming_matches_jax(voice, precision, rate):
    """The port's synth_streaming vs the JAX package's, chunk by chunk: at
    "highest" against its XLA path, at "split3cat" against its Pallas kernel
    (interpret mode); epoch-rate chunks of 24 units, or fixed-rate 5 ms
    frames in chunks of 40."""
    cfg, db, utts, held = voice
    if rate == "epoch":
        feats = held.features[1:-1]
        chunks, kw = [feats[i:i + 24] for i in range(0, len(feats), 24)], {}
    else:
        fixed = world.resample_to_fixed(held.features, held.epochs, cfg.sample_rate, FS)
        chunks, kw = [fixed[i:i + 40] for i in range(0, len(fixed), 40)], {"fixed_frameshift": FS}
    js = JaxSynthesiser(toy_config(preselect_precision=precision,
                                   use_pallas=JAX_MODES[precision]), db=db)
    ts = Synthesiser(toy_config(preselect_precision=precision), db, device="cpu")
    ref, got = _stream(js, chunks, **kw), _stream(ts, chunks, **kw)
    _assert_same_stream(ref, got)
    assert set(ts.last_stream_stages) == {"pull_ms", "prep_ms", "dispatch_ms", "fetch_ms"}
    assert len(ts.last_stream_stages["dispatch_ms"]) == len(got[1])


def test_streaming_matches_greedy(voice):
    """Port of tests/test_e2e.py:213, tightened: three chunks of an
    utterance's centre epochs give exactly the one-shot greedy unit ids and
    its audio, sample for sample to f32 rounding (the crossfade tails summed
    across chunks are the whole-utterance OLA)."""
    cfg, db, utts, _ = voice
    ts = Synthesiser(cfg, db, device="cpu")
    utt = utts[1]
    feats = utt.features[1:-1]
    n = len(feats)
    audio, ids = _stream(ts, [feats[: n // 3], feats[n // 3: 2 * n // 3], feats[2 * n // 3:]])
    ref = ts.synth_from_features(utt.features, greedy=True)
    np.testing.assert_array_equal(np.concatenate(ids), ref["unit_ids"])
    wave = np.concatenate(audio)
    assert len(wave) == len(ref["wave"])
    np.testing.assert_allclose(wave, ref["wave"], atol=1e-6)


def test_streaming_flushes_leftover_multiepoch():
    """Port of tests/test_e2e.py:229: with 4 epochs a unit, a tail that is not
    a whole unit is padded by repeating the last frame at the end of the
    stream, so every epoch is decoded; the JAX package does the same."""
    cfg, db, utts = build_toy_voice(halfphone=False, multiepoch=4, n_utts=2)
    feats = utts[0].features[1:-1]
    if len(feats) % 4 == 0:
        feats = feats[:-2]
    chunks = [feats[: len(feats) // 2 + 1], feats[len(feats) // 2 + 1:]]
    ts = Synthesiser(cfg, db, device="cpu")
    got = _stream(ts, chunks)
    assert sum(len(x) for x in got[1]) == -(-len(feats) // 4)
    _assert_same_stream(_stream(JaxSynthesiser(cfg, db=db), chunks), got)


def test_streaming_fixed_rate_matches_batch_conversion(voice):
    """Port of tests/test_e2e.py:323: fixed-rate frames streamed through the
    incremental epoch grid decode exactly like the one-shot conversion fed
    through the epoch-rate stream."""
    cfg, db, utts, held = voice
    ts = Synthesiser(cfg, db, device="cpu")
    fixed = world.resample_to_fixed(held.features, held.epochs, cfg.sample_rate, FS)
    audio_a, ids_a = _stream(ts, [fixed[i:i + 40] for i in range(0, len(fixed), 40)],
                             fixed_frameshift=FS)
    ep, _ = world.fixed_to_epoch_targets(fixed, _lf0_col(cfg), cfg.sample_rate, FS)
    audio_b, ids_b = _stream(ts, [ep[i:i + 32] for i in range(0, len(ep), 32)])
    np.testing.assert_array_equal(np.concatenate(ids_a), np.concatenate(ids_b))
    wave_a, wave_b = np.concatenate(audio_a), np.concatenate(audio_b)
    assert len(wave_a) == len(wave_b)
    np.testing.assert_allclose(wave_a, wave_b, atol=1e-4)


def test_streaming_merged_db_matches_jax(voice):
    """A DB merged from two voices streams with ``voice=`` through the
    partition variant and matches the JAX package; without a voice it is a
    ValueError, as in JAX."""
    cfg, db, utts, held = voice
    _, db2, _ = build_toy_voice(halfphone=False, multiepoch=1, n_utts=2)
    merged = merge_voicedbs([db, db2], names=["a", "b"])
    c = dataclasses.replace(cfg, n_candidates=8)
    feats = held.features[1:-1]
    chunks = [feats[i:i + 40] for i in range(0, len(feats), 40)]
    ts = Synthesiser(c, merged, device="cpu")
    for v in ("a", "b"):
        got = _stream(ts, chunks, voice=v)
        assert (merged.voice_ids[np.concatenate(got[1])] == ts._voice_code(v)).all()
        _assert_same_stream(_stream(JaxSynthesiser(c, db=merged), chunks, voice=v), got)
    with pytest.raises(ValueError, match="multi-voice"):
        next(ts.synth_streaming(iter(chunks)))


def test_streaming_host_ola_matches_device_ola(voice):
    """``preload_all_waves=False``: each chunk is concatenated on the host;
    the stream equals the device-OLA stream."""
    cfg, db, utts, held = voice
    feats = held.features[1:-1]
    chunks = [feats[i:i + 24] for i in range(0, len(feats), 24)]
    dev = _stream(Synthesiser(cfg, db, device="cpu"), chunks)
    host = _stream(Synthesiser(dataclasses.replace(cfg, preload_all_waves=False), db,
                               device="cpu"), chunks)
    _assert_same_stream(dev, host)


def test_streaming_halfphone_voice_raises():
    """Streaming is epoch-mode only, as in the JAX package."""
    cfg, db, _ = build_toy_voice(halfphone=True, n_utts=2)
    with pytest.raises(NotImplementedError, match="epoch-mode only"):
        next(Synthesiser(cfg, db, device="cpu").synth_streaming(iter([])))

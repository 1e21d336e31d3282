"""The port's analysis chain on the CPU against the JAX package's, on the
same numpy-seeded inputs: the DFT, STFT, mel, magphase, WORLD-style and
join-smoothing modules, the epoch detector (Python and native) and the EST
pitchmark files.

The analysis streams are held to the JAX package by the two rules of
tests/analysis64.py against a float64 numpy analysis of the same frames:
(a) within 1e-3 of the JAX package on the bands within 6 nats of their
frame's strongest band (beyond what the JAX package itself misses the
float64 analysis by there: its matmul DFT is not the truth), and (b) no
farther than the JAX package from the float64 analysis, in max and in p99.
The port's analysis runs in float64 to its f32 outputs, so it is also held
within ``PORT_F64_ATOL`` of the float64 analysis everywhere, the last frame
of an epoch count that is no multiple of 128 included (the JAX package's
epoch bucketing sets that frame's next gap).
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest

from snickery_tpu.features import dft as jdft
from snickery_tpu.features import epochs as jepochs
from snickery_tpu.features import magphase as jmag
from snickery_tpu.features import mel as jmel
from snickery_tpu.features import smoothing as jsmooth
from snickery_tpu.features import world as jworld
from snickery_tpu.io import est as jest
from snickery_tpu.native import native_detect_epochs as jax_native_epochs
from snickery_tpu_torch import native as tnative
from snickery_tpu_torch.features import dft as tdft
from snickery_tpu_torch.features import epochs as tepochs
from snickery_tpu_torch.features import magphase as tmag
from snickery_tpu_torch.features import mel as tmel
from snickery_tpu_torch.features import smoothing as tsmooth
from snickery_tpu_torch.features import world as tworld
from snickery_tpu_torch.io import est as port_est
from tests import analysis64 as a64
from tests.jaxnative import build_private_lib, jax_native, native_reference  # noqa: F401
from tests.toyvoice import SR, synth_utterance

# (the packages' ``features.stft`` attribute is the function, not the module)
jstft = importlib.import_module("snickery_tpu.features.stft")
tstft = importlib.import_module("snickery_tpu_torch.features.stft")
PORT_F64_ATOL = 1e-4


@pytest.fixture(scope="module")
def utt3():
    """The 142-epoch toy utterance (seed 3) and its epochs."""
    wave, _ = synth_utterance(3)
    return wave, jepochs.detect_epochs(wave, SR, use_native=False)


def _np(t):
    return t.cpu().numpy() if hasattr(t, "cpu") else np.asarray(t)


# ------------------------------------------------------------------- dft
@pytest.mark.parametrize("n_fft", [128, 1024, 2048])
def test_rdft_matches_numpy_and_jax(n_fft):
    import torch
    x = np.random.default_rng(7).standard_normal((16, n_fft)).astype(np.float32)
    re, im = tdft.rdft(torch.from_numpy(x))
    ref = np.fft.rfft(x, axis=-1)
    scale = np.abs(ref).max()
    jre, jim = jdft.rdft(jnp.asarray(x))
    for got, want, jax_ in ((re, ref.real, jre), (im, ref.imag, jim)):
        np.testing.assert_allclose(_np(got), want, atol=2e-4 * scale)
        np.testing.assert_allclose(_np(got), np.asarray(jax_), atol=2e-4 * scale)


@pytest.mark.parametrize("n_fft", [128, 1024])
def test_irdft_roundtrip_and_numpy(n_fft):
    import torch
    rng = np.random.default_rng(11)
    x = rng.standard_normal((8, n_fft)).astype(np.float32)
    back = _np(tdft.irdft(*tdft.rdft(torch.from_numpy(x)), n_fft))
    np.testing.assert_allclose(back, x, atol=5e-5 * np.abs(x).max() * n_fft ** 0.5)
    spec = (rng.standard_normal((8, n_fft // 2 + 1))
            + 1j * rng.standard_normal((8, n_fft // 2 + 1))).astype(np.complex64)
    ref = np.fft.irfft(spec, n=n_fft, axis=-1)
    out = _np(tdft.irdft(torch.from_numpy(spec.real), torch.from_numpy(spec.imag), n_fft))
    np.testing.assert_allclose(out, ref, atol=2e-4 * np.abs(ref).max() + 1e-6)
    jout = np.asarray(jdft.irdft(jnp.asarray(spec.real), jnp.asarray(spec.imag), n_fft))
    np.testing.assert_allclose(out, jout, atol=2e-4 * np.abs(ref).max() + 1e-6)


def test_rdft_pad_and_truncate_match_rfft_n_arg():
    import torch
    x = np.random.default_rng(5).standard_normal((4, 300)).astype(np.float32)
    for n in (512, 256):
        re, im = tdft.rdft(torch.from_numpy(x), n)
        ref = np.fft.rfft(x, n=n, axis=-1)
        scale = max(np.abs(ref).max(), 1.0)
        assert re.shape == (4, n // 2 + 1)
        np.testing.assert_allclose(_np(re), ref.real, atol=2e-4 * scale)
        np.testing.assert_allclose(_np(im), ref.imag, atol=2e-4 * scale)


# ------------------------------------------------------------------- stft
@pytest.mark.parametrize("frame_len,hop,n_fft", [(512, 128, None), (400, 160, 512),
                                                 (256, 128, None)])
def test_stft_istft_match_jax(utt3, frame_len, hop, n_fft):
    wave = utt3[0][:9000]
    got = _np(tstft.stft(wave, frame_len, hop, n_fft, device="cpu"))
    want = np.asarray(jstft.stft(jnp.asarray(wave), frame_len, hop, n_fft))
    assert got.shape == want.shape and got.dtype == np.complex64
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, atol=2e-4 * scale)
    mag = _np(tstft.stft_mag(wave, frame_len, hop, n_fft, device="cpu"))
    np.testing.assert_allclose(mag, np.abs(got), atol=1e-5 * scale)
    np.testing.assert_allclose(mag, np.asarray(jstft.stft_mag(jnp.asarray(wave), frame_len,
                                                              hop, n_fft)), atol=2e-4 * scale)
    if n_fft is None:
        back = _np(tstft.istft(got, frame_len, hop, len(wave), device="cpu"))
        assert back.shape == (len(wave),)
        assert np.abs(back[frame_len:-frame_len] - wave[frame_len:-frame_len]).max() < 1e-3
        _check_istft(got, frame_len, hop, len(wave))


def _istft64(spec, frame_len, hop, n_samples):
    """istft in float64 (the same COLA normalisation) -> (out, COLA sum)."""
    win = 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(frame_len) / frame_len)
    frames = np.fft.irfft(spec.astype(np.complex128), n=frame_len, axis=-1) * win
    out_len = (len(frames) - 1) * hop + max(frame_len, n_samples)
    out, norm = np.zeros(out_len), np.zeros(out_len)
    for i, f in enumerate(frames):
        out[i * hop: i * hop + frame_len] += f
        norm[i * hop: i * hop + frame_len] += win * win
    return (out / np.maximum(norm, 1e-8))[:n_samples], norm[:n_samples]


def _check_istft(spec, frame_len, hop, n_samples):
    """The port's istft against the float64 one: the overlap-added frames
    (the output times the COLA sum) within 1e-5 everywhere, and where the
    COLA sum is at least 1% of its peak (the division by a small sum at the
    edges amplifies any f32 rounding) within 1e-5 and no farther from it
    than the JAX package's istft."""
    got = _np(tstft.istft(spec, frame_len, hop, n_samples, device="cpu"))
    want = np.asarray(jstft.istft(jnp.asarray(spec), frame_len, hop, n_samples))
    truth, norm = _istft64(spec, frame_len, hop, n_samples)
    assert got.shape == want.shape == (n_samples,)
    np.testing.assert_allclose(got * norm, truth * norm, atol=1e-5)
    body = norm >= 0.01 * norm.max()
    np.testing.assert_allclose(got[body], truth[body], atol=1e-5)
    a64.rule_b(got[body], want[body], truth[body])


def test_frame_signal_and_windows_match_jax():
    import torch
    x = np.arange(1000, dtype=np.float32)
    for fl, hop in ((256, 100), (1024, 512), (64, 64)):
        np.testing.assert_array_equal(_np(tstft.frame_signal(torch.from_numpy(x), fl, hop)),
                                      np.asarray(jstft.frame_signal(jnp.asarray(x), fl, hop)))
    for n in (1, 7, 400):
        np.testing.assert_allclose(_np(tstft.hann(n, device="cpu")), np.asarray(jstft.hann(n)),
                                   atol=1e-7)
        np.testing.assert_allclose(_np(tstft.hann_symmetric(n, device="cpu")),
                                   np.asarray(jstft.hann_symmetric(n)), atol=1e-7)


def test_istft_pads_short_output():
    spec = _np(tstft.stft(np.ones(600, np.float32), 256, 128, device="cpu"))
    out = _np(tstft.istft(spec, 256, 128, 2000, device="cpu"))
    assert out.shape == (2000,) and not out[768:].any()
    _check_istft(spec, 256, 128, 2000)


# -------------------------------------------------------------------- mel
@pytest.mark.parametrize("args", [(80, 512, 16000), (25, 1024, 16000), (32, 1024, 48000),
                                  (40, 2048, 22050, 50.0, 8000.0)])
def test_mel_matrices_bit_equal(args):
    a, b = tmel.mel_filterbank(*args), jmel.mel_filterbank(*args)
    assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    n_bins, n = args[1] // 2 + 1, args[0]
    for f in ("_warp_matrix", "_unwarp_matrix"):
        assert getattr(tmag, f)(n_bins, n, args[2]).tobytes() == getattr(jmag, f)(
            n_bins, n, args[2]).tobytes()
    assert tworld._band_matrix(n_bins, 5).tobytes() == jworld._band_matrix(n_bins, 5).tobytes()
    for n_ceps in (13, n):
        assert tmel.dct_matrix(n, n_ceps).tobytes() == jmel.dct_matrix(n, n_ceps).tobytes()
    np.testing.assert_array_equal(tmel._hz_to_mel([0, 700, 8000]), jmel._hz_to_mel([0, 700, 8000]))
    np.testing.assert_array_equal(tmel._mel_to_hz([0, 1000, 2840]), jmel._mel_to_hz([0, 1000, 2840]))


@pytest.mark.parametrize("floor_db", [None, 60.0])
@pytest.mark.parametrize("kw", [{}, dict(n_mels=25, frame_len=1024, hop=256, n_fft=1024)])
def test_log_mel_and_mfcc_rules(utt3, floor_db, kw):
    """log-mel by rules (a) and (b); the MFCC (its DCT) by rule (b); both,
    computed in float64, within ``PORT_F64_ATOL`` of the float64 analysis."""
    wave = utt3[0]
    got = _np(tmel.log_mel_spectrogram(wave, SR, floor_db=floor_db, device="cpu", **kw))
    want = np.asarray(jmel.log_mel_spectrogram(jnp.asarray(wave), SR, floor_db=floor_db, **kw))
    truth = a64.log_mel64(wave, SR, floor_db=floor_db, **kw)
    assert got.shape == want.shape
    a64.rule_a(got, want, a64.strong(truth), truth)
    a64.rule_b(got, want, truth)
    np.testing.assert_allclose(got, truth, atol=PORT_F64_ATOL)
    n_mels = kw.get("n_mels", 40)
    mkw = dict(kw, n_mels=n_mels)
    gm = _np(tmel.mfcc(wave, SR, floor_db=floor_db, device="cpu", **mkw))
    wm = np.asarray(jmel.mfcc(jnp.asarray(wave), SR, floor_db=floor_db, **mkw))
    tm = a64.log_mel64(wave, SR, floor_db=floor_db, **mkw) @ a64.dct(n_mels, 13)
    assert gm.shape == wm.shape == tm.shape
    a64.rule_b(gm, wm, tm)
    np.testing.assert_allclose(gm, tm, atol=PORT_F64_ATOL)


# --------------------------------------------------------------- magphase
def _epochs_case(case, utt3):
    wave, e = utt3
    if case == "mod128":                       # E = 128: no bucket padding
        return wave, e[:128], SR
    if case == "not_mod128":                   # E = 142: the last frame's gap is set
        return wave, e, SR
    if case == "two_buckets":                  # E = 256 over a longer wave
        w, _ = synth_utterance(4, n_segments=16)
        return w, jepochs.detect_epochs(w, SR, use_native=False)[:256], SR
    # 48 kHz: 2,048-point frames
    sr = 48000
    t = np.arange(int(0.9 * sr)) / sr
    phase = 2 * np.pi * np.cumsum(120.0 + 25.0 * np.sin(2 * np.pi * 0.7 * t)) / sr
    w = sum(a * np.sin((h + 1) * phase) for h, a in enumerate([0.5, 0.3, 0.2, 0.1]))
    w = w.astype(np.float32)
    return w, jepochs.detect_epochs(w, sr, use_native=False), sr


@pytest.mark.parametrize("case", ["mod128", "not_mod128", "two_buckets", "48k"])
def test_magphase_analysis_rules(utt3, case):
    wave, e, sr = _epochs_case(case, utt3)
    got = tmag.magphase_analysis(wave, e, sr, device="cpu")
    want = jmag.magphase_analysis(wave, e, sr)
    truth = a64.magphase64(wave, e, sr)
    for k in ("mag", "real", "imag"):
        assert got[k].shape == want[k].shape == (len(e), 60 if k == "mag" else 45)
        assert got[k].dtype == np.float32
        mask = a64.strong(truth["mag"] if k == "mag" else truth["strength_ph"])
        a64.rule_a(got[k], want[k], mask, truth[k])
        a64.rule_b(got[k], want[k], truth[k])
        np.testing.assert_allclose(got[k], truth[k], atol=PORT_F64_ATOL, err_msg=k)
        # the last frame, whose next gap the bucketing sets
        a64.rule_a(got[k][-1:], want[k][-1:], mask[-1:], truth[k][-1:])
    np.testing.assert_array_equal(got["lf0"], want["lf0"])


def test_epoch_bucketing_sets_the_last_frame(utt3):
    """Without the bucket padding the last frame of E = 142 would differ
    (its next gap is e[-1] - e[-2], not 1): the port pads as the JAX package
    does, so its last frame is the padded one."""
    import torch
    wave, e = utt3
    got = tmag.magphase_analysis(wave, e, SR, device="cpu")
    fm = tmag.frame_max_for(SR, 50.0)
    unpadded = tmag.magphase_analysis_frames(torch.from_numpy(wave), torch.from_numpy(e), fm, fm,
                                             60, 45, SR)
    np.testing.assert_array_equal(_np(unpadded["mag"])[:-1], got["mag"][:-1])
    assert np.abs(_np(unpadded["mag"])[-1] - got["mag"][-1]).max() > 0.1


def test_magphase_empty_and_device_check(monkeypatch):
    import torch
    out = tmag.magphase_analysis(np.zeros(0, np.float32), np.zeros(0, np.int32), SR, device="cpu")
    assert {k: v.shape for k, v in out.items()} == {
        "mag": (0, 60), "real": (0, 45), "imag": (0, 45), "lf0": (0, 1)}
    assert tmag.magphase_synthesis(out, SR, device="cpu").shape == (0,)
    assert tmag.magphase_synthesis(out, SR, epoch_samples=np.zeros(0), device="cpu").shape == (0,)
    w = tworld.world_analysis(np.zeros(0, np.float32), np.zeros(0, np.int32), SR, device="cpu")
    assert {k: v.shape for k, v in w.items()} == {"mgc": (0, 60), "bap": (0, 5), "lf0": (0, 1)}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for fn in (lambda: tmag.magphase_analysis(np.zeros(10), np.arange(4), SR),
               lambda: tworld.world_analysis(np.zeros(10), np.arange(4), SR),
               lambda: tstft.stft(np.zeros(600, np.float32), 256, 128),
               lambda: tmel.mfcc(np.zeros(600, np.float32), SR),
               lambda: tsmooth.smooth_joins(np.zeros((8, 3), np.float32), 2)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            fn()


@pytest.mark.parametrize("kw", [dict(), dict(overlap=1), dict(target_lf0=True),
                                dict(epoch_samples=True), dict(wsum_floor=0.05, overlap=2)])
def test_magphase_synthesis_matches_jax(utt3, kw):
    """The same streams (the JAX analysis) through both syntheses: the
    waves agree to f32 rounding of the transforms (1e-4 of the peak)."""
    wave, e = utt3
    streams = jmag.magphase_analysis(wave, e, SR)
    kw = dict(kw)
    if kw.get("target_lf0"):
        kw["target_lf0"] = streams["lf0"].reshape(-1) + 0.1
    if kw.get("epoch_samples"):
        kw.update(epoch_samples=e, n_samples=len(wave))
    got = tmag.magphase_synthesis(streams, SR, device="cpu", **kw)
    want = jmag.magphase_synthesis(streams, SR, **kw)
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-4 * np.abs(want).max())
    if "epoch_samples" in kw:
        corr = np.corrcoef(wave[2000:14000], got[2000:14000])[0, 1]
        assert corr > 0.90, f"copy-synthesis corr {corr}"


# ------------------------------------------------------------------ world
def _jax_world_logmel(wave, e, sr, n_mgc):
    """The JAX package's warped log power before the DCT (world.py:65-76),
    on its own frames and its own FFT."""
    fm = tmag.frame_max_for(sr, 50.0)
    ep = jnp.asarray(tmag.bucket_epochs(np.asarray(e, np.int32)))
    pg = jnp.maximum(jnp.diff(ep, prepend=ep[:1] - 64), 1)
    ng = jnp.maximum(jnp.diff(ep, append=ep[-1:] + 64), 1)
    frames, _ = jmag._epoch_frames(jnp.asarray(wave), ep, pg, ng, fm)
    spec = jnp.fft.rfft(frames, n=fm, axis=-1)
    power = jnp.real(spec) ** 2 + jnp.imag(spec) ** 2
    warp = jnp.asarray(jmag._warp_matrix(fm // 2 + 1, max(2 * n_mgc, 40), sr))
    return np.asarray(0.5 * jnp.log(jnp.maximum(jnp.dot(power, warp), 1e-16)))[:len(e)]


@pytest.mark.parametrize("n_mgc,n_bap,case", [(60, 5, "not_mod128"), (24, 5, "mod128"),
                                              (24, 3, "48k")])
def test_world_analysis_rules(utt3, n_mgc, n_bap, case):
    """mgc and bap by rule (b); the warped log power under the DCT by rule
    (a); lf0 equal."""
    import torch
    wave, e, sr = _epochs_case(case, utt3)
    got = tworld.world_analysis(wave, e, sr, n_mgc=n_mgc, n_bap=n_bap, device="cpu")
    want = jworld.world_analysis(wave, e, sr, n_mgc=n_mgc, n_bap=n_bap)
    truth = a64.world64(wave, e, sr, n_mgc=n_mgc, n_bap=n_bap)
    for k in ("mgc", "bap"):
        assert got[k].shape == want[k].shape and got[k].dtype == np.float32
        a64.rule_b(got[k], want[k], truth[k])
        np.testing.assert_allclose(got[k], truth[k], atol=PORT_F64_ATOL, err_msg=k)
    np.testing.assert_array_equal(got["lf0"], want["lf0"])
    fm = tmag.frame_max_for(sr, 50.0)
    power = tworld.world_power(torch.from_numpy(wave),
                               torch.from_numpy(tmag.bucket_epochs(np.asarray(e, np.int32))),
                               fm, fm)
    logmel = _np(tworld.world_log_mel(power, n_mgc, sr))[:len(e)]
    a64.rule_a(logmel, _jax_world_logmel(wave, e, sr, n_mgc), a64.strong(truth["logmel"]),
               truth["logmel"])


def test_world_bap_separates_tone_from_noise(utt3):
    """As tests/test_features.py::test_world_streams: periodic frames have
    deep inter-harmonic valleys (bap << 0), noise does not."""
    t = np.arange(SR) / SR
    phase = 2 * np.pi * np.cumsum(120.0 + 20.0 * np.sin(2 * np.pi * 0.7 * t)) / SR
    tone = (0.5 * np.sin(phase) + 0.25 * np.sin(2 * phase) + 0.12 * np.sin(3 * phase)).astype(
        np.float32)
    w = tworld.world_analysis(tone, tepochs.detect_epochs(tone, SR), SR, n_mgc=24,
                              device="cpu")
    noise = np.random.default_rng(7).standard_normal(SR).astype(np.float32) * 0.3
    wn = tworld.world_analysis(noise, np.arange(200, SR - 200, 130, dtype=np.int32), SR,
                               n_mgc=24, device="cpu")
    assert np.median(w["bap"][5:-5, 0]) < np.median(wn["bap"][5:-5, 0]) - 1.0


# -------------------------------------------------------------- smoothing
@pytest.mark.parametrize("F,k,width,strength", [
    (40, 4, 2, 1.0), (41, 3, 1, 0.5), (30, 4, 3, 1.0),      # width > k / 2
    (7, 4, 2, 1.0), (12, 6, 2, 0.7), (20, 5, 0, 1.0), (60, 2, 2, "array")])
def test_smooth_joins_matches_jax(F, k, width, strength):
    rng = np.random.default_rng(F * 100 + k)
    traj = rng.standard_normal((F, 7)).astype(np.float32)
    if strength == "array":
        strength = np.float32(0.25)
    got = _np(tsmooth.smooth_joins(traj, k, width=width, strength=strength, device="cpu"))
    want = np.asarray(jsmooth.smooth_joins(jnp.asarray(traj), k, width=width,
                                           strength=strength))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    if F < 2 * k or width < 1:
        np.testing.assert_array_equal(got, traj)


# ----------------------------------------------------------------- epochs
def _waves():
    rng = np.random.default_rng(4)
    w0, _ = synth_utterance(600, n_segments=6)
    return [w0, synth_utterance(601, n_segments=3)[0],
            (0.1 * rng.standard_normal(SR // 2)).astype(np.float32),
            np.zeros(500, np.float32)]                       # shorter than 0.05 s


@pytest.mark.parametrize("use_native", [True, False])
def test_detect_epochs_match_jax(use_native, jax_native):
    for w in _waves():
        got = tepochs.detect_epochs(w, SR, use_native=use_native)
        want = jepochs.detect_epochs(w, SR, use_native=use_native)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    for kw in (dict(fmin=60.0, fmax=300.0), dict(unvoiced_period_sec=0.01)):
        w = _waves()[0]
        np.testing.assert_array_equal(tepochs.detect_epochs(w, SR, use_native=use_native, **kw),
                                      jepochs.detect_epochs(w, SR, use_native=use_native, **kw))


@pytest.mark.parametrize("use_native,n_threads", [(True, 1), (True, 4), (False, 1), (False, 3)])
def test_detect_epochs_batch_matches_jax(use_native, n_threads, jax_native):
    waves = _waves()
    got = tepochs.detect_epochs_batch(waves, SR, n_threads=n_threads, use_native=use_native)
    want = jepochs.detect_epochs_batch(waves, SR, n_threads=n_threads, use_native=use_native)
    assert len(got) == len(want) == len(waves)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert tepochs.detect_epochs_batch([], SR) == []


def test_f0_tracking_matches_jax():
    for w in _waves()[:3]:
        for a, b in zip(tepochs.track_f0_autocorr(w, SR), jepochs.track_f0_autocorr(w, SR)):
            np.testing.assert_array_equal(a, b)
        e = jepochs.detect_epochs(w, SR)
        for n in (0, 1, 2, len(e)):
            np.testing.assert_array_equal(tepochs.f0_from_epochs(e[:n], SR),
                                          jepochs.f0_from_epochs(e[:n], SR))
    assert tepochs.f0_from_epochs(np.array([0, 10_000]), SR).shape == (2, 1)   # all unvoiced
    np.testing.assert_array_equal(tepochs.f0_from_epochs(np.array([0, 10_000]), SR),
                                  jepochs.f0_from_epochs(np.array([0, 10_000]), SR))


def test_native_library_is_the_ports_own(jax_native):
    """The port builds its own copy of native/epochs.cpp under
    build/snickery_tpu_torch_native and never loads the JAX package's
    library; its marks equal the JAX package's native marks, and its batch
    entry equals its scalar one at any thread count."""
    lib = tnative.get_lib()
    assert lib is not None, "g++ is present here: the native build must succeed"
    path = tnative.lib_path()
    assert path.exists() and path.parent.name == "snickery_tpu_torch_native"
    assert lib._name == str(path) != jax_native._name
    waves = _waves()[:3]
    for w in waves:
        np.testing.assert_array_equal(tnative.native_detect_epochs(w, SR),
                                      jax_native_epochs(w, SR))
    serial = tnative.native_detect_epochs_batch(waves, SR, n_threads=1)
    for nt in (2, 16):
        for a, b, w in zip(serial, tnative.native_detect_epochs_batch(waves, SR, n_threads=nt),
                           waves):
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(a, tnative.native_detect_epochs(w, SR))


def test_native_reference_survives_a_failed_jax_loader(monkeypatch, tmp_path_factory):
    """A JAX loader that has cached a failed load (the state of a process
    that lost the race of the in-place ``make``) runs the Python detector
    under ``use_native=True``, whose marks differ from the native ones on
    noise; the reference helper still loads its private build, so the marks
    compared are native, and it puts the failed state back afterwards."""
    from snickery_tpu import native as jnative
    monkeypatch.setattr(jnative, "_lib", None)
    monkeypatch.setattr(jnative, "_lib_failed", True)
    noise = _waves()[2]
    assert jnative.get_lib() is None
    fallback = jepochs.detect_epochs(noise, SR, use_native=True)
    np.testing.assert_array_equal(fallback, jepochs.detect_epochs(noise, SR, use_native=False))
    port = tepochs.detect_epochs(noise, SR, use_native=True)
    assert not np.array_equal(port, fallback)
    lib_path = build_private_lib(tmp_path_factory.getbasetemp() / "jaxnative")
    with native_reference(lib_path) as lib:
        assert jnative.get_lib() is lib and lib._name == str(lib_path)
        for w in _waves():
            np.testing.assert_array_equal(jepochs.detect_epochs(w, SR, use_native=True),
                                          tepochs.detect_epochs(w, SR, use_native=True))
    assert jnative._lib is None and jnative._lib_failed


def test_native_reference_fails_loudly_without_the_library(tmp_path):
    """A library that does not load is an error of the helper, never a
    silent switch to the Python detector."""
    from snickery_tpu import native as jnative
    before = (jnative._lib, jnative._lib_failed)
    bogus = tmp_path / "libsnickery_native.so"
    bogus.write_bytes(b"not a shared object")
    with pytest.raises(AssertionError, match="Python detector"):
        with native_reference(bogus):
            pass
    assert (jnative._lib, jnative._lib_failed) == before


# -------------------------------------------------------------------- est
def test_est_files_equal_and_round_trip(tmp_path):
    marks = np.array([100, 233, 366, 500, 647, 647, 50], dtype=np.int32)
    for sr in (16000, 48000):
        port_est.write_est_pitchmarks(marks, str(tmp_path / "t.pm"), sr)
        jest.write_est_pitchmarks(marks, str(tmp_path / "j.pm"), sr)
        assert (tmp_path / "t.pm").read_bytes() == (tmp_path / "j.pm").read_bytes()
        got = port_est.read_est_pitchmarks(str(tmp_path / "j.pm"), sr)
        np.testing.assert_array_equal(got, np.unique(marks))
        np.testing.assert_array_equal(got, jest.read_est_pitchmarks(str(tmp_path / "t.pm"), sr))
    port_est.write_est_pitchmarks(np.zeros(0, np.int32), str(tmp_path / "e.pm"), 16000)
    assert len(port_est.read_est_pitchmarks(str(tmp_path / "e.pm"), 16000)) == 0


@pytest.mark.parametrize("text,units", [
    ("0.01\n0.02\n0.03\n", "auto"), ("10\n20\n30\n40\n", "auto"), ("10 1\n20 1\n", "ms"),
    ("EST_File Track\nDataType ascii\nfoo bar\nEST_Header_End\n0.01 1 1\n-0.5 1 1\n0.02 1 1\n",
     "auto"),
    ("EST_File Track\nDataType binary\nEST_Header_End\n", "auto"),
    ("EST_File Track\nDataType ascii\n0.01 1 1\n", "auto"),
    ("this is not\na pitchmark file\n", "auto"), ("5000\n10000\n15000\n", "auto"),
    ("0.01\n", "minutes")])
def test_est_reader_matches_jax(tmp_path, text, units):
    p = tmp_path / "x.pm"
    p.write_text(text)

    def run(fn):
        try:
            return fn(str(p), 16000, units=units)
        except ValueError as e:
            return ("ValueError", str(e))
    got, want = run(port_est.read_est_pitchmarks), run(jest.read_est_pitchmarks)
    if isinstance(want, tuple):
        assert got == want
    else:
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_features_exports_match_jax():
    import snickery_tpu.features as jf
    import snickery_tpu_torch.features as tf
    assert tf.__all__ == jf.__all__
    for name in tf.__all__:
        assert callable(getattr(tf, name))

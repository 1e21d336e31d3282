"""The port's quality report (``snickery_tpu_torch.evaluate``) on the CPU
against the JAX package's, on the same numpy-seeded waves: a copy, a gain
change, a shifted copy, added noise and another utterance.

The metrics are computed from spectra that the two packages take with
different transforms (the port's f32 FFT, the JAX package's matmul DFT), so
the numbers agree to a stated tolerance, not bit for bit: the MCD within
``MCD_RTOL`` (relative) + ``MCD_ATOL`` dB, NSIM within ``NSIM_ATOL``, the
voicing / pitch error fractions exactly and the f0 RMSE within 1e-4 Hz,
the join flux ratio within ``FLUX_RTOL``.  The relative -60 dB floor of the
MCD analysis (``floor_db``) is what makes these tolerances meaningful: the
bands it clamps are the weak bands where two f32 transforms differ most.
``dtw_path``, the speech mask and the NSIM blur are the same numpy code and
are held equal exactly.
"""

import numpy as np
import pytest

import snickery_tpu.evaluate as jev
import snickery_tpu_torch.evaluate as tev
from tests import analysis64 as a64
from tests.toyvoice import SR, synth_utterance

MCD_RTOL, MCD_ATOL = 1e-4, 1e-3
NSIM_ATOL = 5e-4
FLUX_RTOL = 1e-4


@pytest.fixture(scope="module")
def waves():
    w, _ = synth_utterance(200, n_segments=8)
    w2, _ = synth_utterance(201, n_segments=8)
    noise = np.random.default_rng(0).standard_normal(len(w)).astype(np.float32)
    return {"self": (w, w), "gain": (0.25 * w, w), "shift": (w[300:], w),
            "noisy": ((w + 0.02 * noise).astype(np.float32), w), "other": (w2, w)}


CASES = ["self", "gain", "shift", "noisy", "other"]


@pytest.mark.parametrize("case", CASES)
def test_mcd_matches_jax(waves, case):
    s, r = waves[case]
    got = tev.mel_cepstral_distortion(s, r, SR, device="cpu")
    want = jev.mel_cepstral_distortion(s, r, SR)
    assert np.isfinite(got)
    assert abs(got - want) <= MCD_ATOL + MCD_RTOL * abs(want), (got, want)
    if case == "self":
        assert got == 0.0


@pytest.mark.parametrize("case", CASES)
def test_nsim_matches_jax(waves, case):
    s, r = waves[case]
    got, want = tev.nsim(s, r, SR, device="cpu"), jev.nsim(s, r, SR)
    assert abs(got - want) <= NSIM_ATOL, (got, want)
    if case in ("self", "gain"):
        assert got == pytest.approx(1.0, abs=1e-6)


@pytest.mark.parametrize("case", CASES)
def test_f0_metrics_match_jax(waves, case):
    s, r = waves[case]
    got, want = tev.f0_metrics(s, r, SR, device="cpu"), jev.f0_metrics(s, r, SR)
    assert got.keys() == want.keys() == {"vde", "gpe", "ffe", "f0_rmse_hz"}
    for k in ("vde", "gpe", "ffe"):
        assert got[k] == want[k], k
    np.testing.assert_allclose(got["f0_rmse_hz"], want["f0_rmse_hz"], atol=1e-4)


@pytest.mark.parametrize("case,width", [("self", 256), ("noisy", 256), ("other", 512)])
def test_join_discontinuity_matches_jax(waves, case, width):
    s = waves[case][0]
    joins = np.arange(500, len(s), 1500)
    got = tev.join_discontinuity(s, SR, joins, width=width, device="cpu")
    want = jev.join_discontinuity(s, SR, joins, width=width)
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_allclose(got[k], want[k], rtol=FLUX_RTOL, err_msg=k)
    short = tev.join_discontinuity(s[:300], SR, joins, device="cpu")
    assert all(np.isnan(v) for v in short.values())


def test_mfcc_and_neurogram_rules(waves):
    """The MFCC of the MCD analysis no farther than the JAX package's from a
    float64 analysis (rule (b)); the neurogram within 1e-5 of the JAX
    package's (it is normalised to its peak and has no log)."""
    w = waves["noisy"][0]
    got, want = tev._mfcc(w, SR, device="cpu"), jev._mfcc(w, SR)
    kw = dict(n_mels=tev._MCD_NMELS, frame_len=tev._MCD_FRAME, hop=tev._MCD_HOP,
              n_fft=tev._MCD_FRAME, floor_db=tev._MCD_FLOOR_DB)
    truth = a64.log_mel64(w, SR, **kw) @ a64.dct(tev._MCD_NMELS, 13)
    assert got.shape == want.shape == truth.shape
    a64.rule_b(got, want, truth)
    gn, wn = tev._neurogram(w, SR, device="cpu"), jev._neurogram(w, SR)
    assert gn.shape == wn.shape
    np.testing.assert_allclose(gn, wn, atol=1e-5)


@pytest.mark.parametrize("shape", [(1, 1), (1, 7), (9, 1), (30, 41), (64, 64)])
def test_dtw_path_equal(shape):
    cost = np.random.default_rng(shape[0] * 100 + shape[1]).random(shape)
    for a, b in zip(tev.dtw_path(cost), jev.dtw_path(cost)):
        np.testing.assert_array_equal(a, b)
    cost = np.zeros(shape)                       # every step ties
    for a, b in zip(tev.dtw_path(cost), jev.dtw_path(cost)):
        np.testing.assert_array_equal(a, b)


def test_speech_mask_and_blur_equal(waves):
    w = waves["shift"][0]
    for n in (0, 5, 60):
        np.testing.assert_array_equal(tev._speech_mask(w, n), jev._speech_mask(w, n))
    x = np.random.default_rng(3).random((17, 32))
    np.testing.assert_array_equal(tev._gauss_blur_3x3(x), jev._gauss_blur_3x3(x))


def test_evaluate_needs_cuda_by_default(waves, monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    s, r = waves["self"]
    for fn in (lambda: tev.mel_cepstral_distortion(s, r, SR), lambda: tev.nsim(s, r, SR),
               lambda: tev.f0_metrics(s, r, SR),
               lambda: tev.join_discontinuity(s, SR, np.array([800]))):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            fn()

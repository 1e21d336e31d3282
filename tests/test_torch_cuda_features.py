"""The port's analysis chain, voice building, magphase resynthesis and
quality report on a CUDA card against the same code on the CPU.

Tolerances: the analyses (log-mel, MFCC, magphase, WORLD-style) run in
float64 to f32 outputs, so the card's cuFFT and the CPU's FFT agree within
``F64_ATOL``; the f32 STFT within 1e-5 of its peak; the f32 syntheses (the
overlap-add is ``index_add_``, which on the card adds in no fixed order)
within 1e-4 of their peak; the voice's arrays that do not depend on the
analysis exactly.  Each card test starts with TF32 allowed; the analysis'
products run in float64, where it never applies.

Marked ``cuda``; each test skips where no card is visible.  No jax:

    python -m pytest -m cuda --noconftest -p no:cacheprovider tests/test_torch_cuda_features.py
"""

import importlib

import numpy as np
import pytest
import torch

from snickery_tpu_torch import evaluate as tev
from snickery_tpu_torch.features import magphase as tmag
from snickery_tpu_torch.features import mel as tmel
from snickery_tpu_torch.features import smoothing as tsmooth
from snickery_tpu_torch.features import world as tworld
from snickery_tpu_torch.features.epochs import detect_epochs
from snickery_tpu_torch.synthetic_voices import SR, synth_utterance
# (pytest puts this directory on sys.path: on a card host a package named
# ``tests`` installed elsewhere may shadow ``tests.toycorpus``)
from toycorpus import write_config, write_corpus

tstft = importlib.import_module("snickery_tpu_torch.features.stft")
F64_ATOL = 1e-4


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run this file on the GPU host)")
    torch.backends.cuda.matmul.allow_tf32 = True
    return "cuda"


@pytest.fixture(scope="module")
def utt():
    wave, _ = synth_utterance(3)
    return wave, detect_epochs(wave, SR)


def _np(t):
    return t.cpu().numpy() if hasattr(t, "cpu") else np.asarray(t)


@pytest.mark.cuda
@pytest.mark.parametrize("frame_len,hop,n_fft", [(512, 128, None), (400, 160, 512)])
def test_stft_istft_card_vs_cpu(cuda_device, utt, frame_len, hop, n_fft):
    wave = utt[0]
    got = _np(tstft.stft(wave, frame_len, hop, n_fft, device=cuda_device))
    want = _np(tstft.stft(wave, frame_len, hop, n_fft, device="cpu"))
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, atol=1e-5 * scale)
    np.testing.assert_allclose(_np(tstft.stft_mag(wave, frame_len, hop, n_fft, device=cuda_device)),
                               np.abs(want), atol=1e-5 * scale)
    if n_fft is None:
        back = _np(tstft.istft(want, frame_len, hop, len(wave), device=cuda_device))
        ref = _np(tstft.istft(want, frame_len, hop, len(wave), device="cpu"))
        np.testing.assert_allclose(back[frame_len:-frame_len], ref[frame_len:-frame_len],
                                   atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("floor_db", [None, 60.0])
def test_log_mel_and_mfcc_card_vs_cpu(cuda_device, utt, floor_db):
    wave = utt[0]
    for fn in (tmel.log_mel_spectrogram, tmel.mfcc):
        got = _np(fn(wave, SR, floor_db=floor_db, device=cuda_device))
        np.testing.assert_allclose(got, _np(fn(wave, SR, floor_db=floor_db, device="cpu")),
                                   atol=F64_ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("n_epochs", [128, None])       # None: 142, no multiple of 128
def test_magphase_analysis_card_vs_cpu(cuda_device, utt, n_epochs):
    wave, e = utt
    e = e[:n_epochs]
    got = tmag.magphase_analysis(wave, e, SR, device=cuda_device)
    want = tmag.magphase_analysis(wave, e, SR, device="cpu")
    for k in ("mag", "real", "imag"):
        assert got[k].shape == want[k].shape and got[k].dtype == np.float32
        np.testing.assert_allclose(got[k], want[k], atol=F64_ATOL, err_msg=k)
    np.testing.assert_array_equal(got["lf0"], want["lf0"])


@pytest.mark.cuda
def test_world_analysis_card_vs_cpu(cuda_device, utt):
    wave, e = utt
    got = tworld.world_analysis(wave, e, SR, device=cuda_device)
    want = tworld.world_analysis(wave, e, SR, device="cpu")
    for k in ("mgc", "bap"):
        np.testing.assert_allclose(got[k], want[k], atol=F64_ATOL, err_msg=k)
    np.testing.assert_array_equal(got["lf0"], want["lf0"])


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [{}, {"overlap": 1}, {"epoch_samples": True},
                                {"target_lf0": True, "wsum_floor": 0.05}])
def test_magphase_synthesis_card_vs_cpu(cuda_device, utt, kw):
    wave, e = utt
    streams = tmag.magphase_analysis(wave, e, SR, device="cpu")
    kw = dict(kw)
    if kw.get("epoch_samples"):
        kw.update(epoch_samples=e, n_samples=len(wave))
    if kw.get("target_lf0"):
        kw["target_lf0"] = streams["lf0"].reshape(-1) + 0.1
    got = tmag.magphase_synthesis(streams, SR, device=cuda_device, **kw)
    want = tmag.magphase_synthesis(streams, SR, device="cpu", **kw)
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-4 * np.abs(want).max())


@pytest.mark.cuda
@pytest.mark.parametrize("F,k,width", [(40, 4, 2), (30, 4, 3), (7, 4, 2)])
def test_smooth_joins_card_vs_cpu(cuda_device, F, k, width):
    traj = np.random.default_rng(F + k).standard_normal((F, 9)).astype(np.float32)
    got = _np(tsmooth.smooth_joins(traj, k, width=width, device=cuda_device))
    np.testing.assert_allclose(got, _np(tsmooth.smooth_joins(traj, k, width=width, device="cpu")),
                               rtol=1e-6, atol=1e-6)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("cuda_corpus")
    write_corpus(str(root), [200, 201, 202], n_segments=5)
    return root, write_config(root / "voice.json", str(root))


@pytest.mark.cuda
@pytest.mark.parametrize("over", [{}, {"target_representation": "halfphone"},
                                  {"stream_list": ["mgc", "lf0", "bap"],
                                   "datadims": {"mgc": 24, "lf0": 1, "bap": 5}}])
def test_train_voice_card_vs_cpu(cuda_device, corpus, tmp_path, over):
    from snickery_tpu_torch.config import load_config
    from snickery_tpu_torch.train import train_voice
    cfg = load_config(write_config(tmp_path / "voice.json", str(corpus[0]), **over))
    got = train_voice(cfg, save=False, device=cuda_device)
    want = train_voice(cfg, save=False, device="cpu")
    for name in ("cutpoints", "utt_index", "unit_lf0", "waves", "wave_offsets", "unit_code"):
        x, y = getattr(got, name), getattr(want, name)
        assert (x is None and y is None) or np.asarray(x).tobytes() == np.asarray(y).tobytes(), name
    for name in ("unit_features", "join_left", "join_right"):
        np.testing.assert_allclose(getattr(got, name), getattr(want, name), atol=F64_ATOL,
                                   err_msg=name)


@pytest.mark.cuda
def test_resynth_magphase_card_vs_cpu(cuda_device, corpus):
    import dataclasses

    from snickery_tpu_torch.config import load_config
    from snickery_tpu_torch.synth import Synthesiser
    from snickery_tpu_torch.train import prepare_utterance, train_voice
    cfg = dataclasses.replace(load_config(corpus[1]), magphase_smooth_joins=2)
    db = train_voice(cfg, save=False, device="cpu")
    feats = prepare_utterance(cfg, "utt01", device="cpu").features
    card, cpu = Synthesiser(cfg, db, device=cuda_device), Synthesiser(cfg, db, device="cpu")
    ids = cpu.synth_from_features(feats[::-1].copy())["unit_ids"]
    for kw in ({}, {"target_lf0": feats[: len(ids), -1] + 0.05}):
        got, want = card.resynth_magphase(ids, **kw), cpu.resynth_magphase(ids, **kw)
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=1e-4 * np.abs(want).max())


@pytest.mark.cuda
def test_evaluate_card_vs_cpu(cuda_device):
    w, _ = synth_utterance(200, n_segments=8)
    other, _ = synth_utterance(201, n_segments=8)
    for s, r in ((w[300:], w), (other, w), (0.5 * w, w)):
        np.testing.assert_allclose(tev.mel_cepstral_distortion(s, r, SR, device=cuda_device),
                                   tev.mel_cepstral_distortion(s, r, SR, device="cpu"),
                                   rtol=1e-5, atol=1e-4)
        np.testing.assert_allclose(tev.nsim(s, r, SR, device=cuda_device),
                                   tev.nsim(s, r, SR, device="cpu"), atol=1e-5)
        got, want = tev.f0_metrics(s, r, SR, device=cuda_device), tev.f0_metrics(s, r, SR,
                                                                                   device="cpu")
        for k in ("vde", "gpe", "ffe"):
            assert got[k] == want[k], k
        np.testing.assert_allclose(got["f0_rmse_hz"], want["f0_rmse_hz"], atol=1e-4)
        joins = np.arange(500, len(s), 1500)
        got = tev.join_discontinuity(s, SR, joins, device=cuda_device)
        want = tev.join_discontinuity(s, SR, joins, device="cpu")
        for k in got:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)


@pytest.mark.cuda
def test_analysis_exact_with_tf32_allowed(cuda_device, utt):
    """The caller allows TF32 (the fixture does).  The products of the
    analysis, the resynthesis and the neurogram run in float64, where TF32
    never applies, so the tests above hold them to the CPU; none of them
    changes the caller's setting."""
    wave, e = utt
    streams = tmag.magphase_analysis(wave, e, SR, device=cuda_device)
    tmag.magphase_synthesis(streams, SR, device=cuda_device)
    tworld.world_analysis(wave, e, SR, device=cuda_device)
    tmel.mfcc(wave, SR, device=cuda_device)
    tev.nsim(wave, wave, SR, device=cuda_device)
    assert torch.backends.cuda.matmul.allow_tf32

"""The port's voice building (``snickery_tpu_torch.train``) on the CPU against
the JAX package's, on a wav corpus written to disk (tests/toycorpus.py):
epoch, halfphone, sample-level, multi-epoch and WORLD-stream voices, with
silence trimming, pitchmark files and feature files.

Each voice is built by both packages.  Epochs, unit bounds, waves, lf0,
halfphone segments and every other array of the ``.voicedb`` but the
features are equal exactly; each utterance's features are held by the rules
of tests/analysis64.py (within 1e-3 of the JAX package on strong bands,
beyond its own error there, and no farther than it from a float64 analysis
of the same frames), and within ``PORT_F64_ATOL`` of that float64 analysis;
features read from files are equal exactly.
"""

import dataclasses
import os

import numpy as np
import pytest

from snickery_tpu import config as jconfig
from snickery_tpu import train as jtrain
from snickery_tpu_torch import config as tconfig
from snickery_tpu_torch import train as ttrain
from snickery_tpu_torch.features.epochs import detect_epochs
from snickery_tpu_torch.io.est import write_est_pitchmarks
from snickery_tpu_torch.io.speech import put_speech, read_wave
from snickery_tpu_torch.voicedb.build import build_voicedb
from tests import analysis64 as a64
from tests.jaxnative import jax_native  # noqa: F401
from tests.toycorpus import STREAMS, write_config, write_corpus

# the JAX package's train detects epochs: with its native library, always
pytestmark = pytest.mark.usefixtures("jax_native")

PORT_F64_ATOL = 1e-4
EXACT = ("cutpoints", "utt_index", "unit_pos", "unit_code", "context_codes", "voice_ids",
         "unit_lf0", "waves", "wave_offsets")
META = ("sample_rate", "target_representation", "multiepoch", "stream_list", "datadims",
        "filenames", "unit_names", "phone_names", "voice_names", "version")
WORLD = {"mgc": 24, "lf0": 1, "bap": 5}


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_train")
    names = write_corpus(str(root), [200, 201, 202], n_segments=5)
    padded = root / "padded"
    write_corpus(str(padded), [42, 43], n_segments=4, pad_silence=4000)
    # pitchmarks and stream files of the corpus (the marks thinned, so that
    # they differ from what the detector would give)
    for sub in ("pm", "mag", "real", "imag", "lf0"):
        os.makedirs(root / "feats" / sub)
    rng = np.random.default_rng(9)
    for name in names:
        wave, sr = read_wave(str(root / "wav" / f"{name}.wav"))
        write_est_pitchmarks(detect_epochs(wave, sr)[::2], str(root / "feats" / "pm" / f"{name}.pm"),
                             sr)
        for s, d in STREAMS.items():
            put_speech(rng.standard_normal((400, d)).astype(np.float32),
                       str(root / "feats" / s / f"{name}.{s}"))
    return root


CASES = {
    "epoch": {},
    "halfphone": dict(target_representation="halfphone"),
    "sample": dict(target_representation="sample", sample_hop=80),
    "multiepoch": dict(multiepoch=2),
    "world": dict(stream_list=list(WORLD), datadims=WORLD),
    "world_mfcc_alias": dict(stream_list=["mfcc", "bap", "lf0", "mag"],
                             datadims={"mfcc": 20, "bap": 3, "lf0": 1, "mag": 60}),
    "trim_silence": dict(trim_silence=True),
    "pm_datadir": dict(pm="feats/pm"),
    "feat_datadir": dict(pm="feats/pm", feat="feats"),
    "n_train_utts": dict(n_train_utts=2),
}


def _configs(root, tmp_path, kind):
    over = dict(CASES[kind])
    if kind == "trim_silence":
        root = root / "padded"
    if "pm" in over:
        over["pm_datadir"] = str(root / over.pop("pm"))
    if "feat" in over:
        over["feat_datadir"] = str(root / over.pop("feat"))
    path = write_config(tmp_path / "voice.json", str(root), **over)
    return root, tconfig.load_config(path), jconfig.load_config(path)


def _truth(cfg, utt, wave, analysed):
    """The float64 analysis of the utterance's frames: each stream at the
    epochs the analysis saw (before any silence trimming), rows picked at the
    utterance's kept epochs."""
    rows = np.searchsorted(analysed, utt.epochs)
    out = {}
    if any(s in ("mag", "real", "imag") for s in cfg.stream_list):
        out.update(a64.magphase64(wave, analysed, cfg.sample_rate,
                                  n_mag=cfg.datadims.get("mag", 60),
                                  n_phase=cfg.datadims.get("real", 45)))
    if any(s in ("mgc", "bap", "mfcc") for s in cfg.stream_list):
        w = a64.world64(wave, analysed, cfg.sample_rate,
                        n_mgc=cfg.datadims.get("mgc", cfg.datadims.get("mfcc", 60)),
                        n_bap=cfg.datadims.get("bap", 5))
        out.update(mgc=w["mgc"], mfcc=w["mgc"], bap=w["bap"])
    return {k: v[rows] for k, v in out.items()}


def _assert_features(cfg, tu, ju, root):
    """Each stream of one utterance by the rules (lf0 exactly)."""
    wave, sr = read_wave(os.path.join(cfg.wav_datadir, tu.basename + ".wav"))
    analysed = detect_epochs(wave, sr) if cfg.trim_silence else tu.epochs
    truth = _truth(cfg, tu, wave, analysed)
    for name, a, b in cfg.stream_slices:
        got, want = tu.features[:, a:b], ju.features[:, a:b]
        if name == "lf0":
            np.testing.assert_array_equal(got, want)
            continue
        if name in ("mag", "real", "imag"):
            strength = truth["mag"] if name == "mag" else truth["strength_ph"]
            a64.rule_a(got, want, a64.strong(strength), truth[name])
        a64.rule_b(got, want, truth[name])
        np.testing.assert_allclose(got, truth[name], atol=PORT_F64_ATOL, err_msg=name)


@pytest.mark.parametrize("kind", sorted(CASES))
def test_train_voice_matches_jax(corpus, tmp_path, kind):
    root, tcfg, jcfg = _configs(corpus, tmp_path, kind)
    tdb = ttrain.train_voice(tcfg, save=False, device="cpu")
    jdb = jtrain.train_voice(jcfg, save=False)
    for name in META:
        assert getattr(tdb, name) == getattr(jdb, name), name
    for name in EXACT:
        x, y = getattr(tdb, name), getattr(jdb, name)
        assert (x is None) == (y is None), name
        if x is not None:
            assert np.asarray(x).tobytes() == np.asarray(y).tobytes(), name
    assert tdb.unit_features.shape == jdb.unit_features.shape
    bases = ttrain.corpus_basenames(tcfg)
    assert bases == jtrain.corpus_basenames(jcfg) and len(bases) == (2 if kind in (
        "trim_silence", "n_train_utts") else 3)
    tutts = [ttrain.prepare_utterance(tcfg, b, device="cpu") for b in bases]
    jutts = [jtrain.prepare_utterance(jcfg, b) for b in bases]
    for tu, ju in zip(tutts, jutts):
        np.testing.assert_array_equal(tu.epochs, ju.epochs)
        np.testing.assert_array_equal(tu.wave, ju.wave)
        np.testing.assert_array_equal(tu.lf0, ju.lf0)
        assert [dataclasses.astuple(s) for s in tu.halfphones or []] == [
            dataclasses.astuple(s) for s in ju.halfphones or []]
        if kind == "feat_datadir":
            assert tu.features.tobytes() == ju.features.tobytes()
        else:
            _assert_features(tcfg, tu, ju, root)
    # the DB is the port's utterances, cut by the shared builder
    assert tdb.unit_features.tobytes() == build_voicedb(tcfg, tutts).unit_features.tobytes()
    if kind == "feat_datadir":
        for name in ("unit_features", "join_left", "join_right", "mean_target", "std_target"):
            assert getattr(tdb, name).tobytes() == getattr(jdb, name).tobytes(), name
    if kind == "trim_silence":
        assert tutts[0].epochs.min() > 3000


def test_train_voice_saves_a_voicedb_both_packages_load(corpus, tmp_path):
    from snickery_tpu.voicedb.db import VoiceDB as JaxVoiceDB
    from snickery_tpu_torch.voicedb.db import VoiceDB
    _, tcfg, _ = _configs(corpus, tmp_path, "epoch")
    db = ttrain.train_voice(tcfg, device="cpu")
    assert os.path.isdir(tcfg.db_path)
    for loaded in (VoiceDB.load(tcfg.db_path), JaxVoiceDB.load(tcfg.db_path, mmap=False)):
        assert loaded.unit_features.tobytes() == db.unit_features.tobytes()
        assert loaded.cutpoints.tobytes() == db.cutpoints.tobytes()


def test_train_voice_refusals(corpus, tmp_path, monkeypatch):
    import torch
    _, tcfg, _ = _configs(corpus, tmp_path, "epoch")
    with pytest.raises(FileNotFoundError):
        ttrain.train_voice(dataclasses.replace(tcfg, wav_datadir=str(tmp_path / "none")),
                           device="cpu")
    with pytest.raises(ValueError, match="native dim"):
        ttrain.train_voice(dataclasses.replace(tcfg, datadims=dict(STREAMS, lf0=2)),
                           save=False, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ttrain.train_voice(tcfg, save=False)

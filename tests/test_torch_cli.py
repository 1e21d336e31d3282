"""The port's command line (``snickery_tpu_torch.cli``) on the CPU against the
JAX package's: the hybrid (DNN-target) tests of tests/test_cli.py and the
merge + ``--voice`` test of tests/test_multivoice.py, each running both CLIs
on one config and one ``.voicedb`` and comparing the ``units.npy`` files
(equal) and the wavs (16-bit PCM of audio equal to f32 rounding: one LSB).

The voices are the toy voices of tests/toyvoice.py, saved with the JAX
package's ``VoiceDB.save``; the "predicted" stream files are held-out toy
utterances' features (epoch-rate, or resampled to 5 ms frames).
"""

import dataclasses
import json
import os

import numpy as np
import pytest

from snickery_tpu.cli import main as jax_cli
from snickery_tpu.voicedb.multivoice import merge_voicedbs
from snickery_tpu_torch import cli as cli_mod
from snickery_tpu_torch.cli import main as port_cli
from snickery_tpu_torch.features.world import resample_to_fixed
from snickery_tpu_torch.io.speech import get_speech, put_speech, read_wave
from snickery_tpu_torch.voicedb.db import VoiceDB
from tests.toyvoice import SR, build_toy_voice, prepare_toy_utts

PCM_ATOL = 1.5 / 32768.0    # wavs are 16-bit PCM of audio equal to 1e-5


def _write_streams(root, utts, names, fixed_frameshift=0.0):
    """Stream files <root>/<stream>/<name>.<stream> of each utterance's
    features (mag 60 | real 45 | imag 45 | lf0 1), epoch-rate or resampled
    to fixed-rate frames."""
    slices = {"mag": (0, 60), "real": (60, 105), "imag": (105, 150), "lf0": (150, 151)}
    for u, name in zip(utts, names):
        feats = u.features
        if fixed_frameshift:
            feats = resample_to_fixed(u.features, u.epochs, SR, fixed_frameshift)
        for s, (a, b) in slices.items():
            os.makedirs(os.path.join(root, s), exist_ok=True)
            put_speech(feats[:, a:b], os.path.join(root, s, f"{name}.{s}"))


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_cli")
    cfg, db, _ = build_toy_voice(halfphone=False)
    db.save(str(root / "work" / "clitoy.voicedb"))
    held = prepare_toy_utts(3, seed0=950)
    names = [f"pred{i:02d}" for i in range(3)]
    _write_streams(str(root / "predicted"), held, names)
    _write_streams(str(root / "fixed"), held[:1], names[:1], fixed_frameshift=0.005)
    cfg_d = dataclasses.asdict(cfg)
    cfg_d.update(workdir=str(root / "work"), voice_name="clitoy",
                 test_data_dir=str(root / "predicted"), n_candidates=8,
                 taper_length=32)
    return root, cfg_d, held


def _config(root, cfg_d, name, **over):
    path = root / f"{name}.json"
    path.write_text(json.dumps(dict(cfg_d, **over)))
    return str(path)


def _run_both(cfg_path, out_root, *extra, rc=0):
    """Both CLIs' synth on one config; returns the two output dirs."""
    out_j, out_t = str(out_root / "out_jax"), str(out_root / "out_port")
    assert jax_cli(["synth", "-c", cfg_path, "-o", out_j, *extra]) == rc
    assert port_cli(["synth", "-c", cfg_path, "-o", out_t, "--device", "cpu", *extra]) == rc
    return out_j, out_t


def _assert_same_outputs(out_j, out_t):
    files = sorted(os.listdir(out_j))
    assert files == sorted(os.listdir(out_t)) and files
    for f in files:
        a, b = os.path.join(out_j, f), os.path.join(out_t, f)
        if f.endswith(".npy"):
            np.testing.assert_array_equal(np.load(b), np.load(a))
        else:
            (wa, sa), (wb, sb) = read_wave(a), read_wave(b)
            assert sa == sb == SR and len(wa) == len(wb)
            np.testing.assert_allclose(wb, wa, atol=PCM_ATOL)


def test_hybrid_dnn_target_mode(corpus, tmp_path):
    """Hybrid mode: DNN-predicted stream files under test_data_dir drive
    synthesis (one utterance per step); ids and wavs equal the JAX CLI's."""
    root, cfg_d, _ = corpus
    out_j, out_t = _run_both(_config(tmp_path, cfg_d, "hybrid"), tmp_path, "--dump-units")
    _assert_same_outputs(out_j, out_t)
    assert sorted(f for f in os.listdir(out_t) if f.endswith(".wav")) == [
        "pred00.wav", "pred01.wav", "pred02.wav"]
    audio, sr = read_wave(os.path.join(out_t, "pred00.wav"))
    assert sr == SR and len(audio) > 1000 and np.abs(audio).max() > 0.01


def _path_cost64(synth, tw, ids):
    """Float64 target + join cost of a unit path, and the f32 cancellation
    noise of the JAX join distances along it (tests/test_torch_synth.py)."""
    db, f64 = synth.db, np.float64
    fw = (((db.unit_features[ids] - db.mean_target) / db.std_target) * synth._sqrt_wt)
    jl = (((db.join_left[ids] - db.mean_join) / db.std_join) * synth._sqrt_wj).astype(f64)
    jr = (((db.join_right[ids] - db.mean_join) / db.std_join) * synth._sqrt_wj).astype(f64)
    jcw = synth.cfg.join_cost_weight
    cost = (np.sqrt(((fw.astype(f64) - tw) ** 2).sum(-1)).sum()
            + jcw * np.sqrt(((jl[1:] - jr[:-1]) ** 2).sum(-1)).sum())
    eps = float(np.finfo(np.float32).eps)
    noise = jcw * np.sqrt(16 * eps * ((jl[1:] ** 2).sum(-1) + (jr[:-1] ** 2).sum(-1))).sum()
    return cost, noise


def test_hybrid_fixed_rate_targets(corpus, tmp_path):
    """Fixed-rate (5 ms) DNN-style targets: the epoch grid is integrated
    from the predicted lf0 (test_data_frameshift), as in the JAX CLI: the
    same epoch-rate targets, and the same ids except where the JAX
    package's Viterbi, whose join distances carry f32 cancellation noise
    (``|r|^2 + |l|^2 - 2 r.l``), takes a path that is dearer in float64;
    there the port's path must be the cheaper one, by less than that
    noise."""
    from snickery_tpu.features.world import fixed_to_epoch_targets as jax_fixed
    from snickery_tpu_torch.config import load_config
    from snickery_tpu_torch.features.world import fixed_to_epoch_targets
    from snickery_tpu_torch.synth import Synthesiser

    root, cfg_d, held = corpus
    cfg_path = _config(tmp_path, cfg_d, "fixed", test_data_dir=str(root / "fixed"),
                       test_data_frameshift=0.005)
    out_j, out_t = _run_both(cfg_path, tmp_path, "--dump-units")
    assert sorted(os.listdir(out_j)) == sorted(os.listdir(out_t)) == [
        "pred00.units.npy", "pred00.wav"]
    audio, _ = read_wave(os.path.join(out_t, "pred00.wav"))
    assert 0.75 < len(audio) / len(held[0].wave) < 1.25
    feats, _, _, _ = cli_mod._target_features_for(load_config(cfg_path), "pred00")
    fixed = np.concatenate([get_speech(os.path.join(root, "fixed", s, f"pred00.{s}"), d)
                            for s, d in (("mag", 60), ("real", 45), ("imag", 45), ("lf0", 1))],
                           axis=1)
    want, _ = jax_fixed(fixed, 150, SR, 0.005)
    np.testing.assert_array_equal(feats, want)
    np.testing.assert_array_equal(fixed_to_epoch_targets(fixed, 150, SR, 0.005)[0], want)
    ids_j, ids_t = (np.load(os.path.join(d, "pred00.units.npy")) for d in (out_j, out_t))
    assert len(ids_j) == len(ids_t) and (ids_j == ids_t).mean() >= 0.9
    synth = Synthesiser(load_config(cfg_path), device="cpu")
    tgt, _ = synth.targets_from_features(feats)
    tw = (((tgt - synth.db.mean_target) / synth.db.std_target) * synth._sqrt_wt).astype(np.float64)
    (c_t, _), (c_j, noise) = _path_cost64(synth, tw, ids_t), _path_cost64(synth, tw, ids_j)
    assert c_t <= c_j * (1 + 1e-12) and c_j - c_t <= noise, (c_t, c_j, noise)


def test_cli_batched_synthesis(corpus, tmp_path):
    """synth_batch > 1 routes synthesis through the batched step (3
    utterances: a batch of 2, then 1)."""
    root, cfg_d, _ = corpus
    out_j, out_t = _run_both(_config(tmp_path, cfg_d, "batched", synth_batch=2),
                             tmp_path, "--dump-units")
    _assert_same_outputs(out_j, out_t)
    assert sorted(f for f in os.listdir(out_t) if f.endswith(".wav")) == [
        "pred00.wav", "pred01.wav", "pred02.wav"]


@pytest.mark.parametrize("extra", [("--greedy",), ("--no-greedy", "pred01")])
def test_cli_greedy_and_utterance_filter(corpus, tmp_path, extra):
    root, cfg_d, _ = corpus
    out_j, out_t = _run_both(_config(tmp_path, cfg_d, "g"), tmp_path, "--dump-units", *extra)
    _assert_same_outputs(out_j, out_t)
    if "pred01" in extra:
        assert sorted(os.listdir(out_t)) == ["pred01.units.npy", "pred01.wav"]


def test_cli_serve_dispatch(monkeypatch):
    """`serve` forwards the config, the server options and --device."""
    import snickery_tpu_torch.server as server_mod
    calls = []

    def fake_serve(config_path, host, port, max_batch, max_wait_ms, device):
        calls.append(dict(config=config_path, host=host, port=port,
                          max_batch=max_batch, max_wait_ms=max_wait_ms, device=device))

    monkeypatch.setattr(server_mod, "serve", fake_serve)
    assert port_cli(["serve", "-c", "voice.json", "--host", "127.0.0.1", "--port", "8399",
                     "--max-batch", "4", "--max-wait-ms", "5"]) == 0
    assert port_cli(["serve", "-c", "voice.json", "--device", "cpu"]) == 0
    assert calls == [
        {"config": "voice.json", "host": "127.0.0.1", "port": 8399, "max_batch": 4,
         "max_wait_ms": 5.0, "device": "cuda"},
        {"config": "voice.json", "host": "0.0.0.0", "port": 8300, "max_batch": 32,
         "max_wait_ms": 20.0, "device": "cpu"}]


def test_cli_merge_and_voice_flag(corpus, tmp_path):
    """`merge` writes the same .voicedb as the JAX CLI's; `synth --voice`
    from it selects that voice's units only, with the JAX CLI's ids; without
    --voice both CLIs refuse (exit 1)."""
    root, cfg_d, _ = corpus
    _, db_a, _ = build_toy_voice(halfphone=False, n_utts=2)
    _, db_b, _ = build_toy_voice(halfphone=False, n_utts=3)
    pa, pb = str(tmp_path / "a.voicedb"), str(tmp_path / "b.voicedb")
    db_a.save(pa)
    db_b.save(pb)
    out_t, out_j = tmp_path / "w" / "merged.voicedb", tmp_path / "wj" / "merged.voicedb"
    assert port_cli(["merge", pa, pb, "-o", str(out_t), "--names", "alice,bob"]) == 0
    assert jax_cli(["merge", pa, pb, "-o", str(out_j), "--names", "alice,bob"]) == 0
    for f in sorted(p.relative_to(out_j) for p in out_j.rglob("*") if p.is_file()):
        assert (out_t / f).read_bytes() == (out_j / f).read_bytes(), f
    merged = VoiceDB.load(str(out_t))
    assert merged.voice_names == ["alice", "bob"]
    assert merged.n_units == merge_voicedbs([db_a, db_b]).n_units
    assert port_cli(["merge", pa, pb, "-o", str(out_t), "--names", "alice"]) == 1
    cfg_path = _config(tmp_path, cfg_d, "mv", workdir=str(tmp_path / "w"),
                       voice_name="merged")
    _run_both(cfg_path, tmp_path / "novoice", rc=1)
    out_j, out_t = _run_both(cfg_path, tmp_path, "--voice", "bob", "--dump-units")
    _assert_same_outputs(out_j, out_t)
    for f in os.listdir(out_t):
        if f.endswith(".npy"):
            assert (merged.voice_ids[np.load(os.path.join(out_t, f))] == 1).all()


def test_cli_info_matches(corpus, capsys):
    root, cfg_d, _ = corpus
    cfg_path = _config(root, cfg_d, "info")
    assert jax_cli(["info", "-c", cfg_path]) == 0
    want = capsys.readouterr().out
    assert port_cli(["info", "-c", cfg_path, "--device", "cpu"]) == 0
    assert capsys.readouterr().out == want
    assert "VoiceDB[epoch]" in want


@pytest.mark.parametrize("argv", [["train"], ["evaluate"], ["synth"]])
def test_unported_commands_raise(corpus, tmp_path, argv):
    """train, evaluate and natural-mode synth (no test_data_dir) need the
    analysis chain and the voice builder: NotImplementedError naming
    ROADMAP."""
    root, cfg_d, _ = corpus
    cfg_path = _config(tmp_path, cfg_d, "natural", test_data_dir="")
    args = argv + (["-c", cfg_path, "--device", "cpu"] if argv == ["synth"]
                   else ["-c", cfg_path] if argv == ["train"] else [])
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        port_cli(args)
    assert cli_mod._TODO in str(pytest.raises(NotImplementedError, port_cli, args).value)

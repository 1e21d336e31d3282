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
from tests.jaxnative import jax_native  # noqa: F401
from tests.toycorpus import copy_reference, write_config, write_corpus
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


# ---------------------------------------------- train -> natural synth -> evaluate
@pytest.fixture(scope="module")
def trained(tmp_path_factory, jax_native):
    """A wav corpus (three training utterances and a held-out one, which
    sorts last and so falls outside ``n_train_utts``) and a voice built from
    it by each CLI's ``train``, then each CLI's natural-mode ``synth`` of all
    four wavs (the training ones must come back as their own units)."""
    root = tmp_path_factory.mktemp("torch_cli_natural")
    train_names = write_corpus(str(root), [200, 201, 202], n_segments=5)
    held = write_corpus(str(root), [950], n_segments=5, prefix="zheld")
    cfgs = {who: write_config(root / f"{who}.json", str(root), workdir=str(root / f"work_{who}"),
                              n_train_utts=3)
            for who in ("jax", "port")}
    assert jax_cli(["train", "-c", cfgs["jax"]]) == 0
    assert port_cli(["train", "-c", cfgs["port"], "--device", "cpu"]) == 0
    outs = {"jax": str(root / "out_jax"), "port": str(root / "out_port")}
    assert jax_cli(["synth", "-c", cfgs["jax"], "-o", outs["jax"], "--dump-units"]) == 0
    assert port_cli(["synth", "-c", cfgs["port"], "-o", outs["port"], "--dump-units",
                     "--device", "cpu"]) == 0
    return root, cfgs, outs, train_names, held[0]


def test_cli_train_matches_jax(trained):
    """Both CLIs' ``train`` write a .voicedb with the same units: the arrays
    that do not depend on the analysis equal bit for bit (the features are
    held by tests/test_torch_train.py); the port's loads in both packages."""
    from snickery_tpu.voicedb.db import VoiceDB as JaxVoiceDB
    root, cfgs, *_ = trained
    t = VoiceDB.load(str(root / "work_port" / "corpus.voicedb"))
    j = VoiceDB.load(str(root / "work_jax" / "corpus.voicedb"))
    assert t.filenames == j.filenames == ["utt00", "utt01", "utt02"]
    for name in ("cutpoints", "utt_index", "unit_lf0", "waves", "wave_offsets"):
        assert getattr(t, name).tobytes() == getattr(j, name).tobytes(), name
    assert t.unit_features.shape == j.unit_features.shape
    jt = JaxVoiceDB.load(str(root / "work_port" / "corpus.voicedb"), mmap=False)
    assert jt.unit_features.tobytes() == t.unit_features.tobytes()


def test_cli_natural_synth_of_training_utterances(trained):
    """Natural-mode synth of a training utterance: both CLIs write the same
    units.npy, each unit the utterance's own (consecutive ids, except where
    the next unit has a feature-identical twin, as in a stop's silent
    closure, which the search may pick at the same zero cost), and audio
    equal to f32 rounding."""
    root, cfgs, outs, names, _ = trained
    db = VoiceDB.load(str(root / "work_port" / "corpus.voicedb"))
    for u, name in enumerate(names):
        ids_t, ids_j = (np.load(os.path.join(outs[w], f"{name}.units.npy"))
                        for w in ("port", "jax"))
        np.testing.assert_array_equal(ids_t, ids_j)
        assert (db.utt_index[ids_t] == u).all()
        natural = ids_t[0] + np.arange(len(ids_t))
        assert db.unit_features[ids_t].tobytes() == db.unit_features[natural].tobytes()
        assert (ids_t == natural).mean() > 0.8
        (wt, _), (wj, _) = (read_wave(os.path.join(outs[w], f"{name}.wav"))
                            for w in ("port", "jax"))
        assert len(wt) == len(wj) > 1000
        np.testing.assert_allclose(wt, wj, atol=PCM_ATOL)


def test_cli_natural_synth_of_held_out_utterance(trained, jax_native):
    """A held-out wav: each CLI searches its own analysis of it in its own
    voice, so the ids may differ.  Each CLI's path is its own float64
    oracle's (the same preselection and Viterbi in numpy), and in float64
    the port's path is no dearer than that oracle's on the port's voice and
    targets.  (Across voices the paths are not ordered: with 8 candidates a
    target's preselection can leave out a unit of the other voice's path.)"""
    from snickery_tpu import train as jtrain
    from snickery_tpu import config as jconfig
    from snickery_tpu_torch.config import load_config
    from snickery_tpu_torch.synth import Synthesiser
    from snickery_tpu_torch.train import prepare_utterance

    root, cfgs, outs, _, held = trained
    for who in ("port", "jax"):
        cfg = load_config(cfgs[who])
        synth = Synthesiser(cfg, device="cpu")
        feats = (prepare_utterance(cfg, held, device="cpu") if who == "port" else
                 jtrain.prepare_utterance(jconfig.load_config(cfgs[who]), held)).features
        ids = np.load(os.path.join(outs[who], f"{held}.units.npy"))
        ids_o, c_t, c_o = _oracle_path(synth, feats, ids)
        np.testing.assert_array_equal(ids, ids_o)
        if who == "port":
            assert c_t <= c_o * (1 + 1e-12), (c_t, c_o)
    audio, _ = read_wave(os.path.join(outs["port"], f"{held}.wav"))
    assert len(audio) > 1000 and np.isfinite(audio).all()


def _oracle_path(synth, feats, ids):
    """The float64 oracle's ids for ``feats`` on the synthesiser's voice, and
    the float64 costs of ``ids`` and of the oracle's ids."""
    from snickery_tpu_torch import oracle
    db, cfg = synth.db, synth.cfg
    tgt, _ = synth.targets_from_features(feats)
    tw = (((tgt - db.mean_target) / db.std_target) * synth._sqrt_wt).astype(np.float64)
    feats_w = db.normalised_features().astype(np.float32) * synth._sqrt_wt[None, :]
    jl, jr = db.normalised_joins()
    ids_o, _ = oracle.synth_pipeline(
        tw.astype(np.float32), feats_w, (jl * synth._sqrt_wj).astype(np.float32),
        (jr * synth._sqrt_wj).astype(np.float32), n_candidates=cfg.n_candidates,
        join_cost_weight=cfg.join_cost_weight)
    return ids_o, _path_cost64(synth, tw, ids)[0], _path_cost64(synth, tw, ids_o)[0]


# the same wavs through both CLIs' evaluate: MCD, NSIM and the f0 RMSE
# within these tolerances (the port's FFT against the JAX package's matmul
# DFT; the relative -60 dB floor of the MCD analysis clamps the weak bands
# where the two differ most), the voicing and pitch error fractions and the
# join counts equal
REPORT_TOL = {"mcd_db": (1e-4, 1e-3), "nsim": (0.0, 5e-4), "f0_rmse_hz": (0.0, 1e-4),
              "join_flux_ratio": (1e-4, 0.0)}


def _assert_reports_match(got, want):
    assert [r["utterance"] for r in got["utterances"]] == [
        r["utterance"] for r in want["utterances"]]
    assert got["mean"].keys() == want["mean"].keys()
    for g, w in [*zip(got["utterances"], want["utterances"]), (got["mean"], want["mean"])]:
        assert g.keys() == w.keys()
        for k in g:
            if k == "utterance" or g[k] is None or w[k] is None:
                assert g[k] == w[k], k
                continue
            rtol, atol = REPORT_TOL.get(k, (0.0, 0.0))
            assert abs(g[k] - w[k]) <= atol + rtol * abs(w[k]), (k, g[k], w[k])


@pytest.mark.parametrize("extra", [(), ("--legacy-line", "-N", "2"), ("utt01", "zheld00")])
def test_cli_evaluate_matches_jax(trained, tmp_path, capsys, extra):
    """``evaluate`` of the port's natural synth against the reference wavs,
    by both CLIs, with ``-c`` (join flux at non-natural joins): the same
    strict-JSON report to the tolerances above, on stdout and in ``-o``; the
    outputs for the training utterances, being copies, score NSIM > 0.97
    (against the whole wav, not the span the units cover: see
    test_cli_evaluate_scores_copies)."""
    root, cfgs, outs, names, held = trained
    argv = ["evaluate", "-s", outs["port"], "-r", str(root / "wav"), "-c", cfgs["port"], *extra]
    assert jax_cli(argv + ["-o", str(tmp_path / "j.json")]) == 0
    out_j = capsys.readouterr().out
    assert port_cli(argv + ["-o", str(tmp_path / "t.json"), "--device", "cpu"]) == 0
    out_t = capsys.readouterr().out
    got = json.loads((tmp_path / "t.json").read_text())
    want = json.loads((tmp_path / "j.json").read_text())
    _assert_reports_match(got, want)
    lines_t, lines_j = out_t.strip().splitlines(), out_j.strip().splitlines()
    if "--legacy-line" in extra:
        last_t, last_j = json.loads(lines_t[-1]), json.loads(lines_j[-1])
        assert last_t.keys() == last_j.keys() and last_t["n_utterances"] == 2
        assert abs(last_t["value"] - last_j["value"]) <= 1e-3 + 1e-4 * abs(last_j["value"])
        lines_t = lines_t[:-1]
    assert json.loads("\n".join(lines_t)) == got
    expect = {(): names + [held], ("utt01", "zheld00"): ["utt01", held]}.get(extra, names[:2])
    assert [r["utterance"] for r in got["utterances"]] == expect
    for row in got["utterances"]:
        assert all(v is None or np.isfinite(v) for k, v in row.items() if k != "utterance")
        if row["utterance"] in names:
            assert row["nsim"] > 0.97 and row["ffe"] < 0.05, row


def test_cli_evaluate_scores_copies(trained, tmp_path):
    """Natural synthesis of a training utterance is a copy of the corpus span
    its units cover (equal to 16-bit PCM rounding away from the tapered
    edges): against that span, evaluate's MCD is under 0.5 dB (the tapered
    edges) and its NSIM above 0.999, in both CLIs."""
    from snickery_tpu_torch.io.speech import write_wave
    root, cfgs, outs, names, _ = trained
    db = VoiceDB.load(str(root / "work_port" / "corpus.voicedb"))
    (tmp_path / "ref").mkdir()
    for name in names:
        ids = np.load(os.path.join(outs["port"], f"{name}.units.npy"))
        out, _ = read_wave(os.path.join(outs["port"], f"{name}.wav"))
        ref = copy_reference(db, ids, 32, len(out))
        np.testing.assert_allclose(out[64:-64], ref[64:-64], atol=PCM_ATOL)
        write_wave(ref, str(tmp_path / "ref" / f"{name}.wav"), SR)
    argv = ["evaluate", "-s", outs["port"], "-r", str(tmp_path / "ref")]
    assert jax_cli(argv + ["-o", str(tmp_path / "j.json")]) == 0
    assert port_cli(argv + ["-o", str(tmp_path / "t.json"), "--device", "cpu"]) == 0
    got = json.loads((tmp_path / "t.json").read_text())
    _assert_reports_match(got, json.loads((tmp_path / "j.json").read_text()))
    assert [r["utterance"] for r in got["utterances"]] == names
    for row in got["utterances"]:
        assert row["mcd_db"] < 0.5 and row["nsim"] > 0.999 and row["ffe"] == 0.0, row


def test_cli_evaluate_and_train_refusals(trained, tmp_path, monkeypatch):
    """No common basenames: exit 1 in both CLIs; ``train`` and ``evaluate``
    default to the card and raise where CUDA is absent."""
    import torch
    root, cfgs, outs, *_ = trained
    (tmp_path / "empty").mkdir()
    argv = ["evaluate", "-s", str(tmp_path / "empty"), "-r", str(root / "wav")]
    assert jax_cli(argv) == 1
    assert port_cli(argv + ["--device", "cpu"]) == 1
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for args in (["train", "-c", cfgs["port"]],
                 ["evaluate", "-s", outs["port"], "-r", str(root / "wav")],
                 ["synth", "-c", cfgs["port"], "-o", str(tmp_path / "o")]):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            port_cli(args)

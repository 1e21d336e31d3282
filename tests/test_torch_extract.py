"""The port's corpus front end on the CPU against the JAX package's: the
feature extraction (``snickery_tpu_torch.extract`` against
``scripts/extract_magphase_features.py``, both run in process on the same
wavs of tests/toycorpus.py) and the corpus-prep bench.

Both extractors write the same tree: the same relative paths, byte-equal
pitchmark files (the same native detector: the JAX side's is held native by
tests/jaxnative.py), epoch-rate streams held by rules (a) and (b) of
tests/analysis64.py against a float64 analysis of the same frames (lf0
exactly), and fixed-rate files equal bit for bit to the JAX resampler applied
to the port's own epoch-rate stream.  A voice trained from an extracted tree
is held to the voice of the other package on that tree, and to the port's
voice trained from the wavs.
"""

import functools
import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from snickery_tpu import config as jconfig
from snickery_tpu import train as jtrain
from snickery_tpu.features.world import resample_to_fixed as jax_resample_to_fixed
from snickery_tpu_torch import bench_corpus_prep, extract
from snickery_tpu_torch import config as tconfig
from snickery_tpu_torch import train as ttrain
from snickery_tpu_torch.io.est import read_est_pitchmarks
from snickery_tpu_torch.io.speech import get_speech, read_wave, write_wave
from tests import analysis64 as a64
from tests.jaxnative import jax_native  # noqa: F401
from tests.toycorpus import write_config, write_corpus
from tests.toyvoice import SR, synth_utterance

ROOT = Path(__file__).resolve().parents[1]
PORT_F64_ATOL = 1e-4
FRAMESHIFT = 0.005
DIMS = {"mag": 60, "real": 45, "imag": 45, "lf0": 1, "mgc": 60, "bap": 5}
# the streams of a run, its extra flags, and the stream dims those flags set
RUNS = {
    "default": ([], {}),
    "all_fixed": (["--streams", "mag,real,imag,lf0,mgc,bap", "--fixed-frameshift",
                   str(FRAMESHIFT)], {}),
    "world_dims": (["--streams", "mgc,bap", "--dim-mgc", "24", "--dim-bap", "3"],
                   {"mgc": 24, "bap": 3}),
    "narrow_magphase": (["--streams", "lf0,mag,imag", "-m", "40", "-p", "30"],
                        {"mag": 40, "imag": 30}),
}
# the voice's epoch arrays and features: equal bit for bit where both voices
# read the same files
VOICE_ARRAYS = ("cutpoints", "utt_index", "unit_pos", "unit_code", "context_codes", "voice_ids",
                "unit_lf0", "waves", "wave_offsets", "unit_features", "join_left", "join_right",
                "mean_target", "std_target", "mean_join", "std_join")
VOICE_META = ("sample_rate", "target_representation", "multiepoch", "stream_list", "datadims",
              "filenames", "unit_names", "phone_names", "voice_names", "version")


@functools.lru_cache(maxsize=None)
def jax_script():
    """``scripts/extract_magphase_features.py``, loaded from its path."""
    path = ROOT / "scripts" / "extract_magphase_features.py"
    spec = importlib.util.spec_from_file_location("jax_extract_magphase_features", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def tree(root) -> set[str]:
    """Every directory and file under ``root``, relative to it."""
    out = set()
    for d, dirs, files in os.walk(root):
        rel = os.path.relpath(d, root)
        out |= {os.path.normpath(os.path.join(rel, x)) for x in dirs + files}
    return out


def run_both(wavdir, out_root, *flags):
    """Each extractor on ``wavdir`` into ``out_root/{jax,port}``; returns the
    two exit codes and output directories."""
    outs = {who: str(Path(out_root) / who) for who in ("jax", "port")}
    rc_j = jax_script().main(["-w", str(wavdir), "-o", outs["jax"], *flags])
    rc_t = extract.main(["-w", str(wavdir), "-o", outs["port"], *flags, "--device", "cpu"])
    return (rc_j, rc_t), outs


@pytest.fixture(scope="module")
def corpus(tmp_path_factory, jax_native):
    """Five short wavs of the toy generator, and each run of RUNS by both
    extractors."""
    root = tmp_path_factory.mktemp("torch_extract")
    names = write_corpus(str(root), [300, 301, 302, 303, 304], n_segments=5)
    runs = {}
    for label, (flags, _) in RUNS.items():
        rcs, outs = run_both(root / "wav", root / label, *flags)
        assert rcs == (0, 0), (label, rcs)
        runs[label] = outs
    return root, names, runs


def _streams(label):
    flags, dims = RUNS[label]
    listed = flags[flags.index("--streams") + 1] if "--streams" in flags else "mag,real,imag,lf0"
    return {s: dims.get(s, DIMS[s]) for s in listed.split(",")}


@pytest.mark.parametrize("label", sorted(RUNS))
def test_the_same_tree_and_pitchmarks(corpus, label):
    """(1) the same relative paths; (2) each .pm byte-equal."""
    root, names, runs = corpus
    outs = runs[label]
    paths = tree(outs["port"])
    assert paths == tree(outs["jax"])
    streams = _streams(label)
    want = {"pm"} | {f"pm/{n}.pm" for n in names} | set(streams) | {
        f"{s}/{n}.{s}" for s in streams for n in names}
    if "--fixed-frameshift" in RUNS[label][0]:
        want |= {"fixed"} | {f"fixed/{s}" for s in streams} | {
            f"fixed/{s}/{n}.{s}" for s in streams for n in names}
    assert paths == {os.path.normpath(p) for p in want}
    for n in names:
        pm = f"pm/{n}.pm"
        assert (Path(outs["port"]) / pm).read_bytes() == (Path(outs["jax"]) / pm).read_bytes()


@pytest.mark.parametrize("label", sorted(RUNS))
def test_epoch_rate_streams_by_the_rules(corpus, label):
    """(3) each epoch-rate stream: mag / real / imag by rule (a) on strong
    bands and rule (b), mgc / bap by rule (b), against a float64 analysis of
    the same frames, and within PORT_F64_ATOL of it; lf0 equal exactly."""
    root, names, runs = corpus
    outs = runs[label]
    streams = _streams(label)
    for n in names:
        wave, sr = read_wave(str(root / "wav" / f"{n}.wav"))
        epochs = read_est_pitchmarks(os.path.join(outs["port"], "pm", f"{n}.pm"), sr)
        truth = {}
        if any(s in ("mag", "real", "imag") for s in streams):
            n_phase = streams.get("real", streams.get("imag", 45))
            truth.update(a64.magphase64(wave, epochs, sr, n_mag=streams.get("mag", 60),
                                        n_phase=n_phase))
        if any(s in ("mgc", "bap") for s in streams):
            truth.update(a64.world64(wave, epochs, sr, n_mgc=streams["mgc"],
                                     n_bap=streams["bap"]))
        for s, d in streams.items():
            got, want = (get_speech(os.path.join(outs[w], s, f"{n}.{s}"), d)
                         for w in ("port", "jax"))
            assert got.shape == want.shape == (len(epochs), d), (s, got.shape)
            if s == "lf0":
                assert got.tobytes() == want.tobytes()
                continue
            if s in ("mag", "real", "imag"):
                strength = truth["mag"] if s == "mag" else truth["strength_ph"]
                a64.rule_a(got, want, a64.strong(strength), truth[s])
            a64.rule_b(got, want, truth[s])
            np.testing.assert_allclose(got, truth[s], atol=PORT_F64_ATOL, err_msg=f"{n} {s}")


def test_fixed_rate_files(corpus):
    """(4) each fixed-rate file is the JAX package's ``resample_to_fixed`` of
    the port's own epoch-rate stream, bit for bit."""
    root, names, runs = corpus
    out = runs["all_fixed"]["port"]
    for n in names:
        epochs = read_est_pitchmarks(os.path.join(out, "pm", f"{n}.pm"), SR)
        for s, d in DIMS.items():
            epoch_rate = get_speech(os.path.join(out, s, f"{n}.{s}"), d)
            fixed = get_speech(os.path.join(out, "fixed", s, f"{n}.{s}"), d)
            want = jax_resample_to_fixed(epoch_rate, epochs, SR, frameshift=FRAMESHIFT)
            assert len(fixed) > len(epoch_rate) // 2
            assert fixed.tobytes() == want.tobytes(), (n, s)


@pytest.mark.parametrize("case", ["unknown_stream", "empty_wavdir", "sample_rate_mismatch",
                                  "max_files"])
def test_refusals_and_limits(corpus, tmp_path, case):
    """(5) the same exit code and the same files written (none where the run
    is refused): an unknown stream, a wav dir with no wavs, a wav at another
    sample rate than ``-s`` (skipped), ``-N``."""
    root, names, _ = corpus
    wavdir, flags = root / "wav", []
    if case == "unknown_stream":
        flags = ["--streams", "mag,f0"]
    elif case == "empty_wavdir":
        wavdir = tmp_path / "nowavs"
        wavdir.mkdir()
        (wavdir / "notes.txt").write_text("no wavs")
    elif case == "sample_rate_mismatch":
        wavdir = tmp_path / "mixed"
        wavdir.mkdir()
        for i, (seed, sr) in enumerate(((310, SR), (311, 8000), (312, SR))):
            write_wave(synth_utterance(seed, n_segments=3)[0], str(wavdir / f"m{i}.wav"), sr)
        flags = ["-s", str(SR)]
    else:
        flags = ["-N", "2"]
    rcs, outs = run_both(wavdir, tmp_path / "out", *flags)
    assert rcs[0] == rcs[1] == (1 if case in ("unknown_stream", "empty_wavdir") else 0)
    paths = tree(outs["port"])
    assert paths == tree(outs["jax"])
    pms = sorted(p for p in paths if p.endswith(".pm"))
    assert pms == {"unknown_stream": [], "empty_wavdir": [],
                   "sample_rate_mismatch": ["pm/m0.pm", "pm/m2.pm"],
                   "max_files": [f"pm/{n}.pm" for n in names[:2]]}[case]
    if rcs[1] == 1:
        assert not os.path.exists(outs["port"])


def test_extract_refuses_a_missing_card(corpus, tmp_path, monkeypatch):
    """``--device cuda`` (the default) raises where CUDA is absent, before
    anything is written: no CPU fallback."""
    import torch
    root, *_ = corpus
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        extract.main(["-w", str(root / "wav"), "-o", str(tmp_path / "out")])
    assert not (tmp_path / "out").exists()


def _voice_configs(root, tmp_path, tree_dir, name):
    """The toy voice's config over the wavs, reading pitchmarks and streams
    from ``tree_dir`` (or analysing the wavs where it is None)."""
    over = dict(workdir=str(tmp_path / "work"), voice_name=name)
    if tree_dir is not None:
        over.update(pm_datadir=os.path.join(tree_dir, "pm"), feat_datadir=str(tree_dir))
    path = write_config(tmp_path / f"{name}.json", str(root), **over)
    return tconfig.load_config(path), jconfig.load_config(path)


def _assert_same_voice(a, b):
    for name in VOICE_META:
        assert getattr(a, name) == getattr(b, name), name
    for name in VOICE_ARRAYS:
        x, y = getattr(a, name), getattr(b, name)
        assert (x is None) == (y is None), name
        if x is not None:
            assert np.asarray(x).tobytes() == np.asarray(y).tobytes(), name


def test_port_train_on_the_jax_tree_equals_the_jax_train(corpus, tmp_path):
    """(7) the port's ``train`` on the tree the JAX script wrote builds the
    voice the JAX ``train`` builds from it: units, cutpoints and features
    equal bit for bit (both read the same files)."""
    root, names, runs = corpus
    tcfg, jcfg = _voice_configs(root, tmp_path, runs["default"]["jax"], "jaxtree")
    tdb = ttrain.train_voice(tcfg, save=False, device="cpu")
    jdb = jtrain.train_voice(jcfg, save=False)
    assert tdb.filenames == names and tdb.n_units > 300
    _assert_same_voice(tdb, jdb)


@pytest.mark.parametrize("label", ["default", "all_fixed"])
def test_port_voice_from_its_tree_equals_its_voice_from_the_wavs(corpus, tmp_path, label):
    """(8) the port's voice trained from its own extracted tree equals, bit
    for bit, the one it trains from the wavs (the same detector and analysis;
    the pitchmarks round-trip through the EST files exactly)."""
    root, names, runs = corpus
    from_tree, _ = _voice_configs(root, tmp_path, runs[label]["port"], "porttree")
    from_wavs, _ = _voice_configs(root, tmp_path, None, "portwavs")
    a = ttrain.train_voice(from_tree, save=False, device="cpu")
    b = ttrain.train_voice(from_wavs, save=False, device="cpu")
    assert a.filenames == names
    _assert_same_voice(a, b)
    for n in names:
        wave, _ = read_wave(str(root / "wav" / f"{n}.wav"))
        ta = ttrain.prepare_utterance(from_tree, n, device="cpu")
        tb = ttrain.prepare_utterance(from_wavs, n, device="cpu")
        assert ta.epochs.tobytes() == tb.epochs.tobytes() and len(ta.epochs) > 50
        assert ta.features.tobytes() == tb.features.tobytes()


def test_bench_corpus_prep_prints_the_four_lines(capsys):
    """A tiny corpus-prep bench on the CPU: exit 0 and the JAX script's four
    line prefixes, in its order, each with a time and an x-realtime rate."""
    assert bench_corpus_prep.main(["--minutes", "0.2", "--python-minutes", "0.1",
                                   "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    prefixes = ("native epoch detector: ", "python epoch detector: ", "magphase analysis: ",
                "world analysis (mgc/bap): ")
    assert len(lines) == 4
    for line, prefix in zip(lines, prefixes):
        assert line.startswith(prefix) and "s audio in " in line and "x realtime" in line, line


def test_bench_corpus_prep_refuses_a_missing_card(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bench_corpus_prep.main(["--minutes", "0.1"])


def test_front_end_runs_with_jax_blocked(corpus, tmp_path):
    """``python -m snickery_tpu_torch.extract`` and ``.bench_corpus_prep``
    run in a process where jax and the JAX package cannot be imported, and
    neither is loaded."""
    root, names, _ = corpus
    code = (
        "import runpy, sys\n"
        "def blocked(name):\n"
        "    return (name in ('jax', 'jaxlib', 'snickery_tpu')\n"
        "            or name.startswith(('jax.', 'jaxlib.', 'snickery_tpu.')))\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if blocked(name):\n"
        "            raise ImportError(f'{name} is blocked')\n"
        "sys.meta_path.insert(0, Block())\n"
        "for argv in (%r, %r):\n"
        "    sys.argv = argv\n"
        "    try:\n"
        "        runpy.run_module(argv[0], run_name='__main__')\n"
        "    except SystemExit as e:\n"
        "        assert e.code == 0, (argv, e.code)\n"
        "assert not any(blocked(m) for m in sys.modules)\n"
    ) % (["snickery_tpu_torch.extract", "-w", str(root / "wav"), "-o", str(tmp_path / "out"),
          "-N", "1", "--device", "cpu"],
         ["snickery_tpu_torch.bench_corpus_prep", "--minutes", "0.1", "--python-minutes",
          "0.1", "--device", "cpu"])
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "magphase analysis: " in res.stdout
    assert tree(tmp_path / "out") == {"pm", "mag", "real", "imag", "lf0", f"pm/{names[0]}.pm"} | {
        f"{s}/{names[0]}.{s}" for s in ("mag", "real", "imag", "lf0")}


def test_chip_smoke_front_end_phase_rehearses_on_the_cpu(tmp_path, monkeypatch, capsys):
    """chip_smoke.py's corpus front-end phase on the CPU at a tiny size (3
    training wavs and the held-out one, 0.2 minutes of bench audio): the
    extract, the voice from its tree against the wav-trained voice, the
    natural-synth ids against the wav-trained voice's and the bench's four
    lines all pass their checks.  (On the CPU no kernel launches, so the
    launch count of the main path is not read here.)"""
    import torch

    import chip_smoke as smoke
    from snickery_tpu_torch import cli
    monkeypatch.setattr(smoke, "VOICE_UTTS", 3)
    monkeypatch.setattr(smoke, "BENCH_MINUTES", 0.2)
    cfg_path = smoke.voice_corpus(str(tmp_path / "voice"))
    smoke.port_module(["snickery_tpu_torch.cli", "train", "-c", cfg_path, "--device", "cpu"],
                      300, "train")
    out = tmp_path / "voice" / "out"
    assert cli.main(["synth", "-c", cfg_path, "-o", str(out), "--dump-units", "--device", "cpu",
                     "utt000", "zheld"]) == 0
    ids, held = (np.load(out / f"{n}.units.npy") for n in ("utt000", "zheld"))
    run = smoke.Run(torch)
    monkeypatch.setattr(run, "main_path", lambda label, kernel, fn: fn())
    monkeypatch.chdir(ROOT)
    smoke.corpus_front_end(run, "cpu", cfg_path, ids, held, device="cpu")
    log = capsys.readouterr().out
    assert "bit-equal to the wav-trained voice" in log
    assert sum(line.startswith("corpus prep (0.2 min, cpu): ") for line in log.splitlines()) == 4

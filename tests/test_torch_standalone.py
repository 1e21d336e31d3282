"""The port stands alone: it imports nothing of the JAX package, and each
module it copied from there (const, utils, config, io, voicedb, oracle, the
host half of the device layout, the epoch detector, the EST pitchmark files,
the native detector's source and loader, the toy speech generator) is held
to its original on the CPU: the same fields and defaults, the same files
loading to equal configs, the same ``.voicedb`` directory read and written
both ways bit for bit, the same arrays from the builder, the merge and the
raw-block layout, the same oracle ids and costs, the same code but for
docstrings and package names, and the same ctypes signatures.
"""

import ast
import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest

from snickery_tpu import config as jconfig
from snickery_tpu import const as jconst
from snickery_tpu import oracle as joracle
from snickery_tpu import utils as jutils
from snickery_tpu.io import labels as jlabels
from snickery_tpu.io import speech as jspeech
from snickery_tpu.voicedb import build as jbuild
from snickery_tpu.voicedb import db as jdb
from snickery_tpu.voicedb import device_layout as jlayout
from snickery_tpu.voicedb import multivoice as jmulti
from snickery_tpu_torch import config as tconfig
from snickery_tpu_torch import const as tconst
from snickery_tpu_torch import oracle as toracle
from snickery_tpu_torch import utils as tutils
from snickery_tpu_torch.io import labels as tlabels
from snickery_tpu_torch.io import speech as tspeech
from snickery_tpu_torch.voicedb import build as tbuild
from snickery_tpu_torch.voicedb import db as tdb
from snickery_tpu_torch.voicedb import device_layout as tlayout
from snickery_tpu_torch.voicedb import multivoice as tmulti
from tests.jaxnative import jax_native  # noqa: F401
from tests.toyvoice import prepare_toy_utts, toy_config

ROOT = Path(__file__).resolve().parents[1]
ARRAYS = ("unit_features", "join_left", "join_right", "cutpoints", "utt_index",
          "unit_pos", "unit_code", "context_codes", "voice_ids", "unit_lf0",
          "mean_target", "std_target", "mean_join", "std_join", "waves", "wave_offsets")
META = ("sample_rate", "target_representation", "multiepoch", "stream_list", "datadims",
        "filenames", "unit_names", "phone_names", "voice_names", "version")


def _forbidden(name: str) -> bool:
    return (name in ("jax", "jaxlib", "snickery_tpu", "bench", "tests")
            or name.startswith(("jax.", "jaxlib.", "snickery_tpu.", "tests.")))


def _port_sources():
    return sorted((ROOT / "snickery_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_port_sources_import_nothing_of_jax_or_the_jax_package():
    """An AST scan of every module of the port and of chip_smoke.py finds no
    import of jax, of snickery_tpu, of the JAX bench (``bench``) or of the
    test helpers (``tests``), at any depth of the file."""
    found = []
    for path in _port_sources():
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            found += [(path.name, n) for n in names if _forbidden(n)]
    assert not found, found


# ------------------------------------------------------------ const, utils
def test_const_values_match():
    names = {n for n in dir(jconst) if n.isupper()}
    assert names == {n for n in dir(tconst) if n.isupper()}
    for n in names:
        assert getattr(tconst, n) == getattr(jconst, n), n


@pytest.mark.parametrize("buckets", [(128, 256, 512), (64,), (2048, 128)])
def test_utils_length_helpers_match(buckets):
    for x in (1, 63, 64, 65, 128, 129, 511, 513, 2047, 5000):
        assert tutils.bucket_length(x, buckets) == jutils.bucket_length(x, buckets)
    for x, m in ((0, 8), (1, 8), (8, 8), (9, 8), (1000, 512), (8192, 4096)):
        assert tutils.next_multiple(x, m) == jutils.next_multiple(x, m)


def test_utils_file_helpers_match(tmp_path):
    for name in ("b.mag", "a.mag", "c.lf0", "d.txt"):
        (tmp_path / name).write_text("x")
    assert tutils.basenames_in(str(tmp_path), "mag") == jutils.basenames_in(str(tmp_path), ".mag")
    assert tutils.basenames_in(str(tmp_path / "none"), "mag") == []
    tutils.writelist(["u1", "u2", ""], str(tmp_path / "list"))
    assert tutils.readlist(str(tmp_path / "list")) == jutils.readlist(str(tmp_path / "list"))
    tutils.dump_json({"b": 1, "a": [2]}, str(tmp_path / "t.json"))
    jutils.dump_json({"b": 1, "a": [2]}, str(tmp_path / "j.json"))
    assert (tmp_path / "t.json").read_text() == (tmp_path / "j.json").read_text()
    assert tutils.load_json(str(tmp_path / "j.json")) == {"a": [2], "b": 1}
    timer = tutils.StageTimer()
    with timer.stage("x"):
        pass
    assert list(timer.report()) == ["x"] and timer.counts == {"x": 1}


# ------------------------------------------------------------------ config
def test_config_fields_and_defaults_match():
    jf = {f.name: f for f in dataclasses.fields(jconfig.SnickeryConfig)}
    tf = {f.name: f for f in dataclasses.fields(tconfig.SnickeryConfig)}
    assert list(jf) == list(tf)
    assert tconfig.SnickeryConfig().to_dict() == jconfig.SnickeryConfig().to_dict()
    assert tconfig._ALIASES == jconfig._ALIASES
    cfg = tconfig.SnickeryConfig(stream_list=["mag", "real", "imag", "lf0"],
                                 datadims={"mag": 60, "real": 45, "imag": 45, "lf0": 1})
    ref = jconfig.SnickeryConfig(stream_list=["mag", "real", "imag", "lf0"],
                                 datadims={"mag": 60, "real": 45, "imag": 45, "lf0": 1})
    assert (cfg.target_dim, cfg.stream_slices, cfg.db_path) == (
        ref.target_dim, ref.stream_slices, ref.db_path)


CONFIG_FILES = {
    # the files of tests/test_config.py, plus TPU-only and alias keys
    "voice.cfg": ("workdir = '/tmp/w'\n"
                  "stream_list = ['mag', 'real', 'imag', 'lf0']\n"
                  "datadims = {'mag': 60, 'real': 45, 'imag': 45, 'lf0': 1}\n"
                  "n_candidates = 50\n"
                  "join_cost_weight = 0.5\n"
                  "target_stream_weights = [1.0, 0.5, 0.5, 2.0]\n"
                  "join_stream_weights = 1.0\n"
                  "multiepoch = 4\n"
                  "wave_datadir = os.path.join(path, 'wav')\n"),
    "voice.json": json.dumps({"voice_name": "slt", "n_candidates": 10, "mesh_db": 2,
                              "use_pallas": "interpret", "zero_transient": 0,
                              "raw_block_layout": "colmajor", "mystery_key": 1}),
    "voice.py": ("import math\n"
                 "n_candidates = int(math.sqrt(64))\n"
                 "preselect_precision = 'split3cat'\n"
                 "length_buckets = [64, 256]\n"
                 "n_candidates_per_unit = 12\n"),
}


@pytest.mark.parametrize("name", sorted(CONFIG_FILES))
def test_config_files_load_equal(tmp_path, name):
    p = tmp_path / name
    p.write_text(CONFIG_FILES[name])
    a, b = tconfig.load_config(str(p)), jconfig.load_config(str(p))
    assert a.to_dict() == b.to_dict()
    assert a._extra.keys() == b._extra.keys()
    if b._extra:
        with pytest.raises(KeyError):
            tconfig.load_config(str(p), strict=True)


@pytest.mark.parametrize("bad", [
    {"target_representation": "diphone"}, {"multiepoch": 0},
    {"target_stream_weights": [1.0, 2.0, 3.0]}, {"join_cost_type": "cubic"},
    {"waves_dtype": "int8"}, {"raw_block_layout": "tiled"},
    {"target_representation": "halfphone", "join_context_frames": 2}])
def test_config_validation_matches(bad):
    with pytest.raises(ValueError) as want:
        jconfig.SnickeryConfig(**bad)
    with pytest.raises(ValueError) as got:
        tconfig.SnickeryConfig(**bad)
    assert str(got.value) == str(want.value)


# ------------------------------------------------------------------- io
def test_labels_match(tmp_path):
    lab = tmp_path / "u.lab"
    lab.write_text("0 1000000 xx^xx-a+b=c@1[2]\n1000000 2000000 xx^xx-a+b=c@1[3]\n"
                   "2000000 3500000 xx^a-b+c=xx@2[2]\n3500000 3500000 a^b-c+xx=xx@3\n"
                   "3500000 5000000 b-c+xx\n")
    a, b = tlabels.read_hts_label(str(lab)), jlabels.read_hts_label(str(lab))
    assert [dataclasses.astuple(s) for s in a] == [dataclasses.astuple(s) for s in b]
    ha, hb = tlabels.halfphone_segments(a), jlabels.halfphone_segments(b)
    assert [dataclasses.astuple(s) for s in ha] == [dataclasses.astuple(s) for s in hb]
    np.testing.assert_array_equal(tlabels.segments_to_sample_bounds(ha, 16000),
                                  jlabels.segments_to_sample_bounds(hb, 16000))


def test_speech_io_match(tmp_path):
    rng = np.random.default_rng(3)
    feats = rng.standard_normal((37, 5)).astype(np.float32)
    tspeech.put_speech(feats, str(tmp_path / "t.mag"))
    np.testing.assert_array_equal(jspeech.get_speech(str(tmp_path / "t.mag"), 5), feats)
    np.testing.assert_array_equal(tspeech.get_speech(str(tmp_path / "t.mag"), 5), feats)
    wave = np.clip(0.4 * rng.standard_normal(4000), -1, 1).astype(np.float32)
    tspeech.write_wave(wave, str(tmp_path / "t.wav"), 16000)
    jspeech.write_wave(wave, str(tmp_path / "j.wav"), 16000)
    assert (tmp_path / "t.wav").read_bytes() == (tmp_path / "j.wav").read_bytes()
    (wt, st), (wj, sj) = tspeech.read_wave(str(tmp_path / "t.wav")), jspeech.read_wave(
        str(tmp_path / "t.wav"))
    assert st == sj == 16000
    np.testing.assert_array_equal(wt, wj)


# --------------------------------------------------------------- voicedb
@pytest.fixture(scope="module")
def toy_utts():
    return {"epoch": prepare_toy_utts(3), "halfphone": prepare_toy_utts(3, halfphone=True)}


def _cfgs(kind):
    over = {"epoch": {}, "halfphone": {"target_representation": "halfphone"},
            "multiepoch2": {"multiepoch": 2},
            "jcf2": {"multiepoch": 2, "join_context_frames": 2}}[kind]
    return (tconfig.config_from_dict(toy_config(**over).to_dict()), toy_config(**over))


def _assert_db_equal(a, b):
    for name in META:
        assert getattr(a, name) == getattr(b, name), name
    for name in ARRAYS:
        x, y = getattr(a, name), getattr(b, name)
        if x is None or y is None:
            assert x is None and y is None, name
            continue
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape, name
        assert x.tobytes() == y.tobytes(), name


@pytest.mark.parametrize("kind", ["epoch", "halfphone", "multiepoch2", "jcf2"])
def test_build_voicedb_bit_equal(toy_utts, kind):
    utts = toy_utts["halfphone" if kind == "halfphone" else "epoch"]
    tc, jc = _cfgs(kind)
    _assert_db_equal(tbuild.build_voicedb(tc, utts), jbuild.build_voicedb(jc, utts))


def test_derive_multiepoch_and_tiled_bit_equal(toy_utts):
    tc, jc = _cfgs("epoch")
    t1, j1 = tbuild.build_voicedb(tc, toy_utts["epoch"]), jbuild.build_voicedb(
        jc, toy_utts["epoch"])
    _assert_db_equal(tbuild.derive_multiepoch(t1, 2), jbuild.derive_multiepoch(j1, 2))
    _assert_db_equal(t1.tiled(3), j1.tiled(3))
    assert t1.summary() == j1.summary()


@pytest.mark.parametrize("kind", ["epoch", "halfphone"])
def test_merge_voicedbs_bit_equal(toy_utts, kind):
    utts = toy_utts[kind]
    tc, jc = _cfgs(kind)
    tdbs = [tbuild.build_voicedb(tc, utts[:2]), tbuild.build_voicedb(tc, utts[1:])]
    jdbs = [jbuild.build_voicedb(jc, utts[:2]), jbuild.build_voicedb(jc, utts[1:])]
    _assert_db_equal(tmulti.merge_voicedbs(tdbs, names=["a", "b"]),
                     jmulti.merge_voicedbs(jdbs, names=["a", "b"]))


@pytest.mark.parametrize("kind", ["epoch", "halfphone", "merged"])
def test_voicedb_save_load_both_directions(toy_utts, tmp_path, kind):
    """A .voicedb the JAX package saved loads in the port bit for bit, and
    one the port saved loads in the JAX package; the files are the same."""
    tc, jc = _cfgs("halfphone" if kind == "halfphone" else "epoch")
    utts = toy_utts["halfphone" if kind == "halfphone" else "epoch"]
    db = jbuild.build_voicedb(jc, utts)
    if kind == "merged":
        db = jmulti.merge_voicedbs([db, jbuild.build_voicedb(jc, utts[:1])], names=["x", "y"])
    db.save(str(tmp_path / "j.voicedb"))
    got = tdb.VoiceDB.load(str(tmp_path / "j.voicedb"))
    _assert_db_equal(got, db)
    got.save(str(tmp_path / "t.voicedb"))
    _assert_db_equal(jdb.VoiceDB.load(str(tmp_path / "t.voicedb"), mmap=False), db)
    files = sorted(p.relative_to(tmp_path / "j.voicedb")
                   for p in (tmp_path / "j.voicedb").rglob("*") if p.is_file())
    for f in files:
        assert (tmp_path / "t.voicedb" / f).read_bytes() == (tmp_path / "j.voicedb" / f).read_bytes(), f


@pytest.mark.parametrize("ndb,affine", [(1, False), (1, True), (2, True), (4, False)])
def test_build_raw_blocks_bit_equal(ndb, affine):
    rng = np.random.default_rng(ndb + 10 * affine)
    m, kd, dj = 1000, 24, 8
    feats = rng.standard_normal((m, kd)).astype(np.float32)
    jr = np.zeros((m, dj), np.float32)
    jr[:-1] = feats[1:, :dj]
    jr[::37] = rng.standard_normal((len(jr[::37]), dj))
    aff = ((0.1 * rng.standard_normal(kd)).astype(np.float32),
           rng.uniform(0.5, 2.0, kd).astype(np.float32),
           rng.uniform(0.2, 1.0, kd).astype(np.float32)) if affine else None
    mp = 1024
    a = tlayout.build_raw_blocks(feats, jr, mp, ndb=ndb, affine=aff)
    b = jlayout.build_raw_blocks(feats, jr, mp, ndb=ndb, affine=aff)
    assert a[1:] == b[1:] and a[0].tobytes() == b[0].tobytes()
    for x, y in zip(tlayout.identity_affine(kd), jlayout.identity_affine(kd)):
        assert x.dtype == y.dtype and np.array_equal(x, y)


# ---------------------------------------------------------------- oracle
@pytest.mark.parametrize("greedy,fast", [(False, False), (False, True), (True, False)])
def test_oracle_matches(toy_utts, greedy, fast):
    """The oracle on a toy voice (held-out-style targets: another
    utterance's frames plus noise), with preselect penalties and the
    lattice mask: the same ids and costs."""
    tc, jc = _cfgs("epoch")
    db = jbuild.build_voicedb(jc, toy_utts["epoch"])
    rng = np.random.default_rng(5)
    feats = db.normalised_features().astype(np.float32)
    jl, jr = (x.astype(np.float32) for x in db.normalised_joins())
    tw = (feats[40:90] + 0.3 * rng.standard_normal((50, feats.shape[1]))).astype(np.float32)
    pen = (rng.random((50, db.n_units)) < 0.2) * 1e4
    kw = dict(n_candidates=8, join_cost_weight=0.7, use_greedy=greedy, extra=pen,
              fast_preselect=fast, lattice_penalty=pen)
    ia, ca = toracle.synth_pipeline(tw, feats, jl, jr, **kw)
    ib, cb = joracle.synth_pipeline(tw, feats, jl, jr, **kw)
    np.testing.assert_array_equal(ia, ib)
    assert ca == cb
    spans = db.cutpoints[ia]
    np.testing.assert_array_equal(
        toracle.overlap_add(db.waves, spans[:, 0], spans[:, 2], 40),
        joracle.overlap_add(db.waves, spans[:, 0], spans[:, 2], 40))


# ------------------------------------- the analysis chain's copied modules
def _code_without_docstrings(path: Path, rename: bool) -> str:
    """The module's AST with every docstring removed (and, with ``rename``,
    ``snickery_tpu_torch`` read as ``snickery_tpu``), dumped."""
    src = path.read_text()
    if rename:
        src = src.replace("snickery_tpu_torch", "snickery_tpu")
    tree = ast.parse(src)
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if (isinstance(body, list) and body and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant)
                and isinstance(body[0].value.value, str)):
            node.body = body[1:] or [ast.Pass()]
    return ast.dump(tree)


@pytest.mark.parametrize("rel", ["features/epochs.py", "io/est.py"])
def test_copied_numpy_modules_equal_their_originals(rel):
    """features/epochs.py and io/est.py are the JAX package's modules with
    only their docstrings and package names changed (est.py's logger is
    named after the port)."""
    port = _code_without_docstrings(ROOT / "snickery_tpu_torch" / rel, rename=True)
    orig = _code_without_docstrings(ROOT / "snickery_tpu" / rel, rename=False)
    assert port == orig


def test_native_source_and_loader_match_the_originals(jax_native):
    """native/epochs.cpp is copied byte for byte; the port's loader binds the
    same three C entry points with the same ctypes signatures, from its own
    build (never the JAX package's library), and its Python entry points
    take the same arguments."""
    import inspect

    from snickery_tpu import native as jnative
    from snickery_tpu_torch import native as tnative
    assert (ROOT / "snickery_tpu_torch" / "native" / "epochs.cpp").read_bytes() == (
        ROOT / "native" / "epochs.cpp").read_bytes()
    for fn in ("native_detect_epochs", "native_detect_epochs_batch", "_max_marks"):
        assert inspect.signature(getattr(tnative, fn)) == inspect.signature(getattr(jnative, fn))
    tlib, jlib = tnative.get_lib(), jnative.get_lib()
    assert tlib is not None and jlib is jax_native
    assert tlib._name != jlib._name and "snickery_tpu_torch_native" in tlib._name
    for sym in ("snickery_detect_epochs", "snickery_detect_epochs_batch",
                "snickery_detect_epochs_batch_mt"):
        t, j = getattr(tlib, sym), getattr(jlib, sym)
        assert (t.restype, t.argtypes) == (j.restype, j.argtypes), sym


@pytest.mark.parametrize("seed,n_segments", [(3, 8), (200, 5), (5000, 40)])
def test_synth_utterance_equals_the_toy_generator(seed, n_segments):
    """The speech-like generator copied into synthetic_voices gives the waves
    and segments of tests/toyvoice.py for the same seed."""
    from snickery_tpu_torch.synthetic_voices import synth_utterance
    from tests.toyvoice import synth_utterance as toy
    (w, s), (wt, st) = synth_utterance(seed, n_segments=n_segments), toy(seed, n_segments)
    assert w.dtype == wt.dtype and w.tobytes() == wt.tobytes()
    assert [dataclasses.astuple(x) for x in s] == [dataclasses.astuple(x) for x in st]


def test_import_scan_covers_the_analysis_chain():
    """The AST scan above reads the modules this slice added."""
    names = {str(p.relative_to(ROOT)) for p in _port_sources()}
    for rel in ("features/dft.py", "features/stft.py", "features/mel.py",
                "features/magphase.py", "features/world.py", "features/smoothing.py",
                "features/epochs.py", "io/est.py", "native/__init__.py", "train.py",
                "evaluate.py", "synthetic_voices.py", "cli.py"):
        assert f"snickery_tpu_torch/{rel}" in names, rel


def test_import_scan_covers_the_parallel_package():
    """The AST scan above reads the mesh modules (parallel/), which import
    torch and the port only."""
    names = {str(p.relative_to(ROOT)) for p in _port_sources()}
    for rel in ("__init__.py", "mesh.py", "sharded.py", "dryrun.py"):
        assert f"snickery_tpu_torch/parallel/{rel}" in names, rel


def test_import_scan_covers_the_corpus_front_end():
    """The AST scan above reads the feature extraction and the
    corpus-prep bench."""
    names = {str(p.relative_to(ROOT)) for p in _port_sources()}
    for rel in ("extract.py", "bench_corpus_prep.py"):
        assert f"snickery_tpu_torch/{rel}" in names, rel


def test_version_equals_the_jax_packages():
    import snickery_tpu
    import snickery_tpu_torch
    assert snickery_tpu_torch.__version__ == snickery_tpu.__version__
    assert "__version__" in snickery_tpu_torch.__all__


def test_pyproject_lists_every_package_of_the_port():
    """Every directory of snickery_tpu_torch/ that holds an ``__init__.py``
    is a package of the wheel (``[tool.setuptools] packages``)."""
    import tomllib
    with open(ROOT / "pyproject.toml", "rb") as f:
        packages = set(tomllib.load(f)["tool"]["setuptools"]["packages"])
    port = ROOT / "snickery_tpu_torch"
    found = {".".join(p.parent.relative_to(ROOT).parts) for p in port.rglob("__init__.py")}
    assert "snickery_tpu_torch.parallel" in found
    assert found <= packages, sorted(found - packages)

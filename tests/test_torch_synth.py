"""The ported slice end to end: ``snickery_tpu_torch.Synthesiser`` on the CPU
(the preselect kernel's plain twin) vs the JAX ``Synthesiser`` and the
float64 oracle, on the tests/toyvoice.py epoch voice.

Costs: the JAX Viterbi sums join distances through the
``|r|^2 + |l|^2 - 2 r.l`` identity, whose f32 cancellation leaves up to a few
1e-3 on every join, natural joins included (a zero-cost natural path comes
out at ~0.2); the port sums the differences.  So the port's total cost is
held to the float64 path cost of its own ids (rtol 1e-5), and the JAX cost to
the port's within that cancellation bound.
"""

import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from snickery_tpu import oracle
from snickery_tpu.synth import Synthesiser as JaxSynthesiser
from snickery_tpu.voicedb.multivoice import merge_voicedbs
from snickery_tpu_torch.synth import (JAX_FIELDS, DeviceDB, Synthesiser,
                                      device_db_from_numpy)
from tests.toyvoice import build_toy_voice, prepare_toy_utts, toy_config

F32_EPS = float(np.finfo(np.float32).eps)


@pytest.fixture(scope="module")
def voices():
    cfg, db, utts = build_toy_voice(halfphone=False, multiepoch=1)
    held = prepare_toy_utts(1, seed0=900)[0]
    return cfg, db, utts, held, JaxSynthesiser(cfg, db=db), Synthesiser(cfg, db, device="cpu")


def _weighted(synth, db, ids):
    fw = ((db.unit_features[ids] - db.mean_target) / db.std_target) * synth._sqrt_wt
    jl = ((db.join_left[ids] - db.mean_join) / db.std_join) * synth._sqrt_wj
    jr = ((db.join_right[ids] - db.mean_join) / db.std_join) * synth._sqrt_wj
    return fw, jl, jr


def _check_costs(cfg, db, synth, feats, ids, c_port, c_jax):
    tgt, _ = synth.targets_from_features(feats)
    tw = ((tgt - db.mean_target) / db.std_target) * synth._sqrt_wt
    fw, jl, jr = (a.astype(np.float64) for a in _weighted(synth, db, ids))
    jcw = cfg.join_cost_weight
    c64 = (np.sqrt(((fw - tw) ** 2).sum(-1)).sum()
           + jcw * np.sqrt(((jl[1:] - jr[:-1]) ** 2).sum(-1)).sum())
    np.testing.assert_allclose(c_port, c64, rtol=1e-5, atol=1e-4)
    # per join: sqrt of a few ulp of |r|^2 + |l|^2 (the identity's cancellation)
    noise = jcw * np.sqrt(16 * F32_EPS * ((jl[1:] ** 2).sum(-1)
                                          + (jr[:-1] ** 2).sum(-1))).sum()
    assert abs(c_jax - c_port) <= 1e-5 * abs(c_port) + noise, (c_jax, c_port, noise)


def _assert_same(cfg, db, ts, a, b, feats):
    np.testing.assert_array_equal(b["unit_ids"], a["unit_ids"])
    assert b["n_units"] == a["n_units"]
    assert len(b["wave"]) == len(a["wave"])
    np.testing.assert_allclose(b["wave"], a["wave"], atol=1e-5)
    _check_costs(cfg, db, ts, feats, b["unit_ids"], b["total_cost"], a["total_cost"])


def _voice_db(kind):
    if kind == "merged":
        cfg, db_b, _ = build_toy_voice(halfphone=True, n_utts=2)
        _, db_c, _ = build_toy_voice(halfphone=True, n_utts=3)
        return (dataclasses.replace(cfg, n_candidates=6),
                merge_voicedbs([db_b, db_c], names=["b", "c"]))
    cfg, db, _ = build_toy_voice(halfphone=kind == "halfphone", multiepoch=1)
    return cfg, db


@pytest.mark.parametrize("kind", ["epoch", "halfphone", "merged"])
def test_device_db_from_jax_matches_prepare(voices, kind):
    """The JAX DeviceDB's fields, fetched to numpy, make a port DeviceDB
    equal bit for bit to the port's own _prepare_device_db (the derived
    kernel metadata included), for epoch, halfphone and merged voices."""
    if kind == "epoch":
        js, ts = voices[-2], voices[-1]
    else:
        cfg, db = _voice_db(kind)
        js, ts = JaxSynthesiser(cfg, db=db), Synthesiser(cfg, db, device="cpu")
    assert ts.n_units_padded == js.n_units_padded
    arrays = {f: np.asarray(getattr(js.device_db, f)) for f in JAX_FIELDS}
    got = device_db_from_numpy(arrays, "cpu")
    for f in DeviceDB.__dataclass_fields__:
        a, b = getattr(got, f), getattr(ts.device_db, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        bits = (lambda t: t.reshape(-1).view(torch.int32)
                if t.dtype == torch.float32 else t)
        assert torch.equal(bits(a), bits(b)), f
    meta = ts.device_db.meta
    assert torch.equal(meta[:, 0], got.codes) and torch.equal(meta[:, 6], got.vids)
    assert torch.equal(meta[:, 1:6], got.ctx) and not meta[:, 7].any()


@pytest.mark.parametrize("which", ["natural", "held_out"])
def test_synth_from_features_matches_jax(voices, which):
    cfg, db, utts, held, js, ts = voices
    feats = utts[0].features if which == "natural" else held.features
    a, b = js.synth_from_features(feats), ts.synth_from_features(feats)
    _assert_same(cfg, db, ts, a, b, feats)
    if which == "natural":
        assert b["total_cost"] == 0.0, "the natural path must cost exactly 0"


def test_synth_batch_matches_jax_and_single(voices):
    cfg, db, utts, held, js, ts = voices
    feats = [utts[0].features, utts[1].features, held.features]
    for a, b, f in zip(js.synth_batch(feats), ts.synth_batch(feats), feats):
        _assert_same(cfg, db, ts, a, b, f)
        single = ts.synth_from_features(f)
        np.testing.assert_array_equal(b["unit_ids"], single["unit_ids"])
        np.testing.assert_allclose(b["wave"], single["wave"], atol=1e-6)


def test_greedy_matches_jax(voices):
    cfg, db, utts, held, js, ts = voices
    a = js.synth_from_features(held.features, greedy=True)
    b = ts.synth_from_features(held.features, greedy=True)
    np.testing.assert_array_equal(b["unit_ids"], a["unit_ids"])
    np.testing.assert_allclose(b["wave"], a["wave"], atol=1e-5)
    np.testing.assert_allclose(b["total_cost"], a["total_cost"], rtol=1e-5)


def test_matches_jax_pallas_interpret(voices):
    """Against the JAX pipeline through the real Pallas kernel (interpret
    mode): the same zero-transient preselect with the same rank margin."""
    cfg, db, utts, held, _, ts = voices
    js = JaxSynthesiser(toy_config(use_pallas="interpret"), db=db)
    for feats in (utts[0].features, held.features):
        _assert_same(cfg, db, ts, js.synth_from_features(feats),
                     ts.synth_from_features(feats), feats)


def test_int16_waves_match_jax(voices):
    cfg16 = toy_config(waves_dtype="int16")
    cfg, db, utts, held, _, _ = voices
    a = JaxSynthesiser(cfg16, db=db).synth_from_features(held.features)
    b = Synthesiser(cfg16, db, device="cpu").synth_from_features(held.features)
    np.testing.assert_array_equal(b["unit_ids"], a["unit_ids"])
    np.testing.assert_allclose(b["wave"], a["wave"], atol=1e-5)


def test_agreement_vs_oracle(voices):
    """Held-out target (seed 900, not in the DB) vs the float64 oracle."""
    cfg, db, utts, held, js, ts = voices
    ids = ts.synth_from_features(held.features)["unit_ids"]
    tgt, _ = ts.targets_from_features(held.features)
    tw = (((tgt - db.mean_target) / db.std_target) * ts._sqrt_wt).astype(np.float32)
    feats = db.normalised_features().astype(np.float32) * ts._sqrt_wt[None, :]
    jl, jr = db.normalised_joins()
    ids_ref, _ = oracle.synth_pipeline(
        tw, feats, (jl * ts._sqrt_wj).astype(np.float32),
        (jr * ts._sqrt_wj).astype(np.float32),
        n_candidates=min(cfg.n_candidates, ts.n_units_padded),
        join_cost_weight=cfg.join_cost_weight)
    assert (ids == ids_ref).mean() >= 0.99


def test_cuda_device_raises_without_cuda(voices, monkeypatch):
    cfg, db, *_ = voices
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Synthesiser(cfg, db)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Synthesiser(cfg, db, device="cuda")


@pytest.mark.parametrize("method", ["quinphone", "quinphone_backoff"])
def test_linguistic_preselection_needs_halfphone_voice(voices, method):
    """A linguistic preselection_method on an epoch voice is a ValueError,
    in the port as in the JAX package."""
    _, db, *_ = voices
    for synth in (JaxSynthesiser, lambda c, db: Synthesiser(c, db, device="cpu")):
        with pytest.raises(ValueError, match="needs a halfphone voice"):
            synth(toy_config(preselection_method=method), db=db)


def test_unported_entry_points_raise(voices):
    """Streaming a halfphone voice is refused, as the JAX package refuses
    it."""
    cfg, db = _voice_db("halfphone")
    with pytest.raises(NotImplementedError, match="epoch-mode only"):
        next(Synthesiser(cfg, db, device="cpu").synth_streaming(iter([])))


@pytest.fixture(scope="module")
def held_ids(voices):
    """The ids both synthesisers pick for the held-out target (non-natural
    joins, so that join smoothing has work to do)."""
    cfg, db, utts, held, js, ts = voices
    ids = ts.synth_from_features(held.features)["unit_ids"]
    np.testing.assert_array_equal(ids, js.synth_from_features(held.features)["unit_ids"])
    return ids, held.lf0[: len(ids) * ts.frames_per_unit]


def test_selected_features_match_jax(voices, held_ids):
    *_, js, ts = voices
    ids, _ = held_ids
    got = ts.selected_features(ids)
    assert got.tobytes() == js.selected_features(ids).tobytes()
    assert got.shape == (len(ids) * ts.frames_per_unit, ts.cfg.target_dim)


@pytest.mark.parametrize("over,target_f0", [
    ({}, False), ({"magphase_smooth_joins": 2}, False), ({"magphase_overlap": 1}, False),
    ({}, True), ({"magphase_use_target_f0": False}, True),
    ({"magphase_smooth_joins": 3, "magphase_overlap": 2}, True)])
def test_resynth_magphase_matches_jax(voices, held_ids, monkeypatch, over, target_f0):
    """The same ids through both packages' magphase resynthesis (join
    smoothing, target f0, overlap): the waves agree to f32 rounding of the
    transforms (1e-4 of the peak), as tests/test_torch_features.py holds
    magphase_synthesis."""
    *_, js, ts = voices
    ids, lf0 = held_ids
    for synth in (js, ts):
        for key, val in over.items():
            monkeypatch.setattr(synth.cfg, key, val)
    kw = {"target_lf0": lf0} if target_f0 else {}
    got, want = ts.resynth_magphase(ids, **kw), js.resynth_magphase(ids, **kw)
    assert got.dtype == np.float32 and got.shape == want.shape and len(got) > 1000
    np.testing.assert_allclose(got, want, atol=1e-4 * np.abs(want).max())
    if over.get("magphase_smooth_joins"):
        monkeypatch.setattr(ts.cfg, "magphase_smooth_joins", 0)
        plain = ts.resynth_magphase(ids, **kw)
        assert plain.shape != got.shape or np.abs(plain - got).max() > 1e-3


def test_resynth_magphase_needs_magphase_streams(voices, monkeypatch):
    """Streams without mag / real / imag cannot be resynthesised, in either
    package."""
    *_, js, ts = voices
    for synth in (js, ts):
        monkeypatch.setattr(synth.cfg, "stream_list", ["mgc", "lf0"])
        monkeypatch.setattr(synth.cfg, "datadims", {"mgc": 150, "lf0": 1})
        with pytest.raises(ValueError, match="mag/real/imag"):
            synth.resynth_magphase(np.arange(4))


def test_port_imports_without_jax():
    """Every module of the port, and chip_smoke.py, imports with jax and the
    JAX package (snickery_tpu) blocked, and neither ends up loaded."""
    pkg = Path(__file__).resolve().parents[1] / "snickery_tpu_torch"
    modules = sorted("snickery_tpu_torch." + ".".join(p.relative_to(pkg).with_suffix("").parts)
                     for p in pkg.rglob("*.py") if p.name != "__init__.py")
    for p in pkg.rglob("*.py"):
        assert "import jax" not in p.read_text(), p
    code = (
        "import sys\n"
        "def blocked(name):\n"
        "    return (name in ('jax', 'jaxlib', 'snickery_tpu')\n"
        "            or name.startswith(('jax.', 'jaxlib.', 'snickery_tpu.')))\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if blocked(name):\n"
        "            raise ImportError(f'{name} is blocked')\n"
        "sys.meta_path.insert(0, Block())\n"
        "import importlib, snickery_tpu_torch\n"
        f"for m in {modules!r}: importlib.import_module(m)\n"
        "snickery_tpu_torch.Synthesiser\n"
        "import chip_smoke\n"
        "assert not any(blocked(m) for m in sys.modules), sorted(m for m in sys.modules if blocked(m))\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=pkg.parent)
    assert res.returncode == 0, res.stderr

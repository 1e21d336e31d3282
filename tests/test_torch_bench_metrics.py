"""The port's bench corpus and metrics against ``bench.py``'s, on the CPU.

- ``agreement_metrics`` (raw, tie-adjusted agreement, f64 path-cost gap)
  equals ``bench.agreement_metrics`` on the cases of
  tests/test_bench_metrics.py;
- ``gen_utterance`` waves are bit-equal to ``bench.gen_utterance``'s;
- ``make_corpus`` gives the JAX bench's waves, epochs (both native
  detectors: the JAX one through tests/jaxnative.py's private build), lf0
  and halfphone labels exactly, and its features hold to the JAX bench's
  by the rules of tests/analysis64.py, as tests/test_torch_features.py
  holds the analysis;
- the grouped analysis (``bulk_analyse``) equals the port's per-utterance
  ``magphase_analysis`` bit for bit on every row where a group holds one
  utterance, and on all but each utterance's first and last row where it
  holds several (those two windows reach the neighbouring utterance, in
  ``bench.py``'s grouping too); those rows hold to the float64 analysis of
  the group's frames.
"""

import dataclasses
import types

import numpy as np
import pytest
import torch

import bench as jbench
from snickery_tpu_torch import bench as tbench
from snickery_tpu_torch.features.magphase import magphase_analysis
from tests import analysis64 as a64
from tests.jaxnative import jax_native  # noqa: F401

PORT_F64_ATOL = 1e-4      # the port's analysis against the float64 one (as in test_torch_features)


@pytest.fixture
def on_cpu(monkeypatch):
    monkeypatch.setitem(tbench._STATE, "device", torch.device("cpu"))


def _fixture(seed=5, m=64, d=6):
    """tests/test_bench_metrics.py's voice: unit 10 a bit-identical duplicate
    of unit 3 (features and both contexts), unit 20 sharing only unit 4's
    feature row."""
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((m, d)).astype(np.float32)
    jl = rng.standard_normal((m, d)).astype(np.float32)
    jr = rng.standard_normal((m, d)).astype(np.float32)
    feats[10], jl[10], jr[10] = feats[3], jl[3], jr[3]
    feats[20] = feats[4]
    db = types.SimpleNamespace(
        unit_features=feats, join_left=jl, join_right=jr,
        mean_target=np.zeros(d, np.float32), std_target=np.ones(d, np.float32),
        mean_join=np.zeros(d, np.float32), std_join=np.ones(d, np.float32))
    synth = types.SimpleNamespace(_sqrt_wt=np.ones(d, np.float32),
                                  _sqrt_wj=np.ones(d, np.float32))
    return db, synth, rng


def _case(name):
    db, synth, rng = _fixture()
    if name == "identical":
        ids = rng.integers(0, 64, 12).astype(np.int32)
        return ids, ids.copy(), rng.standard_normal((12, 6)).astype(np.float32), db, synth
    if name == "duplicate_swap":
        return (np.array([1, 10, 7, 9], np.int32), np.array([1, 3, 7, 9], np.int32),
                rng.standard_normal((4, 6)).astype(np.float32), db, synth)
    if name == "feature_only_duplicate":
        return (np.array([1, 20, 7, 9], np.int32), np.array([1, 4, 7, 9], np.int32),
                rng.standard_normal((4, 6)).astype(np.float32), db, synth)
    tw = db.unit_features[np.array([2, 5, 8])].copy()
    return np.array([2, 6, 8], np.int32), np.array([2, 5, 8], np.int32), tw, db, synth


@pytest.mark.parametrize("name", ["identical", "duplicate_swap", "feature_only_duplicate",
                                  "worse_sequence"])
def test_agreement_metrics_equal_the_jax_benchs(name):
    ids_dev, ids_ref, tw, db, synth = _case(name)
    got = tbench.agreement_metrics(ids_dev, ids_ref, tw, db, synth, 0.5)
    want = jbench.agreement_metrics(ids_dev, ids_ref, tw, db, synth, 0.5)
    assert got == want
    raw, adj, gap = got
    expected = {"identical": (1.0, 1.0), "duplicate_swap": (0.75, 1.0),
                "feature_only_duplicate": (0.75, 0.75), "worse_sequence": (2 / 3, 2 / 3)}[name]
    assert (raw, adj) == pytest.approx(expected)
    if name == "worse_sequence":
        assert gap > 0.0
    elif name == "feature_only_duplicate":
        assert gap != 0.0
    else:
        assert abs(gap) < 1e-12


@pytest.mark.parametrize("seed,n_segments", [(10_000, 40), (90_000, 16), (91_003, 3)])
def test_gen_utterance_bit_equal(seed, n_segments):
    w_t, segs_t = tbench.gen_utterance(seed, n_segments)
    w_j, segs_j = jbench.gen_utterance(seed, n_segments)
    assert w_t.dtype == w_j.dtype and w_t.tobytes() == w_j.tobytes()
    assert [dataclasses.astuple(s) for s in segs_t] == [dataclasses.astuple(s) for s in segs_j]


def _grouped64(waves, eps):
    """The float64 analysis of the frames ``bulk_analyse`` analyses when all
    ``waves`` fall in one group: the waves joined with 2,048-sample gaps,
    the epochs offset; the rows split back per utterance."""
    segs, offs, off = [], [], 0
    for w in waves:
        segs += [np.asarray(w, np.float32), np.zeros(2048, np.float32)]
        offs.append(off)
        off += len(w) + 2048
    big_e = np.concatenate([np.asarray(e, np.int64) + o for e, o in zip(eps, offs)])
    truth = a64.magphase64(np.concatenate(segs), big_e, tbench.SR)
    bounds = np.cumsum([0] + [len(e) for e in eps])
    return [{k: v[a:b] for k, v in truth.items()} for a, b in zip(bounds[:-1], bounds[1:])]


def test_make_corpus_matches_the_jax_benchs(on_cpu, jax_native):
    """Three utterances of five segments (one analysis group): waves, native
    epochs, lf0 and labels exactly; mag / real / imag by rules (a) and (b)
    against the float64 analysis of the group's frames, and within
    ``PORT_F64_ATOL`` of it."""
    got = tbench.make_corpus(3, 5, 10_000, True)
    want = jbench.make_corpus(3, 5, 10_000, True)
    assert len(got) == len(want) == 3
    truths = _grouped64([g.wave for g in got], [g.epochs for g in got])
    for g, w, truth in zip(got, want, truths):
        assert g.basename == w.basename
        assert g.wave.tobytes() == w.wave.tobytes()
        np.testing.assert_array_equal(g.epochs, w.epochs)
        assert g.epochs.dtype == w.epochs.dtype
        np.testing.assert_array_equal(g.lf0, w.lf0)
        np.testing.assert_array_equal(g.features[:, -1], w.features[:, -1])
        assert ([dataclasses.astuple(s) for s in g.halfphones]
                == [dataclasses.astuple(s) for s in w.halfphones])
        assert g.features.shape == w.features.shape and g.features.dtype == np.float32
        cols = {"mag": slice(0, 60), "real": slice(60, 105), "imag": slice(105, 150)}
        for k, c in cols.items():
            mask = a64.strong(truth["mag"] if k == "mag" else truth["strength_ph"])
            a64.rule_a(g.features[:, c], w.features[:, c], mask, truth[k])
            a64.rule_b(g.features[:, c], w.features[:, c], truth[k])
            np.testing.assert_allclose(g.features[:, c], truth[k], atol=PORT_F64_ATOL, err_msg=k)


@pytest.mark.parametrize("group", ["one_group", "uneven_groups"])
def test_bulk_analyse_matches_per_utterance(on_cpu, group):
    """The grouped, uniformly padded analysis gives every row but an
    utterance's first and last bit for bit as the utterance's own
    ``magphase_analysis`` does, and all of them where a group holds one
    utterance (the case of tests/test_bench_metrics.py::
    test_bulk_analyse_matches_per_utterance); in one group the first and
    last rows hold to the float64 analysis of the group's frames."""
    from snickery_tpu_torch.features.epochs import detect_epochs
    waves = [tbench.gen_utterance(800 + i, 3)[0] for i in range(4)]
    eps = [detect_epochs(w, tbench.SR, use_native=False) for w in waves]
    one = group == "one_group"
    got = tbench.bulk_analyse(waves, eps, **({} if one else
                                             {"group_epochs": max(len(e) for e in eps) + 1}))
    truths = _grouped64(waves, eps)
    for w, e, f, truth in zip(waves, eps, got, truths):
        s = magphase_analysis(w, e, tbench.SR, n_mag=60, n_phase=45, device="cpu")
        want = np.concatenate([s["mag"], s["real"], s["imag"], s["lf0"]], axis=1)
        assert f.shape == want.shape and f.dtype == np.float32
        rows = slice(1, -1) if one else slice(None)
        np.testing.assert_array_equal(f[rows], want.astype(np.float32)[rows])
        if one:
            for k, c in (("mag", slice(0, 60)), ("real", slice(60, 105)),
                         ("imag", slice(105, 150))):
                np.testing.assert_allclose(f[[0, -1], c], truth[k][[0, -1]],
                                           atol=PORT_F64_ATOL, err_msg=k)
    assert tbench.bulk_analyse([], []) == []

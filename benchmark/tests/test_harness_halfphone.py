"""The ``halfphone`` unit kind and its reference on the CPU at tiny sizes:
the kind's phones are the generator's own draws; the reference's frozen
unit-cutting rule gives the port's ``build_voicedb`` halfphone units bit for
bit; its search gives the port's float64 oracle's ids and totals (with the
penalties the oracle's callers pass); a tiny halfphone cell runs correct
through ``run.py``, traced and untraced, with its readers; the control comes
out not correct; and the cell's readers count what their docstrings say."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import control, registry, speech, voices
from benchmark import run as harness
from benchmark.reference import halfphone as ref_hp
from benchmark.tests import tiny

SEED = 2 ** 31 + 41
SR = 16000
DATA = {"voices": 1, "utterances_per_voice": 40, "segments": 8, "seg_sec": 0.15,
        "sample_rate": SR}
SYNTH = {**tiny.SYNTH, "target_representation": "halfphone", "n_candidates": 4,
         "quinphone_context_weights": [1.0, 10.0, 0.0, 10.0, 1.0],
         "quinphone_penalty_scale": 100.0, "length_buckets": [16, 32]}
CONFIG = {"name": "tinyhp", "units": "halfphone", "data": DATA, "synth": SYNTH}
MIX = {"entry": "synth_batch", "loop": "closed", "batch": 4, "pool": 6, "pool_segments": 10,
       "epochs": {"median": 14, "sigma": 0.25, "min": 8, "max": 20}, "greedy": False,
       "sample": 3}
HP_METRICS = ("preselect_roofline.hp_batch", "step_roofline.hp_batch", "ling_ms.hp_batch",
              "pad_ms.hp_batch")
WEIGHTS = (1.0, 10.0, 0.0, 10.0, 1.0, 100.0)


def _kind():
    return registry.load_module(tiny.REPO / "benchmark/units/halfphone.py", "hp_kind_bench")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """The tiny root with the cell ``tinyhp.hp``: the tiny limits, and the
    halfphone cell's readers listed for it."""
    r = tiny.make_root(tmp_path_factory.mktemp("hp"))
    bench = r / "benchmark"
    (bench / "configs/tinyhp.json").write_text(json.dumps(CONFIG))
    (bench / "traffic/hp.json").write_text(json.dumps(MIX))
    (bench / "limits/tinyhp.hp.json").write_text(json.dumps(tiny.LIMITS))
    doc = json.loads((r / "BENCHMARK.json").read_text())
    doc["configs"].append({"name": "tinyhp", "source": "t", "reduced": [], "why": "t",
                           "file": "benchmark/configs/tinyhp.json"})
    doc["workloads"].append({"name": "tinyhp.hp", "config": "tinyhp", "traffic": "hp",
                             "chips": 1, "why": "t"})
    doc["end_to_end"][0]["workloads"].append("tinyhp.hp")
    real = json.loads((tiny.REPO / "BENCHMARK.json").read_text())
    doc["per_layer"] += [{**m, "workloads": ["tinyhp.hp"]} for m in real["per_layer"]
                         if m["name"] in HP_METRICS]
    (r / "BENCHMARK.json").write_text(json.dumps(doc))
    return r


@pytest.fixture(scope="module")
def labelled():
    kind = _kind()
    utts = kind._labelled(16, 8, voices.sub_seed(5, "voice", 0), "cpu", DATA)
    return kind, utts


def test_the_phones_are_the_generators_own_draws():
    kind = _kind()
    n, S, seed = 3, 5, 77
    utts = voices.utterances(n, S, seed, "cpu")
    phones = kind.phone_draws(n, S, seed, "cpu", 0.15)
    gen = torch.Generator().manual_seed(seed)
    p, f0, noise = speech.draw(gen, n, S)
    assert np.array_equal(phones, p.numpy())
    waves, _ = speech.render(torch.from_numpy(phones), f0, noise)
    assert all(np.array_equal(w, u["wave"]) for w, u in zip(waves.numpy(), utts))
    labs = kind.labels(phones[0], 0.15)
    assert [lab[2] for lab in labs[:2]] == [f"{speech.PHONES[phones[0][0]]}_{h}" for h in "LR"]
    assert labs[0][5][:2] == ("xx", "xx") and labs[-1][5][3:] == ("xx", "xx")
    assert labs[1][1] == labs[2][0] == pytest.approx(0.15)


def test_the_frozen_cutting_rule_is_the_builders_bit_for_bit(labelled):
    from snickery_tpu_torch.config import SnickeryConfig
    from snickery_tpu_torch.voicedb.build import UtteranceData, build_voicedb

    kind, utts = labelled
    # an utterance cut short: its last labels lie past its epochs
    short = {**utts[1], "epochs": utts[1]["epochs"][:60], "features": utts[1]["features"][:60]}
    utts = [utts[0], short] + utts[2:]
    db = build_voicedb(SnickeryConfig(**SYNTH), [
        UtteranceData(basename=f"u{i}", wave=u["wave"], epochs=np.asarray(u["epochs"], np.int32),
                      features=u["features"], lf0=np.ascontiguousarray(u["features"][:, -1]),
                      halfphones=kind._segments(u["labels"])) for i, u in enumerate(utts)])
    v = ref_hp.build(utts, SYNTH["datadims"], SYNTH["stream_list"], [1.0] * 4, [1.0] * 4, SR,
                     "cpu")
    assert len(ref_hp.frames(short["labels"], short["epochs"], 60, SR)[0]) < len(short["labels"])
    assert np.array_equal(v.feats, db.unit_features)
    assert np.array_equal(v.jr, db.join_right)
    assert np.array_equal(v.feats[:, :151], db.join_left)
    assert np.array_equal(v.cut_start.numpy(), db.cutpoints[:, 1])
    assert np.array_equal(v.cut_end.numpy(), db.cutpoints[:, 2])
    assert np.array_equal(v.waves.numpy(), db.waves)
    names = [db.unit_names[c] for c in db.unit_code]
    assert [list(v.names)[c] for c in v.codes.tolist()] == names
    assert np.array_equal(np.asarray([[list(v.phones)[c] for c in row] for row in v.ctx.tolist()]),
                          np.asarray(db.phone_names)[db.context_codes])
    for got, want in ((v.mean_t, db.mean_target), (v.std_t, db.std_target)):
        assert np.array_equal(got.float().numpy(), want)
    assert sum(u["units"] for u in utts[:1] + utts[2:]) + len(
        ref_hp.frames(short["labels"], short["epochs"], 60, SR)[0]) == db.n_units


def test_the_search_gives_the_oracles_ids_and_totals(labelled):
    from snickery_tpu_torch import oracle

    kind, utts = labelled
    v = ref_hp.build(utts, SYNTH["datadims"], SYNTH["stream_list"], [1.0] * 4, [1.0] * 4, SR,
                     "cpu")
    pool = kind._labelled(3, 12, voices.sub_seed(5, "targets"), "cpu", DATA)
    tg = ref_hp.cut_targets(v, pool)
    asks = [(0, 24), (1, 19), (2, 13)]
    got = ref_hp.synthesise(v, tg, asks, 6, 0.7, 50, WEIGHTS)
    fw, jl, jr = (x.numpy() for x in (v.fw, v.jlw, v.jrw))
    for (p, m), g in zip(asks, got):
        codes, ctx = tg.codes[p, :m].numpy(), tg.ctx[p, :m].numpy()
        id_pen = (codes[:, None] != v.codes.numpy()[None, :]) * ref_hp.ID_PENALTY
        pen = id_pen.copy()
        for c, w in enumerate(WEIGHTS[:5]):
            if w:
                pen = pen + (ctx[:, c:c + 1] != v.ctx.numpy()[None, :, c]) * (w * WEIGHTS[5])
        ids, cost = oracle.synth_pipeline(tg.tw[p, :m].numpy(), fw, jl, jr, 6, 0.7,
                                          extra=pen, lattice_penalty=id_pen)
        assert np.array_equal(g["unit_ids"], ids)
        assert g["total"] == pytest.approx(cost, rel=1e-12)


@pytest.mark.parametrize("trace", [False, True], ids=["untraced", "traced"])
def test_a_tiny_halfphone_cell_runs_correct(root, trace):
    cell = registry.cell(root, "tinyhp.hp")
    assert registry.units(cell).row_width(cell.config) == 453
    logged = []
    line, checks = harness.run_cell(cell, SEED, 1.0, trace, device="cpu", log=logged.append)
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0
    assert all(v <= lim for _, v, lim in checks)
    assert any("identity_fallbacks 0" in m for m in logged)
    if not trace:
        assert set(line["metrics"]) == {"rtf", "setup_s"}
        return
    # the CPU has no device trace: the span readers alone read
    assert set(line["metrics"]) == {"ling_ms.hp_batch", "pad_ms.hp_batch"}
    assert all(m["value"] > 0 for m in line["metrics"].values())


def test_the_control_comes_out_not_correct(root):
    cell = registry.cell(root, "tinyhp.hp")
    for seed in (5, 6, 7):
        nums = control.control_numbers(cell, seed, 1.0, "cpu", log=lambda m: None)
        assert nums["correct"] is False
        assert nums["audio_err"] > cell.limits["audio_err"]


class _Trace:
    def __init__(self, device_s, host_ops):
        self.device_s, self.host_ops, self.device_ops = device_s, host_ops, [(0, 1, "k")]

    def kernel_seconds(self, pattern):
        return self.device_s


class _Run:
    def __init__(self, trace, work, steps=2, wall_s=1.0):
        self.trace, self.work, self.steps, self.wall_s = trace, work, steps, wall_s
        self.synth = None
        self.cell = type("Cell", (), {"config": CONFIG})


def _reader(name):
    return registry.load_module(tiny.REPO / f"benchmark/metrics/{name}.py", name).read


def test_the_readers_count_the_halfphone_step():
    from benchmark import roofline
    w = {"targets": 1000, "pairs": 50_000, "rows": 5000, "kd": 453, "n": 20,
         "precision": "split3cat", "masked": False, "decode": "viterbi", "utterances": 20,
         "out_samples": 10 ** 6, "fragment_samples": 10 ** 6 + 10 ** 5}
    run = _Run(_Trace(0.01, [(0.0, 300.0, "snk.pad"), (400.0, 500.0, "snk.pad"),
                             (0.0, 900.0, "snk.synth_batch")]), [w, w])
    pre = roofline.bound_ms(1000, 5000, 453, 20, "split3cat", True, work=(w["pairs"], 5000))[0]
    # the label metadata's 32 bytes a target and a row are in the (bytes-bound) bound
    assert pre > roofline.bound_ms(1000, 5000, 453, 20, "split3cat", False,
                                   work=(w["pairs"], 5000))[0]
    assert _reader("preselect_roofline.hp_batch")(run) == pytest.approx(
        100 * 2 * pre / 1e3 / 0.01)
    step = (pre + roofline.rescore_bound_ms(1000, 20, 453, 151)[0]
            + roofline.decode_bound_ms("viterbi", 1000, 20, 151, 8080)[0]
            + roofline.ola_bound_ms(w["fragment_samples"], w["out_samples"])[0])
    assert _reader("step_roofline.hp_batch")(run) == pytest.approx(100 * 2 * step / 1e3)
    assert _reader("pad_ms.hp_batch")(run) == pytest.approx(0.4 / 2)
    for name in HP_METRICS:
        assert _reader(name)(_Run(None, [w])) is None
    assert _reader("pad_ms.hp_batch")(_Run(_Trace(0.01, []), [w])) is None
    # a program without span "ling" (or its timer) reads nothing
    assert _reader("ling_ms.hp_batch")(_Run(_Trace(0.01, []), [w])) is None


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the halfphone kernels run only on the card")


@pytest.mark.cuda
def test_a_traced_tiny_halfphone_cell_on_the_card_reads_every_metric(card, root):
    line, _ = harness.run_cell(registry.cell(root, "tinyhp.hp"), SEED, 1.5, True,
                               log=lambda m: None)
    assert line["correct"] is True
    assert set(HP_METRICS) <= set(line["metrics"])
    for name in ("preselect_roofline.hp_batch", "step_roofline.hp_batch"):
        assert 0 < line["metrics"][name]["value"] <= 105

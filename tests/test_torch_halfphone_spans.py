"""Span ``ling`` and the counter ``identity_fallbacks`` of the synthesiser on
the CPU, and a halfphone ``synth_batch`` against the benchmark's float64
halfphone reference.

Under ``torch.profiler`` a halfphone call records span ``ling`` three times
inside ``preselect`` and ``rescore`` (the target labels' packing, the
penalised ranking key, the identity fallback mask); an epoch call and a
merged epoch call record none, and an epoch call runs no operation of them
(its count is held to the one before they existed, with the five the
host-device copies add).  A call's waves hold its utterances' live samples
alone, end to end, not views of the padded audio block; marked ``cuda``: a
host copy from the card, into pages mapped up front, is exact.
``Synthesiser.counters`` sums ``identity_fallbacks``, the live targets that kept no live candidate of their own name: with the quinphone
ranking every unit of the target's name ranks first, so those are the live
targets whose name the voice lacks.
"""

import collections
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile
from torch.utils._python_dispatch import TorchDispatchMode

from benchmark import registry, voices
from benchmark.reference import halfphone as ref_hp
from snickery_tpu_torch.config import SnickeryConfig
from snickery_tpu_torch.synth import Synthesiser
from snickery_tpu_torch.synthetic_voices import (DATADIMS, SR, make_halfphone_utterances,
                                                 make_utterances, phone_means)
from snickery_tpu_torch.voicedb.build import build_voicedb
from snickery_tpu_torch.voicedb.multivoice import merge_voicedbs

REPO = Path(__file__).resolve().parents[1]
WEIGHTS = [1.0, 10.0, 0.0, 10.0, 1.0]
# aten operations of one epoch synth_batch call of ``epoch_call`` below: 1,312
# before span "ling" and the counters existed (they add none to an epoch
# call), 4 of the copy-out of each utterance's live samples alone (the column
# index, the totals' column view, the comparison, the masked gather) and 1 of
# the targets' buffer (``torch.empty``, page-locked on a card); a change to it
# is work added to every epoch call
EPOCH_CALL_OPS = 1312 + 4 + 1


def _config(**over) -> SnickeryConfig:
    base = dict(stream_list=list(DATADIMS), datadims=dict(DATADIMS), sample_rate=SR,
                n_candidates=6, taper_length=50, join_cost_weight=0.7,
                length_buckets=[32, 64], voice_name="hp", preselect_precision="split3cat",
                quinphone_context_weights=WEIGHTS, quinphone_penalty_scale=100.0)
    return SnickeryConfig(**{**base, **over})


@pytest.fixture(scope="module")
def numpy_hp():
    """A numpy halfphone voice over 40 phones, too few utterances to hold
    every halfphone name, and held-out utterances with their targets."""
    means = phone_means(5)
    cfg = _config(target_representation="halfphone")
    utts = make_halfphone_utterances(np.random.default_rng(6), 8, 12, "v", means)
    synth = Synthesiser(cfg, db=build_voicedb(cfg, utts), device="cpu")
    held = make_halfphone_utterances(np.random.default_rng(7), 6, 10, "h", means)

    def targets(us):
        return [synth.halfphone_targets_from_features(u.features, u.epochs, u.halfphones)
                for u in us]

    return synth, targets(utts[:6]), targets(held)


def epoch_call(kind: str):
    """(synthesiser, call) of one synth_batch over a small numpy epoch voice,
    or two merged ones."""
    cfg = _config(n_candidates=8)
    utts = make_utterances(np.random.default_rng(3), 6, 120, "u")
    held = [u.features for u in make_utterances(np.random.default_rng(4), 3, 40, "h")]
    if kind == "epoch":
        synth = Synthesiser(cfg, db=build_voicedb(cfg, utts), device="cpu")
        return synth, lambda: synth.synth_batch(held)
    db = merge_voicedbs([build_voicedb(cfg, utts[:3]), build_voicedb(cfg, utts[3:])],
                        ["a", "b"])
    synth = Synthesiser(cfg, db=db, device="cpu")
    return synth, lambda: synth.synth_batch(held, voices=["a", "b", "a"])


def _snk_names(fn) -> list:
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    host = torch.autograd.DeviceType.CPU
    return [e.name[len("snk."):] for e in sorted(prof.events(), key=lambda e: e.time_range.start)
            if e.name.startswith("snk.") and e.device_type == host]


@pytest.mark.parametrize("kind", ["halfphone", "epoch", "multivoice"])
def test_span_ling_only_in_halfphone_calls(kind, numpy_hp):
    if kind == "halfphone":
        synth, _, held = numpy_hp
        call = lambda: synth.synth_batch([t for t, _ in held], segments_list=[s for _, s in held])  # noqa: E731
    else:
        synth, call = epoch_call(kind)
    names = _snk_names(call)
    if kind != "halfphone":
        assert "ling" not in names and "ling" not in synth.timer.device_times()
        return
    # inside preselect once (the labels' packing), inside rescore twice
    assert names.count("ling") == 3
    at = [i for i, n in enumerate(names) if n == "ling"]
    assert names[at[0] - 1] == "preselect" and names[at[1] - 1] == "rescore"
    assert names.index("decode") > at[2]
    assert synth.timer.device_times()["ling"][1] == 3


class _Count(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


def test_an_epoch_call_runs_no_halfphone_operations():
    synth, call = epoch_call("epoch")
    call()
    with _Count() as count:
        out = call()
    assert len(out) == 3 and not synth.counters
    assert count.n == EPOCH_CALL_OPS


@pytest.mark.parametrize("which", ["voice_utterances", "held_out"])
def test_identity_fallbacks_count_the_targets_whose_name_the_voice_lacks(numpy_hp, which):
    synth, own, held = numpy_hp
    targets = own if which == "voice_utterances" else held
    names = set(synth.db.unit_names)
    want = sum(s.name not in names for _, segs in targets for s in segs)
    assert (want == 0) == (which == "voice_utterances")
    before = synth.counters["identity_fallbacks"]
    synth.synth_batch([t for t, _ in targets], segments_list=[s for _, s in targets])
    assert synth.counters["identity_fallbacks"] - before == want
    # a second call adds its own
    synth.synth_batch([t for t, _ in targets[:2]], segments_list=[s for _, s in targets[:2]])
    assert synth.counters["identity_fallbacks"] - before == want + sum(
        s.name not in names for _, segs in targets[:2] for s in segs)


@pytest.fixture(scope="module")
def kind_voice():
    """Eight held-out utterances and a voice of the benchmark's halfphone
    kind (its generator's 21 phones), small, but with several times the
    kept candidates of each name, so the context penalties pick them."""
    kind = registry.load_module(REPO / "benchmark/units/halfphone.py", "hp_kind_tests")
    data = {"seg_sec": 0.15, "sample_rate": SR}
    utts = kind.Voices([kind._labelled(48, 8, voices.sub_seed(11, "voice", 0), "cpu", data)])
    pool = kind._labelled(8, 12, voices.sub_seed(11, "targets"), "cpu", data)
    for u in pool:
        u["targets"], u["segments"] = kind._program_targets(u, SR)
    config = {"data": {"voices": 1, **data}, "synth": {
        **{k: v for k, v in vars(_config()).items() if k in (
            "stream_list", "datadims", "sample_rate", "n_candidates", "taper_length",
            "join_cost_weight", "length_buckets", "voice_name", "preselect_precision",
            "quinphone_context_weights", "quinphone_penalty_scale")},
        "target_representation": "halfphone", "n_candidates": 4}}
    return kind, config, utts, pool


def _as_dicts(utts) -> list:
    """The reference's utterance dicts of ``UtteranceData``."""
    return [{"wave": u.wave, "epochs": u.epochs, "features": u.features,
             "labels": [(h.start_sec, h.end_sec, h.name, h.phone, h.half, h.quinphone)
                        for h in u.halfphones]} for u in utts]


@pytest.fixture(scope="module")
def numpy_kind(kind_voice):
    """The numpy voice of ``numpy_hp`` in the kind's form: its names are
    sparse, so steps keep candidates of other names (the lattice mask) and
    held-out names the voice lacks fall back."""
    kind, config, _, _ = kind_voice
    means = phone_means(5)
    cfg = _config(target_representation="halfphone")
    utts = kind.Voices([_as_dicts(make_halfphone_utterances(np.random.default_rng(6), 8, 12,
                                                            "v", means))])
    pool = _as_dicts(make_halfphone_utterances(np.random.default_rng(7), 8, 12, "h", means))
    # every third target of the first utterance named after a halfphone the
    # voice holds once or twice, its rows another's: without the mask a unit
    # of another name would win there
    held = collections.Counter(lab[2] for u in utts[0] for lab in u["labels"])
    scarce = sorted(name for name, c in held.items() if c <= 2)
    pool[0]["labels"] = [(*lab[:2], scarce[i % len(scarce)], *lab[3:]) if i % 3 == 0 else lab
                         for i, lab in enumerate(pool[0]["labels"])]
    for u in pool:
        u["targets"], u["segments"] = kind._program_targets(u, SR)
    config = {**config, "synth": {**config["synth"], "n_candidates": cfg.n_candidates}}
    return kind, config, utts, pool


@pytest.mark.parametrize("which", ["generator", "numpy"])
def test_a_halfphone_batch_agrees_with_the_float64_reference(which, kind_voice, numpy_kind):
    kind, config, utts, pool = kind_voice if which == "generator" else numpy_kind
    synth = kind.build(config, utts, "cpu", lambda m: None)
    asks = [type("Ask", (), {"pool": p, "epochs": min(n, len(pool[p]["targets"])), "voice": 0})
            for p, n in enumerate([24, 20, 17, 23, 24, 12, 19, 21])]
    out = synth.synth_batch([kind.features(pool, a) for a in asks],
                            **kind.call_kwargs(pool, asks))
    answers = [{"unit_ids": r["unit_ids"], "total_cost": r["total_cost"], "wave": r["wave"]}
               for r in out]
    ref = kind.reference(config, utts, "cpu")
    nums = kind.numbers(ref, config, answers, pool, asks, list(range(len(asks))))
    assert nums["missing"] == 0 and nums["voice_leaks"] == 0 and nums["compared"] == 8
    assert nums["id_mismatch"] == 0 and nums["cost_gap"] < 1e-6
    assert nums["total_err"] < 1e-5 and nums["audio_err"] < 1e-5
    assert nums["identity_fallbacks"] == synth.counters["identity_fallbacks"]
    # the generator's voice holds each name many times; the numpy one keeps
    # other names at some steps (the lattice's mask) and lacks some (fallbacks)
    tg = ref_hp.cut_targets(ref.voice, pool)
    n = config["synth"]["n_candidates"]
    other = fallbacks = 0
    for a in asks:
        codes = tg.codes[a.pool, : a.epochs]
        ids, _ = ref_hp.preselect(ref.voice, tg.tw[a.pool, : a.epochs], codes,
                                  tg.ctx[a.pool, : a.epochs], n, (*WEIGHTS, 100.0))
        other += int(((ref.voice.codes[ids] != codes[:, None]).any(1) & (codes >= 0)).sum())
        fallbacks += int((codes < 0).sum())
    assert fallbacks == nums["identity_fallbacks"]
    assert (other > 0 and fallbacks > 0) == (which == "numpy")


@pytest.mark.parametrize("kind", ["halfphone", "epoch", "multivoice"])
def test_a_calls_waves_hold_only_their_live_samples(kind, numpy_hp):
    if kind == "halfphone":
        synth, _, held = numpy_hp
        out = synth.synth_batch([t for t, _ in held], segments_list=[s for _, s in held])
    else:
        _, call = epoch_call(kind)
        out = call()
    waves = [r["wave"] for r in out]
    # the call's samples end to end in one buffer, no padding between them
    addr = [w.__array_interface__["data"][0] for w in waves]
    assert all(w.ndim == 1 and w.flags.c_contiguous for w in waves)
    assert all(a + w.nbytes == b for a, w, b in zip(addr, waves, addr[1:]))


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the page-mapped host copy is the card's path")


@pytest.mark.cuda
def test_a_large_host_copy_from_the_card_is_exact(card):
    from snickery_tpu_torch.synth import _host_copy
    for n in (10, (1 << 22) + 5):
        t = torch.randn(n, device="cuda")
        out = _host_copy(t)
        assert out.flags.writeable and np.array_equal(out, t.cpu().numpy())

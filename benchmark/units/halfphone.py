"""Unit kind ``halfphone``: one unit a labelled halfphone (BASELINE config 2),
with the functions ``units/epoch.py`` lists.

The voice and the target pool are the epoch kind's utterances
(:func:`benchmark.voices.utterances`, one voice), each with its phone draws,
which the generator's labelling turns into halfphone labels as
``snickery_tpu_torch.synthetic_voices.synth_utterance`` does: segment ``i``
of phone ``p`` spans ``[i, i + 1) * seg_sec`` seconds and is halved at its
midpoint into ``p_L`` and ``p_R``, both with the quinphone ``(p[i-2], p[i-1],
p, p[i+1], p[i+2])``, "xx" past either edge.  A label is the tuple
``(start_sec, end_sec, name, phone, half, quinphone)``, the fields of the
program's ``HalfphoneSegment``.

Each pool utterance's unit-rate targets (``[first | mid | last]`` epoch rows,
3 x 151 = 453 wide) and their segments are cut once, at set-up, by the
program's own rule (``Synthesiser.halfphone_targets_from_features``'s:
``halfphone_frame_indices`` over ``segments_to_sample_bounds``).  **A mix's
lengths (its ``epochs`` key) count halfphones for this kind**: an ask of
``n`` passes the first ``n`` halfphone targets of its utterance and their
segments (``call_kwargs``: ``segments_list``) and makes ``n`` unit targets.

The reference (``reference/halfphone.py``) cuts the voice's units and the
targets again by its own frozen rule, and searches in float64.  The
program's ``Synthesiser.counters`` (``identity_fallbacks``, summed over the
run's calls, the warm-up's included) is printed among the numbers the
reference line logs, where the program has it.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark import speech, system, voices
from benchmark.reference import halfphone as ref_hp


class Voices(list):
    """The cell's voices (one list of utterance dicts a voice), and the
    program's counters once :func:`build` has made it."""
    counters = None


class Reference:
    """The reference's voice, and the program's counters where it has them
    (a plain class: the registry loads this module outside ``sys.modules``,
    where a dataclass cannot resolve its annotations)."""

    def __init__(self, voice: ref_hp.HalfphoneVoice, counters):
        self.voice, self.counters = voice, counters


def phone_draws(n_utts: int, n_segments: int, seed: int, device, seg_sec: float) -> np.ndarray:
    """(n_utts, n_segments) phone indices of ``voices.utterances(n_utts,
    n_segments, seed, device, seg_sec)``: its generator replayed chunk by
    chunk (the phones are each chunk's first draw; nothing else draws)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    chunk = max(1, voices.CHUNK_SAMPLES // (speech.seg_len(seg_sec) * n_segments))
    out = []
    for c0 in range(0, n_utts, chunk):
        phones, _, _ = speech.draw(gen, min(chunk, n_utts - c0), n_segments, seg_sec)
        out.append(phones.cpu().numpy())
    return np.concatenate(out)


def labels(phones, seg_sec: float) -> list:
    """The halfphone labels of one utterance's phone indices."""
    names = [speech.PHONES[int(p)] for p in phones]
    S = len(names)
    seg = speech.seg_len(seg_sec) / speech.SR

    def at(i):
        return names[i] if 0 <= i < S else "xx"

    out = []
    for i, ph in enumerate(names):
        s0, s1 = i * seg, (i + 1) * seg
        mid = 0.5 * (s0 + s1)
        quin = tuple(at(i + o) for o in (-2, -1, 0, 1, 2))
        out += [(s0, mid, f"{ph}_L", ph, "L", quin), (mid, s1, f"{ph}_R", ph, "R", quin)]
    return out


def _labelled(n_utts: int, n_segments: int, seed: int, device, data: dict) -> list:
    utts = voices.utterances(n_utts, n_segments, seed, device, data["seg_sec"],
                             data["sample_rate"])
    for u, p in zip(utts, phone_draws(n_utts, n_segments, seed, device, data["seg_sec"])):
        u["labels"] = labels(p, data["seg_sec"])
        u["units"] = len(ref_hp.frames(u["labels"], u["epochs"], len(u["features"]),
                                       data["sample_rate"])[0])
    return utts


def _segments(labs: list) -> list:
    from snickery_tpu_torch.io.labels import HalfphoneSegment
    return [HalfphoneSegment(*lab) for lab in labs]


def _program_targets(u: dict, sample_rate: int):
    """(targets (n, 3 kd) f32, kept segments) of a pool utterance by the
    program's rule."""
    from snickery_tpu_torch.io.labels import segments_to_sample_bounds
    from snickery_tpu_torch.voicedb.build import halfphone_frame_indices

    segs = _segments(u["labels"])
    f = u["features"]
    picked = halfphone_frame_indices(segs, segments_to_sample_bounds(segs, sample_rate),
                                     u["epochs"], len(f))
    rows = [np.concatenate([f[e0], f[mid], f[e1]]) for _, e0, mid, e1 in picked]
    return np.asarray(rows, np.float32), [seg for seg, *_ in picked]


def inputs(config: dict, traffic: dict, seed: int, device, log):
    """(voices, pool): one voice of labelled utterances, and the held-out
    labelled target utterances with their halfphone targets and segments."""
    data = config["data"]
    if data["voices"] != 1:
        raise ValueError("the halfphone kind has one voice")
    t0 = time.perf_counter()
    utts = Voices([_labelled(data["utterances_per_voice"], data["segments"],
                             voices.sub_seed(seed, "voice", 0), device, data)])
    pool = _labelled(traffic["pool"], traffic["pool_segments"],
                     voices.sub_seed(seed, "targets"), device, data)
    for u in pool:
        u["targets"], u["segments"] = _program_targets(u, data["sample_rate"])
    need = traffic["epochs"]["max"]
    short = min(len(u["targets"]) for u in pool)
    if short < need:
        raise ValueError(f"a target utterance has {short} halfphones, the traffic cuts {need}")
    secs = sum(len(u["wave"]) for u in utts[0]) / data["sample_rate"]
    log(f"setup data: 1 voice, {voice_rows(utts)[0]} halfphone units, {secs:.1f} s of audio, "
        f"{len(pool)} target utterances, {time.perf_counter() - t0:.2f} s")
    return utts, pool


def voice_rows(utts: list) -> list:
    return [sum(u["units"] for u in v) for v in utts]


def build(config: dict, utts: list, device, log):
    """The program's ``Synthesiser`` of the voice, built through its public
    builder with the utterances' segments."""
    from snickery_tpu_torch.synth import Synthesiser
    from snickery_tpu_torch.voicedb.build import UtteranceData, build_voicedb

    cfg = system.synth_config(config)
    t0 = time.perf_counter()
    db = build_voicedb(cfg, [UtteranceData(basename=f"hp{i:05d}", wave=u["wave"],
                                           epochs=np.asarray(u["epochs"], np.int32),
                                           features=u["features"],
                                           lf0=np.ascontiguousarray(u["features"][:, -1]),
                                           halfphones=_segments(u["labels"]))
                             for i, u in enumerate(utts[0])])
    t1 = time.perf_counter()
    log(f"setup voicedb: {db.n_units} halfphone units, {t1 - t0:.2f} s")
    synth = Synthesiser(cfg, db=db, device=device)
    log(f"setup device db: {synth.n_units_padded} rows, {time.perf_counter() - t1:.2f} s")
    if isinstance(utts, Voices):
        utts.counters = getattr(synth, "counters", None)
    return synth


def features(pool: list, ask):
    """The first ``ask.epochs`` halfphone targets of the ask's utterance."""
    return pool[ask.pool]["targets"][: ask.epochs]


def call_kwargs(pool: list, asks: list) -> dict:
    return {"segments_list": [pool[a.pool]["segments"][: a.epochs] for a in asks]}


def n_targets(pool: list, ask) -> int:
    return ask.epochs


def row_width(config: dict) -> int:
    syn = config["synth"]
    return 3 * sum(syn["datadims"][s] for s in syn["stream_list"])


def _weights(syn: dict) -> tuple:
    """The ranking's (w_0..w_4, scale); the reference knows the quinphone
    method only."""
    if syn.get("preselection_method", "") not in ("", "quinphone"):
        raise ValueError("the halfphone reference ranks by the quinphone method only")
    return (*syn["quinphone_context_weights"], syn["quinphone_penalty_scale"])


def reference(config: dict, utts: list, device):
    syn = config["synth"]
    streams = syn["stream_list"]
    voice = ref_hp.build(utts[0], syn["datadims"], streams,
                         syn.get("target_stream_weights", [1.0] * len(streams)),
                         syn.get("join_stream_weights", [1.0] * len(streams)),
                         syn["sample_rate"], device)
    return Reference(voice=voice, counters=getattr(utts, "counters", None))


def _asks(asks: list) -> list:
    return [(a.pool, a.epochs) for a in asks]


def numbers(ref, config: dict, answers: list, pool: list, asks: list, sample: list) -> dict:
    syn = config["synth"]
    nums = ref_hp.numbers(ref.voice, ref_hp.cut_targets(ref.voice, pool), answers, _asks(asks),
                          sample, syn["n_candidates"], syn["join_cost_weight"],
                          syn["taper_length"], _weights(syn))
    if ref.counters is not None:
        nums["identity_fallbacks"] = int(ref.counters.get("identity_fallbacks", 0))
    return nums


def control(ref, config: dict, pool: list, asks: list) -> list:
    """The reference one precision lower (``precision="tf32"``)."""
    syn = config["synth"]
    return [{"unit_ids": a["unit_ids"], "total_cost": a["total"], "wave": a["wave"]}
            for a in ref_hp.synthesise(ref.voice, ref_hp.cut_targets(ref.voice, pool),
                                       _asks(asks), syn["n_candidates"],
                                       syn["join_cost_weight"], syn["taper_length"],
                                       _weights(syn), precision="tf32")]

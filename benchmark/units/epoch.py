"""Unit kind ``epoch``: one unit an epoch (pitch mark), the kind a
configuration has where it names none.

A unit kind is the seam between the harness and what a configuration's
units are.  ``run.py``, ``control.py``, ``sweep_rate.py``, the entries and
``record.Run`` call only these functions of it, so a kind is added as one
file, ``units/<kind>.py``, with the same functions:

- ``inputs(config, traffic, seed, device, log)``: (voices, pool), the
  cell's inputs made from ``seed``: one item a voice, and the held-out
  target utterances that asks index;
- ``voice_rows(voices)``: each voice's unit count;
- ``build(config, voices, device, log)``: the program's ``Synthesiser``;
- ``features(pool, ask)``: the target trajectory a call passes for ``ask``;
- ``call_kwargs(pool, asks)``: the further keyword arguments of a
  ``synth_batch`` call of ``asks``;
- ``n_targets(pool, ask)``: the unit targets ``ask`` makes;
- ``row_width(config)``: the width of a unit row, as the roofline counts it;
- ``reference(config, voices, device)``: the plain reference's voice;
- ``numbers(ref, config, answers, pool, asks, sample)``: the comparison's
  numbers of ``answers`` (see ``reference/compare.py``);
- ``control(ref, config, pool, asks)``: the control's answers to ``asks``.

Here each delegates to the epoch-unit code beside it: ``voices``,
``system``, ``reference.voice``, ``reference.compare`` and
``reference.search``.
"""

from __future__ import annotations

from benchmark import system, voices
from benchmark.reference import compare, search
from benchmark.reference import voice as ref_voice


def inputs(config: dict, traffic: dict, seed: int, device, log):
    return voices.cell_data(config, traffic, seed, device, log)


def voice_rows(utts: list) -> list:
    return [sum(len(u["epochs"]) - 2 for u in v) for v in utts]


def build(config: dict, utts: list, device, log):
    return system.build(config, utts, device, log)


def features(pool: list, ask):
    """The epoch-rate target trajectory of ``ask``."""
    return pool[ask.pool]["features"][: ask.epochs]


def call_kwargs(pool: list, asks: list) -> dict:
    return {}


def n_targets(pool: list, ask) -> int:
    return ask.epochs - 2


def row_width(config: dict) -> int:
    syn = config["synth"]
    return sum(syn["datadims"][s] for s in syn["stream_list"])


def reference(config: dict, utts: list, device):
    syn = config["synth"]
    streams = syn["stream_list"]
    return ref_voice.build(utts, syn["datadims"], streams,
                           syn.get("target_stream_weights", [1.0] * len(streams)),
                           syn.get("join_stream_weights", [1.0] * len(streams)), device)


def numbers(ref, config: dict, answers: list, pool: list, asks: list, sample: list) -> dict:
    syn = config["synth"]
    return compare.numbers(ref, answers, [features(pool, a) for a in asks],
                           [a.voice for a in asks], sample, syn["n_candidates"],
                           syn["join_cost_weight"], syn["taper_length"])


def control(ref, config: dict, pool: list, asks: list) -> list:
    """The reference one precision lower (``search.synthesise`` at "tf32")."""
    syn = config["synth"]
    return [{"unit_ids": a["unit_ids"], "total_cost": a["total"], "wave": a["wave"]}
            for a in search.synthesise(ref, [features(pool, a) for a in asks],
                                       [a.voice for a in asks], syn["n_candidates"],
                                       syn["join_cost_weight"], syn["taper_length"],
                                       precision="tf32")]

"""Entry ``synth_batch``: a closed loop of ``Synthesiser.synth_batch`` calls,
each of the mix's ``batch`` utterances, the next sent when the last returns,
until the window's seconds have passed; the window ends with the last call.
What a call passes for each utterance, and the targets it makes, are the
unit kind's (``run.units``).
"""

from __future__ import annotations

import time
from collections import Counter

from benchmark import roofline, traffic


def _call(run, asks):
    synth = run.synth
    voices = [a.voice for a in asks] if synth.is_multivoice else None
    return synth.synth_batch([run.features(a) for a in asks],
                             greedy=bool(run.cell.traffic["greedy"]), voices=voices,
                             **run.units.call_kwargs(run.pool, asks))


def _step_work(run, asks, results) -> dict:
    syn = run.cell.config["synth"]
    taper = syn["taper_length"]
    per_voice = Counter()
    for a in asks:
        per_voice[a.voice] += run.units.n_targets(run.pool, a)
    units = sum(per_voice.values())
    out = sum(len(r["wave"]) for r in results)
    pairs, rows = roofline.partition_work(per_voice, run.voice_rows)
    return {"targets": units, "pairs": pairs, "rows": rows,
            "kd": run.units.row_width(run.cell.config),
            "n": syn["n_candidates"], "precision": syn["preselect_precision"],
            "masked": len(run.voice_rows) > 1,
            "decode": "greedy" if run.cell.traffic["greedy"] else "viterbi",
            "utterances": len(asks), "out_samples": out,
            "fragment_samples": out - len(asks) * 2 * taper + units * 2 * taper}


def warm(run):
    """One call of the window's first batch: every call has its shapes."""
    _call(run, next(traffic.batches(run.cell.traffic, run.seed, len(run.voice_rows))))


def window(run, seconds: float):
    timer = run.synth.timer
    before = (timer.totals.get("synth_step", 0.0), timer.counts.get("synth_step", 0))
    it = traffic.batches(run.cell.traffic, run.seed, len(run.voice_rows))
    sr = run.cell.config["synth"]["sample_rate"]
    with run.tracer.window():
        t0 = time.perf_counter()
        while True:
            asks = next(it)
            results = _call(run, asks)
            run.asked += asks
            run.answers += [{"unit_ids": r["unit_ids"], "total_cost": r["total_cost"],
                             "wave": r["wave"]} for r in results]
            run.work.append(_step_work(run, asks, results))
            run.audio_s += sum(len(r["wave"]) for r in results) / sr
            run.steps += 1
            if time.perf_counter() - t0 >= seconds:
                break
        run.wall_s = time.perf_counter() - t0
    run.counters["synth_step_s"] = timer.totals["synth_step"] - before[0]
    run.counters["synth_step_n"] = timer.counts["synth_step"] - before[1]
    n = len(run.answers)
    longest = max(range(n), key=lambda i: run.asked[i].epochs)
    run.sample = traffic.sample(n, longest, run.cell.traffic["sample"], run.seed)

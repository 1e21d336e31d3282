"""The comparison that decides ``correct``: the program's answers against
the reference's, each number beside its limit.

Numbers (``answers`` are the program's, one dict an utterance or request
with ``unit_ids``, ``total_cost`` and, where kept, ``wave``):

- ``missing``: answers due that never came, failed, or hold another number
  of units than their targets or of samples than their units' audio (exact:
  limit 0);
- ``voice_leaks``: unit ids outside the voice the answer was asked of, over
  every answer (exact: limit 0);
- ``total_err``: over every answer, the widest relative gap between the
  total cost the program reports and the float64 cost of the path it
  returned;
- ``audio_err``: over every answer that kept its wave, the widest gap
  between the program's audio and the reference's overlap-add of the
  program's units, as a share of the reference audio's peak;
- ``cost_gap_median``: over the sample, the median of the relative gaps
  between the float64 cost of the program's path and that of the
  reference's path (``cost_gap``, the widest of them, is read but has no
  limit: at ``split3cat`` a few near-ties the ranking's margin misses set
  it as high as the control's; see ``PERF.md``);
- ``id_mismatch``: over the sample's units, the share whose id differs from
  the reference's, less those whose unit rows and both join contexts are
  bit-identical to the reference unit's (equally optimal).
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import search

TINY = 1e-9             # a cost below it is a natural target's 0


def numbers(voice, answers: list, features: list, voice_ids: list, sample: list,
            n_cand: int, jcw: float, taper: int) -> dict:
    """The numbers above; ``sample`` indexes the answers the reference
    searches itself (answers that are missing are left out of it)."""
    out = {"missing": 0, "voice_leaks": 0, "total_err": 0.0, "audio_err": 0.0}
    dev = voice.fw.device
    good = set()
    for i, a in enumerate(answers):
        T = len(features[i]) - 2
        if a is None or len(a["unit_ids"]) != T:
            out["missing"] += 1
            continue
        ids = torch.as_tensor(np.asarray(a["unit_ids"], np.int64), device=dev)
        lo, hi = voice.voice_rows[voice_ids[i]]
        leaks = int(((ids < lo) | (ids >= hi)).sum())
        out["voice_leaks"] += leaks
        if leaks:
            continue
        good.add(i)
        tw = voice.targets(features[i])
        c = float(search.path_costs(tw, ids, voice.fw, voice.jlw, voice.jrw, jcw))
        out["total_err"] = max(out["total_err"], abs(float(a["total_cost"]) - c) / max(c, TINY))
        if a.get("wave") is not None:
            ref = search.overlap_add(voice.waves, voice.cut_start[ids], voice.cut_end[ids], taper)
            wave = torch.as_tensor(np.array(a["wave"], np.float32), device=dev)
            if wave.shape != ref.shape:
                out["missing"] += 1
            else:
                err = float((wave.double() - ref).abs().max() / ref.abs().max().clamp(min=1e-30))
                out["audio_err"] = max(out["audio_err"], err)
    picked = [i for i in sample if i in good]
    refs = search.synthesise(voice, [features[i] for i in picked],
                             [voice_ids[i] for i in picked], n_cand, jcw, taper)
    gaps, differ, units = [], 0, 0
    for i, r in zip(picked, refs):
        tw = voice.targets(features[i])
        mine = np.asarray(answers[i]["unit_ids"], np.int64)
        c_mine = float(search.path_costs(tw, torch.as_tensor(mine, device=dev), voice.fw,
                                         voice.jlw, voice.jrw, jcw))
        c_ref = float(search.path_costs(tw, torch.as_tensor(r["unit_ids"], device=dev),
                                        voice.fw, voice.jlw, voice.jrw, jcw))
        gaps.append(abs(c_mine - c_ref) / max(c_ref, TINY))
        d = np.flatnonzero(mine != r["unit_ids"])
        a, b = mine[d], r["unit_ids"][d]
        same = ((voice.feats[a] == voice.feats[b]).all(1) & (voice.jr[a] == voice.jr[b]).all(1))
        differ += int((~same).sum())
        units += len(mine)
    out["cost_gap"] = max(gaps, default=0.0)
    out["cost_gap_median"] = float(np.median(gaps)) if gaps else 0.0
    out["id_mismatch"] = differ / max(units, 1)
    out["compared"] = len(picked)
    return out


def judge(nums: dict, limits: dict) -> tuple[bool, list]:
    """(correct, [(name, number, limit)]): each limited number at or under
    its limit, and at least one answer compared by the reference."""
    rows = [(k, nums[k], limits[k]) for k in limits]
    ok = all(v <= lim for _, v, lim in rows) and nums.get("compared", 0) > 0
    return ok, rows

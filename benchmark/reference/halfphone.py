"""The reference for halfphone voices (BASELINE config 2): units cut from
labelled utterances, the quinphone-penalised search over them, the path's
cost and its overlap-add, in float64.

Unit semantics (the program's documented halfphone contract, a frozen
reading of its voice builder's frame rule): an utterance with epochs ``e``
(E of them), feature rows ``f`` (E, kd) and halfphone labels (start and end
in seconds, name, quinphone) has one unit a label, in label order:

- the label's start and end, rounded to samples, snap to the nearest epoch
  (the earlier on a tie): ``e0`` (at least 1) and ``e1`` = the end's epoch
  less one, kept within ``[e0, E - 2]``; a label whose ``e0`` lies past
  ``E - 2`` has no unit; ``mid = (e0 + e1) // 2``;
- its row is ``[f[e0] | f[mid] | f[e1]]`` (3 kd wide), its left join context
  ``f[e0]``, its right one ``f[min(e1 + 1, E - 1)]`` (kd wide), its audio
  span ``[e[e0], e[min(e1 + 1, E - 1)])`` of the utterance's wave;
- a target utterance's halfphone targets are cut from its epoch rows and
  labels by the same rule.

Unit ids number the units in corpus order.  Rows and targets are
standardised by the mean and (population) standard deviation of the unit
rows, join contexts by those of the left contexts followed by the right
ones, each stream scaled by the square root of its weight; the statistics
follow the builder's float32 rule as ``reference/voice.py`` does.  One voice.

The search (a frozen reading of the program's documented halfphone step and
of the float64 oracle ``snickery_tpu_torch/oracle.py`` with the penalties
its bench passes):

- each target ranks every unit by its key: the squared distance, plus
  ``ID_PENALTY`` where the unit's name is not the target's, plus ``w_c *
  scale`` for each quinphone slot ``c`` in which the unit's context differs
  from the target's; the ``n`` least are kept in (key, unit id) order;
- a kept unit's target cost is its distance, raised to at least ``BIG``
  where its name is not the target's at a step that keeps a unit of the
  target's name; as ``ID_PENALTY`` ranks every unit of the target's name
  before every other, that is every step whose name the voice has;
- join costs, the Viterbi and the overlap-add are the epoch search's
  (``reference/search.py``): join contexts 151 wide against rows 453 wide.

A target's name that the voice lacks matches no unit's; a target's context
phone that the voice lacks reads as the edge mark "xx", as the program
reads it.

``precision="tf32"`` is the control: the same search as a lower-precision
program would make it, as ``search.synthesise`` makes the epoch one (keys
from TF32 products plus the penalties in float32, no exact rescore, float32
lattice costs, audio from bfloat16 waves).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from benchmark.reference import compare, search
from benchmark.reference.voice import stream_weights

ID_PENALTY = float(2 ** 24)    # an identity mismatch in the ranking key
BIG = 1.0e10                   # the least lattice cost of an identity mismatch
BLOCK_ANSWERS = 512            # answers whose paths and audio are checked at once


def frames(labels: list, epochs: np.ndarray, n_frames: int, sample_rate: int):
    """(label indices, e0, mid, e1) int64 arrays of the labels that have a
    unit: the frame rule above."""
    ep = np.asarray(epochs, np.int64)
    b = np.asarray([[round(lab[0] * sample_rate), round(lab[1] * sample_rate)]
                    for lab in labels], np.int64).reshape(-1, 2)

    def snap(x):
        pos = np.clip(np.searchsorted(ep, x), 1, len(ep) - 1)
        left, right = ep[pos - 1], ep[pos]
        return np.where(x - left <= right - x, pos - 1, pos)

    e0 = np.maximum(snap(b[:, 0]), 1)
    e1 = np.minimum(np.maximum(snap(b[:, 1]) - 1, e0), n_frames - 2)
    keep = np.flatnonzero(e1 >= e0)
    e0, e1 = e0[keep], e1[keep]
    return keep, e0, (e0 + e1) // 2, e1


def rows_of(features: np.ndarray, e0, mid, e1) -> np.ndarray:
    """(n, 3 kd) f32 ``[f[e0] | f[mid] | f[e1]]``."""
    return np.concatenate([features[e0], features[mid], features[e1]], axis=1)


@dataclass
class HalfphoneVoice:
    feats: np.ndarray          # (M, 3 kd) f32 unit rows as cut (host)
    jr: np.ndarray             # (M, kd) f32 right join contexts as cut (host)
    fw: torch.Tensor           # (M, 3 kd) f64 standardised, weighted unit rows
    jlw: torch.Tensor          # (M, kd) f64 weighted left contexts
    jrw: torch.Tensor          # (M, kd) f64 weighted right contexts
    codes: torch.Tensor        # (M,) int64 name codes
    ctx: torch.Tensor          # (M, 5) int64 quinphone codes
    cut_start: torch.Tensor    # (M,) int64 into ``waves``
    cut_end: torch.Tensor
    waves: torch.Tensor        # (S,) f32, the utterances' waves end to end
    mean_t: torch.Tensor
    std_t: torch.Tensor
    sqrt_wt: torch.Tensor
    names: dict                # halfphone name -> code
    phones: dict               # phone -> code
    sample_rate: int

    def targets(self, rows: np.ndarray) -> torch.Tensor:
        """(T, 3 kd) f64 standardised, weighted targets of raw rows."""
        t = torch.from_numpy(np.asarray(rows, np.float32)).to(self.fw.device, torch.float64)
        return (t - self.mean_t) / self.std_t * self.sqrt_wt

    def label_codes(self, labels: list):
        """(codes (T,), contexts (T, 5)) int64 of target labels: -1 for a
        name the voice lacks, "xx"'s code for a phone it lacks."""
        dev = self.fw.device
        codes = torch.tensor([self.names.get(lab[2], -1) for lab in labels], dtype=torch.int64)
        edge = self.phones["xx"]
        ctx = torch.tensor([[self.phones.get(p, edge) for p in lab[5]] for lab in labels],
                           dtype=torch.int64).reshape(-1, 5)
        return codes.to(dev), ctx.to(dev)


def build(utts: list, datadims: dict, streams: list, target_weights: list,
          join_weights: list, sample_rate: int, device) -> HalfphoneVoice:
    """The reference voice of one voice's utterances: dicts with ``wave``
    (n,) f32, ``epochs`` (E,) int, ``features`` (E, kd) f32 and ``labels``
    (tuples whose items 0, 1, 2 and 5 are the start and end in seconds, the
    halfphone name and the quinphone)."""
    feats, jl, jr, c0, c1, codes, ctx, waves = [], [], [], [], [], [], [], []
    names, phones = {}, {"xx": 0}
    offset = 0
    for u in utts:
        f, e = u["features"], np.asarray(u["epochs"], np.int64)
        E = len(e)
        if E < 4 or len(f) != E:
            continue
        idx, e0, mid, e1 = frames(u["labels"], e, E, sample_rate)
        if not len(idx):
            continue
        after = np.minimum(e1 + 1, E - 1)
        feats.append(rows_of(f, e0, mid, e1))
        jl.append(f[e0])
        jr.append(f[after])
        c0.append(e[e0] + offset)
        c1.append(e[after] + offset)
        for i in idx:
            lab = u["labels"][i]
            codes.append(names.setdefault(lab[2], len(names)))
            ctx.append([phones.setdefault(p, len(phones)) for p in lab[5]])
        waves.append(np.asarray(u["wave"], np.float32))
        offset += len(u["wave"])
    feats = np.ascontiguousarray(np.concatenate(feats), np.float32)
    jl = np.ascontiguousarray(np.concatenate(jl), np.float32)
    jr = np.ascontiguousarray(np.concatenate(jr), np.float32)
    joins = np.concatenate([jl, jr])
    stats = [feats.mean(axis=0), np.maximum(feats.std(axis=0), 1e-8),
             joins.mean(axis=0), np.maximum(joins.std(axis=0), 1e-8)]
    del joins
    mean_t, std_t, mean_j, std_j = (
        torch.from_numpy(x.astype(np.float32)).to(device, torch.float64) for x in stats)
    k = feats.shape[1] // jl.shape[1]
    sqrt_wt = torch.from_numpy(np.sqrt(np.tile(stream_weights(datadims, streams,
                                                              target_weights), k)))
    sqrt_wj = torch.from_numpy(np.sqrt(stream_weights(datadims, streams, join_weights)))
    sqrt_wt, sqrt_wj = sqrt_wt.to(device), sqrt_wj.to(device)

    def on(x):
        return torch.from_numpy(x).to(device, torch.float64)

    waves = torch.from_numpy(np.concatenate(waves)).to(device)
    return HalfphoneVoice(
        feats=feats, jr=jr,
        fw=(on(feats) - mean_t) / std_t * sqrt_wt,
        jlw=(on(jl) - mean_j) / std_j * sqrt_wj,
        jrw=(on(jr) - mean_j) / std_j * sqrt_wj,
        codes=torch.tensor(codes, dtype=torch.int64, device=device),
        ctx=torch.tensor(ctx, dtype=torch.int64, device=device).reshape(-1, 5),
        cut_start=torch.from_numpy(np.concatenate(c0)).to(device),
        cut_end=torch.from_numpy(np.concatenate(c1)).to(device),
        waves=waves, mean_t=mean_t, std_t=std_t, sqrt_wt=sqrt_wt,
        names=names, phones=phones, sample_rate=sample_rate)


@dataclass
class Targets:
    """Target utterances cut by the frame rule, on the device: ``tw`` (P, L,
    3 kd) f64 weighted, ``codes`` (P, L), ``ctx`` (P, L, 5) and ``kept``
    (P,) halfphone targets an utterance (steps past it are zeros and -1)."""
    tw: torch.Tensor
    codes: torch.Tensor
    ctx: torch.Tensor
    kept: list


def cut_targets(voice: HalfphoneVoice, utts: list) -> Targets:
    """The halfphone targets of target utterances (dicts of ``epochs``,
    ``features`` and ``labels``)."""
    rows, labels = [], []
    for u in utts:
        f = u["features"]
        idx, e0, mid, e1 = frames(u["labels"], u["epochs"], len(f), voice.sample_rate)
        rows.append(rows_of(f, e0, mid, e1))
        labels.append([u["labels"][i] for i in idx])
    P, L, W = len(rows), max(len(r) for r in rows), voice.fw.shape[1]
    dev = voice.fw.device
    tw = torch.zeros((P, L, W), dtype=torch.float64, device=dev)
    codes = torch.full((P, L), -1, dtype=torch.int64, device=dev)
    ctx = torch.full((P, L, 5), -1, dtype=torch.int64, device=dev)
    for p, (r, lab) in enumerate(zip(rows, labels)):
        tw[p, : len(r)] = voice.targets(r)
        codes[p, : len(r)], ctx[p, : len(r)] = voice.label_codes(lab)
    return Targets(tw=tw, codes=codes, ctx=ctx, kept=[len(r) for r in rows])


def penalties(tcodes, tctx, codes, ctx, weights: tuple, dtype) -> torch.Tensor:
    """(T, M) ranking penalties of targets against units: ``ID_PENALTY`` on
    a name mismatch, ``w_c * scale`` for each context slot ``c`` that
    differs (``weights`` = (w_0..w_4, scale)); exact in float32 and 64."""
    *w, scale = weights
    pen = (tcodes[:, None] != codes[None, :]).to(dtype) * ID_PENALTY
    for c, wc in enumerate(w):
        if wc:
            pen += (tctx[:, None, c] != ctx[None, :, c]).to(dtype) * (wc * scale)
    return pen


def _exact_keyed(t: torch.Tensor, rows: torch.Tensor, pen: torch.Tensor, n: int):
    """(squared distances, columns) (T, n) of the ``n`` least keys ``sum (t -
    u)^2 + pen`` of each target, in (key, column) order: the expanded product
    screens, every pair within its rounding of the n-th least key is summed
    again directly (as ``search._exact_nearest`` does without penalties)."""
    key = search._scores(t, rows, "f64") + pen
    nth = torch.topk(key, n, dim=1, largest=False).values.amax(dim=1, keepdim=True)
    slack = 1e-9 * ((t * t).sum(1, keepdim=True) + (rows * rows).sum(1).amax())
    r, c = torch.nonzero(key <= nth + slack, as_tuple=True)
    del key
    sq = torch.cat([((t[r[i: i + search.PAIRS]] - rows[c[i: i + search.PAIRS]]) ** 2).sum(1)
                    for i in range(0, r.shape[0], search.PAIRS)])
    exact = sq + pen[r, c]
    for k in range(3):                           # order by (row, key, column)
        o = torch.argsort((c, exact, r)[k], stable=True)
        r, c, exact, sq = r[o], c[o], exact[o], sq[o]
    counts = torch.bincount(r, minlength=t.shape[0])
    rank = torch.arange(r.shape[0], device=r.device) - (torch.cumsum(counts, 0) - counts)[r]
    keep = rank < n
    return sq[keep].reshape(t.shape[0], n), c[keep].reshape(t.shape[0], n)


def preselect(voice: HalfphoneVoice, tw, tcodes, tctx, n: int, weights: tuple,
              precision: str = "f64"):
    """(ids (T, n) int64, squared distances (T, n)) of the ``n`` least keys
    over the voice's units for each target, in (key, id) order (the
    control's ``tf32`` keys as they come)."""
    out_i, out_v = [], []
    for t0 in range(0, tw.shape[0], search.BLOCK_TARGETS):
        sl = slice(t0, t0 + search.BLOCK_TARGETS)
        if precision == "f64":
            pen = penalties(tcodes[sl], tctx[sl], voice.codes, voice.ctx, weights,
                            torch.float64)
            sq, i = _exact_keyed(tw[sl], voice.fw, pen, n)
        else:
            pen = penalties(tcodes[sl], tctx[sl], voice.codes, voice.ctx, weights,
                            torch.float32)
            sc = search._scores(tw[sl], voice.fw, precision)
            _, i = search.nearest(sc + pen, n)
            sq = torch.gather(sc, 1, i)
        out_i.append(i)
        out_v.append(sq)
    return torch.cat(out_i), torch.cat(out_v)


def lattice_costs(dist: torch.Tensor, unit_codes: torch.Tensor, tcodes: torch.Tensor):
    """Target costs of units at steps: the distance, raised to at least
    ``BIG`` where the unit's name is not the step's and the voice has the
    step's name (``tcodes`` >= 0)."""
    fallback = (unit_codes != tcodes) & (tcodes >= 0)
    return torch.where(fallback, torch.clamp(dist, min=BIG), dist)


def path_costs(voice: HalfphoneVoice, tw, tcodes, ids, lengths, jcw: float) -> torch.Tensor:
    """(B,) float64 cost of unit paths ``ids`` (B, T) over their first
    ``lengths`` steps: target costs (:func:`lattice_costs`) plus ``jcw``
    times the join distances."""
    T = ids.shape[1]
    live = torch.arange(T, device=ids.device)[None, :] < lengths[:, None]
    tc = lattice_costs(torch.sqrt(((voice.fw[ids] - tw) ** 2).sum(-1)), voice.codes[ids],
                       tcodes)
    jc = torch.sqrt(((voice.jlw[ids[:, 1:]] - voice.jrw[ids[:, :-1]]) ** 2).sum(-1))
    return (torch.where(live, tc, 0.0).sum(1)
            + jcw * torch.where(live[:, 1:], jc, 0.0).sum(1))


def overlap_add_flat(waves, cut_start, cut_end, lengths, taper: int, dtype=torch.float64):
    """(audio of B unit sequences end to end, offsets (B + 1,)): each
    sequence's ``search.overlap_add``, from cut points (B, T) of which the
    first ``lengths`` are live."""
    B, T = cut_start.shape
    dev = cut_start.device
    live = torch.arange(T, device=dev)[None, :] < lengths[:, None]
    span = torch.where(live, cut_end - cut_start, 0)
    t2 = 2 * taper
    offsets = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                         torch.cumsum(span.sum(1) + t2, 0)])
    anchors = offsets[:-1, None] + taper + torch.cumsum(span, 1) - span
    L = torch.where(live, span + t2, 0)
    p = torch.arange(int(L.max()), device=dev)
    src = cut_start[:, :, None] - taper + p
    dst = anchors[:, :, None] - taper + p
    keep = p < L[:, :, None]
    inside = (src >= 0) & (src < waves.shape[0])
    x = waves[src.clamp(0, waves.shape[0] - 1)].to(dtype)
    pos = p.to(dtype)
    rise = 0.5 - 0.5 * torch.cos(torch.pi * torch.clamp((pos + 0.5) / t2, max=1.0))
    fall = 0.5 - 0.5 * torch.cos(torch.pi * torch.clamp(
        (L.to(dtype)[:, :, None] - pos - 0.5) / t2, max=1.0))
    vals = torch.where(keep & inside, x * torch.minimum(rise, fall), 0.0)
    out = torch.zeros(int(offsets[-1]), dtype=dtype, device=dev)
    out.index_add_(0, torch.where(keep, dst, 0).reshape(-1), vals.reshape(-1))
    return out, offsets


def synthesise(voice: HalfphoneVoice, targets: Targets, asks: list, n: int, jcw: float,
               taper: int, weights: tuple, precision: str = "f64", batch: int = 16) -> list:
    """The reference's (or with ``precision="tf32"`` the control's) answer
    to each ask, (target utterance, halfphones): dicts of ``unit_ids``
    (int64 numpy), ``total`` (the search's own path total) and ``wave``
    (float32 numpy)."""
    dt = torch.float64 if precision == "f64" else torch.float32
    waves = voice.waves if precision == "f64" else voice.waves.to(torch.bfloat16).float()
    answers = [None] * len(asks)
    order = sorted(range(len(asks)), key=lambda i: asks[i][1])
    for g0 in range(0, len(order), batch):
        group = order[g0: g0 + batch]
        T = max(asks[i][1] for i in group)
        ids, tcs = [], []
        for i in group:
            p, m = asks[i]
            idx, sq = preselect(voice, targets.tw[p, :m], targets.codes[p, :m],
                                targets.ctx[p, :m], n, weights, precision)
            tc = lattice_costs(torch.sqrt(torch.clamp(sq, min=0.0)).to(dt), voice.codes[idx],
                               targets.codes[p, :m, None])
            ids.append(torch.nn.functional.pad(idx, (0, 0, 0, T - m)))
            tcs.append(torch.nn.functional.pad(tc, (0, 0, 0, T - m)))
        cand = torch.stack(ids)                                   # (B, T, n)
        jl, jr = voice.jlw[cand].to(dt), voice.jrw[cand].to(dt)
        lengths = [asks[i][1] for i in group]
        paths, totals = search.viterbi(torch.stack(tcs), jl, jr, lengths, jcw)
        unit_ids = torch.gather(cand, 2, paths[:, :, None])[:, :, 0]
        for b, i in enumerate(group):
            u = unit_ids[b, : lengths[b]]
            wave = search.overlap_add(waves, voice.cut_start[u], voice.cut_end[u], taper, dt)
            answers[i] = {"unit_ids": u.cpu().numpy(), "total": float(totals[b]),
                          "wave": wave.float().cpu().numpy()}
    return answers


def _check_block(voice, targets, answers, asks, block, jcw, taper, out):
    """``total_err`` and ``audio_err`` of the answers ``block`` (indices of
    sound answers, each with its wave), at once; an answer whose audio has
    another length than its units' counts as missing."""
    dev = voice.fw.device
    T = max(asks[i][1] for i in block)
    ids = torch.zeros((len(block), T), dtype=torch.int64)
    for b, i in enumerate(block):
        ids[b, : asks[i][1]] = torch.as_tensor(np.asarray(answers[i]["unit_ids"], np.int64))
    ids = ids.to(dev)
    pool = torch.tensor([asks[i][0] for i in block], device=dev)
    lengths = torch.tensor([asks[i][1] for i in block], device=dev)
    tw, tcodes = targets.tw[pool, :T], targets.codes[pool, :T]
    c = path_costs(voice, tw, tcodes, ids, lengths, jcw)
    total = torch.tensor([float(answers[i]["total_cost"]) for i in block],
                         dtype=torch.float64, device=dev)
    err = (total - c).abs() / torch.clamp(c, min=compare.TINY)
    out["total_err"] = max(out["total_err"], float(err.max()))
    ref, offsets = overlap_add_flat(voice.waves, voice.cut_start[ids], voice.cut_end[ids],
                                    lengths, taper)
    want = (offsets[1:] - offsets[:-1]).tolist()
    same = [len(answers[i]["wave"]) == w for i, w in zip(block, want)]
    out["missing"] += same.count(False)
    if not any(same):
        return
    waves = np.concatenate([np.asarray(answers[i]["wave"], np.float32) if ok
                            else np.zeros(w, np.float32) for i, ok, w in zip(block, same, want)])
    seg = torch.repeat_interleave(torch.arange(len(block), device=dev), offsets[1:] - offsets[:-1])
    diff = (torch.from_numpy(waves).to(dev).double() - ref).abs()
    worst = torch.zeros(len(block), dtype=torch.float64, device=dev)
    peak = torch.zeros(len(block), dtype=torch.float64, device=dev)
    worst.scatter_reduce_(0, seg, diff, "amax")
    peak.scatter_reduce_(0, seg, ref.abs(), "amax")
    rel = worst / torch.clamp(peak, min=1e-30)
    ok = torch.tensor(same, device=dev)
    out["audio_err"] = max(out["audio_err"], float(torch.where(ok, rel, 0.0).max()))


def numbers(voice: HalfphoneVoice, targets: Targets, answers: list, asks: list,
            sample: list, n_cand: int, jcw: float, taper: int, weights: tuple) -> dict:
    """The numbers of ``reference/compare.py`` for halfphone answers:
    ``asks`` gives each answer's (target utterance, halfphones), ``sample``
    the answers the reference searches itself."""
    out = {"missing": 0, "voice_leaks": 0, "total_err": 0.0, "audio_err": 0.0}
    M = voice.fw.shape[0]
    good = []
    for i, a in enumerate(answers):
        if a is None or len(a["unit_ids"]) != asks[i][1]:
            out["missing"] += 1
            continue
        ids = np.asarray(a["unit_ids"], np.int64)
        leaks = int(((ids < 0) | (ids >= M)).sum())
        out["voice_leaks"] += leaks
        if not leaks:
            good.append(i)
    for b0 in range(0, len(good), BLOCK_ANSWERS):
        _check_block(voice, targets, answers, asks, good[b0: b0 + BLOCK_ANSWERS], jcw, taper,
                     out)
    good = set(good)
    picked = [i for i in sample if i in good]
    refs = synthesise(voice, targets, [asks[i] for i in picked], n_cand, jcw, taper, weights)
    dev = voice.fw.device
    codes, ctx = voice.codes.cpu().numpy(), voice.ctx.cpu().numpy()
    gaps, differ, units = [], 0, 0
    for i, r in zip(picked, refs):
        p, m = asks[i]
        mine = np.asarray(answers[i]["unit_ids"], np.int64)
        both = torch.as_tensor(np.stack([mine, r["unit_ids"]]), device=dev)
        c_mine, c_ref = path_costs(voice, targets.tw[p, :m].expand(2, -1, -1),
                                   targets.codes[p, :m].expand(2, -1), both,
                                   torch.full((2,), m, device=dev), jcw).tolist()
        gaps.append(abs(c_mine - c_ref) / max(c_ref, compare.TINY))
        d = np.flatnonzero(mine != r["unit_ids"])
        a, b = mine[d], r["unit_ids"][d]
        same = ((voice.feats[a] == voice.feats[b]).all(1) & (voice.jr[a] == voice.jr[b]).all(1)
                & (codes[a] == codes[b]) & (ctx[a] == ctx[b]).all(1))
        differ += int((~same).sum())
        units += len(mine)
    out["cost_gap"] = max(gaps, default=0.0)
    out["cost_gap_median"] = float(np.median(gaps)) if gaps else 0.0
    out["id_mismatch"] = differ / max(units, 1)
    out["compared"] = len(picked)
    return out

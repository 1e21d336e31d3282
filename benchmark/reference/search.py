"""The reference search: exhaustive preselection of the ``n`` nearest units,
the Viterbi over them, the path's cost and its overlap-add, in float64.

The algorithm is the program's documented one (a frozen reading of the
float64 oracle ``snickery_tpu_torch/oracle.py``):

- preselection keeps, for each target, the ``n`` units of its voice with the
  least squared distance, in (distance, unit id) order;
- the target cost is the distance, the join cost the distance between the
  previous unit's right context and this unit's left context, weighted by
  the join cost weight; the Viterbi keeps, at each step and candidate, the
  first predecessor of least cost, and ends at the first candidate of least
  total;
- the overlap-add places the units' spans back to back, each extended by
  ``taper`` samples a side, under complementary raised-cosine ramps over
  ``2 * taper`` samples.

``precision="tf32"`` computes the same search as a lower-precision program
would: distances by the expanded product with its operands rounded to TF32,
no exact rescore, float32 lattice costs, and the audio from waves held in
bfloat16.  The benchmark's control runs it in the program's place.
"""

from __future__ import annotations

import math

import torch

BLOCK_ROWS = 131072
BLOCK_TARGETS = 1024
PAIRS = 1 << 18          # (target, row) pairs summed directly at a time


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 ``x`` rounded to TF32's 10 mantissa bits (to nearest, ties even)."""
    i = x.contiguous().view(torch.int32).to(torch.int64)
    lsb = (i >> 13) & 1
    i = (i + 0x0FFF + lsb) & ~0x1FFF
    return i.to(torch.int32).view(torch.float32)


def _scores(tw: torch.Tensor, rows: torch.Tensor, precision: str) -> torch.Tensor:
    """Squared distances (T, m) of targets to rows."""
    if precision == "f64":
        return ((tw * tw).sum(1)[:, None] + (rows * rows).sum(1)[None, :]
                - 2.0 * tw @ rows.T)
    t32, r32 = tw.float(), rows.float()
    return ((t32 * t32).sum(1)[:, None] + (r32 * r32).sum(1)[None, :]
            - 2.0 * to_tf32(t32) @ to_tf32(r32).T)


def nearest(sc: torch.Tensor, n: int):
    """(values, columns) (T, n) of the ``n`` least of each row of ``sc`` in
    (value, column) order: every value under the n-th least, then the
    lowest columns among those equal to it."""
    nth = torch.topk(sc, n, dim=1, largest=False).values.amax(dim=1, keepdim=True)
    less = sc < nth
    room = n - less.sum(dim=1, keepdim=True)
    equal = sc == nth
    keep = less | (equal & (torch.cumsum(equal, dim=1) <= room))
    cols = torch.nonzero(keep)[:, 1].reshape(sc.shape[0], n)
    vals = torch.gather(sc, 1, cols)
    o = torch.argsort(vals, dim=1, stable=True)
    return torch.gather(vals, 1, o), torch.gather(cols, 1, o)


def _exact_nearest(t: torch.Tensor, rows: torch.Tensor, n: int):
    """:func:`nearest` of the exact float64 squared distances, ``sum (t -
    u)^2``: the expanded product screens, every pair within its rounding of
    the n-th least is summed again directly (so bit-identical rows tie
    exactly, at 0 for a target equal to a row), and the least ``n`` are kept
    in (distance, column) order."""
    sc = _scores(t, rows, "f64")
    nth = torch.topk(sc, n, dim=1, largest=False).values.amax(dim=1, keepdim=True)
    slack = 1e-9 * ((t * t).sum(1, keepdim=True) + (rows * rows).sum(1).amax())
    r, c = torch.nonzero(sc <= nth + slack, as_tuple=True)
    del sc
    exact = torch.cat([((t[r[i: i + PAIRS]] - rows[c[i: i + PAIRS]]) ** 2).sum(1)
                       for i in range(0, r.shape[0], PAIRS)])
    for k in range(3):                           # order by (row, distance, column)
        o = torch.argsort((c, exact, r)[k], stable=True)
        r, c, exact = r[o], c[o], exact[o]
    counts = torch.bincount(r, minlength=t.shape[0])
    rank = torch.arange(r.shape[0], device=r.device) - (torch.cumsum(counts, 0) - counts)[r]
    keep = rank < n
    return exact[keep].reshape(t.shape[0], n), c[keep].reshape(t.shape[0], n)


def preselect(tw: torch.Tensor, fw: torch.Tensor, lo: int, hi: int, n: int,
              precision: str = "f64"):
    """(ids (T, n) int64, squared distances (T, n)) of the ``n`` nearest of
    rows ``lo:hi`` of ``fw`` to each target row of ``tw``, in (distance, id)
    order, ties to the lowest id.  Exact float64 (or the control's ``tf32``
    ranking, which takes its expanded products as they come)."""
    out_i, out_v = [], []
    for t0 in range(0, tw.shape[0], BLOCK_TARGETS):
        t = tw[t0: t0 + BLOCK_TARGETS]
        best_v = best_i = None
        for r0 in range(lo, hi, BLOCK_ROWS):
            r1 = min(r0 + BLOCK_ROWS, hi)
            k = min(n, r1 - r0)
            if precision == "f64":
                v, i = _exact_nearest(t, fw[r0:r1], k)
            else:
                v, i = nearest(_scores(t, fw[r0:r1], precision), k)
            i = i + r0
            if best_v is not None:
                # the earlier blocks' ids are all lower: in (value, id) order
                # a stable sort by value of [earlier, this] is exact
                v, i = torch.cat([best_v, v], 1), torch.cat([best_i, i], 1)
                o = torch.argsort(v, dim=1, stable=True)[:, :n]
                v, i = torch.gather(v, 1, o), torch.gather(i, 1, o)
            best_v, best_i = v, i
        out_i.append(best_i)
        out_v.append(best_v)
    return torch.cat(out_i), torch.cat(out_v)


def viterbi(tc: torch.Tensor, jl: torch.Tensor, jr: torch.Tensor, lengths, jcw: float):
    """Batched Viterbi: target costs (B, T, N), left and right contexts
    (B, T, N, d), live steps ``lengths`` (B,) -> (paths (B, T) int64 over
    the candidates, totals (B,)), in ``tc``'s dtype; steps past a length
    keep the path's end."""
    B, T, N = tc.shape
    dev = tc.device
    lengths = torch.as_tensor(lengths, device=dev)
    cost = tc[:, 0].clone()
    back = torch.zeros((B, T, N), dtype=torch.int64, device=dev)
    ar = torch.arange(N, device=dev)
    for t in range(1, T):
        diff = jr[:, t - 1][:, :, None, :] - jl[:, t][:, None, :, :]
        dist = torch.sqrt(torch.clamp((diff * diff).sum(-1), min=0.0))
        trans = cost[:, :, None] + jcw * dist                    # (B, prev, cur)
        arg = torch.argmin(trans, dim=1)
        new = torch.gather(trans, 1, arg[:, None, :])[:, 0] + tc[:, t]
        live = (t < lengths)[:, None]
        cost = torch.where(live, new, cost)
        back[:, t] = torch.where(live, arg, ar[None, :])
    last = torch.argmin(cost, dim=1)
    total = torch.gather(cost, 1, last[:, None])[:, 0]
    paths = torch.zeros((B, T), dtype=torch.int64, device=dev)
    cur = last
    for t in range(T - 1, -1, -1):
        paths[:, t] = cur
        cur = torch.gather(back[:, t], 1, cur[:, None])[:, 0]
    return paths, total


def path_costs(tw: torch.Tensor, ids: torch.Tensor, fw, jlw, jrw, jcw: float) -> torch.Tensor:
    """float64 cost of one unit path: the sum of its target distances and
    ``jcw`` times the sum of its join distances."""
    tc = torch.sqrt(((fw[ids] - tw) ** 2).sum(-1))
    jc = torch.sqrt(((jlw[ids[1:]] - jrw[ids[:-1]]) ** 2).sum(-1))
    return tc.sum() + jcw * jc.sum()


def overlap_add(waves: torch.Tensor, cut_start: torch.Tensor, cut_end: torch.Tensor,
                taper: int, dtype=torch.float64) -> torch.Tensor:
    """Audio of one unit sequence (see the module's docstring)."""
    span = (cut_end - cut_start).long()
    t2 = 2 * taper
    total = int(span.sum()) + t2
    anchors = taper + torch.cumsum(span, 0) - span
    L = span + t2
    p = torch.arange(int(L.max()), device=waves.device)
    src = cut_start.long()[:, None] - taper + p
    dst = anchors[:, None] - taper + p
    keep = p[None, :] < L[:, None]
    inside = (src >= 0) & (src < waves.shape[0])
    x = waves[src.clamp(0, waves.shape[0] - 1)].to(dtype)
    pos = p.to(dtype)[None, :]
    rise = 0.5 - 0.5 * torch.cos(math.pi * torch.clamp((pos + 0.5) / t2, max=1.0))
    fall = 0.5 - 0.5 * torch.cos(math.pi * torch.clamp((L.to(dtype)[:, None] - pos - 0.5) / t2,
                                                       max=1.0))
    vals = torch.where(keep & inside, x * torch.minimum(rise, fall), 0.0)
    out = torch.zeros(total, dtype=dtype, device=waves.device)
    out.index_add_(0, torch.where(keep, dst, 0).reshape(-1), vals.reshape(-1))
    return out


def synthesise(voice, features: list, voice_ids: list, n: int, jcw: float, taper: int,
               precision: str = "f64", batch: int = 16) -> list:
    """The reference's (or with ``precision="tf32"`` the control's) answer
    to each target trajectory: dicts of ``unit_ids`` (int64 numpy), ``total``
    (the search's own path total) and ``wave`` (float32 numpy)."""
    dt = torch.float64 if precision == "f64" else torch.float32
    waves = voice.waves if precision == "f64" else voice.waves.to(torch.bfloat16).float()
    answers = [None] * len(features)
    order = sorted(range(len(features)), key=lambda i: (voice_ids[i], len(features[i])))
    for g0 in range(0, len(order), batch):
        group = order[g0: g0 + batch]
        tws = [voice.targets(features[i]) for i in group]
        T = max(t.shape[0] for t in tws)
        ids, tcs = [], []
        for i, tw in zip(group, tws):
            lo, hi = voice.voice_rows[voice_ids[i]]
            idx, sq = preselect(tw, voice.fw, lo, hi, n, precision)
            pad = T - tw.shape[0]
            ids.append(torch.nn.functional.pad(idx, (0, 0, 0, pad)))
            tcs.append(torch.nn.functional.pad(torch.sqrt(torch.clamp(sq, min=0.0)).to(dt),
                                               (0, 0, 0, pad)))
        cand = torch.stack(ids)                                   # (B, T, n)
        tc = torch.stack(tcs)
        jl, jr = voice.jlw[cand].to(dt), voice.jrw[cand].to(dt)
        lengths = [t.shape[0] for t in tws]
        paths, totals = viterbi(tc, jl, jr, lengths, jcw)
        unit_ids = torch.gather(cand, 2, paths[:, :, None])[:, :, 0]
        for b, i in enumerate(group):
            u = unit_ids[b, : lengths[b]]
            wave = overlap_add(waves, voice.cut_start[u], voice.cut_end[u], taper, dt)
            answers[i] = {"unit_ids": u.cpu().numpy(), "total": float(totals[b]),
                          "wave": wave.float().cpu().numpy()}
    return answers

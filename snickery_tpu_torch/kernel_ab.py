"""Times and checksums of the stream preselect kernels and of the decode
kernels at the main-path shapes, for comparing two trees of this package on
one card in one run.

    python -m snickery_tpu_torch.kernel_ab [--label NAME] [--reps 3] [--only CASES]
                                           [--split] [--out FILE]

The data are the kernel sweep's (:func:`sweep_topk.make_data`: AR(1) rows,
d 151, seed 0), so two trees see the same tensors.  Cases, all
``select="stream"``:

- 65,536 targets x 1,048,576 units (the config-3 batch shape): the
  zero-transient kernel at "highest" (k 40) and "split3cat" (k 48), the
  derived-operand kernel at "highest" (k 30) and "split3cat" (k 48);
- 64 targets x 1,048,576 units (a config-4 chunk): both "split3cat" forms;
- 2,048 targets x 8,388,608 units (the capacity shape, the block tiled x8
  on the card): the zero-transient kernel at "split3" (k 40);
- the small grids (:data:`SMALL_CASES`, zero-transient form, AR(1) rows of
  the same recipe, seeded per case): natural synthesis (1,024 of the
  voice's own rows as targets against its 49,527 rows padded to 57,344,
  "highest", k 40); a config-5 chunk (8 voices of 32,768 rows and 4,096
  padding rows, 56 targets of voice 2 and 8 dead ones, voice id -1,
  "split3cat" with the partition mask, k 48); a config-5 step (64
  utterances of 256 steps, one voice each, the tail of some dead,
  "highest" with the partition mask, k 40); a config-2 step (512 x 57,344
  x 453, the quinphone penalties, k 30); natural synthesis and the config-2
  step again at "split3cat" (k 48 and 40), whose target tiles run as
  thread-block clusters.  A last line gives what the card holds at once of
  the batch shape's first pass at "split3cat", by cluster size.

Each case prints one JSON line: the median of ``--reps`` timed launches
(CUDA events, after a warm-up) and the SHA-256 of the returned ids and of
the returned scores (bytes of the contiguous host copies).  At "highest"
every score is one ascending chain of ``fmaf`` and at the split precisions
one ``wgmma`` chain over the columns, and the selection is exact, so two
trees whose mainloops agree print the same digests.  To compare with an
older tree, copy this file into that tree's package and run it there
(``--label parent``), in the same command as the run on this tree.  Needs a
CUDA card.

``--split`` adds, per case, the time of each pass (``torch.profiler``'s
device time of the ``topk_partial*`` and ``topk_merge*`` kernels, mean of
``--reps`` calls) at k = 1, 8, 40 and 64 (the small grids and the chunks)
or at the case's own k (the batch shapes): the mainloop does not depend on
k, so the slope in k is the list phase.

The decode cases (:data:`DECODE_AB_CASES`, numpy-seeded lattices of
uniform [0, 5) target costs and N(0, 0.3^2) contexts, through the public
wrappers ``viterbi_decode``, ``greedy_decode`` and ``greedy_decode_stream``
only, so that the file runs in an older tree): config 3's Viterbi and greedy
at 32 x 2,048 x 30 x 151 all live, the same lattice with ragged lengths
(Viterbi at ``search_epsilon`` 0.3), a 64-step stream chunk with 32 live
steps, and one utterance of 650 steps.  Each prints the median time of
``--reps`` launches and the SHA-256 of the paths and of the totals (a
chunk's outgoing context).  :data:`PR13_DECODE_DIGESTS` records what the
first decode kernels (one CTA an utterance) printed for them on an NVIDIA
H100 80GB HBM3; the Viterbi kept their summation order, so
``chip_smoke.py`` holds its cases to them (greedy now sums a distance in
one thread, where they summed it over a warp).

:data:`FIRST_DESIGN_DIGESTS` records what the first design of the kernels
(64 x 64 tiles, a dense selection after every tile) printed for the two
"highest" cases, and :data:`PR9_DIGESTS` what the kernels of PR 9 (PR 7's
mainloops) printed for every case, on an NVIDIA H100 80GB HBM3;
``chip_smoke.py`` holds today's to them.
"""

from __future__ import annotations

import argparse
import hashlib
import inspect
import json
import subprocess
import sys

import numpy as np
import torch

from snickery_tpu_torch import sweep_topk
from snickery_tpu_torch.ops import cuda_topk
from snickery_tpu_torch.ops.cuda_topk import cuda_topk_preselect, derive_operand, pack_meta
from snickery_tpu_torch.synthetic_voices import ar1_walks
from snickery_tpu_torch.voicedb.device_layout import build_raw_blocks

KD = 151
UNITS = 1 << 20
CASES = (  # (name, T, tiles of the block, zero_transient, precision, k)
    ("zt_highest", 65536, 1, True, "highest", 40),
    ("dv_highest", 65536, 1, False, "highest", 30),
    ("zt_split3cat", 65536, 1, True, "split3cat", 48),
    ("dv_split3cat", 65536, 1, False, "split3cat", 48),
    ("zt_split3cat_chunk", 64, 1, True, "split3cat", 48),
    ("dv_split3cat_chunk", 64, 1, False, "split3cat", 48),
    ("zt_split3_capacity", 2048, 8, True, "split3", 40),
)
VOICE_ROWS = 32768       # rows of one voice of the config-5 cases
# small grids, zero-transient form: name: (T, m_rows, real rows, kd, precision, k, masks)
SMALL_CASES = {
    "zt_natural": (1024, 57344, 49527, KD, "highest", 40, "none"),
    "zt_split3cat_part_chunk": (64, 8 * VOICE_ROWS + 4096, 8 * VOICE_ROWS, KD, "split3cat",
                                48, "part"),
    "zt_part_config5": (16384, 8 * VOICE_ROWS, 8 * VOICE_ROWS, KD, "highest", 40, "part"),
    "zt_ling_config2": (512, 57344, 57344, 453, "highest", 30, "ling"),
    "zt_split3cat_natural": (1024, 57344, 49527, KD, "split3cat", 48, "none"),
    "zt_split3cat_ling_config2": (512, 57344, 57344, 453, "split3cat", 40, "ling"),
}
# the partition kernels' span edge cases, 300 targets x 151 dims: name: (precision, k,
# the DB's voice-id runs (id, rows); -1 the padding rows)
SPAN_CASES = {
    "span_unaligned": ("highest", 40, ((0, 1000), (1, 5003), (2, 37), (-1, 200))),
    "span_gaps": ("split3cat", 48, ((3, 500), (0, 700), (7, 300), (3, 129), (-1, 90))),
    "span_padding_only": ("highest", 40, ((-1, 1500),)),
}
SPLIT_K = (1, 8, 40, 64)   # --split: the k-sweep of the small grids and the chunks
# case: (ids_sha256, scores_sha256) of the first design
FIRST_DESIGN_DIGESTS = {"zt_highest": ("42687863318a6959", "c62f05eb8d61ae14"),
                        "dv_highest": ("8daee431bb4b3206", "0a6414f3590d49e4")}
# case: (ids_sha256, scores_sha256) of the kernels of PR 9
PR9_DIGESTS = {
    "zt_highest": ("42687863318a6959", "c62f05eb8d61ae14"),
    "dv_highest": ("8daee431bb4b3206", "0a6414f3590d49e4"),
    "zt_split3cat": ("851a41ab2faff505", "59d5b161defd4378"),
    "dv_split3cat": ("e885d548d748afa0", "72ea968ab3e12282"),
    "zt_split3cat_chunk": ("2a491fbe1bc6a251", "ec3f8d94aa9df12e"),
    "dv_split3cat_chunk": ("dffeb590dac9d764", "c96f13582211d12a"),
    "zt_split3_capacity": ("47859fb9de478683", "d3fdcf429a73255c"),
    "zt_natural": ("1955f463db82bfd1", "5b133d9c6d35c765"),
    "zt_split3cat_part_chunk": ("46233cb6623a1762", "9346db933939521a"),
    "zt_part_config5": ("eff57b97977ef89d", "1e07b0ebd946331d"),
    "zt_ling_config2": ("5ab19870444ecd42", "ed16d5074f58c21c"),
    "span_unaligned": ("3e4d10ee9c610aa8", "c0ac60bcf92e068b"),
    "span_gaps": ("4c0bc3770ebef4ed", "39e19a847a80edaf"),
    "span_padding_only": ("609d6b6ba89016a0", "7423375f832efff6")}


# decode cases: name: (kind, B, T, N, dj, lengths, search_epsilon); lengths "full" (all T
# live), "ragged" (seeded, 1 to T, one utterance of 1 step and one of 0), or a stream
# chunk's live steps
DECODE_AB_CASES = {
    "decode_viterbi_config3": ("viterbi", 32, 2048, 30, KD, "full", 0.0),
    "decode_greedy_config3": ("greedy", 32, 2048, 30, KD, "full", 0.0),
    "decode_viterbi_config3_ragged_eps": ("viterbi", 32, 2048, 30, KD, "ragged", 0.3),
    "decode_greedy_config3_ragged": ("greedy", 32, 2048, 30, KD, "ragged", 0.0),
    "decode_stream_chunk": ("stream", 1, 64, 30, KD, 32, 0.0),
    "decode_viterbi_single": ("viterbi", 1, 650, 30, KD, "full", 0.0),
}
DECODE_JCW = 0.7
# case: (paths_sha256, totals_sha256) of the first decode kernels
PR13_DECODE_DIGESTS = {
    "decode_viterbi_config3": ("8189674c28a28a20", "25f986cfd474445d"),
    "decode_greedy_config3": ("9f422a8fbf5cbf42", "6c7794306a3fa943"),
    "decode_viterbi_config3_ragged_eps": ("3703fef2160dd259", "c34c88100acc39d9"),
    "decode_greedy_config3_ragged": ("e935f59acb085220", "35886aff93c46333"),
    "decode_stream_chunk": ("f815258f1bb50806", "bddb7e94b3e24f67"),
    "decode_viterbi_single": ("60c1a780e955e8a5", "9e8c6dcc0d7b23af")}


def digest(t: torch.Tensor) -> str:
    return hashlib.sha256(t.contiguous().cpu().numpy().tobytes()).hexdigest()[:16]


def card_line() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()


def small_case(name: str, dev) -> tuple:
    """(targets, raw block, affine, m_rows, k, precision, mask kwargs) of one
    of :data:`SMALL_CASES` on ``dev``, made with numpy from a seed of its
    own: AR(1) walks as in :func:`sweep_topk.make_data`, padded to m_rows
    with the never-wins sentinel rows."""
    T, m_rows, n_real, kd, precision, k, masks = SMALL_CASES[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    walk = sweep_topk.WALK
    feats = ar1_walks(rng, -(-n_real // walk), walk, kd).reshape(-1, kd)[:n_real]
    feats = np.ascontiguousarray(feats * rng.uniform(0.5, 2.0, kd).astype(np.float32)
                                 + rng.standard_normal(kd).astype(np.float32))
    mean, std = feats.mean(0), feats.std(0)
    aff = (mean.astype(np.float32), std.astype(np.float32), np.ones(kd, np.float32))
    jr = np.empty_like(feats)
    jr[:-1], jr[-1] = feats[1:], feats[0]
    raw = build_raw_blocks(feats, jr, m_rows, affine=aff)[0]
    if name.endswith("natural"):         # the voice's own rows, as natural synthesis
        targets = (feats[8192:8192 + T] - mean) / std
    else:
        targets = ar1_walks(rng, -(-T // walk), walk, kd).reshape(-1, kd)[:T]
    targets = np.ascontiguousarray(targets, np.float32)
    kw = {}
    if masks == "ling":
        kw = sweep_topk.make_masks(T, m_rows, 0, "ling", dev)
    elif masks == "part":
        dv = np.full(m_rows, -1, np.int32)
        dv[:n_real] = np.arange(n_real) // VOICE_ROWS
        if T == 64:                      # a chunk of voice 2, its last 8 steps dead
            tv = np.full(T, 2, np.int32)
            tv[56:] = -1
        else:                            # utterances of 256 steps, one voice each
            step, utt = np.arange(T) % 256, np.arange(T) // 256
            tv = np.where(step < 256 - 3 * (utt % 7), utt % 8, -1).astype(np.int32)
        targets[tv < 0] = 0.0            # dead steps carry zeroed targets
        zeros = lambda n: torch.zeros(n, dtype=torch.int32)
        kw = dict(tgt_meta=pack_meta(zeros(T), zeros((T, 5)), torch.from_numpy(tv)).to(dev),
                  db_meta=pack_meta(zeros(m_rows), zeros((m_rows, 5)),
                                    torch.from_numpy(dv)).to(dev),
                  partition=True, ling_weights=None)
        if "voice_spans" in inspect.signature(cuda_topk_preselect).parameters:
            kw["voice_spans"] = cuda_topk.voice_spans_of(kw["db_meta"][:, 6], m_rows)
    to = lambda a: torch.from_numpy(a).to(dev)
    return (to(targets), to(raw), tuple(map(to, aff)), m_rows, k, precision, kw)


def span_case(name: str, dev, precision: str | None = None, zero_transient: bool = True):
    """(targets, DB rows, affine or None, m_rows, k, precision, kwargs) of
    one of :data:`SPAN_CASES` on ``dev``, seeded by its name: AR(1) rows
    whose voice ids run as the case says (a voice of 37 rows is shorter
    than k; "span_gaps" has ids 0, 3, 7 and voice 3 in two runs; a padding
    shard has no live row); 300 targets in runs of 40 steps of one voice
    (so tiles span two voices), one in ten dead (voice id -1, target
    zeroed), one of an id no row has and one of id -5.  ``precision``
    overrides the case's; ``zero_transient=False`` gives the derived
    operand (``raw`` the operand, ``kw["sqn"]`` its norms)."""
    own, k, runs = SPAN_CASES[name]
    precision = precision or own
    k = k if precision == own else (48 if precision == "split3cat" else 40)
    dv = np.concatenate([np.full(n, v, np.int32) for v, n in runs])
    m_rows, T = len(dv), 300
    rng = np.random.default_rng(sum(map(ord, name)))
    feats = ar1_walks(rng, -(-m_rows // sweep_topk.WALK), sweep_topk.WALK, KD).reshape(-1, KD)
    feats = np.ascontiguousarray(feats[:m_rows])
    aff = (feats.mean(0), feats.std(0), np.ones(KD, np.float32))
    jr = np.roll(feats, -1, 0)
    n_real = int(np.sum(dv >= 0))
    order = np.argsort(dv < 0, kind="stable")          # padding rows last, as a DB has them
    dv = dv[order]
    raw = build_raw_blocks(feats[order][:n_real], jr[order][:n_real], m_rows, affine=aff)[0]
    live = np.unique(dv[dv >= 0]) if n_real else np.array([0], np.int32)
    tv = np.repeat(rng.choice(live, -(-T // 40)), 40)[:T].astype(np.int32)
    tv[rng.random(T) < 0.1] = -1
    tv[T // 3], tv[T // 2] = 99, -5
    targets = rng.standard_normal((T, KD)).astype(np.float32)
    targets[tv < 0] = 0.0
    zeros = lambda n: torch.zeros(n, dtype=torch.int32)
    kw = dict(tgt_meta=pack_meta(zeros(T), zeros((T, 5)), torch.from_numpy(tv)).to(dev),
              db_meta=pack_meta(zeros(m_rows), zeros((m_rows, 5)), torch.from_numpy(dv)).to(dev),
              partition=True, ling_weights=None)
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    block, aff = to(raw), tuple(map(to, aff))
    if not zero_transient:
        block, sqn = derive_operand(block, aff, n_real, m_rows, precision)
        kw, aff = dict(kw, zero_transient=False, sqn=sqn), None
    if "voice_spans" in inspect.signature(cuda_topk_preselect).parameters:
        kw["voice_spans"] = cuda_topk.voice_spans_of(kw["db_meta"][:, 6], m_rows)
    return to(targets), block, aff, m_rows, k, precision, kw


def pass_times(call, reps: int) -> tuple:
    """(pass 1 ms, pass 2 ms) of ``call``: the mean device time of the
    ``topk_partial*`` and ``topk_merge*`` kernels over ``reps`` calls, from
    ``torch.profiler``; None where the profiler saw no device time."""
    from torch.profiler import ProfilerActivity, profile
    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            call()
        torch.cuda.synchronize()
    total = {"topk_partial": 0.0, "topk_merge": 0.0}
    for evt in prof.key_averages():
        us = getattr(evt, "device_time_total", None)
        if us is None:
            us = getattr(evt, "cuda_time_total", 0.0)
        for key in total:
            if key in evt.key:
                total[key] += us
    return tuple(v / reps / 1e3 if v > 0 else None for v in total.values())


def case_calls(names, dev):
    """(name, T, m_rows, kd, k, precision, call(k)) for each case in
    ``names``, built one at a time on ``dev`` (the batch cases share the
    sweep's 1,048,576-row data)."""
    big = None
    for name, T, tiles, zt, precision, k in CASES:
        if name not in names:
            continue
        if big is None:
            tg_np, raw_np, aff_np = sweep_topk.make_data(65536, UNITS, KD, 0, 0, False)
            big = (torch.from_numpy(tg_np).to(dev), torch.from_numpy(raw_np).to(dev),
                   tuple(torch.from_numpy(a).to(dev) for a in aff_np))
        tg, raw, aff = big
        block = raw if tiles == 1 else raw.repeat(tiles, 1)
        m_rows = block.shape[0]
        x = tg[:T].contiguous()
        if zt:
            kw = dict(db_affine=aff)
        else:
            block, sqn = derive_operand(block, aff, m_rows, m_rows, precision)
            kw = dict(db_affine=None, zero_transient=False, sqn=sqn)
        yield (name, T, m_rows, KD, k, precision,
               lambda kk, x=x, block=block, kw=kw, m_rows=m_rows, p=precision:
               cuda_topk_preselect(x, block, kk, m_rows=m_rows, precision=p, **kw))
        del block, kw
        torch.cuda.empty_cache()
    for name in (*SMALL_CASES, *SPAN_CASES):
        if name not in names:
            continue
        make = small_case if name in SMALL_CASES else span_case
        x, raw, aff, m_rows, k, precision, kw = make(name, dev)
        yield (name, x.shape[0], m_rows, x.shape[1], k, precision,
               lambda kk, x=x, raw=raw, aff=aff, m_rows=m_rows, p=precision, kw=kw:
               cuda_topk_preselect(x, raw, kk, aff, m_rows, precision=p, **kw))
        del x, raw, kw
        torch.cuda.empty_cache()


ALL_CASES = tuple(c[0] for c in CASES) + tuple(SMALL_CASES) + tuple(SPAN_CASES)


def decode_lattice(name: str, dev, shapes: dict | None = None) -> dict:
    """One of :data:`DECODE_AB_CASES` on ``dev``: the lattice made with numpy
    from a seed of its shape (so the config-3 cases share one, kept in
    ``shapes`` where given), ragged lengths from a seed of the name."""
    kind, B, T, N, dj, lens, eps = DECODE_AB_CASES[name]
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    key = (B, T, N, dj)
    if shapes is None or key not in shapes:
        rng = np.random.default_rng(100003 * B + 31 * T + N)
        tc = rng.uniform(0.0, 5.0, (B, T, N)).astype(np.float32)
        jl = 0.3 * rng.standard_normal((B, T, N, dj), dtype=np.float32)
        jr = 0.3 * rng.standard_normal((B, T, N, dj), dtype=np.float32)
        made = (to(tc), to(jl), to(jr))
        del tc, jl, jr
        if shapes is None:
            shapes = {}
        shapes[key] = made
    tc, jl, jr = shapes[key]
    lat = dict(kind=kind, tc=tc, jl=jl, jr=jr, eps=eps, length=None)
    if lens == "ragged":
        length = np.random.default_rng(sum(map(ord, name))).integers(1, T + 1, B)
        length[1], length[2] = 1, 0
        lat["length"] = to(length.astype(np.int64))
    if kind == "stream":
        ctx = 0.3 * np.random.default_rng(7).standard_normal(dj, dtype=np.float32)
        lat.update(tc=lat["tc"][0], jl=lat["jl"][0], jr=lat["jr"][0], init_ctx=to(ctx),
                   n_live=lens)
    lat["live_steps"] = (lens if kind == "stream" else
                         B * T if lat["length"] is None else int(lat["length"].clamp(1).sum()))
    return lat


def decode_call(lat: dict):
    """The public wrapper's call on a :func:`decode_lattice` lattice."""
    from snickery_tpu_torch.ops import viterbi as vit
    if lat["kind"] == "stream":
        return lambda: vit.greedy_decode_stream(lat["tc"], lat["jl"], lat["jr"], lat["init_ctx"],
                                                DECODE_JCW, DECODE_JCW, lat["n_live"])
    if lat["kind"] == "viterbi":
        return lambda: vit.viterbi_decode(lat["tc"], lat["jl"], lat["jr"], DECODE_JCW,
                                          lat["eps"], lat["length"])
    return lambda: vit.greedy_decode(lat["tc"], lat["jl"], lat["jr"], DECODE_JCW, lat["length"])


def run_decode_cases(label: str = "change", reps: int = 10, only=()) -> list[dict]:
    """Time and digest the decode cases named in ``only`` (all if empty) on
    the current CUDA device, one dict a case."""
    dev = torch.device("cuda")
    card = card_line()
    lines, shapes = [], {}
    for name in DECODE_AB_CASES:
        if only and name not in only:
            continue
        lat = decode_lattice(name, dev, shapes)
        ms, (paths, second) = sweep_topk.time_call(decode_call(lat), reps, dev)
        kind, B, T, N, dj, _, eps = DECODE_AB_CASES[name]
        lines.append({"label": label, "case": name, "kind": kind, "B": B, "T": T, "N": N,
                      "dj": dj, "eps": eps, "live_steps": lat["live_steps"], "ms": ms,
                      "paths_sha256": digest(paths), "totals_sha256": digest(second),
                      "card": card})
        del lat, paths, second
    del shapes
    torch.cuda.empty_cache()
    return lines


def run_cases(label: str = "change", reps: int = 3, only=(), split: bool = False) -> list[dict]:
    """Time and digest the cases named in ``only`` (all if empty) on the
    current CUDA device; one dict a case (the JSON lines of the module),
    with ``split`` the pass times of the k-sweep under ``"split"``."""
    dev = torch.device("cuda")
    card = card_line()
    lines = []
    for name, T, m_rows, kd, k, precision, call in case_calls(set(only or ALL_CASES), dev):
        ms, (ids, scores) = sweep_topk.time_call(lambda: call(k), reps, dev)
        line = {"label": label, "case": name, "T": T, "m_rows": m_rows, "kd": kd, "k": k,
                "precision": precision, "ms": ms, "ids_sha256": digest(ids),
                "scores_sha256": digest(scores), "card": card}
        if split:
            ks = SPLIT_K if T <= 16384 else (k,)
            line["split"] = []
            for kk in ks:
                kk_ms = sweep_topk.time_call(lambda: call(kk), reps, dev)[0]
                p1, p2 = pass_times(lambda: call(kk), reps)
                line["split"].append({"k": kk, "ms": kk_ms, "pass1_ms": p1, "pass2_ms": p2})
        lines.append(line)
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--label", default="change")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--only", default="",
                    help="comma list of case names, preselect or decode (default: all)")
    ap.add_argument("--split", action="store_true",
                    help="also time pass 1 and pass 2 apart, over the k-sweep")
    ap.add_argument("--out", default="", help="also append the JSON lines to this file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    only = set(filter(None, args.only.split(",")))
    unknown = only - set(ALL_CASES) - set(DECODE_AB_CASES)
    if unknown:
        ap.error(f"unknown cases {sorted(unknown)}; have {ALL_CASES + tuple(DECODE_AB_CASES)}")
    pre = only & set(ALL_CASES) if only else set(ALL_CASES)
    dec = only & set(DECODE_AB_CASES) if only else set(DECODE_AB_CASES)
    lines = run_cases(args.label, args.reps, pre, args.split) if pre else []
    if pre and hasattr(cuda_topk, "max_active_clusters"):
        lines.append({"label": args.label, "case": "occupancy", "kd": KD, "k": 48,
                      "max_active_clusters": {c: cuda_topk.max_active_clusters(KD, 48, c)
                                              for c in (1, 2, 4)},
                      "card": card_line()})
    if dec:
        lines += run_decode_cases(args.label, args.reps, dec)
    for line in lines:
        print(json.dumps(line), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Sweep of the preselect kernel over its precisions and selection forms.

    python -m snickery_tpu_torch.sweep_topk --combos "split3cat,stream split3cat,packed"

Counterpart of ``scripts/bench_topk.py`` for the PyTorch/CUDA port: it times
``cuda_topk_preselect`` at one shape (by default 16,384 target rows x
1,048,576 units x 151 dims, k 30) for each ``precision,select`` combination
and prints one line a combination, then the fastest as ``BEST``.  This sweep
is what reaches ``select="phase"``, ``"packed"``, ``"packed3"`` and
``"packed3diag"``: no config key does, as in the JAX package.  For
``packed3diag`` the line also reports how many targets raised the overflow
flag (where ``packed3`` would fall back to the stream kernel).

Data is made with numpy from ``--seed``: DB rows and targets are AR(1)
walks (``synthetic_voices.ar1_walks``; neighbouring rows are near-duplicates
as consecutive epochs are), normalised by the DB's own mean and deviation.
With ``--real`` they are the port bench's config-3 voice instead
(``bench1m.voicedb`` in ``--cache-dir``, which ``python -m
snickery_tpu_torch.bench --modes epoch`` builds and caches; the sweep builds
no voice) and its held-out targets (``bench.held_out_features(8, 128)``,
seeds 90,000+, each utterance's first and last row dropped, normalised by
the voice's statistics, cut to ``--rows`` and padded with zero rows to a
multiple of 1,024), the DB padded to a multiple of 8,192 rows; ``--units``
and ``--dim`` then come from the voice (``bench_topk.py:114-168``).
``--cluster`` (with ``--real``) reorders the voice's rows by k-means cluster
(:func:`cluster_order`, host numpy, timed), which gathers similar units into
runs.
``--pileup N`` plants, for one target in 16, a run of N near-duplicate rows
inside one 128-row block with the target on top of it
(``kernel_check.pileup_block``), standing in for a real voice's runs of
near-duplicate epochs; ``--scatter`` stride-permutes the DB rows with a
golden-ratio step (``bench_topk.py:144-153``; with ``--real`` the voice's
rows only, after ``--cluster``), which spreads such runs over many blocks.
``--db-op zt`` times the zero-transient form (the raw block), ``dv`` (or
``norm``, the JAX script's name) the derived operand (derived once per
precision, outside the timing), ``raw`` the derived operand derived inside
every timed call, as the JAX wrapper derives it inside its jit.  The
zero-transient block is the port's resident ``[data | sqn | ptr]`` block,
which the ``_zt`` kernels read; the JAX script's ``--db-op zt`` builds the
legacy ``[data | ptr]`` block with no sqn column (``pallas_topk.py:757-760``),
which no synthesis path of the port builds.  Its ``--cluster`` sees the
block's columns less the sqn column, the rows it sees in the JAX script, so
that the two orders are equal; whole rows move.
``--masks part | ling | ling_part`` fuses the voice partition mask, the
quinphone penalties or both, on labels drawn from 8 voices, 80 halfphone
codes and 40 context phones (the JAX script sweeps the unmasked kernel
only), so that every entry point of the kernel library can be timed.

On ``--device cuda`` (the default) the hand-written kernels run and the
times are CUDA-event times, the median of ``--iters`` after one warm-up
call; on ``--device cpu`` the plain twins run and the times are host wall
times of those, no measure of the kernels.

Left out, against the JAX script: ``t_tile``, ``chunk`` and ``block`` (TPU
tilings; the port's tiles are fixed in ``csrc/topk_preselect.cuh``).  The
cache is the port bench's ``--cache-dir`` (default
``~/.cache/snickery_bench_torch``), not ``SNICKERY_BENCH_CACHE``: a
port-built voice differs from a JAX-built one in weak bands.
"""

from __future__ import annotations

import argparse
import os
import statistics
import sys
import time
from typing import NamedTuple

import numpy as np
import torch

from snickery_tpu_torch import bench
from snickery_tpu_torch.const import QUINPHONE_CONTEXT_WEIGHTS, QUINPHONE_SCALE
from snickery_tpu_torch.kernel_check import pileup_block
from snickery_tpu_torch.ops.cuda_topk import (BLOCK_ROWS, PRECISIONS, SELECTS,
                                              cuda_topk_preselect, derive_operand, pack_meta,
                                              voice_spans_of)
from snickery_tpu_torch.synthetic_voices import ar1_walks
from snickery_tpu_torch.voicedb.device_layout import build_raw_blocks

WALK = 350               # rows of one AR(1) walk (an utterance's epochs)
PILEUP_SHARE = 16        # --pileup: one target in this many gets a run
MASKS = {"none": (False, False), "part": (True, False), "ling": (False, True),
         "ling_part": (True, True)}       # --masks: (partition, linguistic)
DB_OPS = ("zt", "dv", "norm", "raw")     # --db-op; norm is the JAX script's name for dv
REAL_VOICE = "bench1m"                   # --real: the bench's config-3 voice
REAL_UTTS, REAL_SEGMENTS = 8, 128        # --real: held-out utterances and their segments
GRID_ROWS = 8192                         # --real: the DB is padded to a multiple of this
TARGET_ROWS = 1024                       # --real: the targets to a multiple of this


def scatter_order(n: int) -> np.ndarray:
    """The golden-ratio stride permutation of ``bench_topk.py --scatter``:
    row j of the scattered DB is row ``j * step % n``, step the first
    integer from ``0.618 n | 1`` up that is coprime to n."""
    step = next((c for c in range(int(0.618 * n) | 1, n) if np.gcd(c, n) == 1), 1)
    return (np.arange(n, dtype=np.int64) * step) % n


def cluster_order(feats: np.ndarray, n_clusters: int = 1024, sample: int = 100_000,
                  iters: int = 8, seed: int = 0) -> np.ndarray:
    """Row permutation that groups similar rows into runs: a minibatch
    k-means fitted on a sample, then a blocked assignment of every row and
    a stable argsort by cluster.  A copy of ``bench_topk.py:24-51``, the
    same numpy operations in the same order, so that the order is the same
    bit for bit."""
    rng = np.random.default_rng(seed)
    m = len(feats)
    idx = rng.choice(m, size=min(sample, m), replace=False)
    x = feats[idx].astype(np.float32)
    c = x[rng.choice(len(x), size=n_clusters, replace=False)].copy()
    for _ in range(iters):
        d = (c * c).sum(1)[None, :] - 2.0 * x @ c.T          # (s, k)
        a = d.argmin(1)
        sums = np.zeros_like(c)
        np.add.at(sums, a, x)
        counts = np.bincount(a, minlength=n_clusters)[:, None]
        nz = counts[:, 0] > 0
        c[nz] = sums[nz] / counts[nz]
    assign = np.empty(m, np.int32)
    csq = (c * c).sum(1)[None, :]
    for lo in range(0, m, 65536):
        hi = min(lo + 65536, m)
        d = csq - 2.0 * feats[lo:hi] @ c.T
        assign[lo:hi] = d.argmin(1)
    return np.argsort(assign, kind="stable")


def make_data(rows: int, units: int, dim: int, seed: int, pileup: int, scatter: bool):
    """(targets (rows, dim) normalised f32, raw block (units, dim + 2), its
    affine (mean, std, ones)), numpy: the DB and the targets are separate
    AR(1) walks; with ``pileup`` every PILEUP_SHARE-th target sits on a run
    of that many near-duplicate rows inside one block of its own."""
    rng = np.random.default_rng(seed)
    feats = ar1_walks(rng, -(-units // WALK), WALK, dim).reshape(-1, dim)[:units]
    feats = np.ascontiguousarray(feats * rng.uniform(0.5, 2.0, dim).astype(np.float32)
                                 + rng.standard_normal(dim).astype(np.float32))
    mean, std = feats.mean(0), feats.std(0)
    aff = (mean.astype(np.float32), std.astype(np.float32), np.ones(dim, np.float32))
    held = ar1_walks(rng, -(-rows // WALK), WALK, dim).reshape(-1, dim)[:rows]
    targets = np.ascontiguousarray(held)          # already in the normalised space
    if pileup:
        n_runs = max(1, rows // PILEUP_SHARE)
        blocks = rng.choice(units // BLOCK_ROWS, n_runs, replace=n_runs > units // BLOCK_ROWS)
        for j, b in enumerate(blocks):
            t = j * PILEUP_SHARE
            pileup_block(feats, targets[t:t + 1], aff, start=int(b) * BLOCK_ROWS + 8,
                         run=pileup, n_targets=1, seed=seed + 1 + j)
    if scatter:
        feats = feats[scatter_order(units)]
    jr = np.empty_like(feats)
    jr[:-1], jr[-1] = feats[1:], feats[0]
    raw, _, _ = build_raw_blocks(feats, jr, units, affine=aff)
    return targets, raw, aff


class RealData(NamedTuple):
    """``--real`` inputs, numpy: targets (T, kd) normalised f32, T a
    multiple of TARGET_ROWS; the raw block (q, kd + 2) ``[data | sqn | ptr]``
    of the voice padded to ``m_rows`` (a multiple of GRID_ROWS) with its
    first ``n_units`` rows in ``order`` (None: as built) and its affine
    (mean, std, ones); ``how`` names the order, ``cluster_s`` the host
    seconds of :func:`cluster_order` (0 without ``--cluster``)."""
    targets: np.ndarray
    raw: np.ndarray
    aff: tuple
    n_units: int
    m_rows: int
    order: np.ndarray | None
    how: str
    cluster_s: float


def real_voice_path(cache_dir: str) -> str:
    return os.path.join(cache_dir, REAL_VOICE + ".voicedb")


def real_targets(db, rows: int, device) -> np.ndarray:
    """The held-out targets of ``bench_topk.py --real`` (:155-162) for the
    voice ``db``, the analysis on ``device``."""
    feats = bench.held_out_features(REAL_UTTS, REAL_SEGMENTS, device=device)[0]
    tw = np.concatenate([(f[1:-1] - db.mean_target) / db.std_target
                         for f in feats])[:rows].astype(np.float32)
    return np.pad(tw, ((0, (-len(tw)) % TARGET_ROWS), (0, 0)))


def real_block(db, db_op: str, cluster: bool, scatter: bool):
    """(raw block, affine, m_rows, order, how, cluster seconds) of the voice
    ``db`` for ``--db-op`` (see :class:`RealData`).  The k-means order is
    taken on the rows the JAX script gives it for that operand: the
    normalised features (dv / norm), the raw data columns (raw), the block
    less its sqn column (zt)."""
    n, kd = db.unit_features.shape
    m_rows = -(-n // GRID_ROWS) * GRID_ROWS
    aff = (np.array(db.mean_target, np.float32), np.array(db.std_target, np.float32),
           np.ones(kd, np.float32))
    raw, _, _ = build_raw_blocks(db.unit_features, db.join_right, m_rows, affine=aff)
    order, how, cluster_s = None, [], 0.0
    if cluster:
        if db_op == "zt":
            rows = np.concatenate([raw[:n, :kd], raw[:n, -1:]], axis=1)
        elif db_op == "raw":
            rows = raw[:n, :kd]
        else:
            rows = db.normalised_features().astype(np.float32)
        t0 = time.perf_counter()
        order = cluster_order(rows)
        cluster_s = time.perf_counter() - t0
        how.append("clustered")
        del rows
    if scatter:
        step = scatter_order(n)
        order = step if order is None else order[step]
        how.append("scattered")
    if order is not None:
        raw[:n] = raw[:n][order]
    return raw, aff, m_rows, order, ", ".join(how) or "built", cluster_s


def make_real_data(cache_dir: str, rows: int, db_op: str, cluster: bool, scatter: bool,
                   device) -> RealData:
    """The ``--real`` branch of ``bench_topk.py`` (:114-168): the cached
    voice's raw block in the order asked for and its held-out targets, the
    targets analysed on ``device``."""
    from snickery_tpu_torch.voicedb.db import VoiceDB
    db = VoiceDB.load(real_voice_path(cache_dir))
    targets = real_targets(db, rows, device)
    raw, aff, m_rows, order, how, cluster_s = real_block(db, db_op, cluster, scatter)
    return RealData(targets, raw, aff, db.n_units, m_rows, order, how, cluster_s)


def make_masks(rows: int, units: int, seed: int, masks: str, device) -> dict:
    """The mask arguments of ``cuda_topk_preselect`` for ``--masks``: labels
    drawn uniformly from 8 voices, 80 halfphone codes and 40 context phones
    on both sides, the penalties those of the halfphone voices, and with the
    partition the DB's voice spans (each voice's rows are scattered over the
    DB, so every tile scans all of it)."""
    partition, linguistic = MASKS[masks]
    if not (partition or linguistic):
        return {}
    rng = np.random.default_rng(seed + 1_000_003)

    def meta(n):
        return pack_meta(*(torch.from_numpy(rng.integers(0, hi, shape).astype(np.int32))
                           for hi, shape in ((80, n), (40, (n, 5)), (8, n)))).to(device)

    weights = (*QUINPHONE_CONTEXT_WEIGHTS, QUINPHONE_SCALE) if linguistic else None
    tgt_meta, db_meta = meta(rows), meta(units)     # in this order: the seeded draws
    return dict(tgt_meta=tgt_meta, db_meta=db_meta, partition=partition,
                ling_weights=weights,
                voice_spans=voice_spans_of(db_meta[:, 6], units) if partition else None)


def time_call(fn, iters: int, device) -> tuple[float, tuple]:
    """(median ms of ``iters`` calls after one warm-up, the last result):
    CUDA events on a card, the host clock on the CPU."""
    out = fn()
    times = []
    for _ in range(iters):
        if device.type == "cuda":
            start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            out = fn()
            stop.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(stop))
        else:
            t0 = time.perf_counter()
            out = fn()
            times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times), out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", type=int, default=16384, help="target rows T")
    ap.add_argument("--units", type=int, default=1 << 20, help="DB rows M")
    ap.add_argument("--dim", type=int, default=151)
    ap.add_argument("--k", type=int, default=30)
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--precision", default="split3cat", choices=PRECISIONS)
    ap.add_argument("--select", default="stream", choices=SELECTS)
    ap.add_argument("--db-op", default="zt", choices=DB_OPS,
                    help="zt: the resident raw block; dv (or norm): the derived operand, "
                         "derived once; raw: the derived operand, derived in every call")
    ap.add_argument("--combos", default="",
                    help='space list of "precision,select" (default: one, from '
                         "--precision and --select)")
    ap.add_argument("--pileup", type=int, default=0,
                    help="plant runs of N near-duplicate rows in one 128-row block "
                         f"for one target in {PILEUP_SHARE}")
    ap.add_argument("--masks", default="none", choices=tuple(MASKS),
                    help="fuse the voice partition mask, the quinphone penalties or both")
    ap.add_argument("--scatter", action="store_true",
                    help="stride-permute the DB rows (golden-ratio step)")
    ap.add_argument("--real", action="store_true",
                    help=f"the bench's cached {REAL_VOICE} voice and its held-out targets "
                         "(--units and --dim then come from the voice)")
    ap.add_argument("--cluster", action="store_true",
                    help="with --real: reorder the DB rows by k-means cluster")
    ap.add_argument("--cache-dir", default="",
                    help=f"with --real: the bench's cache (default {bench.DEFAULT_CACHE})")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    combos = [(args.precision, args.select)]
    if args.combos:
        combos = [tuple(c.split(",")) for c in args.combos.split()]
    for combo in combos:
        if len(combo) != 2 or combo[0] not in PRECISIONS or combo[1] not in SELECTS:
            ap.error(f"bad combination {','.join(combo)!r}: want precision,select from "
                     f"{PRECISIONS} and {SELECTS}")
    if not 0 <= args.pileup <= BLOCK_ROWS - 8:
        ap.error(f"--pileup must lie in [0, {BLOCK_ROWS - 8}]")
    if args.cluster and not args.real:
        ap.error("--cluster reorders the real voice: it needs --real")
    if args.pileup and args.real:
        ap.error("--pileup plants runs in the AR(1) rows; the real voice carries its own")
    cache = os.path.expanduser(args.cache_dir or bench.DEFAULT_CACHE)
    if args.real and not os.path.isdir(real_voice_path(cache)):
        print(f"sweep_topk: no cached {REAL_VOICE} voice in {cache}; build it with "
              f"python -m snickery_tpu_torch.bench --modes epoch --cache-dir {cache}",
              file=sys.stderr)
        return 2
    if args.device == "cuda" and not torch.cuda.is_available():
        print("sweep_topk: no CUDA device (use --device cpu for the plain twins)",
              file=sys.stderr)
        return 2
    device = torch.device(args.device)
    what = (f"kernel, {torch.cuda.get_device_name(0)}" if device.type == "cuda"
            else "plain twin on the CPU, host wall time")

    if args.real:
        data = make_real_data(cache, args.rows, args.db_op, args.cluster, args.scatter, device)
        targets, raw, aff, n_real = data.targets, data.raw, data.aff, data.n_units
        args.rows, args.units, args.dim = len(targets), data.m_rows, targets.shape[1]
        source = (f"real {REAL_VOICE} ({n_real} units; --units and --dim from the voice), "
                  f"{data.how}, clustering {data.cluster_s:.1f} s")
    else:
        targets, raw, aff = make_data(args.rows, args.units, args.dim, args.seed, args.pileup,
                                      args.scatter)
        n_real = args.units
        source = f"pileup {args.pileup}, scatter {args.scatter}, seed {args.seed}"
    print(f"# {args.rows} target rows x {args.units} units x {args.dim} dims, k {args.k}, "
          f"db-op {args.db_op}, masks {args.masks}, {source}; {what}", file=sys.stderr)

    targets, raw = torch.from_numpy(targets).to(device), torch.from_numpy(raw).to(device)
    aff = tuple(torch.from_numpy(a).to(device) for a in aff)
    masks = make_masks(args.rows, args.units, args.seed, args.masks, device)
    operands = {}
    results = []
    for precision, select in combos:
        tag = f"{precision:9s} {select:11s}"
        kw = dict(k=args.k, m_rows=args.units, precision=precision, select=select, **masks)
        if args.db_op == "zt":
            def call():
                return cuda_topk_preselect(targets, raw_block=raw, db_affine=aff, **kw)
        elif args.db_op == "raw":
            def call():
                op, sqn = derive_operand(raw, aff, n_real, args.units, precision)
                return cuda_topk_preselect(targets, raw_block=op, db_affine=None,
                                           zero_transient=False, sqn=sqn, **kw)
        else:
            key = "split3cat" if precision == "split3cat" else "f32"
            if key not in operands:
                operands[key] = derive_operand(raw, aff, n_real, args.units, precision)
            op, sqn = operands[key]

            def call():
                return cuda_topk_preselect(targets, raw_block=op, db_affine=None,
                                           zero_transient=False, sqn=sqn, **kw)
        ms, out = time_call(call, args.iters, device)
        results.append((ms, tag))
        note = ""
        if select == "packed3diag":
            note = f"  overflow {int((out[2] > 0).sum())}/{out[2].shape[0]} cols"
        print(f"{tag}: {ms:10.3f} ms{note}", flush=True)
    best_ms, best_tag = min(results)
    print(f"\nBEST: {best_tag} -> {best_ms:.3f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())

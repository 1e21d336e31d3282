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
``--pileup N`` plants, for one target in 16, a run of N near-duplicate rows
inside one 128-row block with the target on top of it
(``kernel_check.pileup_block``), standing in for a real voice's runs of
near-duplicate epochs; ``--scatter`` stride-permutes the DB rows with a
golden-ratio step (``bench_topk.py:144-153``), which spreads such runs over
many blocks.  ``--db-op zt`` times the zero-transient form (the raw block),
``dv`` the derived operand (derived once per precision, outside the timing).
``--masks part | ling | ling_part`` fuses the voice partition mask, the
quinphone penalties or both, on labels drawn from 8 voices, 80 halfphone
codes and 40 context phones (the JAX script sweeps the unmasked kernel
only), so that every entry point of the kernel library can be timed.

On ``--device cuda`` (the default) the hand-written kernels run and the
times are CUDA-event times, the median of ``--iters`` after one warm-up
call; on ``--device cpu`` the plain twins run and the times are host wall
times of those, no measure of the kernels.

Left out, against the JAX script: ``t_tile``, ``chunk`` and ``block`` (TPU
tilings; the port's tiles are fixed in ``csrc/topk_preselect.cuh``), and
``--real`` / ``--cluster`` (they need the cached bench voice that the JAX
package's analysis chain builds).
"""

from __future__ import annotations

import argparse
import statistics
import sys
import time

import numpy as np
import torch

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


def scatter_order(n: int) -> np.ndarray:
    """The golden-ratio stride permutation of ``bench_topk.py --scatter``:
    row j of the scattered DB is row ``j * step % n``, step the first
    integer from ``0.618 n | 1`` up that is coprime to n."""
    step = next((c for c in range(int(0.618 * n) | 1, n) if np.gcd(c, n) == 1), 1)
    return (np.arange(n, dtype=np.int64) * step) % n


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
    ap.add_argument("--db-op", default="zt", choices=("zt", "dv"),
                    help="zt: the resident raw block; dv: the derived operand")
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
    if args.device == "cuda" and not torch.cuda.is_available():
        print("sweep_topk: no CUDA device (use --device cpu for the plain twins)",
              file=sys.stderr)
        return 2
    device = torch.device(args.device)
    what = (f"kernel, {torch.cuda.get_device_name(0)}" if device.type == "cuda"
            else "plain twin on the CPU, host wall time")
    print(f"# {args.rows} target rows x {args.units} units x {args.dim} dims, k {args.k}, "
          f"db-op {args.db_op}, masks {args.masks}, pileup {args.pileup}, scatter "
          f"{args.scatter}, seed "
          f"{args.seed}; {what}", file=sys.stderr)

    targets, raw, aff = make_data(args.rows, args.units, args.dim, args.seed, args.pileup,
                                  args.scatter)
    targets, raw = torch.from_numpy(targets).to(device), torch.from_numpy(raw).to(device)
    aff = tuple(torch.from_numpy(a).to(device) for a in aff)
    masks = make_masks(args.rows, args.units, args.seed, args.masks, device)
    operands = {}
    results = []
    for precision, select in combos:
        tag = f"{precision:9s} {select:11s}"
        if args.db_op == "zt":
            kw = dict(raw_block=raw, db_affine=aff)
        else:
            key = "split3cat" if precision == "split3cat" else "f32"
            if key not in operands:
                operands[key] = derive_operand(raw, aff, args.units, args.units, precision)
            op, sqn = operands[key]
            kw = dict(raw_block=op, db_affine=None, zero_transient=False, sqn=sqn)
        ms, out = time_call(lambda: cuda_topk_preselect(
            targets, k=args.k, m_rows=args.units, precision=precision, select=select, **kw,
            **masks),
            args.iters, device)
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

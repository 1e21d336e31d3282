"""The rate sweep of an open-loop cell: one set-up, then the cell's mix at
each rate in turn, each for ``--seconds``; a row a rate of requests sent,
answered and failed, the latency's median and 95th percentile, the answers
a second, the median latency of the last quarter of requests against the
first (a backlog that grows shows as a ratio well over 1), how late the
client sent, and the mean batch.  The highest rate with every request
answered, no growing backlog and answers keeping up with the offer is the
cell's knee; its mix runs at about four fifths of it.

    python3 benchmark/sweep_rate.py --workload multivoice8.served --seed 7 \\
        --seconds 10 --rates 20,40,60,80
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time

if __name__ == "__main__":           # the checkout's root in place of this folder
    sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

from benchmark import run as harness  # noqa: E402


def _pct(vals, q):
    vals = sorted(vals)
    return vals[math.ceil(q * len(vals)) - 1] if vals else float("nan")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--rates", required=True)
    args = ap.parse_args(argv)
    harness.cache_env(harness.ROOT)
    import torch

    from pathlib import Path

    from benchmark import registry
    from benchmark.record import Run
    from benchmark.trace import Tracer

    if not torch.cuda.is_available():
        harness.log("no CUDA device")
        return 2
    harness.log(f"card: {harness.card_line()}")
    cell = registry.cell(Path(harness.ROOT), args.workload)
    entry = registry.entry(cell)
    units = registry.units(cell)
    log = harness.log
    utts, pool = units.inputs(cell.config, cell.traffic, args.seed, "cuda", log)
    synth = units.build(cell.config, utts, "cuda", log)
    rows = units.voice_rows(utts)
    for rate in [float(r) for r in args.rates.split(",")]:
        run = Run(cell=cell, seed=args.seed, device="cuda", log=log, tracer=Tracer(False),
                  units=units, pool=pool, voice_rows=rows, synth=synth)
        run.state.update(seconds=args.seconds, rate=rate)
        try:
            entry.warm(run)
            t0 = time.perf_counter()
            entry.window(run, args.seconds)
        finally:
            entry.stop(run)
        lat = run.latencies_ms
        ok = [x for x in lat if math.isfinite(x)]
        q = max(1, len(lat) // 4)
        first, last = _pct(lat[:q], 0.5), _pct(lat[-q:], 0.5)
        sizes = run.counters["batch_sizes"]
        row = {"rate_per_s": rate, "sent": len(lat), "answered": len(ok),
               "failed": len(lat) - len(ok), "p50_ms": _pct(lat, 0.5), "p95_ms": _pct(lat, 0.95),
               "answered_per_s": len(ok) / args.seconds,
               "backlog_ratio": last / first if first > 0 else float("nan"),
               "late_p95_ms": _pct(run.late_ms, 0.95),
               "batch_mean": sum(int(k) * v for k, v in sizes.items()) / max(1, sum(sizes.values())),
               "window_s": time.perf_counter() - t0,
               "p95_by_5s": [round(_pct([x for x, a in zip(lat, run.asked)
                                         if t <= a.due_s < t + 5], 0.95), 1)
                             for t in range(0, int(args.seconds), 5)]}
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

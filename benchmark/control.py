"""The control of a cell's comparison: the reference put in the program's
place and computed one precision lower (the unit kind's ``control``; for
``epoch``: distances from TF32 products with no exact rescore, float32
lattice costs, audio from bfloat16 waves; see ``reference/search.py``),
judged by the cell's own comparison.  It has to come out not correct.

For each seed it makes the cell's inputs, asks the control what a run's
first answers ask of the program (a closed loop's first call; an open
loop's requests due in ``--seconds``), judges the sample a run judges, and
prints one JSON line of the numbers beside the cell's limits.

    python3 benchmark/control.py --workload epoch1m.batch --seeds 11,12,13
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

if __name__ == "__main__":           # the checkout's root in place of this folder
    sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

from benchmark import run as harness  # noqa: E402


def control_numbers(cell, seed: int, seconds: float, device: str, log=harness.log) -> dict:
    from benchmark import registry, traffic
    from benchmark.reference import compare

    tr = cell.traffic
    units = registry.units(cell)
    utts, pool = units.inputs(cell.config, tr, seed, device, log)
    if tr["loop"] == "closed":
        asks = next(traffic.batches(tr, seed, len(utts)))
    else:
        asks = traffic.arrivals(tr, seed, seconds, len(utts))
    longest = max(range(len(asks)), key=lambda i: asks[i].epochs)
    sample = traffic.sample(len(asks), longest, tr["sample"], seed)
    asks = [asks[i] for i in sample]
    ref = units.reference(cell.config, utts, device)
    t0 = time.perf_counter()
    answers = units.control(ref, cell.config, pool, asks)
    nums = units.numbers(ref, cell.config, answers, pool, asks, list(range(len(asks))))
    correct, _ = compare.judge(nums, cell.limits)
    log(f"control: {len(asks)} answers, {time.perf_counter() - t0:.2f} s")
    return {"seed": seed, "correct": correct, **nums}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    args = ap.parse_args(argv)
    harness.cache_env(harness.ROOT)
    import torch

    from pathlib import Path

    from benchmark import registry

    if not torch.cuda.is_available():
        harness.log("no CUDA device")
        return 2
    cell = registry.cell(Path(harness.ROOT), args.workload)
    for seed in [int(s) for s in args.seeds.split(",")]:
        print(json.dumps({"workload": args.workload,
                          **control_numbers(cell, seed, args.seconds, "cuda")}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

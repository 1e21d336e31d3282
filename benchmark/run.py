"""Runs one cell of the port's benchmark once and prints its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  The cell's entry in ``BENCHMARK.json`` names
its configuration and traffic mix; everything else is found by name (see
``benchmark/registry.py``).  A run:

1. makes its inputs from ``--seed`` on the card, through the unit kind the
   configuration names (``benchmark/units/<kind>.py``; ``epoch``:
   ``benchmark/voices.py``);
2. builds the port's voice and ``Synthesiser`` from them (the unit kind;
   ``epoch``: ``benchmark/system.py``) and warms the mix's shapes (its entry);
3. measures for ``--seconds`` (under ``torch.profiler`` with ``--trace 1``);
4. reads the device's memory peak, frees the program, and compares the
   program's answers with the plain float64 reference
   (``benchmark/reference/``), each number beside its limit;
5. prints the numbers compared as its last lines on standard error, and as
   the last line of standard output one JSON object: ``correct``,
   ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
   with ``--trace 1`` its per-layer metrics), ``device`` and, traced,
   ``breakdown``, then ``checks``.

It exits non-zero, with no result line, where there is no card or fewer
cards than the cell asks for, or where ``jax``, ``jaxlib``, ``flax`` or the
JAX package ``snickery_tpu`` has been loaded.  Build and kernel caches stay
in ``build/`` of the checkout.
"""

from __future__ import annotations

import os
import sys
import time
from pathlib import Path


def _process_start() -> float:
    """Wall-clock time at which this process started."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - uptime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.time()


T_START = _process_start()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# run as a script, this folder heads the path: the checkout's root takes its
# place, so that the harness's modules import as ``benchmark.*`` only
if __name__ == "__main__":
    sys.path[0] = ROOT
FORBIDDEN = ("jax", "jaxlib", "flax", "snickery_tpu")


def cache_env(root: str) -> None:
    """Every build and kernel cache at a fixed path inside the checkout; no
    library that the program imports loads JAX."""
    cache = os.path.join(root, "build", "bench_cache")
    for key, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[key] = os.path.join(cache, sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN})


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def card_line() -> str:
    import subprocess
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30).stdout.strip().splitlines()
        return out[0] if out else "nvidia-smi gave nothing"
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi failed"


def _sync(device):
    import torch
    if device == "cuda":
        torch.cuda.synchronize()


def run_cell(cell, seed: int, seconds: float, trace: bool, device: str = "cuda",
             t_start: float | None = None, log=log) -> tuple[dict, list]:
    """One run of ``cell`` (a ``registry.Cell``) on ``device``: (the result
    line's object, [(number, value, limit)])."""
    import gc

    import torch

    from benchmark import registry
    from benchmark.record import Run
    from benchmark.reference import compare
    from benchmark.trace import Tracer

    t_start = time.time() if t_start is None else t_start
    cuda = device == "cuda"
    units = registry.units(cell)
    run = Run(cell=cell, seed=seed, device=device, log=log, tracer=Tracer(trace, cuda),
              units=units)
    utts, run.pool = units.inputs(cell.config, cell.traffic, seed, device, log)
    run.voice_rows = units.voice_rows(utts)
    peak = 0
    if cuda:
        _sync(device)
        peak = torch.cuda.max_memory_allocated()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    run.synth = units.build(cell.config, utts, device, log)
    entry = registry.entry(cell)
    run.state["seconds"] = seconds
    t0 = time.perf_counter()
    try:
        entry.warm(run)
        _sync(device)
        log(f"setup warm-up: {time.perf_counter() - t0:.2f} s")
        run.setup_s = time.time() - t_start
        log(f"setup total: {run.setup_s:.2f} s")
        entry.window(run, seconds)
        _sync(device)
    finally:
        if hasattr(entry, "stop"):
            entry.stop(run)
    if cuda:
        run.synth_peak_bytes = torch.cuda.max_memory_allocated()
        peak = max(peak, run.synth_peak_bytes)
    log(f"window: {run.wall_s:.3f} s, {run.steps} steps, {len(run.asked)} answers due")

    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = registry.reader(cell, "metrics" if trace else "e2e", m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                   "count": cell.chips, "memory_peak_bytes": int(peak)}
    line = {"correct": False, "attempted": len(run.asked),
            "failed": sum(a is None for a in run.answers), "metrics": metrics,
            "device": device_info}
    if trace:
        device_info["busy_s"] = run.trace.busy_s
        device_info["window_s"] = run.trace.window_s
        line["breakdown"] = run.trace.breakdown()
        log(f"trace read in {run.tracer.read_s:.2f} s")

    # the program's state goes before the reference runs
    answers, asked, sample = run.answers, run.asked, run.sample
    run.synth = None
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ref = units.reference(cell.config, utts, device)
    log(f"reference: voice built, {time.perf_counter() - t0:.2f} s")
    nums = units.numbers(ref, cell.config, answers, run.pool, asked, sample)
    line["correct"], checks = compare.judge(nums, cell.limits)
    log(f"reference: {nums['compared']} answers searched, {time.perf_counter() - t0:.2f} s; "
        + ", ".join(f"{k} {v!r}" for k, v in nums.items() if k not in cell.limits))
    line["checks"] = {k: {"value": v, "limit": lim} for k, v, lim in checks}
    return line, checks


def main(argv=None) -> int:
    import argparse
    import json

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cache_env(ROOT)
    import torch

    from benchmark import registry

    cell = registry.cell(Path(ROOT), args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        log(f"{args.workload} needs {cell.chips} CUDA device(s); "
            f"torch sees {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    log(f"card: {card_line()}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    line, checks = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                            t_start=T_START)
    found = forbidden_modules()
    if found:
        log(f"loaded modules of JAX or the JAX package: {', '.join(found)}")
        return 3
    for name, value, limit in checks:
        log(f"check {name}: {value!r} (limit {limit!r})")
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

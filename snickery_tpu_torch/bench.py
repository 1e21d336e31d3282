"""Benchmark of the port: unit-selection synthesis through the real
pipeline (corpus -> native epoch detection -> grouped magphase analysis ->
cutter -> VoiceDB -> Synthesiser) on one device.

    python -m snickery_tpu_torch.bench [--modes epoch,kernel,...] [--quick]
        [--device cuda|cpu] [--cache-dir DIR] [--out PATH] [--profile DIR]

Counterpart of ``bench.py`` (the JAX package's bench), with its modes,
flags and field names:

- ``epoch``: BASELINE config #3, a ~1M-epoch-unit voice
  (``--units``), ``--batch`` held-out utterances a step at bucket 2048,
  ``preselect_precision="split3cat"``; the first step through
  ``Synthesiser.synth_batch``, then ``parallel.batched_synth_step``;
  fidelity gates: the step re-run at "highest" (tie-adjusted agreement,
  worst f64 path-cost gap) and the float64 oracle on ``--oracle-rows``
  held-out rows;
- ``kernel``: the preselect kernel against its plain twin
  (``kernel_check.compare``) at the JAX check's shape and at the config-3
  batch shape: ``kernel_vs_twin`` (``bench.py``'s
  ``pallas_compiled_vs_interpret``);
- ``streaming``: config #4, fixed-rate 5 ms chunks and epoch-rate chunks on
  the config-3 voice: chunk latency p50 / p95, its decomposition, and the
  quality cost of the greedy and streamed decodes against Viterbi;
- ``me2``: the config-3 voice at ``multiepoch=2`` (kd 302), derived from
  the cached config-3 voice, with the same gates and the kernel against its
  twin at that shape;
- ``capacity``: the config-3 voice tiled ``--cap-tile`` times at "split3"
  with int16 waves (agreement with "highest", peak device memory);
- ``halfphone`` (config #2), ``multivoice`` (config #5), ``toy`` (config
  #1), ``48k`` and ``quality`` (MCD, NSIM and join flux against DB size).

Differences from ``bench.py``, all on purpose:

- ``ms_per_step`` is the median of ``--iters`` steps, each synchronised
  with the device (the full record keeps every step's ms, their min and
  max), not the mean of back-to-back enqueues: the step's wall is what a
  caller waits for (it ends with the results copied to the host), and
  steps moved by up to 2x between runs while the decode was a host-paced
  loop;
- a mode that raises is recorded as ``<mode>_error`` and the run goes on,
  but the exit code is then 1; a kill by SIGTERM, SIGALRM or the watchdog
  prints the line and exits non-zero; a skip for lack of budget
  (``<mode>_skipped: "budget"``) is the only clean gap;
- the records (``BENCH_full.json`` at the end, ``BENCH_partial.json``
  after each mode) go to the cache dir (default
  ``~/.cache/snickery_bench_torch``, not the JAX bench's: a port-built
  voice differs from a JAX-built one in weak bands) and to ``--out``; the
  bench writes nothing into the repository, and merges no earlier record;
- ``--device cuda`` (the default) runs the hand-written kernels and raises
  where CUDA is absent; ``--device cpu`` runs their plain twins;
- ``--profile DIR`` writes a ``torch.profiler`` trace of one steady
  config-3 step and logs its device-busy share and its device kernels;
- ``capacity`` keeps the audio on the host (``preload_all_waves=False``)
  only where the raw block, the waves and a working reserve do not fit in
  the device's free memory (``torch.cuda.mem_get_info``); under ``--quick``
  it tiles the quick voice, and it builds the voice it tiles when that is
  not cached.

Prints ONE JSON line, the last of standard output:
    {"metric": "synthesis_rtf", "value": <wall / audio>, "unit": ...,
     "vs_baseline": <value / 0.003>, "extra": {per-config numbers}}
``vs_baseline`` is the RTF over BASELINE.json's north star (RTF <= 0.003);
below 1.0 beats it.  The log (standard error) starts with the card's name
and power limit as ``nvidia-smi --query-gpu=name,power.limit`` gives them.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import hashlib
import json
import math
import os
import signal
import subprocess
import sys
import threading
import time
import traceback
import uuid

import numpy as np

SR = 16000
STREAMS = ["mag", "real", "imag", "lf0"]
DATADIMS = {"mag": 60, "real": 45, "imag": 45, "lf0": 1}
D = 151
JCW = 0.7
NORTH_STAR_RTF = 0.003            # BASELINE.json's north star
GROUP_EPOCHS = 120_000            # bench.py's analysis group
CAPACITY_RESERVE_GIB = 4.0        # working memory a capacity step needs beside the voice
MODES = ("epoch", "kernel", "streaming", "me2", "capacity", "halfphone", "multivoice",
         "toy", "48k", "quality")
DEFAULT_CACHE = os.path.join("~", ".cache", "snickery_bench_torch")


def log(msg: str) -> None:
    print(f"# {msg}", file=sys.stderr, flush=True)


# ------------------------------------------------------- result resilience
# The records are flushed after every mode, a --budget-sec soft deadline
# skips the remaining modes, and SIGTERM / SIGALRM handlers and a watchdog
# thread print the final line before the process dies.
def _fresh_state() -> dict:
    return {"rtf": float("nan"), "extra": {}, "t0": time.time(), "budget": 0.0,
            "emitted": False, "device": None, "cache": None, "out": None}


_STATE: dict = _fresh_state()


def _no_nan(x):
    """NaN / inf -> null, recursively: the line must be strict JSON."""
    if isinstance(x, dict):
        return {k: _no_nan(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_no_nan(v) for v in x]
    if isinstance(x, float) and (x != x or x in (float("inf"), float("-inf"))):
        return None
    return x


def _sig(x, n: int = 5):
    """Floats to n significant digits (the line stays short)."""
    if isinstance(x, bool) or not isinstance(x, float):
        return x
    if x != x or x in (float("inf"), float("-inf")) or x == 0.0:
        return x
    return round(x, max(0, n - 1 - int(math.floor(math.log10(abs(x))))))


# keys promoted from each per-config block into the compact final line; the
# rest lives in the full record
_COMPACT_KEYS = ("rtf", "latency_ms",
                 "agreement_tie_adjusted", "oracle_path_cost_gap_rel",
                 "agreement_vs_f32_tie_adjusted", "f32_gate_worst_cost_gap_rel")


def record_path() -> str:
    """Where the full record goes: ``--out`` if given, else the cache dir."""
    return _STATE["out"] or os.path.join(cache_dir(), "BENCH_full.json")


def _compact_extra() -> dict:
    full = _STATE["extra"]
    out: dict = {}
    errors: dict = {}
    skipped: list = []
    for name, block in full.items():
        if isinstance(block, dict) and (name.startswith("config")
                                        or name == "capacity"):
            keep = {k: _sig(block[k]) for k in _COMPACT_KEYS if k in block}
            if keep:
                out[name] = keep
        elif name in ("kernel_vs_twin", "bench_elapsed_sec",
                      "killed_by_signal", "killed_by_watchdog"):
            out[name] = _sig(block)
        elif name.endswith("_error"):
            # the exception's type only; the message is in the full record
            errors[name[:-6]] = str(block).split(":")[0][:40]
        elif name.endswith("_skipped"):
            skipped.append(name[:-8])
    if errors:
        out["errors"] = errors
    if skipped:
        out["skipped"] = skipped
    out["detail"] = record_path()
    return out


def _result_line() -> str:
    """The one stdout line: compact by construction (< 1,500 characters with
    every block populated); the detail goes to the full record."""
    rtf = _STATE["rtf"]
    return json.dumps(_no_nan({
        "metric": "synthesis_rtf",
        "value": rtf,
        "unit": "wall_sec_per_audio_sec",
        "vs_baseline": rtf / NORTH_STAR_RTF,
        "extra": _compact_extra(),
    }), allow_nan=False, separators=(",", ":"))


def _full_line() -> str:
    rtf = _STATE["rtf"]
    return json.dumps(_no_nan({
        "metric": "synthesis_rtf",
        "value": rtf,
        "unit": "wall_sec_per_audio_sec",
        "vs_baseline": rtf / NORTH_STAR_RTF,
        "extra": _STATE["extra"],
    }), allow_nan=False)


def _write(path: str, text: str) -> None:
    try:
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            f.write(text)
    except OSError as e:
        log(f"cannot write {path}: {e}")


def flush_partial() -> None:
    """This run's record so far, after each mode, to
    ``<cache>/BENCH_partial.json`` and to ``--out``."""
    line = _full_line() + "\n"
    _write(os.path.join(cache_dir(), "BENCH_partial.json"), line)
    if _STATE["out"]:
        _write(_STATE["out"], line)


def emit_final() -> None:
    if not _STATE["emitted"]:
        _STATE["emitted"] = True
        line = _full_line() + "\n"
        _write(os.path.join(cache_dir(), "BENCH_full.json"), line)
        if _STATE["out"]:
            _write(_STATE["out"], line)
        log("full detail: " + line.strip())
        print(_result_line(), flush=True)


def _die_flushing(signum, frame):  # pragma: no cover - signal path
    _STATE["extra"]["killed_by_signal"] = int(signum)
    log(f"signal {signum}: flushing result JSON and exiting")
    emit_final()
    sys.stdout.flush()
    os._exit(128 + int(signum))


def _start_watchdog(deadline_sec: float) -> threading.Event:
    """A daemon thread that prints the line and exits 1 once the deadline
    passes, even if the main thread is stuck inside a C call (where a Python
    signal handler never runs).  Returns the event that stops it."""
    stop = threading.Event()

    def guard():  # pragma: no cover - timing path
        if stop.wait(max(0.0, _STATE["t0"] + deadline_sec - time.time())):
            return
        _STATE["extra"]["killed_by_watchdog"] = round(elapsed(), 1)
        log("watchdog deadline: flushing result JSON and exiting")
        emit_final()
        sys.stdout.flush()
        os._exit(1)

    threading.Thread(target=guard, daemon=True).start()
    return stop


def elapsed() -> float:
    return time.time() - _STATE["t0"]


def over_budget(reserve: float = 0.0) -> bool:
    b = _STATE["budget"]
    return bool(b) and elapsed() + reserve > b


# ------------------------------------------------------------- the device
def device():
    return _STATE["device"]


def sync(dev=None) -> None:
    """Wait for the device's queued work (a no-op on the CPU)."""
    import torch
    dev = dev or device()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def device_bytes_in_use(peak: bool = False):
    """(gigabytes, source) of the device memory PyTorch holds for tensors
    (``peak``: the most since the last reset), or (None, "unavailable") on
    the CPU."""
    import torch
    dev = device()
    if dev.type != "cuda":
        return None, "unavailable"
    fn = torch.cuda.max_memory_allocated if peak else torch.cuda.memory_allocated
    return fn(dev) / 2**30, "torch.cuda"


def card_line() -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    import torch
    dev = device()
    if dev.type != "cuda":
        return "cpu"
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60).stdout
        return out.strip().splitlines()[dev.index or 0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return f"{torch.cuda.get_device_name(dev)}, power limit not read (nvidia-smi failed)"


def cache_dir() -> str:
    d = _STATE["cache"] or os.path.expanduser(DEFAULT_CACHE)
    os.makedirs(d, exist_ok=True)
    return d


def _timed_ms(fn, dev=None) -> float:
    t0 = time.perf_counter()
    fn()
    sync(dev)
    return 1e3 * (time.perf_counter() - t0)


def timed_steps(step, n: int):
    """``n`` steps, each synchronised: (ms of each, the last output, kernel
    launches a step by entry point: the preselect's and the decode's, which
    count in one counter).  The launch counts are set to 0 just before and
    read just after."""
    from snickery_tpu_torch.ops import cuda_topk
    ms, out = [], None
    cuda_topk.LAUNCH_COUNTS.clear()
    for _ in range(n):
        t0 = time.perf_counter()
        out = step()
        sync()
        ms.append(1e3 * (time.perf_counter() - t0))
    launches = {k: v / n for k, v in sorted(cuda_topk.LAUNCH_COUNTS.items())}
    return ms, out, launches


def step_stats(ms: list) -> dict:
    return {"ms_per_step": float(np.median(ms)), "ms_per_step_min": float(min(ms)),
            "ms_per_step_max": float(max(ms)), "step_ms": [float(x) for x in ms]}


# --------------------------------------------------------------- corpus gen
def gen_utterance(seed: int, n_segments: int):
    from snickery_tpu_torch.synthetic_voices import synth_utterance
    return synth_utterance(seed, n_segments=n_segments)


def bulk_analyse(waves: list, epochs_list: list, group_epochs: int = GROUP_EPOCHS,
                 device=None):
    """Magphase analysis of many utterances in few device calls, as
    ``bench.py`` groups them: the waves joined with 2,048-sample silence
    gaps, the epoch grids offset, one analysis a group of at most
    ``group_epochs`` epochs, every group padded to the largest group's
    shape (zeros for the wave, the last epoch repeated: the padding the
    analysis applies itself).  Every row but an utterance's first and last
    equals the per-utterance analysis's; those two may not, since their
    windows' outer gaps reach the group's neighbouring utterance or padding
    (``bench.py`` groups alike).  lf0 is computed per utterance (a group's
    grid has the wrong gaps at the boundaries).  ``device``: where the
    analysis runs (default: the bench's device, set by :func:`main`)."""
    from snickery_tpu_torch.features.epochs import f0_from_epochs
    from snickery_tpu_torch.features.magphase import magphase_analysis

    device = device or _STATE["device"]
    out = [None] * len(waves)
    if not waves:
        return out
    gap = 2048
    groups = []
    i = 0
    while i < len(waves):
        j, total_e = i, 0
        while j < len(waves) and total_e + len(epochs_list[j]) <= group_epochs:
            total_e += len(epochs_list[j])
            j += 1
        j = max(j, i + 1)
        groups.append((i, j))
        i = j
    e_uniform = max(sum(len(epochs_list[k]) for k in range(i, j)) for i, j in groups)
    n_uniform = max(sum(len(waves[k]) + gap for k in range(i, j)) for i, j in groups)
    for i, j in groups:
        segs, eps, off = [], [], 0
        for k in range(i, j):
            segs.append(np.asarray(waves[k], np.float32))
            segs.append(np.zeros(gap, np.float32))
            eps.append(np.asarray(epochs_list[k], np.int64) + off)
            off += len(waves[k]) + gap
        segs.append(np.zeros(n_uniform - off, np.float32))
        big_wave = np.concatenate(segs)
        big_eps = np.concatenate(eps)
        big_eps = np.concatenate(
            [big_eps, np.full(e_uniform - len(big_eps), big_eps[-1], np.int64)])
        streams = magphase_analysis(big_wave, big_eps, SR, n_mag=DATADIMS["mag"],
                                    n_phase=DATADIMS["real"], device=device)
        feats = np.concatenate(
            [streams["mag"], streams["real"], streams["imag"], streams["lf0"]],
            axis=1).astype(np.float32)
        pos = 0
        for k in range(i, j):
            E = len(epochs_list[k])
            f = feats[pos: pos + E].copy()
            f[:, -1:] = f0_from_epochs(epochs_list[k], SR)
            out[k] = f
            pos += E
    return out


def make_corpus(n_utts: int, n_segments: int, seed0: int, halfphone: bool):
    """Generate, epoch-mark and analyse a corpus -> list[UtteranceData]."""
    from snickery_tpu_torch.features.epochs import detect_epochs_batch, f0_from_epochs
    from snickery_tpu_torch.voicedb.build import UtteranceData

    t0 = time.time()
    waves, segss = [], []
    for i in range(n_utts):
        w, segs = gen_utterance(seed0 + i, n_segments)
        waves.append(w)
        segss.append(segs)
    log(f"corpus: generated {n_utts} utts "
        f"({sum(len(w) for w in waves)/SR/60:.1f} min) in {time.time()-t0:.1f}s")
    t0 = time.time()
    epochs_list = detect_epochs_batch(waves, SR)
    log(f"corpus: epochs detected in {time.time()-t0:.1f}s (native)")
    t0 = time.time()
    feats_list = bulk_analyse(waves, epochs_list)
    log(f"corpus: features analysed in {time.time()-t0:.1f}s (grouped, {device()})")
    utts = []
    for i in range(n_utts):
        utts.append(UtteranceData(
            basename=f"b{i:05d}", wave=waves[i],
            epochs=np.asarray(epochs_list[i], np.int32),
            features=feats_list[i],
            lf0=f0_from_epochs(epochs_list[i], SR).reshape(-1),
            halfphones=segss[i] if halfphone else None))
    return utts


def bench_config(**over):
    from snickery_tpu_torch.config import SnickeryConfig
    base = dict(
        workdir=cache_dir(), stream_list=list(STREAMS), datadims=dict(DATADIMS),
        sample_rate=SR, n_candidates=30, taper_length=50,
        length_buckets=[2048], join_cost_weight=JCW,
        preselect_precision="split3cat", voice_name="bench")
    base.update(over)
    return SnickeryConfig(**base)


def get_voice(name: str, builder, cfg, rebuild: bool, mmap: bool = True):
    """Build-or-load a cached VoiceDB."""
    from snickery_tpu_torch.voicedb.db import VoiceDB
    path = os.path.join(cache_dir(), f"{name}.voicedb")
    if os.path.isdir(path) and not rebuild:
        db = VoiceDB.load(path, mmap=mmap)
        log(f"{name}: loaded cached voice ({db.n_units} units)")
        return db
    t0 = time.time()
    db = builder()
    db.save(path)
    log(f"{name}: built + cached in {time.time()-t0:.1f}s ({db.n_units} units)")
    return db


def held_out_features(n_utts: int, n_segments: int, seed0: int = 90_000, device=None):
    """Held-out target trajectories (in no bench voice: disjoint seeds),
    analysed on ``device`` (default: the bench's device)."""
    from snickery_tpu_torch.features.epochs import detect_epochs_batch
    waves = [gen_utterance(seed0 + i, n_segments)[0] for i in range(n_utts)]
    eps = detect_epochs_batch(waves, SR)
    return bulk_analyse(waves, eps, device=device), waves, eps


def oracle_arrays(db, synth, targets_raw):
    """Weighted float32 arrays for oracle.synth_pipeline, with the device
    pipeline's normalisation and stream weighting."""
    feats_w = db.normalised_features().astype(np.float32) * synth._sqrt_wt[None, :]
    jl, jr = db.normalised_joins()
    jl = (jl * synth._sqrt_wj[None, :]).astype(np.float32)
    jr = (jr * synth._sqrt_wj[None, :]).astype(np.float32)
    tw = ((targets_raw - db.mean_target) / db.std_target) * synth._sqrt_wt[None, :]
    return tw.astype(np.float32), feats_w, jl, jr


def agreement_metrics(ids_dev, ids_ref, tw, db, synth, jcw):
    """(raw agreement, tie-adjusted agreement, relative f64 path-cost gap).

    Unit-selection argmins are not unique: a corpus holds bit-identical
    units, and any choice among them is equally optimal.  ``tie-adjusted``
    counts a row as agreeing when the ids match or the two units are
    bit-interchangeable (feature row and both join contexts equal); the f64
    path-cost gap of the whole device sequence against the reference's is
    the optimality check (equal cost, equally correct).  Reads only the
    rows both sequences touch (the VoiceDB arrays may be memory-mapped)."""
    ids_dev = np.asarray(ids_dev)
    ids_ref = np.asarray(ids_ref)
    uids = np.unique(np.concatenate([ids_dev, ids_ref]))
    fw = ((np.asarray(db.unit_features[uids]) - db.mean_target)
          / db.std_target).astype(np.float32) * synth._sqrt_wt[None, :]
    jlw = ((np.asarray(db.join_left[uids]) - db.mean_join)
           / db.std_join).astype(np.float32) * synth._sqrt_wj[None, :]
    jrw = ((np.asarray(db.join_right[uids]) - db.mean_join)
           / db.std_join).astype(np.float32) * synth._sqrt_wj[None, :]
    p_dev = np.searchsorted(uids, ids_dev)
    p_ref = np.searchsorted(uids, ids_ref)
    same = ids_dev == ids_ref
    raw = float(same.mean())
    if same.all():
        adj = 1.0
    else:
        m = ~same
        eq = (fw[p_dev[m]] == fw[p_ref[m]]).all(-1)
        eq &= (jlw[p_dev[m]] == jlw[p_ref[m]]).all(-1)
        eq &= (jrw[p_dev[m]] == jrw[p_ref[m]]).all(-1)
        adj = float((same.sum() + eq.sum()) / same.size)

    def path_cost(pos):
        f64 = np.float64
        tc = np.sqrt(((fw[pos].astype(f64) - tw.astype(f64)) ** 2).sum(-1))
        jc = np.sqrt(((jlw[pos[1:]].astype(f64)
                       - jrw[pos[:-1]].astype(f64)) ** 2).sum(-1))
        return tc.sum() + jcw * jc.sum()

    c_dev, c_ref = path_cost(p_dev), path_cost(p_ref)
    gap = float((c_dev - c_ref) / max(abs(c_ref), 1e-12))
    return raw, adj, gap


def cached_oracle_ids(tag: str, db, targets: np.ndarray, params: str, compute):
    """Float64-oracle unit ids memoised under the cache dir, keyed by a hash
    of the voice build (its unit count and manifest), the target rows and
    the search parameters."""
    man = os.path.join(cache_dir(), f"{tag}.voicedb", "manifest.json")
    h = hashlib.sha256()
    h.update(f"{db.n_units}|{params}".encode())
    if os.path.exists(man):
        st = os.stat(man)
        h.update(f"{st.st_mtime_ns}|{st.st_size}".encode())
    h.update(np.ascontiguousarray(targets, np.float32).tobytes())
    path = os.path.join(cache_dir(), f"oracle_{tag}_{h.hexdigest()[:16]}.npy")
    if os.path.exists(path):
        ids = np.load(path)
        log(f"{tag}: oracle ids loaded from cache ({path})")
        return ids, True
    ids = np.asarray(compute())
    np.save(path, ids)
    return ids, False


def _host(t) -> np.ndarray:
    return t.cpu().numpy()


# ------------------------------------------------------------ config #3 (headline)
def fidelity_gates(args, cfg, db, synth, step, out, tgts, lengths,
                   label: str, block: dict, tag: str) -> None:
    """The fidelity gates of the headline mode and of me2:

    (a) the step at its precision against the same step at "highest" over
        all decoded rows: tie-adjusted agreement and the worst per-utterance
        f64 path-cost gap;
    (b) the float64 host oracle on ``args.oracle_rows`` held-out rows (ids
        memoised per voice build, :func:`cached_oracle_ids`).

    ``step(precision=..., lengths_=...)`` re-runs the production step;
    ``out`` is its timed result.  The numbers land in ``block``."""
    if cfg.preselect_precision != "highest":
        ref = step(precision="highest")
        ids_a_all = _host(out[0])
        ids_b_all = _host(ref[0])
        raw_w = adj_w = n_tot = 0.0
        worst_gap = 0.0
        for b in range(ids_a_all.shape[0]):
            n = int(lengths[b])
            if n < 2:
                continue
            tw_b = (((tgts[b, :n] - db.mean_target) / db.std_target)
                    * synth._sqrt_wt[None, :]).astype(np.float32)
            r, a, g = agreement_metrics(
                ids_a_all[b, :n], ids_b_all[b, :n], tw_b, db, synth, JCW)
            raw_w += r * n
            adj_w += a * n
            n_tot += n
            if abs(g) > abs(worst_gap):
                worst_gap = g
        agree = raw_w / max(n_tot, 1.0)
        agree_adj = adj_w / max(n_tot, 1.0)
        log(f"{label} unit-sequence agreement "
            f"({cfg.preselect_precision} vs exact f32): raw {agree:.5f}, "
            f"tie-adjusted {agree_adj:.5f}, worst per-utt f64 path-cost "
            f"gap {worst_gap:+.2e} (negative = kernel path cheaper)")
        block["agreement_vs_f32"] = agree
        block["agreement_vs_f32_tie_adjusted"] = agree_adj
        block["f32_gate_worst_cost_gap_rel"] = worst_gap

    if not args.skip_oracle:
        from snickery_tpu_torch import oracle
        n_rows = min(args.oracle_rows, tgts.shape[1])
        lengths_o = np.asarray(lengths).copy()
        lengths_o[0] = n_rows
        out_o = step(lengths_=lengths_o)
        ids_dev = _host(out_o[0])[0, :n_rows]
        t0 = time.time()

        def compute():
            tw, feats_w, jl, jr = oracle_arrays(db, synth, tgts[0, :n_rows])
            ids_ref, _ = oracle.synth_pipeline(
                tw, feats_w, jl, jr,
                n_candidates=cfg.n_candidates, join_cost_weight=JCW,
                fast_preselect=True)
            return ids_ref

        ids_ref, was_cached = cached_oracle_ids(
            tag, db, tgts[0, :n_rows], f"k{cfg.n_candidates}|jcw{JCW}|fast", compute)
        tw_o = (((tgts[0, :n_rows] - db.mean_target) / db.std_target)
                * synth._sqrt_wt[None, :]).astype(np.float32)
        agree_o, agree_adj, cost_gap = agreement_metrics(
            ids_dev, ids_ref, tw_o, db, synth, JCW)
        log(f"{label} agreement vs float64 oracle "
            f"({n_rows} held-out rows @ {db.n_units} units): raw {agree_o:.5f}, "
            f"tie-adjusted {agree_adj:.5f}, f64 path-cost gap {cost_gap:.2e} "
            f"(oracle {'cached' if was_cached else f'ran {time.time()-t0:.1f}s on host'})")
        block["agreement_vs_f64_oracle"] = agree_o
        block["agreement_tie_adjusted"] = agree_adj
        block["oracle_path_cost_gap_rel"] = cost_gap


def batch_arrays(synth, prepped, buckets):
    """Padded (B, T, kd) targets and (B,) lengths of unit-rate targets."""
    from snickery_tpu_torch import utils
    B = len(prepped)
    t_bucket = utils.bucket_length(max(n for _, n in prepped), tuple(buckets))
    tgts = np.zeros((B, t_bucket, synth.db.target_dim), np.float32)
    lengths = np.zeros(B, np.int64)
    for b, (tu, n) in enumerate(prepped):
        tgts[b, :n] = tu
        lengths[b] = n
    return tgts, lengths, t_bucket


def stepper(synth, tgts, lengths, t_bucket, **fixed):
    """The production step on fixed inputs, uploaded once:
    ``step(precision=..., lengths_=...)`` -> (unit ids (B, T), costs,
    audio, total samples), through ``parallel.batched_synth_step`` on the
    Synthesiser's (1 x 1) mesh."""
    import torch

    from snickery_tpu_torch import utils
    from snickery_tpu_torch.parallel import batched_synth_step
    cfg, dev = synth.cfg, synth.device
    synth.ensure_sharded()
    out_len = utils.next_multiple(t_bucket * synth.max_span + 2 * cfg.taper_length, 128)
    tgts_dev = torch.from_numpy(tgts).to(dev)
    lengths_dev = torch.from_numpy(np.asarray(lengths, np.int64)).to(dev)
    fixed = {k: (torch.from_numpy(v).to(dev) if isinstance(v, np.ndarray) else v)
             for k, v in fixed.items()}

    def step(precision=cfg.preselect_precision, lengths_=None):
        lens = (lengths_dev if lengths_ is None
                else torch.from_numpy(np.asarray(lengths_, np.int64)).to(dev))
        return batched_synth_step(
            synth._sharded_voice, tgts_dev, lens, JCW, 0.0,
            fixed.get("voice_ids"), fixed.get("tgt_codes"), fixed.get("tgt_ctx"),
            mesh=synth._mesh, n_cand=min(cfg.n_candidates, synth.n_units_padded),
            max_frag=synth.max_frag, out_len=out_len, taper=cfg.taper_length,
            precision=precision, halfphone=fixed.get("halfphone", False),
            ling_weights=fixed.get("ling_weights"), margin=cfg.preselect_margin,
            zero_transient=cfg.zero_transient, do_ola=cfg.preload_all_waves)

    step.targets = tgts_dev
    step.lengths = lengths_dev
    return step


def kernel_at_shape(synth, step, precision: str | None = None, reps: int = 3) -> dict:
    """The preselect kernel of ``step``'s operands (its weighted targets,
    dead steps zeroed, against the Synthesiser's resident voice) held to
    its plain twin (``kernel_check.compare``), both timed, with the bound
    and ``torch.matmul`` of the product beside them (no mask: epoch
    voices)."""
    import torch

    from snickery_tpu_torch import kernel_check
    from snickery_tpu_torch.ops import cuda_topk
    from snickery_tpu_torch.ops.topk import preselect_margin, resolve_zero_transient
    cfg, d, dev = synth.cfg, synth.device_db, synth.device
    precision = precision or cfg.preselect_precision
    tgts, lengths = step.targets, step.lengths
    B, T, kd = tgts.shape
    aff = (d.mean_t, d.std_t, d.sqrt_wt)
    live = torch.arange(T, device=dev)[None, :] < lengths.reshape(B, 1)
    x = torch.where(live[:, :, None], (tgts - d.mean_t) / d.std_t * d.sqrt_wt,
                    torch.zeros((), device=dev)).reshape(B * T, kd).contiguous()
    m_rows = d.cut1.shape[0]
    zt = resolve_zero_transient(cfg.zero_transient, precision)
    k = min(min(cfg.n_candidates, synth.n_units_padded)
            + preselect_margin(True, precision, zero_transient=zt,
                               override=cfg.preselect_margin), m_rows)
    name = cuda_topk.kernel_name(False, False, precision, zt)
    if zt:
        block, block_aff, sqn, row_bytes, rows = d.raw, aff, None, None, d.raw[:m_rows, :kd]
    else:
        block, sqn = cuda_topk.derive_operand(d.raw, aff, d.n_real, m_rows, precision)
        block_aff, row_bytes, rows = None, block.shape[1] * block.element_size() + 4, block
    err, nbad, dead = kernel_check.compare(x, block, block_aff, m_rows, k, precision,
                                           sqn=sqn, n_real=int(d.n_real))
    kw = dict(precision=precision, zero_transient=zt, sqn=sqn)
    ms = kernel_check.time_ms(lambda: cuda_topk.cuda_topk_preselect(
        x, block, k, block_aff, m_rows, **kw), reps, dev)
    if zt:
        plain = lambda: cuda_topk.topk_preselect_zt_plain(  # noqa: E731
            x, block, k, block_aff, m_rows, precision=precision)
    else:
        plain = lambda: cuda_topk.topk_preselect_dv_plain(  # noqa: E731
            x, block, sqn, k, m_rows, precision=precision)
    plain_ms = kernel_check.time_ms(plain, 1, dev)
    mm_ms = kernel_check.matmul_ms(x, rows, precision)
    b_ms, b_by = kernel_check.bound_ms(B * T, m_rows, kd, k, precision, False, row_bytes)
    row = {"name": name, "shape": f"{B * T} x {m_rows} x {kd}, k {k}", "T": B * T,
           "m_rows": m_rows, "kd": kd, "k": k, "precision": precision, "ms": ms,
           "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by, "matmul_ms": mm_ms,
           "max_abs_err": err, "near_tie_rows": nbad, "dead_slots": dead}
    log(f"{name} {row['shape']}: kernel {ms:.3f} ms, plain {plain_ms:.2f} ms, bound "
        f"{b_ms:.3f} ms ({b_by}), torch.matmul {mm_ms:.2f} ms, max_abs_err {err:.3e}, "
        f"near-tie id swaps {nbad}")
    return row


def profile_step(step, path: str, median_ms: float) -> dict:
    """One step under ``torch.profiler`` (trace written to ``path``): the
    device's busy time (the union of its kernels' and copies' intervals)
    over the median step time, and the count of device kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    dev = device()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    os.makedirs(path, exist_ok=True)
    sync()
    with profile(activities=acts) as prof:
        wall = _timed_ms(step)
    trace = os.path.join(path, "config3_step.trace.json")
    prof.export_chrome_trace(trace)
    spans = sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy_us, end = 0.0, -math.inf
    for s, e, _ in spans:
        if e > end:
            busy_us += e - max(s, end)
            end = e
    kernels = sum(not n.startswith(("Memcpy", "Memset")) for _, _, n in spans)
    out = {"trace": trace, "profiled_step_ms": wall,
           "device_busy_ms": busy_us / 1e3 if spans else None,
           "device_busy_share": busy_us / 1e3 / median_ms if spans else None,
           "device_kernels": kernels if spans else None,
           "device_copies": len(spans) - kernels if spans else None}
    log(f"config3 torch.profiler trace of one step -> {trace}: "
        + (f"device busy {busy_us / 1e3:.1f} ms = {out['device_busy_share']:.3f} of the "
           f"median step {median_ms:.1f} ms; {kernels} device kernels, "
           f"{len(spans) - kernels} copies (profiled step {wall:.1f} ms)" if spans
           else "no device activity recorded (device busy share not measured)"))
    return out


def epoch_voice(args):
    """The config-3 voice: ``bench1m`` (``--units`` // 767 utterances) or,
    with ``--quick``, ``benchq`` (24); built and cached if needed."""
    from snickery_tpu_torch.voicedb.build import build_voicedb
    cfg = bench_config(voice_name="bench1m")
    name = "bench1m" if not args.quick else "benchq"
    # ~767 epoch units per 6 s utterance of 40 segments
    n_utts = args.units // 767 if not args.quick else 24
    db = get_voice(name, lambda: build_voicedb(cfg, make_corpus(n_utts, 40, 10_000, False)),
                   cfg, args.rebuild)
    return cfg, name, db


def run_epoch_mode(args, extra: dict):
    from snickery_tpu_torch.synth import Synthesiser

    cfg, tag, db = epoch_voice(args)
    t0 = time.time()
    synth = Synthesiser(cfg, db=db, device=device())
    log(f"device DB prepared in {time.time()-t0:.1f}s "
        f"({synth.n_units_padded} padded units, max_span {synth.max_span})")

    # held-out targets: ~1900 units per utterance at T bucket 2048
    tgt_feats, _, _ = held_out_features(args.batch, 128 if not args.quick else 16)
    if args.quick:
        synth.cfg.length_buckets = [256]
    # every utterance inside the one T bucket
    t_cap = synth.cfg.length_buckets[0] + 2
    tgt_feats = [f[:t_cap] for f in tgt_feats]

    # first call through the public API (kernel build or load + upload + audio)
    t0 = time.time()
    results = synth.synth_batch(tgt_feats)
    compile_s = time.time() - t0
    log(f"first batched step (incl. kernel load): {compile_s:.1f}s")
    audio_sec_first = sum(len(r["wave"]) for r in results) / SR
    log(f"synthesised {audio_sec_first:.0f} audio-sec across {len(results)} utts")

    prepped = [synth.targets_from_features(f) for f in tgt_feats]
    tgts, lengths, t_bucket = batch_arrays(synth, prepped, synth.cfg.length_buckets)
    step = stepper(synth, tgts, lengths, t_bucket)
    step()
    sync()
    latency = _timed_ms(step) / 1e3
    ms, out, launches = timed_steps(step, args.iters)
    stats = step_stats(ms)
    wall = stats["ms_per_step"] / 1e3

    audio_sec = float(out[3].sum()) / SR
    rtf = wall / audio_sec
    units_per_sec = float(lengths.sum()) / wall
    log(f"config3 steady-state: median {wall*1e3:.1f} ms/step (min "
        f"{stats['ms_per_step_min']:.1f}, max {stats['ms_per_step_max']:.1f}, "
        f"{args.iters} steps), {latency*1e3:.1f} ms single-step latency, "
        f"{audio_sec:.1f} audio-sec/step, {units_per_sec:,.0f} lattice-steps/s, "
        f"kernel launches a step {launches}")
    extra["config3"] = {"rtf": rtf, **stats, "single_step_latency_ms": latency * 1e3,
                        "units_per_sec": units_per_sec, "audio_sec_per_step": audio_sec,
                        "n_units": db.n_units, "batch": len(prepped), "bucket_T": t_bucket,
                        "precision": cfg.preselect_precision,
                        "first_step_sec": compile_s, "launches_per_step": launches}
    if args.profile:
        extra["config3"]["profile"] = profile_step(step, args.profile, wall * 1e3)
    # the headline before the gates: a timeout there must not lose it
    _STATE["rtf"] = rtf
    flush_partial()

    fidelity_gates(args, cfg, db, synth, step, out, tgts, lengths,
                   "config3", extra["config3"], tag)
    return rtf, synth, step


# --------------------------------------------- the kernel against its twin
def run_kernel_check(args, extra: dict, synth=None, step=None):
    """The stream kernel against its plain twin (``kernel_check.compare``):
    at the JAX check's shape (256 random targets x 8,192 random rows x 151,
    k 16) at "highest" and at the bench's precision, and, after the epoch
    mode, at the config-3 batch shape on its voice.  ``kernel_vs_twin`` is
    true when every case passes; a case that fails is logged, recorded and
    raised after the others ran."""
    import torch

    from snickery_tpu_torch import kernel_check
    from snickery_tpu_torch.ops import cuda_topk
    from snickery_tpu_torch.voicedb.device_layout import build_raw_blocks, identity_affine

    dev = device()
    rng = np.random.default_rng(17)
    T, M, k = 256, 8192, 16
    targets = torch.from_numpy(rng.standard_normal((T, D)).astype(np.float32)).to(dev)
    rows = rng.standard_normal((M, D)).astype(np.float32)
    jr = np.zeros_like(rows)
    jr[:-1] = rows[1:]
    aff_np = identity_affine(D)
    raw = torch.from_numpy(build_raw_blocks(rows, jr, M, affine=aff_np)[0]).to(dev)
    aff = tuple(torch.from_numpy(np.asarray(a, np.float32)).to(dev) for a in aff_np)
    cases, failures = [], []

    def case(label, fn):
        try:
            row = fn()
            row["ok"] = True
        except RuntimeError as e:
            log(f"kernel vs twin {label}: MISMATCH: {e}")
            row = {"ok": False, "error": str(e)[:200]}
            failures.append(f"{label}: {e}")
        cases.append({"case": label, **row})

    for precision in ("highest", "split3cat"):
        def synthetic(precision=precision):
            err, nbad, _ = kernel_check.compare(targets, raw, aff, M, k, precision)
            ms = kernel_check.time_ms(lambda: cuda_topk.cuda_topk_preselect(
                targets, raw, k, aff, M, precision=precision), 3, dev)
            log(f"kernel vs twin {T} x {M} x {D} k {k} {precision}: max_abs_err {err:.3e}, "
                f"near-tie id swaps {nbad}, kernel {ms:.3f} ms")
            return {"name": cuda_topk.kernel_name(False, False, precision),
                    "shape": f"{T} x {M} x {D}, k {k}", "ms": ms, "max_abs_err": err,
                    "near_tie_rows": nbad}
        case(f"random_{precision}", synthetic)
    if synth is not None:
        case("config3_batch", lambda: kernel_at_shape(synth, step))
    ok = not failures
    log(f"kernel vs twin: {'OK' if ok else 'MISMATCH'} ({len(cases)} cases)")
    extra["kernel_vs_twin"] = ok
    extra["kernel_check"] = {"cases": cases,
                             "kernel_ms": cases[-1].get("ms"), "device": str(dev)}
    if failures:
        raise RuntimeError("kernel differs from its twin: " + "; ".join(failures))


# ----------------------------------------------------- config #1 (toy voice)
def toy_voice(args):
    from snickery_tpu_torch.voicedb.build import build_voicedb
    cfg = bench_config(voice_name="benchtoy", length_buckets=[512])
    db = get_voice("benchtoy",
                   lambda: build_voicedb(cfg, make_corpus(50, 40, 70_000, False)),
                   cfg, args.rebuild)
    return cfg, db


def run_toy_mode(args, extra: dict):
    """BASELINE config #1: single-utterance synthesis on a toy voice (~5 min
    of speech, epoch units, top-30 preselect).  The metric at this scale is
    the per-utterance latency through the public API, host round trip
    included."""
    from snickery_tpu_torch.evaluate import f0_metrics, mel_cepstral_distortion, nsim
    from snickery_tpu_torch.features.epochs import detect_epochs
    from snickery_tpu_torch.synth import Synthesiser

    dev = device()
    cfg, db = toy_voice(args)
    synth = Synthesiser(cfg, db=db, device=dev)
    feats, ref_waves, _ = held_out_features(3, 32, seed0=95_000)
    synth.synth_from_features(feats[0])          # warm
    times, results = [], []
    for i in range(6):
        t0 = time.time()
        r = synth.synth_from_features(feats[i % len(feats)])
        times.append(time.time() - t0)
        if i < len(feats):
            results.append(r)
    lat = float(np.median(times)) * 1e3
    audio_s = len(r["wave"]) / SR
    # objective quality against the held-out originals (not in the DB)
    mcd = float(np.nanmean([mel_cepstral_distortion(r["wave"], w, SR, device=dev)
                            for r, w in zip(results, ref_waves)]))
    nsim_mean = float(np.nanmean([nsim(r["wave"], w, SR, device=dev)
                                  for r, w in zip(results, ref_waves)]))
    pros = [f0_metrics(r["wave"], w, SR, device=dev) for r, w in zip(results, ref_waves)]
    ffe = float(np.nanmean([p["ffe"] for p in pros]))
    f0_rmse = float(np.nanmean([p["f0_rmse_hz"] for p in pros]))
    flux_all = [_join_flux(synth, r) for r in results]
    # quality mode evaluates the same held-out set on the same voice
    _STATE["toy_quality_row"] = {
        "voice": "benchtoy", "n_units": db.n_units,
        "held_out_mcd_db": mcd, "nsim": nsim_mean, "ffe": ffe, "f0_rmse_hz": f0_rmse,
        "join_flux_ratio": float(np.nanmean([f["ratio"] for f in flux_all]))}
    # scale anchor: a training utterance rides the natural zero-join path
    w_nat, _ = gen_utterance(70_000, 40)
    f_nat = bulk_analyse([w_nat], [detect_epochs(w_nat, SR)])[0]
    r_nat = synth.synth_from_features(f_nat)
    mcd_nat = mel_cepstral_distortion(r_nat["wave"], w_nat, SR, device=dev)
    flux = flux_all[0]
    log(f"config1 toy voice ({db.n_units} units, ~5 min speech): "
        f"{lat:.1f} ms median per-utterance latency for ~{audio_s:.1f}s "
        f"audio (public API incl. host round trip); held-out MCD {mcd:.2f} dB "
        f"(natural-reconstruction floor {mcd_nat:.2f} dB); join flux ratio "
        f"{flux['ratio']:.2f}")
    extra["config1"] = {"latency_ms": lat, "n_units": db.n_units,
                        "audio_sec": audio_s, "held_out_mcd_db": mcd,
                        "held_out_nsim": nsim_mean,
                        "natural_reconstruction_mcd_db": float(mcd_nat),
                        "held_out_ffe": ffe, "held_out_f0_rmse_hz": f0_rmse,
                        "join_flux_ratio": flux["ratio"],
                        "n_nonnatural_joins": flux["n_joins"]}


def _join_flux(synth, result) -> dict:
    """Spectral flux at the non-natural joins of one result (corpus-
    consecutive units reconstruct the corpus exactly)."""
    from snickery_tpu_torch.evaluate import join_discontinuity
    ids = np.asarray(result["unit_ids"])
    cuts = synth.db.cutpoints
    spans = (cuts[ids, 2] - cuts[ids, 1]).astype(np.int64)
    starts = synth.cfg.taper_length + np.cumsum(spans) - spans
    nonnat = np.nonzero(cuts[ids[1:], 1] != cuts[ids[:-1], 2])[0] + 1
    out = join_discontinuity(result["wave"], synth.cfg.sample_rate, starts[nonnat],
                             device=synth.device)
    return {"ratio": float(out["ratio"]), "n_joins": int(len(nonnat))}


# ------------------------------------------------------------- 48 kHz voice
def run_48k_mode(args, extra: dict):
    """A config-#1-style toy voice at 48 kHz: epoch rate, max_span and OLA
    geometry scale 3x; latency, RTF and agreement with the float64 oracle."""
    import scipy.signal as sps

    from snickery_tpu_torch import oracle
    from snickery_tpu_torch.features.epochs import detect_epochs_batch, f0_from_epochs
    from snickery_tpu_torch.features.magphase import magphase_analysis
    from snickery_tpu_torch.synth import Synthesiser
    from snickery_tpu_torch.voicedb.build import UtteranceData, build_voicedb

    sr48 = 48000
    dev = device()

    def corpus48(n_utts, seed0):
        waves = [sps.resample_poly(gen_utterance(seed0 + i, 30)[0], 3, 1).astype(np.float32)
                 for i in range(n_utts)]
        eps = detect_epochs_batch(waves, sr48)
        utts = []
        for i, (w, e) in enumerate(zip(waves, eps)):
            streams = magphase_analysis(w, np.asarray(e, np.int64), sr48,
                                        n_mag=DATADIMS["mag"], n_phase=DATADIMS["real"],
                                        device=dev)
            f = np.concatenate([streams["mag"], streams["real"],
                                streams["imag"], streams["lf0"]], axis=1).astype(np.float32)
            f[:, -1:] = f0_from_epochs(e, sr48)
            utts.append(UtteranceData(
                basename=f"k{i:04d}", wave=w, epochs=np.asarray(e, np.int32), features=f,
                lf0=f0_from_epochs(e, sr48).reshape(-1)))
        return utts

    cfg = bench_config(voice_name="bench48k", sample_rate=sr48,
                       length_buckets=[1024], taper_length=150)
    db = get_voice("bench48k", lambda: build_voicedb(cfg, corpus48(24, 82_000)),
                   cfg, args.rebuild)
    synth = Synthesiser(cfg, db=db, device=dev)
    test_utts = corpus48(2, 86_000)
    synth.synth_from_features(test_utts[0].features)         # warm
    times, results = [], []
    for i in range(4):
        u = test_utts[i % len(test_utts)]
        t0 = time.time()
        r = synth.synth_from_features(u.features)
        times.append(time.time() - t0)
        if i < len(test_utts):
            results.append(r)
    lat = float(np.median(times)) * 1e3
    audio_s = len(results[0]["wave"]) / sr48
    rtf48 = (lat / 1e3) / audio_s
    tgt, _ = synth.targets_from_features(test_utts[0].features)
    tw, feats_w, jl, jr = oracle_arrays(db, synth, tgt)
    ids_ref, _ = oracle.synth_pipeline(
        tw, feats_w, jl, jr, n_candidates=cfg.n_candidates,
        join_cost_weight=JCW, fast_preselect=True)
    agree, agree_adj, cost_gap = agreement_metrics(
        results[0]["unit_ids"], ids_ref, tw, db, synth, JCW)
    log(f"config-48k ({db.n_units} units @ 48 kHz): {lat:.1f} ms/utt "
        f"({audio_s:.1f}s audio, rtf {rtf48:.5f}), oracle agreement "
        f"raw {agree:.5f} / tie-adjusted {agree_adj:.5f} (cost gap {cost_gap:.2e})")
    extra["config_48k"] = {"latency_ms": lat, "rtf": rtf48,
                           "n_units": db.n_units, "sample_rate": sr48,
                           "agreement_vs_f64_oracle": agree,
                           "agreement_tie_adjusted": agree_adj,
                           "oracle_path_cost_gap_rel": cost_gap}


# --------------------------------------------- quality trend vs DB size
def run_quality_mode(args, extra: dict, synth_1m=None):
    """MCD, NSIM, FFE and join flux against DB size: the toy voice (reused
    from config 1 when it ran), ~170k units (``benchmid``; ``--quick``: 80
    utterances), the config-3 voice when the epoch mode ran, and its
    multiepoch=2 voice when cached."""
    from snickery_tpu_torch.evaluate import f0_metrics, mel_cepstral_distortion, nsim
    from snickery_tpu_torch.synth import Synthesiser
    from snickery_tpu_torch.voicedb.build import build_voicedb
    from snickery_tpu_torch.voicedb.db import VoiceDB

    dev = device()
    feats, ref_waves, _ = held_out_features(3, 32, seed0=95_000)
    trend = []

    def eval_voice(name, synth):
        mcds, fluxes, ffes, nsims = [], [], [], []
        for f, w in zip(feats, ref_waves):
            f = f[: 2 * synth.cfg.length_buckets[-1]]
            r = synth.synth_from_features(f)
            mcds.append(mel_cepstral_distortion(r["wave"], w, SR, device=dev))
            nsims.append(nsim(r["wave"], w, SR, device=dev))
            ffes.append(f0_metrics(r["wave"], w, SR, device=dev)["ffe"])
            fluxes.append(_join_flux(synth, r)["ratio"])
        row = {"voice": name, "n_units": synth.db.n_units,
               "held_out_mcd_db": float(np.nanmean(mcds)),
               "nsim": float(np.nanmean(nsims)),
               "ffe": float(np.nanmean(ffes)),
               "join_flux_ratio": float(np.nanmean(fluxes))}
        trend.append(row)
        log(f"quality[{name}]: {row['n_units']} units, "
            f"MCD {row['held_out_mcd_db']:.2f} dB, NSIM {row['nsim']:.3f}, "
            f"FFE {row['ffe']:.3f}, flux ratio {row['join_flux_ratio']:.2f}")

    if _STATE.get("toy_quality_row") is not None:
        row = _STATE["toy_quality_row"]
        trend.append(row)
        log(f"quality[benchtoy]: {row['n_units']} units, "
            f"MCD {row['held_out_mcd_db']:.2f} dB, "
            f"flux ratio {row['join_flux_ratio']:.2f} (reused from config1)")
    else:
        cfg_toy, db_toy = toy_voice(args)
        eval_voice("benchtoy", Synthesiser(cfg_toy, db=db_toy, device=dev))

    mid, n_mid = ("benchmid", 220) if not args.quick else ("benchmidq", 80)
    cfg_mid = bench_config(voice_name=mid, length_buckets=[512])
    db_mid = get_voice(mid, lambda: build_voicedb(cfg_mid, make_corpus(n_mid, 40, 75_000, False)),
                       cfg_mid, args.rebuild)
    eval_voice(mid, Synthesiser(cfg_mid, db=db_mid, device=dev))

    if synth_1m is not None:
        old = synth_1m.cfg.length_buckets
        synth_1m.cfg.length_buckets = [512]
        try:
            eval_voice("bench1m" if not args.quick else "benchq", synth_1m)
        finally:
            synth_1m.cfg.length_buckets = old

    # the multiepoch=2 voice, when the me2 mode built it
    for me2 in ("bench1m_me2", "bench1m_me2d"):
        me2_dir = os.path.join(cache_dir(), me2 + ".voicedb")
        if os.path.isdir(me2_dir) and not over_budget(90.0):
            cfg_me2 = bench_config(voice_name=me2, multiepoch=2, length_buckets=[512])
            eval_voice(me2, Synthesiser(cfg_me2, db=VoiceDB.load(me2_dir), device=dev))
            break
    extra["quality_trend"] = trend


# ----------------------------------------------------- config #3, multiepoch=2
def run_me2_mode(args, extra: dict):
    """The config-3 voice at ``multiepoch=2``: units span 2 pitch periods,
    so a lattice step covers twice the audio and the contraction dim is 302.
    The voice is derived from the cached config-3 voice by indexing
    (``derive_multiepoch``, equal to building at multiepoch=2 on the same
    corpus) when no me2 voice is cached.  Gates as the headline mode's, and
    the kernel against its twin at this step's shape."""
    from snickery_tpu_torch.synth import Synthesiser
    from snickery_tpu_torch.voicedb.build import build_voicedb, derive_multiepoch
    from snickery_tpu_torch.voicedb.db import VoiceDB

    cfg = bench_config(voice_name="bench1m_me2", multiepoch=2, length_buckets=[1024])
    n_utts = (2 * args.units) // 767 if not args.quick else 24

    me2_name = "bench1m_me2" if not args.quick else "benchq_me2"
    base_name = "bench1m" if not args.quick else "benchq"
    base_path = os.path.join(cache_dir(), base_name + ".voicedb")
    if (not os.path.isdir(os.path.join(cache_dir(), me2_name + ".voicedb"))
            and os.path.isdir(base_path)):
        me2_name += "d"
        db = get_voice(me2_name,
                       lambda: derive_multiepoch(VoiceDB.load(base_path, mmap=False), 2),
                       cfg, rebuild=False)
    else:
        db = get_voice(me2_name,
                       lambda: build_voicedb(cfg, make_corpus(n_utts, 40, 20_000, False)),
                       cfg, args.rebuild)
    synth = Synthesiser(cfg, db=db, device=device())
    tgt_feats, _, _ = held_out_features(args.batch, 128 if not args.quick else 16,
                                        seed0=94_000)
    if args.quick:
        synth.cfg.length_buckets = [128]
    t_cap = 2 * synth.cfg.length_buckets[0] + 2
    tgt_feats = [f[:t_cap] for f in tgt_feats]

    prepped = [synth.targets_from_features(f) for f in tgt_feats]
    tgts, lengths, t_bucket = batch_arrays(synth, prepped, synth.cfg.length_buckets)
    step = stepper(synth, tgts, lengths, t_bucket)
    step()
    sync()
    ms, out, launches = timed_steps(step, args.iters)
    stats = step_stats(ms)
    wall = stats["ms_per_step"] / 1e3
    audio_sec = float(out[3].sum()) / SR
    rtf = wall / audio_sec
    log(f"config3-me2 ({db.n_units} 2-epoch units, "
        f"{len(db.waves)/SR/3600:.2f} h corpus): median {wall*1e3:.1f} ms/step (min "
        f"{stats['ms_per_step_min']:.1f}, max {stats['ms_per_step_max']:.1f}), "
        f"{audio_sec:.1f} audio-sec/step, rtf {rtf:.5f}, kernel launches a step {launches}")
    extra["config3_me2"] = {"rtf": rtf, **stats,
                            "n_units": db.n_units, "multiepoch": 2, "kd": db.target_dim,
                            "batch": len(prepped), "bucket_T": t_bucket,
                            "launches_per_step": launches,
                            "inventory": ("derived_from_" + base_name
                                          if me2_name.endswith("d") else "own_2x_corpus")}
    flush_partial()
    fidelity_gates(args, cfg, db, synth, step, out, tgts, lengths,
                   "config3-me2", extra["config3_me2"], me2_name)
    extra["config3_me2"]["kernel_at_shape"] = kernel_at_shape(synth, step)


# ------------------------------------------- single-card capacity
def run_capacity_mode(args, extra: dict):
    """The config-3 voice tiled ``--cap-tile`` times (bit-identical replicas:
    capacity and step-time evidence only) or, with ``--cap-tile`` 0 / 1, a
    real ``--cap-units`` corpus, at ``preselect_precision="split3"`` with
    int16 waves.  Gated by split3-vs-highest unit agreement (tie-adjusted)
    on the same block; reports the peak device memory."""
    import torch

    from snickery_tpu_torch.synth import Synthesiser
    from snickery_tpu_torch.voicedb.build import build_voicedb
    from snickery_tpu_torch.voicedb.db import VoiceDB

    dev = device()
    cfg = bench_config(voice_name="bench8m", preselect_precision="split3",
                       waves_dtype="int16")
    if args.cap_tile > 1:
        _, base_name, _ = epoch_voice(args)
        t0 = time.time()
        db = VoiceDB.load(os.path.join(cache_dir(), base_name + ".voicedb"),
                          mmap=False).tiled(args.cap_tile)
        log(f"capacity: tiled {base_name} x{args.cap_tile} -> {db.n_units} "
            f"units in {time.time()-t0:.1f}s (host)")
    else:
        n_utts = args.cap_units // 767
        db = get_voice("bench8m",
                       lambda: build_voicedb(cfg, make_corpus(n_utts, 40, 300_000, False)),
                       cfg, args.rebuild)
    raw_gib = db.n_units * (db.target_dim + 2) * 4 / 2**30
    waves_gib = len(db.waves) * 2 / 2**30
    used_gib, used_src = device_bytes_in_use()
    if dev.type == "cuda":
        free_gib = torch.cuda.mem_get_info(dev)[0] / 2**30
        if raw_gib + waves_gib + CAPACITY_RESERVE_GIB > free_gib:
            cfg = dataclasses.replace(cfg, preload_all_waves=False)
        log(f"capacity: raw block {raw_gib:.2f} GiB + int16 waves {waves_gib:.2f} GiB + "
            f"reserve {CAPACITY_RESERVE_GIB:.0f} GiB against {free_gib:.1f} GiB free "
            f"({used_gib:.2f} GiB already allocated) -> preload_all_waves="
            f"{cfg.preload_all_waves}")
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.time()
    synth = Synthesiser(cfg, db=db, device=dev)
    log(f"capacity: device DB prepared in {time.time()-t0:.1f}s "
        f"({synth.n_units_padded} padded units)")

    B = 8
    n_seg, bucket = (128, cfg.length_buckets[0]) if not args.quick else (16, 256)
    synth.cfg.length_buckets = [bucket]
    tgt_feats, _, _ = held_out_features(B, n_seg, seed0=97_000)
    prepped = [synth.targets_from_features(f[:bucket + 2]) for f in tgt_feats]
    tgts, lengths, t_bucket = batch_arrays(synth, prepped, [bucket])
    step = stepper(synth, tgts, lengths, t_bucket)

    t0 = time.time()
    step()
    sync()
    log(f"capacity: first step {time.time()-t0:.1f}s")
    ms, out, launches = timed_steps(step, max(2, args.iters // 2))
    stats = step_stats(ms)
    wall = stats["ms_per_step"] / 1e3
    audio_sec = float(out[3].sum()) / SR
    rtf = wall / audio_sec
    log(f"capacity ({db.n_units} units on one {dev.type} device, split3): "
        f"median {wall*1e3:.1f} ms/step, {audio_sec:.1f} audio-sec/step, rtf {rtf:.5f}, "
        f"kernel launches a step {launches}")
    ref = step("highest")
    mask = np.arange(t_bucket)[None, :] < lengths[:, None]
    ids_a = _host(out[0])[mask]
    ids_b = _host(ref[0])[mask]
    raw = float((ids_a == ids_b).mean())
    m = ids_a != ids_b
    uids = np.unique(np.concatenate([ids_a[m], ids_b[m]]))
    fw = np.asarray(db.unit_features[uids])
    jlw = np.asarray(db.join_left[uids])
    jrw = np.asarray(db.join_right[uids])
    pa, pb = np.searchsorted(uids, ids_a[m]), np.searchsorted(uids, ids_b[m])
    eq = ((fw[pa] == fw[pb]).all(-1) & (jlw[pa] == jlw[pb]).all(-1)
          & (jrw[pa] == jrw[pb]).all(-1))
    adj = float(((~m).sum() + eq.sum()) / ids_a.size)
    peak_gb, peak_src = device_bytes_in_use(peak=True)
    log(f"capacity agreement (split3 vs highest): raw {raw:.5f}, tie-adjusted {adj:.5f}; "
        f"peak device memory {peak_gb if peak_gb is None else round(peak_gb, 3)} GiB "
        f"({peak_src})")
    extra["capacity"] = {
        "rtf": rtf, **stats, "n_units": db.n_units,
        "precision": "split3_zero_transient", "batch": B,
        "hbm_bytes_in_use_gb": peak_gb, "hbm_source": peak_src,
        "device_bytes_before_gb": used_gib, "device_bytes_source": used_src,
        "agreement_split3_vs_highest": raw,
        "agreement_tie_adjusted": adj,
        "launches_per_step": launches,
        "inventory": (f"tiled_x{args.cap_tile}" if args.cap_tile > 1 else "real_corpus"),
        "waves_dtype": cfg.waves_dtype,
        "preload_all_waves": cfg.preload_all_waves,
    }


# ------------------------------------------------------------ config #2 halfphone
def run_halfphone_mode(args, extra: dict):
    from snickery_tpu_torch import utils
    from snickery_tpu_torch.features.epochs import detect_epochs
    from snickery_tpu_torch.synth import Synthesiser
    from snickery_tpu_torch.voicedb.build import build_voicedb

    cfg = bench_config(voice_name="benchhp", target_representation="halfphone",
                       length_buckets=[128], n_candidates=20)
    n_utts = args.hp_units // 80 if not args.quick else 16   # ~80 hp units/utt
    tag = "benchhp" if not args.quick else "benchhpq"
    db = get_voice(tag, lambda: build_voicedb(cfg, make_corpus(n_utts, 40, 30_000, True)),
                   cfg, args.rebuild)
    synth = Synthesiser(cfg, db=db, device=device())

    feats_list, segs_list = [], []
    for i in range(4):
        w, segs = gen_utterance(91_000 + i, 40)
        eps = detect_epochs(w, SR)
        f = bulk_analyse([w], [eps])[0]
        tgt, kept = synth.halfphone_targets_from_features(f, eps, segs)
        feats_list.append(tgt)
        segs_list.append(kept)

    t0 = time.time()
    results = synth.synth_batch(feats_list, segments_list=segs_list)
    log(f"config2 first batched halfphone step: {time.time()-t0:.1f}s")
    match = np.mean([
        (db.unit_code[r["unit_ids"]]
         == [synth._unit_vocab.get(s.name, -2) for s in segs]).mean()
        for r, segs in zip(results, segs_list)])

    B = len(feats_list)
    t_bucket = utils.bucket_length(max(len(f) for f in feats_list), tuple(cfg.length_buckets))
    tgts = np.zeros((B, t_bucket, db.target_dim), np.float32)
    lengths = np.zeros(B, np.int64)
    tcodes = np.full((B, t_bucket), -1, np.int32)
    tctx = np.full((B, t_bucket, 5), -1, np.int32)
    for b, (f, segs) in enumerate(zip(feats_list, segs_list)):
        n = len(f)
        tgts[b, :n] = f
        lengths[b] = n
        tcodes[b, :n] = [synth._unit_vocab.get(s.name, -1) for s in segs]
        tctx[b, :n] = [[synth._phone_vocab.get(p, 0) for p in s.quinphone] for s in segs]
    step = stepper(synth, tgts, lengths, t_bucket, tgt_codes=tcodes, tgt_ctx=tctx,
                   halfphone=True, ling_weights=synth._ling_weights())
    step()
    sync()
    ms, out, launches = timed_steps(step, args.iters)
    stats = step_stats(ms)
    wall = stats["ms_per_step"] / 1e3
    audio_sec_step = float(out[3].sum()) / SR
    rtf = wall / audio_sec_step
    log(f"config2 halfphone ({db.n_units} units): median {wall*1e3:.1f} ms/step, "
        f"{audio_sec_step:.1f} audio-sec/step, rtf {rtf:.5f}, identity match {match:.3f}, "
        f"kernel launches a step {launches}")
    extra["config2"] = {"rtf": rtf, **stats, "n_units": db.n_units,
                        "halfphone_identity_match": float(match),
                        "launches_per_step": launches}

    if not args.skip_oracle:
        from snickery_tpu_torch import oracle
        from snickery_tpu_torch.const import ID_RANK_PENALTY
        segs0 = segs_list[0]
        n0 = len(feats_list[0])
        codes_t = np.asarray([synth._unit_vocab.get(s.name, -1) for s in segs0])
        ctx_t = np.asarray([[synth._phone_vocab.get(p, 0) for p in s.quinphone]
                            for s in segs0])
        # the penalty weights the device kernel fuses (Synthesiser._ling_weights);
        # the identity penalty enters both the preselect ranking and the
        # lattice costs, the context penalties the ranking only
        *ctx_w, pen_scale = synth._ling_weights()
        id_pen = (codes_t[:, None] != db.unit_code[None, :]) * float(ID_RANK_PENALTY)
        pen = id_pen.copy()
        for c, w in enumerate(ctx_w):
            if w:
                pen = pen + ((ctx_t[:, c:c + 1] != db.context_codes[None, :, c])
                             * (w * pen_scale))
        t0 = time.time()

        def compute():
            tw0, feats_w, jl, jr = oracle_arrays(db, synth, feats_list[0])
            ids_ref, _ = oracle.synth_pipeline(
                tw0, feats_w, jl, jr,
                n_candidates=min(cfg.n_candidates, synth.n_units_padded),
                join_cost_weight=JCW, extra=pen, lattice_penalty=id_pen)
            return ids_ref

        ids_ref, was_cached = cached_oracle_ids(
            tag, db, feats_list[0],
            f"k{cfg.n_candidates}|jcw{JCW}|hp3|{synth._ling_weights()}", compute)
        ids_dev = results[0]["unit_ids"][:n0]
        agree_hp = float((ids_dev == ids_ref).mean())
        log(f"config2 agreement vs float64 oracle ({n0} halfphone targets "
            f"@ {db.n_units} units): {agree_hp:.5f} "
            f"(oracle {'cached' if was_cached else f'ran {time.time()-t0:.1f}s'})")
        extra["config2"]["agreement_vs_f64_oracle"] = agree_hp


# ------------------------------------------------------------ config #4 streaming
def _drive_stream(synth, chunks, **kw):
    """One streaming pass -> (per-chunk ms, total wall s, audio samples)."""
    times, audio_samples = [], 0
    t_all = time.time()
    gen = synth.synth_streaming(iter(chunks), **kw)
    while True:
        t0 = time.time()
        try:
            piece = next(gen)
        except StopIteration:
            break
        times.append(time.time() - t0)
        audio_samples += len(piece)
    return np.asarray(times) * 1e3, time.time() - t_all, audio_samples


def _stream_decompose(synth) -> dict | None:
    """Where a streaming chunk's latency goes:

    - the host stages ``synth_streaming`` records for each chunk
      (``last_stream_stages``: pulling, preparing and enqueuing the chunk,
      and waiting for its results), medians;
    - ``device_ms``: CUDA events around the last chunk's step, re-run
      (median of 8; on the CPU the host clock);
    - ``rtt_ms``: a synchronise with nothing queued (mean of 20);
    - ``payload_fetch_ms``: a device-to-host copy of one chunk's result
      (ids, audio, total; mean of 8)."""
    import torch

    from snickery_tpu_torch.synth import streaming_step
    last = getattr(synth, "_last_stream_step", None)
    st = getattr(synth, "last_stream_stages", None)
    if last is None or st is None or not st["fetch_ms"]:
        return None
    args, kw = last
    dev = synth.device
    out = streaming_step(*args, **kw)
    sync(dev)
    t0 = time.perf_counter()
    for _ in range(20):
        sync(dev)
    rtt_ms = (time.perf_counter() - t0) / 20 * 1e3
    t0 = time.perf_counter()
    for _ in range(8):
        [t.cpu() for t in (out[0], out[2], out[3])]
    payload_ms = (time.perf_counter() - t0) / 8 * 1e3
    dev_ms = []
    for _ in range(8):
        if dev.type == "cuda":
            start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            streaming_step(*args, **kw)
            stop.record()
            stop.synchronize()
            dev_ms.append(start.elapsed_time(stop))
        else:
            dev_ms.append(_timed_ms(lambda: streaming_step(*args, **kw), dev))
    med = {k: float(np.median(v)) for k, v in st.items() if v}
    return {
        "device_ms": float(np.median(dev_ms)),
        "rtt_ms": rtt_ms,
        "payload_fetch_ms": payload_ms,
        "host_pull_ms": med.get("pull_ms", 0.0),
        "host_prep_ms": med.get("prep_ms", 0.0),
        "host_dispatch_ms": med.get("dispatch_ms", 0.0),
        "observed_fetch_ms": med.get("fetch_ms", 0.0),
    }


def _greedy_quality(synth, n_utts: int = 2, chunk_rows: int = 32) -> dict:
    """The quality cost of the greedy and chunked-streaming decoders against
    Viterbi on the same held-out utterances: MCD, NSIM, join flux, the f64
    path cost and the unit overlap with the Viterbi selection."""
    from snickery_tpu_torch.evaluate import mel_cepstral_distortion, nsim
    feats, ref_waves, _ = held_out_features(n_utts, 32, seed0=95_000)
    cfg = synth.cfg
    dev = synth.device
    old_buckets = cfg.length_buckets
    jcw, db = cfg.join_cost_weight, synth.db
    out: dict = {}
    ids_v: list = []
    try:
        for mode in ("viterbi", "greedy", "stream"):
            mcds, nsims, fluxes, overlaps, costs = [], [], [], [], []
            for i, (f, w) in enumerate(zip(feats, ref_waves)):
                f = f[:1024]
                if mode == "stream":
                    cfg.length_buckets = [64]
                    chunks = [f[j:j + chunk_rows] for j in range(0, len(f), chunk_rows)]
                    wave = np.concatenate(list(synth.synth_streaming(iter(chunks))))
                    ids = np.concatenate(synth.last_stream_unit_ids)
                    r = {"wave": wave, "unit_ids": ids}
                else:
                    cfg.length_buckets = [512]
                    r = synth.synth_from_features(f, greedy=(mode == "greedy"))
                    ids = r["unit_ids"]
                mcds.append(mel_cepstral_distortion(r["wave"], w, SR, device=dev))
                nsims.append(nsim(r["wave"], w, SR, device=dev))
                fluxes.append(_join_flux(synth, r)["ratio"])
                # f64 path cost of the selected sequence (agreement_metrics' maths)
                tgt, n = synth.targets_from_features(f)
                n = min(n, len(ids))
                tw = (((tgt[:n] - db.mean_target) / db.std_target)
                      * synth._sqrt_wt[None, :]).astype(np.float32)
                uids = np.unique(ids[:n])
                fw = ((np.asarray(db.unit_features[uids]) - db.mean_target)
                      / db.std_target).astype(np.float32) * synth._sqrt_wt
                jlw = ((np.asarray(db.join_left[uids]) - db.mean_join)
                       / db.std_join).astype(np.float32) * synth._sqrt_wj
                jrw = ((np.asarray(db.join_right[uids]) - db.mean_join)
                       / db.std_join).astype(np.float32) * synth._sqrt_wj
                pos = np.searchsorted(uids, ids[:n])
                f64 = np.float64
                tc = np.sqrt(((fw[pos].astype(f64) - tw.astype(f64)) ** 2).sum(-1)).sum()
                jc = np.sqrt(((jlw[pos[1:]].astype(f64)
                               - jrw[pos[:-1]].astype(f64)) ** 2).sum(-1)).sum()
                costs.append(float(tc + jcw * jc))
                if mode == "viterbi":
                    ids_v.append(ids)
                else:
                    n_o = min(len(ids), len(ids_v[i]))
                    overlaps.append(float((ids[:n_o] == ids_v[i][:n_o]).mean()))
            row = {"mcd_db": float(np.nanmean(mcds)),
                   "nsim": float(np.nanmean(nsims)),
                   "join_flux_ratio": float(np.nanmean(fluxes)),
                   "f64_path_cost": float(np.mean(costs))}
            if overlaps:
                row["unit_overlap_vs_viterbi"] = float(np.mean(overlaps))
            out[mode] = row
            log(f"greedy-quality[{mode}]: MCD {row['mcd_db']:.2f} dB, "
                f"NSIM {row['nsim']:.3f}, flux {row['join_flux_ratio']:.2f}, "
                f"path cost {row['f64_path_cost']:.1f}"
                + (f", overlap {row.get('unit_overlap_vs_viterbi', 1):.3f}"
                   if overlaps else ""))
    finally:
        cfg.length_buckets = old_buckets
    out["cost_increase_greedy_rel"] = (
        out["greedy"]["f64_path_cost"] / out["viterbi"]["f64_path_cost"] - 1.0)
    out["cost_increase_stream_rel"] = (
        out["stream"]["f64_path_cost"] / out["viterbi"]["f64_path_cost"] - 1.0)
    return out


def run_streaming_mode(args, extra: dict, synth):
    """Streaming latency on the config-3 voice, both input modes:
    ``config4``, fixed-rate 5 ms DNN-style frames (the predicted lf0
    integrates into an epoch grid across chunks); ``config4_natural``,
    epoch-rate natural-feature chunks."""
    from snickery_tpu_torch.features.world import resample_to_fixed

    cfg = synth.cfg
    old_buckets = cfg.length_buckets
    cfg.length_buckets = [64]        # small chunks, a small step
    try:
        feats, _, eps = held_out_features(1, 96, seed0=92_000)
        f = feats[0][1:-1]
        chunk_rows = args.stream_chunk

        fs = 0.005
        fixed = resample_to_fixed(feats[0], np.asarray(eps[0]), SR, fs)
        frames_per_chunk = max(8, int(round(chunk_rows * 1.0)))
        fchunks = [fixed[i:i + frames_per_chunk]
                   for i in range(0, len(fixed), frames_per_chunk)]
        list(synth.synth_streaming(iter(fchunks[:3]), fixed_frameshift=fs))
        per_h, wall_h, samples_h = _drive_stream(synth, fchunks, fixed_frameshift=fs)
        ph = per_h[1:-1]
        p50h, p95h = float(np.percentile(ph, 50)), float(np.percentile(ph, 95))
        rtf_h = wall_h / (samples_h / SR)
        log(f"config4 hybrid streaming ({len(fchunks)} fixed-rate chunks of "
            f"{frames_per_chunk} frames @ {fs*1e3:.0f} ms): latency p50 "
            f"{p50h:.2f} ms, p95 {p95h:.2f} ms, rtf {rtf_h:.5f}")
        extra["config4"] = {"chunk_latency_p50_ms": p50h,
                            "chunk_latency_p95_ms": p95h,
                            "rtf": rtf_h,
                            "input": "fixed_rate_dnn_style",
                            "frameshift_ms": fs * 1e3,
                            "chunk_frames": frames_per_chunk}
        decomp = _stream_decompose(synth)
        if decomp:
            log("config4 chunk-latency decomposition (ms): "
                + ", ".join(f"{k} {v:.3f}" for k, v in decomp.items()))
            extra["config4"].update({k: round(v, 3) for k, v in decomp.items()})

        chunks = [f[i:i + chunk_rows] for i in range(0, len(f), chunk_rows)]
        list(synth.synth_streaming(iter(chunks[:2])))     # warm
        per, wall_total, audio_samples = _drive_stream(synth, chunks)
        pn = per[1:-1]
        p50, p95 = float(np.percentile(pn, 50)), float(np.percentile(pn, 95))
        rtf_stream = wall_total / (audio_samples / SR)
        log(f"config4-natural streaming ({len(chunks)} chunks of {chunk_rows} "
            f"units, ~{audio_samples/len(per)/SR*1e3:.0f} ms audio/chunk): "
            f"latency p50 {p50:.2f} ms, p95 {p95:.2f} ms, rtf {rtf_stream:.5f}")
        extra["config4_natural"] = {"chunk_latency_p50_ms": p50,
                                    "chunk_latency_p95_ms": p95,
                                    "rtf": rtf_stream,
                                    "chunk_units": chunk_rows}
        flush_partial()
        # the latency numbers above land even when the budget cannot afford this
        if not over_budget(150.0):
            gq = _greedy_quality(synth)
            extra["config4"]["quality_vs_viterbi"] = gq
            extra["config4"]["greedy_mcd_delta_db"] = round(
                gq["greedy"]["mcd_db"] - gq["viterbi"]["mcd_db"], 3)
            extra["config4"]["stream_mcd_delta_db"] = round(
                gq["stream"]["mcd_db"] - gq["viterbi"]["mcd_db"], 3)
        else:
            log("greedy-quality measurement SKIPPED: budget")
    finally:
        cfg.length_buckets = old_buckets


# ------------------------------------------------------------ config #5 multivoice
def run_multivoice_mode(args, extra: dict):
    from snickery_tpu_torch.synth import Synthesiser
    from snickery_tpu_torch.voicedb.build import build_voicedb
    from snickery_tpu_torch.voicedb.multivoice import merge_voicedbs

    n_voices = 8 if not args.quick else 2
    cfg = bench_config(voice_name="benchmv", length_buckets=[256])

    def build():
        per_voice = (args.mv_units // n_voices) // 600 if not args.quick else 8
        dbs = [build_voicedb(cfg, make_corpus(per_voice, 40, 50_000 + v * 1000, False))
               for v in range(n_voices)]
        return merge_voicedbs(dbs, names=[f"v{v}" for v in range(n_voices)])

    db = get_voice("benchmv" if not args.quick else "benchmvq", build, cfg, args.rebuild)
    synth = Synthesiser(cfg, db=db, device=device())

    B = args.mv_batch if not args.quick else 8
    feats, _, _ = held_out_features(4, 15, seed0=93_000)
    feats = [f[: cfg.length_buckets[0] + 2] for f in feats]
    feats_list = [feats[i % len(feats)] for i in range(B)]
    voices = [f"v{i % n_voices}" for i in range(B)]
    t0 = time.time()
    results = synth.synth_batch(feats_list, voices=voices)
    log(f"config5 first batch-{B} step: {time.time()-t0:.1f}s")
    leaks = sum(int((db.voice_ids[r["unit_ids"]] != i % n_voices).sum())
                for i, r in enumerate(results))

    prepped = [synth.targets_from_features(f) for f in feats_list]
    tgts, lengths, t_bucket = batch_arrays(synth, prepped, cfg.length_buckets)
    vids = np.asarray([synth._voice_code(v) for v in voices], np.int32)
    step = stepper(synth, tgts, lengths, t_bucket, voice_ids=vids)
    step()
    sync()
    ms, out, launches = timed_steps(step, args.iters)
    stats = step_stats(ms)
    wall = stats["ms_per_step"] / 1e3
    audio_sec = float(out[3].sum()) / SR
    rtf = wall / audio_sec
    log(f"config5 multi-voice ({n_voices} voices, {db.n_units} units, batch {B}): "
        f"median {wall*1e3:.1f} ms/step, {audio_sec:.1f} audio-sec/step, rtf {rtf:.5f}, "
        f"cross-voice leaks {leaks}, kernel launches a step {launches}")
    extra["config5"] = {"rtf": rtf, **stats, "batch": B, "n_voices": n_voices,
                        "n_units": db.n_units, "cross_voice_leaks": leaks,
                        "launches_per_step": launches}


# ----------------------------------------------------------------------- main
def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="snickery_tpu_torch.bench",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--modes", default=",".join(MODES),
                    help="comma list of " + ",".join(MODES) + " (in order of importance: "
                         "the headline config and its gates first, so that a budget cut "
                         "loses only tail configs)")
    ap.add_argument("--units", type=int, default=1_048_576)
    ap.add_argument("--cap-units", type=int, default=8_388_608,
                    help="capacity mode with --cap-tile 0 / 1: the unit count of a real corpus")
    ap.add_argument("--cap-tile", type=int, default=8,
                    help="capacity mode: tile the config-3 voice N-fold in memory "
                         "(VoiceDB.tiled; bit-identical replicas: step time and "
                         "capacity only); 0 / 1 = build a real --cap-units corpus")
    ap.add_argument("--hp-units", type=int, default=50_000)
    ap.add_argument("--mv-units", type=int, default=262_144)
    ap.add_argument("--mv-batch", type=int, default=64)
    ap.add_argument("--batch", type=int, default=32,
                    help="utterances a batched step (configs 3 and me2)")
    ap.add_argument("--iters", type=int, default=5,
                    help="timed steps a mode (each synchronised; the median is reported)")
    ap.add_argument("--stream-chunk", type=int, default=32,
                    help="epoch units per streaming chunk")
    ap.add_argument("--oracle-rows", type=int, default=1024,
                    help="held-out rows for the float64-oracle gate (ids memoised "
                         "per voice build)")
    ap.add_argument("--skip-oracle", action="store_true")
    ap.add_argument("--rebuild", action="store_true", help="rebuild cached bench voices")
    ap.add_argument("--quick", action="store_true", help="small smoke shapes")
    ap.add_argument("--profile", default="",
                    help="directory for a torch.profiler trace of one steady config-3 step")
    ap.add_argument("--budget-sec", type=float, default=1080.0,
                    help="soft wall-clock budget: remaining modes are skipped once "
                         "exceeded (0 = unlimited); a hard SIGALRM at budget + 120 s "
                         "and a watchdog at budget + 150 s print the line and exit 1")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default: the hand-written kernels; raises without "
                         "CUDA) or cpu (their plain twins)")
    ap.add_argument("--cache-dir", default="",
                    help=f"voices, oracle ids and records (default {DEFAULT_CACHE})")
    ap.add_argument("--out", default="", help="also write the full record here")
    args = ap.parse_args(argv)
    if args.iters < 1:
        ap.error("--iters must be at least 1")
    unknown = [m for m in args.modes.split(",") if m.strip() and m.strip() not in MODES]
    if unknown:
        ap.error(f"unknown modes {unknown}; have {','.join(MODES)}")
    return args


def main(argv=None) -> int:
    args = parse_args(argv)
    import torch

    from snickery_tpu_torch import utils

    dev = utils.torch_device(args.device)
    if dev.type == "cuda":
        # full f32 products in the step and the gates (as Synthesiser sets)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    _STATE.clear()
    _STATE.update(_fresh_state())
    _STATE.update(budget=max(0.0, args.budget_sec), device=dev,
                  cache=os.path.abspath(os.path.expanduser(args.cache_dir)) if args.cache_dir
                  else None, out=os.path.abspath(args.out) if args.out else None)
    extra = _STATE["extra"]
    card = card_line()
    log(f"device: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    extra["device"] = card
    extra["run_id"] = uuid.uuid4().hex[:12]

    old_handlers = {s: signal.signal(s, _die_flushing) for s in (signal.SIGTERM, signal.SIGALRM)}
    stop_watchdog = None
    if _STATE["budget"]:
        signal.alarm(int(_STATE["budget"]) + 120)
        stop_watchdog = _start_watchdog(_STATE["budget"] + 150.0)
    try:
        run_modes(args, [m.strip() for m in args.modes.split(",") if m.strip()])
        extra["bench_elapsed_sec"] = round(elapsed(), 1)
        emit_final()
    finally:
        signal.alarm(0)
        for s, h in old_handlers.items():
            signal.signal(s, h)
        if stop_watchdog is not None:
            stop_watchdog.set()
    failed = sorted(k[:-6] for k in extra if k.endswith("_error"))
    if failed:
        log(f"modes that raised: {failed}: exit 1")
        return 1
    return 0


def run_modes(args, modes: list) -> None:
    extra = _STATE["extra"]
    cdir = cache_dir()
    synth, step = None, None

    def run_one(name, fn, *fn_args, reserve=0.0):
        # reserve: what the mode is expected to cost; a mode that cannot
        # finish inside the budget is skipped up front
        if over_budget(reserve):
            log(f"{name} mode SKIPPED: budget {_STATE['budget']:.0f}s "
                f"exceeded ({elapsed():.0f}s elapsed, reserve {reserve:.0f}s)")
            extra[name + "_skipped"] = "budget"
            return None
        t_mode = time.time()
        try:
            return fn(args, extra, *fn_args)
        except Exception as e:
            log(f"{name} mode FAILED: {type(e).__name__}: {e}")
            traceback.print_exc(file=sys.stderr)
            extra[name + "_error"] = f"{type(e).__name__}: {e}"
            return None
        finally:
            extra.setdefault("mode_sec", {})[name] = round(time.time() - t_mode, 1)
            gc.collect()
            if device().type == "cuda":
                import torch
                torch.cuda.empty_cache()
            flush_partial()

    base = "bench1m" if not args.quick else "benchq"

    def cached(name):
        return os.path.isdir(os.path.join(cdir, name + ".voicedb"))

    if "epoch" in modes:
        out = run_one("epoch", run_epoch_mode)
        if out is not None:
            _STATE["rtf"], synth, step = out
    if "kernel" in modes:
        run_one("kernel", run_kernel_check, synth, step, reserve=30.0)
    if "streaming" in modes:
        if synth is not None:
            # reuses the epoch mode's synthesiser, right after its gates
            run_one("streaming", run_streaming_mode, synth, reserve=60.0)
        elif "epoch_skipped" in extra:
            extra["streaming_skipped"] = "budget"
        else:
            extra["streaming_error"] = "RuntimeError: streaming needs the epoch mode's voice"
    step = None        # the config-3 batch's device tensors go before the larger modes
    if "me2" in modes:
        me2 = base + "_me2"
        run_one("me2", run_me2_mode, reserve=200.0 if cached(me2) or cached(me2 + "d")
                else (300.0 if cached(base) else 600.0))
    if "capacity" in modes:
        run_one("capacity", run_capacity_mode,
                reserve=150.0 if (args.cap_tile > 1 and cached(base)) else 600.0)
    for name, fn, reserve in (("halfphone", run_halfphone_mode, 60.0),
                              ("multivoice", run_multivoice_mode, 120.0),
                              ("toy", run_toy_mode, 90.0),
                              ("48k", run_48k_mode, 90.0)):
        if name in modes:
            run_one(name, fn, reserve=reserve)
    if "quality" in modes:
        run_one("quality", run_quality_mode, synth, reserve=120.0)


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (snickery_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # a few minutes of command time on an H100

Phases, each timed, any failure ending the run with a non-zero exit:

1. the card and the versions of torch, CUDA and nvcc;
2. the kernel build from ``snickery_tpu_torch/csrc`` (nvcc, ``sm_90a``);
3. the preselect kernel against its plain PyTorch twin on the card, at
   T in {128, 2048} x M in {8192, 65536}, with duplicated DB rows (ties), and
   with T and M that are not multiples of the kernel tiles;
4. the kernel's masked variants (voice partition, quinphone penalties, both)
   against their twins at kd 151 and 453, T in {128, 2048, 300}, on labels
   drawn from an 80-halfphone / 40-phone inventory and 8 voices, with a
   voice of fewer than k rows (starved slots must read (+inf, 0)) and
   target codes that no DB row carries (the fallback pool);
5. config 3 (epoch units): a voice built with numpy alone, about 3,000
   synthetic utterances, 1,048,500 units, d = 151 (mag 60, real 45, imag 45,
   lf0 1), 16 kHz, smooth AR(1) feature walks and 80-160-sample periods;
   the main path through ``Synthesiser(cfg, db, device="cuda")``:
   ``synth_from_features`` on 3 utterances (a corpus utterance must come back
   as its own units) and ``synth_batch`` at B = 8 and B = 32 x T = 2048, a
   per-stage split of one B = 32 step, the kernel against its twin at those
   shapes, and a held-out utterance against the float64 oracle;
6. config 2 (halfphone units): 625 numpy-made utterances of 40 phones with
   HalfphoneSegment labels and quinphone contexts, about 50,000 units,
   kd = 3 x 151 = 453, n_candidates 20, length bucket 128;
   ``synth_from_features`` and ``synth_batch`` at B = 4 with the halfphone
   identity gate, and a held-out utterance against the float64 oracle with
   the same penalties (path-cost gap gate);
7. config 5 (multi-voice): 8 numpy-made voices merged into 262,144 epoch
   units, ``synth_batch`` at B = 64 x T = 256 with mixed voices (no unit may
   leak across voices) and a corpus utterance sent to its own voice;
8. composition: two merged halfphone voices, a mixed-voice ``synth_batch``
   at B = 4 (no leaks, identity match >= 0.9), once on two small voices
   (4,800 units each) and once at config-2 scale (50,000 units each);
9. the split precisions against their twins (synthetic, kd 151, T in
   {128, 2048, 300} x M in {8192, 65536, 8229}, duplicated rows; split3cat at
   k 48, split3 at k 40), near-ties judged in float64 on the three bf16
   products, and each variant's distance from "highest"; then both split
   kernels on a probe whose dropped lo * lo products exceed the f32
   rounding, held to the float64 hh + hl + lh, which "highest" must miss;
10. config 3 at ``preselect_precision="split3cat"`` (the JAX bench's speed
    mode): a second Synthesiser on the config-3 voice, ``synth_batch``
    B = 32 x 2048 with a per-stage split, the kernel against its twin, the
    held-out utterance against the float64 oracle, and unit agreement with
    the "highest" batch (raw and tie-adjusted);
11. config 4, streaming on that voice at split3cat (length bucket 64): one
    held-out utterance of 2,050 epochs as fixed-rate 5 ms frames in chunks of
    32 and as epoch-rate features in chunks of 32 units; per-chunk latency
    p50 / p95, RTF, the host stage lists and one chunk's device stage split;
    exact sample totals and streamed-vs-greedy unit agreement; the kernel
    against its twin on a chunk's targets (T = 64);
12. capacity: the config-3 voice tiled x8 (8,388,000 units, a 5.13 GB raw
    block) at ``preselect_precision="split3"`` with int16 waves and the audio
    on the host (``preload_all_waves=False``): ``synth_batch`` B = 8 x 2048,
    peak device memory, the kernel against its twin, and the same targets at
    "highest" on the same block (tie-adjusted agreement);
13. the split precisions with the fused masks (the six split x mask
    variants) against their twins at kd 151 and 453, T in {128, 2048, 300},
    with duplicated rows, starved voices and codes no row carries (this
    check runs with phases 3, 4 and 9, before the voices are built);
14. the port's HTTP server (``snickery_tpu_torch.server``, warmed as
    ``serve`` warms it, on 127.0.0.1 at an ephemeral port, ``urllib``
    clients) on the config-2 voice at split3cat: 4 concurrent ``POST
    /synth`` with segments (identity match, f64 path-cost gap against the
    oracle, equal to direct calls, ``/stream`` answers 400), then one
    synth_batch step at split3 (agreement with "highest");
15. the server on the config-5 voice at split3cat, max_batch 32, max_wait
    20 ms: 64 concurrent ``POST /synth`` of 256 units round-robin over the 8
    voices (all 200, no leaks, ids equal to direct calls, tie-adjusted
    agreement with phase 7's "highest" batch, batching observed in
    ``/stats``), one ``POST /stream`` (ids equal to a direct
    ``synth_streaming``, audio to f32 rounding, exact sample total); then
    one step at split3;
16. the CLI: the config-5 DB saved with ``VoiceDB.save``, 8 DNN-target
    utterances as stream files, ``python -m snickery_tpu_torch.cli synth
    --voice v3 --dump-units`` in a subprocess at synth_batch 8 and
    split3cat; its units.npy must equal a direct synth_batch;
17. the server on the two merged 50,000-unit halfphone voices at split3cat
    with voices and segments, then one step at split3.

Each main path runs with the launch counts set to 0 just before it and read
just after; the kernel it needs must have launched.  Standard output ends
with a JSON line of the kernels (launches on the main paths, max error
against the twin, kernel, twin and ``torch.matmul``-of-the-product times,
and the bound from the card's published peaks), the card's name and power
limit from nvidia-smi, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import base64
import json
import os
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np

from snickery_tpu_torch.kernel_check import PROBE_RTOL, check, compare, split_probe_error
from snickery_tpu_torch.synthetic_voices import (DATADIMS, KD, SR, make_halfphone_utterances,
                                               make_utterances, phone_means)

STREAMS = ["mag", "real", "imag", "lf0"]
JCW = 0.7
N_UTTS = 3000            # config 3: 1,048,500 epoch units
T_BUCKET = 2048
HP_UTTS = 625            # config 2: 625 x 80 = 50,000 halfphone units
MV_EPOCHS = [351] * 93 + [313]   # config 5: 32,768 units a voice, 8 voices
COMP_UTTS = 60           # composition: 4,800 halfphone units a voice
KERNEL_SOURCE = "snickery_tpu_torch/csrc/topk_preselect.cu"
REPLACES = {
    "topk_preselect_zt": "snickery_tpu/ops/pallas_topk.py:904",
    "topk_preselect_zt_part": "snickery_tpu/ops/pallas_topk.py:904 (+:187-191)",
    "topk_preselect_zt_ling": "snickery_tpu/ops/pallas_topk.py:904 (+:192-208)",
    "topk_preselect_zt_ling_part": "snickery_tpu/ops/pallas_topk.py:904 (+:187-208)",
    "topk_preselect_zt_split3cat": "snickery_tpu/ops/pallas_topk.py:904 (+:158-178)",
    "topk_preselect_zt_split3": "snickery_tpu/ops/pallas_topk.py:904 (+:77-93, :156-157)",
    "topk_preselect_zt_split3cat_part": "snickery_tpu/ops/pallas_topk.py:904 (+:158-191)",
    "topk_preselect_zt_split3cat_ling": "snickery_tpu/ops/pallas_topk.py:904 (+:158-178, :192-208)",
    "topk_preselect_zt_split3cat_ling_part": "snickery_tpu/ops/pallas_topk.py:904 (+:158-208)",
    "topk_preselect_zt_split3_part": "snickery_tpu/ops/pallas_topk.py:904 (+:77-93, :156-157, :187-191)",
    "topk_preselect_zt_split3_ling": "snickery_tpu/ops/pallas_topk.py:904 (+:77-93, :156-157, :192-208)",
    "topk_preselect_zt_split3_ling_part": "snickery_tpu/ops/pallas_topk.py:904 (+:77-93, :156-157, :187-208)",
}
# the card's published peaks (H100 SXM data sheet, dense, at 700 W): FP32
# outside the tensor cores for "highest", bf16 tensor cores for the splits
PEAK_FLOPS = {"highest": 67e12, "split3": 989e12, "split3cat": 989e12}
HBM_BYTES_PER_S = 3.35e12
STREAM_CHUNK = 32        # config 4: units (epoch-rate) or 5 ms frames a chunk
CAP_TILE = 8             # capacity: the config-3 voice x8, 8,388,000 units
JAX_TPU_CONFIG2_AGREEMENT = 0.9875   # BENCH_full.json config2, a TPU v5e run


def log(msg: str) -> None:
    print(msg, flush=True)


class Phase:
    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.t0 = time.perf_counter()
        log(f"== {self.name}")
        return self

    def __exit__(self, *exc):
        if exc[0] is None:
            log(f"== {self.name}: {time.perf_counter() - self.t0:.1f} s")
        return False


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout
    return out.strip().splitlines()[0]


# ----------------------------------------------------------- kernel vs plain
def synthetic_block(rng, m: int, kd: int, dup: bool):
    from snickery_tpu_torch.voicedb.device_layout import build_raw_blocks
    feats = rng.standard_normal((m, kd), dtype=np.float32)
    if dup:
        feats[100:140] = feats[50]
    jr = np.zeros_like(feats)
    jr[:-1] = feats[1:]
    mean = (0.1 * rng.standard_normal(kd)).astype(np.float32)
    std = rng.uniform(0.5, 2.0, kd).astype(np.float32)
    w = rng.uniform(0.2, 1.0, kd).astype(np.float32)
    raw, _, _ = build_raw_blocks(feats, jr, m, affine=(mean, std, w))
    return raw, (mean, std, w)


def bound_ms(T: int, m_rows: int, kd: int, k: int, precision: str, masked: bool):
    """(least time in ms, "operations" or "bytes") the card could take for
    one preselect call: 2 T m_rows kd FLOP per product (three bf16 products
    at a split precision) at the peak rate of its type, against the bytes
    the call must move (targets, the raw block's data and sqn columns, the
    metadata rows when masked, each read once; the (T, k) scores and ids
    written once) at HBM bandwidth.  The mask compares are integer work
    beside the kd products of each score and are not counted."""
    flops = 2.0 * T * m_rows * kd * (1 if precision == "highest" else 3)
    nbytes = 4.0 * (T * kd + m_rows * (kd + 1) + 2 * T * k)
    if masked:
        nbytes += 32.0 * (T + m_rows)
    t_ops, t_bytes = flops / PEAK_FLOPS[precision], nbytes / HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def matmul_ms(torch, x, rows, precision: str) -> float:
    """Card time of the product alone, ``x @ rows.T`` for targets x (T, kd)
    and DB rows (m, kd), as torch.matmul computes it at the same precision:
    f32 (no TF32) at "highest"; at a split precision bf16 operands with f32
    accumulation, one matmul over the 3 kd pairs (split3cat) or three
    (split3).  Chunked over the DB so each output stays within 1 GiB.  A
    yardstick only: no PyTorch call fuses the product with an exact top-k,
    and the port never calls this."""
    from snickery_tpu_torch.ops.cuda_topk import split_bf16
    T = x.shape[0]
    step = max(64, (1 << 28) // T)
    if precision == "highest":
        pairs = [(x, rows)]
    else:
        bf = torch.bfloat16
        th, tl = (a.to(bf) for a in split_bf16(x))
        rh, rl = (a.to(bf) for a in split_bf16(rows.contiguous()))
        if precision == "split3cat":
            pairs = [(torch.cat([th, tl, th], 1), torch.cat([rh, rh, rl], 1))]
        else:
            pairs = [(th, rh), (tl, rh), (th, rl)]

    def run():
        for lo in range(0, rows.shape[0], step):
            for a, b in pairs:
                torch.matmul(a, b[lo:lo + step].T)

    ms = time_ms(torch, run, 1)
    del pairs
    return ms


def time_ms(torch, fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def kernel_vs_plain_synthetic(torch) -> float:
    dev = torch.device("cuda")
    worst = 0.0
    shapes = [(128, 8192, False), (128, 65536, False), (2048, 8192, False),
              (2048, 65536, False), (256, 8192, True), (300, 8192 + 37, False)]
    for i, (T, M, dup) in enumerate(shapes):
        rng = np.random.default_rng(100 + i)
        raw_np, aff_np = synthetic_block(rng, M, KD, dup)
        raw = torch.from_numpy(raw_np).to(dev)
        aff = tuple(torch.from_numpy(a).to(dev) for a in aff_np)
        tg = torch.from_numpy(rng.standard_normal((T, KD), dtype=np.float32)).to(dev)
        err, nbad, _ = compare(tg, raw, aff, M, 40)
        worst = max(worst, err)
        log(f"kernel vs plain T={T} M={M} kd={KD} k=40 dup={dup}: "
            f"max_abs_err {err:.3e}, rows with near-tie id swaps {nbad}")
    return worst


def synthetic_labels(rng, T: int, M: int, k: int):
    """Target and DB labels from an 80-halfphone / 40-phone inventory and 8
    voices: 16 targets ask for a code no DB row carries, 32 for voice 7,
    which has k // 2 rows, and 8 for voice 9, which has none."""
    tc = rng.integers(0, 80, T).astype(np.int32)
    tc[:16] = 80
    tx = rng.integers(0, 40, (T, 5)).astype(np.int32)
    tv = rng.integers(0, 7, T).astype(np.int32)
    tv[16:48] = 7
    tv[48:56] = 9
    dc = rng.integers(0, 80, M).astype(np.int32)
    dx = rng.integers(0, 40, (M, 5)).astype(np.int32)
    dv = rng.integers(0, 7, M).astype(np.int32)
    dv[rng.choice(M, k // 2, replace=False)] = 7
    return tc, tx, tv, dc, dx, dv


def split_masked_variants_synthetic(torch) -> dict:
    """The split precisions with the fused masks (partition, quinphone
    penalties, both) against their twins at kd 151 and 453, with duplicated
    rows, starved voices and codes no row carries; returns {kernel name:
    max_abs_err}."""
    from snickery_tpu_torch.const import QUINPHONE_CONTEXT_WEIGHTS, QUINPHONE_SCALE
    from snickery_tpu_torch.ops.cuda_topk import kernel_name, pack_meta
    from snickery_tpu_torch.synth import BACKOFF_LING_WEIGHTS
    dev = torch.device("cuda")
    errs = {}
    variants = [(True, None), (False, (*QUINPHONE_CONTEXT_WEIGHTS, QUINPHONE_SCALE)),
                (True, BACKOFF_LING_WEIGHTS)]
    for kd in (KD, 3 * KD):
        for T, M in ((128, 65536), (2048, 65536), (300, 8192 + 37)):
            rng = np.random.default_rng(7 * kd + T)
            raw_np, aff_np = synthetic_block(rng, M, kd, True)
            raw = torch.from_numpy(raw_np).to(dev)
            aff = tuple(torch.from_numpy(a).to(dev) for a in aff_np)
            tg = torch.from_numpy(rng.standard_normal((T, kd), dtype=np.float32)).to(dev)
            for precision, k in (("split3cat", 48), ("split3", 40)):
                tc, tx, tv, dc, dx, dv = (torch.from_numpy(a).to(dev)
                                          for a in synthetic_labels(rng, T, M, k))
                meta = dict(tgt_meta=pack_meta(tc, tx, tv), db_meta=pack_meta(dc, dx, dv))
                for partition, weights in variants:
                    name = kernel_name(partition, weights is not None, precision)
                    err, nbad, dead = compare(tg, raw, aff, M, k, precision,
                                              partition=partition, ling_weights=weights,
                                              **meta)
                    errs[name] = max(errs.get(name, 0.0), err)
                    if partition:
                        check(dead >= 32 * (k - k // 2) + 8 * k,
                              f"starved slots missing ({dead})")
                    log(f"{name} vs plain T={T} M={M} kd={kd} k={k} dup=True: max_abs_err "
                        f"{err:.3e}, near-tie id swaps {nbad}, dead slots {dead}")
    return errs


def kernel_variants_synthetic(torch) -> dict:
    """Every masked variant against its twin at kd 151 and 453; returns
    {kernel name: max_abs_err}."""
    from snickery_tpu_torch.const import QUINPHONE_CONTEXT_WEIGHTS, QUINPHONE_SCALE
    from snickery_tpu_torch.ops.cuda_topk import kernel_name, pack_meta
    from snickery_tpu_torch.synth import BACKOFF_LING_WEIGHTS
    dev = torch.device("cuda")
    errs = {}
    variants = [(True, None), (False, (*QUINPHONE_CONTEXT_WEIGHTS, QUINPHONE_SCALE)),
                (True, BACKOFF_LING_WEIGHTS)]
    for kd in (KD, 3 * KD):
        for T, M in ((128, 65536), (2048, 65536), (300, 8192 + 37)):
            rng = np.random.default_rng(kd + T)
            raw_np, aff_np = synthetic_block(rng, M, kd, False)
            raw = torch.from_numpy(raw_np).to(dev)
            aff = tuple(torch.from_numpy(a).to(dev) for a in aff_np)
            tg = torch.from_numpy(rng.standard_normal((T, kd), dtype=np.float32)).to(dev)
            tc, tx, tv, dc, dx, dv = (torch.from_numpy(a).to(dev)
                                      for a in synthetic_labels(rng, T, M, 30))
            meta = dict(tgt_meta=pack_meta(tc, tx, tv), db_meta=pack_meta(dc, dx, dv))
            for partition, weights in variants:
                name = kernel_name(partition, weights is not None)
                err, nbad, dead = compare(tg, raw, aff, M, 30, partition=partition,
                                          ling_weights=weights, **meta)
                errs[name] = max(errs.get(name, 0.0), err)
                if partition:
                    check(dead >= 32 * 15 + 8 * 30, f"starved slots missing ({dead})")
                log(f"{name} vs plain T={T} M={M} kd={kd} k=30: max_abs_err {err:.3e}, "
                    f"near-tie id swaps {nbad}, dead slots {dead}")
    return errs


def precision_variants_synthetic(torch) -> dict:
    """The split-precision variants against their twins at kd 151 with
    duplicated rows, and each one's distance from "highest" on the same
    inputs (the kernel ranks with bf16 splits, so its scores must move);
    returns {kernel name: max_abs_err}."""
    from snickery_tpu_torch.ops.cuda_topk import cuda_topk_preselect, kernel_name
    dev = torch.device("cuda")
    errs = {}
    for precision, k in (("split3cat", 48), ("split3", 40)):
        name = kernel_name(False, False, precision)
        for T, M in ((128, 8192), (2048, 65536), (300, 8192 + 37)):
            rng = np.random.default_rng(T + M)
            raw_np, aff_np = synthetic_block(rng, M, KD, True)
            raw = torch.from_numpy(raw_np).to(dev)
            aff = tuple(torch.from_numpy(a).to(dev) for a in aff_np)
            tg = torch.from_numpy(rng.standard_normal((T, KD), dtype=np.float32)).to(dev)
            err, nbad, _ = compare(tg, raw, aff, M, k, precision=precision)
            errs[name] = max(errs.get(name, 0.0), err)
            ih, vh = cuda_topk_preselect(tg, raw, k, aff, M)
            ik, vk = cuda_topk_preselect(tg, raw, k, aff, M, precision=precision)
            same = (torch.sort(ih.long(), 1)[0] == torch.sort(ik.long(), 1)[0]).all(1)
            vs = (torch.sort(vk[same], 1)[0] - torch.sort(vh[same], 1)[0]).abs()
            log(f"{name} vs plain T={T} M={M} kd={KD} k={k} dup=True: max_abs_err "
                f"{err:.3e}, near-tie id swaps {nbad}; vs highest: rows with other "
                f"ids {int((~same).sum())}, max |score diff| on the others "
                f"{float(vs.max()) if vs.numel() else 0.0:.3e}")
    for precision in ("split3cat", "split3", "highest"):
        err = split_probe_error(dev, precision)
        log(f"{precision} on the split probe (kd 8, lo * lo 2.7e-6 - 2.5e-5 of each dot): "
            f"max |score - f64 hh+hl+lh| / (2 sum |t||u|) {err:.3e} (limit {PROBE_RTOL})")
        if precision == "highest":
            check(err > PROBE_RTOL, "the split probe cannot tell full f32 from the split")
        else:
            check(err <= PROBE_RTOL, f"{precision} kernel does not form hh + hl + lh")
    return errs


# -------------------------------------------------------------- voice checks
def natural_rate(db, ids) -> float:
    return float((np.diff(db.unit_pos[ids]) == 1).mean())


def weighted(db, synth, ids):
    fw = ((db.unit_features[ids] - db.mean_target) / db.std_target) * synth._sqrt_wt
    jl = ((db.join_left[ids] - db.mean_join) / db.std_join) * synth._sqrt_wj
    jr = ((db.join_right[ids] - db.mean_join) / db.std_join) * synth._sqrt_wj
    return fw, jl, jr


def path_cost(db, synth, tw, ids, masked=None) -> float:
    """Float64 cost of a unit path in the oracle's terms; ``masked`` (T,)
    bool marks steps whose cost the identity rule raises to BIG_PENALTY."""
    from snickery_tpu_torch.const import BIG_PENALTY
    f64 = np.float64
    fw, jl, jr = weighted(db, synth, ids)
    tc = np.sqrt(((fw.astype(f64) - tw.astype(f64)) ** 2).sum(-1))
    if masked is not None:
        tc = np.where(masked, np.maximum(tc, BIG_PENALTY), tc)
    jc = np.sqrt(((jl[1:].astype(f64) - jr[:-1].astype(f64)) ** 2).sum(-1))
    return float(tc.sum() + JCW * jc.sum())


def smoke_config(**over):
    from snickery_tpu_torch.config import SnickeryConfig
    base = dict(workdir=os.path.join("build", "chip_smoke"), stream_list=list(STREAMS),
                datadims=dict(DATADIMS), sample_rate=SR, n_candidates=30,
                taper_length=50, join_cost_weight=JCW, voice_name="smoke")
    base.update(over)
    return SnickeryConfig(**base)


# --------------------------------------------------------------- main paths
class Run:
    """Shared state of one smoke run: counts, errors and times per kernel."""

    def __init__(self, torch):
        from snickery_tpu_torch.ops import cuda_topk
        self.torch, self.cuda_topk = torch, cuda_topk
        self.launches: dict[str, int] = {}
        self.errs: dict[str, float] = {}
        self.times: dict[str, tuple[float, float]] = {}
        self.bounds: dict[str, tuple[float, str]] = {}
        self.matmul: dict[str, float] = {}

    def main_path(self, label: str, kernel: str, fn):
        """Drive one main path with every count set to 0 just before and
        read just after; its kernel must have launched."""
        counts = self.cuda_topk.LAUNCH_COUNTS
        counts.clear()
        out = fn()
        got = dict(counts)
        log(f"{label}: kernel launches {got}")
        check(got.get(kernel, 0) > 0, f"{label} never launched {kernel}")
        self.launches[kernel] = self.launches.get(kernel, 0) + got[kernel]
        return out

    def kernel_at(self, kernel, synth, tgts, kwargs, T_list, report=True):
        """The kernel against its twin, and both timed, at the main path's
        shapes (with ``report``, the last of ``T_list`` is the shape whose
        times, bound and matmul yardstick the kernels line reports)."""
        from snickery_tpu_torch.ops.cuda_topk import topk_preselect_zt_plain
        from snickery_tpu_torch.ops.topk import preselect_margin
        from snickery_tpu_torch.synth import fused_masks
        torch, d = self.torch, synth.device_db
        aff = (d.mean_t, d.std_t, d.sqrt_wt)
        kd = tgts.shape[-1]
        tw = ((tgts - d.mean_t) / d.std_t * d.sqrt_wt).reshape(-1, kd).contiguous()
        m_rows = d.cut1.shape[0]
        precision = kwargs["precision"]
        k = min(kwargs["n_cand"] + preselect_margin(True, precision, zero_transient=True,
                                                    override=kwargs["margin"]), m_rows)
        masks = fused_masks(d, kwargs["tgt_codes"], kwargs["tgt_ctx"], kwargs["tgt_vids"],
                            halfphone=kwargs["halfphone"], multivoice=kwargs["multivoice"],
                            ling_weights=kwargs["ling_weights"])
        for T in T_list:
            x = tw[:T].contiguous()
            m = dict(masks, tgt_meta=masks["tgt_meta"][:T].contiguous()) if masks else {}
            err, nbad, dead = compare(x, d.raw, aff, m_rows, k, precision, **m)
            self.errs[kernel] = max(self.errs.get(kernel, 0.0), err)
            ms = time_ms(torch, lambda: self.cuda_topk.cuda_topk_preselect(
                x, d.raw, k, aff, m_rows, precision=precision, **m), 3)
            plain_ms = time_ms(torch, lambda: topk_preselect_zt_plain(
                x, d.raw, k, aff, m_rows, precision=precision, **m), 1)
            b_ms, b_by = bound_ms(T, m_rows, kd, k, precision, bool(masks))
            msg = ""
            if report:
                self.times[kernel] = (ms, plain_ms)
                self.bounds[kernel] = (b_ms, b_by)
                self.matmul[kernel] = matmul_ms(torch, x, d.raw[:m_rows, :kd], precision)
                msg = f", torch.matmul of the product alone {self.matmul[kernel]:.2f} ms"
            log(f"{kernel} T={T} M={m_rows} kd={kd} k={k}: kernel {ms:.2f} ms, plain "
                f"{plain_ms:.2f} ms, bound {b_ms:.3f} ms ({b_by}){msg}, max_abs_err "
                f"{err:.3e}, near-tie id swaps {nbad}, dead slots {dead}")


def timed_batch(torch, synth, reps: int, *args, **kw):
    synth.synth_batch(*args, **kw)                              # warm-up
    walls = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = synth.synth_batch(*args, **kw)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    audio_s = sum(len(r["wave"]) for r in out) / SR
    log(f"{1e3 * float(np.mean(walls)):.1f} ms/step (steps "
        f"{[round(1e3 * w, 1) for w in walls]}), {audio_s:.1f} s audio/step, "
        f"RTF {np.mean(walls) / audio_s:.6f}")
    return out


def stage_split(label, synth, tgts, lengths, kwargs):
    from snickery_tpu_torch import utils
    from snickery_tpu_torch.synth import synth_pipeline_step
    with Phase(f"{label} per-stage split (synchronised stage edges)"):
        timer = utils.StageTimer()
        synth_pipeline_step(synth.device_db, tgts, lengths, stage_timer=timer, **kwargs)
        log("stages ms: " + json.dumps({k: round(1e3 * v, 1) for k, v in timer.report().items()}))


def check_result(db, res):
    ids = res["unit_ids"]
    check(len(ids) == res["n_units"], "one id per unit")
    check(bool(((ids >= 0) & (ids < db.n_units)).all()), "ids in range")
    check(np.isfinite(res["total_cost"]), "finite cost")
    check(len(res["wave"]) > 0 and bool(np.isfinite(res["wave"]).all()), "finite audio")


def config3(run: Run):
    torch = run.torch
    from snickery_tpu_torch.voicedb.build import build_voicedb
    from snickery_tpu_torch import Synthesiser

    cfg = smoke_config(length_buckets=[T_BUCKET])
    with Phase("config-3 voice (numpy)"):
        utts = make_utterances(np.random.default_rng(2026), N_UTTS,
                               351 + np.arange(N_UTTS) % 2, "utt")
        natural = utts[0].features
        db = build_voicedb(cfg, utts)
        del utts
        held = make_utterances(np.random.default_rng(7), 32, T_BUCKET + 2, "held")
        short = make_utterances(np.random.default_rng(8), 1, 258, "short")[0]
        log(f"{db.n_units} units, d={db.target_dim}, {len(db.filenames)} utts, "
            f"{len(db.waves) / SR:.0f} s of audio")
    with Phase("config-3 Synthesiser(device='cuda')"):
        synth = Synthesiser(cfg, db=db, device="cuda")
        torch.cuda.synchronize()
        log(f"{synth.n_units_padded} padded units, resident DB "
            f"{synth.device_db.nbytes / 2**20:.1f} MiB "
            f"(raw block {synth.device_db.raw.nbytes / 2**20:.1f} MiB)")

    def drive():
        with Phase("config-3 main path: synth_from_features x 3"):
            for name, feats in (("corpus utt 0", natural), ("held-out 2048", held[0].features),
                                ("held-out 256", short.features)):
                t0 = time.perf_counter()
                res = synth.synth_from_features(feats)
                check_result(db, res)
                msg = (f"{name}: {res['n_units']} units, cost {res['total_cost']:.4f}, "
                       f"{len(res['wave'])} samples, {1e3 * (time.perf_counter() - t0):.1f} ms")
                if name.startswith("corpus"):
                    rate = natural_rate(db, res["unit_ids"])
                    own = float((db.utt_index[res["unit_ids"]] == 0).mean())
                    msg += f", natural continuation {rate:.4f}, own-utterance {own:.4f}"
                    check(rate >= 0.85, f"natural continuation {rate} < 0.85")
                log(msg)
        for B in (8, 32):
            with Phase(f"config-3 main path: synth_batch B={B} x T={T_BUCKET}"):
                out = timed_batch(torch, synth, 2, [u.features for u in held[:B]])
                for res in out:
                    check_result(db, res)
        return out

    out32 = run.main_path("config 3", "topk_preselect_zt", drive)
    prepped = [synth.targets_from_features(u.features) for u in held[:32]]
    tgts, lengths, kwargs = synth.batch_inputs(prepped)
    stage_split("config-3 B=32", synth, tgts, lengths, kwargs)
    with Phase("config-3 kernel vs plain at main-path shapes"):
        run.kernel_at("topk_preselect_zt", synth, tgts, kwargs, (T_BUCKET, 32 * T_BUCKET))
    with Phase("config-3 held-out utterance vs float64 oracle (full DB)"):
        agree, _ = oracle_check(db, synth, short.features, "highest")
        check(agree >= 0.99, f"oracle agreement {agree} < 0.99")
    return db, held, short, out32


def oracle_check(db, synth, feats, label):
    """A held-out utterance through ``synth`` against the float64 oracle over
    the full DB; returns (raw agreement, relative f64 path-cost gap)."""
    from snickery_tpu_torch import oracle
    res = synth.synth_from_features(feats)
    tgt, n = synth.targets_from_features(feats)
    tw_o = (((tgt - db.mean_target) / db.std_target) * synth._sqrt_wt).astype(np.float32)
    feats_w = db.normalised_features().astype(np.float32) * synth._sqrt_wt[None, :]
    jl, jr = db.normalised_joins()
    ids_ref, _ = oracle.synth_pipeline(
        tw_o, feats_w, (jl * synth._sqrt_wj).astype(np.float32),
        (jr * synth._sqrt_wj).astype(np.float32), n_candidates=synth.cfg.n_candidates,
        join_cost_weight=JCW, fast_preselect=True)
    agree = float((res["unit_ids"] == ids_ref).mean())
    c_dev, c_ref = path_cost(db, synth, tw_o, res["unit_ids"]), path_cost(db, synth, tw_o, ids_ref)
    gap = (c_dev - c_ref) / abs(c_ref)
    log(f"{label}: {n} held-out units, raw agreement {agree:.5f}, f64 path cost "
        f"{c_dev:.6f} vs oracle {c_ref:.6f} (gap {gap:+.3e})")
    return agree, gap


def tie_adjusted_agreement(db, ids_a, ids_b):
    """(raw, tie-adjusted) agreement of two flat unit-id arrays, as
    ``bench.py`` computes it: a differing pair counts as agreeing when the
    two units' target features and join contexts are bit-identical."""
    m = ids_a != ids_b
    uids = np.unique(np.concatenate([ids_a[m], ids_b[m]]))
    fw, jl, jr = (np.asarray(a[uids]) for a in (db.unit_features, db.join_left,
                                                 db.join_right))
    pa, pb = np.searchsorted(uids, ids_a[m]), np.searchsorted(uids, ids_b[m])
    eq = (fw[pa] == fw[pb]).all(-1) & (jl[pa] == jl[pb]).all(-1) & (jr[pa] == jr[pb]).all(-1)
    return float((~m).mean()), float(((~m).sum() + eq.sum()) / ids_a.size)


def config3_split3cat(run: Run, db, held, short, out_highest):
    """Config 3 at the JAX bench's speed precision, then config 4 streaming
    on the same Synthesiser."""
    torch = run.torch
    from snickery_tpu_torch import Synthesiser

    cfg = smoke_config(length_buckets=[64, T_BUCKET], preselect_precision="split3cat")
    with Phase("config-3 split3cat Synthesiser(device='cuda')"):
        synth = Synthesiser(cfg, db=db, device="cuda")
        torch.cuda.synchronize()
    feats = [u.features for u in held[:32]]

    def drive():
        with Phase(f"config-3 split3cat main path: synth_batch B=32 x T={T_BUCKET}"):
            out = timed_batch(torch, synth, 2, feats)
            for res in out:
                check_result(db, res)
        return out

    out = run.main_path("config 3 split3cat", "topk_preselect_zt_split3cat", drive)
    ids_s = np.concatenate([r["unit_ids"] for r in out])
    ids_h = np.concatenate([r["unit_ids"] for r in out_highest])
    raw, adj = tie_adjusted_agreement(db, ids_s, ids_h)
    log(f"split3cat vs highest over {len(ids_s)} units: raw {raw:.5f}, tie-adjusted {adj:.5f}")
    check(adj >= 0.999, f"split3cat-vs-highest tie-adjusted agreement {adj} < 0.999")
    tgts, lengths, kwargs = synth.batch_inputs([synth.targets_from_features(f) for f in feats])
    stage_split("config-3 split3cat B=32", synth, tgts, lengths, kwargs)
    with Phase("config-3 split3cat kernel vs plain at main-path shapes"):
        run.kernel_at("topk_preselect_zt_split3cat", synth, tgts, kwargs,
                      (T_BUCKET, 32 * T_BUCKET))
    with Phase("config-3 split3cat held-out utterance vs float64 oracle (full DB)"):
        agree, gap = oracle_check(db, synth, short.features, "split3cat")
        check(agree >= 0.99, f"split3cat oracle agreement {agree} < 0.99")
        check(gap <= 1e-4, f"split3cat f64 path-cost gap {gap} > 1e-4")
    ids = run.main_path("config 4", "topk_preselect_zt_split3cat",
                        lambda: config4(db, synth, held[0]))
    config4_checks(run, synth, held[0], ids)


def drive_stream(synth, chunks, **kw):
    """One streaming pass: (per-chunk ms to each yielded piece, wall s,
    the pieces), as ``bench.py::_drive_stream`` times it."""
    times, pieces = [], []
    t_all = time.perf_counter()
    gen = synth.synth_streaming(iter(chunks), **kw)
    while True:
        t0 = time.perf_counter()
        try:
            piece = next(gen)
        except StopIteration:
            break
        times.append(1e3 * (time.perf_counter() - t0))
        pieces.append(piece)
    return np.asarray(times), time.perf_counter() - t_all, pieces


def config4(db, synth, utt):
    """Streaming on the config-3 voice at split3cat: fixed-rate 5 ms frames
    and epoch-rate units, chunks of STREAM_CHUNK, bucket 64; returns the
    epoch-rate stream's unit ids."""
    from snickery_tpu_torch.features.world import resample_to_fixed

    fs, taper = 0.005, synth.cfg.taper_length
    fixed = resample_to_fixed(utt.features, utt.epochs, SR, fs)
    feats = utt.features[1:-1]
    def chunked(x):
        return [x[i:i + STREAM_CHUNK] for i in range(0, len(x), STREAM_CHUNK)]

    inputs = {"fixed-rate": (chunked(fixed), dict(fixed_frameshift=fs)),
              "epoch-rate": (chunked(feats), {})}
    for label, (chunks, kw) in inputs.items():
        with Phase(f"config-4 main path: synth_streaming, {label}, {len(chunks)} chunks"):
            list(synth.synth_streaming(iter(chunks[:3]), **kw))               # warm-up
            per, wall, pieces = drive_stream(synth, chunks, **kw)
            audio = np.concatenate(pieces)
            ids = np.concatenate(synth.last_stream_unit_ids)
            spans = (db.cutpoints[ids, 2] - db.cutpoints[ids, 1]).astype(np.int64)
            inner = per[1:-1]
            log(f"{label}: {len(ids)} units, {len(audio) / SR:.2f} s audio, chunk latency "
                f"p50 {np.percentile(inner, 50):.2f} ms, p95 {np.percentile(inner, 95):.2f} ms "
                f"(first {per[0]:.2f}, last {per[-1]:.2f}), RTF {wall / (len(audio) / SR):.6f}")
            log("host stage means ms: " + json.dumps({
                k: round(float(np.mean(v)), 3) for k, v in synth.last_stream_stages.items()}))
            log("host stages ms: " + json.dumps({
                k: [round(x, 2) for x in v] for k, v in synth.last_stream_stages.items()}))
            check(bool(np.isfinite(audio).all()), f"{label}: non-finite audio")
            check(len(audio) == 2 * taper + int(spans.sum()),
                  f"{label}: {len(audio)} samples, expected {2 * taper + int(spans.sum())}")
    return ids


def config4_checks(run: Run, synth, utt, ids):
    """After the config-4 main path: the epoch-rate stream's ids against
    one-shot greedy, one chunk's device stage split, and the kernel against
    its twin on the last chunk's targets (the streaming shape, T = 64)."""
    from snickery_tpu_torch import utils
    from snickery_tpu_torch.synth import streaming_step

    with Phase("config-4 streamed vs synth_from_features(greedy=True)"):
        ref = synth.synth_from_features(utt.features, greedy=True)["unit_ids"]
        agree = float((ids == ref).mean()) if len(ids) == len(ref) else 0.0
        log(f"epoch-rate streamed ids vs one-shot greedy: {len(ids)} vs {len(ref)} units, "
            f"agreement {agree:.5f}")
        check(agree >= 0.99, f"streamed-vs-greedy agreement {agree} < 0.99")
    with Phase("config-4 one chunk's device stage split (synchronised stage edges)"):
        args, kwargs = synth._last_stream_step
        timer = utils.StageTimer()
        out = streaming_step(*args, stage_timer=timer, **kwargs)
        t0 = time.perf_counter()
        _, event = synth._to_host((out[0], out[2], out[3]))
        event.synchronize()
        split = {k: round(1e3 * v, 3) for k, v in timer.report().items()}
        split["fetch"] = round(1e3 * (time.perf_counter() - t0), 3)
        log(f"chunk of {args[2]} units (bucket {args[1].shape[0]}), stages ms: "
            + json.dumps(split))
    with Phase("config-4 kernel vs plain at the streaming shape"):
        kw = dict(kwargs, tgt_codes=None, tgt_ctx=None, tgt_vids=None, halfphone=False,
                  ling_weights=None)
        run.kernel_at("topk_preselect_zt_split3cat", synth, args[1], kw,
                      (args[1].shape[0],), report=False)


def host_free_gib() -> float:
    with open("/proc/meminfo") as f:
        info = dict(line.split(":", 1) for line in f)
    return int(info["MemAvailable"].split()[0]) / 2**20


def capacity(run: Run, db, held):
    """The config-3 voice tiled x CAP_TILE on one card at split3, int16
    waves, audio on the host; gated by split3-vs-highest agreement on the
    same resident block (replicas are bit-identical, so raw agreement is
    printed only)."""
    torch = run.torch
    from snickery_tpu_torch import Synthesiser
    from snickery_tpu_torch.synth import synth_pipeline_step

    cfg = smoke_config(length_buckets=[T_BUCKET], preselect_precision="split3",
                       waves_dtype="int16", preload_all_waves=False,
                       voice_name="smokecap")
    with Phase(f"capacity voice: config 3 tiled x{CAP_TILE}"):
        log(f"host memory available before tiling: {host_free_gib():.1f} GiB")
        big = db.tiled(CAP_TILE)
        log(f"{big.n_units} units; host memory available {host_free_gib():.1f} GiB")
    with Phase("capacity Synthesiser(device='cuda')"):
        torch.cuda.reset_peak_memory_stats()
        synth = Synthesiser(cfg, db=big, device="cuda")
        torch.cuda.synchronize()
        log(f"{synth.n_units_padded} padded units, raw block "
            f"{synth.device_db.raw.nbytes / 1e9:.2f} GB, resident DB "
            f"{synth.device_db.nbytes / 2**30:.2f} GiB, waves on the device "
            f"{synth.device_db.waves.numel()} samples (placeholder)")
    feats = [u.features for u in held[:8]]

    def drive():
        with Phase(f"capacity main path: synth_batch B=8 x T={T_BUCKET}"):
            out = timed_batch(torch, synth, 2, feats)
            for res in out:
                check_result(big, res)
            log(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
                f"(torch.cuda.max_memory_allocated)")
        return out

    out = run.main_path("capacity", "topk_preselect_zt_split3", drive)
    tgts, lengths, kwargs = synth.batch_inputs([synth.targets_from_features(f) for f in feats])
    stage_split("capacity B=8", synth, tgts, lengths, kwargs)
    t0 = time.perf_counter()
    for res in out:
        synth._host_ola(res["unit_ids"])
    log(f"host OLA of the {len(out)} utterances: {1e3 * (time.perf_counter() - t0):.1f} ms")
    with Phase("capacity kernel vs plain at main-path shape"):
        run.kernel_at("topk_preselect_zt_split3", synth, tgts, kwargs, (T_BUCKET,))
    with Phase("capacity: the same targets at highest on the same block"):
        ids_h, *_ = synth_pipeline_step(synth.device_db, tgts, lengths,
                                        **dict(kwargs, precision="highest"))
        ids_h = ids_h.cpu().numpy()
        ids_s = np.concatenate([r["unit_ids"] for r in out])
        ids_h = np.concatenate([ids_h[b, :len(r["unit_ids"])] for b, r in enumerate(out)])
        raw, adj = tie_adjusted_agreement(big, ids_s, ids_h)
        log(f"split3 vs highest over {len(ids_s)} units: raw {raw:.5f} (replicas are "
            f"bit-identical: not gated), tie-adjusted {adj:.5f}")
        check(adj >= 0.999, f"split3-vs-highest tie-adjusted agreement {adj} < 0.999")


def identity_match(synth, db, results, segs_list) -> float:
    return float(np.mean([
        (db.unit_code[r["unit_ids"]] == [synth._unit_vocab.get(s.name, -2) for s in segs]).mean()
        for r, segs in zip(results, segs_list)]))


def config2(run: Run):
    torch = run.torch
    from snickery_tpu_torch.voicedb.build import build_voicedb
    from snickery_tpu_torch import Synthesiser

    cfg = smoke_config(target_representation="halfphone", n_candidates=20,
                       length_buckets=[128], voice_name="smokehp")
    means = phone_means(31)
    with Phase("config-2 halfphone voice (numpy)"):
        utts = make_halfphone_utterances(np.random.default_rng(32), HP_UTTS, 40, "hp", means)
        corpus = utts[0]
        db = build_voicedb(cfg, utts)
        del utts
        held = make_halfphone_utterances(np.random.default_rng(33), 4, 40, "held", means)
        log(f"{db.n_units} halfphone units, kd={db.target_dim}, {len(db.unit_names)} "
            f"halfphone names, {len(db.phone_names)} phones, {len(db.filenames)} utts")
    with Phase("config-2 Synthesiser(device='cuda')"):
        synth = Synthesiser(cfg, db=db, device="cuda")
        torch.cuda.synchronize()
        log(f"{synth.n_units_padded} padded units, resident DB "
            f"{synth.device_db.nbytes / 2**20:.1f} MiB, kernel metadata "
            f"{synth.device_db.meta.nbytes / 2**20:.2f} MiB")
    targets = [synth.halfphone_targets_from_features(u.features, u.epochs, u.halfphones)
               for u in (corpus, *held)]
    feats, segs = [t for t, _ in targets[1:]], [s for _, s in targets[1:]]

    def drive():
        with Phase("config-2 main path: synth_from_features x 2, synth_batch B=4"):
            res = synth.synth_from_features(targets[0][0], target_segments=targets[0][1])
            check_result(db, res)
            rate = natural_rate(db, res["unit_ids"])
            match = identity_match(synth, db, [res], [targets[0][1]])
            log(f"corpus utt: {res['n_units']} units, cost {res['total_cost']:.4f}, "
                f"identity match {match:.4f}, natural continuation {rate:.4f}")
            check(match >= 0.95 and rate >= 0.85, "corpus utterance not reproduced")
            res = synth.synth_from_features(feats[0], target_segments=segs[0])
            check_result(db, res)
            out = timed_batch(torch, synth, 3, feats, segments_list=segs)
            for r in out:
                check_result(db, r)
            match = identity_match(synth, db, out, segs)
            log(f"B=4 halfphone identity match {match:.4f}")
            check(match >= 0.95, f"halfphone identity match {match} < 0.95")
            return out

    out = run.main_path("config 2", "topk_preselect_zt_ling", drive)
    prepped = [(f, len(f)) for f in feats]
    tgts, lengths, kwargs = synth.batch_inputs(prepped, segs, [0] * len(feats))
    stage_split("config-2 B=4", synth, tgts, lengths, kwargs)
    with Phase("config-2 kernel vs plain at main-path shapes"):
        run.kernel_at("topk_preselect_zt_ling", synth, tgts, kwargs, (128, tgts.shape[0] * 128))
    with Phase("config-2 held-out utterance vs float64 oracle (full DB)"):
        halfphone_oracle_gap(db, synth, *targets[1], out[0]["unit_ids"], "highest")
    return db, feats, segs, out


def halfphone_oracle_gap(db, synth, tgt, kept, ids, label) -> float:
    """A halfphone utterance's ids against the float64 oracle with the same
    penalties over the full DB: the relative f64 path-cost gap, gated at
    1e-4."""
    from snickery_tpu_torch import oracle
    from snickery_tpu_torch.const import ID_RANK_PENALTY
    codes = np.asarray([synth._unit_vocab.get(s.name, -1) for s in kept])
    ctx = np.asarray([[synth._phone_vocab.get(p, 0) for p in s.quinphone] for s in kept])
    *ctx_w, scale = synth._ling_weights()
    id_pen = (codes[:, None] != db.unit_code[None, :]) * float(ID_RANK_PENALTY)
    pen = id_pen.copy()
    for c, w in enumerate(ctx_w):
        if w:
            pen = pen + (ctx[:, c:c + 1] != db.context_codes[None, :, c]) * (w * scale)
    tw_o = (((tgt - db.mean_target) / db.std_target) * synth._sqrt_wt).astype(np.float32)
    feats_w = db.normalised_features().astype(np.float32) * synth._sqrt_wt[None, :]
    jl, jr = db.normalised_joins()
    ids_ref, _ = oracle.synth_pipeline(
        tw_o, feats_w, (jl * synth._sqrt_wj).astype(np.float32),
        (jr * synth._sqrt_wj).astype(np.float32), n_candidates=synth.cfg.n_candidates,
        join_cost_weight=JCW, extra=pen, lattice_penalty=id_pen, fast_preselect=True)
    has = (codes[:, None] == db.unit_code[None, :]).any(1)
    agree = float((ids == ids_ref).mean())
    c_dev = path_cost(db, synth, tw_o, ids, has & (db.unit_code[ids] != codes))
    c_ref = path_cost(db, synth, tw_o, ids_ref, has & (db.unit_code[ids_ref] != codes))
    gap = (c_dev - c_ref) / abs(c_ref)
    log(f"{label}: {len(ids)} held-out halfphone units, raw agreement {agree:.5f} (the "
        f"JAX package's TPU figure: {JAX_TPU_CONFIG2_AGREEMENT}), f64 path cost "
        f"{c_dev:.6f} vs oracle {c_ref:.6f} (gap {gap:+.3e})")
    check(gap <= 1e-4, f"{label}: f64 path-cost gap {gap} > 1e-4")
    return gap


def config5(run: Run):
    torch = run.torch
    from snickery_tpu_torch.voicedb.build import build_voicedb
    from snickery_tpu_torch.voicedb.multivoice import merge_voicedbs
    from snickery_tpu_torch import Synthesiser

    cfg = smoke_config(length_buckets=[256], voice_name="smokemv")
    n_voices, B = 8, 64
    with Phase("config-5 eight voices, merged (numpy)"):
        dbs, natural = [], None
        for v in range(n_voices):
            rng = np.random.default_rng(500 + v)
            utts = make_utterances(rng, len(MV_EPOCHS), MV_EPOCHS, f"v{v}_")
            shift = rng.standard_normal(KD).astype(np.float32)
            shift[-1] = 0.0
            for u in utts:
                u.features += shift
            if v == 3:
                natural = utts[5].features
            dbs.append(build_voicedb(cfg, utts))
        db = merge_voicedbs(dbs, names=[f"v{v}" for v in range(n_voices)])
        del dbs
        held = make_utterances(np.random.default_rng(77), 16, 258, "held")
        log(f"{db.n_units} units in {n_voices} voices "
            f"({np.bincount(db.voice_ids).tolist()}), d={db.target_dim}")
    with Phase("config-5 Synthesiser(device='cuda')"):
        synth = Synthesiser(cfg, db=db, device="cuda")
        torch.cuda.synchronize()
        log(f"{synth.n_units_padded} padded units, resident DB "
            f"{synth.device_db.nbytes / 2**20:.1f} MiB, kernel metadata "
            f"{synth.device_db.meta.nbytes / 2**20:.2f} MiB")
    feats = [held[i % len(held)].features for i in range(B)]
    voices = [f"v{i % n_voices}" for i in range(B)]

    def drive():
        with Phase(f"config-5 main path: synth_batch B={B} x T=256, mixed voices"):
            out = timed_batch(torch, synth, 3, feats, voices=voices)
            leaks = sum(int((db.voice_ids[r["unit_ids"]] != i % n_voices).sum())
                        for i, r in enumerate(out))
            for r in out:
                check_result(db, r)
            res = synth.synth_from_features(natural, voice="v3")
            rate = natural_rate(db, res["unit_ids"])
            leaks += int((db.voice_ids[res["unit_ids"]] != 3).sum())
            log(f"cross-voice leaks {leaks}; corpus utterance of v3 sent to v3: "
                f"natural continuation {rate:.4f}, cost {res['total_cost']:.4f}")
            check(leaks == 0, f"{leaks} units leaked across voices")
            check(rate >= 0.85, f"natural continuation {rate} < 0.85")
            return out

    out = run.main_path("config 5", "topk_preselect_zt_part", drive)
    prepped = [synth.targets_from_features(f) for f in feats]
    tgts, lengths, kwargs = synth.batch_inputs(prepped, None,
                                               [synth._voice_code(v) for v in voices])
    stage_split(f"config-5 B={B}", synth, tgts, lengths, kwargs)
    with Phase("config-5 kernel vs plain at main-path shapes"):
        run.kernel_at("topk_preselect_zt_part", synth, tgts, kwargs, (256, B * 256))
    return db, feats, voices, out, held


def composition(run: Run, n_utts: int):
    """Two merged halfphone voices of ``n_utts`` utterances each: a small
    pair for the gates, then a pair at config-2 scale (625 utterances,
    50,000 units a voice), whose kernel time is the one reported."""
    torch = run.torch
    from snickery_tpu_torch.voicedb.build import build_voicedb
    from snickery_tpu_torch.voicedb.multivoice import merge_voicedbs
    from snickery_tpu_torch import Synthesiser

    cfg = smoke_config(target_representation="halfphone", n_candidates=20,
                       length_buckets=[128], voice_name="smokehpmv")
    label = f"composition {n_utts} utts a voice"
    with Phase(f"{label}: two halfphone voices, merged (numpy)"):
        dbs, held = [], []
        for v in range(2):
            means = phone_means(40 + v)
            rng = np.random.default_rng(60 + v)
            dbs.append(build_voicedb(cfg, make_halfphone_utterances(rng, n_utts, 40, f"c{v}_", means)))
            held += make_halfphone_utterances(rng, 2, 40, f"ch{v}_", means)
        db = merge_voicedbs(dbs, names=["alice", "bob"])
        log(f"{db.n_units} halfphone units in 2 voices ({np.bincount(db.voice_ids).tolist()})")
    synth = Synthesiser(cfg, db=db, device="cuda")
    targets = [synth.halfphone_targets_from_features(u.features, u.epochs, u.halfphones)
               for u in held]
    feats, segs = [t for t, _ in targets], [s for _, s in targets]
    voices = ["alice", "alice", "bob", "bob"]

    def drive():
        with Phase(f"{label} main path: synth_batch B=4, mixed voices"):
            out = timed_batch(torch, synth, 3, feats, voices=voices, segments_list=segs)
            leaks = sum(int((db.voice_ids[r["unit_ids"]] != synth._voice_code(v)).sum())
                        for r, v in zip(out, voices))
            match = identity_match(synth, db, out, segs)
            log(f"cross-voice leaks {leaks}, halfphone identity match {match:.4f}")
            check(leaks == 0, f"{leaks} units leaked across voices")
            check(match >= 0.9, f"identity match {match} < 0.9")
            return out

    out = run.main_path(label, "topk_preselect_zt_ling_part", drive)
    tgts, _, kwargs = synth.batch_inputs([(f, len(f)) for f in feats], segs,
                                         [synth._voice_code(v) for v in voices])
    with Phase(f"{label} kernel vs plain at main-path shape"):
        run.kernel_at("topk_preselect_zt_ling_part", synth, tgts, kwargs, (4 * 128,))
    return db, feats, segs, voices, out


# ------------------------------------------------------------------ serving
def start_server(synth, **kw):
    """The port's HTTP server on 127.0.0.1 at an ephemeral port, warmed as
    ``serve`` warms it; returns (server, base url, thread)."""
    from snickery_tpu_torch.server import SynthHTTPServer, warm_up
    warm_up(synth)
    httpd = SynthHTTPServer(synth, host="127.0.0.1", port=0, **kw)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    return httpd, f"http://127.0.0.1:{httpd.server_address[1]}", thread


def stop_server(httpd, thread) -> None:
    httpd.shutdown()
    httpd.server_close()
    thread.join(timeout=30)


def http(url: str, payload: dict | None = None):
    """(status, body bytes) of a GET (no payload) or a JSON POST."""
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(url, data=data, headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=600) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()
    except OSError as e:                  # no response at all: status 0
        return 0, repr(e).encode()


def post_all(url: str, payloads: list):
    """POST every payload at once from its own thread; (responses in payload
    order, wall seconds)."""
    out = [None] * len(payloads)

    def one(i):
        out[i] = http(url, payloads[i])

    threads = [threading.Thread(target=one, args=(i,)) for i in range(len(payloads))]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return out, time.perf_counter() - t0


def synth_payload(feats, voice=None, segs=None) -> dict:
    payload = {"features_b64": base64.b64encode(
        np.ascontiguousarray(feats, np.float32).tobytes()).decode()}
    if voice is not None:
        payload["voice"] = voice
    if segs is not None:
        payload["segments"] = [{"name": s.name, "quinphone": list(s.quinphone)} for s in segs]
    return payload


def served_ids(label, responses, db, synth, voices) -> list:
    """Every response 200 with finite audio; returns the unit ids, after
    checking that none comes from another voice (merged DBs)."""
    ids = []
    for i, (status, body) in enumerate(responses):
        check(status == 200, f"{label}: request {i} answered {status}: {body[:200]!r}")
        res = json.loads(body)
        wave = np.frombuffer(base64.b64decode(res["wave_b64"]), np.float32)
        check(len(wave) == res["n_samples"] > 0 and bool(np.isfinite(wave).all()),
              f"{label}: request {i} audio")
        ids.append(np.asarray(res["unit_ids"], np.int64))
    if voices is not None:
        leaks = sum(int((db.voice_ids[u] != synth._voice_code(v)).sum())
                    for u, v in zip(ids, voices))
        log(f"{label}: cross-voice leaks {leaks}")
        check(leaks == 0, f"{label}: {leaks} units leaked across voices")
    return ids


def log_stats(label, base, httpd, n_requests, wall):
    status, body = http(base + "/stats")
    check(status == 200, f"{label}: /stats answered {status}")
    stats = json.loads(body)
    sizes = httpd.batcher.batch_sizes
    steps = sum(sizes.values())
    share = {str(b): round(n / steps, 4) for b, n in sorted(sizes.items())}
    log(f"{label}: /stats {json.dumps(stats)}; {n_requests / wall:.2f} requests/s over "
        f"{wall:.3f} s; share of steps per batch size {share}")
    return stats


def same_as_direct(label, ids, direct_ids) -> None:
    bad = [i for i, (a, b) in enumerate(zip(ids, direct_ids)) if not np.array_equal(a, b)]
    log(f"{label}: {len(ids) - len(bad)} of {len(ids)} responses equal direct calls")
    check(not bad, f"{label}: responses {bad[:8]} differ from direct calls")


def server_config5(run: Run, db, feats, voices, out_highest, held):
    """Config 5 served at split3cat: 64 concurrent POST /synth of 256 units
    round-robin over the 8 voices, then one POST /stream."""
    torch = run.torch
    from snickery_tpu_torch import Synthesiser

    cfg = smoke_config(length_buckets=[64, 256], voice_name="smokemv",
                       preselect_precision="split3cat")
    with Phase("server config 5: Synthesiser(split3cat) and warm-up"):
        synth = Synthesiser(cfg, db=db, device="cuda")
        httpd, base, thread = start_server(synth, max_batch=32, max_wait_ms=20.0)
        torch.cuda.synchronize()
    payloads = [synth_payload(f, v) for f, v in zip(feats, voices)]
    stream_feats = held[3].features
    stream_payload = dict(synth_payload(stream_feats, "v2"), chunk_frames=STREAM_CHUNK)

    def drive():
        with Phase(f"server config-5 main path: {len(payloads)} concurrent POST /synth, "
                   "then POST /stream"):
            responses, wall = post_all(base + "/synth", payloads)
            stream = http(base + "/stream", stream_payload)
        return responses, wall, stream

    try:
        responses, wall, (st_status, st_body) = run.main_path(
            "server config 5", "topk_preselect_zt_split3cat_part", drive)
        # the /stream handler ran synth_streaming on this Synthesiser
        st_ids = np.concatenate(synth.last_stream_unit_ids)
        stats = log_stats("server config 5", base, httpd, len(payloads), wall)
    finally:
        stop_server(httpd, thread)
    ids = served_ids("server config 5", responses, db, synth, voices)
    check(stats["batches"] < stats["requests"] and stats["max_batch_seen"] > 1,
          f"server config 5: requests were not batched ({stats})")
    with Phase("server config 5: responses vs direct calls and vs highest"):
        direct = [synth.synth_from_features(f, voice=v)["unit_ids"]
                  for f, v in zip(feats, voices)]
        same_as_direct("server config 5", ids, direct)
        raw, adj = tie_adjusted_agreement(db, np.concatenate(ids), np.concatenate(
            [r["unit_ids"] for r in out_highest]))
        log(f"served split3cat vs the highest batch: raw {raw:.5f}, tie-adjusted {adj:.5f}")
        check(adj >= 0.999, f"served split3cat tie-adjusted agreement {adj} < 0.999")
    with Phase("server config 5: POST /stream vs synth_streaming"):
        check(st_status == 200, f"/stream answered {st_status}")
        chunks = [stream_feats[i:i + STREAM_CHUNK]
                  for i in range(0, len(stream_feats), STREAM_CHUNK)]
        ref = np.concatenate(list(synth.synth_streaming(iter(chunks), voice="v2")))
        s_ids = np.concatenate(synth.last_stream_unit_ids)
        spans = (db.cutpoints[s_ids, 2] - db.cutpoints[s_ids, 1]).astype(np.int64)
        audio = np.frombuffer(st_body, np.float32)
        same = len(audio) == len(ref)
        err = float(np.abs(audio - ref).max()) if same else float("inf")
        log(f"/stream: {len(st_body)} bytes, {len(audio)} samples; direct synth_streaming "
            f"{len(ref)} samples; expected {2 * cfg.taper_length + int(spans.sum())}; "
            f"ids equal {np.array_equal(st_ids, s_ids)}; bytes equal "
            f"{st_body == ref.tobytes()}; max |streamed - direct| {err:.3e} (the OLA's "
            "atomic adds sum overlaps in no fixed order)")
        check(np.array_equal(st_ids, s_ids), "/stream unit ids differ from direct")
        check(same and err <= 1e-5, f"/stream audio differs from direct by {err}")
        check(len(audio) == 2 * cfg.taper_length + int(spans.sum()), "/stream sample total")
        check(bool((db.voice_ids[s_ids] == 2).all()), "/stream leaked across voices")
    B = stats["max_batch_seen"]
    tgts, _, kwargs = synth.batch_inputs([synth.targets_from_features(f) for f in feats[:B]],
                                         None, [synth._voice_code(v) for v in voices[:B]])
    with Phase("server config 5: kernel vs plain at the served shapes"):
        run.kernel_at("topk_preselect_zt_split3cat_part", synth, tgts, kwargs, (B * 256,))
        args, kw = synth._last_stream_step
        T = args[1].shape[0]
        kw = dict(kw, tgt_codes=torch.zeros((1, T), dtype=torch.int32, device=synth.device),
                  tgt_ctx=torch.zeros((1, T, 5), dtype=torch.int32, device=synth.device),
                  tgt_vids=torch.full((1, T), 2, dtype=torch.int32, device=synth.device),
                  halfphone=False, ling_weights=None)
        run.kernel_at("topk_preselect_zt_split3cat_part", synth, args[1], kw,
                      (args[1].shape[0],), report=False)
    return synth


def server_halfphone(run: Run, label, kernel, db, feats, segs, voices, oracle_gate):
    """A halfphone voice (or two merged) served at split3cat: concurrent
    POST /synth with segments (and voices), gated by the halfphone identity,
    equality with direct calls and (``oracle_gate``) the float64 oracle;
    POST /stream must answer 400."""
    torch = run.torch
    from snickery_tpu_torch import Synthesiser

    cfg = smoke_config(target_representation="halfphone", n_candidates=20,
                       length_buckets=[128], voice_name="smokehp",
                       preselect_precision="split3cat")
    with Phase(f"{label}: Synthesiser(split3cat) and warm-up"):
        synth = Synthesiser(cfg, db=db, device="cuda")
        httpd, base, thread = start_server(synth, max_batch=32, max_wait_ms=20.0)
        torch.cuda.synchronize()
    vs = voices or [None] * len(feats)
    payloads = [synth_payload(f, v, s) for f, v, s in zip(feats, vs, segs)]

    def drive():
        with Phase(f"{label} main path: {len(payloads)} concurrent POST /synth"):
            return post_all(base + "/synth", payloads)

    try:
        responses, wall = run.main_path(label, kernel, drive)
        log_stats(label, base, httpd, len(payloads), wall)
        st_status, _ = http(base + "/stream", synth_payload(feats[0]))
    finally:
        stop_server(httpd, thread)
    check(st_status == 400, f"{label}: /stream answered {st_status}, expected 400")
    ids = served_ids(label, responses, db, synth, voices)
    results = [{"unit_ids": u} for u in ids]
    match = identity_match(synth, db, results, segs)
    log(f"{label}: halfphone identity match {match:.4f}")
    check(match >= (0.95 if oracle_gate else 0.9), f"{label}: identity match {match}")
    direct = [synth.synth_from_features(f, target_segments=s, voice=v)["unit_ids"]
              for f, s, v in zip(feats, segs, vs)]
    same_as_direct(label, ids, direct)
    if oracle_gate:
        halfphone_oracle_gap(db, synth, feats[0], segs[0], ids[0], f"{label} split3cat")
    tgts, _, kwargs = synth.batch_inputs(
        [(f, len(f)) for f in feats], segs,
        None if voices is None else [synth._voice_code(v) for v in voices])
    with Phase(f"{label}: kernel vs plain at the served shape"):
        run.kernel_at(kernel, synth, tgts, kwargs, (tgts.shape[0] * 128,))


def split3_masked(run: Run, label, kernel, db, cfg_over, feats, out_highest,
                  voices=None, segs=None):
    """One synth_batch step at split3 on a masked voice: no leaks, and
    tie-adjusted agreement with the "highest" step on the same inputs."""
    torch = run.torch
    from snickery_tpu_torch import Synthesiser
    synth = Synthesiser(smoke_config(preselect_precision="split3", **cfg_over),
                        db=db, device="cuda")

    def drive():
        with Phase(f"{label} split3 main path: synth_batch B={len(feats)}"):
            return timed_batch(torch, synth, 1, feats, voices=voices, segments_list=segs)

    out = run.main_path(f"{label} split3", kernel, drive)
    if voices is not None:
        leaks = sum(int((db.voice_ids[r["unit_ids"]] != synth._voice_code(v)).sum())
                    for r, v in zip(out, voices))
        log(f"{label} split3: cross-voice leaks {leaks}")
        check(leaks == 0, f"{label} split3: {leaks} units leaked across voices")
    raw, adj = tie_adjusted_agreement(db, np.concatenate([r["unit_ids"] for r in out]),
                                      np.concatenate([r["unit_ids"] for r in out_highest]))
    log(f"{label}: split3 vs highest over {sum(len(r['unit_ids']) for r in out)} units: "
        f"raw {raw:.5f}, tie-adjusted {adj:.5f}")
    check(adj >= 0.999, f"{label}: split3 tie-adjusted agreement {adj} < 0.999")
    if segs is None:
        prepped = [synth.targets_from_features(f) for f in feats]
    else:
        prepped = [(f, len(f)) for f in feats]
    tgts, _, kwargs = synth.batch_inputs(
        prepped, segs, None if voices is None else [synth._voice_code(v) for v in voices])
    with Phase(f"{label} split3: kernel vs plain at main-path shape"):
        run.kernel_at(kernel, synth, tgts, kwargs, (tgts.shape[0] * tgts.shape[1],))


def cli_phase(run: Run, db, synth5, feats):
    """The CLI on the config-5 voice: the merged DB saved with the port's
    VoiceDB.save, 8 DNN-target utterances as stream files, a JSON config at
    synth_batch 8 and split3cat, and ``python -m snickery_tpu_torch.cli
    synth --voice v3 --dump-units`` in a subprocess; its units.npy must equal
    a direct synth_batch of the same 8 utterances."""
    from snickery_tpu_torch.io.speech import put_speech
    root = os.path.abspath(os.path.join("build", "chip_smoke", "cli"))
    with Phase("CLI: save the merged voice and write the stream files"):
        db.save(os.path.join(root, "smokemv.voicedb"))
        test_dir = os.path.join(root, "test")
        for name, a, b in synth5.cfg.stream_slices:
            os.makedirs(os.path.join(test_dir, name), exist_ok=True)
            for i, f in enumerate(feats[:8]):
                put_speech(f[:, a:b], os.path.join(test_dir, name, f"t{i}.{name}"))
        cfg = dict(workdir=root, voice_name="smokemv", test_data_dir=test_dir,
                   stream_list=list(STREAMS), datadims=dict(DATADIMS), sample_rate=SR,
                   n_candidates=30, taper_length=50, join_cost_weight=JCW,
                   length_buckets=[64, 256], synth_batch=8,
                   preselect_precision="split3cat")
        cfg_path = os.path.join(root, "voice.json")
        with open(cfg_path, "w") as f:
            json.dump(cfg, f)
    out_dir = os.path.join(root, "out")
    with Phase("CLI main path: python -m snickery_tpu_torch.cli synth (subprocess)"):
        res = subprocess.run([sys.executable, "-m", "snickery_tpu_torch.cli", "synth",
                              "-c", cfg_path, "-o", out_dir, "--voice", "v3",
                              "--dump-units"], capture_output=True, text=True, timeout=600)
        for line in (res.stdout + res.stderr).strip().splitlines()[-12:]:
            log(f"cli: {line}")
        check(res.returncode == 0, f"CLI synth exited {res.returncode}")
    direct = synth5.synth_batch(feats[:8], voices=["v3"] * 8)
    for i, r in enumerate(direct):
        got = np.load(os.path.join(out_dir, f"t{i}.units.npy"))
        check(np.array_equal(got, r["unit_ids"]), f"CLI t{i}.units.npy differs from direct")
        check(os.path.getsize(os.path.join(out_dir, f"t{i}.wav")) > 44, f"CLI t{i}.wav empty")
    log("CLI: 8 of 8 units.npy equal a direct synth_batch")


def main() -> int:
    argparse.ArgumentParser(description=__doc__.split("\n\n")[0]).parse_args()
    t_start = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device", file=sys.stderr)
        return 2
    from snickery_tpu_torch.ops import _build

    smi = nvidia_smi_line()
    with Phase("card"):
        log(f"nvidia-smi: {smi}")
        nvcc = subprocess.run([_build._nvcc(), "--version"], capture_output=True,
                              text=True, check=True).stdout.strip().splitlines()[-1]
        log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, nvcc: {nvcc}, "
            f"device 0: {torch.cuda.get_device_name(0)}, "
            f"count {torch.cuda.device_count()}")
    with Phase("kernel build"):
        lib = _build.kernel_library()
        log(f"built {lib.path.name} in {lib.build_seconds:.1f} s")
        for line in lib.compiler_log.splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                log(f"ptxas: {line.strip()}")
    run = Run(torch)
    with Phase("kernel vs plain, synthetic"):
        run.errs["topk_preselect_zt"] = kernel_vs_plain_synthetic(torch)
    with Phase("kernel variants vs plain, synthetic"):
        for name, err in kernel_variants_synthetic(torch).items():
            run.errs[name] = max(run.errs.get(name, 0.0), err)
    with Phase("split precisions vs plain, synthetic"):
        for name, err in precision_variants_synthetic(torch).items():
            run.errs[name] = max(run.errs.get(name, 0.0), err)
    with Phase("split precisions with fused masks vs plain, synthetic"):
        for name, err in split_masked_variants_synthetic(torch).items():
            run.errs[name] = max(run.errs.get(name, 0.0), err)
    db, held, short, out32 = config3(run)
    torch.cuda.empty_cache()
    config3_split3cat(run, db, held, short, out32)
    torch.cuda.empty_cache()
    capacity(run, db, held)
    del db
    torch.cuda.empty_cache()
    hp_over = dict(target_representation="halfphone", n_candidates=20, length_buckets=[128])
    db, feats, segs, out = config2(run)
    server_halfphone(run, "server config 2", "topk_preselect_zt_split3cat_ling", db,
                     feats, segs, None, True)
    split3_masked(run, "config 2", "topk_preselect_zt_split3_ling", db, hp_over, feats,
                  out, segs=segs)
    torch.cuda.empty_cache()
    db, feats, voices, out, held = config5(run)
    synth5 = server_config5(run, db, feats, voices, out, held)
    split3_masked(run, "config 5", "topk_preselect_zt_split3_part", db,
                  dict(length_buckets=[256]), feats, out, voices=voices)
    cli_phase(run, db, synth5, feats)
    del synth5
    torch.cuda.empty_cache()
    composition(run, COMP_UTTS)
    torch.cuda.empty_cache()
    db, feats, segs, voices, out = composition(run, HP_UTTS)
    server_halfphone(run, "server composition", "topk_preselect_zt_split3cat_ling_part",
                     db, feats, segs, voices, False)
    split3_masked(run, "composition", "topk_preselect_zt_split3_ling_part", db, hp_over,
                  feats, out, voices=voices, segs=segs)
    del db
    torch.cuda.empty_cache()

    log(f"chip_smoke.py: all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [{
        "name": name, "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": REPLACES[name], "launches": run.launches[name],
        "max_abs_err": run.errs[name], "ms": run.times[name][0],
        "plain_ms": run.times[name][1], "bound_ms": run.bounds[name][0],
        "bound_by": run.bounds[name][1], "library_ms": None,
        "matmul_ms": run.matmul[name]} for name in REPLACES]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

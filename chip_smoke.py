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
    with voices and segments, then one step at split3;
18. the derived operand (config ``zero_transient: 0``): its twelve entry
    points against their twins at kd 151 and 453, T in {128, 2048, 300} x
    M in {8192, 65536, 8229}, with duplicated rows, 37 padding rows that
    must never be selected, starved voices and codes no row carries (this
    check runs with phases 3, 4, 9 and 13);
19. config 3 at ``zero_transient: 0``: ``synth_batch`` B = 32 x 2048 at
    "highest" (k = n_candidates, no margin) and at split3cat (the pre-split
    operand), each with its stage split (``derive`` included), the kernel
    against its twin, the held-out utterance against the float64 oracle
    and agreement with phase 5's batch; one epoch-rate config-4 stream at
    split3cat (exact totals, streamed vs greedy ids); a B = 8 step at
    split3;
20. one ``synth_batch`` step at ``zero_transient: 0`` at each precision on
    the config-2 voice (identity match, f64 gap), the config-5 voice (no
    leaks, agreement with phase 7) and the merged 50,000-unit halfphone
    voices, so that every masked derived entry point runs on a main path;
21. the server on the config-5 voice at ``zero_transient: 0`` and
    split3cat: 16 concurrent ``POST /synth``, ids equal to direct calls,
    no leaks;
22. the selection variants (``select="phase"``, ``"packed"``, ``"packed3"``,
    ``"packed3diag"``) x both operand forms x three precisions x four masks
    against their twins (kd 151 and 453, duplicated rows, 37 padding rows,
    starved voices, one pile-up block): equal to the twin exactly at
    "highest", "phase" equal to "stream" bit for bit, unflagged
    "packed3diag" columns equal to "packed", "packed3" exact with a pile-up
    (the stream kernel launches) and without (it does not) (this check runs
    with phases 3, 4, 9, 13 and 18);
23. the kernel sweep, the path that reaches those variants: ``python -m
    snickery_tpu_torch.sweep_topk`` called in process, once per operand
    form and mask at 2,048 x 131,072 x 151 over every precision and
    selection, and once at its default shape (16,384 x 1,048,576, k 30)
    with ``--pileup 6``; all 72 variant entry points must have launched;
    then each of them against its twin, timed, at the sweep's small shape;
24. the variants at the config-3 batch shape (65,536 x 1,048,576 x 151,
    zero-transient) at "highest" (k 40) and split3cat (k 48): "phase",
    "packed" and "packed3diag" against their twins, timed beside the stream
    kernel of the same run; the overflow count on the voice and on a copy
    with planted runs of 6 near-duplicates; at "highest" the packed
    top-(30 + margin) must hold the stream top-30 of every target (these
    checks run inside phases 5 and 10);
25. the edges of the kernels' tiles and of their screened epilogue
    (``kernel_check.EDGE_CASES``) against the twins at "highest" and
    split3cat in both operand forms: target and DB row counts that are no
    multiples of a tile over one split and several, kd 453 at k 64 (the
    narrower target tile), scores that fall with the row index (every score
    passes the screen and the survivor queue overflows on every tile) and
    that rise (nothing passes after the first k rows), bit-identical rows
    (the lowest k indices must win), a starved voice and kd 302 (multiepoch=2
    units) (this check runs after phase 22's);
26. the SHA-256 of the "highest" kernels' ids and scores on the seeded
    65,536 x 1,048,578 case of ``snickery_tpu_torch.kernel_ab``, printed
    beside the digests of the kernels' first design;
27. voice building, natural synthesis, resynthesis and the quality report:
    64 speech-like utterances of 6 s (``synthetic_voices.synth_utterance``,
    about 49,000 epoch units; mag 60, real 45, imag 45, lf0 1) and a
    held-out one as 16 kHz wavs; the port's native epoch library must load;
    ``python -m snickery_tpu_torch.cli train --device cuda`` in a subprocess
    (its stage split); ``magphase_analysis`` and ``world_analysis`` at
    120,000 epochs x 1,024-point frames (the corpus joined with 2,048-sample
    gaps and repeated), timed, held to the port's CPU analysis of the same
    frames and, by rules (a) and (b), to a float64 numpy analysis of the
    first 4,096 epochs (``tests/analysis64.py``); natural-mode ``synth`` of
    a training and the held-out utterance (the preselect kernel, counted,
    then held to its twin on both utterances' targets): the training
    utterance comes back as its own units, each run of them its corpus audio
    sample for sample; ``resynth_magphase`` of those units correlates above
    0.90 with the original on the resynthesis epoch grid; ``python -m
    snickery_tpu_torch.cli evaluate`` (subprocess): strict JSON, copy MCD
    below 0.5 dB, every held-out field finite;
28. meshes (``snickery_tpu_torch.parallel``): on the config-3 voice a
    ``Synthesiser`` on a (1, 2) mesh at "highest" and one on a (2, 2) mesh
    at split3cat, members ``["cuda:0"] * n`` on a one-card machine and
    distinct cards where the machine has n (logged), ``synth_batch`` B = 32 x
    2048: the kernel launched once a member a step and nothing else, each
    member's exchange payload equal to its model, every shard contributing
    units, ids equal to phases 5 / 10 except float64-judged near-ties, the
    held-out utterance through each mesh against the float64 oracle
    (>= 0.99, gap <= 1e-4), the kernel against its twin at a member's shape
    (65,536 and 32,768 x 524,288), ``sharded_norm_stats`` of the voice's features
    against float64; on the config-5 voice a (1, 4) mesh at split3cat, B =
    64 (no leaks, ids against phase 7's, the kernel at 16,384 x 65,536);
    ``parallel.dryrun`` on 4 members.  ``meshes_alone`` runs this phase by
    itself with the voices and single-device batches it is held to;
29. the corpus front end, after phase 27 on its 65 wavs: ``python -m
    snickery_tpu_torch.extract --device cuda`` (subprocess; mag / real /
    imag / lf0 and their 5 ms fixed-rate copies): every ``.pm`` and stream
    file, no fallback to the Python detector; ``cli train`` (subprocess) of
    a second voice from that tree, whose units, cutpoints, waves and
    features must equal the wav-trained voice's bit for bit; natural-mode
    ``synth`` of utt000 and the held-out utterance from it (the preselect
    kernel, counted), ids equal to phase 27's; ``python -m
    snickery_tpu_torch.bench_corpus_prep --device cuda`` at 60 minutes of
    audio, its four lines logged beside the card's name and power limit;
30. the port's bench (``python -m snickery_tpu_torch.bench --device
    cuda``, two subprocesses sharing the cache ``build/chip_smoke/bench``):
    ``--modes epoch,kernel,streaming`` at the defaults (the bench's own
    1M-unit corpus: ``synth_utterance`` waves, the native detector, the
    grouped magphase analysis on the card, the cutter; config 3 at split3cat
    B = 32 x 2048 with the float64-oracle and f32 gates, the kernel against
    its twin, config-4 streaming), then ``--quick --modes me2,capacity,
    halfphone,multivoice,toy,48k,quality``: both exit 0, both last lines
    parse, every block is there with no error and no skip, config 3's oracle
    tie-adjusted agreement >= 0.99 with |gap| <= 1e-4 and split3cat-vs-f32
    tie-adjusted >= 0.999, ``kernel_vs_twin`` true, each block's preselect
    kernel and the Viterbi kernel launched in its timed steps,
    ``BENCH_full.json`` unchanged; me2's kernel at kd 302 is the kernels
    line's ``@me2`` row;
31. the decode kernels (``csrc/viterbi.cu``; run right after phase 5, on
    its lattice): ``viterbi_decode``, ``greedy_decode`` and
    ``greedy_decode_stream`` against their plain versions on
    ``kernel_check.DECODE_CASES`` (lengths 1, T, 0 and ragged with junk in
    the padded steps; N 1, 20, 30 and 64; dj 151 and 302; a natural chain
    that must cost exactly 0.0; epsilon 0, 0.3 and 1e9; squared joins;
    exact ties, where the lowest index must win; backpointers in device
    memory at T = 8,200; one staging buffer a side at N = 64, dj = 302;
    stream chunks with and without an incoming context, and with none
    live; one utterance of 650 steps; 160 utterances, more than the card
    has SMs; N = 33, one state past a warp, with ties at epsilon 0.25),
    each twice (bit-identical): paths equal, or float64 near-ties no
    dearer (1e-6), totals rtol 1e-5; each again at every forced cluster
    size 1, 2, 4 and 8, bit-equal to the default plan's result; the
    SHA-256 of every ``kernel_ab`` Viterbi case's paths and totals against
    the first decode kernels' (``kernel_ab.PR13_DECODE_DIGESTS``; greedy's
    are logged: it now sums a distance in another order); then at config
    3's batch lattice (phase 5's B = 32 x 2048 step, N = 30, dj = 151) the
    Viterbi and the greedy kernel, its first utterance cut to 650 steps
    for the single-utterance Viterbi (the kernels line's ``@single`` row),
    and a config-4-shaped chunk of it (T = 64, 32 live) for the stream
    kernel, timed against their plain versions with CUDA events, the
    Viterbi and the stream call under
    ``torch.cuda.set_sync_debug_mode("error")``;
32. the kernel sweep on the bench's real rows (after phase 30, on its cached
    ``bench1m``, 1,048,052 units padded to 1,048,576): ``sweep_topk.main
    --real`` in process (16,384 held-out targets, kd 151, k 30) for
    ``--db-op zt`` and ``dv``, each as built, ``--cluster`` (k-means order,
    host seconds logged) and ``--scatter``, and once with ``--db-op raw``,
    over ``highest,stream``, ``split3cat`` at ``stream``, ``phase``,
    ``packed`` and ``packed3diag``, and ``highest,packed3diag``; the counts
    set to 0 around each call, every entry point asked for launched, every
    line logged beside the card's name and power limit, then all of them as
    one JSON line; on the first 2,048 targets against the whole DB, as built
    and clustered, each combination in both operand forms against its twin
    (``kernel_check.judge``; near-tie ids on up to 5% of the targets at a
    packed selection at split3cat, where a key drops the score's low 7 bits,
    1% elsewhere); at "highest" the stream kernel's scores on the
    clustered DB equal to the built DB's, its ids the same rows through the
    order up to bit-identical rows; then ``_zt`` and ``_zt_split3cat`` at
    the sweep's full shape against their twins: the kernels line's
    ``@real`` rows, with the sweep's launches.

Each main path runs with the launch counts set to 0 just before it and read
just after; the preselect kernel it needs and its decode kernel (Viterbi;
greedy for ``greedy_search``; the stream kernel for the streams) must have
launched (phase 30's bench counts them so around each mode's timed steps, in
its subprocess).  Standard output ends
with a JSON line of the meshes (phase 28: ms a step, exchange bytes a
member, agreement, the kernel at a shard's shape), a JSON line of the
kernels (launches on the main paths, max error against the twin, kernel,
twin and ``torch.matmul``-of-the-product times, and the bound from the
card's published peaks; after the stream and variant entry points the
``@me2`` and ``@real`` rows, then the three decode kernels' rows and the
single-utterance Viterbi's last, with no matmul yardstick; the ``@single``
row counts the Viterbi launches of the natural-synth paths, one utterance
a launch), the card's name and power limit from nvidia-smi,
and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import base64
import functools
import json
import os
import re
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np

from snickery_tpu_torch.kernel_check import (F32_EPS, PROBE_RTOL, bound_ms, check, compare,
                                             matmul_ms, partition_work, split_probe_error,
                                             time_ms)
from snickery_tpu_torch.synthetic_voices import (DATADIMS, KD, SR, make_halfphone_utterances,
                                               make_utterances, phone_means)

STREAMS = ["mag", "real", "imag", "lf0"]
JCW = 0.7
N_UTTS = 3000            # config 3: 1,048,500 epoch units
T_BUCKET = 2048
HP_UTTS = 625            # config 2: 625 x 80 = 50,000 halfphone units
MV_EPOCHS = [351] * 93 + [313]   # config 5: 32,768 units a voice, 8 voices
COMP_UTTS = 60           # composition: 4,800 halfphone units a voice
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
# the derived-operand form (zero_transient=False, :795-811): the same lines
# plus the derivation, and split3cat_db (:112-125) for the pre-split operand
REPLACES.update({
    name.replace("_zt", "_dv", 1): line.replace(
        "(+", "(+:795-811, " + (":112-125, " if "split3cat" in name else ""), 1)
    if "(+" in line else line + " (+:795-811)"
    for name, line in REPLACES.items()})
# the selection variants: one source per (form, selection), and the lines of
# the Pallas selection loop each replaces
SELECT_LINES = {"phase": ":572-641", "packed": ":212-306, :521-554",
                "packed3": ":309-411, :521-554, :917-936"}
STREAM_KERNELS = tuple(REPLACES)
REPLACES.update({
    f"{name}_{sel}": (f"{line[:-1]}, {lines})" if "(+" in line else f"{line} (+{lines})")
    for sel, lines in SELECT_LINES.items() for name, line in list(REPLACES.items())})


# the decode kernels (phase 31): the XLA scans of the JAX package they replace
SINGLE_ROW = "viterbi_decode@single"    # the kernels line's row of one utterance
SINGLE_STEPS = 650                        # its steps: config 1's utterance (PERF.md)
SINGLE_PATHS = ("natural synth", "front end natural synth")   # one utterance a decode
DECODE_REPLACES = {
    "viterbi_decode": "snickery_tpu/ops/viterbi.py:102 (lax.scan; +:117, the backtrack)",
    "greedy_decode": "snickery_tpu/ops/viterbi.py:155 (lax.scan)",
    "greedy_decode_stream": "snickery_tpu/synth.py:337 (lax.scan of _streaming_step)",
}

# the overlap-add kernel (ola_phase): the JAX package's scatter-add it replaces,
# and each row of the kernels line: the kernel_ab case it is timed on, and the
# prefixes of the main paths whose launches it counts ("overlap_add": all)
OLA_REPLACES = {
    "overlap_add": "snickery_tpu/ops/ola.py:108 (the scatter-add .at[...].add, :183)",
}
OLA_ROWS = {"overlap_add": ("ola_halfphone", ()),
            "overlap_add@epoch": ("ola_epoch", ("config 3", "config-3")),
            "overlap_add@stream": ("ola_epoch", ("config 4", "config-4"))}


def kernel_source(name: str) -> str:
    """The .cu file that exports entry point ``name``."""
    if name in DECODE_REPLACES:
        return "snickery_tpu_torch/csrc/viterbi.cu"
    if name in OLA_REPLACES:
        return "snickery_tpu_torch/csrc/ola.cu"
    stem = "topk_preselect" if "_zt" in name else "topk_derived"
    sel = next((x for x in SELECT_LINES if name.endswith("_" + x)), None)
    return f"snickery_tpu_torch/csrc/{stem}{'_' + sel if sel else ''}.cu"


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


def derived_variants_synthetic(torch) -> dict:
    """The twelve derived-operand entry points against their twins at kd 151
    and 453, T in {128, 2048, 300} x M in {8192, 65536, 8229}, with
    duplicated rows, the last 37 rows padding (n_real < m_rows: never
    selected), starved voices and codes no row carries; returns {kernel
    name: max_abs_err}."""
    from snickery_tpu_torch.const import QUINPHONE_CONTEXT_WEIGHTS, QUINPHONE_SCALE
    from snickery_tpu_torch.ops.cuda_topk import derive_operand, kernel_name, pack_meta
    from snickery_tpu_torch.synth import BACKOFF_LING_WEIGHTS
    dev = torch.device("cuda")
    errs = {}
    variants = [(False, None), (True, None),
                (False, (*QUINPHONE_CONTEXT_WEIGHTS, QUINPHONE_SCALE)),
                (True, BACKOFF_LING_WEIGHTS)]
    for kd in (KD, 3 * KD):
        for T, M in ((128, 8192), (2048, 65536), (300, 8192 + 37)):
            rng = np.random.default_rng(11 * kd + T)
            raw_np, aff_np = synthetic_block(rng, M, kd, True)
            n_real = M - 37
            raw = torch.from_numpy(raw_np).to(dev)
            aff = tuple(torch.from_numpy(a).to(dev) for a in aff_np)
            tg = torch.from_numpy(rng.standard_normal((T, kd), dtype=np.float32)).to(dev)
            for precision, k in (("highest", 30), ("split3", 40), ("split3cat", 48)):
                op, sqn = derive_operand(raw, aff, n_real, M, precision)
                tc, tx, tv, dc, dx, dv = synthetic_labels(rng, T, M, k)
                dc[n_real:], dx[n_real:], dv[n_real:] = -1, -1, -1
                tc, tx, tv, dc, dx, dv = (torch.from_numpy(a).to(dev)
                                          for a in (tc, tx, tv, dc, dx, dv))
                meta = dict(tgt_meta=pack_meta(tc, tx, tv), db_meta=pack_meta(dc, dx, dv))
                for partition, weights in variants:
                    name = kernel_name(partition, weights is not None, precision, False)
                    kw = (dict(meta, partition=partition, ling_weights=weights)
                          if partition or weights else {})
                    err, nbad, dead = compare(tg, op, None, M, k, precision, sqn=sqn,
                                              n_real=n_real, **kw)
                    errs[name] = max(errs.get(name, 0.0), err)
                    if partition:
                        check(dead >= 32 * (k - k // 2) + 8 * k,
                              f"starved slots missing ({dead})")
                    log(f"{name} vs plain T={T} M={M} (n_real {n_real}) kd={kd} k={k} "
                        f"dup=True: max_abs_err {err:.3e}, near-tie id swaps {nbad}, "
                        f"dead slots {dead}")
                del op, sqn
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


def select_case(torch, seed: int, T: int, M: int, kd: int, pileup: int):
    """Card tensors of one selection-variant case: a raw block of M - 37
    real rows (the last 37 padding) with duplicated rows and, with
    ``pileup``, a run of that many near-duplicates in the block of row 512
    under the first 16 targets.  Returns (targets, raw, aff, n_real, the
    generator, for the caller's labels)."""
    from snickery_tpu_torch.kernel_check import pileup_block
    from snickery_tpu_torch.voicedb.device_layout import build_raw_blocks
    rng = np.random.default_rng(seed)
    n_real = M - 37
    feats = rng.standard_normal((n_real, kd), dtype=np.float32)
    feats[100:140] = feats[50]
    aff = ((0.1 * rng.standard_normal(kd)).astype(np.float32),
           rng.uniform(0.5, 2.0, kd).astype(np.float32),
           rng.uniform(0.2, 1.0, kd).astype(np.float32))
    tg = rng.standard_normal((T, kd), dtype=np.float32)
    if pileup:
        pileup_block(feats, tg, aff, start=512, run=pileup, n_targets=16, seed=seed)
    jr = np.zeros_like(feats)
    jr[:-1] = feats[1:]
    raw, _, _ = build_raw_blocks(feats, jr, M, affine=aff)
    dev = torch.device("cuda")
    return (torch.from_numpy(tg).to(dev), torch.from_numpy(raw).to(dev),
            tuple(torch.from_numpy(a).to(dev) for a in aff), n_real, rng)


def select_variants_synthetic(torch) -> dict:
    """The four selection variants x both operand forms x three precisions
    x four masks against their twins (kd 151 at T=300 x M=8229, kd 453 at
    T=128 x M=8192; duplicated rows, 37 padding rows, starved voices, one
    pile-up block): the rule of kernel_check.compare at the selection; at
    "highest" ids, scores and flags equal the twin's exactly; "phase" equals
    the stream kernel bit for bit; columns that "packed3diag" leaves
    unflagged equal "packed"; "packed3" once with a pile-up (the fallback
    must launch the stream kernel and return its result) and once without
    (it must not).  Returns {entry point: max_abs_err}."""
    from snickery_tpu_torch.const import QUINPHONE_CONTEXT_WEIGHTS, QUINPHONE_SCALE
    from snickery_tpu_torch.ops import cuda_topk
    from snickery_tpu_torch.ops.cuda_topk import (cuda_topk_preselect, derive_operand,
                                                  kernel_name, pack_meta)
    from snickery_tpu_torch.synth import BACKOFF_LING_WEIGHTS
    errs = {}
    variants = [(False, None), (True, None),
                (False, (*QUINPHONE_CONTEXT_WEIGHTS, QUINPHONE_SCALE)),
                (True, BACKOFF_LING_WEIGHTS)]
    dev = torch.device("cuda")
    for kd, T, M in ((KD, 300, 8192 + 37), (3 * KD, 128, 8192)):
        tg, raw, aff, n_real, rng = select_case(torch, 13 * kd + T, T, M, kd, 10)
        for precision, k in (("highest", 30), ("split3", 40), ("split3cat", 48)):
            tc, tx, tv, dc, dx, dv = synthetic_labels(rng, T, M, k)
            dc[n_real:], dx[n_real:], dv[n_real:] = -1, -1, -1
            tc, tx, tv, dc, dx, dv = (torch.from_numpy(a).to(dev)
                                      for a in (tc, tx, tv, dc, dx, dv))
            meta = dict(tgt_meta=pack_meta(tc, tx, tv), db_meta=pack_meta(dc, dx, dv))
            for zt in (True, False):
                if zt:
                    form = dict(raw_block=raw, db_affine=aff)
                    cmp_args, cmp_kw = (tg, raw, aff, M, k, precision), {}
                else:
                    op, sqn = derive_operand(raw, aff, n_real, M, precision)
                    form = dict(raw_block=op, db_affine=None, zero_transient=False, sqn=sqn)
                    cmp_args, cmp_kw = (tg, op, None, M, k, precision), dict(sqn=sqn)
                for partition, weights in variants:
                    kw = (dict(meta, partition=partition, ling_weights=weights)
                          if partition or weights else {})

                    def kernel(select):
                        return cuda_topk_preselect(tg, k=k, m_rows=M, precision=precision,
                                                   select=select, **form, **kw)

                    i_s, v_s = kernel("stream")
                    i_p, v_p = kernel("packed")
                    for select in ("phase", "packed", "packed3", "packed3diag"):
                        name = kernel_name(partition, weights is not None, precision, zt,
                                           select)
                        err, nbad, dead = compare(
                            *cmp_args, n_real=None if partition else n_real, select=select,
                            **cmp_kw, **kw)
                        errs[name] = max(errs.get(name, 0.0), err)
                        if precision == "highest":
                            check(err == 0.0 and nbad == 0,
                                  f"{name} ({select}): not equal to its twin at highest")
                        log(f"{name} ({select}) vs plain T={T} M={M} kd={kd} k={k}: "
                            f"max_abs_err {err:.3e}, near-tie id swaps {nbad}, dead slots "
                            f"{dead}")
                    i_f, v_f = kernel("phase")
                    check(torch.equal(i_f, i_s) and torch.equal(v_f, v_s),
                          f"phase differs from stream ({precision}, zt {zt})")
                    i_d, v_d, flags = kernel("packed3diag")
                    clear = flags == 0
                    check(torch.equal(i_d[clear], i_p[clear])
                          and torch.equal(v_d[clear], v_p[clear]),
                          "an unflagged packed3diag column differs from packed")
                    if not kw:
                        check(bool(flags[:16].all()),
                              "the pile-up targets must raise the flag")
                    i_3, v_3 = kernel("packed3")
                    want = (i_s, v_s) if bool(flags.any()) else (i_p, v_p)
                    check(torch.equal(i_3, want[0]) and torch.equal(v_3, want[1]),
                          "packed3 must return the stream result where a flag is set, "
                          "else the packed one")
    # the fallback, seen in the launch counts: taken with a pile-up, not without
    for pileup, T, M, k in ((10, 128, 65536 + 37, 8), (0, 128, 65536 + 37, 8)):
        tg, raw, aff, n_real, _ = select_case(torch, 77, T, M, KD, pileup)
        cuda_topk.LAUNCH_COUNTS.clear()
        i_3, v_3 = cuda_topk_preselect(tg, raw, k, aff, M, select="packed3")
        got = dict(cuda_topk.LAUNCH_COUNTS)
        log(f"packed3 T={T} M={M} k={k} pile-up {pileup}: launches {got}")
        check(got == ({"topk_preselect_zt_packed3": 1, "topk_preselect_zt": 1} if pileup
                      else {"topk_preselect_zt_packed3": 1}),
              f"packed3 fallback {'not ' if pileup else ''}taken: {got}")
        other = cuda_topk_preselect(tg, raw, k, aff, M, select="stream" if pileup else "packed")
        check(torch.equal(i_3, other[0]) and torch.equal(v_3, other[1]),
              "packed3 must equal stream after a fallback and packed without")
    return errs


def edge_cases_synthetic(torch) -> None:
    """The edges of the kernels' tiles and of their screened epilogue
    (kernel_check.EDGE_CASES) against the twins, at "highest" and
    "split3cat", in both operand forms; then the partition kernels' span
    edge cases (kernel_ab.SPAN_CASES: unaligned voices, one shorter than k,
    dead targets with padding rows, tiles of two voices, ids with gaps and
    a voice in two runs, a shard of padding only) the same way, and their
    digests at the case's own precision against those of PR 9's kernels,
    which scanned every row."""
    from snickery_tpu_torch import kernel_ab
    from snickery_tpu_torch.kernel_check import EDGE_CASES, compare, run_edge_case
    dev = torch.device("cuda")
    for name, (T, M, kd, k, _) in EDGE_CASES.items():
        for precision in ("highest", "split3cat"):
            for zt in (True, False):
                t0 = time.perf_counter()
                err, nbad, dead = run_edge_case(name, dev, precision, zt)
                log(f"edge {name} T={T} M={M} kd={kd} {precision} {'zt' if zt else 'dv'}: "
                    f"max_abs_err {err:.3e}, near-tie id swaps {nbad}, dead slots {dead} "
                    f"({time.perf_counter() - t0:.2f} s with the twin)")
    for name in kernel_ab.SPAN_CASES:
        for precision in ("highest", "split3cat"):
            for zt in (True, False):
                x, block, aff, m_rows, k, prec, kw = kernel_ab.span_case(name, dev, precision, zt)
                kw.pop("zero_transient", None)
                err, nbad, dead = compare(x, block, aff, m_rows, k, prec, **kw)
                if prec == "highest":
                    check(err == 0.0 and nbad == 0, f"{name}: not equal to its twin at highest")
                log(f"edge {name} T={x.shape[0]} M={m_rows} {prec} {'zt' if zt else 'dv'}: "
                    f"max_abs_err {err:.3e}, near-tie id swaps {nbad}, dead slots {dead}")
    for line in kernel_ab.run_cases("chip_smoke", 1, set(kernel_ab.SPAN_CASES)):
        got, want = (line["ids_sha256"], line["scores_sha256"]), kernel_ab.PR9_DIGESTS[line["case"]]
        log(f"{line['case']} ({line['precision']}, k {line['k']}): sha256 of ids {got[0]}, of "
            f"scores {got[1]}; PR 9's kernels: {want[0]}, {want[1]}")
        check(got == want, f"{line['case']}: digests differ from PR 9's kernels'")


def first_design_digests() -> None:
    """The (ids, scores) digests of every seeded case of
    snickery_tpu_torch.kernel_ab (the batch shapes, the chunks, capacity and
    the small grids; the span cases run in edge_cases_synthetic) against
    those PR 9's kernels printed (kernel_ab.PR9_DIGESTS), and the two
    "highest" batch cases against the first design's too: a score is one
    ascending fmaf chain at "highest" and one wgmma chain at the split
    precisions, which no redesign of the list phase, the spans or pass 2
    changes, and the selection is exact, so no bit may move."""
    from snickery_tpu_torch import kernel_ab
    cases = set(kernel_ab.PR9_DIGESTS) - set(kernel_ab.SPAN_CASES)
    for line in kernel_ab.run_cases("chip_smoke", 1, cases):
        got, case = (line["ids_sha256"], line["scores_sha256"]), line["case"]
        want = kernel_ab.PR9_DIGESTS[case]
        first = kernel_ab.FIRST_DESIGN_DIGESTS.get(case)
        log(f"{case} T={line['T']} M={line['m_rows']} {line['precision']} k={line['k']}: "
            f"{line['ms']:.2f} ms, sha256 of ids {got[0]}, of scores {got[1]}; PR 9's: "
            f"{want[0]}, {want[1]}" + (f"; the first design's: {first[0]}, {first[1]}"
                                       if first else ""))
        check(got == want, f"{case}: digests differ from PR 9's kernels'")
        check(first is None or got == first, f"{case}: digests differ from the first design's")


SWEEP_SHAPE = (2048, 131072)   # the sweep's small shape: target rows, units
SWEEP_K = {"highest": 30, "split3": 40, "split3cat": 48}


def sweep_path(run) -> None:
    """The path that reaches the selection variants: the sweep's entry
    point, called in process with every count set to 0 just before and read
    just after.  Once per operand form and mask at the small shape over
    every precision and variant selection, then once at its default shape
    (16,384 x 1,048,576 x 151, k 30) with planted runs.  Each of the 72
    variant entry points must have launched."""
    from snickery_tpu_torch import sweep_topk
    from snickery_tpu_torch.ops.cuda_topk import PRECISIONS
    counts = run.cuda_topk.LAUNCH_COUNTS
    rows, units = SWEEP_SHAPE
    combos = " ".join(f"{p},{sel}" for p in PRECISIONS
                      for sel in ("phase", "packed", "packed3", "packed3diag"))
    counts.clear()
    for db_op in ("zt", "dv"):
        for masks in sweep_topk.MASKS:
            argv = ["--rows", str(rows), "--units", str(units), "--iters", "1", "--db-op",
                    db_op, "--masks", masks, "--pileup", "6", "--combos", combos]
            log("sweep_topk " + " ".join(argv[:12]) + " --combos <every precision x variant>")
            check(sweep_topk.main(argv) == 0, "the sweep failed")
    argv = ["--iters", "2", "--pileup", "6", "--combos",
            "highest,stream highest,packed split3cat,stream split3cat,packed "
            "split3cat,packed3diag"]
    log("sweep_topk " + " ".join(argv))
    check(sweep_topk.main(argv) == 0, "the sweep failed")
    got = dict(counts)
    log(f"sweep: {len(got)} entry points launched, {sum(got.values())} launches")
    for name in REPLACES:
        if name not in STREAM_KERNELS:
            check(got.get(name, 0) > 0, f"the sweep never launched {name}")
    for name, n in got.items():
        run.launches[name] = run.launches.get(name, 0) + n


def selects_at_sweep_shape(run) -> None:
    """Every variant entry point against its twin, timed, on the data of the
    sweep's small shape (AR(1) rows, planted runs of 6, uniform labels)."""
    from snickery_tpu_torch import sweep_topk
    from snickery_tpu_torch.ops.cuda_topk import PRECISIONS, derive_operand
    torch = run.torch
    dev = torch.device("cuda")
    rows, units = SWEEP_SHAPE
    tg, raw, aff = sweep_topk.make_data(rows, units, KD, 0, 6, False)
    tg, raw = torch.from_numpy(tg).to(dev), torch.from_numpy(raw).to(dev)
    aff = tuple(torch.from_numpy(a).to(dev) for a in aff)
    for precision in PRECISIONS:
        k = SWEEP_K[precision]
        for zt in (True, False):
            if zt:
                form = dict(block=raw, aff=aff)
                db_rows = raw[:, :KD]
            else:
                op, sqn = derive_operand(raw, aff, units, units, precision)
                form = dict(block=op, aff=None, sqn=sqn,
                            row_bytes=op.shape[1] * op.element_size() + 4)
                db_rows = op
            matmul = matmul_ms(tg, db_rows, precision)
            for masks in sweep_topk.MASKS:
                kw = sweep_topk.make_masks(rows, units, 0, masks, dev)
                for select in ("phase", "packed", "packed3diag"):
                    run.variant_at(select, tg, m_rows=units, k=k, precision=precision,
                                   matmul=matmul, **form, **kw)


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
        self.shapes: dict[str, str] = {}
        self.meshes: list[dict] = []        # phase 28's figures, one a mesh

    def main_path(self, label: str, kernel: str, fn, decode=("viterbi_decode",), ola=True):
        """Drive one main path with every count set to 0 just before and
        read just after; its preselect kernel, each of its ``decode``
        kernels (the decode launches count in the same counter) and, with
        ``ola`` (the audio made on the card), the overlap-add kernel must
        have launched.  The Viterbi launches of a path in
        :data:`SINGLE_PATHS` (one utterance a launch) count for the
        ``@single`` row too, the overlap-add launches for each row of
        :data:`OLA_ROWS` whose prefixes the label has."""
        counts = self.cuda_topk.LAUNCH_COUNTS
        counts.clear()
        out = fn()
        got = dict(counts)
        log(f"{label}: kernel launches {got}")
        for name in (kernel, *decode, *(("overlap_add",) if ola else ())):
            check(got.get(name, 0) > 0, f"{label} never launched {name}")
            self.launches[name] = self.launches.get(name, 0) + got[name]
        if label in SINGLE_PATHS:
            self.launches[SINGLE_ROW] = (self.launches.get(SINGLE_ROW, 0)
                                         + got["viterbi_decode"])
        for row, (_, prefixes) in OLA_ROWS.items():
            if ola and prefixes and label.startswith(prefixes):
                self.launches[row] = self.launches.get(row, 0) + got["overlap_add"]
        return out

    def kernel_at(self, kernel, synth, tgts, kwargs, T_list, report=True, matmul=None):
        """The kernel against its twin, and both timed, at the main path's
        shapes, in the operand form the step's ``zero_transient`` picks (the
        derived operand is made once, as the step makes it, and its
        derivation timed); with ``report``, the last of ``T_list`` is the
        shape whose times, bound and matmul yardstick the kernels line
        reports.  ``synth`` is anything with a ``device_db`` (a Synthesiser,
        or one shard of a mesh's voice).  ``matmul`` (default: ``report``)
        times the yardstick at the last shape.  Returns that shape's figures
        (shape, ms, plain_ms, bound_ms, bound_by, matmul_ms, max_abs_err)."""
        from snickery_tpu_torch.ops.cuda_topk import (derive_operand,
                                                      topk_preselect_dv_plain,
                                                      topk_preselect_zt_plain)
        from snickery_tpu_torch.ops.topk import preselect_margin, resolve_zero_transient
        from snickery_tpu_torch.synth import fused_masks
        torch, d = self.torch, synth.device_db
        aff = (d.mean_t, d.std_t, d.sqrt_wt)
        kd = tgts.shape[-1]
        tw = ((tgts - d.mean_t) / d.std_t * d.sqrt_wt).reshape(-1, kd).contiguous()
        m_rows = d.cut1.shape[0]
        precision = kwargs["precision"]
        zt = resolve_zero_transient(kwargs["zero_transient"], precision)
        k = min(kwargs["n_cand"] + preselect_margin(True, precision, zero_transient=zt,
                                                    override=kwargs["margin"]), m_rows)
        masks = fused_masks(d, kwargs["tgt_codes"], kwargs["tgt_ctx"], kwargs["tgt_vids"],
                            halfphone=kwargs["halfphone"], multivoice=kwargs["multivoice"],
                            ling_weights=kwargs["ling_weights"])
        want = self.cuda_topk.kernel_name(masks.get("partition", False),
                                          masks.get("ling_weights") is not None, precision, zt)
        check(want == kernel, f"the step runs {want}, not {kernel}")
        if zt:
            block, block_aff, sqn, row_bytes = d.raw, aff, None, None
            plain = topk_preselect_zt_plain
            db_rows = d.raw[:m_rows, :kd]
        else:
            derive_ms = time_ms(lambda: derive_operand(d.raw, aff, d.n_real, m_rows,
                                                              precision), 3)
            block, sqn = derive_operand(d.raw, aff, d.n_real, m_rows, precision)
            block_aff, row_bytes, db_rows = None, block.shape[1] * block.element_size() + 4, block

            def plain(x, blk, k, _aff, m_rows, **kw):
                return topk_preselect_dv_plain(x, blk, sqn, k, m_rows, **kw)
            log(f"{kernel}: derive_operand M={m_rows} kd={kd} {precision}: {derive_ms:.2f} ms, "
                f"operand {block.nbytes / 1e6:.1f} MB ({tuple(block.shape)} {block.dtype})")
        for T in T_list:
            x = tw[:T].contiguous()
            m = dict(masks, tgt_meta=masks["tgt_meta"][:T].contiguous()) if masks else {}
            # (with the partition mask, a step past an utterance's end has
            # voice id -1, as padding rows have, and may pick them)
            err, nbad, dead = compare(
                x, block, block_aff, m_rows, k, precision, sqn=sqn,
                n_real=None if m.get("partition") else int(d.n_real), **m)
            self.errs[kernel] = max(self.errs.get(kernel, 0.0), err)
            ms = time_ms(lambda: self.cuda_topk.cuda_topk_preselect(
                x, block, k, block_aff, m_rows, precision=precision, zero_transient=zt,
                sqn=sqn, **m), 3)
            plain_ms = time_ms(lambda: plain(x, block, k, block_aff, m_rows,
                                                    precision=precision, **m), 1)
            b_ms, b_by = bound_ms(T, m_rows, kd, k, precision, bool(masks), row_bytes,
                                  partition_work(m, m_rows))
            row = dict(shape=f"{T} x {m_rows} x {kd}, k {k}", ms=ms, plain_ms=plain_ms,
                       bound_ms=b_ms, bound_by=b_by, matmul_ms=None, max_abs_err=err)
            msg = ""
            if m.get("partition"):
                msg = (f", bound over the full DB "
                       f"{bound_ms(T, m_rows, kd, k, precision, True, row_bytes)[0]:.3f} ms")
            if (report if matmul is None else matmul) and T == T_list[-1]:
                row["matmul_ms"] = matmul_ms(x, db_rows, precision)
                msg += f", torch.matmul of the product alone {row['matmul_ms']:.2f} ms"
            if report:
                self.shapes[kernel] = row["shape"]
                self.times[kernel] = (ms, plain_ms)
                self.bounds[kernel] = (b_ms, b_by)
                self.matmul[kernel] = row["matmul_ms"]
            log(f"{kernel} T={T} M={m_rows} kd={kd} k={k}: kernel {ms:.2f} ms, plain "
                f"{plain_ms:.2f} ms, bound {b_ms:.3f} ms ({b_by}){msg}, max_abs_err "
                f"{err:.3e}, near-tie id swaps {nbad}, dead slots {dead}")
        return row


    def variant_at(self, select, x, block, aff, m_rows, k, precision, matmul, sqn=None,
                   n_real=None, row_bytes=None, reps=3, row=None, max_differ=0.01, **masks):
        """One selection variant at one shape: the kernel timed (``reps``
        launches after a warm-up), the twin run and timed once, the kernel's
        result held to it (kernel_check.judge); the times, the stream
        kernel's bound (the same work) and ``matmul`` (the product alone,
        measured by the caller on these inputs) are what the kernels line
        reports in ``row`` (default: the entry point's own row; "" reports
        nothing but the entry point's max error).  ``max_differ``: the share
        of rows whose ids may differ by near-ties (judge's).  Returns the
        kernel's result."""
        from snickery_tpu_torch.kernel_check import judge
        from snickery_tpu_torch.ops.cuda_topk import (topk_preselect_dv_plain,
                                                      topk_preselect_zt_plain)
        torch = self.torch
        T, kd = x.shape
        kw = dict(precision=precision, select=select, **masks)
        name = self.cuda_topk.kernel_name(masks.get("partition", False),
                                          masks.get("ling_weights") is not None, precision,
                                          sqn is None, select)

        def kernel():
            return self.cuda_topk.cuda_topk_preselect(x, block, k, aff, m_rows,
                                                      zero_transient=sqn is None, sqn=sqn, **kw)

        ms = time_ms(kernel, reps)
        got = kernel()
        start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        if sqn is None:
            want = topk_preselect_zt_plain(x, block, k, aff, m_rows, **kw)
        else:
            want = topk_preselect_dv_plain(x, block, sqn, k, m_rows, **kw)
        stop.record()
        torch.cuda.synchronize()
        plain_ms = start.elapsed_time(stop)
        err, nbad, dead = judge(got, want, x, block, aff, m_rows, precision, sqn=sqn,
                                n_real=n_real, max_differ=max_differ,
                                **{**masks, "select": select})
        del want
        b_ms, b_by = bound_ms(T, m_rows, kd, k, precision, bool(masks), row_bytes,
                              partition_work(masks, m_rows))
        self.errs[name] = max(self.errs.get(name, 0.0), err)
        row = name if row is None else row
        if row:
            self.errs[row] = max(self.errs.get(row, 0.0), err)
            self.times[row], self.bounds[row], self.matmul[row] = (ms, plain_ms), (b_ms, b_by), matmul
            self.shapes[row] = f"{T} x {m_rows} x {kd}, k {k}"
        log(f"{name} ({select}) T={T} M={m_rows} kd={kd} k={k}: kernel {ms:.2f} ms, plain "
            f"{plain_ms:.2f} ms, bound {b_ms:.3f} ms ({b_by}), max_abs_err {err:.3e}, near-tie "
            f"id swaps {nbad}, dead slots {dead}")
        return got

    def selects_at(self, stream_kernel, synth, tgts, kwargs):
        """The selection variants at the main path's batch shape, on the
        voice the step reads (zero-transient, no mask): "phase", "packed"
        and "packed3diag" against their twins, timed beside the stream
        kernel in the same run; "phase" must equal "stream" bit for bit;
        the overflow flags counted on the voice and on a copy with planted
        runs (each planted target must raise its flag); and where the step
        ranks in exact f32, the packed top-(n_cand + margin) must hold the
        stream kernel's top-n_cand of every target."""
        from snickery_tpu_torch.ops.topk import preselect_margin
        torch, d = self.torch, synth.device_db
        aff = (d.mean_t, d.std_t, d.sqrt_wt)
        kd = tgts.shape[-1]
        x = ((tgts - d.mean_t) / d.std_t * d.sqrt_wt).reshape(-1, kd).contiguous()
        T, m_rows, precision, n_cand = x.shape[0], d.cut1.shape[0], kwargs["precision"], kwargs["n_cand"]
        k = n_cand + preselect_margin(True, precision, zero_transient=True,
                                      override=kwargs["margin"])

        def kernel(select, block=d.raw, k=k):
            return self.cuda_topk.cuda_topk_preselect(x, block, k, aff, m_rows,
                                                      precision=precision, select=select)

        stream_ms = time_ms(lambda: kernel("stream"), 2)
        log(f"{stream_kernel} (stream) T={T} M={m_rows} kd={kd} k={k}: kernel {stream_ms:.2f} ms "
            f"in this phase")
        i_s, v_s = kernel("stream")
        out = {sel: self.variant_at(sel, x, d.raw, aff, m_rows, k, precision,
                                    self.matmul[stream_kernel], n_real=int(d.n_real), reps=2)
               for sel in ("phase", "packed", "packed3diag")}
        check(torch.equal(out["phase"][0], i_s) and torch.equal(out["phase"][1], v_s),
              f"phase differs from stream at the batch shape ({precision})")
        flags = out["packed3diag"][2]
        clear = flags == 0
        check(torch.equal(out["packed3diag"][0][clear], out["packed"][0][clear])
              and torch.equal(out["packed3diag"][1][clear], out["packed"][1][clear]),
              "an unflagged packed3diag column differs from packed")
        # a copy of the block with runs of 6 near-duplicates, each inside one
        # 128-row block, under every 16th target
        run_len, planted = 6, torch.arange(0, T, 16, device=x.device)
        blocks = torch.randperm(m_rows // 128, device=x.device,
                                generator=torch.Generator(device=x.device).manual_seed(6))[:len(planted)]
        rows = blocks[:, None] * 128 + 8 + torch.arange(run_len, device=x.device)[None, :]
        near = x[planted][:, None, :] + 1e-3 * torch.arange(1, run_len + 1, device=x.device)[
            None, :, None]
        piled = d.raw.clone()
        piled[rows, :kd] = near / d.sqrt_wt * d.std_t + d.mean_t
        back = (piled[rows, :kd] - d.mean_t) / d.std_t * d.sqrt_wt
        piled[rows, kd] = (back * back).sum(-1)
        flags_p = kernel("packed3diag", piled)[2]
        del piled
        check(bool(flags_p[planted].all()), "a planted run did not raise its overflow flag")
        log(f"packed3diag overflow at {precision} k={k}: {int(flags.sum())}/{T} targets on the "
            f"voice, {int(flags_p.sum())}/{T} on the copy with {len(planted)} planted runs of "
            f"{run_len} (packed3 falls back to the stream kernel where any is set)")
        if precision == "highest":
            top = kernel("stream", k=n_cand)[0]
            held_in = (top[:, :, None] == out["packed"][0][:, None, :]).any(-1)
            cover = float(held_in.float().mean())
            log(f"packed top-{k} covers the stream top-{n_cand}: {cover:.6f} of the slots, "
                f"{int(held_in.all(1).sum())}/{T} targets")
            check(bool(held_in.all()), f"packed top-{k} misses a stream top-{n_cand} row")


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


def device_stages(step):
    """{stage: device ms} of ``step(timer)``, its stages timed on the card's
    stream while ``torch.profiler`` records."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from snickery_tpu_torch import utils
    timer = utils.StageTimer()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        step(timer)
        torch.cuda.synchronize()
    return {k: round(1e3 * s, 3) for k, (s, _) in timer.device_times().items()}


def stage_split(label, synth, tgts, lengths, kwargs):
    from snickery_tpu_torch.synth import synth_pipeline_step
    with Phase(f"{label} per-stage split (device time of each stage's span)"):
        split = device_stages(lambda timer: synth_pipeline_step(
            synth.device_db, tgts, lengths, timer=timer, **kwargs))
        log("stages ms: " + json.dumps(split))


def check_result(db, res):
    ids = res["unit_ids"]
    check(len(ids) == res["n_units"], "one id per unit")
    check(bool(((ids >= 0) & (ids < db.n_units)).all()), "ids in range")
    check(np.isfinite(res["total_cost"]), "finite cost")
    check(len(res["wave"]) > 0 and bool(np.isfinite(res["wave"]).all()), "finite audio")


def config3_voice(cfg):
    """The config-3 voice (numpy): (db, a corpus utterance's features, 32
    held-out utterances of T_BUCKET units, a held-out one of 256)."""
    from snickery_tpu_torch.voicedb.build import build_voicedb
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
    return db, natural, held, short


def config3(run: Run):
    torch = run.torch
    from snickery_tpu_torch import Synthesiser

    cfg = smoke_config(length_buckets=[T_BUCKET])
    db, natural, held, short = config3_voice(cfg)
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
    with Phase("config-3 selection variants at the batch shape"):
        run.selects_at("topk_preselect_zt", synth, tgts, kwargs)
    with Phase("config-3 held-out utterance vs float64 oracle (full DB)"):
        agree, _ = oracle_check(db, synth, short.features, "highest")
        check(agree >= 0.99, f"oracle agreement {agree} < 0.99")
    with Phase("config-3 B=32 lattice for phase 31"):
        lattice = batch_lattice(synth, tgts, lengths, kwargs)
    return db, held, short, out32, lattice


def batch_lattice(synth, tgts, lengths, kwargs) -> dict:
    """The lattice one ``synth_pipeline_step`` of these inputs decodes (its
    preselect and rescore, ``synth._candidates``), in
    ``kernel_check.run_decode``'s form: target costs (B, T, n), join
    contexts (B, T, n, dj), lengths on the card, and the step's jcw,
    epsilon and join type."""
    from snickery_tpu_torch.synth import _candidates
    kw = kwargs
    _, cand, tc, jl, jr = _candidates(
        synth.device_db, tgts, lengths, kw["tgt_codes"], kw["tgt_ctx"], kw["tgt_vids"],
        n_cand=kw["n_cand"], margin=kw["margin"], halfphone=kw["halfphone"],
        multivoice=kw["multivoice"], ling_weights=kw["ling_weights"],
        precision=kw["precision"], zero_transient=kw["zero_transient"])
    B, T = tgts.shape[:2]
    n, dj = cand.shape[1], jl.shape[-1]
    return dict(kind="viterbi", tc=tc.reshape(B, T, n).contiguous(),
                jl=jl.reshape(B, T, n, dj).contiguous(), jr=jr.reshape(B, T, n, dj).contiguous(),
                length=lengths, jcw=float(kw["jcw"]), eps=float(kw["eps"]),
                squared=bool(kw["squared_joins"]), special=None)


_ORACLE_IDS: dict = {}      # (voice, n_candidates, target bytes) -> the oracle's ids


def oracle_check(db, synth, feats, label, batch=False):
    """A held-out utterance through ``synth`` (``synth_from_features``, or
    with ``batch`` a ``synth_batch`` of it alone: the mesh route) against the
    float64 oracle over the full DB, whose ids are computed once per voice
    and utterance; returns (raw agreement, relative f64 path-cost gap)."""
    from snickery_tpu_torch import oracle
    res = synth.synth_batch([feats])[0] if batch else synth.synth_from_features(feats)
    tgt, n = synth.targets_from_features(feats)
    tw_o = (((tgt - db.mean_target) / db.std_target) * synth._sqrt_wt).astype(np.float32)
    key = (db.n_units, synth.cfg.n_candidates, tw_o.tobytes())
    if key not in _ORACLE_IDS:
        feats_w = db.normalised_features().astype(np.float32) * synth._sqrt_wt[None, :]
        jl, jr = db.normalised_joins()
        _ORACLE_IDS[key], _ = oracle.synth_pipeline(
            tw_o, feats_w, (jl * synth._sqrt_wj).astype(np.float32),
            (jr * synth._sqrt_wj).astype(np.float32), n_candidates=synth.cfg.n_candidates,
            join_cost_weight=JCW, fast_preselect=True)
    ids_ref = _ORACLE_IDS[key]
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
    with Phase("config-3 split3cat selection variants at the batch shape"):
        run.selects_at("topk_preselect_zt_split3cat", synth, tgts, kwargs)
    with Phase("config-3 split3cat held-out utterance vs float64 oracle (full DB)"):
        agree, gap = oracle_check(db, synth, short.features, "split3cat")
        check(agree >= 0.99, f"split3cat oracle agreement {agree} < 0.99")
        check(gap <= 1e-4, f"split3cat f64 path-cost gap {gap} > 1e-4")
    ids = run.main_path("config 4", "topk_preselect_zt_split3cat",
                        lambda: config4(db, synth, held[0]), decode=("greedy_decode_stream",))
    config4_checks(run, synth, held[0], ids)
    return out


def config3_derived(run: Run, db, held, short, out_highest):
    """Config 3 at ``zero_transient: 0`` (the derived operand): B = 32 x 2048
    at "highest" (k = n_candidates, no margin) and at split3cat, each with
    its stage split (derive included), the kernel against its twin, the
    held-out utterance against the float64 oracle and agreement with the
    zero-transient "highest" batch; one config-4 stream at split3cat; one
    B = 8 step at split3."""
    torch = run.torch
    from snickery_tpu_torch import Synthesiser

    feats = [u.features for u in held[:32]]
    ids_h = np.concatenate([r["unit_ids"] for r in out_highest])
    for precision in ("highest", "split3cat"):
        kernel = run.cuda_topk.kernel_name(False, False, precision, zero_transient=False)
        label = f"config-3 zero_transient 0 {precision}"
        cfg = smoke_config(length_buckets=[64, T_BUCKET], preselect_precision=precision,
                           zero_transient=0)
        with Phase(f"{label} Synthesiser(device='cuda')"):
            synth = Synthesiser(cfg, db=db, device="cuda")
            torch.cuda.synchronize()

        def drive():
            with Phase(f"{label} main path: synth_batch B=32 x T={T_BUCKET}"):
                out = timed_batch(torch, synth, 2, feats)
                for res in out:
                    check_result(db, res)
            return out

        out = run.main_path(label, kernel, drive)
        raw, adj = tie_adjusted_agreement(
            db, np.concatenate([r["unit_ids"] for r in out]), ids_h)
        log(f"{label} vs the zero-transient highest batch over {ids_h.size} units: "
            f"raw {raw:.5f}, tie-adjusted {adj:.5f}")
        check(adj >= 0.999, f"{label}: tie-adjusted agreement with highest {adj} < 0.999")
        tgts, lengths, kwargs = synth.batch_inputs([synth.targets_from_features(f)
                                                    for f in feats])
        stage_split(f"{label} B=32", synth, tgts, lengths, kwargs)
        with Phase(f"{label} kernel vs plain at main-path shapes"):
            run.kernel_at(kernel, synth, tgts, kwargs, (T_BUCKET, 32 * T_BUCKET))
        with Phase(f"{label} held-out utterance vs float64 oracle (full DB)"):
            agree, gap = oracle_check(db, synth, short.features, label)
            check(agree >= 0.99, f"{label}: oracle agreement {agree} < 0.99")
            check(gap <= 1e-4, f"{label}: f64 path-cost gap {gap} > 1e-4")
        if precision == "split3cat":
            ids = run.main_path("config 4 zero_transient 0", kernel,
                                lambda: config4(db, synth, held[0], ("epoch-rate",)),
                                decode=("greedy_decode_stream",))
            config4_checks(run, synth, held[0], ids, kernel)
        del synth
        torch.cuda.empty_cache()
    label = "config-3 zero_transient 0 split3"
    synth = Synthesiser(smoke_config(length_buckets=[T_BUCKET], preselect_precision="split3",
                                     zero_transient=0), db=db, device="cuda")

    def drive8():
        with Phase(f"{label} main path: synth_batch B=8 x T={T_BUCKET}"):
            return timed_batch(torch, synth, 1, feats[:8])

    kernel = "topk_preselect_dv_split3"
    out = run.main_path(label, kernel, drive8)
    raw, adj = tie_adjusted_agreement(db, np.concatenate([r["unit_ids"] for r in out]),
                                      ids_h[:8 * T_BUCKET])
    log(f"{label} vs the zero-transient highest batch: raw {raw:.5f}, tie-adjusted {adj:.5f}")
    check(adj >= 0.999, f"{label}: tie-adjusted agreement with highest {adj} < 0.999")
    tgts, _, kwargs = synth.batch_inputs([synth.targets_from_features(f) for f in feats[:8]])
    with Phase(f"{label} kernel vs plain at main-path shape"):
        run.kernel_at(kernel, synth, tgts, kwargs, (8 * T_BUCKET,))


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


def config4(db, synth, utt, rates=("fixed-rate", "epoch-rate")):
    """Streaming on the config-3 voice at split3cat: fixed-rate 5 ms frames
    and (or only) epoch-rate units, chunks of STREAM_CHUNK, bucket 64;
    returns the last stream's unit ids."""
    from snickery_tpu_torch.features.world import resample_to_fixed

    fs, taper = 0.005, synth.cfg.taper_length
    fixed = resample_to_fixed(utt.features, utt.epochs, SR, fs)
    feats = utt.features[1:-1]
    def chunked(x):
        return [x[i:i + STREAM_CHUNK] for i in range(0, len(x), STREAM_CHUNK)]

    inputs = {"fixed-rate": (chunked(fixed), dict(fixed_frameshift=fs)),
              "epoch-rate": (chunked(feats), {})}
    for label in rates:
        chunks, kw = inputs[label]
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


def config4_checks(run: Run, synth, utt, ids, kernel="topk_preselect_zt_split3cat"):
    """After the config-4 main path: the epoch-rate stream's ids against
    one-shot greedy, one chunk's device stage split, and the kernel against
    its twin on the last chunk's targets (the streaming shape, T = 64)."""
    from snickery_tpu_torch.synth import streaming_step

    with Phase("config-4 streamed vs synth_from_features(greedy=True)"):
        ref = run.main_path(
            "greedy_search", kernel,
            lambda: synth.synth_from_features(utt.features, greedy=True)["unit_ids"],
            decode=("greedy_decode",))
        agree = float((ids == ref).mean()) if len(ids) == len(ref) else 0.0
        log(f"epoch-rate streamed ids vs one-shot greedy: {len(ids)} vs {len(ref)} units, "
            f"agreement {agree:.5f}")
        check(agree >= 0.99, f"streamed-vs-greedy agreement {agree} < 0.99")
    with Phase("config-4 one chunk's device stage split (device time of each stage's span)"):
        args, kwargs = synth._last_stream_step
        split = device_stages(lambda timer: streaming_step(*args, timer=timer, **kwargs))
        log(f"chunk of {args[2]} units (bucket {args[1].shape[0]}), stages ms: "
            + json.dumps(split))
    with Phase("config-4 kernel vs plain at the streaming shape"):
        kw = dict(kwargs, tgt_codes=None, tgt_ctx=None, tgt_vids=None, halfphone=False,
                  ling_weights=None)
        run.kernel_at(kernel, synth, args[1], kw, (args[1].shape[0],), report=False,
                      matmul=True)


# ------------------------------------------------------------------ decodes
def no_sync(torch, fn):
    """``fn()`` under ``torch.cuda.set_sync_debug_mode("error")``: a host
    synchronisation inside it raises."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        return fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")


def decode_at(run: Run, name: str, lat: dict, live_steps: int, out_bytes: int, smi: str,
              reps: int = 5, sync_free: bool = False):
    """One decode kernel against its plain version at a main path's shape
    (``kernel_check.run_decode`` / ``judge_decode``, bit-identical twice),
    both timed with CUDA events, the bound from this lattice's live steps;
    with ``sync_free`` the first call runs under :func:`no_sync`."""
    from snickery_tpu_torch.kernel_check import decode_bound_ms, judge_decode, run_decode
    torch = run.torch
    got = no_sync(torch, lambda: run_decode(lat)) if sync_free else run_decode(lat)
    again = run_decode(lat)
    check(all(torch.equal(a, b) for a, b in zip(got, again)), f"{name}: two runs differ")
    err, n_diff = judge_decode(lat, got, run_decode(lat, plain=True))
    ms = time_ms(lambda: run_decode(lat), reps)
    plain_ms = time_ms(lambda: run_decode(lat, plain=True), 1)
    n, dj = lat["tc"].shape[-1], lat["jl"].shape[-1]
    b_ms, b_by = decode_bound_ms(lat["kind"], live_steps, n, dj, out_bytes)
    shape = (f"{' x '.join(map(str, lat['tc'].shape))} x {dj}, {live_steps} live steps"
             + (", under set_sync_debug_mode('error')" if sync_free else ""))
    run.errs[name] = max(run.errs.get(name, 0.0), err)
    run.times[name], run.bounds[name] = (ms, plain_ms), (b_ms, b_by)
    run.matmul[name], run.shapes[name] = None, shape
    log(f"{name} at {shape}: kernel {ms:.3f} ms, plain {plain_ms:.2f} ms, bound {b_ms:.3f} ms "
        f"({b_by}), max |total diff| {err:.3e}, paths differing {n_diff} [{smi}]")


def decode_phase(run: Run, lat: dict, smi: str) -> None:
    """Phase 31: the three decode kernels against their plain versions, on
    ``kernel_check.DECODE_CASES`` (each also at every forced cluster size,
    bit-equal to the default plan), the ``kernel_ab`` Viterbi cases' digests
    against the first decode kernels', and at config 3's batch lattice ``lat``
    (phase 5's B = 32 x 2048 step: Viterbi and greedy over it, its first
    utterance cut to 650 steps for the single-utterance Viterbi, and a
    config-4-shaped chunk of it, T = 64 with 32 live steps, for the stream
    kernel), the Viterbi and the stream call under set_sync_debug_mode
    ("error")."""
    from snickery_tpu_torch import kernel_ab
    from snickery_tpu_torch.kernel_check import DECODE_CASES, DECODE_CLUSTERS, run_decode_case
    kernel_of = {"viterbi": "viterbi_decode", "greedy": "greedy_decode",
                 "stream": "greedy_decode_stream"}
    with Phase("decode kernels vs plain, cases, at every cluster size"):
        for name, case in DECODE_CASES.items():
            err, n_diff = run_decode_case(name, "cuda", DECODE_CLUSTERS)
            kernel = kernel_of[case[0]]
            run.errs[kernel] = max(run.errs.get(kernel, 0.0), err)
            log(f"{name} ({kernel}, B={case[1]} T={case[2]} N={case[3]} dj={case[4]}): "
                f"max |total diff| {err:.3e}, paths differing {n_diff}, bit-equal at cluster "
                f"sizes {DECODE_CLUSTERS}")
    with Phase("digests of kernel_ab's decode cases against the first decode kernels"):
        for line in kernel_ab.run_decode_cases("chip_smoke", 3):
            got = (line["paths_sha256"], line["totals_sha256"])
            want = kernel_ab.PR13_DECODE_DIGESTS[line["case"]]
            log(f"{line['case']} ({line['kind']}, {line['B']} x {line['T']} x {line['N']} x "
                f"{line['dj']}, eps {line['eps']}): {line['ms']:.3f} ms, sha256 of paths "
                f"{got[0]}, of totals {got[1]}; the first kernels': {want[0]}, {want[1]} "
                f"[{smi}]")
            if line["kind"] == "viterbi":      # the Viterbi kept their summation order
                check(got == want, f"{line['case']}: digests differ from the first kernels'")
    B, T = lat["tc"].shape[:2]
    live = int(lat["length"].clamp(1, T).sum())
    with Phase("decode kernels at config 3's batch lattice"):
        decode_at(run, "viterbi_decode", lat, live, B * T * 8 + B * 4, smi, sync_free=True)
        decode_at(run, "greedy_decode", dict(lat, kind="greedy"), live, B * T * 8 + B * 4, smi)
        one = dict(lat, tc=lat["tc"][:1, :SINGLE_STEPS].contiguous(),
                   jl=lat["jl"][:1, :SINGLE_STEPS].contiguous(),
                   jr=lat["jr"][:1, :SINGLE_STEPS].contiguous(),
                   length=lat["length"][:1].clamp(max=SINGLE_STEPS).contiguous())
        one_live = int(one["length"].clamp(1).sum())
        decode_at(run, SINGLE_ROW, one, one_live, SINGLE_STEPS * 8 + 4, smi, reps=20,
                  sync_free=True)
        chunk = dict(kind="stream", tc=lat["tc"][0, :64].contiguous(),
                     jl=lat["jl"][0, :64].contiguous(), jr=lat["jr"][0, :64].contiguous(),
                     init_ctx=lat["jr"][1, 0, 0].contiguous(), jcw=lat["jcw"],
                     jcw_first=lat["jcw"], n_live=STREAM_CHUNK, squared=lat["squared"],
                     special=None)
        decode_at(run, "greedy_decode_stream", chunk, STREAM_CHUNK,
                  64 * 8 + 4 * chunk["jl"].shape[-1], smi, reps=20, sync_free=True)


# ------------------------------------------------------------- overlap-add
def ola_inputs(torch, row: str):
    """The wrapper's arguments of one :data:`OLA_ROWS` row on the card
    (``kernel_ab.ola_case``; the stream row the epoch case's first
    utterance cut to a chunk: T = 64, STREAM_CHUNK live, ``out_len`` as
    ``synth_streaming`` sets it), with its fragment and output samples."""
    from snickery_tpu_torch import kernel_ab
    c = kernel_ab.ola_case(OLA_ROWS[row][0], torch.device("cuda"))
    starts, ends, n_units, out_len = c["starts"], c["ends"], c["n_units"], c["out_len"]
    if row.endswith("@stream"):
        starts, ends = starts[:1, :64].contiguous(), ends[:1, :64].contiguous()
        n_units = torch.full((1,), STREAM_CHUNK, dtype=torch.int64, device=starts.device)
        out_len = -(-(64 * int((c["ends"] - c["starts"]).max()) + 2 * kernel_ab.OLA_TAPER)
                    // 128) * 128
    live = torch.arange(starts.shape[1], device=starts.device)[None, :] < n_units[:, None]
    spans = int(torch.where(live, ends - starts, 0).sum())
    t2 = 2 * kernel_ab.OLA_TAPER
    args = (c["waves"], starts, ends, n_units, c["max_frag"], out_len, kernel_ab.OLA_TAPER,
            c["scale"])
    return args, spans + t2 * int(n_units.sum()), spans + t2 * starts.shape[0]


def ola_phase(run: Run, smi: str) -> None:
    """The overlap-add kernel against ``overlap_add_units_plain`` at each
    :data:`OLA_ROWS` shape (the halfphone and epoch cells' steps and a
    config-4 chunk): bit for bit with the plain version on a CPU copy of the
    same inputs (both sum a sample's fragments in unit order from 0.0), to
    1e-6 of the peak with it on the card (its ``index_add_`` adds in any
    order), one launch a call and no host synchronisation; both timed with
    CUDA events, the bound from ``benchmark/roofline.py``'s
    ``ola_bound_ms``."""
    from benchmark.roofline import ola_bound_ms
    from snickery_tpu_torch.ops import ola
    torch, counts = run.torch, run.cuda_topk.LAUNCH_COUNTS
    with Phase("overlap-add kernel vs plain at the steps' and a chunk's shapes"):
        for row in OLA_ROWS:
            args, frag_samples, out_samples = ola_inputs(torch, row)
            waves, starts = args[0], args[1]
            ola.overlap_add_units(*args)
            before = counts["overlap_add"]
            audio, totals = no_sync(torch, lambda: ola.overlap_add_units(*args))
            check(counts["overlap_add"] == before + 1, f"{row}: not one launch a call")
            cpu = [a.cpu() if isinstance(a, torch.Tensor) else a for a in args]
            want, want_totals = ola.overlap_add_units_plain(*cpu)
            got = audio.cpu()
            check(torch.equal(got.view(torch.int32), want.view(torch.int32))
                  and torch.equal(totals.cpu(), want_totals),
                  f"{row}: the kernel differs from the plain version on the CPU")
            card, _ = ola.overlap_add_units_plain(*args)
            peak = float(waves.abs().max() * args[7])
            card_err = float((card - audio).abs().max())
            check(card_err <= 1e-6 * peak, f"{row}: {card_err} from the plain version on the "
                  f"card (peak {peak})")
            del card
            ms = time_ms(lambda: ola.overlap_add_units(*args), 20)
            plain_ms = time_ms(lambda: ola.overlap_add_units_plain(*args), 3)
            b_ms, b_by = ola_bound_ms(frag_samples, out_samples)
            B, U = starts.shape
            shape = (f"{B} x {U} units ({float(args[3].float().mean()):.1f} live on average), "
                     f"max_frag {args[4]}, out_len {args[5]}, {waves.dtype}".replace("torch.", ""))
            run.errs[row] = float((got - want).abs().max())
            run.times[row], run.bounds[row] = (ms, plain_ms), (b_ms, b_by)
            run.matmul[row], run.shapes[row] = None, shape
            run.launches.setdefault(row, 0)
            log(f"{row} at {shape}: kernel {ms:.4f} ms, plain on the card {plain_ms:.2f} ms, "
                f"bound {b_ms:.4f} ms ({b_by}), bit-equal to the plain version on the CPU, "
                f"{card_err:.3e} from it on the card [{smi}]")
            del args, audio, totals, want, got
            torch.cuda.empty_cache()


# ------------------------------------------------------------------ meshes
def mesh_devices(torch, n: int):
    """(members, how): cards 0..n-1 where the machine has n, else card 0
    repeated n times."""
    if torch.cuda.device_count() >= n:
        return [f"cuda:{i}" for i in range(n)], f"{n} distinct cards"
    return ["cuda:0"] * n, f"card 0 repeated {n} times"


def mesh_synthesiser(run: Run, label, db, n_data, n_db, **over):
    """A Synthesiser on an n_data x n_db mesh of the smoke config (``over``
    on top), its sharded voice placed (timed)."""
    from snickery_tpu_torch import Synthesiser
    torch = run.torch
    devices, how = mesh_devices(torch, n_data * n_db)
    with Phase(f"{label}: Synthesiser on a {n_data}x{n_db} mesh, {how}"):
        synth = Synthesiser(smoke_config(mesh_data=n_data, mesh_db=n_db, **over), db=db,
                            device=devices)
        t0 = time.perf_counter()
        synth.ensure_sharded()
        torch.cuda.synchronize()
        sv = synth._sharded_voice
        log(f"{label}: {synth.n_units_padded} padded units, {sv.m_shard} a shard, n_real "
            f"a shard {[m.n_real.item() for m in sv.members[0]]}; shards placed in "
            f"{time.perf_counter() - t0:.1f} s, "
            + ", ".join(f"{dev}: {sv.nbytes(dev) / 2**20:.1f} MiB"
                        for dev in synth._mesh.distinct()))
    return synth, how


def mesh_batch(run: Run, label, kernel, synth, db, feats, ref, voices=None, steps=2):
    """Phase 28's main path on one mesh: ``steps`` synth_batch steps (the
    first a warm-up) with the counts at 0 before; the kernel and the
    Viterbi kernel must launch once per member a step each and nothing else
    launch; each member's exchange
    payload equals the model rows x k_local x (5 x 4 + 8 dj) bytes; every
    shard contributes units; ids equal the single device's batch ``ref`` of
    the same targets except float64 near-ties (a differing utterance's path
    no dearer in float64 than the single device's, within 1e-6 of it).
    Returns the mesh's line of figures."""
    from snickery_tpu_torch import utils
    from snickery_tpu_torch.ops.topk import preselect_margin
    from snickery_tpu_torch.parallel import sharded
    torch, cfg = run.torch, synth.cfg
    n_mem, kw = synth.mesh_size, ({} if voices is None else {"voices": voices})

    def drive():
        sharded.EXCHANGE_BYTES.clear()
        walls = []
        with Phase(f"{label} main path: synth_batch B={len(feats)} on the mesh"):
            for _ in range(steps):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = synth.synth_batch(feats, **kw)
                torch.cuda.synchronize()
                walls.append(1e3 * (time.perf_counter() - t0))
            # (a launch made as thread-block clusters is counted once more,
            # under "<kernel>.cluster<n>")
            got = {n: c for n, c in run.cuda_topk.LAUNCH_COUNTS.items() if ".cluster" not in n}
            audio_s = sum(len(r["wave"]) for r in out) / SR
            log(f"{label}: ms/step {[round(w, 1) for w in walls]} (the first a warm-up), "
                f"{audio_s:.1f} s audio/step, RTF {walls[-1] / 1e3 / audio_s:.6f}")
            want = {kernel: steps * n_mem, "viterbi_decode": steps * n_mem}
            if cfg.preload_all_waves:
                want["overlap_add"] = steps * n_mem
            check(got == want, f"{label}: launches {got}, want {want}")
            for r in out:
                check_result(db, r)
        return out, walls, dict(sharded.EXCHANGE_BYTES)

    out, walls, xbytes = run.main_path(label, kernel, drive)
    sv, ndb = synth._sharded_voice, max(1, cfg.mesh_db)
    T = utils.bucket_length(max(synth.targets_from_features(f)[1] for f in feats),
                            tuple(cfg.length_buckets))
    k_local = min(cfg.n_candidates + preselect_margin(True, cfg.preselect_precision, False,
                                                      zero_transient=True), sv.m_shard)
    rows = len(feats) // max(1, cfg.mesh_data) * T
    want = rows * k_local * (5 * 4 + 8 * db.join_dim) if ndb > 1 else 0
    per_member = sorted({v // steps for v in xbytes.values()} or {0})
    log(f"{label}: exchange {per_member} bytes a member a step (model {want}: {rows} rows x "
        f"k_local {k_local} x (20 + 8 x {db.join_dim}))")
    check(per_member == [want], f"{label}: exchange payload {per_member} != {want}")
    ids = np.concatenate([r["unit_ids"] for r in out])
    hit = sorted({int(u) // sv.m_shard for u in ids})
    check(hit == list(range(ndb)), f"{label}: only shards {hit} contributed units")
    n_diff = 0
    for f, a, b in zip(feats, out, ref):
        if np.array_equal(a["unit_ids"], b["unit_ids"]):
            continue
        n_diff += 1
        tgt, _ = synth.targets_from_features(f)
        tw = ((tgt - db.mean_target) / db.std_target) * synth._sqrt_wt
        c_m, c_1 = path_cost(db, synth, tw, a["unit_ids"]), path_cost(db, synth, tw, b["unit_ids"])
        check(c_m <= c_1 * (1 + 1e-6), f"{label}: a path dearer than the single device's "
              f"in float64 ({c_m} vs {c_1})")
    raw, adj = tie_adjusted_agreement(db, ids, np.concatenate([r["unit_ids"] for r in ref]))
    log(f"{label}: vs the single device's batch: raw {raw:.5f}, tie-adjusted {adj:.5f}, "
        f"{n_diff} utterances differ (each a float64 near-tie); shards hit {hit}")
    return dict(mesh=f"{cfg.mesh_data}x{ndb}", precision=cfg.preselect_precision,
                kernel=kernel, batch=f"{len(feats)} x {T}", ms_step=walls[-1],
                ms_steps=walls, launches_a_step=n_mem,
                exchange_bytes_a_member=per_member[0], raw_agreement=raw,
                tie_adjusted_agreement=adj, utterances_differing=n_diff, shards_hit=hit)


def shard_kernel_at(run: Run, label, kernel, synth, feats, voices=None):
    """The kernel against its twin at member (0, 0)'s shape (its targets,
    shard 0's rows), timed beside its bound and the matmul yardstick."""
    import types
    from snickery_tpu_torch.parallel.sharded import ShardedVoice
    sv: ShardedVoice = synth._sharded_voice
    vids = None if voices is None else [synth._voice_code(v) for v in voices]
    tgts, _, kwargs = synth.batch_inputs([synth.targets_from_features(f) for f in feats],
                                         None, vids)
    b_local = len(feats) // sv.mesh.shape["data"]
    kwargs = {k: (v[:b_local] if k.startswith("tgt_") else v) for k, v in kwargs.items()}
    with Phase(f"{label}: kernel vs plain at a shard's shape"):
        return run.kernel_at(kernel, types.SimpleNamespace(device_db=sv.members[0][0]),
                             tgts[:b_local], kwargs, (b_local * tgts.shape[1],),
                             report=False, matmul=True)


def meshes_config3(run: Run, db, held, short, out_highest, out_split):
    """Phase 28 on the config-3 voice: (1, 2) at "highest" and (2, 2) at
    split3cat, B = 32 x 2048, against phases 5 and 10; the oracle gate on
    the held-out utterance through each mesh; the kernel at a member's shape;
    ``sharded_norm_stats`` of the voice's features against float64."""
    from snickery_tpu_torch.parallel import sharded_norm_stats
    torch = run.torch
    feats = [u.features for u in held[:32]]
    t_phase = time.perf_counter()
    for (n_data, n_db), precision, kernel, ref in (
            ((1, 2), "highest", "topk_preselect_zt", out_highest),
            ((2, 2), "split3cat", "topk_preselect_zt_split3cat", out_split)):
        label = f"meshes: config 3 {n_data}x{n_db} {precision}"
        synth, how = mesh_synthesiser(run, label, db, n_data, n_db,
                                      length_buckets=[T_BUCKET], preselect_precision=precision)
        line = mesh_batch(run, label, kernel, synth, db, feats, ref)
        with Phase(f"{label}: held-out utterance through the mesh vs float64 oracle"):
            agree, gap = oracle_check(db, synth, short.features, label, batch=True)
            check(agree >= 0.99, f"{label}: oracle agreement {agree} < 0.99")
            check(gap <= 1e-4, f"{label}: f64 path-cost gap {gap} > 1e-4")
        line.update(voice="config 3", devices=how, oracle_agreement=agree, oracle_gap=gap,
                    shard_kernel=shard_kernel_at(run, label, kernel, synth, feats))
        if n_db * n_data == 4:
            with Phase("meshes: sharded_norm_stats of the config-3 features"):
                f32 = db.unit_features
                rows = -(-len(f32) // 4) * 4
                padded = np.zeros((rows, f32.shape[1]), np.float32)
                padded[:len(f32)] = f32
                t0 = time.perf_counter()
                mean, std = sharded_norm_stats(padded, len(f32), mesh=synth._mesh)
                torch.cuda.synchronize()
                ms = 1e3 * (time.perf_counter() - t0)
                s64, ss64 = np.zeros(f32.shape[1]), np.zeros(f32.shape[1])
                for lo in range(0, len(f32), 1 << 17):
                    c = f32[lo:lo + (1 << 17)].astype(np.float64)
                    s64 += c.sum(0)
                    ss64 += (c * c).sum(0)
                m64 = s64 / len(f32)
                sd64 = np.sqrt(ss64 / len(f32) - m64 * m64)
                e_mean = float(np.abs(mean.cpu().numpy() - m64).max())
                e_std = float(np.abs(std.cpu().numpy() / sd64 - 1).max())
                log(f"sharded_norm_stats over {len(f32)} x {f32.shape[1]} on the {n_data}x{n_db} "
                    f"mesh: {ms:.1f} ms (host to card included); max |mean - f64| {e_mean:.3e}, "
                    f"max std rel err {e_std:.3e}")
                check(e_mean <= 1e-4 * (1 + float(np.abs(m64).max())) and e_std <= 1e-3,
                      "sharded_norm_stats disagrees with float64")
                line["norm_stats"] = dict(ms=ms, max_abs_err_mean=e_mean, max_rel_err_std=e_std)
        run.meshes.append(line)
        del synth
        torch.cuda.empty_cache()
    log(f"meshes: the config-3 part took {time.perf_counter() - t_phase:.1f} s")


def meshes_config5(run: Run, db, feats, voices, out_highest):
    """Phase 28 on the config-5 voice: (1, 4) at split3cat, B = 64 mixed
    voices (each shard holds two voices' rows): no leaks, ids against phase
    7's batch, the kernel at a shard's shape."""
    t_phase = time.perf_counter()
    label = "meshes: config 5 1x4 split3cat"
    synth, how = mesh_synthesiser(run, label, db, 1, 4, length_buckets=[256],
                                  voice_name="smokemv", preselect_precision="split3cat")
    kernel = "topk_preselect_zt_split3cat_part"
    line = mesh_batch(run, label, kernel, synth, db, feats, out_highest, voices=voices)
    out = synth.synth_batch(feats, voices=voices)
    leaks = sum(int((db.voice_ids[r["unit_ids"]] != synth._voice_code(v)).sum())
                for r, v in zip(out, voices))
    log(f"{label}: cross-voice leaks {leaks}")
    check(leaks == 0, f"{label}: {leaks} units leaked across voices")
    line.update(voice="config 5", devices=how, leaks=leaks,
                shard_kernel=shard_kernel_at(run, label, kernel, synth, feats, voices))
    run.meshes.append(line)
    log(f"meshes: the config-5 part took {time.perf_counter() - t_phase:.1f} s")


def meshes_dryrun(run: Run) -> None:
    """``parallel.dryrun`` (the JAX dry run's shapes) on 4 members: cards
    0..3 where the machine has them, else card 0 repeated."""
    from snickery_tpu_torch.parallel.dryrun import dryrun_multichip
    devices, how = mesh_devices(run.torch, 4)
    with Phase(f"meshes: parallel.dryrun on 4 members, {how}"):
        got = dryrun_multichip(4, "cuda" if devices[1] != devices[0] else "cuda:0")
        run.meshes.append(dict(voice="dryrun", mesh="2x2", devices=how, **{
            k: v for k, v in got.items() if k != "mesh"}))


def meshes_alone(run: Run) -> None:
    """Phase 28 by itself (a quick call on the card): the config-3 and
    config-5 voices, the single-device batches it is held to (the steps of
    phases 5, 10 and 7 without their other checks), phase 28 and the dry
    run; ends with the meshes' JSON line."""
    from snickery_tpu_torch import Synthesiser
    torch = run.torch
    db, _, held, short = config3_voice(smoke_config(length_buckets=[T_BUCKET]))
    feats = [u.features for u in held]
    refs = []
    for precision in ("highest", "split3cat"):
        with Phase(f"config 3 {precision}: the single-device batch"):
            synth = Synthesiser(smoke_config(length_buckets=[T_BUCKET],
                                             preselect_precision=precision), db=db,
                                device="cuda")
            refs.append(synth.synth_batch(feats))
            del synth
    meshes_config3(run, db, held, short, *refs)
    del db
    torch.cuda.empty_cache()
    cfg5 = smoke_config(length_buckets=[256], voice_name="smokemv")
    db, _, _, feats, voices = config5_voice(cfg5)
    with Phase("config 5: the single-device batch"):
        ref = Synthesiser(cfg5, db=db, device="cuda").synth_batch(feats, voices=voices)
    meshes_config5(run, db, feats, voices, ref)
    meshes_dryrun(run)
    print(json.dumps({"meshes": run.meshes}))


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

    out = run.main_path("capacity", "topk_preselect_zt_split3", drive, ola=False)
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


def config5_voice(cfg, n_voices: int = 8, B: int = 64):
    """The config-5 voice (numpy) and its batch: (db merged from
    ``n_voices`` voices, a corpus utterance of voice v3, 16 held-out
    utterances of 256 units, B of their features round-robin, one voice
    each, round-robin)."""
    from snickery_tpu_torch.voicedb.build import build_voicedb
    from snickery_tpu_torch.voicedb.multivoice import merge_voicedbs
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
    feats = [held[i % len(held)].features for i in range(B)]
    return db, natural, held, feats, [f"v{i % n_voices}" for i in range(B)]


def config5(run: Run):
    torch = run.torch
    from snickery_tpu_torch import Synthesiser

    cfg = smoke_config(length_buckets=[256], voice_name="smokemv")
    n_voices, B = 8, 64
    db, natural, held, feats, voices = config5_voice(cfg, n_voices, B)
    with Phase("config-5 Synthesiser(device='cuda')"):
        synth = Synthesiser(cfg, db=db, device="cuda")
        torch.cuda.synchronize()
        log(f"{synth.n_units_padded} padded units, resident DB "
            f"{synth.device_db.nbytes / 2**20:.1f} MiB, kernel metadata "
            f"{synth.device_db.meta.nbytes / 2**20:.2f} MiB")

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
            "server config 5", "topk_preselect_zt_split3cat_part", drive,
            decode=("viterbi_decode", "greedy_decode_stream"))
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
                      (args[1].shape[0],), report=False, matmul=True)
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


def masked_step(run: Run, label, kernel, db, cfg_over, feats, out_highest,
                voices=None, segs=None, precision="split3", zero_transient=-1,
                oracle_gate=False):
    """One synth_batch step at ``precision`` (split3 by default; with
    ``zero_transient=0`` on the derived operand) on a masked voice: no
    leaks, tie-adjusted agreement with the "highest" step on the same
    inputs and, with ``oracle_gate`` (a halfphone voice), the identity
    match and the float64 path-cost gap of the first utterance."""
    torch = run.torch
    from snickery_tpu_torch import Synthesiser
    synth = Synthesiser(smoke_config(preselect_precision=precision,
                                     zero_transient=zero_transient, **cfg_over),
                        db=db, device="cuda")
    if zero_transient == 0:
        label = f"{label} zero_transient 0"

    def drive():
        with Phase(f"{label} {precision} main path: synth_batch B={len(feats)}"):
            return timed_batch(torch, synth, 1, feats, voices=voices, segments_list=segs)

    out = run.main_path(f"{label} {precision}", kernel, drive)
    for r in out:
        check_result(db, r)
    if voices is not None:
        leaks = sum(int((db.voice_ids[r["unit_ids"]] != synth._voice_code(v)).sum())
                    for r, v in zip(out, voices))
        log(f"{label} {precision}: cross-voice leaks {leaks}")
        check(leaks == 0, f"{label} {precision}: {leaks} units leaked across voices")
    if oracle_gate:
        match = identity_match(synth, db, out, segs)
        log(f"{label} {precision}: halfphone identity match {match:.4f}")
        check(match >= 0.95, f"{label} {precision}: identity match {match} < 0.95")
        halfphone_oracle_gap(db, synth, feats[0], segs[0], out[0]["unit_ids"],
                             f"{label} {precision}")
    raw, adj = tie_adjusted_agreement(db, np.concatenate([r["unit_ids"] for r in out]),
                                      np.concatenate([r["unit_ids"] for r in out_highest]))
    log(f"{label}: {precision} vs highest over {sum(len(r['unit_ids']) for r in out)} "
        f"units: raw {raw:.5f}, tie-adjusted {adj:.5f}")
    check(adj >= 0.999, f"{label}: {precision} tie-adjusted agreement {adj} < 0.999")
    if segs is None:
        prepped = [synth.targets_from_features(f) for f in feats]
    else:
        prepped = [(f, len(f)) for f in feats]
    tgts, _, kwargs = synth.batch_inputs(
        prepped, segs, None if voices is None else [synth._voice_code(v) for v in voices])
    with Phase(f"{label} {precision}: kernel vs plain at main-path shape"):
        run.kernel_at(kernel, synth, tgts, kwargs, (tgts.shape[0] * tgts.shape[1],))


def derived_steps(run: Run, label, db, cfg_over, feats, out_highest, voices=None,
                  segs=None, oracle_gate=False):
    """One synth_batch step at ``zero_transient: 0`` at each precision on a
    masked voice, through the derived variant of its masks (the gates of
    :func:`masked_step`)."""
    for precision in ("highest", "split3", "split3cat"):
        kernel = run.cuda_topk.kernel_name(voices is not None, segs is not None, precision,
                                           zero_transient=False)
        masked_step(run, label, kernel, db, cfg_over, feats, out_highest, voices=voices,
                    segs=segs, precision=precision, zero_transient=0,
                    oracle_gate=oracle_gate)
        run.torch.cuda.empty_cache()


def server_config5_derived(run: Run, db, feats, voices):
    """The server on the config-5 voice at ``zero_transient: 0`` and
    split3cat: 16 concurrent POST /synth; every response 200, no leaks, ids
    equal to direct calls."""
    from snickery_tpu_torch import Synthesiser

    label = "server config 5 zero_transient 0"
    cfg = smoke_config(length_buckets=[64, 256], voice_name="smokemv",
                       preselect_precision="split3cat", zero_transient=0)
    with Phase(f"{label}: Synthesiser(split3cat) and warm-up"):
        synth = Synthesiser(cfg, db=db, device="cuda")
        httpd, base, thread = start_server(synth, max_batch=16, max_wait_ms=20.0)
        run.torch.cuda.synchronize()
    feats, voices = feats[:16], voices[:16]
    payloads = [synth_payload(f, v) for f, v in zip(feats, voices)]

    def drive():
        with Phase(f"{label} main path: {len(payloads)} concurrent POST /synth"):
            return post_all(base + "/synth", payloads)

    try:
        responses, wall = run.main_path(label, "topk_preselect_dv_split3cat_part", drive)
        log_stats(label, base, httpd, len(payloads), wall)
    finally:
        stop_server(httpd, thread)
    ids = served_ids(label, responses, db, synth, voices)
    direct = [synth.synth_from_features(f, voice=v)["unit_ids"] for f, v in zip(feats, voices)]
    same_as_direct(label, ids, direct)


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


# ------------------------------------------------- voice building (analysis)
VOICE_UTTS = 64          # BASELINE config #1's size: 64 x 6 s, ~6.4 min of 16 kHz speech
VOICE_SEED = 7000        # the corpus seeds 7000..7063; 7999 is held out
VOICE_MIN_UNITS = 40_000     # about 760 epoch units an utterance
ANALYSIS_EPOCHS = 120_000    # bench.py's bulk_analyse group: 120,000 x 1,024-point frames
ANALYSIS_REF_EPOCHS = 4096   # the float64 numpy reference's slice of it
PCM_ATOL = 1.5 / 32768.0     # wavs are 16-bit PCM of audio equal to f32 rounding
BENCH_MINUTES = 60.0        # bench_corpus_prep's default: an hour of audio
STAGE_LINE = re.compile(r"\btrain (\w+)\s+([\d.]+s) \(n=\d+\)")
VOICE_MIN_COVERED = 0.9      # share of the copy's samples held to the corpus spans


def natural_copy_checks(db, ids, audio, wav, taper: int):
    """Natural synthesis of a corpus utterance reconstructs it: the ids are
    its consecutive units, except where the search took a feature-identical
    twin (the preselection ranks equal rows by index), which must be an
    all-silent unit standing for an all-silent one; the audio equals the
    float64 overlap-add of the ids to f32 rounding (the written wav to PCM
    rounding).  Over the whole utterance, each run of its own units equals
    its corpus span sample for sample and each twin is silent (the output
    offset by the twins' lengths, which may differ from the units' they
    stand for), all but the crossfades at the ends of runs, which must
    leave at least VOICE_MIN_COVERED of the samples checked.  Returns (the
    corpus span from the first unit, as long as the audio; the number of
    twins; the share of samples checked; the largest distance there; the
    audio's distance from the overlap-add)."""
    from snickery_tpu_torch.oracle import overlap_add
    natural = ids[0] + np.arange(len(ids))
    twin = ids != natural
    check(bool((db.utt_index[ids] == db.utt_index[ids[0]]).all()),
          "the ids reach into other utterances")
    check(db.unit_features[ids].tobytes() == db.unit_features[natural].tobytes(),
          "the ids are neither consecutive units nor feature-identical twins")
    cut = db.cutpoints
    for j in np.nonzero(twin)[0]:
        for u in (ids[j], natural[j]):
            check(not np.any(db.waves[cut[u, 0]:cut[u, 2]]), f"twin unit {u} is not silent")
    ola = overlap_add(np.asarray(db.waves, np.float64), cut[ids, 1], cut[ids, 2], taper)
    check(len(audio) == len(wav) == len(ola), "audio lengths differ")
    ola_err = float(np.abs(audio - ola).max())
    check(ola_err <= 1e-5 and float(np.abs(wav - ola).max()) <= PCM_ATOL,
          f"audio differs from the overlap-add of its ids by {ola_err}")
    # the output sample of each unit's first corpus sample; the runs of the
    # utterance's own units and each twin alone (what follows a twin in the
    # corpus need not be silent), each compared away from the crossfades
    off = taper + np.concatenate([[0], np.cumsum(cut[ids, 2] - cut[ids, 1])])
    t = np.nonzero(twin)[0]
    ends = np.unique(np.concatenate([[0, len(ids)], t, t + 1]))
    span_err, covered = 0.0, 0
    for a, b in zip(ends[:-1], ends[1:]):
        lo, hi = int(off[a]) + taper, int(off[b]) - taper
        if hi <= lo:
            continue
        want = (np.zeros(hi - lo) if twin[a] else
                db.waves[int(cut[ids[a], 1]) + taper:int(cut[ids[b - 1], 2]) - taper])
        span_err = max(span_err, float(np.abs(audio[lo:hi] - want).max()))
        covered += hi - lo
    share = covered / len(audio)
    check(span_err <= 1e-5, f"audio differs from its corpus spans by {span_err}")
    check(share >= VOICE_MIN_COVERED, f"the span check covers {share:.3f} of the audio")
    ref = tests_module("toycorpus").copy_reference(db, ids, taper, len(audio))
    return ref, int(twin.sum()), share, span_err, ola_err


def median_ms(fn, reps: int = 3):
    """(median wall ms of ``reps`` calls after one warm call, the last result)."""
    out = fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        times.append(1e3 * (time.perf_counter() - t0))
    return float(np.median(times)), out


def voice_corpus(root: str) -> str:
    """64 speech-like utterances of 40 0.15 s segments (``synth_utterance``)
    and one held out, as 16 kHz wavs, and a JSON voice config (mag 60, real
    45, imag 45, lf0 1, as bench.py's; a 16-sample taper, so that the
    crossfades of consecutive units, 32 samples, fit in the shortest unit
    (about a period at the epoch detector's 400 Hz ceiling), and add up to the
    corpus exactly); returns the config's path."""
    from snickery_tpu_torch.io.speech import write_wave
    from snickery_tpu_torch.synthetic_voices import synth_utterance
    wav = os.path.join(root, "wav")
    os.makedirs(wav, exist_ok=True)
    seeds = {f"utt{i:03d}": VOICE_SEED + i for i in range(VOICE_UTTS)}
    seeds["zheld"] = VOICE_SEED + 999          # sorts last: outside n_train_utts
    for name, seed in seeds.items():
        write_wave(synth_utterance(seed, n_segments=40)[0], os.path.join(wav, f"{name}.wav"), SR)
    cfg = dict(workdir=os.path.join(root, "work"), wav_datadir=wav, voice_name="smokevoice",
               stream_list=list(STREAMS), datadims=dict(DATADIMS), sample_rate=SR,
               n_candidates=30, taper_length=16, join_cost_weight=JCW,
               length_buckets=[1024, 2048], n_train_utts=VOICE_UTTS)
    path = os.path.join(root, "voice.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    return path


@functools.lru_cache(maxsize=None)
def tests_module(name: str):
    """``tests/<name>.py`` (``analysis64``: the float64 numpy analysis and
    rules (a) and (b); ``toycorpus``: the copy's corpus span), loaded from
    its path: a package named ``tests`` installed elsewhere would shadow the
    repository's directory, which is no package."""
    import importlib.util
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", f"{name}.py")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def analysis_rules(name: str, card: np.ndarray, cpu: np.ndarray, truth: np.ndarray,
                   strength: np.ndarray | None) -> float:
    """One stream of the card's analysis against the port's CPU analysis of
    the same frames: rule (a) within 1e-3 on the bands within 6 nats of the
    frame's strongest (in the float64 reference), rule (b) no farther from
    the float64 reference than the CPU result, in max and in p99, beyond one
    f32 ulp of the stream's largest value (two roundings of float64 values
    to f32); returns max |card - cpu|."""
    a64 = tests_module("analysis64")
    if strength is not None:
        a64.rule_a(card, cpu, a64.strong(strength))
    ulp = float(np.spacing(np.float32(np.abs(cpu).max())))
    (dg, pg), (dc, pc) = a64.distances(card, truth), a64.distances(cpu, truth)
    check(dg <= dc + ulp and pg <= pc + ulp,
          f"{name}: rule (b) card max / p99 {dg:.3e} / {pg:.3e} against the CPU's "
          f"{dc:.3e} / {pc:.3e}")
    return float(np.abs(card.astype(np.float64) - cpu).max())


def full_width_analysis(waves: list, smi: str, device: str = "cuda") -> None:
    """``magphase_analysis`` and ``world_analysis`` at the group shape of
    bench.py's bulk analysis: the corpus waves joined with 2,048-sample
    zero gaps, repeated and cut to 120,000 epochs; timed on the card (the
    entry point's wall, and the device part alone by CUDA events), held to
    the port's CPU analysis of the same frames everywhere and by rules (a)
    and (b) against a float64 numpy analysis of the first 4,096 epochs."""
    import torch

    from snickery_tpu_torch.features.epochs import detect_epochs_batch
    from snickery_tpu_torch.features.magphase import (bucket_epochs, frame_max_for,
                                                      magphase_analysis,
                                                      magphase_analysis_frames)
    from snickery_tpu_torch.features.world import world_analysis, world_analysis_frames
    a64 = tests_module("analysis64")
    marks = detect_epochs_batch(waves, SR)
    pieces, epochs, off, n_e = [], [], 0, 0
    while n_e < ANALYSIS_EPOCHS:
        for w, e in zip(waves, marks):
            pieces += [w, np.zeros(2048, np.float32)]
            epochs.append(e.astype(np.int64) + off)
            off += len(w) + 2048
            n_e += len(e)
    e = np.concatenate(epochs)[:ANALYSIS_EPOCHS].astype(np.int32)
    wave = np.concatenate(pieces)[: int(e[-1]) + 1024]
    log(f"full-width analysis: {len(e):,} epochs over {len(wave):,} samples "
        f"({len(waves)} utterances, 2,048-sample gaps, repeated)")
    fm = frame_max_for(SR, 50.0)
    dev = torch.device(device)
    w_dev = torch.from_numpy(wave).to(dev)
    e_dev = torch.from_numpy(bucket_epochs(e)).to(dev)
    ref_e = e[:ANALYSIS_REF_EPOCHS]
    inner = slice(1, ANALYSIS_REF_EPOCHS - 1)     # the slice's edge frames see other gaps
    for label, entry, frames, kw, ref_fn, streams in (
            ("magphase_analysis", magphase_analysis, magphase_analysis_frames,
             dict(n_fft=fm, n_mag=60, n_phase=45), a64.magphase64, ("mag", "real", "imag")),
            ("world_analysis", world_analysis, world_analysis_frames,
             dict(n_fft=fm, n_mgc=60, n_bap=5), a64.world64, ("mgc", "bap"))):
        ms, card = median_ms(lambda: entry(wave, e, SR, device=device))

        def device_part():
            frames(w_dev, e_dev, frame_max=fm, sample_rate=SR, **kw)
        dev_ms = time_ms(device_part, 3) if dev.type == "cuda" else float("nan")
        t0 = time.perf_counter()
        cpu = entry(wave, e, SR, device="cpu")
        cpu_s = time.perf_counter() - t0
        truth = ref_fn(wave, ref_e, SR)
        errs = []
        for k in streams:
            check(card[k].shape == cpu[k].shape == (len(e), card[k].shape[1]),
                  f"{label} {k} shape {card[k].shape}")
            check(bool(np.isfinite(card[k]).all()), f"{label} {k} not finite")
            # rule (a)'s strong bands: of the warped magnitude (mag) or of
            # the magnitude under the phase warp (real / imag); the WORLD
            # streams' rule (a) reads the warped log power, below
            strength = truth.get({"mag": "mag", "real": "strength_ph",
                                  "imag": "strength_ph"}.get(k, ""))
            err_all = float(np.abs(card[k].astype(np.float64) - cpu[k]).max())
            check(err_all <= 1e-4, f"{label} {k}: card vs CPU {err_all:.3e} > 1e-4")
            analysis_rules(f"{label} {k}", card[k][:ANALYSIS_REF_EPOCHS][inner],
                           cpu[k][:ANALYSIS_REF_EPOCHS][inner], truth[k][inner],
                           None if strength is None else strength[inner])
            errs.append(f"{k} {err_all:.2e}")
        check(np.array_equal(card["lf0"], cpu["lf0"]), f"{label} lf0 differs")
        if label == "world_analysis":
            from snickery_tpu_torch.features.world import world_log_mel, world_power
            lm = {d: world_log_mel(world_power(torch.from_numpy(wave).to(d), torch.from_numpy(
                bucket_epochs(ref_e)).to(d), fm, fm), 60, SR)[:len(ref_e)].cpu().numpy()
                for d in (device, "cpu")}
            analysis_rules("world_analysis warped log power", lm[device][inner],
                           lm["cpu"][inner], truth["logmel"][inner], truth["logmel"][inner])
        log(f"voice: {label} {len(e):,} x {fm}: {ms:.2f} ms a call (median of 3, entry point "
            f"with transfers), device part {dev_ms:.2f} ms; CPU port {cpu_s:.2f} s; card vs "
            f"CPU max |diff| {', '.join(errs)}; rules (a) and (b) pass [{smi}]")


def port_module(args: list, timeout: int, label: str):
    """``python -m <args>`` in a subprocess: (its standard output's lines,
    all its lines, wall seconds).  The last 8 lines are logged; the exit
    code must be 0 and no line may say that the native epoch detector did
    not build or load (the Python detector would have run)."""
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-m", *args], capture_output=True, text=True,
                         timeout=timeout)
    wall = time.perf_counter() - t0
    lines = (res.stdout + res.stderr).strip().splitlines()
    for line in lines[-8:]:
        log(f"{label}: {line}")
    check(res.returncode == 0, f"{label} exited {res.returncode}")
    check(not any("native build" in x or "cannot load native" in x for x in lines),
          f"{label} fell back to the Python epoch detector")
    return res.stdout.strip().splitlines(), lines, wall


def voice_building(run: Run, smi: str, device: str = "cuda"):
    """Voice building, natural synthesis, resynthesis and the quality report
    through the port's CLI on the card: train (subprocess), the full-width
    analysis, natural-mode synth of a training and a held-out utterance
    (in process, counted: the preselect kernel), ``resynth_magphase`` and
    ``evaluate`` (subprocess).  Returns (the voice config's path, the ids of
    utt000 and of the held-out utterance)."""
    from snickery_tpu_torch import cli, native
    from snickery_tpu_torch.config import load_config
    from snickery_tpu_torch.features.magphase import magphase_synthesis
    from snickery_tpu_torch.io.speech import read_wave, write_wave
    from snickery_tpu_torch.ops.topk import resolve_zero_transient
    from snickery_tpu_torch.synth import Synthesiser
    from snickery_tpu_torch.train import prepare_utterance
    from snickery_tpu_torch.voicedb.db import VoiceDB
    root = os.path.abspath(os.path.join("build", "chip_smoke", "voice"))
    t_phase = time.perf_counter()
    with Phase("voice: corpus of 64 utterances (6 s each) and the native epoch detector"):
        cfg_path = voice_corpus(root)
        lib = native.get_lib()
        check(lib is not None and lib._name == str(native.lib_path()),
              f"the port's native epoch library did not load ({native.lib_path()})")
        log(f"voice: native epoch library {lib._name}")
    with Phase("voice main path: python -m snickery_tpu_torch.cli train (subprocess)"):
        _, lines, wall = port_module(["snickery_tpu_torch.cli", "train", "-c", cfg_path,
                                      "--device", device], 600, "train")
        stages = dict(m.groups() for m in map(STAGE_LINE.search, lines) if m)
        check(set(stages) == {"prepare_utterance", "build_voicedb", "save"},
              f"train stages {stages}")
        log(f"voice: train wall {wall:.1f} s (subprocess, import and card start included); "
            f"stages {stages} [{smi}]")
    cfg = load_config(cfg_path)
    db = VoiceDB.load(cfg.db_path)
    log(f"voice: {db.summary()}")
    check(db.n_units > VOICE_MIN_UNITS and db.filenames == [f"utt{i:03d}" for i in range(VOICE_UTTS)],
          f"voice holds {db.n_units} units of {len(db.filenames)} utterances")
    with Phase("voice: full-width analysis on the card vs the CPU"):
        waves = [np.asarray(db.waves[db.wave_offsets[i]:db.wave_offsets[i + 1]], np.float32)
                 for i in range(VOICE_UTTS)]
        full_width_analysis(waves, smi, device)
    out = os.path.join(root, "out")
    zt = resolve_zero_transient(cfg.zero_transient, cfg.preselect_precision)
    kernel = run.cuda_topk.kernel_name(False, False, cfg.preselect_precision, zt)
    with Phase("voice main path: natural-mode synth of utt000 and a held-out utterance"):
        rc = run.main_path("natural synth", kernel, lambda: cli.main(
            ["synth", "-c", cfg_path, "-o", out, "--dump-units", "--device", device,
             "utt000", "zheld"]))
        check(rc == 0, f"natural synth exited {rc}")
        ids = np.load(os.path.join(out, "utt000.units.npy"))
        wav, _ = read_wave(os.path.join(out, "utt000.wav"))
        held = np.load(os.path.join(out, "zheld.units.npy"))
    synth = Synthesiser(cfg, db, device=device)
    utt, utt_held = (prepare_utterance(cfg, b, device=device) for b in ("utt000", "zheld"))
    res = synth.synth_from_features(utt.features)
    check(np.array_equal(res["unit_ids"], ids), "direct synth ids differ from the CLI's")
    check(np.array_equal(synth.synth_from_features(utt_held.features)["unit_ids"], held),
          "direct synth ids of zheld differ from the CLI's")
    with Phase("voice: natural synth kernel vs plain at the voice's shape"):
        for u in (utt, utt_held):
            tgts, _, kwargs = synth.batch_inputs([synth.targets_from_features(u.features)])
            run.kernel_at(kernel, synth, tgts, kwargs, (tgts.shape[1],), report=False,
                          matmul=u is utt)
    ref, n_twins, share, span_err, ola_err = natural_copy_checks(db, ids, res["wave"], wav,
                                                                cfg.taper_length)
    log(f"voice: utt000 {len(ids)} units, {len(ids) - n_twins} consecutive and {n_twins} "
        f"feature-identical silent twins; audio vs the corpus spans {span_err:.2e} over "
        f"{share:.4f} of its samples, vs the float64 overlap-add of the ids {ola_err:.2e}; zheld "
        f"{len(held)} units, natural-join share "
        f"{float(np.mean(db.cutpoints[held[1:], 1] == db.cutpoints[held[:-1], 2])):.3f}")
    with Phase("voice: resynth_magphase and copy synthesis"):
        ms, wave_rs = median_ms(lambda: synth.resynth_magphase(ids))
        src = db.cutpoints[ids, 1] - db.wave_offsets[0]
        # the resynthesis epoch grid, as magphase_synthesis integrates it (in
        # the f32 of the lf0 stream: one sample off is 36 degrees at 1.6 kHz)
        lf0 = synth.selected_features(ids)[:, -1]
        p = np.cumsum(np.clip(SR / np.maximum(np.exp(lf0), 1e-3), 2, 2 * SR / 50.0)).astype(
            np.int64)
        lo, hi = 2000, min(len(wave_rs), int(p[-1])) - 2000
        warped = np.interp(np.interp(np.arange(lo, hi), p, src), np.arange(len(utt.wave)),
                           utt.wave)
        corr = float(np.corrcoef(wave_rs[lo:hi], warped)[0, 1])
        check(corr > 0.90, f"resynth_magphase correlation {corr:.3f} <= 0.90")
        streams = {n: utt.features[:, a:b] for n, a, b in cfg.stream_slices}
        copy = magphase_synthesis(streams, SR, n_samples=len(utt.wave),
                                  epoch_samples=utt.epochs, device=device)
        corr_copy = float(np.corrcoef(copy[2000:-2000], utt.wave[2000:-2000])[0, 1])
        check(corr_copy > 0.90, f"copy synthesis correlation {corr_copy:.3f} <= 0.90")
        log(f"voice: resynth_magphase of {len(ids)} units {ms:.2f} ms (median of 3); "
            f"correlation {corr:.4f} with the original on the resynthesis epoch grid; "
            f"copy synthesis on the natural grid {corr_copy:.4f} [{smi}]")
    with Phase("voice main path: python -m snickery_tpu_torch.cli evaluate (subprocess)"):
        ref_dir = os.path.join(root, "ref")
        os.makedirs(ref_dir, exist_ok=True)
        write_wave(ref, os.path.join(ref_dir, "utt000.wav"), SR)
        write_wave(read_wave(os.path.join(cfg.wav_datadir, "zheld.wav"))[0],
                   os.path.join(ref_dir, "zheld.wav"), SR)
        report = os.path.join(root, "report.json")
        t0 = time.perf_counter()
        res = subprocess.run([sys.executable, "-m", "snickery_tpu_torch.cli", "evaluate", "-s",
                              out, "-r", ref_dir, "-o", report, "-c", cfg_path, "--device",
                              device], capture_output=True, text=True, timeout=600)
        wall = time.perf_counter() - t0
        for line in res.stderr.strip().splitlines()[-4:]:
            log(f"evaluate: {line}")
        check(res.returncode == 0, f"evaluate exited {res.returncode}")
        with open(report) as f:
            rows = {r["utterance"]: r for r in json.load(f)["utterances"]}
        check(sorted(rows) == ["utt000", "zheld"], f"evaluate rows {sorted(rows)}")
        check(rows["utt000"]["mcd_db"] < 0.5, f"copy MCD {rows['utt000']['mcd_db']} >= 0.5 dB")
        check(all(v is not None and np.isfinite(v) for k, v in rows["zheld"].items()
                  if k != "utterance"), f"held-out report {rows['zheld']}")
        log(f"voice: evaluate wall {wall:.1f} s (subprocess); utt000 copy {rows['utt000']}; "
            f"held-out {rows['zheld']} [{smi}]")
    log(f"voice: the voice-building phases took {time.perf_counter() - t_phase:.1f} s")
    return cfg_path, ids, held


# ------------------------------------------------------- corpus front end
FRONT_STREAMS = "mag,real,imag,lf0"
FRONT_FRAMESHIFT = 0.005
BENCH_PREFIXES = ("native epoch detector: ", "python epoch detector: ", "magphase analysis: ",
                  "world analysis (mgc/bap): ")
VOICE_ARRAYS = ("cutpoints", "utt_index", "unit_pos", "unit_lf0", "waves", "wave_offsets",
                "unit_features", "join_left", "join_right", "mean_target", "std_target",
                "mean_join", "std_join")


def corpus_front_end(run: Run, smi: str, cfg_path: str, ids, held,
                     device: str = "cuda") -> None:
    """The corpus front end on phase 27's wavs: ``python -m
    snickery_tpu_torch.extract`` (subprocess) into ``voice/feats``, ``cli
    train`` (subprocess) of a second voice from that tree, which must equal
    the wav-trained voice bit for bit, natural synth of utt000 and zheld from
    it (in process, counted), whose ids must equal phase 27's, and
    ``python -m snickery_tpu_torch.bench_corpus_prep`` at its defaults (an
    hour of audio)."""
    from snickery_tpu_torch import cli
    from snickery_tpu_torch.config import load_config
    from snickery_tpu_torch.ops.topk import resolve_zero_transient
    from snickery_tpu_torch.voicedb.db import VoiceDB
    t_phase = time.perf_counter()
    cfg = load_config(cfg_path)
    root = os.path.dirname(cfg_path)
    feats = os.path.join(root, "feats")
    names = sorted(f[:-4] for f in os.listdir(cfg.wav_datadir) if f.endswith(".wav"))
    check(len(names) == VOICE_UTTS + 1, f"{len(names)} wavs")
    streams = FRONT_STREAMS.split(",")
    with Phase("front end main path: python -m snickery_tpu_torch.extract (subprocess)"):
        _, lines, wall = port_module(
            ["snickery_tpu_torch.extract", "-w", cfg.wav_datadir, "-o", feats, "--streams",
             FRONT_STREAMS, "--fixed-frameshift", str(FRONT_FRAMESHIFT), "--device", device],
            600, "extract")
        pms = sorted(f for f in os.listdir(os.path.join(feats, "pm")) if f.endswith(".pm"))
        check(pms == [f"{n}.pm" for n in names], f"{len(pms)} .pm files")
        for sub in streams + [f"fixed/{s}" for s in streams]:
            s = sub.split("/")[-1]
            got = sorted(os.listdir(os.path.join(feats, sub)))
            check(got == [f"{n}.{s}" for n in names], f"{sub}: {len(got)} files")
        check(sum("epochs" in x for x in lines) == len(names), "extract logged no line a wav")
        log(f"front end: extract of {len(names)} wavs (6 s each), streams {FRONT_STREAMS} and "
            f"fixed-rate {FRONT_FRAMESHIFT} s: wall {wall:.1f} s (subprocess, import and card "
            f"start included) [{smi}]")
    with open(cfg_path) as f:
        over = json.load(f)
    over.update(voice_name="smokevoice_extracted", feat_datadir=feats,
                pm_datadir=os.path.join(feats, "pm"))
    cfg_x_path = os.path.join(root, "voice_extracted.json")
    with open(cfg_x_path, "w") as f:
        json.dump(over, f)
    cfg_x = load_config(cfg_x_path)
    with Phase("front end main path: cli train from the extracted tree (subprocess)"):
        _, lines, wall = port_module(["snickery_tpu_torch.cli", "train", "-c", cfg_x_path,
                                      "--device", device], 600, "train")
        stages = dict(m.groups() for m in map(STAGE_LINE.search, lines) if m)
        a, b = VoiceDB.load(cfg.db_path), VoiceDB.load(cfg_x.db_path)
        check(a.filenames == b.filenames and a.n_units == b.n_units,
              f"{b.n_units} units of {len(b.filenames)} utterances against {a.n_units}")
        for name in VOICE_ARRAYS:
            x, y = np.asarray(getattr(a, name)), np.asarray(getattr(b, name))
            check(x.dtype == y.dtype and x.tobytes() == y.tobytes(),
                  f"{name} of the extracted-tree voice differs from the wav-trained voice's")
        log(f"front end: train from the tree wall {wall:.1f} s; stages {stages}; {b.n_units:,} "
            f"units, cutpoints, epochs (unit bounds), waves and features bit-equal to the "
            f"wav-trained voice [{smi}]")
    out = os.path.join(root, "out_extracted")
    zt = resolve_zero_transient(cfg_x.zero_transient, cfg_x.preselect_precision)
    kernel = run.cuda_topk.kernel_name(False, False, cfg_x.preselect_precision, zt)
    with Phase("front end main path: natural synth of utt000 and zheld from that voice"):
        rc = run.main_path("front end natural synth", kernel, lambda: cli.main(
            ["synth", "-c", cfg_x_path, "-o", out, "--dump-units", "--device", device,
             "utt000", "zheld"]))
        check(rc == 0, f"natural synth exited {rc}")
        for name, want in (("utt000", ids), ("zheld", held)):
            got = np.load(os.path.join(out, f"{name}.units.npy"))
            check(np.array_equal(got, want), f"{name}: ids differ from the wav-trained voice's")
        log(f"front end: natural synth ids equal the wav-trained voice's ({len(ids)} and "
            f"{len(held)} units)")
    with Phase("front end: python -m snickery_tpu_torch.bench_corpus_prep (subprocess)"):
        out_lines, _, wall = port_module(
            ["snickery_tpu_torch.bench_corpus_prep", "--minutes", str(BENCH_MINUTES),
             "--device", device], 900, "bench_corpus_prep")
        check(len(out_lines) == 4 and all(x.startswith(p)
                                          for x, p in zip(out_lines, BENCH_PREFIXES)),
              f"bench_corpus_prep printed {out_lines}")
        for line in out_lines:
            log(f"corpus prep ({BENCH_MINUTES} min, {device}): {line} [{smi}]")
        log(f"front end: bench_corpus_prep wall {wall:.1f} s (subprocess)")
    log(f"front end: the corpus front-end phases took {time.perf_counter() - t_phase:.1f} s")


# phase 30: the port's bench, two runs sharing one cache (the second tiles
# nothing of the first: --quick voices are their own)
BENCH_RUNS = (("defaults", ["--modes", "epoch,kernel,streaming"], 900),
              ("quick", ["--quick", "--modes", "me2,capacity,halfphone,multivoice,toy,48k,quality"],
               600))
BENCH_BLOCKS = {"epoch": ("config3",), "kernel": ("kernel_vs_twin",),
                "streaming": ("config4", "config4_natural"), "me2": ("config3_me2",),
                "capacity": ("capacity",), "halfphone": ("config2",), "multivoice": ("config5",),
                "toy": ("config1",), "48k": ("config_48k",), "quality": ("quality_trend",)}
# the block whose steps each stream kernel must have run
BENCH_KERNELS = {"config3": "topk_preselect_zt_split3cat",
                 "config3_me2": "topk_preselect_zt_split3cat",
                 "capacity": "topk_preselect_zt_split3",
                 "config2": "topk_preselect_zt_split3cat_ling",
                 "config5": "topk_preselect_zt_split3cat_part"}
ME2_ROW = "topk_preselect_zt_split3cat@me2"     # the kernels line's row at me2's kd 302


def bench_phase(run: Run, smi: str, device: str = "cuda") -> None:
    """``python -m snickery_tpu_torch.bench`` in two subprocesses sharing the
    cache ``build/chip_smoke/bench``: at its defaults for the epoch, kernel
    and streaming modes (the 1M-unit corpus built on the device, the oracle
    and f32 gates), then ``--quick`` for the other seven.  Both must exit 0
    with every asked-for block, no error and no skip; the config-3 gates,
    ``kernel_vs_twin`` and each block's kernel launches (the bench counts
    them around its timed steps) are checked, and the JAX bench's
    ``BENCH_full.json`` must keep its bytes.  me2's kernel-vs-twin figures at
    kd 302 become a row of the kernels line."""
    import hashlib
    t_phase = time.perf_counter()
    cache = os.path.join("build", "chip_smoke", "bench")
    jax_record = os.path.join(os.path.dirname(os.path.abspath(__file__)), "BENCH_full.json")

    def digest():
        with open(jax_record, "rb") as f:
            return hashlib.sha256(f.read()).hexdigest()

    before = digest()
    extra = {}
    for label, args, timeout in BENCH_RUNS:
        out = os.path.join(cache, f"{label}.json")
        modes = args[args.index("--modes") + 1].split(",")
        with Phase(f"bench main path: python -m snickery_tpu_torch.bench {' '.join(args)} "
                   "(subprocess)"):
            out_lines, _, wall = port_module(["snickery_tpu_torch.bench", *args, "--device",
                                              device, "--cache-dir", cache, "--out", out],
                                             timeout, f"bench {label}")
            line = json.loads(out_lines[-1])
            with open(out) as f:
                full = json.load(f)["extra"]
            check("errors" not in line["extra"] and "skipped" not in line["extra"],
                  f"bench {label}: errors {line['extra'].get('errors')}, skipped "
                  f"{line['extra'].get('skipped')}")
            for mode in modes:
                for block in BENCH_BLOCKS[mode]:
                    check(block in full, f"bench {label}: no {block} block")
            log(f"bench {label} line ({len(out_lines[-1])} chars) [{smi}]: {out_lines[-1]}")
            log(f"bench {label}: wall {wall:.1f} s (subprocess), seconds a mode "
                f"{full['mode_sec']}")
            extra.update(full)
    check(digest() == before, "the bench changed BENCH_full.json")
    c3 = extra["config3"]
    check(c3["agreement_tie_adjusted"] >= 0.99, f"config3 oracle agreement "
          f"{c3['agreement_tie_adjusted']}")
    check(abs(c3["oracle_path_cost_gap_rel"]) <= 1e-4,
          f"config3 oracle path-cost gap {c3['oracle_path_cost_gap_rel']}")
    check(c3["agreement_vs_f32_tie_adjusted"] >= 0.999,
          f"config3 split3cat vs f32 agreement {c3['agreement_vs_f32_tie_adjusted']}")
    check(extra["kernel_vs_twin"] is True, "kernel_vs_twin is not true")
    for block, kernel in BENCH_KERNELS.items():
        per_step = extra[block]["launches_per_step"]
        log(f"bench {block}: kernel launches a step {per_step}")
        for name in (kernel, "viterbi_decode"):
            check(per_step.get(name, 0) > 0, f"bench {block} never launched {name}")
            n = round(per_step[name] * len(extra[block]["step_ms"]))
            if block == "config3_me2" and name == kernel:
                name = ME2_ROW
            run.launches[name] = run.launches.get(name, 0) + n
    me2 = extra["config3_me2"]["kernel_at_shape"]
    check(me2["kd"] == 2 * KD, f"me2 ran the kernel at kd {me2['kd']}")
    b_ms, b_by = bound_ms(me2["T"], me2["m_rows"], me2["kd"], me2["k"], me2["precision"], False)
    run.errs[ME2_ROW] = me2["max_abs_err"]
    run.times[ME2_ROW] = (me2["ms"], me2["plain_ms"])
    run.bounds[ME2_ROW] = (b_ms, b_by)
    run.matmul[ME2_ROW] = me2["matmul_ms"]
    run.shapes[ME2_ROW] = me2["shape"]
    log(f"bench me2 kernel {me2['shape']}: kernel {me2['ms']:.3f} ms, plain "
        f"{me2['plain_ms']:.2f} ms, bound {b_ms:.3f} ms ({b_by}), torch.matmul "
        f"{me2['matmul_ms']:.2f} ms, max_abs_err {me2['max_abs_err']:.3e} [{smi}]")
    log(f"bench: the bench phase took {time.perf_counter() - t_phase:.1f} s")


# phase 32: the preselect kernels swept on the bench's voice (phase 30's cache)
BENCH_CACHE = os.path.join("build", "chip_smoke", "bench")
REAL_COMBOS = ("highest,stream", "split3cat,stream", "split3cat,phase", "split3cat,packed",
               "split3cat,packed3diag", "highest,packed3diag")
REAL_RUNS = tuple((op, order) for op in ("zt", "dv") for order in ("built", "cluster", "scatter")
                  ) + (("raw", "built"),)
REAL_SLICE = 2048        # target rows of the kernel-vs-twin checks on the real rows
REAL_K = 30
# the share of those targets whose ids may differ from the twin's by float64
# near-ties at a packed selection at split3cat (judge's default elsewhere,
# 1%): a packed key drops a score's low 7 bits, and the kernel's split sums
# differ from the twin's by up to ~50 ulp, so two rows within 128 ulp can
# order either way; on the bench's voice ~13% of targets have such a rival at
# rank k (7% an exact tie of bit-identical rows), and 1.1-2.1% flip
REAL_PACKED_DIFFER = 0.05
REAL_ROWS = {"topk_preselect_zt@real": "highest", "topk_preselect_zt_split3cat@real": "split3cat"}
SWEEP_LINE = re.compile(r"^(\w+)\s+(\w+)\s*:\s+([\d.]+) ms(?:\s+overflow (\d+)/(\d+) cols)?$")


def real_sweep_runs(run: Run, smi: str, device: str = "cuda") -> dict:
    """Phase 32's sweeps: ``sweep_topk.main --real`` in process for each
    operand form and order of :data:`REAL_RUNS`, over :data:`REAL_COMBOS`,
    with the counts set to 0 just before each call and read just after;
    every entry point asked for must have launched.  Returns the launches
    of each entry point over all the calls, and logs every line the sweep
    printed beside the card's name and power limit, then all its times as
    one JSON line."""
    import contextlib
    import io
    from snickery_tpu_torch import sweep_topk
    torch, counts = run.torch, run.cuda_topk.LAUNCH_COUNTS
    launches, table = {}, []
    for op, order in REAL_RUNS:
        argv = ["--real", "--cache-dir", BENCH_CACHE, "--db-op", op, "--device", device,
                "--combos", " ".join(REAL_COMBOS)] + ([f"--{order}"] if order != "built" else [])
        with Phase(f"real-row sweep main path: sweep_topk --real --db-op {op}, {order}"):
            out, err = io.StringIO(), io.StringIO()
            counts.clear()
            with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
                rc = sweep_topk.main(argv)
            got = dict(counts)
            for line in (err.getvalue() + out.getvalue()).splitlines():
                if line.strip():
                    log(f"sweep {op} {order}: {line} [{smi}]")
            check(rc == 0, f"sweep_topk --real --db-op {op} ({order}) exited {rc}")
            log(f"sweep {op} {order}: kernel launches {got}")
            for combo in REAL_COMBOS:
                precision, select = combo.split(",")
                name = run.cuda_topk.kernel_name(False, False, precision, op == "zt", select)
                check(got.get(name, 0) > 0, f"the real-row sweep ({op}, {order}) never "
                      f"launched {name}")
            for line in out.getvalue().splitlines():
                m = SWEEP_LINE.match(line.strip())
                if m:
                    table.append(dict(db_op=op, order=order, precision=m[1], select=m[2],
                                      ms=float(m[3]), overflow=None if m[4] is None
                                      else int(m[4]), cols=None if m[5] is None else int(m[5])))
        for name, n in got.items():
            launches[name] = launches.get(name, 0) + n
        torch.cuda.empty_cache()
    check(len(table) == len(REAL_RUNS) * len(REAL_COMBOS), "a sweep line did not parse")
    log(json.dumps({"real_sweep": table, "card": smi}))
    return launches


def real_slice_checks(run: Run, smi: str, launches: dict, device: str = "cuda") -> None:
    """Phase 32's checks on the sweep's data: on the first REAL_SLICE
    held-out targets against the whole DB, as built and k-means-ordered,
    each combination of REAL_COMBOS against its twin (``Run.variant_at``,
    ``kernel_check.judge``; at a packed selection at split3cat up to
    :data:`REAL_PACKED_DIFFER` of the targets may differ by near-ties, 1%
    elsewhere) in both operand forms; at "highest" the stream
    kernel's k scores a target on the clustered DB equal to the as-built
    DB's to f32 rounding, and its ids the same rows through the order, up
    to bit-identical rows (and near the k-th score, where an exact tie
    between two rows goes to the lower index of each order); then the
    kernels line's ``@real`` rows: the stream kernels at the sweep's full
    shape against their twins, with the sweep's launches."""
    from snickery_tpu_torch import sweep_topk
    from snickery_tpu_torch.ops.cuda_topk import derive_operand
    from snickery_tpu_torch.voicedb.db import VoiceDB
    torch = run.torch
    dev = torch.device(device)
    db = VoiceDB.load(sweep_topk.real_voice_path(BENCH_CACHE))
    n, kd = db.n_units, db.target_dim
    with Phase("real rows: held-out targets"):
        targets = torch.from_numpy(sweep_topk.real_targets(db, 16384, dev)).to(dev)
    x = targets[:REAL_SLICE].contiguous()
    highest, yardstick = {}, {}     # "highest,stream" by order; matmul ms by (zt, precision)
    for order in ("built", "clustered"):
        with Phase(f"real rows, {order}: the combinations vs their twins at "
                   f"{REAL_SLICE} x the whole DB"):
            raw, aff, m_rows, perm, how, secs = sweep_topk.real_block(
                db, "zt", order == "clustered", False)
            log(f"real rows {how}: {n} units in {m_rows} rows; k-means {secs:.1f} s (host)")
            raw = torch.from_numpy(raw).to(dev)
            aff = tuple(torch.from_numpy(a).to(dev) for a in aff)
            if order == "built":
                built = (raw, aff, m_rows)
            for zt in (True, False):
                forms = {}
                for precision in ("highest", "split3cat"):
                    rows, row_bytes = raw[:m_rows, :kd], None
                    forms[precision] = dict(block=raw, aff=aff)
                    if not zt:
                        rows, sqn = derive_operand(raw, aff, n, m_rows, precision)
                        row_bytes = rows.shape[1] * rows.element_size() + 4
                        forms[precision] = dict(block=rows, aff=None, sqn=sqn,
                                                row_bytes=row_bytes)
                    if order == "built":        # the yardsticks at the sweep's full shape
                        mm = yardstick[zt, precision] = matmul_ms(targets, rows, precision)
                        b_ms, b_by = bound_ms(len(targets), m_rows, kd, REAL_K, precision,
                                              False, row_bytes)
                        log(f"real rows, {'zt' if zt else 'dv'} {precision} at {len(targets)} "
                            f"x {m_rows} x {kd}, k {REAL_K}: bound {b_ms:.3f} ms ({b_by}), "
                            f"torch.matmul {mm:.2f} ms [{smi}]")
                for combo in REAL_COMBOS:
                    precision, select = combo.split(",")
                    packed = precision != "highest" and select.startswith("packed")
                    got = run.variant_at(select, x, m_rows=m_rows, k=REAL_K,
                                         precision=precision, matmul=None, n_real=n, reps=2,
                                         row="", max_differ=REAL_PACKED_DIFFER if packed
                                         else 0.01, **forms[precision])
                    if zt and combo == "highest,stream":
                        highest[order] = got
                del forms, rows
            del raw
            torch.cuda.empty_cache()
    raw, aff, m_rows = built
    with Phase("real rows: clustered vs as built, highest, stream kernel"):
        (ib, vb), (ic, vc) = highest["built"], highest["clustered"]
        gap = float(((vc - vb).abs() / vb.abs().clamp(min=1.0)).max())
        log(f"highest scores, clustered vs built: max relative difference {gap:.3e}")
        check(gap <= 2 * F32_EPS, f"the clustered DB's scores differ from the built DB's "
              f"by {gap:.3e} (relative)")
        mapped = torch.from_numpy(perm).to(dev)[ic.long()]
        w = torch.randint(1, 2**31 - 1, (kd,), device=dev,
                          generator=torch.Generator(device=dev).manual_seed(32))

        def canon(v, ids):
            # each slot's row as a fingerprint of its bits, ordered by (score, fingerprint)
            f = (raw[ids, :kd].contiguous().view(torch.int32).long() * w).sum(-1)
            o = torch.sort(f, dim=1, stable=True).indices
            v, f = v.gather(1, o), f.gather(1, o)
            o = torch.sort(v, dim=1, stable=True).indices
            return f.gather(1, o)

        inner = vb < vb[:, -1:]       # below the k-th score: no tie at the boundary
        same_rows = canon(vb, ib.long()) == canon(vc, mapped)
        n_same, n_dup = int((mapped == ib.long()).sum()), int((mapped != ib.long()).sum())
        log(f"highest ids, clustered vs built through the order: {n_same} slots the same "
            f"row, {n_dup} another slot or a bit-identical row; {int((~same_rows).sum())} "
            f"slots at the k-th score differ ({int((~same_rows[inner]).sum())} below it)")
        check(bool(same_rows[inner].all()), "a clustered id below the k-th score is no "
              "bit-identical row of the built DB's")
    del highest
    for row, precision in REAL_ROWS.items():
        with Phase(f"real rows: {row} at the sweep's shape"):
            mm = yardstick[True, precision]
            run.variant_at("stream", targets, raw, aff, m_rows, REAL_K, precision, mm,
                           n_real=n, row=row)
            name = run.cuda_topk.kernel_name(False, False, precision)
            run.launches[row] = launches.get(name, 0)
            b_ms, b_by = run.bounds[row]
            log(f"{row}: {run.shapes[row]}: kernel {run.times[row][0]:.3f} ms, twin "
                f"{run.times[row][1]:.2f} ms, bound {b_ms:.3f} ms ({b_by}), torch.matmul "
                f"{mm:.2f} ms, sweep launches {run.launches[row]} [{smi}]")


def real_sweep_phase(run: Run, smi: str, device: str = "cuda") -> None:
    """Phase 32: the preselect kernels swept on the port bench's 1M-unit
    voice (``bench1m`` in :data:`BENCH_CACHE`, built by phase 30)."""
    t_phase = time.perf_counter()
    launches = real_sweep_runs(run, smi, device)
    for name, n in launches.items():
        if name not in STREAM_KERNELS:
            run.launches[name] = run.launches.get(name, 0) + n
    real_slice_checks(run, smi, launches, device)
    run.torch.cuda.empty_cache()
    log(f"real rows: phase 32 took {time.perf_counter() - t_phase:.1f} s")


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
    with Phase("derived operand (zero_transient 0) variants vs plain, synthetic"):
        for name, err in derived_variants_synthetic(torch).items():
            run.errs[name] = max(run.errs.get(name, 0.0), err)
    with Phase("selection variants vs plain, synthetic"):
        for name, err in select_variants_synthetic(torch).items():
            run.errs[name] = max(run.errs.get(name, 0.0), err)
    with Phase("tile edges and queue overflow vs plain, synthetic"):
        edge_cases_synthetic(torch)
    with Phase("digests of kernel_ab's seeded cases against PR 9's kernels"):
        first_design_digests()
    with Phase("kernel sweep (the selection variants' path)"):
        sweep_path(run)
    with Phase("selection variants vs plain at the sweep's small shape"):
        selects_at_sweep_shape(run)
    ola_phase(run, smi)
    db, held, short, out32, lattice = config3(run)
    decode_phase(run, lattice, smi)
    del lattice
    torch.cuda.empty_cache()
    out_split = config3_split3cat(run, db, held, short, out32)
    torch.cuda.empty_cache()
    config3_derived(run, db, held, short, out32)
    torch.cuda.empty_cache()
    meshes_config3(run, db, held, short, out32, out_split)
    capacity(run, db, held)
    del db
    torch.cuda.empty_cache()
    hp_over = dict(target_representation="halfphone", n_candidates=20, length_buckets=[128])
    db, feats, segs, out = config2(run)
    server_halfphone(run, "server config 2", "topk_preselect_zt_split3cat_ling", db,
                     feats, segs, None, True)
    masked_step(run, "config 2", "topk_preselect_zt_split3_ling", db, hp_over, feats,
                out, segs=segs)
    derived_steps(run, "config 2", db, hp_over, feats, out, segs=segs, oracle_gate=True)
    torch.cuda.empty_cache()
    db, feats, voices, out, held = config5(run)
    meshes_config5(run, db, feats, voices, out)
    meshes_dryrun(run)
    torch.cuda.empty_cache()
    synth5 = server_config5(run, db, feats, voices, out, held)
    masked_step(run, "config 5", "topk_preselect_zt_split3_part", db,
                dict(length_buckets=[256]), feats, out, voices=voices)
    derived_steps(run, "config 5", db, dict(length_buckets=[256]), feats, out, voices=voices)
    server_config5_derived(run, db, feats, voices)
    cli_phase(run, db, synth5, feats)
    del synth5
    torch.cuda.empty_cache()
    composition(run, COMP_UTTS)
    torch.cuda.empty_cache()
    db, feats, segs, voices, out = composition(run, HP_UTTS)
    server_halfphone(run, "server composition", "topk_preselect_zt_split3cat_ling_part",
                     db, feats, segs, voices, False)
    masked_step(run, "composition", "topk_preselect_zt_split3_ling_part", db, hp_over,
                feats, out, voices=voices, segs=segs)
    derived_steps(run, "composition", db, hp_over, feats, out, voices=voices, segs=segs)
    del db
    torch.cuda.empty_cache()
    cfg_path, ids, held = voice_building(run, smi)
    torch.cuda.empty_cache()
    corpus_front_end(run, smi, cfg_path, ids, held)
    torch.cuda.empty_cache()
    bench_phase(run, smi)
    real_sweep_phase(run, smi)

    log(f"chip_smoke.py: all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"meshes": run.meshes}))
    replaces = {**REPLACES, **DECODE_REPLACES, **OLA_REPLACES}
    print(json.dumps({"kernels": [{
        "name": name, "route": "cuda", "source": kernel_source(name.split("@")[0]),
        "replaces": replaces[name.split("@")[0]], "launches": run.launches[name],
        "max_abs_err": run.errs[name], "ms": run.times[name][0],
        "plain_ms": run.times[name][1], "bound_ms": run.bounds[name][0],
        "bound_by": run.bounds[name][1], "library_ms": None,
        "matmul_ms": run.matmul[name], "shape": run.shapes[name]}
        for name in (*REPLACES, ME2_ROW, *REAL_ROWS, *DECODE_REPLACES, SINGLE_ROW,
                     *OLA_ROWS)]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (snickery_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # about 75 s of command time on an H100

Phases, each timed, any failure ending the run with a non-zero exit:

1. the card and the versions of torch, CUDA and nvcc;
2. the kernel build from ``snickery_tpu_torch/csrc`` (nvcc, ``sm_90a``);
3. the preselect kernel against its plain PyTorch twin on the card, at
   T in {128, 2048} x M in {8192, 65536}, with duplicated DB rows (ties), and
   with T and M that are not multiples of the kernel tiles;
4. a config-3 voice built with numpy alone: about 3,000 synthetic
   utterances, 1,048,500 epoch units, d = 151 (mag 60, real 45, imag 45,
   lf0 1), 16 kHz, smooth AR(1) feature walks and 80-160-sample periods;
5. the main path through the public API, ``Synthesiser(cfg, db,
   device="cuda")``: ``synth_from_features`` on 3 utterances (one a corpus
   utterance, which must come back as its own units) and ``synth_batch`` at
   B = 8 and B = 32 x T = 2048, with the kernel's launch count read before
   and after, and a per-stage split of one B = 32 step;
6. the kernel against its twin on the voice at the main path's shapes, with
   times;
7. one held-out utterance against the float64 numpy oracle over the full DB.

Standard output ends with a JSON line of the kernels, the card's name and
power limit from nvidia-smi, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

SR = 16000
STREAMS = ["mag", "real", "imag", "lf0"]
DATADIMS = {"mag": 60, "real": 45, "imag": 45, "lf0": 1}
KD = sum(DATADIMS.values())
JCW = 0.7
N_UTTS = 3000
T_BUCKET = 2048
SCORE_ATOL = 1e-3        # |kernel - plain| on scores of ~1e2: f32 sums of
                         # 151 products taken in another order
TIE_RTOL = 1e-5          # a differing id must be an f32 near-tie of the k-th
KERNEL_SOURCE = "snickery_tpu_torch/csrc/topk_preselect.cu"
KERNEL_REPLACES = "snickery_tpu/ops/pallas_topk.py:904"


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


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


def compare(torch, targets, raw, aff, m_rows, k):
    """Kernel vs plain twin on the same card tensors.  Id sets must be equal
    per row, except where the differing ids are f32 near-ties of the k-th
    score (checked in float64); scores of shared ids within SCORE_ATOL.
    Returns (max_abs_err, rows_with_differing_ids)."""
    from snickery_tpu_torch.ops.cuda_topk import (cuda_topk_preselect,
                                                  topk_preselect_zt_plain)
    ik, vk = cuda_topk_preselect(targets, raw, k, aff, m_rows)
    ip, vp = topk_preselect_zt_plain(targets, raw, k, aff, m_rows)
    torch.cuda.synchronize()
    check(bool((ik >= 0).all() and (ik < m_rows).all()), "kernel ids in range")
    check(bool(torch.isfinite(vk).all()), "kernel scores finite")
    ik_s, ok = torch.sort(ik.long(), dim=1)
    ip_s, op = torch.sort(ip.long(), dim=1)
    vk_s, vp_s = torch.gather(vk, 1, ok), torch.gather(vp, 1, op)
    same = (ik_s == ip_s).all(dim=1)
    err = float((vk_s[same] - vp_s[same]).abs().max()) if bool(same.any()) else 0.0
    check(err <= SCORE_ATOL, f"score error {err} > {SCORE_ATOL}")
    bad = torch.nonzero(~same).flatten()
    if len(bad):
        kd = targets.shape[1]
        mean, std, w = (a.double() for a in aff)
        t2 = targets[bad].double() * (w / std)

        def f64(ids):
            rows = raw[ids].double()                       # (nb, k, W)
            return rows[..., kd] - 2.0 * torch.einsum("bkc,bc->bk", rows[..., :kd], t2)

        worst_k, worst_p = f64(ik_s[bad]).max(1).values, f64(ip_s[bad]).max(1).values
        gap = float(((worst_k - worst_p) / worst_p.abs().clamp(min=1.0)).max())
        check(gap <= TIE_RTOL, f"differing ids are not near-ties (gap {gap})")
        check(len(bad) <= 0.01 * targets.shape[0], f"{len(bad)} rows differ")
    return err, int(len(bad))


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
        err, nbad = compare(torch, tg, raw, aff, M, 40)
        worst = max(worst, err)
        log(f"kernel vs plain T={T} M={M} kd={KD} k=40 dup={dup}: "
            f"max_abs_err {err:.3e}, rows with near-tie id swaps {nbad}")
    return worst


# ------------------------------------------------------------- config-3 voice
def make_utterances(rng, n_utts: int, n_epochs, prefix: str):
    """Synthetic epoch-rate utterances (numpy only): a smooth f0 contour gives
    80-160-sample periods; features are an AR(1) walk per utterance (so
    natural joins matter); waves are low-amplitude noise of matching length."""
    from snickery_tpu.voicedb.build import UtteranceData
    n_epochs = np.broadcast_to(np.asarray(n_epochs), (n_utts,))
    E = int(n_epochs.max())
    a = np.float32(0.95)
    x = rng.standard_normal((n_utts, KD), dtype=np.float32)
    feats = np.empty((n_utts, E, KD), np.float32)
    for e in range(E):
        feats[:, e] = x
        x = a * x + np.float32(np.sqrt(1 - a * a)) * rng.standard_normal(
            (n_utts, KD), dtype=np.float32)
    phase = rng.uniform(0, 2 * np.pi, (n_utts, 1))
    rate = rng.uniform(0.005, 0.02, (n_utts, 1))
    periods = np.rint(120 + 40 * np.sin(rate * np.arange(E)[None, :] + phase)).astype(np.int64)
    feats[:, :, -1] = np.log(SR / periods).astype(np.float32)        # lf0
    utts = []
    for u in range(n_utts):
        n = int(n_epochs[u])
        epochs = 160 + np.cumsum(periods[u, :n]) - periods[u, 0]
        wave = 0.05 * rng.standard_normal(int(epochs[-1]) + 200, dtype=np.float32)
        utts.append(UtteranceData(
            basename=f"{prefix}{u:05d}", wave=wave, epochs=epochs.astype(np.int32),
            features=np.ascontiguousarray(feats[u, :n]),
            lf0=feats[u, :n, -1].copy()))
    return utts


def natural_rate(db, ids) -> float:
    return float((np.diff(db.unit_pos[ids]) == 1).mean())


def path_cost(db, synth, tw, ids) -> float:
    f64 = np.float64
    fw = ((db.unit_features[ids] - db.mean_target) / db.std_target) * synth._sqrt_wt
    jl = ((db.join_left[ids] - db.mean_join) / db.std_join) * synth._sqrt_wj
    jr = ((db.join_right[ids] - db.mean_join) / db.std_join) * synth._sqrt_wj
    tc = np.sqrt(((fw.astype(f64) - tw.astype(f64)) ** 2).sum(-1))
    jc = np.sqrt(((jl[1:].astype(f64) - jr[:-1].astype(f64)) ** 2).sum(-1))
    return float(tc.sum() + JCW * jc.sum())


def main() -> int:
    argparse.ArgumentParser(description=__doc__.split("\n\n")[0]).parse_args()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import snickery_tpu_torch  # noqa: F401  (fails where the port is absent)
    from snickery_tpu_torch.ops import _build, cuda_topk

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
            if "registers" in line or "spill" in line:
                log(f"ptxas: {line.strip()}")
    with Phase("kernel vs plain, synthetic"):
        max_err = kernel_vs_plain_synthetic(torch)

    from snickery_tpu import oracle
    from snickery_tpu.config import SnickeryConfig
    from snickery_tpu.voicedb.build import build_voicedb
    from snickery_tpu_torch import Synthesiser
    from snickery_tpu_torch.synth import synth_pipeline_step
    from snickery_tpu import utils

    cfg = SnickeryConfig(
        workdir=os.path.join("build", "chip_smoke"), stream_list=list(STREAMS),
        datadims=dict(DATADIMS), sample_rate=SR, n_candidates=30,
        taper_length=50, join_cost_weight=JCW, length_buckets=[T_BUCKET],
        voice_name="smoke")
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

    with Phase("Synthesiser(device='cuda')"):
        synth = Synthesiser(cfg, db=db, device="cuda")
        torch.cuda.synchronize()
        log(f"{synth.n_units_padded} padded units, resident DB "
            f"{synth.device_db.nbytes / 2**20:.1f} MiB "
            f"(raw block {synth.device_db.raw.nbytes / 2**20:.1f} MiB)")

    def counted(fn, *a):
        before = cuda_topk.LAUNCH_COUNTS[cuda_topk.KERNEL]
        out = fn(*a)
        check(cuda_topk.LAUNCH_COUNTS[cuda_topk.KERNEL] > before,
              f"{fn.__name__} did not launch the kernel")
        return out

    def check_result(res):
        ids = res["unit_ids"]
        check(len(ids) == res["n_units"], "one id per unit")
        check(bool(((ids >= 0) & (ids < db.n_units)).all()), "ids in range")
        check(np.isfinite(res["total_cost"]), "finite cost")
        check(len(res["wave"]) > 0 and bool(np.isfinite(res["wave"]).all()),
              "finite audio")

    cuda_topk.LAUNCH_COUNTS.clear()
    with Phase("main path: synth_from_features x 3"):
        for name, feats in (("corpus utt 0", natural), ("held-out 2048", held[0].features),
                            ("held-out 256", short.features)):
            t0 = time.perf_counter()
            res = counted(synth.synth_from_features, feats)
            check_result(res)
            msg = (f"{name}: {res['n_units']} units, cost {res['total_cost']:.4f}, "
                   f"{len(res['wave'])} samples, {1e3 * (time.perf_counter() - t0):.1f} ms")
            if name.startswith("corpus"):
                rate = natural_rate(db, res["unit_ids"])
                own = float((db.utt_index[res["unit_ids"]] == 0).mean())
                msg += f", natural continuation {rate:.4f}, own-utterance {own:.4f}"
                check(rate >= 0.85, f"natural continuation {rate} < 0.85")
            log(msg)
    step_ms = {}
    for B in (8, 32):
        with Phase(f"main path: synth_batch B={B} x T={T_BUCKET}"):
            feats = [u.features for u in held[:B]]
            counted(synth.synth_batch, feats)                    # warm-up
            walls = []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = counted(synth.synth_batch, feats)
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
            for res in out:
                check_result(res)
            audio_s = sum(len(r["wave"]) for r in out) / SR
            step_ms[B] = 1e3 * float(np.mean(walls))
            log(f"B={B}: {step_ms[B]:.1f} ms/step (steps {[round(1e3 * w, 1) for w in walls]}), "
                f"{audio_s:.1f} s audio/step, RTF {np.mean(walls) / audio_s:.6f}")
    launches = cuda_topk.LAUNCH_COUNTS[cuda_topk.KERNEL]
    log(f"main-path launches of {cuda_topk.KERNEL}: {launches}")
    check(launches > 0, "the main path never launched the kernel")

    prepped = [synth.targets_from_features(u.features) for u in held[:32]]
    tgts, lengths, kwargs = synth.batch_inputs(prepped)
    with Phase("per-stage split, B=32 (synchronised stage edges)"):
        timer = utils.StageTimer()
        synth_pipeline_step(synth.device_db, tgts, lengths, stage_timer=timer, **kwargs)
        log("stages ms: " + json.dumps({k: round(1e3 * v, 1) for k, v in timer.report().items()}))

    with Phase("kernel vs plain at main-path shapes"):
        d = synth.device_db
        aff = (d.mean_t, d.std_t, d.sqrt_wt)
        tw = ((tgts - d.mean_t) / d.std_t * d.sqrt_wt).reshape(-1, KD).contiguous()
        m_rows = d.cut1.shape[0]
        times = {}
        for T in (T_BUCKET, tw.shape[0]):
            x = tw[:T].contiguous()
            err, nbad = compare(torch, x, d.raw, aff, m_rows, 40)
            max_err = max(max_err, err)
            ms = time_ms(torch, lambda: cuda_topk.cuda_topk_preselect(x, d.raw, 40, aff, m_rows), 3)
            plain_ms = time_ms(torch, lambda: cuda_topk.topk_preselect_zt_plain(x, d.raw, 40, aff, m_rows), 1)
            times[T] = (ms, plain_ms)
            log(f"T={T} M={m_rows} kd={KD} k=40: kernel {ms:.2f} ms, plain {plain_ms:.2f} ms, "
                f"max_abs_err {err:.3e}, near-tie id swaps {nbad}")

    with Phase("held-out utterance vs float64 oracle (full DB)"):
        res = synth.synth_from_features(short.features)
        tgt, n = synth.targets_from_features(short.features)
        tw_o = (((tgt - db.mean_target) / db.std_target) * synth._sqrt_wt).astype(np.float32)
        feats_w = db.normalised_features().astype(np.float32) * synth._sqrt_wt[None, :]
        jl, jr = db.normalised_joins()
        ids_ref, _ = oracle.synth_pipeline(
            tw_o, feats_w, (jl * synth._sqrt_wj).astype(np.float32),
            (jr * synth._sqrt_wj).astype(np.float32), n_candidates=cfg.n_candidates,
            join_cost_weight=JCW, fast_preselect=True)
        agree = float((res["unit_ids"] == ids_ref).mean())
        c_dev, c_ref = path_cost(db, synth, tw_o, res["unit_ids"]), path_cost(db, synth, tw_o, ids_ref)
        log(f"{n} held-out units: raw agreement {agree:.5f}, f64 path cost "
            f"{c_dev:.6f} vs oracle {c_ref:.6f} (gap {(c_dev - c_ref) / abs(c_ref):+.3e})")
        check(agree >= 0.99, f"oracle agreement {agree} < 0.99")

    ms, plain_ms = times[tw.shape[0]]
    print(json.dumps({"kernels": [{
        "name": cuda_topk.KERNEL, "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES, "launches": launches, "max_abs_err": max_err,
        "ms": ms, "plain_ms": plain_ms}]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The port on a CUDA card: the preselect kernel against its plain twin, and
the synthesiser on the card against the same synthesiser on the CPU.

Marked ``cuda``; each test skips where no card is visible.  This file
imports no jax, so it also runs on a GPU host without jax, where the
repository's conftest (which configures jax) is left out:

    python -m pytest -m cuda --noconftest -p no:cacheprovider tests/test_torch_cuda_kernel.py
"""

import numpy as np
import pytest
import torch

from snickery_tpu.config import SnickeryConfig
from snickery_tpu.voicedb.build import UtteranceData, build_voicedb
from snickery_tpu.voicedb.device_layout import build_raw_blocks
from snickery_tpu_torch.ops import cuda_topk
from snickery_tpu_torch.ops.cuda_topk import (cuda_topk_preselect,
                                              topk_preselect_zt_plain)
from snickery_tpu_torch.synth import Synthesiser

KD = 151


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run this file on the GPU host)")
    return torch.device("cuda")


def _block(seed, M, dup):
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((M, KD)).astype(np.float32)
    if dup:
        feats[100:140] = feats[50]
    jr = np.zeros_like(feats)
    jr[:-1] = feats[1:]
    aff = ((0.1 * rng.standard_normal(KD)).astype(np.float32),
           rng.uniform(0.5, 2.0, KD).astype(np.float32),
           rng.uniform(0.2, 1.0, KD).astype(np.float32))
    raw, _, _ = build_raw_blocks(feats, jr, M, affine=aff)
    return rng, raw, aff


@pytest.mark.cuda
@pytest.mark.parametrize("T,M,dup", [(128, 8192, False), (300, 8229, False),
                                     (256, 8192, True), (2048, 65536, False)])
def test_kernel_matches_plain(cuda_device, T, M, dup):
    """Same card tensors through the kernel and the twin: id sets equal,
    lowest index first among the duplicated rows, scores within 1e-3 (f32
    sums of 151 products, possibly in another order)."""
    rng, raw, aff = _block(T + M, M, dup)
    tg = torch.from_numpy(rng.standard_normal((T, KD)).astype(np.float32)).to(cuda_device)
    R = torch.from_numpy(raw).to(cuda_device)
    A = tuple(torch.from_numpy(a).to(cuda_device) for a in aff)
    before = cuda_topk.LAUNCH_COUNTS[cuda_topk.KERNEL]
    ki, kv = cuda_topk_preselect(tg, R, 40, A, M)
    assert cuda_topk.LAUNCH_COUNTS[cuda_topk.KERNEL] == before + 1
    pi, pv = topk_preselect_zt_plain(tg, R, 40, A, M)
    torch.cuda.synchronize()
    ks, ko = torch.sort(ki.long(), 1)
    ps, po = torch.sort(pi.long(), 1)
    assert torch.equal(ks, ps)
    torch.testing.assert_close(torch.gather(kv, 1, ko), torch.gather(pv, 1, po),
                               rtol=0, atol=1e-3)
    assert bool((kv[:, 1:] >= kv[:, :-1]).all()), "kernel output ascending"


def _utterances(seed, n_utts, n_epochs):
    """Numpy-made epoch utterances: AR(1) feature walks, 80-160-sample
    periods, low-amplitude noise waves."""
    rng = np.random.default_rng(seed)
    utts = []
    for u in range(n_utts):
        x = np.empty((n_epochs, KD), np.float32)
        x[0] = rng.standard_normal(KD)
        for e in range(1, n_epochs):
            x[e] = 0.95 * x[e - 1] + 0.31 * rng.standard_normal(KD)
        periods = rng.integers(80, 161, n_epochs)
        epochs = 160 + np.cumsum(periods) - periods[0]
        x[:, -1] = np.log(16000 / periods)
        utts.append(UtteranceData(
            basename=f"u{u}", epochs=epochs.astype(np.int32), features=x,
            wave=0.05 * rng.standard_normal(int(epochs[-1]) + 200).astype(np.float32),
            lf0=x[:, -1].copy()))
    return utts


@pytest.mark.cuda
def test_synthesiser_on_card_matches_cpu(cuda_device):
    """The whole step on the card (kernel, Viterbi, OLA) gives the CPU
    path's unit ids, costs (rtol 1e-5) and audio (atol 1e-5)."""
    cfg = SnickeryConfig(
        stream_list=["mag", "real", "imag", "lf0"],
        datadims={"mag": 60, "real": 45, "imag": 45, "lf0": 1},
        n_candidates=30, taper_length=50, join_cost_weight=0.7,
        length_buckets=[256])
    db = build_voicedb(cfg, _utterances(1, 40, 202))
    held = [u.features for u in _utterances(2, 3, 258)]
    gpu, cpu = Synthesiser(cfg, db, device=cuda_device), Synthesiser(cfg, db, device="cpu")
    before = cuda_topk.LAUNCH_COUNTS[cuda_topk.KERNEL]
    out_g = gpu.synth_batch(held)
    assert cuda_topk.LAUNCH_COUNTS[cuda_topk.KERNEL] == before + 1
    for g, c in zip(out_g, cpu.synth_batch(held)):
        np.testing.assert_array_equal(g["unit_ids"], c["unit_ids"])
        np.testing.assert_allclose(g["total_cost"], c["total_cost"], rtol=1e-5)
        np.testing.assert_allclose(g["wave"], c["wave"], atol=1e-5)

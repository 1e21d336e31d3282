"""The preselect kernel's wrapper and plain twin vs the JAX Pallas kernel.

On the CPU the wrapper runs the plain twin (``topk_preselect_zt_plain``);
the Pallas kernel runs in interpret mode, as tests/test_pallas_topk.py runs
it.  The kernel itself runs only on a CUDA card, in
tests/test_torch_cuda_kernel.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from snickery_tpu.ops.pallas_topk import pallas_topk_preselect
from snickery_tpu.voicedb.device_layout import build_raw_blocks
from snickery_tpu_torch.ops import cuda_topk
from snickery_tpu_torch.ops.cuda_topk import (cuda_topk_preselect, split_plan,
                                              topk_preselect_zt_plain)


def _voice(seed, m, M, kd, dup=False):
    """Raw [data | sqn | ptr] block with jr exceptions and padding rows."""
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((m, kd)).astype(np.float32)
    if dup:
        feats[100:140] = feats[50]
    jr = np.empty((m, kd), np.float32)
    jr[:-1] = feats[1:]
    jr[-1] = rng.standard_normal(kd)
    jr[39::40] = rng.standard_normal((len(jr[39::40]), kd))
    aff = ((0.1 * rng.standard_normal(kd)).astype(np.float32),
           rng.uniform(0.5, 2.0, kd).astype(np.float32),
           rng.uniform(0.2, 1.0, kd).astype(np.float32))
    raw, _, _ = build_raw_blocks(feats, jr, M, affine=aff)
    return rng, raw, aff


@pytest.mark.parametrize("m,dup", [(8192 - 700, False), (8192, True)])
def test_zt_plain_matches_pallas_interpret(m, dup):
    """T=256, M=8192, kd=151, k=40: identical id sets; scores (with comp
    added back) rtol 1e-5 / atol 1e-3 -- f32 sums of 151 products in another
    order, on scores of magnitude ~1e2.

    With 41 bit-identical DB rows (50 and 100..139) the Pallas stream
    select may keep any members of that class at the k boundary (it
    replaces the first of several equal worst slots); the port keeps the
    lowest indices.  There ids are compared up to the class, and the
    port's members must be the class's lowest."""
    Tn, M, kd, k = 256, 8192, 151, 40
    rng, raw, aff = _voice(7 + m, m, M, kd, dup)
    targets = rng.standard_normal((Tn, kd)).astype(np.float32)
    ri, rv = pallas_topk_preselect(
        jnp.asarray(targets), jnp.asarray(raw), k=k, interpret=True,
        mm_precision="highest", sort=True, zero_transient=True, m_rows=M,
        db_affine=(*map(jnp.asarray, aff), jnp.int32(m)))
    gi, gv = cuda_topk_preselect(torch.from_numpy(targets), torch.from_numpy(raw),
                                 k, tuple(map(torch.from_numpy, aff)), M)
    ri, rv, gi, gv = np.asarray(ri), np.asarray(rv), gi.numpy(), gv.numpy()
    assert gi.dtype == np.int32 and gv.dtype == np.float32
    assert (gi < m).all(), "padding rows must never be selected"
    alias = np.arange(M)
    if dup:
        klass = np.r_[50, 100:140]
        alias[klass] = 50
        for row in gi:
            members = np.sort(row[np.isin(row, klass)])
            np.testing.assert_array_equal(members, klass[:len(members)])
    o_r, o_g = np.argsort(alias[ri], 1), np.argsort(alias[gi], 1)
    np.testing.assert_array_equal(np.take_along_axis(alias[gi], o_g, 1),
                                  np.take_along_axis(alias[ri], o_r, 1))
    np.testing.assert_allclose(np.take_along_axis(gv, o_g, 1),
                               np.take_along_axis(rv, o_r, 1), rtol=1e-5, atol=1e-3)
    # ascending (score, index) order, lowest index first on ties
    assert (np.diff(gv, axis=1) >= 0).all()
    tie = np.diff(gv, axis=1) == 0
    assert (np.diff(gi.astype(np.int64), axis=1)[tie] > 0).all()


def test_zt_plain_blocking_invariant():
    """The twin's target blocking and DB chunking do not change its result,
    including a ragged last chunk and m_rows short of the block."""
    rng, raw, aff = _voice(3, 3000, 3000, 24)
    tg = torch.from_numpy(rng.standard_normal((100, 24)).astype(np.float32))
    args = (tg, torch.from_numpy(raw), 12, tuple(map(torch.from_numpy, aff)), 2900)
    i0, v0 = topk_preselect_zt_plain(*args)
    i1, v1 = topk_preselect_zt_plain(*args, t_block=7, chunk=333)
    assert torch.equal(i0, i1) and torch.equal(v0, v1)
    assert (i0 < 2900).all()


def test_wrapper_rejects_bad_inputs():
    rng, raw, aff = _voice(4, 1000, 1024, 24)
    tg = torch.from_numpy(rng.standard_normal((10, 24)).astype(np.float32))
    R, A = torch.from_numpy(raw), tuple(map(torch.from_numpy, aff))
    with pytest.raises(TypeError):
        cuda_topk_preselect(tg.double(), R, 8, A, 1024)
    with pytest.raises(ValueError, match="width"):
        cuda_topk_preselect(tg, R[:, :-1].contiguous(), 8, A, 1024)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_topk_preselect(tg.t().contiguous().t(), R, 8, A, 1024)
    with pytest.raises(ValueError, match="k="):
        cuda_topk_preselect(tg, R, cuda_topk.MAX_K + 1, A, 1024)
    with pytest.raises(ValueError, match="m_rows"):
        cuda_topk_preselect(tg, R, 8, A, R.shape[0] + 1)
    with pytest.raises(ValueError, match="db_affine"):
        cuda_topk_preselect(tg, R, 8, A[:2], 1024)
    with pytest.raises(ValueError, match="device"):
        cuda_topk_preselect(tg.to("meta"), R.to("meta"), 8,
                            tuple(a.to("meta") for a in A), 1024)


def test_cpu_tensors_take_the_plain_twin():
    """A CPU tensor goes through the twin and never counts a kernel launch."""
    rng, raw, aff = _voice(5, 512, 512, 16)
    tg = torch.from_numpy(rng.standard_normal((9, 16)).astype(np.float32))
    before = cuda_topk.LAUNCH_COUNTS[cuda_topk.KERNEL]
    a = cuda_topk_preselect(tg, torch.from_numpy(raw), 6,
                            tuple(map(torch.from_numpy, aff)), 512)
    b = topk_preselect_zt_plain(tg, torch.from_numpy(raw), 6,
                                tuple(map(torch.from_numpy, aff)), 512)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert cuda_topk.LAUNCH_COUNTS[cuda_topk.KERNEL] == before


@pytest.mark.parametrize("T,m_rows", [(128, 1_056_768), (2048, 1_056_768),
                                      (65536, 1_056_768), (300, 8229), (1, 40)])
def test_split_plan_covers_the_db(T, m_rows):
    splits, rows = split_plan(T, m_rows, n_sm=132, tile_rows=64, db_tile_rows=64)
    assert rows % 64 == 0
    assert (splits - 1) * rows < m_rows <= splits * rows    # none empty
    tiles = -(-T // 64)
    assert tiles * splits >= min(2 * 132, tiles * -(-m_rows // 64))   # a full wave

"""Exact fused distance + top-k preselect over the resident raw unit block.

Counterpart of ``snickery_tpu/ops/pallas_topk.py::pallas_topk_preselect``
in the form the synthesis main path runs (precision "highest",
zero_transient=True, ``select="stream"``).  The CUDA C++ kernel lives in
``csrc/topk_preselect.cu``; its plain PyTorch twin
:func:`topk_preselect_zt_plain` computes the same thing.

Zero-transient algebra (as in the JAX wrapper): the kernel reads the raw
block ``[data kd | sqn | ptr]`` directly, with the DB affine folded into
prescaled targets ``t2 = t_w * (sqrt_w / std)``; the per-target constant
``comp = 2 * (t2 @ mean)`` is dropped from the ranking and added back to the
returned scores.  Rows ``[m_rows, q)`` (halo and jr-exception tail) are never
scanned, and padding rows carry the 1e6 never-wins sentinel norm.

Cost on Hopper: at the config-3 batch shape (65,536 target rows x 1,048,576
units x kd = 151) one call is about 2.1e13 FLOP, done as FP32 FMAs on the
CUDA cores, so the kernel is bound by FP32 FMA throughput; the DB block (about
640 MB) is read once per group of target tiles resident together, the rest
of its reads hitting L2.

:func:`cuda_topk_preselect` dispatches on ``raw_block.device``: a CUDA
tensor goes through the kernel, a CPU tensor through the plain twin, and
nothing falls back from one to the other.
"""

from __future__ import annotations

import collections
import ctypes
import functools

import torch

from snickery_tpu_torch.ops.topk import smallest_k

KERNEL = "topk_preselect_zt"
# launches of each hand-written kernel by its wrapper, for run reports
LAUNCH_COUNTS: collections.Counter = collections.Counter()
MAX_K = 64                 # list slots the kernel keeps per target
_TARGET_CTAS_PER_SM = 4    # two resident CTAs per SM, two waves


def _prescale(targets, db_affine):
    mean, std, w = db_affine
    t2 = targets * (w / std)[None, :]
    comp = 2.0 * (t2 @ mean)
    return t2, comp


def _check(targets, raw_block, k, db_affine, m_rows):
    if targets.dtype != torch.float32 or raw_block.dtype != torch.float32:
        raise TypeError("targets and raw_block must be float32")
    if targets.ndim != 2 or raw_block.ndim != 2:
        raise ValueError("targets must be (T, kd) and raw_block (q, kd + 2)")
    T, kd = targets.shape
    if raw_block.shape[1] != kd + 2:
        raise ValueError(
            f"raw_block width {raw_block.shape[1]} != kd + 2 = {kd + 2} "
            "([data | sqn | ptr], build_raw_blocks(affine=...))")
    if len(db_affine) != 3 or any(a.shape != (kd,) or a.dtype != torch.float32
                                  for a in db_affine):
        raise ValueError("db_affine must be (mean, std, sqrt_w), each (kd,) f32")
    if not 1 <= m_rows <= raw_block.shape[0]:
        raise ValueError(f"m_rows={m_rows} outside [1, {raw_block.shape[0]}]")
    if not 1 <= k <= min(MAX_K, m_rows):
        raise ValueError(f"k={k} must lie in [1, min({MAX_K}, m_rows)]")
    if T < 1:
        raise ValueError("no target rows")
    devices = {t.device for t in (targets, raw_block, *db_affine)}
    if len(devices) != 1:
        raise ValueError(f"tensors on several devices: {devices}")
    if not (targets.is_contiguous() and raw_block.is_contiguous()):
        raise ValueError("targets and raw_block must be contiguous")


def topk_preselect_zt_plain(targets, raw_block, k, db_affine, m_rows,
                            t_block: int = 4096, chunk: int = 65536):
    """Plain PyTorch twin of the kernel: the same algebra in chunked
    matmuls, with exact (score, index) selection (lowest index wins ties).

    Returns (indices (T, k) int32, scores (T, k) f32), ascending."""
    _check(targets, raw_block, k, db_affine, m_rows)
    kd = targets.shape[1]
    t2, comp = _prescale(targets, db_affine)
    out_i, out_v = [], []
    for t0 in range(0, t2.shape[0], t_block):
        tb = t2[t0:t0 + t_block]
        vals, cols = [], []
        for lo in range(0, m_rows, chunk):
            hi = min(lo + chunk, m_rows)
            rows = raw_block[lo:hi]
            scores = rows[:, kd][None, :] - 2.0 * (tb @ rows[:, :kd].T)
            v, c = smallest_k(scores, min(k, hi - lo),
                              torch.arange(lo, hi, device=rows.device))
            vals.append(v)
            cols.append(c)
        v, c = smallest_k(torch.cat(vals, 1), k, torch.cat(cols, 1))
        out_i.append(c.to(torch.int32))
        out_v.append(v + comp[t0:t0 + t_block, None])
    return torch.cat(out_i), torch.cat(out_v)


@functools.cache
def _kernel():
    from snickery_tpu_torch.ops._build import kernel_library
    lib = kernel_library().lib
    fn = lib.snk_topk_preselect_zt
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.snk_topk_partial_smem.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.snk_topk_partial_smem.restype = ctypes.c_size_t
    lib.snk_topk_tile_rows.restype = ctypes.c_int
    lib.snk_topk_db_tile_rows.restype = ctypes.c_int
    return lib


def split_plan(T: int, m_rows: int, n_sm: int, tile_rows: int,
               db_tile_rows: int) -> tuple[int, int]:
    """(splits S, rows per split) for the kernel's first pass: enough
    (target tile x DB split) blocks to fill ``n_sm`` SMs, each split a
    whole number of DB tiles and none empty."""
    n_tiles = -(-T // tile_rows)
    want = -(-_TARGET_CTAS_PER_SM * n_sm // n_tiles)
    splits = max(1, min(want, -(-m_rows // db_tile_rows)))
    rows = -(-m_rows // splits)
    rows = -(-rows // db_tile_rows) * db_tile_rows
    return -(-m_rows // rows), rows


def cuda_topk_preselect(targets, raw_block, k, db_affine, m_rows):
    """Exact top-k DB rows per target, zero-transient form.

    ``targets`` (T, kd) f32: normalised, weighted target rows.
    ``raw_block`` (q, kd + 2) f32: the resident ``[data | sqn | ptr]`` block.
    ``db_affine`` = (mean, std, sqrt_w), each (kd,) f32.
    ``m_rows``: DB rows to scan (rows beyond are halo / exception tail).
    Returns (indices (T, k) int32, scores (T, k) f32): the exact k best
    (score, index) pairs, scores = squared distance minus ||t||^2.  On a
    CUDA device the hand-written kernel runs (ascending order); on the CPU
    the plain twin."""
    if raw_block.device.type == "cpu":
        return topk_preselect_zt_plain(targets, raw_block, k, db_affine, m_rows)
    if raw_block.device.type != "cuda":
        raise ValueError(f"unsupported device {raw_block.device}")
    _check(targets, raw_block, k, db_affine, m_rows)
    lib = _kernel()
    T, kd = targets.shape
    if lib.snk_topk_partial_smem(kd, k) > 227 * 1024:
        raise ValueError(f"kd={kd} needs more shared memory than a block has")
    dev = raw_block.device
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    splits, rows = split_plan(T, m_rows, n_sm, lib.snk_topk_tile_rows(),
                              lib.snk_topk_db_tile_rows())
    t2, comp = _prescale(targets, db_affine)
    t2 = t2.contiguous()
    part_v = torch.empty((T, splits, k), dtype=torch.float32, device=dev)
    part_i = torch.empty((T, splits, k), dtype=torch.int32, device=dev)
    out_v = torch.empty((T, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((T, k), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.snk_topk_preselect_zt(
        t2.data_ptr(), raw_block.data_ptr(), comp.data_ptr(),
        part_v.data_ptr(), part_i.data_ptr(), out_v.data_ptr(),
        out_i.data_ptr(), T, kd, raw_block.shape[1], m_rows, k, splits, rows,
        stream)
    if err != 0:
        raise RuntimeError(f"{KERNEL} launch failed: cudaError_t {err}")
    LAUNCH_COUNTS[KERNEL] += 1
    return out_i, out_v

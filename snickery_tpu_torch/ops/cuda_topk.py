"""Fused distance + top-k preselect over the resident raw unit block.

Counterpart of ``snickery_tpu/ops/pallas_topk.py::pallas_topk_preselect``
in the forms the synthesis paths run (zero_transient=True,
``select="stream"``): precision "highest" and the bf16-split precisions
"split3" and "split3cat", each with or without the fused voice partition
mask and the fused quinphone penalties (twelve entry points).  The CUDA C++
kernel lives in ``csrc/topk_preselect.cu``; its plain PyTorch twin
:func:`topk_preselect_zt_plain` computes the same thing.

Precisions (``pallas_topk._split3_dot``, ``_bf16_split``): "highest" forms
``u.t2`` in f32; "split3" and "split3cat" split both operands into bf16
``hi = bf16(x)`` and ``lo = bf16(x - hi)`` (:func:`split_bf16`) and form
``hi.hi + hi.lo + lo.hi`` (DB side first), whose products are exact in f32:
"split3" as three sums added ``(hh + hl) + lh``, "split3cat" as one sum over
the 3 kd pairs.  The kernel sums on the tensor cores in its own order, so
kernel and twin agree to f32 rounding of the sums, not bit for bit, at these
precisions.  Callers select k + margin and rescore in exact f32
(``ops.topk.preselect_margin``).

Zero-transient algebra (as in the JAX wrapper): the kernel reads the raw
block ``[data kd | sqn | ptr]`` directly, with the DB affine folded into
prescaled targets ``t2 = t_w * (sqrt_w / std)``; the per-target constant
``comp = 2 * (t2 @ mean)`` is dropped from the ranking and added back to the
returned scores.  Rows ``[m_rows, q)`` (halo and jr-exception tail) are never
scanned, and padding rows carry the 1e6 never-wins sentinel norm.

Fused masks (Pallas ``_compute_scores`` order, so that twin and kernel agree
bit for bit): each score ``s = sqn - 2 * u.t2`` becomes +inf where the
target's and the row's voice ids differ (``partition``), then gains
``ID_RANK_PENALTY`` where the halfphone codes differ and ``f32(w_c * scale)``
for each quinphone context slot c that differs (``ling_weights``).  Both
sides describe themselves with one int32 row of :data:`META_WIDTH` columns,
``[code, ctx0..ctx4, voice id, 0]`` (:func:`pack_meta`).  A slot no finite
score reaches (a voice with fewer than k rows) reads (+inf, index 0), the
Pallas contract.

Cost on Hopper: at the config-3 batch shape (65,536 target rows x 1,048,576
units x kd = 151) one "highest" call is about 2.1e13 FLOP, done as FP32 FMAs
on the CUDA cores, so the kernel is bound by FP32 FMA throughput; the DB
block (about 640 MB) is read once per group of target tiles resident
together, the rest of its reads hitting L2.  The split precisions do three
times the products on the bf16 tensor cores, where the DB staging and the
selection bound them instead.  The fused masks add 8 integer compares per
score against metadata staged in shared memory beside the tile, small
beside the kd FMAs behind each score.

:func:`cuda_topk_preselect` dispatches on ``raw_block.device``: a CUDA
tensor goes through the kernel, a CPU tensor through the plain twin, and
nothing falls back from one to the other.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import threading

import numpy as np
import torch

from snickery_tpu_torch.const import ID_RANK_PENALTY
from snickery_tpu_torch.ops.topk import smallest_k

META_WIDTH = 8             # [code, ctx0..ctx4, voice id, 0] per row
# one exported kernel entry point per (partition, linguistic) variant at
# precision "highest", and the same four variants at each split precision
KERNELS = {(False, False): "topk_preselect_zt",
           (True, False): "topk_preselect_zt_part",
           (False, True): "topk_preselect_zt_ling",
           (True, True): "topk_preselect_zt_ling_part"}
KERNEL = KERNELS[False, False]
PRECISIONS = ("highest", "split3", "split3cat")   # kernel precision codes 0..2
SPLIT_KERNELS = {"split3": "topk_preselect_zt_split3",
                 "split3cat": "topk_preselect_zt_split3cat"}
_MASK_SUFFIX = {(False, False): "", (True, False): "_part", (False, True): "_ling",
                (True, True): "_ling_part"}
# launches of each hand-written kernel by its wrapper, for run reports
# (updated under _LOCK: a server launches from several threads)
LAUNCH_COUNTS: collections.Counter = collections.Counter()
_LOCK = threading.Lock()
MAX_K = 64                 # list slots the kernel keeps per target
_TARGET_CTAS_PER_SM = 4    # two resident CTAs per SM, two waves


def kernel_name(partition: bool, linguistic: bool, precision: str = "highest") -> str:
    """The kernel entry point (without its ``snk_`` prefix) of a variant."""
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}; have {PRECISIONS}")
    if precision == "highest":
        return KERNELS[bool(partition), bool(linguistic)]
    return SPLIT_KERNELS[precision] + _MASK_SUFFIX[bool(partition), bool(linguistic)]


# every entry point, in (precision, partition, linguistic) order
ALL_KERNELS = tuple(kernel_name(p, ling, prec) for prec in PRECISIONS
                    for p in (False, True) for ling in (False, True))


def split_bf16(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) bf16 split of an f32 tensor, returned as f32 values:
    ``hi = bf16(x)``, ``lo = bf16(x - hi)`` (round to nearest even, as
    ``pallas_topk._bf16_split``)."""
    hi = x.to(torch.bfloat16).to(torch.float32)
    return hi, (x - hi).to(torch.bfloat16).to(torch.float32)


def split_scores64(targets: torch.Tensor, rows: torch.Tensor, db_affine) -> torch.Tensor:
    """(T, n) float64 ranking scores ``sqn - 2 * (hh + hl + lh)``, ``comp``
    left out, of raw-block rows (T, n, kd + 2) for targets (T, kd): the
    three bf16 products of the f32-prescaled targets and the rows, summed
    exactly, the value kernel and twin both round at a split precision."""
    kd = targets.shape[1]
    th, tl = (x.double() for x in split_bf16(_prescale(targets, db_affine)[0]))
    rh, rl = (x.double() for x in split_bf16(rows[..., :kd].contiguous()))
    cross = sum(torch.einsum("tnc,tc->tn", r, t) for r, t in ((rh, th), (rh, tl), (rl, th)))
    return rows[..., kd].double() - 2.0 * cross


def cross_products(t2: torch.Tensor, rows: torch.Tensor, precision: str) -> torch.Tensor:
    """(T, n) dot products of prescaled targets (T, kd) with DB rows (n, kd)
    at ``precision``: f32 matmul, or the bf16-split sums (the split halves
    are cast back to f32 before the matmuls, so every product is exact and
    only the f32 summation order is the matmul's)."""
    if precision == "highest":
        return t2 @ rows.T
    th, tl = split_bf16(t2)
    rh, rl = split_bf16(rows)
    if precision == "split3":
        return (th @ rh.T + tl @ rh.T) + th @ rl.T
    return torch.cat([th, tl, th], 1) @ torch.cat([rh, rh, rl], 1).T


def pack_meta(codes: torch.Tensor, ctx: torch.Tensor, vids: torch.Tensor) -> torch.Tensor:
    """(n, META_WIDTH) int32 ``[code, ctx0..ctx4, voice id, 0]`` rows from
    (n,) codes, (n, 5) quinphone context codes and (n,) voice ids."""
    n = codes.shape[0]
    zero = torch.zeros((n, 1), dtype=torch.int32, device=codes.device)
    return torch.cat([codes.reshape(n, 1).to(torch.int32), ctx.to(torch.int32),
                      vids.reshape(n, 1).to(torch.int32), zero], 1).contiguous()


def penalty_constants(ling_weights) -> tuple:
    """The 5 context-slot penalties ``float32(w_c * scale)`` (0 for a slot
    of weight 0, which is skipped), rounded as the Pallas kernel rounds
    them, from ``ling_weights = (w0..w4, scale)``."""
    *w, scale = ling_weights
    return tuple(float(np.float32(wc * scale)) if wc else 0.0 for wc in w)


def _prescale(targets, db_affine):
    mean, std, w = db_affine
    t2 = targets * (w / std)[None, :]
    comp = 2.0 * (t2 @ mean)
    return t2, comp


def _check(targets, raw_block, k, db_affine, m_rows, tgt_meta, db_meta, masked):
    """Argument checks shared by the kernel wrapper and the twin."""
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
    tensors = [targets, raw_block, *db_affine]
    if masked:
        if tgt_meta is None or db_meta is None:
            raise ValueError("partition / linguistic need tgt_meta and db_meta")
        for name, m, rows in (("tgt_meta", tgt_meta, T), ("db_meta", db_meta, m_rows)):
            if (m.dtype != torch.int32 or m.ndim != 2 or m.shape[1] != META_WIDTH
                    or m.shape[0] < rows or not m.is_contiguous()):
                raise ValueError(f"{name} must be contiguous int32 (>= {rows}, "
                                 f"{META_WIDTH}) (pack_meta)")
        tensors += [tgt_meta, db_meta]
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"tensors on several devices: {devices}")
    if not (targets.is_contiguous() and raw_block.is_contiguous()):
        raise ValueError("targets and raw_block must be contiguous")


def _apply_masks(scores, tm, dm, partition, pens):
    """Pallas ``_compute_scores`` order: partition, code penalty, then the
    context slots in order."""
    if partition:
        scores = torch.where(tm[:, 6, None] != dm[None, :, 6], float("inf"), scores)
    if pens is not None:
        zero = torch.zeros((), dtype=torch.float32, device=scores.device)
        pen = torch.tensor(np.float32(ID_RANK_PENALTY), device=scores.device)
        scores = scores + torch.where(tm[:, 0, None] != dm[None, :, 0], pen, zero)
        for c, p in enumerate(pens):
            if p:
                pc = torch.tensor(np.float32(p), device=scores.device)
                scores = scores + torch.where(tm[:, c + 1, None] != dm[None, :, c + 1],
                                              pc, zero)
    return scores


def topk_preselect_zt_plain(targets, raw_block, k, db_affine, m_rows, *,
                            tgt_meta=None, db_meta=None, partition=False,
                            ling_weights=None, precision: str = "highest",
                            t_block: int = 4096, chunk: int = 65536):
    """Plain PyTorch twin of the kernel: the same algebra in chunked
    matmuls (:func:`cross_products` at ``precision``), the fused masks in
    the kernel's order, and exact (score, index) selection (lowest index
    wins ties; a slot with no finite score reads (+inf, 0)).
    ``ling_weights`` (w0..w4, scale) turns the quinphone penalties on,
    ``partition`` the voice mask; both read the (rows, META_WIDTH)
    ``tgt_meta`` / ``db_meta`` of :func:`pack_meta`.

    Returns (indices (T, k) int32, scores (T, k) f32), ascending."""
    masked = partition or ling_weights is not None
    kernel_name(partition, ling_weights is not None, precision)
    _check(targets, raw_block, k, db_affine, m_rows, tgt_meta, db_meta, masked)
    pens = None if ling_weights is None else penalty_constants(ling_weights)
    kd = targets.shape[1]
    t2, comp = _prescale(targets, db_affine)
    out_i, out_v = [], []
    for t0 in range(0, t2.shape[0], t_block):
        tb = t2[t0:t0 + t_block]
        vals, cols = [], []
        for lo in range(0, m_rows, chunk):
            hi = min(lo + chunk, m_rows)
            rows = raw_block[lo:hi]
            scores = rows[:, kd][None, :] - 2.0 * cross_products(tb, rows[:, :kd],
                                                                  precision)
            if masked:
                scores = _apply_masks(scores, tgt_meta[t0:t0 + t_block],
                                      db_meta[lo:hi], partition, pens)
            v, c = smallest_k(scores, min(k, hi - lo),
                              torch.arange(lo, hi, device=rows.device))
            vals.append(v)
            cols.append(c)
        v, c = smallest_k(torch.cat(vals, 1), k, torch.cat(cols, 1))
        c = torch.where(torch.isinf(v), 0, c)
        out_i.append(c.to(torch.int32))
        out_v.append(v + comp[t0:t0 + t_block, None])
    return torch.cat(out_i), torch.cat(out_v)


def _kernel():
    """The kernel library with its entry points typed, built at first use
    (thread-safe)."""
    with _LOCK:
        return _bound_library()


@functools.cache
def _bound_library():
    from snickery_tpu_torch.ops._build import kernel_library
    lib = kernel_library().lib
    for name in ALL_KERNELS:
        fn = getattr(lib, "snk_" + name)
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_float] * 5
                       + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    lib.snk_topk_partial_smem.argtypes = [ctypes.c_int] * 4
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


def cuda_topk_preselect(targets, raw_block, k, db_affine, m_rows, *,
                        tgt_meta=None, db_meta=None, partition=False,
                        ling_weights=None, precision: str = "highest"):
    """Top-k DB rows per target, zero-transient form: exact at precision
    "highest", ranked by the bf16-split products at "split3" / "split3cat".

    ``targets`` (T, kd) f32: normalised, weighted target rows.
    ``raw_block`` (q, kd + 2) f32: the resident ``[data | sqn | ptr]`` block.
    ``db_affine`` = (mean, std, sqrt_w), each (kd,) f32.
    ``m_rows``: DB rows to scan (rows beyond are halo / exception tail).
    ``partition``: restrict each target to the rows of its voice id;
    ``ling_weights`` (w0..w4, scale): add the quinphone penalties; either
    reads ``tgt_meta`` (T, 8) and ``db_meta`` (>= m_rows, 8) int32
    (:func:`pack_meta`).
    Returns (indices (T, k) int32, scores (T, k) f32): the k best
    (score, index) pairs, scores = squared distance (plus penalties) minus
    ||t||^2, (+inf, 0) in a slot no row reaches.  On a CUDA device the
    hand-written kernel of the variant runs (ascending order); on the CPU
    the plain twin."""
    kw = dict(tgt_meta=tgt_meta, db_meta=db_meta, partition=partition,
              ling_weights=ling_weights, precision=precision)
    if raw_block.device.type == "cpu":
        return topk_preselect_zt_plain(targets, raw_block, k, db_affine, m_rows, **kw)
    if raw_block.device.type != "cuda":
        raise ValueError(f"unsupported device {raw_block.device}")
    linguistic = ling_weights is not None
    masked = partition or linguistic
    name = kernel_name(partition, linguistic, precision)
    _check(targets, raw_block, k, db_affine, m_rows, tgt_meta, db_meta, masked)
    lib = _kernel()
    T, kd = targets.shape
    if lib.snk_topk_partial_smem(kd, k, int(masked), PRECISIONS.index(precision)) > 227 * 1024:
        raise ValueError(f"kd={kd} needs more shared memory than a block has")
    dev = raw_block.device
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    splits, rows = split_plan(T, m_rows, n_sm, lib.snk_topk_tile_rows(),
                              lib.snk_topk_db_tile_rows())
    t2, comp = _prescale(targets, db_affine)
    t2 = t2.contiguous()
    pens = penalty_constants(ling_weights) if linguistic else (0.0,) * 5
    part_v = torch.empty((T, splits, k), dtype=torch.float32, device=dev)
    part_i = torch.empty((T, splits, k), dtype=torch.int32, device=dev)
    out_v = torch.empty((T, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((T, k), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = getattr(lib, "snk_" + name)(
        t2.data_ptr(), raw_block.data_ptr(), comp.data_ptr(),
        tgt_meta.data_ptr() if masked else None,
        db_meta.data_ptr() if masked else None, *pens,
        part_v.data_ptr(), part_i.data_ptr(), out_v.data_ptr(),
        out_i.data_ptr(), T, kd, raw_block.shape[1], m_rows, k, splits, rows,
        stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError_t {err}")
    with _LOCK:
        LAUNCH_COUNTS[name] += 1
    return out_i, out_v

"""Fused distance + top-k preselect over the unit DB.

Counterpart of ``snickery_tpu/ops/pallas_topk.py::pallas_topk_preselect``
in both operand forms: zero_transient=True (the resident raw block) and
False (the derived operand, config ``zero_transient: 0``); each at precision
"highest" and the bf16-split precisions "split3" and "split3cat", each with
or without the fused voice partition mask and the fused quinphone
penalties, and each in every selection form of the Pallas kernel:
``select="stream"`` (the one the synthesis paths run), "phase", "packed",
"packed3" and "packed3diag" (reached from sweeps only, as in the JAX
package: :mod:`snickery_tpu_torch.sweep_topk`).  That is 24 entry points a
selection, 96 in all ("packed3diag" is the "packed3" kernel with its flags
returned).  The CUDA C++ kernels live in ``csrc/topk_preselect.cuh`` and
are exported by ``csrc/topk_preselect*.cu`` (zero-transient) and
``csrc/topk_derived*.cu`` (derived), one source a selection; their plain
PyTorch twins :func:`topk_preselect_zt_plain` and
:func:`topk_preselect_dv_plain` compute the same things.

Selections (:data:`SELECTS`).  "stream" and "phase" are the exact
(score, index) top-k, equal bit for bit; they differ in how the kernel finds
it.  "packed" ranks by :func:`packed_keys`: the order-preserving int key of
the score (:func:`to_key`) with its low 7 bits replaced by ``u & 127``, u
the DB row (the Pallas default BLOCK = 128), ties by u; the returned scores
are the unpacked keys (:func:`from_key`), within 127 ulp of the ranked
score, so callers use it with the rank margin.  "packed3" takes, per
128-row block, only the three least keys, and flags a target whose worst
kept key lies above some block's third key (a fourth row of that block
might belong in the list; the flag is conservative); a target without flag
has exactly the "packed" result.  If any target is flagged, "packed3"
returns the "stream" result instead (the flags are read back: one host
synchronisation, then a launch of the stream kernel), so it is exact either
way; "packed3diag" returns the fast path as it is and the (T,) int32 flags
as a third tensor.  Unlike the Pallas kernel, a +inf score takes no key in
the packed forms: dead slots read (+inf, 0) in every selection, and a
target starved by its partition is flagged only where a block holds three
of its finite scores.

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

Derived algebra (the JAX wrapper's zero_transient=False branch, :795-811):
:func:`derive_operand` normalises and weights the block's rows once per
step, padding rows (from ``n_real``) pinned to ``1e6 * sqrt_w``, and sums
their squares into a separate (m_rows,) ``sqn``; the kernel ranks the
normalised, weighted targets themselves by ``sqn - 2 * u.t`` and adds
nothing back.  At "highest" and "split3" the operand is (m_rows, kd) f32;
at "split3cat" it is pre-split into bf16 ``[hi | lo]`` rows, each half
zero-padded to ``kp = kd`` rounded up to :data:`SPLIT_KC` (the port's
layout of the JAX ``split3cat_db``), so that its rows are 16-byte aligned.

Fused masks (Pallas ``_compute_scores`` order, so that twin and kernel agree
bit for bit): each score ``s = sqn - 2 * u.t2`` becomes +inf where the
target's and the row's voice ids differ (``partition``), then gains
``ID_RANK_PENALTY`` where the halfphone codes differ and ``f32(w_c * scale)``
for each quinphone context slot c that differs (``ling_weights``).  Both
sides describe themselves with one int32 row of :data:`META_WIDTH` columns,
``[code, ctx0..ctx4, voice id, 0]`` (:func:`pack_meta`).  A slot no finite
score reaches (a voice with fewer than k rows) reads (+inf, index 0), the
Pallas contract.

Cost on Hopper (either form), and what the kernels do about it
(``csrc/topk_preselect.cuh`` has the details): at the config-3 batch shape
(65,536 target rows x 1,048,576 units x kd = 151) one "highest" call is about
2.1e13 FLOP of FP32 FMAs on the CUDA cores, so it is bound by their rate.
Pass 1 gives a CTA 128 targets (64 where 128 do not fit in shared memory)
and streams its DB split in 128-row tiles through a three-stage ``cp.async``
ring; each thread keeps an 8 x 8 register tile, every score is one ascending
``fmaf`` chain over the columns.  The split precisions do three times the
products on the bf16 tensor cores with ``wgmma`` (64 DB rows x 128 or 64
targets a step) from a ring that one producer warpgroup fills for two
consumer warpgroups; there the DB stream from L2 behind a ring of four
stages, and for f32 rows the producer's loads and split arithmetic, stand
beside the tensor cores' time.  So on f32 rows without the partition mask
two target tiles or more run as thread-block clusters of
:data:`CLUSTER_CTAS` (:func:`launch_shape`): the CTAs of a cluster hold
neighbouring target tiles over the same DB rows, and each producer splits
its share of a stage's rows into every CTA's ring, so a row is split once a
cluster.  Neither kernel writes its scores anywhere:
a score is compared in registers with its target's threshold (the worst kept
score) and only the survivors are queued and inserted into the k-slot lists
(:data:`MAX_K` slots at most); ``tests/test_torch_screen.py`` models that
epilogue.  In the "stream" selection a target's survivors of a DB tile are
sorted by a warp's bitonic network and merged with its sorted list, one
merge a (target, tile), where a tile has many (a CTA's first tile, which
fills the empty lists in bulk; the early tiles of a short split); the few
survivors of a warm tile go in a pair at a time, straight into the list in
the short splits of "highest", through the queue elsewhere.
The fused masks add 8 integer compares per score against metadata that
rides in the ring beside the tile.  The DB is cut into splits
(:func:`split_plan`) so that small T fills the card as well, and pass 2
merges a target's split lists with several warps where T is small.

Voice spans (partition variants).  A merged DB holds each voice's rows in
one run, so a target tile of one voice has only that run to scan.  With
``partition``, :func:`voice_spans_of` (once per DB: ``DeviceDB.spans``) keeps
the hull of each voice id's rows and of the padding rows (voice id -1, the
id of dead target steps), rounded out to 128-row blocks; per call
:func:`tile_spans` gives each target tile, with a few torch ops on the
device and no host synchronisation, the hull of its live voices' rows and
the padding rows if it holds a dead step, and the kernel's CTAs split only
those rows among them (:func:`cta_rows`).  Every row outside them scores
+inf for every target of the tile, so the result is that of the full scan.

:func:`cuda_topk_preselect` dispatches on the DB tensor's device: a CUDA
tensor goes through the kernel, a CPU tensor through the plain twin, and
nothing falls back from one to the other.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import threading
from dataclasses import dataclass

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
SPLIT_KC = 32              # the kernel's KC: a pre-split half is padded to a multiple
# selection forms; the kernel codes are their positions (packed3diag: packed3's)
SELECTS = ("stream", "phase", "packed", "packed3", "packed3diag")
BLOCK_ROWS = 128           # rows of a packed3 block; a packed key carries u & 127
KEY_EMPTY = 0x7FFFFFFF     # no key: an empty slot, a +inf score
_KEY_INF = 0x7F800000      # to_key(+inf)
_NO_PAIR = torch.iinfo(torch.int64).max   # (KEY_EMPTY, no row) as one int64
# launches of each hand-written kernel by its wrapper, for run reports
# (updated under _LOCK: a server launches from several threads)
LAUNCH_COUNTS: collections.Counter = collections.Counter()
_LOCK = threading.Lock()
MAX_K = 64                 # list slots the kernel keeps per target
SMEM_LIMIT = 227 * 1024    # shared memory a block may use on the card
_MAX_WAVES = 4             # split_plan looks no further than this many waves of CTAs
MIN_SPLIT_ROWS = 1024      # DB rows of a split, at the least (split_plan)
# what a CTA's start costs (split_plan), in DB rows at kd 151: the list phase of
# a natural-synthesis split (1,024 x 57,344, k 40, 3,584 rows a CTA) in rows of its
# stream, from the pass-1 k-sweep of kernel_ab --split on the H100 (PERF.md)
COLD_ROWS = 3299
_NO_ROW = 1 << 30          # the low end of an empty span
# target tiles a clustered launch of the split kernels' first pass puts in one
# thread-block cluster over the same DB rows (the kernels' CLUSTER: launch_shape)
CLUSTER_CTAS = 2


def kernel_name(partition: bool, linguistic: bool, precision: str = "highest",
                zero_transient: bool = True, select: str = "stream") -> str:
    """The kernel entry point (without its ``snk_`` prefix) of a variant:
    ``topk_preselect_zt...`` reads the raw block, ``topk_preselect_dv...``
    the derived operand; any selection but "stream" is the name's suffix
    ("packed3diag" runs the ``_packed3`` entry point)."""
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}; have {PRECISIONS}")
    if select not in SELECTS:
        raise ValueError(f"unknown select {select!r}; have {SELECTS}")
    if precision == "highest":
        name = KERNELS[bool(partition), bool(linguistic)]
    else:
        name = SPLIT_KERNELS[precision] + _MASK_SUFFIX[bool(partition), bool(linguistic)]
    if select != "stream":
        name += "_" + select.removesuffix("diag")
    return name if zero_transient else name.replace("_zt", "_dv", 1)


# the stream entry points, in (form, precision, partition, linguistic) order,
# and every entry point: those at each selection
ALL_KERNELS = tuple(kernel_name(p, ling, prec, zt) for zt in (True, False)
                    for prec in PRECISIONS for p in (False, True) for ling in (False, True))
ALL_ENTRY_POINTS = tuple(name + ("" if sel == "stream" else "_" + sel)
                         for sel in SELECTS[:4] for name in ALL_KERNELS)


def to_key(scores: torch.Tensor) -> torch.Tensor:
    """Order-preserving f32 -> int32 key (``pallas_topk._to_key``):
    non-negative bit patterns as they are, negative ones with their
    magnitude bits flipped, so int ``<`` is float ``<`` (and -0.0 sorts
    below +0.0)."""
    bits = scores.contiguous().view(torch.int32)
    return torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)


def from_key(keys: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`to_key` for packed keys (``pallas_topk._from_key``):
    clamped at the +inf pattern, so :data:`KEY_EMPTY` reads +inf."""
    keys = keys.clamp(max=_KEY_INF)
    return torch.where(keys < 0, keys ^ 0x7FFFFFFF, keys).contiguous().view(torch.float32)


def packed_keys(scores: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """int32 packed keys of ``scores`` at DB rows ``rows`` (broadcast against
    them): :func:`to_key` with the low 7 bits replaced by ``rows & 127``
    (``pallas_topk.py:524-527`` at BLOCK = 128)."""
    return (to_key(scores) & ~(BLOCK_ROWS - 1)) | (rows.to(torch.int32) & (BLOCK_ROWS - 1))


def presplit_width(kd: int) -> int:
    """bf16 columns of a pre-split operand row: ``[hi | lo]``, each half
    ``kd`` rounded up to :data:`SPLIT_KC`."""
    return 2 * (-(-kd // SPLIT_KC) * SPLIT_KC)


def split_bf16(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) bf16 split of an f32 tensor, returned as f32 values:
    ``hi = bf16(x)``, ``lo = bf16(x - hi)`` (round to nearest even, as
    ``pallas_topk._bf16_split``)."""
    hi = x.to(torch.bfloat16).to(torch.float32)
    return hi, (x - hi).to(torch.bfloat16).to(torch.float32)


def split_cross64(t2: torch.Tensor, rows) -> torch.Tensor:
    """(T, n) float64 ``hh + hl + lh`` of targets (T, kd) and DB rows
    (T, n, kd) f32, or their bf16 (hi, lo) halves as f32 (a pre-split
    operand): the three bf16 products summed exactly."""
    th, tl = (x.double() for x in split_bf16(t2))
    halves = rows if isinstance(rows, tuple) else split_bf16(rows.contiguous())
    rh, rl = (x.double() for x in halves)
    return sum(torch.einsum("tnc,tc->tn", r, t) for r, t in ((rh, th), (rh, tl), (rl, th)))


def split_scores64(targets: torch.Tensor, rows: torch.Tensor, db_affine) -> torch.Tensor:
    """(T, n) float64 ranking scores ``sqn - 2 * (hh + hl + lh)``, ``comp``
    left out, of raw-block rows (T, n, kd + 2) for targets (T, kd): the
    three bf16 products of the f32-prescaled targets and the rows, summed
    exactly, the value kernel and twin both round at a split precision."""
    kd = targets.shape[1]
    cross = split_cross64(_prescale(targets, db_affine)[0], rows[..., :kd])
    return rows[..., kd].double() - 2.0 * cross


def presplit_halves(operand: torch.Tensor, kd: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The (hi, lo) halves, as f32, of pre-split operand rows (..., 2 kp)."""
    kp = operand.shape[-1] // 2
    return operand[..., :kd].float(), operand[..., kp:kp + kd].float()


def cross_products(t2: torch.Tensor, rows, precision: str) -> torch.Tensor:
    """(T, n) dot products of targets (T, kd) with DB rows (n, kd) at
    ``precision``: f32 matmul, or the bf16-split sums (the split halves
    are cast back to f32 before the matmuls, so every product is exact and
    only the f32 summation order is the matmul's).  At a split precision
    ``rows`` may be given already split, as (hi, lo) f32 halves."""
    if precision == "highest":
        return t2 @ rows.T
    th, tl = split_bf16(t2)
    rh, rl = rows if isinstance(rows, tuple) else split_bf16(rows)
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


@dataclass(frozen=True)
class VoiceSpans:
    """The rows of each voice id of a DB's first ``m_rows`` rows
    (:func:`voice_spans_of`).  ``table`` (V + 2, 4) int32 on the DB's device:
    row ``v + 1`` holds ``[-lo, hi, -_NO_ROW, 0]`` for the hull [lo, hi) of
    voice v's rows, row 0 ``[-_NO_ROW, 0, -lo, hi]`` for the padding rows
    (voice id -1), row V + 1 nothing (ids no row has); each [lo, hi) is
    rounded out to :data:`BLOCK_ROWS` rows and cut at m_rows, and an empty
    one is [_NO_ROW, 0).  Low ends are negated so that one ``amax`` over a
    tile's rows of the table gives the tile's hulls (:func:`tile_spans`).
    ``longest``: rows the longest voice and the padding rows span together,
    what :func:`split_plan` plans for."""
    table: torch.Tensor
    longest: int
    m_rows: int


def voice_spans_of(vids: torch.Tensor, m_rows: int) -> VoiceSpans:
    """:class:`VoiceSpans` of the (>= m_rows,) voice ids ``vids`` (a DB's
    ``vids``, or column 6 of its :func:`pack_meta` rows), on their device.
    Voice ids are -1 (padding) or non-negative.  Reads two numbers back
    (one host synchronisation): make it once per DB."""
    if vids.ndim != 1 or vids.shape[0] < m_rows or m_rows < 1:
        raise ValueError(f"vids must be (>= {m_rows},)")
    v = vids[:m_rows].to(torch.int64)
    low = int(v.min())
    if low < -1:
        raise ValueError(f"voice id {low}: ids are -1 (padding) or non-negative")
    V = max(int(v.max()) + 1, 0)
    rows = torch.arange(m_rows, device=v.device)
    lo = torch.full((V + 2,), _NO_ROW, dtype=torch.int64, device=v.device)
    hi = torch.zeros(V + 2, dtype=torch.int64, device=v.device)
    lo.scatter_reduce_(0, v + 1, rows, "amin")
    hi.scatter_reduce_(0, v + 1, rows + 1, "amax")
    lo = lo // BLOCK_ROWS * BLOCK_ROWS
    hi = torch.clamp(-(-hi // BLOCK_ROWS) * BLOCK_ROWS, max=m_rows)
    live = torch.arange(V + 2, device=v.device) > 0
    table = torch.stack([torch.where(live, -lo, -_NO_ROW), torch.where(live, hi, 0),
                         torch.where(live, -_NO_ROW, -lo), torch.where(live, 0, hi)], 1)
    length = torch.clamp(hi - lo, min=0)
    longest = int((length[1:].max() if V else 0) + length[0])
    return VoiceSpans(table.to(torch.int32).contiguous(), max(longest, 1), m_rows)


def tile_spans(spans: VoiceSpans, tgt_vids: torch.Tensor, tile_rows: int) -> torch.Tensor:
    """(ceil(T / tile_rows), 4) int32 ``[-lo, hi, -lo_pad, hi_pad]`` of each
    tile of ``tile_rows`` targets with voice ids ``tgt_vids`` (T,): the hull
    of the rows of its targets' voices and, if one of its targets is dead
    (voice id -1, as the padding rows), the padding rows; an empty interval
    reads ``[-_NO_ROW, 0]``.  Torch ops on the ids' device, no host
    synchronisation.  A target id below -1 is taken for -1 (more rows, the
    same result); one no row has scans nothing."""
    T = tgt_vids.shape[0]
    n_tiles = -(-T // tile_rows)
    empty = spans.table.shape[0] - 1
    idx = torch.clamp(tgt_vids.to(torch.int32) + 1, 0, empty)
    idx = torch.nn.functional.pad(idx, (0, n_tiles * tile_rows - T), value=empty)
    rows = torch.index_select(spans.table, 0, idx)
    return rows.view(n_tiles, tile_rows, 4).amax(1).contiguous()


def cta_rows(span, split: int, splits: int, chunk: int, m_rows: int, db_tile_rows: int):
    """The DB tiles (first row of each, in order) the CTA of split ``split``
    scans for a target tile whose :func:`tile_spans` row is ``span`` (4
    ints, or None without the partition mask): the kernel's ``cta_rows``
    and ``Rows::base``, in Python.  The tile's intervals, made one where
    they overlap or touch, are read in concatenation; the CTA takes the
    chunks ``split, split + splits, ...`` of ``chunk`` rows of it, each cut
    into tiles of ``db_tile_rows`` rows.  Rows at or past ``m_rows`` in
    the last tile are masked by the kernel."""
    lo0, hi0, lo1, hi1 = 0, m_rows, 0, 0
    if span is not None:
        lo0, hi0, lo1, hi1 = -int(span[0]), int(span[1]), -int(span[2]), int(span[3])
        if hi0 <= lo0:
            lo0, hi0, lo1, hi1 = lo1, hi1, 0, 0
        if hi1 <= lo1:
            lo1 = hi1 = 0
        else:
            if lo1 < lo0:
                lo0, hi0, lo1, hi1 = lo1, hi1, lo0, hi0
            if lo1 <= hi0:
                hi0, lo1, hi1 = max(hi0, hi1), 0, 0
        if hi0 <= lo0:
            lo0 = hi0 = 0
    len0 = -(-(hi0 - lo0) // BLOCK_ROWS) * BLOCK_ROWS if hi1 > lo1 else hi0 - lo0
    total = len0 + hi1 - lo1
    bases = []
    for p0 in range(split * chunk, total, splits * chunk):
        for p in range(p0, min(p0 + chunk, total), db_tile_rows):
            bases.append(lo0 + p if p < len0 else lo1 + p - len0)
    return bases


def _check(targets, block, k, m_rows, tgt_meta, db_meta, masked, *, db_affine=None,
           sqn=None, precision="highest"):
    """Argument checks shared by the kernel wrapper and the twins: the
    zero-transient form reads the raw block with ``db_affine``, the derived
    form (``sqn`` given) the operand of :func:`derive_operand`."""
    derived = sqn is not None
    name = "operand" if derived else "raw_block"
    want = torch.bfloat16 if derived and precision == "split3cat" else torch.float32
    if targets.dtype != torch.float32 or block.dtype != want:
        raise TypeError(f"targets must be float32 and {name} {want}")
    if targets.ndim != 2 or block.ndim != 2:
        raise ValueError(f"targets must be (T, kd) and {name} 2-D")
    T, kd = targets.shape
    if derived:
        width = presplit_width(kd) if want == torch.bfloat16 else kd
        if block.shape[1] != width:
            raise ValueError(f"operand width {block.shape[1]} != {width} "
                             f"(derive_operand at precision {precision!r})")
        if (sqn.dtype != torch.float32 or sqn.ndim != 1 or sqn.shape[0] < m_rows
                or not sqn.is_contiguous()):
            raise ValueError(f"sqn must be contiguous float32 (>= {m_rows},)")
        tensors = [targets, block, sqn]
    else:
        if block.shape[1] != kd + 2:
            raise ValueError(
                f"raw_block width {block.shape[1]} != kd + 2 = {kd + 2} "
                "([data | sqn | ptr], build_raw_blocks(affine=...))")
        if db_affine is None or len(db_affine) != 3 or any(
                a.shape != (kd,) or a.dtype != torch.float32 for a in db_affine):
            raise ValueError("db_affine must be (mean, std, sqrt_w), each (kd,) f32")
        tensors = [targets, block, *db_affine]
    if not 1 <= m_rows <= block.shape[0]:
        raise ValueError(f"m_rows={m_rows} outside [1, {block.shape[0]}]")
    if not 1 <= k <= min(MAX_K, m_rows):
        raise ValueError(f"k={k} must lie in [1, min({MAX_K}, m_rows)]")
    if T < 1:
        raise ValueError("no target rows")
    if masked:
        if tgt_meta is None or db_meta is None:
            raise ValueError("partition / linguistic need tgt_meta and db_meta")
        for what, m, rows in (("tgt_meta", tgt_meta, T), ("db_meta", db_meta, m_rows)):
            if (m.dtype != torch.int32 or m.ndim != 2 or m.shape[1] != META_WIDTH
                    or m.shape[0] < rows or not m.is_contiguous()):
                raise ValueError(f"{what} must be contiguous int32 (>= {rows}, "
                                 f"{META_WIDTH}) (pack_meta)")
        tensors += [tgt_meta, db_meta]
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"tensors on several devices: {devices}")
    if not (targets.is_contiguous() and block.is_contiguous()):
        raise ValueError(f"targets and {name} must be contiguous")


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


def _masked_scores(scores_of, t0, t1, lo, hi, tgt_meta, db_meta, partition, pens):
    scores = scores_of(t0, t1, lo, hi)
    if partition or pens is not None:
        scores = _apply_masks(scores, tgt_meta[t0:t1], db_meta[lo:hi], partition, pens)
    return scores


def _exact_select(T, k, m_rows, scores_of, tgt_meta, db_meta, partition, pens,
                  t_block, chunk):
    """Exact (score, index) top-k over DB rows [0, m_rows), "stream" and
    "phase": the lowest index wins ties and a slot with no finite score
    reads (+inf, 0)."""
    out_i, out_v = [], []
    for t0 in range(0, T, t_block):
        t1 = min(t0 + t_block, T)
        vals, cols = [], []
        for lo in range(0, m_rows, chunk):
            hi = min(lo + chunk, m_rows)
            scores = _masked_scores(scores_of, t0, t1, lo, hi, tgt_meta, db_meta,
                                    partition, pens)
            v, c = smallest_k(scores, min(k, hi - lo),
                              torch.arange(lo, hi, device=scores.device))
            vals.append(v)
            cols.append(c)
        v, c = smallest_k(torch.cat(vals, 1), k, torch.cat(cols, 1))
        out_i.append(torch.where(torch.isinf(v), 0, c).to(torch.int32))
        out_v.append(v)
    return torch.cat(out_i), torch.cat(out_v)


def _key_pairs(keys, rows):
    """(key, row) as one int64 whose order is the pair's; :data:`_NO_PAIR`
    where the key is :data:`KEY_EMPTY`."""
    pairs = (keys.to(torch.int64) << 32) | rows.to(torch.int64)
    return torch.where(keys == KEY_EMPTY, _NO_PAIR, pairs)


def _packed_select(T, k, m_rows, scores_of, tgt_meta, db_meta, partition, pens,
                   t_block, chunk, three: bool):
    """The packed selections over DB rows [0, m_rows).  "packed": the k
    least (key, row) pairs.  ``three`` ("packed3"'s fast path): the k least
    among each 128-row block's three least keys, and per target the flag
    ``least third key of any block < worst kept key`` (:data:`KEY_EMPTY`
    while the list has room).  A score that is not below +inf takes no key.
    Returns (indices (T, k) int32, unpacked scores (T, k) f32, flags (T,)
    int32 or None); a slot no key reaches reads (+inf, 0)."""
    if three and chunk % BLOCK_ROWS:
        raise ValueError(f"chunk={chunk} must be a multiple of {BLOCK_ROWS}")
    out_i, out_v, out_f = [], [], []
    for t0 in range(0, T, t_block):
        t1 = min(t0 + t_block, T)
        best, third = [], None
        for lo in range(0, m_rows, chunk):
            hi = min(lo + chunk, m_rows)
            scores = _masked_scores(scores_of, t0, t1, lo, hi, tgt_meta, db_meta,
                                    partition, pens)
            rows = torch.arange(lo, hi, device=scores.device)
            keys = torch.where(scores < float("inf"), packed_keys(scores, rows), KEY_EMPTY)
            if three:
                pad = -(hi - lo) % BLOCK_ROWS
                keys = torch.nn.functional.pad(keys, (0, pad), value=KEY_EMPTY)
                keys = keys.reshape(t1 - t0, -1, BLOCK_ROWS)
                keys = torch.topk(keys, 3, dim=2, largest=False, sorted=True).values
                least = keys[:, :, 2].min(dim=1).values
                third = least if third is None else torch.minimum(third, least)
                starts = lo + BLOCK_ROWS * torch.arange(keys.shape[1], device=keys.device)
                rows = (starts[None, :, None] + (keys & (BLOCK_ROWS - 1))).flatten(1)
                keys = keys.flatten(1)
            pairs = _key_pairs(keys, rows)
            best.append(torch.topk(pairs, min(k, pairs.shape[1]), dim=1, largest=False,
                                   sorted=True).values)
        pairs = torch.cat(best, 1)
        if pairs.shape[1] < k:                           # fewer than k / 3 blocks
            pairs = torch.nn.functional.pad(pairs, (0, k - pairs.shape[1]), value=_NO_PAIR)
        pairs = torch.topk(pairs, k, dim=1, largest=False, sorted=True).values
        keys = (pairs >> 32).to(torch.int32)             # _NO_PAIR: KEY_EMPTY
        out_i.append(torch.where(pairs == _NO_PAIR, 0, pairs & 0xFFFFFFFF).to(torch.int32))
        out_v.append(from_key(keys))
        if three:
            out_f.append((third < keys[:, -1]).to(torch.int32))
    return torch.cat(out_i), torch.cat(out_v), torch.cat(out_f) if three else None


def _plain_select(T, k, m_rows, scores_of, tgt_meta, db_meta, partition, ling_weights,
                  t_block, chunk, select="stream", comp=None):
    """The chunk loop of both twins at one selection: ``scores_of(t0, t1,
    lo, hi)`` gives the (t1 - t0, hi - lo) ranking scores of targets
    [t0, t1) against rows [lo, hi); the fused masks go on in the kernel's
    order; ``comp`` (T,) is added to the selected scores.  Returns (indices
    (T, k) int32, scores (T, k) f32), ascending, and for "packed3diag" the
    (T,) int32 overflow flags as well."""
    if select not in SELECTS:
        raise ValueError(f"unknown select {select!r}; have {SELECTS}")
    pens = None if ling_weights is None else penalty_constants(ling_weights)
    args = (T, k, m_rows, scores_of, tgt_meta, db_meta, partition, pens, t_block, chunk)
    flags = None
    if select in ("packed", "packed3", "packed3diag"):
        idx, vals, flags = _packed_select(*args, three=select != "packed")
    if select in ("stream", "phase") or (select == "packed3" and bool(flags.any())):
        idx, vals = _exact_select(*args)
    if comp is not None:
        vals = vals + comp[:, None]
    return (idx, vals, flags) if select == "packed3diag" else (idx, vals)


def topk_preselect_zt_plain(targets, raw_block, k, db_affine, m_rows, *,
                            tgt_meta=None, db_meta=None, partition=False,
                            ling_weights=None, precision: str = "highest",
                            select: str = "stream", t_block: int = 4096,
                            chunk: int = 65536, voice_spans=None):
    """Plain PyTorch twin of the zero-transient kernel: the same algebra in
    chunked matmuls (:func:`cross_products` at ``precision``), the fused
    masks in the kernel's order, and the selection ``select`` (module
    docstring; "stream" and "phase": exact (score, index) selection, lowest
    index wins ties; a slot with no finite score reads (+inf, 0) in all).
    ``ling_weights`` (w0..w4, scale) turns the quinphone penalties on,
    ``partition`` the voice mask; both read the (rows, META_WIDTH)
    ``tgt_meta`` / ``db_meta`` of :func:`pack_meta`.  The packed selections
    rank the scores before ``comp`` is added.  The result does not depend on
    ``t_block`` or ``chunk`` (a multiple of 128 for "packed3").  The twin
    scans every row: ``voice_spans`` (the kernel's) is taken and unused.

    Returns (indices (T, k) int32, scores (T, k) f32), ascending, and for
    "packed3diag" the (T,) int32 overflow flags."""
    masked = partition or ling_weights is not None
    kernel_name(partition, ling_weights is not None, precision, select=select)
    _check(targets, raw_block, k, m_rows, tgt_meta, db_meta, masked, db_affine=db_affine)
    kd = targets.shape[1]
    t2, comp = _prescale(targets, db_affine)

    def scores_of(t0, t1, lo, hi):
        rows = raw_block[lo:hi]
        return rows[:, kd][None, :] - 2.0 * cross_products(t2[t0:t1], rows[:, :kd],
                                                            precision)

    return _plain_select(targets.shape[0], k, m_rows, scores_of, tgt_meta, db_meta,
                         partition, ling_weights, t_block, chunk, select, comp)


def derive_operand(raw_block, db_affine, n_real, m_rows: int, precision: str = "highest"):
    """The derived DB operand of one step and its squared row norms
    (``pallas_topk.py:795-811``; ``split3cat_db`` :112-125 in the port's
    layout).  Rows [0, m_rows) of the raw block are normalised and weighted
    as :func:`~snickery_tpu_torch.voicedb.device_layout.affine_rows` does
    it, ``((x - mean) / std) * sqrt_w``, and rows at or past ``n_real`` (an
    int or a 0-dim tensor) are pinned to ``1e6 * sqrt_w``; ``sqn`` (m_rows,)
    f32 sums their squares.  At "highest" and "split3" the operand is that
    (m_rows, kd) f32 array.  At "split3cat" it is (m_rows,
    :func:`presplit_width`) bf16 rows ``[hi | lo]``, ``hi = bf16(x)`` and
    ``lo = bf16(x - hi)`` (:func:`split_bf16`), each half zero past kd.

    Plain PyTorch, as the JAX wrapper derives it inside its jit each call:
    the elementwise passes write one array in place, and at "split3cat" the
    f32 array is turned into the residual in place and freed on return.
    Returns (operand, sqn)."""
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}; have {PRECISIONS}")
    mean, std, w = db_affine
    kd = mean.shape[0]
    dbn = raw_block[:m_rows, :kd].sub(mean).div_(std).mul_(w)
    valid = torch.arange(m_rows, device=dbn.device) < n_real
    torch.where(valid[:, None], dbn, 1e6 * w, out=dbn)
    sqn = torch.sum(dbn * dbn, dim=-1)
    if precision != "split3cat":
        return dbn, sqn
    kp = presplit_width(kd) // 2
    operand = torch.zeros((m_rows, 2 * kp), dtype=torch.bfloat16, device=dbn.device)
    operand[:, :kd] = dbn                       # hi, rounded to nearest even
    dbn -= operand[:, :kd]                      # x - hi, exact in f32
    operand[:, kp:kp + kd] = dbn                # lo
    return operand, sqn


def topk_preselect_dv_plain(targets, operand, sqn, k, m_rows, *, tgt_meta=None,
                            db_meta=None, partition=False, ling_weights=None,
                            precision: str = "highest", select: str = "stream",
                            t_block: int = 4096, chunk: int = 65536, voice_spans=None):
    """Plain PyTorch twin of the derived-operand kernel: ``sqn - 2 * u.t``
    of the normalised, weighted targets against the operand of
    :func:`derive_operand` at ``precision`` (its pre-split halves at
    "split3cat"), in the chunk loop of :func:`topk_preselect_zt_plain`
    with the same masks and selections, nothing added back (every row
    scanned; ``voice_spans`` unused).

    Returns (indices (T, k) int32, scores (T, k) f32), ascending, and for
    "packed3diag" the (T,) int32 overflow flags."""
    masked = partition or ling_weights is not None
    kernel_name(partition, ling_weights is not None, precision, False, select)
    _check(targets, operand, k, m_rows, tgt_meta, db_meta, masked, sqn=sqn,
           precision=precision)
    kd = targets.shape[1]

    def scores_of(t0, t1, lo, hi):
        rows = operand[lo:hi]
        if precision == "split3cat":
            rows = presplit_halves(rows, kd)
        return sqn[lo:hi][None, :] - 2.0 * cross_products(targets[t0:t1], rows, precision)

    return _plain_select(targets.shape[0], k, m_rows, scores_of, tgt_meta, db_meta,
                         partition, ling_weights, t_block, chunk, select)


def _kernel():
    """The kernel library with its entry points typed, built at first use
    (thread-safe)."""
    with _LOCK:
        return _bound_library()


@functools.cache
def _bound_library():
    from snickery_tpu_torch.ops._build import kernel_library
    lib = kernel_library().lib
    for name in ALL_ENTRY_POINTS:
        fn = getattr(lib, "snk_" + name)
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_float] * 5
                       + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    lib.snk_topk_partial_smem.argtypes = [ctypes.c_int] * 5
    lib.snk_topk_partial_smem.restype = ctypes.c_size_t
    lib.snk_topk_tile_rows.argtypes = [ctypes.c_int] * 6
    lib.snk_topk_tile_rows.restype = ctypes.c_int
    lib.snk_topk_db_tile_rows.argtypes = [ctypes.c_int]
    lib.snk_topk_db_tile_rows.restype = ctypes.c_int
    lib.snk_topk_block_rows.restype = ctypes.c_int
    if lib.snk_topk_block_rows() != BLOCK_ROWS:
        raise RuntimeError("the kernels' packed3 block is not BLOCK_ROWS")
    lib.snk_topk_cluster_ctas.restype = ctypes.c_int
    if lib.snk_topk_cluster_ctas() != CLUSTER_CTAS:
        raise RuntimeError("the kernels' cluster is not CLUSTER_CTAS")
    lib.snk_topk_max_clusters.argtypes = [ctypes.c_int] * 3
    lib.snk_topk_max_clusters.restype = ctypes.c_int
    return lib


def max_active_clusters(kd: int, k: int, cluster: int, device=None) -> int:
    """Clusters of ``cluster`` CTAs of the "split3cat" first pass (zero-transient
    form, no masks, the tile of a large batch) that the card holds at once at
    this kd and k (``cudaOccupancyMaxActiveClusters``)."""
    with torch.cuda.device(device if device is not None else torch.cuda.current_device()):
        got = _kernel().snk_topk_max_clusters(kd, k, cluster)
    if got < 0:
        raise RuntimeError(f"cudaOccupancyMaxActiveClusters failed: cudaError_t {-got}")
    return got


def launch_shape(n_tiles: int, precision: str, partition: bool,
                 presplit: bool) -> tuple[int, int]:
    """(CTAs a cluster, target tiles of the grid) of the first pass over
    ``n_tiles`` target tiles.  At the split precisions the producer of a CTA
    loads f32 DB rows and splits them into bf16 hi / lo; a cluster of
    :data:`CLUSTER_CTAS` CTAs holds that many target tiles over the same
    rows and splits each stage once for all of them, so two tiles or more
    run clustered, their count padded with dead tiles (no live target:
    nothing written) to a whole number of clusters.  Not at "highest"
    (no split), not on the pre-split operand (nothing to split), not with
    the partition mask (a tile scans its own voices' rows), not for a single
    tile (a stream chunk): one CTA a cluster, the grid as it is."""
    if precision == "highest" or partition or presplit or n_tiles < 2:
        return 1, n_tiles
    return CLUSTER_CTAS, -(-n_tiles // CLUSTER_CTAS) * CLUSTER_CTAS


@functools.lru_cache(maxsize=512)
def split_plan(T: int, m_rows: int, n_sm: int, tile_rows: int,
               db_tile_rows: int, cold_rows: int = COLD_ROWS) -> tuple[int, int]:
    """(splits S, rows per split) for the kernel's first pass, which runs
    one CTA an SM on a grid of (target tiles) x S over the ``m_rows`` rows
    a target tile scans (the whole DB, or with the partition mask the
    longest voice and the padding rows, :attr:`VoiceSpans.longest`): each
    split a whole number of DB tiles, none empty, and none shorter than
    :data:`MIN_SPLIT_ROWS` while there are that many rows.  (A tile with
    more rows, one that holds two voices, gives each CTA several chunks of
    ``rows per split``: :func:`cta_rows`.)  Every CTA starts with empty
    lists, which take the first rows it sees whatever their scores, and that
    start costs about what ``cold_rows`` rows of the stream cost.  So S is
    the one that makes ``waves x (rows per split + cold_rows)`` least,
    ``waves`` the number of rounds the card needs for the grid: one full
    wave where the target tiles alone do not fill the card, and no needless
    splits where they do."""
    n_tiles = -(-T // tile_rows)
    most = max(1, min(-(-m_rows // db_tile_rows), m_rows // MIN_SPLIT_ROWS,
                      -(-_MAX_WAVES * n_sm // n_tiles)))
    best = None
    for want in range(1, most + 1):
        rows = -(-m_rows // want)
        rows = -(-rows // db_tile_rows) * db_tile_rows
        splits = -(-m_rows // rows)
        cost = -(-n_tiles * splits // n_sm) * (rows + cold_rows)
        if best is None or cost < best[0]:
            best = (cost, splits, rows)
    return best[1], best[2]


def cuda_topk_preselect(targets, raw_block, k, db_affine, m_rows, *,
                        tgt_meta=None, db_meta=None, partition=False,
                        ling_weights=None, precision: str = "highest",
                        zero_transient: bool = True, sqn=None, select: str = "stream",
                        voice_spans: VoiceSpans | None = None):
    """Top-k DB rows per target: exact at precision "highest", ranked by the
    bf16-split products at "split3" / "split3cat".

    Zero-transient form (the default):
    ``targets`` (T, kd) f32: normalised, weighted target rows.
    ``raw_block`` (q, kd + 2) f32: the resident ``[data | sqn | ptr]`` block.
    ``db_affine`` = (mean, std, sqrt_w), each (kd,) f32.
    Derived form (``zero_transient=False``, config ``zero_transient: 0``):
    ``raw_block`` is the operand :func:`derive_operand` made at
    ``precision``, ``sqn`` its (>= m_rows,) squared row norms and
    ``db_affine`` None.
    ``m_rows``: DB rows to scan (rows beyond are halo / exception tail).
    ``partition``: restrict each target to the rows of its voice id;
    ``ling_weights`` (w0..w4, scale): add the quinphone penalties; either
    reads ``tgt_meta`` (T, 8) and ``db_meta`` (>= m_rows, 8) int32
    (:func:`pack_meta`).  ``voice_spans``: the :class:`VoiceSpans` of the
    DB's ids (``DeviceDB.spans``), with which the partition variants scan
    each target tile's own voice rows only; without them the wrapper makes
    them from ``db_meta`` (one host synchronisation).
    ``select``: the selection form (:data:`SELECTS`, module docstring); the
    synthesis paths run "stream".  "packed3" reads its overflow flags back
    to the host (one synchronisation) and, if any is set, launches the
    stream kernel and returns its result.
    Returns (indices (T, k) int32, scores (T, k) f32): the k best
    (score, index) pairs ((key, index) pairs at a packed selection), scores
    = squared distance (plus penalties) minus ||t||^2, (+inf, 0) in a slot
    no row reaches; for "packed3diag" also the (T,) int32 overflow flags.
    On a CUDA device the hand-written kernel of the variant and selection
    runs (ascending order); on the CPU the plain twin of the form."""
    kw = dict(tgt_meta=tgt_meta, db_meta=db_meta, partition=partition,
              ling_weights=ling_weights, precision=precision, voice_spans=voice_spans)
    if select not in SELECTS:
        raise ValueError(f"unknown select {select!r}; have {SELECTS}")
    if zero_transient != (sqn is None):
        raise ValueError("sqn goes with zero_transient=False (the derived operand), "
                         "and only with it")
    if not zero_transient and db_affine is not None:
        raise ValueError("the derived operand is normalised already: db_affine "
                         "must be None")
    if raw_block.device.type == "cpu":
        if zero_transient:
            return topk_preselect_zt_plain(targets, raw_block, k, db_affine, m_rows,
                                           select=select, **kw)
        return topk_preselect_dv_plain(targets, raw_block, sqn, k, m_rows, select=select, **kw)
    if raw_block.device.type != "cuda":
        raise ValueError(f"unsupported device {raw_block.device}")
    linguistic = ling_weights is not None
    masked = partition or linguistic
    name = kernel_name(partition, linguistic, precision, zero_transient, select)
    _check(targets, raw_block, k, m_rows, tgt_meta, db_meta, masked, db_affine=db_affine,
           sqn=sqn, precision=precision)
    lib = _kernel()
    T, kd = targets.shape
    three = select in ("packed3", "packed3diag")
    sel_code = SELECTS.index("packed3" if three else select)
    prec_code = PRECISIONS.index(precision)
    if lib.snk_topk_partial_smem(kd, k, int(masked), prec_code, sel_code) > SMEM_LIMIT:
        raise ValueError(f"kd={kd} needs more shared memory than a block has")
    if raw_block.dtype == torch.bfloat16 and raw_block.data_ptr() % 16:
        raise ValueError("the pre-split operand must start on a 16-byte boundary")
    dev = raw_block.device
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    tt = lib.snk_topk_tile_rows(kd, k, int(masked), prec_code, sel_code, T)
    cluster, _ = launch_shape(-(-T // tt), precision, partition,
                              not zero_transient and precision == "split3cat")
    spans, scan_rows = None, m_rows
    if partition:
        if voice_spans is None:
            voice_spans = voice_spans_of(db_meta[:, 6], m_rows)
        if voice_spans.m_rows != m_rows or voice_spans.table.device != dev:
            raise ValueError(f"voice_spans are of {voice_spans.m_rows} rows on "
                             f"{voice_spans.table.device}, not {m_rows} on {dev}")
        spans = tile_spans(voice_spans, tgt_meta[:T, 6], tt)
        scan_rows = voice_spans.longest
    splits, rows = split_plan(
        T, scan_rows, n_sm, tt, BLOCK_ROWS if three else lib.snk_topk_db_tile_rows(prec_code),
        max(256, COLD_ROWS * 151 // kd))
    if zero_transient:
        t2, extra = _prescale(targets, db_affine)      # the third pointer: comp
        t2 = t2.contiguous()
    else:
        t2, extra = targets, sqn                       # or sqn
    pens = penalty_constants(ling_weights) if linguistic else (0.0,) * 5
    part_v = torch.empty((T, splits, k), dtype=torch.float32, device=dev)
    part_i = torch.empty((T, splits, k), dtype=torch.int32, device=dev)
    out_v = torch.empty((T, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((T, k), dtype=torch.int32, device=dev)
    part_third = flags = None
    if three:
        part_third = torch.empty((T, splits), dtype=torch.int32, device=dev)
        flags = torch.empty((T,), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):         # the launch goes to the current card
        err = getattr(lib, "snk_" + name)(
            t2.data_ptr(), raw_block.data_ptr(), extra.data_ptr(),
            tgt_meta.data_ptr() if masked else None,
            db_meta.data_ptr() if masked else None,
            spans.data_ptr() if partition else None, *pens,
            part_v.data_ptr(), part_i.data_ptr(), part_third.data_ptr() if three else None,
            out_v.data_ptr(), out_i.data_ptr(), flags.data_ptr() if three else None,
            T, kd, raw_block.shape[1], m_rows, k, splits, rows, cluster, stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError_t {err}")
    with _LOCK:
        LAUNCH_COUNTS[name] += 1
        if cluster > 1:
            LAUNCH_COUNTS[f"{name}.cluster{cluster}"] += 1
    if select == "packed3diag":
        return out_i, out_v, flags
    if select == "packed3" and bool(flags.any()):
        return cuda_topk_preselect(targets, raw_block, k, db_affine, m_rows,
                                   zero_transient=zero_transient, sqn=sqn, **kw)
    return out_i, out_v

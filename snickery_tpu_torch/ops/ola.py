"""Waveform concatenation: gather + crossfade overlap-add, batched over B.

Counterpart of ``snickery_tpu.ops.ola``.  Placement semantics are the same:
a unit's nominal span ``[cut1, cut2)`` is extracted with ``taper`` extra
samples on each side, spans are placed back to back, and neighbouring
fragments overlap by ``2 * taper`` samples under complementary float32
raised-cosine ramps, so corpus-consecutive units reconstruct the corpus.

The JAX version works at 128-sample row granularity with masked rolls, a
shape chosen around a TPU gather limit.  Here only the output has to match.
:func:`overlap_add_units` dispatches on the tensors' device: a CUDA tensor
launches one hand-written kernel (``csrc/ola.cu``: a CTA owns a tile of one
utterance's output, each sample summed in a register over the fragments that
cover it, in ascending unit order, and written once; no atomics, no fragment
tensors, the zeros past the last fragment written by the kernel too); a CPU
tensor takes :func:`overlap_add_units_plain`, which gathers every fragment
sample and sums them into the output with ``index_add_``.  Nothing falls
back from one to the other.  The kernel's weights are the plain version's
(:func:`ramp_table`) and it multiplies and adds as it does, so the two agree
bit for bit.
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from snickery_tpu_torch.ops import cuda_topk

OLA_TILE = 2048          # output samples a CTA owns (csrc/ola.cu)
MAX_GRID_Y = 65535       # utterances a launch takes: the grid's second dimension
_WAVE_KINDS = {torch.float32: 0, torch.int16: 1}


def host_overlap_add(waves: np.ndarray, cut_start: np.ndarray,
                     cut_end: np.ndarray, taper: int) -> np.ndarray:
    """Numpy overlap-add of one utterance from host audio (a copy of
    ``snickery_tpu.ops.ola.host_overlap_add``, which cannot be imported
    without jax)."""
    cut_start = np.asarray(cut_start, np.int64)
    cut_end = np.asarray(cut_end, np.int64)
    spans = cut_end - cut_start
    total = int(2 * taper + spans.sum())
    out = np.zeros(total, np.float32)
    n = len(waves)
    t2 = float(2 * taper)
    anchor = taper
    for c1, c2, span in zip(cut_start, cut_end, spans):
        L = int(span) + 2 * taper
        s0 = int(c1) - taper
        frag = np.zeros(L, np.float32)
        lo, hi = max(s0, 0), min(s0 + L, n)
        if hi > lo:
            frag[lo - s0: hi - s0] = waves[lo:hi]
        pos = np.arange(L, dtype=np.float32)
        rise = 0.5 - 0.5 * np.cos(np.pi * np.clip((pos + 0.5) / t2, 0.0, 1.0))
        fall = 0.5 - 0.5 * np.cos(np.pi * np.clip((L - pos - 0.5) / t2, 0.0, 1.0))
        out[anchor - taper: anchor - taper + L] += frag * np.minimum(rise, fall)
        anchor += int(span)
    return out


def overlap_add_units_plain(waves, cut_start, cut_end, n_units, max_frag: int,
                            out_len: int, taper: int, wave_scale=1.0):
    """The plain PyTorch version of :func:`overlap_add_units`: every
    (B, U, ``max_frag``) fragment slot gathered and summed into the output
    with ``index_add_``.

    ``waves`` (S,) corpus audio, float32 or int16 (audio = waves *
    ``wave_scale``); ``cut_start``/``cut_end`` (B, U) anchor and end samples;
    ``n_units`` (B,) live units (slots at or past it contribute nothing);
    ``max_frag`` the longest fragment including ``2 * taper``.
    Returns (audio (B, out_len) f32, total samples (B,) int64).
    """
    B, U = cut_start.shape
    dev = cut_start.device
    live = (torch.arange(U, device=dev)[None, :]
            < torch.as_tensor(n_units, device=dev).reshape(B, 1))
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    span = torch.where(live, (cut_end - cut_start).long(), zero)
    anchors = taper + torch.cumsum(span, dim=1) - span
    total = 2 * taper + span.sum(dim=1)
    frag_len = torch.where(live, span + 2 * taper, zero)

    p = torch.arange(max_frag, device=dev)
    src = cut_start.long()[:, :, None] - taper + p                 # (B, U, F)
    inside = p < frag_len[:, :, None]
    in_corpus = (src >= 0) & (src < waves.shape[0])
    x = waves[src.clamp(0, waves.shape[0] - 1)].to(torch.float32)
    x = x * torch.as_tensor(wave_scale, dtype=torch.float32, device=dev)

    pos = p.to(torch.float32)
    L = frag_len.to(torch.float32)[:, :, None]
    t2 = float(2 * taper)
    rise = 0.5 - 0.5 * torch.cos(math.pi * torch.clamp((pos + 0.5) / t2, 0.0, 1.0))
    fall = 0.5 - 0.5 * torch.cos(math.pi * torch.clamp((L - pos - 0.5) / t2, 0.0, 1.0))
    dst = anchors[:, :, None] - taper + p                         # (B, U, F)
    keep = inside & in_corpus & (dst < out_len)
    vals = torch.where(keep, x * torch.minimum(rise, fall), 0.0)
    flat = torch.where(keep, dst + (torch.arange(B, device=dev) * out_len)[:, None, None],
                       zero)
    out = torch.zeros(B * out_len, dtype=torch.float32, device=dev)
    out.index_add_(0, flat.reshape(-1), vals.reshape(-1))
    return out.reshape(B, out_len), total


def ramp_table(taper: int) -> torch.Tensor:
    """(2 * taper + 1,) f32 on the CPU: the plain version's raised-cosine
    rise at positions 0..2 * taper (1.0 from 2 * taper on), computed with its
    own f32 formula.  The kernel weighs sample p of a fragment of L samples
    by ``min(t[min(p, 2 taper)], t[min(L - 1 - p, 2 taper)])``: the plain
    version's fall at p is its rise at L - 1 - p, the same f32 operands."""
    pos = torch.arange(2 * taper + 1, dtype=torch.float32)
    t2 = float(2 * taper)
    return 0.5 - 0.5 * torch.cos(math.pi * torch.clamp((pos + 0.5) / t2, 0.0, 1.0))


@functools.cache
def _device_ramp(taper: int, index: int) -> torch.Tensor:
    """:func:`ramp_table` on card ``index``, copied there once a process."""
    return ramp_table(taper).to(torch.device("cuda", index))


def ola_grid(B: int, out_len: int) -> tuple[int, int]:
    """The kernel's grid: (tiles of :data:`OLA_TILE` output samples, B).
    Raises ValueError past :data:`MAX_GRID_Y` utterances."""
    if B > MAX_GRID_Y:
        raise ValueError(f"the overlap-add kernel takes at most {MAX_GRID_Y} utterances "
                         f"a launch, not {B}")
    return -(-out_len // OLA_TILE), B


@functools.cache
def _library():
    """The kernel library with the overlap-add entry point typed, built and
    bound at first use (under the preselect's lock)."""
    from snickery_tpu_torch.ops._build import kernel_library
    with cuda_topk._LOCK:
        lib = kernel_library().lib
        p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        lib.snk_overlap_add.argtypes = [p, i, i64, p, p, p, p, p, i64, i64, i, i64, i64, p, p]
        lib.snk_overlap_add.restype = i
        lib.snk_overlap_add_tile.argtypes = []
        lib.snk_overlap_add_tile.restype = i
        if lib.snk_overlap_add_tile() != OLA_TILE:
            raise RuntimeError("the overlap-add kernel's tile is not OLA_TILE")
    return lib


def overlap_add_units(waves, cut_start, cut_end, n_units, max_frag: int,
                      out_len: int, taper: int, wave_scale=1.0):
    """Concatenate selected units of B utterances.

    ``waves`` (S,) corpus audio, float32 or int16 (audio = waves *
    ``wave_scale``, a scalar tensor or a number); ``cut_start`` /
    ``cut_end`` (B, U) anchor and end samples (spans not negative);
    ``n_units`` (B,) live units (slots at or past it contribute nothing);
    ``max_frag`` the longest fragment including ``2 * taper``.
    Returns (audio (B, out_len) f32, total samples (B,) int64).  On a CUDA
    device one launch of ``snk_overlap_add`` (counted in
    ``cuda_topk.LAUNCH_COUNTS["overlap_add"]``), nothing read back to the
    host; on the CPU :func:`overlap_add_units_plain`."""
    dev = cut_start.device
    if dev.type == "cpu":
        return overlap_add_units_plain(waves, cut_start, cut_end, n_units, max_frag, out_len,
                                       taper, wave_scale)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if waves.device != dev or cut_end.device != dev:
        raise ValueError(f"the waves lie on {waves.device}, the cut points on {dev} "
                         f"and {cut_end.device}")
    if waves.dtype not in _WAVE_KINDS:
        raise ValueError(f"the overlap-add kernel reads float32 or int16 waves, not {waves.dtype}")
    if waves.dim() != 1 or not waves.is_contiguous():
        raise ValueError("the overlap-add kernel reads a contiguous (S,) wave")
    if cut_start.dim() != 2 or cut_end.shape != cut_start.shape:
        raise ValueError(f"cut points {tuple(cut_start.shape)} and {tuple(cut_end.shape)} "
                         f"are not both (B, U)")
    B, U = cut_start.shape
    tiles, _ = ola_grid(B, out_len)
    n_live = torch.as_tensor(n_units, device=dev).to(torch.int64).reshape(B).contiguous()
    live = torch.arange(U, device=dev)[None, :] < n_live[:, None]
    span = torch.where(live, (cut_end - cut_start).long(), 0)
    incl = torch.cumsum(span, dim=1)
    total = 2 * taper + span.sum(dim=1)
    out = torch.empty((B, out_len), dtype=torch.float32, device=dev)
    if tiles == 0 or B == 0:
        return out, total
    scale = torch.as_tensor(wave_scale, dtype=torch.float32, device=dev).reshape(())
    starts = cut_start.long().contiguous()
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    lib = _library()
    with torch.cuda.device(dev):
        err = lib.snk_overlap_add(
            waves.data_ptr(), _WAVE_KINDS[waves.dtype], waves.shape[0], scale.data_ptr(),
            starts.data_ptr(), incl.data_ptr(), n_live.data_ptr(),
            _device_ramp(taper, index).data_ptr(), taper, max_frag, B, U, out_len,
            out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"overlap_add launch failed: cudaError_t {err}")
    with cuda_topk._LOCK:
        cuda_topk.LAUNCH_COUNTS["overlap_add"] += 1
    return out, total

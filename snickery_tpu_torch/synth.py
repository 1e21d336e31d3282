"""Synthesiser in PyTorch: unit-selection synthesis from a resident unit DB.

Counterpart of ``snickery_tpu.synth`` for epoch-unit voices (BASELINE
config #3), halfphone voices (#2), merged multi-voice DBs (#5), merged
halfphone voices and streaming synthesis (#4): normalise and weight the
targets, preselect the top k + margin over the whole DB with the
hand-written kernel (reading the resident raw block, or with config
``zero_transient: 0`` an operand derived from it each step; exact at
precision "highest" or ranked by bf16-split products at "split3" /
"split3cat", at each precision with the quinphone penalties fused for
halfphone voices and the voice partition mask for merged DBs),
rescore the candidates in exact f32 and keep the top k in canonical
(score, unit id) order (halfphone voices rank by the exact squared distance
plus penalties and mask identity fallbacks in the lattice), gather join
contexts, decode with the Viterbi (or greedy) kernel, one launch a batch
with the backtrack on the card, and crossfade overlap-add on the device or,
with ``preload_all_waves=False``, on the host.  One batched step
(:func:`synth_pipeline_step`) serves ``synth_from_features`` (B = 1) and
``synth_batch``; :func:`streaming_step` serves ``synth_streaming``.

The device is an explicit argument.  ``device="cuda"`` runs the CUDA kernels
and raises where CUDA is absent; ``device="cpu"`` runs the kernels' plain
PyTorch twins.  Nothing falls back from one to the other.

With config ``mesh_data`` / ``mesh_db`` above 1, ``synth_batch`` runs
:func:`snickery_tpu_torch.parallel.batched_synth_step` over a (data, db)
mesh of devices (``ensure_sharded``); ``synth_from_features`` and
``synth_streaming`` stay on one device, as in the JAX package.

``resynth_magphase`` renders selected units by magphase resynthesis of
their features (optionally join-smoothed, optionally on the target's f0)
on the same device.
"""

from __future__ import annotations

import contextlib
import math
import time
from dataclasses import dataclass, field, fields

import numpy as np
import torch

from snickery_tpu_torch import utils
from snickery_tpu_torch.config import SnickeryConfig
from snickery_tpu_torch.voicedb.db import VoiceDB
from snickery_tpu_torch.const import QUINPHONE_CONTEXT_WEIGHTS, QUINPHONE_SCALE
from snickery_tpu_torch.ops.cuda_topk import (PRECISIONS, VoiceSpans, cuda_topk_preselect,
                                              derive_operand, pack_meta, voice_spans_of)
from snickery_tpu_torch.ops.ola import host_overlap_add, overlap_add_units
from snickery_tpu_torch.ops.topk import (halfphone_exact_rank,
                                         halfphone_lattice_mask,
                                         order_topk_positions, preselect_margin,
                                         resolve_zero_transient)
from snickery_tpu_torch.ops.viterbi import (greedy_decode, greedy_decode_stream,
                                            viterbi_decode)
from snickery_tpu_torch.voicedb.device_layout import (affine_rows,
                                                      build_raw_blocks,
                                                      gather_join_contexts)

# DB rows are padded as the JAX package pads them (its Pallas CHUNK), so the
# padded unit count and the raw block are the same on both sides.
JAX_PALLAS_CHUNK = 4096
# preselection_method="quinphone_backoff": strict tiers (one outer-context
# mismatch 2^14, one inner-context mismatch 2^22), as snickery_tpu.synth
BACKOFF_LING_WEIGHTS = (1.0, 256.0, 0.0, 256.0, 1.0, 16384.0)


def _stream_weight_vector(cfg: SnickeryConfig, weights: list[float]) -> np.ndarray:
    out = np.zeros(cfg.target_dim, np.float32)
    for (name, a, b), w in zip(cfg.stream_slices, weights):
        out[a:b] = w
    return out


@dataclass
class DeviceDB:
    """The resident voice: tensors on one device, fields as in the JAX
    ``DeviceDB`` (see ``snickery_tpu.synth.DeviceDB``), plus ``meta``, the
    kernel's per-row ``[code, ctx0..ctx4, voice id, 0]`` block derived from
    ``codes``, ``ctx`` and ``vids`` (8 int32, 32 bytes a row), and
    ``spans``, the rows of each voice id (``cuda_topk.voice_spans_of``), with
    which the partition kernels scan a target tile's own voice only."""
    raw: torch.Tensor         # (q, kd + 2) [data | sqn | ptr] raw block
    n_real: torch.Tensor      # () int32: rows >= n_real are padding
    cut1: torch.Tensor        # (Mp,) int32
    cut2: torch.Tensor        # (Mp,) int32
    waves: torch.Tensor       # (S,) f32, or int16; (128,) zeros placeholder
                              # when the audio stays on the host
    wave_scale: torch.Tensor  # () f32: audio = waves * wave_scale
    mean_t: torch.Tensor      # (kd,)
    std_t: torch.Tensor
    sqrt_wt: torch.Tensor
    mean_j: torch.Tensor      # (dj,)
    std_j: torch.Tensor
    sqrt_wj: torch.Tensor
    codes: torch.Tensor       # (Mp,) halfphone codes (zeros in epoch mode)
    ctx: torch.Tensor         # (Mp, 5)
    vids: torch.Tensor        # (Mp,) voice ids
    meta: torch.Tensor = field(init=False)   # (Mp, 8) int32, derived

    def __post_init__(self):
        self.meta = pack_meta(self.codes, self.ctx, self.vids)
        # an attribute, not a field: the fields are the JAX DeviceDB's tensors
        self.spans: VoiceSpans = voice_spans_of(self.vids, self.vids.shape[0])

    @property
    def nbytes(self) -> int:
        return sum(getattr(self, f.name).nbytes for f in fields(self))


# the fields the JAX DeviceDB has (``meta`` is derived from them)
JAX_FIELDS = tuple(f.name for f in fields(DeviceDB) if f.init)


def device_db_from_numpy(arrays: dict[str, np.ndarray], device) -> DeviceDB:
    """Build a :class:`DeviceDB` on ``device`` from numpy arrays keyed by
    field name (for example the JAX ``DeviceDB``'s fields, fetched to the
    host).  Dtypes and values are kept bit for bit."""
    names = JAX_FIELDS
    missing = set(names) - set(arrays)
    if missing:
        raise KeyError(f"missing DeviceDB fields: {sorted(missing)}")
    return DeviceDB(**{n: torch.from_numpy(np.array(arrays[n], copy=True)).to(device)
                       for n in names})


def _stage_fn(stage_timer, device):
    def stage(name):
        if stage_timer is None:
            return contextlib.nullcontext()
        return _synced_stage(stage_timer, name, device)
    return stage


def _candidates(db: DeviceDB, targets, lengths, tgt_codes, tgt_ctx, tgt_vids, *,
                n_cand: int, margin: int, halfphone: bool, multivoice: bool,
                ling_weights: tuple | None, precision: str, zero_transient: int,
                stage):
    """Normalise and weight the (B, T, kd) targets, preselect k + margin with
    the kernel at ``precision`` (:func:`preselect`), rescore in exact f32 and
    keep ``n_cand``.  Returns (live (B, T), candidate ids (B*T, n), target
    costs (B*T, n), join-left and join-right contexts (B*T, n, dj))."""
    stage = stage or _stage_fn(None, targets.device)
    tw, live, idx, scores, ling = preselect(
        db, targets, lengths, tgt_codes, tgt_ctx, tgt_vids, n_cand=n_cand,
        margin=margin, halfphone=halfphone, multivoice=multivoice,
        ling_weights=ling_weights, precision=precision,
        zero_transient=zero_transient, stage=stage)
    with stage("rescore"):
        cand_idx, target_costs, jl, jr = _rescore(db, tw, idx, scores, live, n_cand, ling)
    return live, cand_idx, target_costs, jl, jr


def preselect(db: DeviceDB, targets, lengths, tgt_codes, tgt_ctx, tgt_vids, *,
              n_cand: int, margin: int, halfphone: bool, multivoice: bool,
              ling_weights: tuple | None, precision: str, zero_transient: int,
              stage=None):
    """Normalise and weight the (B, T, kd) targets (steps past ``lengths``
    zeroed) and preselect ``k = min(n_cand + margin, rows of db)`` with the
    kernel at ``precision`` over the ``db.cut1.shape[0]`` rows of ``db`` (a
    whole DB or one shard of it).  ``zero_transient`` (config key: -1 auto,
    0, 1) picks the kernel's operand: the resident raw block, or (0) the
    operand derived from it for this step (stage "derive", rows at or past
    ``db.n_real`` pinned), with the margin of that form (none at "highest").
    Returns (weighted targets (B*T, kd), live (B, T), ids (B*T, k) int64,
    kernel scores (B*T, k), ``ling`` = (codes, contexts, weights) in
    halfphone mode or None)."""
    stage = stage or _stage_fn(None, targets.device)
    B, T, kd = targets.shape
    dev = targets.device
    m_pad = db.cut1.shape[0]
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    tw = (targets - db.mean_t) / db.std_t
    tw = tw * db.sqrt_wt
    live = torch.arange(T, device=dev)[None, :] < lengths.reshape(B, 1)
    tw = torch.where(live[:, :, None], tw, zero).reshape(B * T, kd)

    if halfphone and ling_weights is None:
        ling_weights = (*QUINPHONE_CONTEXT_WEIGHTS, QUINPHONE_SCALE)
    masks = fused_masks(db, tgt_codes, tgt_ctx, tgt_vids, halfphone=halfphone,
                        multivoice=multivoice, ling_weights=ling_weights)
    ling = ((tgt_codes.reshape(B * T), tgt_ctx.reshape(B * T, 5), ling_weights)
            if halfphone else None)
    aff = (db.mean_t, db.std_t, db.sqrt_wt)
    zt = resolve_zero_transient(zero_transient, precision)
    k_sel = min(n_cand + preselect_margin(True, precision, halfphone,
                                          zero_transient=zt, override=margin),
                m_pad)
    if zt:
        with stage("preselect"):
            idx, scores = cuda_topk_preselect(tw, db.raw, k_sel, aff, m_pad,
                                              precision=precision, **masks)
    else:
        with stage("derive"):
            operand, sqn = derive_operand(db.raw, aff, db.n_real, m_pad, precision)
        with stage("preselect"):
            idx, scores = cuda_topk_preselect(tw, operand, k_sel, None, m_pad,
                                              precision=precision, zero_transient=False,
                                              sqn=sqn, **masks)
        del operand, sqn
    return tw, live, idx.long(), scores, ling


def _concatenate(db: DeviceDB, unit_ids, live, lengths, *, do_ola: bool,
                 max_frag: int, out_len: int, taper: int):
    """(audio (B, out_len), total samples (B,)) of the (B, T) unit ids
    (:func:`concatenate_cuts` of their cut points)."""
    return concatenate_cuts(db, torch.where(live, db.cut1[unit_ids], 0),
                            torch.where(live, db.cut2[unit_ids], 0), lengths,
                            do_ola=do_ola, max_frag=max_frag, out_len=out_len,
                            taper=taper)


def concatenate_cuts(db: DeviceDB, cut1, cut2, lengths, *, do_ola: bool,
                     max_frag: int, out_len: int, taper: int):
    """(audio (B, out_len), total samples (B,)) of (B, T) unit cut points
    (0 past each length) from ``db``'s waves: the device OLA, or with
    ``do_ola=False`` (audio kept on the host) an (B, 8) zeros placeholder
    and the exact totals ``2 * taper + sum of spans``."""
    if do_ola:
        return overlap_add_units(db.waves, cut1, cut2, lengths, max_frag=max_frag,
                                 out_len=out_len, taper=taper,
                                 wave_scale=db.wave_scale)
    totals = 2 * taper + (cut2 - cut1).long().sum(dim=1)
    return torch.zeros((cut1.shape[0], 8), dtype=torch.float32,
                       device=cut1.device), totals


def synth_pipeline_step(db: DeviceDB, targets: torch.Tensor,
                        lengths: torch.Tensor, tgt_codes: torch.Tensor | None = None,
                        tgt_ctx: torch.Tensor | None = None,
                        tgt_vids: torch.Tensor | None = None, *, n_cand: int,
                        jcw: float, eps: float, max_frag: int, out_len: int,
                        taper: int, greedy: bool = False,
                        squared_joins: bool = False, margin: int = -1,
                        halfphone: bool = False, multivoice: bool = False,
                        ling_weights: tuple | None = None,
                        precision: str = "highest", zero_transient: int = -1,
                        do_ola: bool = True,
                        stage_timer: utils.StageTimer | None = None):
    """Select, decode and concatenate B utterances in one step.

    ``targets`` (B, T, kd) raw unit-rate target features, ``lengths`` (B,)
    live steps.  The single-device body of the JAX batched step
    (``parallel/sharded.py::_select_decode_batch`` at one DB shard plus its
    OLA).  ``halfphone``: fuse the quinphone penalties of ``tgt_codes``
    (B, T) and ``tgt_ctx`` (B, T, 5) into the preselect (weights
    ``ling_weights`` = (w0..w4, scale), default the const values), rank the
    candidates by :func:`halfphone_exact_rank` and apply the identity
    fallback mask to the lattice costs.  ``multivoice``: restrict each step
    to the DB rows whose voice id equals ``tgt_vids`` (B, T).  Either mode
    takes all three target arrays (``Synthesiser.batch_inputs``).
    ``precision``: the kernel's ranking precision (the rank margin follows
    it); ``zero_transient``: the config key (-1 auto, 0 the derived
    operand, 1 the raw block; see :func:`_candidates`).  ``do_ola=False``:
    the audio stays on the host (see :func:`_concatenate`).  Returns
    (unit_ids (B, T), total costs (B,), audio (B, out_len), total samples
    (B,)).

    ``stage_timer``: when given, each stage (derive, with ``zero_transient:
    0``; preselect, rescore, decode, ola) is timed into it, the device
    synchronised at every stage edge; for measurement runs only, since the
    synchronisations serialise the step.
    """
    stage = _stage_fn(stage_timer, targets.device)
    _, cand_idx, target_costs, jl, jr = _candidates(
        db, targets, lengths, tgt_codes, tgt_ctx, tgt_vids, n_cand=n_cand,
        margin=margin, halfphone=halfphone, multivoice=multivoice,
        ling_weights=ling_weights, precision=precision,
        zero_transient=zero_transient, stage=stage)
    return decode_and_concatenate(db, cand_idx, target_costs, jl, jr, lengths, jcw=jcw,
                                  eps=eps, greedy=greedy, squared_joins=squared_joins,
                                  do_ola=do_ola, max_frag=max_frag, out_len=out_len,
                                  taper=taper, stage=stage)


def decode_and_concatenate(db: DeviceDB, cand_idx, target_costs, jl, jr, lengths,
                           cut_cands=None, *, jcw: float, eps: float, greedy: bool,
                           squared_joins: bool, do_ola: bool, max_frag: int, out_len: int,
                           taper: int, stage=None):
    """Decode B utterances from their kept candidates (ids and target costs
    (B*T, n), join contexts (B*T, n, dj); one launch of the Viterbi or the
    greedy kernel, which reads ``lengths`` on the device, with nothing read
    back to the host) and concatenate the chosen units from ``db``'s waves, their cut points
    looked up in ``db`` by id or, with ``cut_cands`` = (cut1, cut2) (B*T, n)
    of the candidates, picked from those (a mesh member, whose ids are
    global).  Returns (unit ids (B, T), total costs (B,), audio, total
    samples)."""
    stage = stage or _stage_fn(None, cand_idx.device)
    B, n, dj = lengths.shape[0], cand_idx.shape[1], jl.shape[-1]
    T = cand_idx.shape[0] // B
    decode = greedy_decode if greedy else viterbi_decode
    kw = {} if greedy else {"search_epsilon": eps}
    with stage("decode"):
        paths, costs = decode(target_costs.reshape(B, T, n),
                              jl.reshape(B, T, n, dj).contiguous(),
                              jr.reshape(B, T, n, dj).contiguous(),
                              join_cost_weight=jcw, length=lengths,
                              squared_joins=squared_joins, **kw)
    with stage("ola"):
        pick = paths.reshape(B * T, 1)
        live = torch.arange(T, device=lengths.device)[None, :] < lengths.reshape(B, 1)

        def chosen(x):
            return torch.where(live, torch.gather(x, 1, pick).reshape(B, T), 0)

        unit_ids = chosen(cand_idx)
        ola = dict(do_ola=do_ola, max_frag=max_frag, out_len=out_len, taper=taper)
        if cut_cands is None:
            audio, totals = _concatenate(db, unit_ids, live, lengths, **ola)
        else:
            audio, totals = concatenate_cuts(db, chosen(cut_cands[0]), chosen(cut_cands[1]),
                                             lengths, **ola)
    return unit_ids, costs, audio, totals


def streaming_step(db: DeviceDB, targets: torch.Tensor, n_live: int,
                   voice_id: int, init_ctx: torch.Tensor, jcw_first: float,
                   jcw_rest: float, *, n_cand: int, max_frag: int, out_len: int,
                   taper: int, squared_joins: bool = False, margin: int = -1,
                   multivoice: bool = False, precision: str = "highest",
                   zero_transient: int = -1, do_ola: bool = True,
                   stage_timer: utils.StageTimer | None = None):
    """One streaming chunk: preselect, rescore, greedy decode from an
    incoming join context, and the chunk's OLA (counterpart of
    ``snickery_tpu.synth._streaming_step``).

    ``targets`` (T, kd) unit-rate targets of which the first ``n_live``
    (a host int, so the step never waits on the device) are live;
    ``voice_id`` restricts the preselect to one voice of a merged DB
    (``multivoice``); ``init_ctx`` (dj,) is the join context carried from
    the previous chunk, weighted by ``jcw_first`` at the chunk's first step
    (0 at the stream's start) and by ``jcw_rest`` after it;
    ``zero_transient`` picks the kernel's operand as in
    :func:`synth_pipeline_step`.  The audio
    covers the chunk's units including both tapers; the caller crossfades
    consecutive chunks by summing the trailing ``2 * taper`` samples into
    the next chunk's head.  Returns (unit ids (T,), outgoing context (dj,),
    audio (out_len,) or the host-OLA placeholder, total samples ())."""
    stage = _stage_fn(stage_timer, targets.device)
    T, kd = targets.shape
    dev = targets.device
    dj = db.sqrt_wj.shape[0]
    lengths = torch.full((1,), n_live, dtype=torch.int64, device=dev)
    codes = torch.zeros((1, T), dtype=torch.int32, device=dev)
    step_live = torch.arange(T, device=dev)[None, :] < n_live
    vids = torch.where(step_live, voice_id, -1).to(torch.int32)
    live, cand_idx, target_costs, jl, jr = _candidates(
        db, targets.reshape(1, T, kd), lengths, codes,
        torch.zeros((1, T, 5), dtype=torch.int32, device=dev), vids,
        n_cand=n_cand, margin=margin, halfphone=False, multivoice=multivoice,
        ling_weights=None, precision=precision, zero_transient=zero_transient,
        stage=stage)
    n = cand_idx.shape[1]
    with stage("greedy"):
        path, ctx = greedy_decode_stream(target_costs, jl.reshape(T, n, dj),
                                         jr.reshape(T, n, dj), init_ctx,
                                         jcw_first, jcw_rest, n_live,
                                         squared_joins=squared_joins)
    with stage("ola"):
        sel = torch.gather(cand_idx, 1, path.reshape(T, 1)).reshape(1, T)
        unit_ids = torch.where(live, sel, 0)
        audio, total = _concatenate(db, unit_ids, live, lengths, do_ola=do_ola,
                                    max_frag=max_frag, out_len=out_len, taper=taper)
    return unit_ids[0], ctx, audio[0], total[0]


def fused_masks(db: DeviceDB, tgt_codes, tgt_ctx, tgt_vids, *, halfphone: bool,
                multivoice: bool, ling_weights: tuple | None) -> dict:
    """The fused-mask keyword arguments of :func:`cuda_topk_preselect` for a
    step's (B, T) target codes, (B, T, 5) contexts and (B, T) voice ids:
    the voice partition for a merged DB, the quinphone penalties of
    ``ling_weights`` in halfphone mode; empty for neither."""
    if not (halfphone or multivoice):
        return {}
    n = tgt_codes.numel()
    return dict(tgt_meta=pack_meta(tgt_codes.reshape(n), tgt_ctx.reshape(n, 5),
                                   tgt_vids.reshape(n)),
                db_meta=db.meta, partition=multivoice,
                ling_weights=ling_weights if halfphone else None,
                voice_spans=db.spans if multivoice else None)


@contextlib.contextmanager
def _synced_stage(timer: utils.StageTimer, name: str, device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    with timer.stage(name):
        yield
        if device.type == "cuda":
            torch.cuda.synchronize(device)


def exact_scores(db: DeviceDB, tw, idx, scores, ling=None):
    """Exact f32 rescoring of preselected candidates from ``db``'s own rows
    (``idx`` (B*T, k) row ids of ``db``; rows at or past ``db.n_real`` are
    padding and cost the 1e6 sentinel): returns (their raw rows (B*T, k, W),
    target costs, ranking keys, identity mismatch flags or None).  A dead
    kernel slot (+inf score) costs +inf.  ``ling`` = (target codes, target
    contexts, weights) in halfphone mode ranks by
    :func:`halfphone_exact_rank`; otherwise the key is the cost."""
    kd = tw.shape[1]
    rows_c = db.raw[idx]                                         # (BT, k, W)
    cand = affine_rows(rows_c[..., :kd], db.mean_t, db.std_t, db.sqrt_wt,
                       idx < db.n_real, 1e6)
    diff = cand - tw[:, None, :]
    sq = torch.clamp(torch.sum(diff * diff, dim=-1), min=0.0)
    ac = torch.where(torch.isinf(scores), float("inf"), torch.sqrt(sq))
    if ling is None:
        return rows_c, ac, ac, None
    codes, ctx, weights = ling
    mism = db.codes[idx] != codes[:, None]
    return rows_c, ac, halfphone_exact_rank(sq, scores, mism, db.ctx[idx], ctx,
                                            weights), mism


def _rescore(db: DeviceDB, tw, idx, scores, live, n_cand, ling=None):
    """Exact f32 rescoring of the preselected candidates
    (:func:`exact_scores`), then the canonical (score, unit id) order the
    float64 oracle uses; keeps ``n_cand``.  In halfphone mode (``ling``) the
    kept lattice costs go through :func:`halfphone_lattice_mask` (the JAX
    batched step's form).  Returns (candidate ids, target costs, join-left,
    join-right contexts)."""
    zero = torch.zeros((), dtype=torch.float32, device=tw.device)
    rows_c, ac, rank, mism = exact_scores(db, tw, idx, scores, ling)
    order = order_topk_positions(rank, idx, n_cand)
    cand_idx = torch.gather(idx, 1, order)
    target_costs = torch.gather(ac, 1, order)
    if ling is not None:
        target_costs = halfphone_lattice_mask(target_costs, torch.gather(mism, 1, order))
    target_costs = torch.where(live.reshape(-1, 1), target_costs, zero)
    rows_sel = torch.gather(rows_c, 1, order[:, :, None].expand(-1, -1, rows_c.shape[2]))
    jl, jr = gather_join_contexts(rows_sel, db.raw, cand_idx, db.sqrt_wj.shape[0],
                                  db.mean_j, db.std_j, db.sqrt_wj,
                                  cand_idx < db.n_real)
    return cand_idx, target_costs, jl, jr


class Synthesiser:
    """Loads a VoiceDB onto one device and synthesises from it: epoch-unit
    and halfphone voices, and DBs merged from several voices of either kind,
    in batches or (epoch units) as a stream.

    ``device`` is explicit: "cuda" (the default) raises where CUDA is absent;
    "cpu" runs the kernels' plain twins (tests).  With config ``mesh_data``
    / ``mesh_db`` above 1, ``synth_batch`` runs over a mesh of
    ``mesh_data * mesh_db`` members (:meth:`ensure_sharded`): cards 0..n-1
    for "cuda" (it raises where there are fewer), the CPU repeated for
    "cpu", or the devices of a list given as ``device`` (repeats allowed:
    ``["cuda:0"] * 4`` runs a 2 x 2 mesh on one card); the single-device
    paths run on its first."""

    def __init__(self, cfg: SnickeryConfig, db: VoiceDB | None = None,
                 device="cuda"):
        self._mesh_devices = None
        if not isinstance(device, (str, torch.device)):
            self._mesh_devices = [torch.device(d) for d in device]
            if not self._mesh_devices:
                raise ValueError("an empty device list")
            device = self._mesh_devices[0]
        self.device = torch.device(device)
        for dev in self._mesh_devices or [self.device]:
            if dev.type == "cuda":
                if not torch.cuda.is_available():
                    raise RuntimeError("Synthesiser(device='cuda'): CUDA is not "
                                       "available; pass device='cpu' explicitly "
                                       "for the plain PyTorch path")
                # full f32 products everywhere: the preselect and the
                # lattice costs are exact f32 by contract (no TF32)
                torch.backends.cuda.matmul.allow_tf32 = False
                torch.backends.cudnn.allow_tf32 = False
            elif dev.type != "cpu":
                raise ValueError(f"unsupported device {dev}")
        self.cfg = cfg
        self._mesh = self._sharded_voice = None
        self.timer = utils.StageTimer()
        with self.timer.stage("load_db"):
            self.db = db if db is not None else VoiceDB.load(cfg.db_path)
        self.halfphone = self.db.target_representation == "halfphone"
        self.is_multivoice = self.db.is_multivoice
        self._check_supported()
        self.frames_per_unit = 3 if self.halfphone else self.db.multiepoch
        with self.timer.stage("prepare_db"):
            self._prepare_device_db()

    def _check_supported(self) -> None:
        """Refuse an unknown precision, and a device list that is not the
        config's mesh."""
        cfg = self.cfg
        if self._mesh_devices is not None and len(self._mesh_devices) != self.mesh_size:
            raise ValueError(
                f"{len(self._mesh_devices)} devices given for a mesh of "
                f"mesh_data x mesh_db = {self.mesh_size}")
        if cfg.preselect_precision not in PRECISIONS:
            raise ValueError(f"preselect_precision={cfg.preselect_precision!r}; "
                             f"have {PRECISIONS}")

    # ------------------------------------------------------------------ setup
    def _prepare_device_db(self) -> None:
        cfg, db = self.cfg, self.db
        d = cfg.target_dim
        k = self.frames_per_unit
        w_t = np.tile(_stream_weight_vector(cfg, cfg.target_stream_weights), k)
        if db.join_dim % d != 0:
            raise ValueError(
                f"DB join dim {db.join_dim} is not a multiple of stream dim {d}")
        w_j = np.tile(_stream_weight_vector(cfg, cfg.join_stream_weights),
                      db.join_dim // d)
        if db.target_dim != k * d:
            raise ValueError(
                f"DB target dim {db.target_dim} != frames_per_unit {k} * stream dim {d}")
        self._sqrt_wt = np.sqrt(w_t).astype(np.float32)
        self._sqrt_wj = np.sqrt(w_j).astype(np.float32)

        m = db.n_units
        chunk = 8192 if m >= 8192 else utils.next_multiple(m, cfg.db_pad_multiple)
        pad_unit = (math.lcm(chunk, JAX_PALLAS_CHUNK * max(1, cfg.mesh_db))
                    if cfg.use_pallas else chunk)
        mp = utils.next_multiple(m, pad_unit)
        self.n_units = m
        self.n_units_padded = mp

        # the join contexts are derived from the raw rows on the device
        if not np.array_equal(db.join_left, db.unit_features[:, :db.join_dim]):
            raise ValueError(
                "VoiceDB violates join_left == unit_features[:, :d_join]; "
                "the device layout derives join contexts from the raw rows")
        raw_block, _, _ = build_raw_blocks(
            db.unit_features, db.join_right, mp, ndb=1,
            affine=(db.mean_target, db.std_target, self._sqrt_wt))
        cuts = np.pad(db.cutpoints.astype(np.int32), ((0, mp - m), (0, 0)))
        # fail fast on a linguistic method for a voice that has no labels
        self._preselect_method()
        if self.is_multivoice:
            # a voice with fewer live units than n_candidates would leave
            # (inf, unit 0) slots in the lattice: reject such DBs up front
            counts = np.bincount(db.voice_ids, minlength=len(db.voice_names))
            short = [db.voice_names[v] for v in np.nonzero(counts < cfg.n_candidates)[0]]
            if short:
                raise ValueError(
                    f"multi-voice DB: voices {short} have fewer than "
                    f"n_candidates={cfg.n_candidates} units; selection for "
                    "them would be degenerate")
        if self.halfphone:
            codes = np.pad(db.unit_code.astype(np.int32), (0, mp - m), constant_values=-1)
            ctx = np.pad(db.context_codes.astype(np.int32), ((0, mp - m), (0, 0)),
                         constant_values=-1)
        else:
            codes, ctx = np.zeros(mp, np.int32), np.zeros((mp, 5), np.int32)
        # preload_all_waves=False keeps the corpus audio on the host and the
        # OLA runs in numpy after the step (_host_ola); the device holds a
        # placeholder
        wave_scale = np.float32(1.0)
        if not cfg.preload_all_waves:
            waves = np.zeros(128, np.float32)
        elif cfg.waves_dtype == "int16":
            w32 = np.asarray(db.waves, np.float32)
            peak = float(np.abs(w32).max()) if len(w32) else 1.0
            wave_scale = np.float32(max(peak, 1e-9) / 32767.0)
            waves = np.clip(np.round(w32 / wave_scale), -32768, 32767).astype(np.int16)
        else:
            waves = np.asarray(db.waves, np.float32)
        self.device_db = device_db_from_numpy(dict(
            raw=raw_block,
            n_real=np.int32(m),
            cut1=np.ascontiguousarray(cuts[:, 1]),
            cut2=np.ascontiguousarray(cuts[:, 2]),
            waves=waves,
            wave_scale=wave_scale,
            mean_t=db.mean_target.astype(np.float32),
            std_t=db.std_target.astype(np.float32),
            sqrt_wt=self._sqrt_wt,
            mean_j=db.mean_join.astype(np.float32),
            std_j=db.std_join.astype(np.float32),
            sqrt_wj=self._sqrt_wj,
            codes=codes,
            ctx=ctx,
            vids=np.pad(db.voice_ids.astype(np.int32), (0, mp - m),
                        constant_values=-1),
        ), self.device)
        spans = (db.cutpoints[:, 2] - db.cutpoints[:, 1]).astype(np.int64)
        self.max_span = int(spans.max()) if len(spans) else 1
        self.max_frag = utils.next_multiple(self.max_span + 2 * cfg.taper_length, 128)
        self._unit_vocab = {n: i for i, n in enumerate(db.unit_names)}
        self._phone_vocab = {n: i for i, n in enumerate(db.phone_names)}
        self._voice_vocab = {n: i for i, n in enumerate(db.voice_names)}

    @property
    def mesh_size(self) -> int:
        return max(1, self.cfg.mesh_data) * max(1, self.cfg.mesh_db)

    def ensure_sharded(self) -> None:
        """Create the (data x db) mesh and the sharded voice if needed
        (counterpart of ``snickery_tpu.synth.Synthesiser.ensure_sharded``).

        Called lazily by ``synth_batch`` on a mesh; callers driving
        :func:`~snickery_tpu_torch.parallel.batched_synth_step` directly
        call it first and then use ``self._mesh`` / ``self._sharded_voice``.
        At one DB shard the members alias the resident raw block (on its
        device, without a copy); with ``mesh_db`` above 1 the shard-local
        blocks (local jr-exception pointers and halo rows) are rebuilt on
        the host for this mesh."""
        if self._mesh is not None:
            return
        from snickery_tpu_torch.parallel import make_mesh, shard_voice
        cfg = self.cfg
        ndb = max(1, cfg.mesh_db)
        devices = self._mesh_devices
        if devices is None and self.device.type == "cpu":
            devices = [self.device] * self.mesh_size
        self._mesh = make_mesh(max(1, cfg.mesh_data), ndb, devices=devices)
        ddb = self.device_db
        if ndb == 1:
            raw_block = ddb.raw
        else:
            raw_block, _, _ = build_raw_blocks(
                self.db.unit_features, self.db.join_right, self.n_units_padded,
                ndb=ndb, affine=(self.db.mean_target, self.db.std_target,
                                 self._sqrt_wt))
        self._sharded_voice = shard_voice(
            self._mesh, raw_block, ddb.cut1, ddb.cut2, ddb.waves, ddb.mean_t,
            ddb.std_t, ddb.sqrt_wt, ddb.mean_j, ddb.std_j, ddb.sqrt_wj,
            n_real=int(ddb.n_real), part=ddb.vids, codes=ddb.codes, ctx=ddb.ctx,
            wave_scale=ddb.wave_scale)

    def _preselect_method(self) -> str:
        """Resolve config preselection_method ("" = auto by voice type)."""
        m = self.cfg.preselection_method
        if not m:
            return "quinphone" if self.halfphone else "acoustic"
        if m != "acoustic" and not self.halfphone:
            raise ValueError(
                f"preselection_method={m!r} needs a halfphone voice "
                f"(this DB has target_representation="
                f"{self.db.target_representation!r})")
        return m

    def _use_ling(self) -> bool:
        """Whether linguistic (quinphone) penalties enter the preselect."""
        return self._preselect_method() in ("quinphone", "quinphone_backoff")

    def _ling_weights(self) -> tuple:
        cfg = self.cfg
        if self._preselect_method() == "quinphone_backoff":
            return BACKOFF_LING_WEIGHTS
        return tuple(float(w) for w in cfg.quinphone_context_weights) + (
            float(cfg.quinphone_penalty_scale),)

    def _voice_code(self, voice) -> int:
        if isinstance(voice, str):
            if voice not in self._voice_vocab:
                raise KeyError(f"unknown voice {voice!r}; have {self.db.voice_names}")
            return self._voice_vocab[voice]
        return int(voice)

    # ------------------------------------------------------- target assembly
    def targets_from_features(self, features: np.ndarray) -> tuple[np.ndarray, int]:
        """Group an epoch-rate trajectory (E, d) into unit-rate targets
        (T_units, k*d) on the DB's unit grid (centre epochs 1 .. E-2)."""
        k = self.frames_per_unit
        d = self.cfg.target_dim
        if features.shape[1] != d:
            raise ValueError(f"feature dim {features.shape[1]} != {d}")
        usable = features[1: len(features) - 1]
        t_units = len(usable) // k
        if t_units == 0:
            raise ValueError("utterance shorter than one unit")
        return usable[: t_units * k].reshape(t_units, k * d).astype(np.float32), t_units

    def halfphone_targets_from_features(
            self, features: np.ndarray, epochs: np.ndarray, segments: list
    ) -> tuple[np.ndarray, list]:
        """Unit-rate halfphone targets ([first, mid, last] frames) from an
        epoch-rate trajectory and the target's halfphone segmentation, with
        the DB builder's frame-picking rule; returns (targets, kept
        segments)."""
        from snickery_tpu_torch.io.labels import segments_to_sample_bounds
        from snickery_tpu_torch.voicedb.build import halfphone_frame_indices

        bounds = segments_to_sample_bounds(segments, self.cfg.sample_rate)
        rows, kept = [], []
        for seg, e0, mid, e1 in halfphone_frame_indices(
                segments, bounds, epochs, len(features)):
            rows.append(np.concatenate([features[e0], features[mid], features[e1]]))
            kept.append(seg)
        return np.asarray(rows, np.float32), kept

    def _prepare(self, feature_list, segments_list, voices):
        """Unit-rate targets and per-utterance voice ids, with the JAX
        package's checks of the halfphone and multi-voice arguments."""
        if self.is_multivoice and voices is None:
            raise ValueError(
                "this is a multi-voice DB: pass a voice name or id per "
                f"utterance (available: {self.db.voice_names})")
        if self.halfphone:
            if segments_list is None:
                raise ValueError("halfphone mode needs target segments")
            prepped = [(np.asarray(f, np.float32), len(f)) for f in feature_list]
        else:
            prepped = [self.targets_from_features(f) for f in feature_list]
        vids = ([self._voice_code(v) for v in voices] if self.is_multivoice
                else [0] * len(prepped))
        return prepped, vids

    # ----------------------------------------------------------------- public
    def batch_inputs(self, prepped: list[tuple[np.ndarray, int]],
                     segments_list: list | None = None,
                     voice_ids: list[int] | None = None):
        """(targets (B, T, kd), lengths (B,), step keyword arguments) for
        :func:`synth_pipeline_step` from unit-rate targets and their
        lengths, padded to the shared length bucket.  ``segments_list``
        (halfphone voices): one HalfphoneSegment list per utterance;
        ``voice_ids`` (merged DBs): one voice id per utterance.  Steps past
        an utterance's length get code, contexts and voice id -1."""
        cfg = self.cfg
        B = len(prepped)
        t_bucket = utils.bucket_length(max(n for _, n in prepped),
                                       tuple(cfg.length_buckets))
        tgts = np.zeros((B, t_bucket, self.db.target_dim), np.float32)
        lengths = np.zeros(B, np.int64)
        codes = np.full((B, t_bucket), -1, np.int32)
        ctx = np.full((B, t_bucket, 5), -1, np.int32)
        vids = np.full((B, t_bucket), -1, np.int32)
        for b, (tu, n) in enumerate(prepped):
            tgts[b, :n] = tu
            lengths[b] = n
            if self.halfphone:
                segs = segments_list[b]
                codes[b, :n] = [self._unit_vocab.get(s.name, -1) for s in segs]
                ctx[b, :n] = [[self._phone_vocab.get(p, 0) for p in s.quinphone]
                              for s in segs]
            else:
                codes[b, :n] = 0
                ctx[b, :n] = 0
            vids[b, :n] = 0 if voice_ids is None else voice_ids[b]
        dev = self.device
        kwargs = dict(
            tgt_codes=torch.from_numpy(codes).to(dev),
            tgt_ctx=torch.from_numpy(ctx).to(dev),
            tgt_vids=torch.from_numpy(vids).to(dev),
            n_cand=min(cfg.n_candidates, self.n_units_padded),
            jcw=cfg.join_cost_weight, eps=cfg.search_epsilon,
            max_frag=self.max_frag,
            out_len=utils.next_multiple(
                t_bucket * self.max_span + 2 * cfg.taper_length, 128),
            taper=cfg.taper_length,
            squared_joins=cfg.join_cost_type == "squared",
            margin=cfg.preselect_margin,
            halfphone=self._use_ling(), multivoice=self.is_multivoice,
            ling_weights=self._ling_weights(),
            precision=cfg.preselect_precision, zero_transient=cfg.zero_transient,
            do_ola=cfg.preload_all_waves)
        return (torch.from_numpy(tgts).to(dev), torch.from_numpy(lengths).to(dev),
                kwargs)

    def _run(self, prepped: list[tuple[np.ndarray, int]], greedy: bool,
             segments_list: list | None, voice_ids: list[int]) -> list[dict]:
        tgts, lengths, kwargs = self.batch_inputs(prepped, segments_list, voice_ids)
        with self.timer.stage("synth_step"):
            out = synth_pipeline_step(self.device_db, tgts, lengths, greedy=greedy,
                                      **kwargs)
            unit_ids, costs, audio, totals = (t.cpu().numpy() for t in out)
        return self._results(prepped, unit_ids, costs, audio, totals)

    def _run_sharded(self, prepped: list[tuple[np.ndarray, int]], greedy: bool,
                     segments_list: list | None, voice_ids: list[int]) -> list[dict]:
        """One :func:`batched_synth_step` over the mesh; the batch is padded
        with zero-length dummies (voice id -1) to a multiple of the mesh,
        as the JAX ``synth_batch`` pads it."""
        from snickery_tpu_torch.parallel import batched_synth_step
        self.ensure_sharded()
        pad = (-len(prepped)) % self.mesh_size
        kd = self.db.target_dim
        padded = prepped + [(np.zeros((0, kd), np.float32), 0)] * pad
        segs = None if segments_list is None else list(segments_list) + [[]] * pad
        vids = list(voice_ids) + [-1] * pad
        tgts, lengths, kw = self.batch_inputs(padded, segs, vids)
        step_vids = (torch.tensor(vids, dtype=torch.int32, device=self.device)
                     if kw.pop("multivoice") else None)
        del kw["tgt_vids"]
        with self.timer.stage("synth_batch_step"):
            out = batched_synth_step(
                self._sharded_voice, tgts, lengths, kw.pop("jcw"), kw.pop("eps"),
                step_vids, kw.pop("tgt_codes"), kw.pop("tgt_ctx"), mesh=self._mesh,
                greedy=greedy, **kw)
            unit_ids, costs, audio, totals = (t.cpu().numpy() for t in out)
        return self._results(prepped, unit_ids, costs, audio, totals)

    def _results(self, prepped, unit_ids, costs, audio, totals) -> list[dict]:
        results = []
        for b, (_, n) in enumerate(prepped):
            ids = unit_ids[b, :n].astype(np.int32)
            wave = (audio[b, : int(totals[b])] if self.cfg.preload_all_waves
                    else self._host_ola(ids))
            results.append({"wave": wave, "unit_ids": ids,
                            "total_cost": float(costs[b]), "n_units": int(n)})
        return results

    def _host_ola(self, unit_ids: np.ndarray) -> np.ndarray:
        """Host-side concatenation for preload_all_waves=False."""
        cuts = self.db.cutpoints
        ids = np.asarray(unit_ids)
        return host_overlap_add(np.asarray(self.db.waves), cuts[ids, 1],
                                cuts[ids, 2], self.cfg.taper_length)

    def synth_from_features(self, features: np.ndarray,
                            greedy: bool | None = None,
                            target_segments: list | None = None,
                            voice=None) -> dict:
        """Synthesise one utterance from an epoch-rate target trajectory.

        Halfphone voices: ``features`` are unit-rate already (from
        :meth:`halfphone_targets_from_features`) and ``target_segments``
        their HalfphoneSegment list.  Merged DBs: ``voice`` (name or id)
        selects the voice.  Returns dict(wave, unit_ids, total_cost,
        n_units)."""
        greedy = self.cfg.greedy_search if greedy is None else greedy
        prepped, vids = self._prepare(
            [features], None if target_segments is None else [target_segments],
            None if voice is None else [voice])
        return self._run(prepped, greedy, [target_segments], vids)[0]

    def synth_batch(self, feature_list: list[np.ndarray],
                    greedy: bool = False, voices: list | None = None,
                    segments_list: list | None = None) -> list[dict]:
        """Synthesise several utterances in one step, padded to a shared
        length bucket; one result dict per utterance, as
        :meth:`synth_from_features` returns; on a mesh (config
        ``mesh_data`` / ``mesh_db``) through :meth:`_run_sharded`.
        ``voices``: one voice name or id per utterance (merged DBs);
        ``segments_list``: one HalfphoneSegment list per utterance
        (halfphone voices, whose ``feature_list`` entries are unit-rate)."""
        prepped, vids = self._prepare(feature_list, segments_list, voices)
        run = self._run if self.mesh_size == 1 else self._run_sharded
        return run(prepped, greedy, segments_list, vids)

    def synth_streaming(self, feature_chunks, greedy: bool = True, voice=None,
                        fixed_frameshift: float = 0.0):
        """Streaming synthesis (BASELINE config #4): consume target feature
        chunks, yield audio chunks as soon as their units are decided.

        The semantics of ``snickery_tpu.synth.Synthesiser.synth_streaming``:
        greedy decoding with the join context carried across chunks (the
        decode is greedy whatever ``greedy`` says), epochs left over from a
        chunk carried into the next, the last frame repeated at the end of
        the stream to fill a whole unit, and each yielded chunk complete
        except its trailing ``2 * taper`` samples, which are summed into the
        next chunk's head (the final tail is yielded last).
        ``feature_chunks``: iterable of (n_i, d) epoch-rate arrays, or with
        ``fixed_frameshift > 0`` (seconds) fixed-rate DNN-style frames whose
        lf0 stream is integrated into an epoch grid chunk by chunk
        (:class:`~snickery_tpu_torch.features.world.StreamingEpochResampler`).
        ``voice``: required for merged DBs.  Yields float32 audio arrays.

        Chunk i + 1 is enqueued on the device before chunk i is waited for:
        chunk i's ids, audio and total are copied into pinned host buffers
        without blocking, and an event recorded after the copies is waited on
        only when chunk i is yielded.  ``last_stream_unit_ids`` keeps the ids
        of each chunk, ``last_stream_stages`` the host times (ms) of each:
        pulling the chunk, preparing it, enqueuing its step, and waiting for
        its results."""
        cfg = self.cfg
        if self.halfphone:
            raise NotImplementedError(
                "streaming synthesis is epoch-mode only, as in the JAX package "
                "(see ROADMAP.md queue 3)")
        if fixed_frameshift and fixed_frameshift > 0:
            from snickery_tpu_torch.features.world import StreamingEpochResampler
            lf0_col = None
            for name, a, _ in cfg.stream_slices:
                if name == "lf0":
                    lf0_col = a
            if lf0_col is None:
                raise ValueError("fixed_frameshift streaming needs an lf0 stream "
                                 "to integrate the epoch grid from")
            resampler = StreamingEpochResampler(lf0_col, cfg.sample_rate,
                                                fixed_frameshift)

            def epoch_chunks():
                for chunk in feature_chunks:
                    rows = resampler.push(np.asarray(chunk, np.float32))
                    if len(rows):
                        yield rows
                rows = resampler.flush()
                if len(rows):
                    yield rows

            yield from self.synth_streaming(epoch_chunks(), voice=voice)
            return
        if self.is_multivoice and voice is None:
            raise ValueError(
                "this is a multi-voice DB: pass voice=<name or id> "
                f"(available: {self.db.voice_names})")
        vid = self._voice_code(voice) if self.is_multivoice else 0
        k, d = self.frames_per_unit, cfg.target_dim
        dev, ddb = self.device, self.device_db
        t2 = 2 * cfg.taper_length
        ctx = torch.zeros(ddb.sqrt_wj.shape[0], dtype=torch.float32, device=dev)
        started = False                 # a join context exists
        tail = np.zeros(t2, np.float32)
        leftover = np.zeros((0, d), np.float32)
        self.last_stream_unit_ids: list[np.ndarray] = []
        stages: dict[str, list] = {"pull_ms": [], "prep_ms": [],
                                   "dispatch_ms": [], "fetch_ms": []}
        self.last_stream_stages = stages
        self._last_stream_step = None   # (args, kwargs) of the last step

        def chunks_then_flush():
            yield from feature_chunks
            yield None                   # end of stream: flush the leftover

        def finish(pending):
            nonlocal tail
            (ids, audio, total), event, t_units = pending
            t0 = time.perf_counter()
            if event is not None:
                event.synchronize()
            stages["fetch_ms"].append((time.perf_counter() - t0) * 1e3)
            ids = ids.numpy()[:t_units].astype(np.int32)
            self.last_stream_unit_ids.append(ids)
            audio = (audio.numpy()[: int(total)].copy() if cfg.preload_all_waves
                     else self._host_ola(ids))
            audio[:t2] += tail
            tail = audio[-t2:].copy()
            return audio[:-t2]

        pending = None
        src = chunks_then_flush()
        while True:
            t_pull = time.perf_counter()
            try:
                chunk_feats = next(src)
            except StopIteration:
                break
            stages["pull_ms"].append((time.perf_counter() - t_pull) * 1e3)
            t_prep = time.perf_counter()
            if chunk_feats is None:
                if len(leftover) == 0:
                    break
                reps = k - len(leftover) % k if len(leftover) % k else 0
                feats = np.concatenate([leftover, np.repeat(leftover[-1:], reps, axis=0)])
            else:
                feats = np.concatenate([leftover, np.asarray(chunk_feats, np.float32)])
            t_units = len(feats) // k
            if t_units == 0:
                leftover = feats
                continue
            leftover = (np.zeros((0, d), np.float32) if chunk_feats is None
                        else feats[t_units * k:])
            t_bucket = utils.bucket_length(t_units, tuple(cfg.length_buckets))
            tgt = np.zeros((t_bucket, k * d), np.float32)
            tgt[:t_units] = feats[: t_units * k].reshape(t_units, k * d)
            args = (ddb, self._to_device(tgt), t_units, vid, ctx,
                    cfg.join_cost_weight if started else 0.0, cfg.join_cost_weight)
            kwargs = dict(n_cand=min(cfg.n_candidates, self.n_units_padded),
                          max_frag=self.max_frag,
                          out_len=utils.next_multiple(t_bucket * self.max_span + t2, 128),
                          taper=cfg.taper_length,
                          squared_joins=cfg.join_cost_type == "squared",
                          margin=cfg.preselect_margin, multivoice=self.is_multivoice,
                          precision=cfg.preselect_precision,
                          zero_transient=cfg.zero_transient,
                          do_ola=cfg.preload_all_waves)
            stages["prep_ms"].append((time.perf_counter() - t_prep) * 1e3)
            t_disp = time.perf_counter()
            unit_ids, ctx, audio, total = streaming_step(*args, **kwargs)
            started = True
            fetched = self._to_host((unit_ids, audio, total))
            stages["dispatch_ms"].append((time.perf_counter() - t_disp) * 1e3)
            self._last_stream_step = (args, kwargs)
            if pending is not None:
                yield finish(pending)
            pending = (*fetched, t_units)
        if pending is not None:
            yield finish(pending)
        yield tail

    def _to_device(self, array: np.ndarray) -> torch.Tensor:
        """A host array on the device without waiting for queued work: on a
        card through pinned memory and an asynchronous copy."""
        t = torch.from_numpy(array)
        if self.device.type != "cuda":
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    def _to_host(self, tensors):
        """(host tensors, event): on a card, pinned buffers filled without
        blocking and the event recorded after the copies (wait on it before
        reading them); on the CPU, the tensors themselves and no event."""
        if self.device.type != "cuda":
            return tuple(tensors), None
        out = []
        for t in tensors:
            buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            buf.copy_(t, non_blocking=True)
            out.append(buf)
        event = torch.cuda.Event()
        event.record()
        return tuple(out), event

    def selected_features(self, unit_ids: np.ndarray) -> np.ndarray:
        """Epoch-rate feature trajectory of the selected units (for magphase
        resynthesis or inspection): (n_units * k, d)."""
        k, d = self.frames_per_unit, self.cfg.target_dim
        return np.asarray(self.db.unit_features[np.asarray(unit_ids)]).reshape(
            len(unit_ids) * k, d)

    def resynth_magphase(self, unit_ids: np.ndarray,
                         target_lf0: np.ndarray | None = None) -> np.ndarray:
        """Magphase resynthesis of the selected units on this Synthesiser's
        device: their mag / real / imag / lf0 frames, join-smoothed with
        config ``magphase_smooth_joins`` > 0, on an epoch grid integrated
        from their lf0 or, with ``magphase_use_target_f0`` and
        ``target_lf0``, from the target's (``magphase_overlap`` widens the
        windows).  Returns float32 audio."""
        from snickery_tpu_torch.features.magphase import magphase_synthesis

        cfg = self.cfg
        traj = self.selected_features(unit_ids)
        if cfg.magphase_smooth_joins > 0:
            from snickery_tpu_torch.features.smoothing import smooth_joins
            traj = smooth_joins(traj, self.frames_per_unit, width=cfg.magphase_smooth_joins,
                                device=self.device).cpu().numpy()
        streams = {name: traj[:, a:b] for name, a, b in cfg.stream_slices}
        for required in ("mag", "real", "imag"):
            if required not in streams:
                raise ValueError("magphase resynthesis needs mag/real/imag streams")
        if "lf0" not in streams:
            streams["lf0"] = np.asarray(self.db.unit_lf0[np.asarray(unit_ids)]).reshape(-1, 1)
        use_tgt = cfg.magphase_use_target_f0 and target_lf0 is not None
        return magphase_synthesis(
            streams, cfg.sample_rate,
            target_lf0=np.asarray(target_lf0).reshape(-1) if use_tgt else None,
            overlap=cfg.magphase_overlap, device=self.device)

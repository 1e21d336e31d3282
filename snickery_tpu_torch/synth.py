"""Synthesiser in PyTorch: epoch-unit synthesis from a resident unit DB.

Counterpart of ``snickery_tpu.synth`` for the main path (BASELINE config
#3): normalise and weight the targets, preselect the top k + margin over
the whole DB with the hand-written kernel (zero-transient form), rescore the
candidates in exact f32 and keep the top k in canonical (score, unit id)
order, gather join contexts, Viterbi, and crossfade overlap-add.  One
batched step (:func:`synth_pipeline_step`) serves ``synth_from_features``
(B = 1) and ``synth_batch``.

The device is an explicit argument.  ``device="cuda"`` runs the CUDA kernel
and raises where CUDA is absent; ``device="cpu"`` runs the kernel's plain
PyTorch twin.  Nothing falls back from one to the other.

Not ported yet (each raises NotImplementedError; see ROADMAP.md): halfphone
and linguistic preselect, multi-voice partitions, preselect precisions other
than "highest", ``preload_all_waves=False``, multi-device meshes, streaming
and magphase resynthesis.
"""

from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass, fields

import numpy as np
import torch

from snickery_tpu import utils
from snickery_tpu.config import SnickeryConfig
from snickery_tpu.voicedb.db import VoiceDB
from snickery_tpu_torch.ops.cuda_topk import cuda_topk_preselect
from snickery_tpu_torch.ops.ola import overlap_add_units
from snickery_tpu_torch.ops.topk import order_topk_positions, preselect_margin
from snickery_tpu_torch.ops.viterbi import greedy_decode, viterbi_decode
from snickery_tpu_torch.voicedb.device_layout import (affine_rows,
                                                      build_raw_blocks,
                                                      gather_join_contexts)

# DB rows are padded as the JAX package pads them (its Pallas CHUNK), so the
# padded unit count and the raw block are the same on both sides.
JAX_PALLAS_CHUNK = 4096
_TODO = "not ported to snickery_tpu_torch yet (see ROADMAP.md)"


def _stream_weight_vector(cfg: SnickeryConfig, weights: list[float]) -> np.ndarray:
    out = np.zeros(cfg.target_dim, np.float32)
    for (name, a, b), w in zip(cfg.stream_slices, weights):
        out[a:b] = w
    return out


@dataclass
class DeviceDB:
    """The resident voice: tensors on one device, fields as in the JAX
    ``DeviceDB`` (see ``snickery_tpu.synth.DeviceDB``)."""
    raw: torch.Tensor         # (q, kd + 2) [data | sqn | ptr] raw block
    n_real: torch.Tensor      # () int32: rows >= n_real are padding
    cut1: torch.Tensor        # (Mp,) int32
    cut2: torch.Tensor        # (Mp,) int32
    waves: torch.Tensor       # (S,) f32, or int16
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

    @property
    def nbytes(self) -> int:
        return sum(getattr(self, f.name).nbytes for f in fields(self))


def device_db_from_numpy(arrays: dict[str, np.ndarray], device) -> DeviceDB:
    """Build a :class:`DeviceDB` on ``device`` from numpy arrays keyed by
    field name (for example the JAX ``DeviceDB``'s fields, fetched to the
    host).  Dtypes and values are kept bit for bit."""
    names = [f.name for f in fields(DeviceDB)]
    missing = set(names) - set(arrays)
    if missing:
        raise KeyError(f"missing DeviceDB fields: {sorted(missing)}")
    return DeviceDB(**{n: torch.from_numpy(np.array(arrays[n], copy=True)).to(device)
                       for n in names})


def synth_pipeline_step(db: DeviceDB, targets: torch.Tensor,
                        lengths: torch.Tensor, *, n_cand: int, jcw: float,
                        eps: float, max_frag: int, out_len: int, taper: int,
                        greedy: bool = False, squared_joins: bool = False,
                        margin: int = -1,
                        stage_timer: utils.StageTimer | None = None):
    """Select, decode and concatenate B utterances in one step.

    ``targets`` (B, T, kd) raw unit-rate target features, ``lengths`` (B,)
    live steps.  The single-device body of the JAX batched step
    (``parallel/sharded.py::_select_decode_batch`` at one DB shard plus its
    OLA).  Returns (unit_ids (B, T), total costs (B,), audio (B, out_len),
    total samples (B,)).

    ``stage_timer``: when given, each stage (preselect, rescore, decode,
    ola) is timed into it, the device synchronised at every stage edge; for
    measurement runs only, since the synchronisations serialise the step.
    """
    def stage(name):
        if stage_timer is None:
            return contextlib.nullcontext()
        return _synced_stage(stage_timer, name, targets.device)

    B, T, kd = targets.shape
    dev = targets.device
    m_pad = db.cut1.shape[0]
    dj = db.sqrt_wj.shape[0]
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    tw = (targets - db.mean_t) / db.std_t
    tw = tw * db.sqrt_wt
    live = torch.arange(T, device=dev)[None, :] < lengths.reshape(B, 1)
    tw = torch.where(live[:, :, None], tw, zero).reshape(B * T, kd)

    k_sel = min(n_cand + preselect_margin(True, "highest", zero_transient=True,
                                          override=margin), m_pad)
    with stage("preselect"):
        idx, scores = cuda_topk_preselect(tw, db.raw, k_sel,
                                          (db.mean_t, db.std_t, db.sqrt_wt), m_pad)
    with stage("rescore"):
        cand_idx, target_costs, jl, jr = _rescore(db, tw, idx.long(), scores,
                                                  live, n_cand)
    n = cand_idx.shape[1]
    decode = greedy_decode if greedy else viterbi_decode
    kw = {} if greedy else {"search_epsilon": eps}
    with stage("decode"):
        paths, costs = decode(target_costs.reshape(B, T, n),
                              jl.reshape(B, T, n, dj), jr.reshape(B, T, n, dj),
                              join_cost_weight=jcw, length=lengths,
                              squared_joins=squared_joins, **kw)
    with stage("ola"):
        sel = torch.gather(cand_idx, 1, paths.reshape(B * T, 1)).reshape(B, T)
        unit_ids = torch.where(live, sel, 0)
        cut1 = torch.where(live, db.cut1[sel], 0)
        cut2 = torch.where(live, db.cut2[sel], 0)
        audio, totals = overlap_add_units(db.waves, cut1, cut2, lengths,
                                          max_frag=max_frag, out_len=out_len,
                                          taper=taper, wave_scale=db.wave_scale)
    return unit_ids, costs, audio, totals


@contextlib.contextmanager
def _synced_stage(timer: utils.StageTimer, name: str, device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    with timer.stage(name):
        yield
        if device.type == "cuda":
            torch.cuda.synchronize(device)


def _rescore(db: DeviceDB, tw, idx, scores, live, n_cand):
    """Exact f32 rescoring of the preselected candidates, then the canonical
    (score, unit id) order the float64 oracle uses; keeps ``n_cand``.
    Returns (candidate ids, target costs, join-left, join-right contexts)."""
    kd = tw.shape[1]
    zero = torch.zeros((), dtype=torch.float32, device=tw.device)
    rows_c = db.raw[idx]                                         # (BT, k, W)
    cand = affine_rows(rows_c[..., :kd], db.mean_t, db.std_t, db.sqrt_wt,
                       idx < db.n_real, 1e6)
    diff = cand - tw[:, None, :]
    ac = torch.sqrt(torch.clamp(torch.sum(diff * diff, dim=-1), min=0.0))
    ac = torch.where(torch.isinf(scores), float("inf"), ac)
    order = order_topk_positions(ac, idx, n_cand)
    cand_idx = torch.gather(idx, 1, order)
    target_costs = torch.where(live.reshape(-1, 1), torch.gather(ac, 1, order), zero)
    rows_sel = torch.gather(rows_c, 1, order[:, :, None].expand(-1, -1, rows_c.shape[2]))
    jl, jr = gather_join_contexts(rows_sel, db.raw, cand_idx, db.sqrt_wj.shape[0],
                                  db.mean_j, db.std_j, db.sqrt_wj,
                                  cand_idx < db.n_real)
    return cand_idx, target_costs, jl, jr


class Synthesiser:
    """Loads a VoiceDB onto one device and synthesises epoch-unit voices.

    ``device`` is explicit: "cuda" (the default) raises where CUDA is absent;
    "cpu" runs the kernels' plain twins (tests)."""

    def __init__(self, cfg: SnickeryConfig, db: VoiceDB | None = None,
                 device="cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError("Synthesiser(device='cuda'): CUDA is not "
                                   "available; pass device='cpu' explicitly "
                                   "for the plain PyTorch path")
            # full f32 products everywhere: the preselect and the lattice
            # costs are exact f32 by contract (no TF32)
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        elif self.device.type != "cpu":
            raise ValueError(f"unsupported device {self.device}")
        self.cfg = cfg
        self.timer = utils.StageTimer()
        with self.timer.stage("load_db"):
            self.db = db if db is not None else VoiceDB.load(cfg.db_path)
        self._check_supported()
        self.frames_per_unit = self.db.multiepoch
        with self.timer.stage("prepare_db"):
            self._prepare_device_db()

    def _check_supported(self) -> None:
        cfg, db = self.cfg, self.db
        if db.target_representation == "halfphone" or cfg.preselection_method not in ("", "acoustic"):
            raise NotImplementedError(f"halfphone / linguistic preselect: {_TODO}")
        if db.is_multivoice:
            raise NotImplementedError(f"multi-voice partitions: {_TODO}")
        if cfg.preselect_precision != "highest":
            raise NotImplementedError(
                f"preselect_precision={cfg.preselect_precision!r}: {_TODO}")
        if not cfg.preload_all_waves:
            raise NotImplementedError(f"preload_all_waves=False: {_TODO}")
        if max(1, cfg.mesh_data) * max(1, cfg.mesh_db) > 1:
            raise NotImplementedError(f"multi-device meshes: {_TODO}")

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
        wave_scale = np.float32(1.0)
        if cfg.waves_dtype == "int16":
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
            codes=np.zeros(mp, np.int32),
            ctx=np.zeros((mp, 5), np.int32),
            vids=np.pad(db.voice_ids.astype(np.int32), (0, mp - m),
                        constant_values=-1),
        ), self.device)
        spans = (db.cutpoints[:, 2] - db.cutpoints[:, 1]).astype(np.int64)
        self.max_span = int(spans.max()) if len(spans) else 1
        self.max_frag = utils.next_multiple(self.max_span + 2 * cfg.taper_length, 128)

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

    # ----------------------------------------------------------------- public
    def batch_inputs(self, prepped: list[tuple[np.ndarray, int]]):
        """(targets (B, T, kd), lengths (B,), step keyword arguments) for
        :func:`synth_pipeline_step` from unit-rate targets and their
        lengths, padded to the shared length bucket."""
        cfg = self.cfg
        t_bucket = utils.bucket_length(max(n for _, n in prepped),
                                       tuple(cfg.length_buckets))
        tgts = np.zeros((len(prepped), t_bucket, self.db.target_dim), np.float32)
        lengths = np.zeros(len(prepped), np.int64)
        for b, (tu, n) in enumerate(prepped):
            tgts[b, :n] = tu
            lengths[b] = n
        kwargs = dict(
            n_cand=min(cfg.n_candidates, self.n_units_padded),
            jcw=cfg.join_cost_weight, eps=cfg.search_epsilon,
            max_frag=self.max_frag,
            out_len=utils.next_multiple(
                t_bucket * self.max_span + 2 * cfg.taper_length, 128),
            taper=cfg.taper_length,
            squared_joins=cfg.join_cost_type == "squared",
            margin=cfg.preselect_margin)
        return (torch.from_numpy(tgts).to(self.device),
                torch.from_numpy(lengths).to(self.device), kwargs)

    def _run(self, prepped: list[tuple[np.ndarray, int]], greedy: bool) -> list[dict]:
        tgts, lengths, kwargs = self.batch_inputs(prepped)
        with self.timer.stage("synth_step"):
            unit_ids, costs, audio, totals = synth_pipeline_step(
                self.device_db, tgts, lengths, greedy=greedy, **kwargs)
            unit_ids, costs = unit_ids.cpu().numpy(), costs.cpu().numpy()
            audio, totals = audio.cpu().numpy(), totals.cpu().numpy()
        return [{"wave": audio[b, : int(totals[b])],
                 "unit_ids": unit_ids[b, :n].astype(np.int32),
                 "total_cost": float(costs[b]),
                 "n_units": int(n)} for b, (_, n) in enumerate(prepped)]

    def synth_from_features(self, features: np.ndarray,
                            greedy: bool | None = None) -> dict:
        """Synthesise one utterance from an epoch-rate target trajectory.
        Returns dict(wave, unit_ids, total_cost, n_units)."""
        greedy = self.cfg.greedy_search if greedy is None else greedy
        return self._run([self.targets_from_features(features)], greedy)[0]

    def synth_batch(self, feature_list: list[np.ndarray],
                    greedy: bool = False) -> list[dict]:
        """Synthesise several utterances in one step, padded to a shared
        length bucket; one result dict per utterance, as
        :meth:`synth_from_features` returns."""
        return self._run([self.targets_from_features(f) for f in feature_list],
                         greedy)

    def synth_streaming(self, *args, **kwargs):
        raise NotImplementedError(f"streaming synthesis: {_TODO}")

    def resynth_magphase(self, *args, **kwargs):
        raise NotImplementedError(f"magphase resynthesis: {_TODO}")

"""Sharded, batched synthesis over a (data, db) mesh of torch devices.

Counterpart of ``snickery_tpu.parallel.sharded``, driven by one process
(see :mod:`snickery_tpu_torch.parallel.mesh`).  Layout:

- raw unit blocks (ndb * q, kd + 2) from ``build_raw_blocks(..., ndb=)``:
  member (d, j) holds shard j's (q, kd + 2) block with block-local
  jr-exception pointers and halo rows, and shard j's rows of the cut
  points, voice ids, halfphone codes and quinphone contexts;
- waves, the target and join affines, and ``n_real``: replicated;
- the target batch (B, T, kd): split over ``data``.

Members on one device share one tensor of each (``.to`` of a tensor already
there copies nothing): a 2 x 2 mesh on one card holds each shard once.

One step (:func:`batched_synth_step`), with ndb the size of the db axis:

1. every member preselects its data slice's B/n_data utterances against its
   shard with the hand-written kernel (``m_rows`` = the shard's rows; rows
   at or past the global ``n_real`` are padding), rescores the k local
   winners in exact f32 from its own rows and gathers their join contexts
   and cut points;
2. the candidate exchange (:func:`_all_to_all`, the JAX package's tiled
   ``all_to_all`` over ``db``): member (d, j) keeps sub-batch j of the slice
   (B/(n_data * ndb) utterances) and receives those rows' candidates from
   every shard, in shard order; a transpose, so each member receives
   B_local * T * k candidates whatever ndb is;
3. each member re-ranks the merged pool (global ids, canonical (score, id)
   order), keeps n_cand, decodes its sub-batch (Viterbi or greedy) and
   concatenates its audio from the replicated waves.

Nothing between a member's preselect and its decode waits on the host:
the rescore, the exchange (device-to-device copies) and the merge are
device work, and the decode is one kernel launch that reads the lengths on
the device.  The host only issues work until the results are copied back,
so members on separate cards run their preselects and decodes together
(the copy of a member's inputs to its card waits on that card's stream
only).  With ndb = 1 there is no exchange: each member runs the
single-device step on its slice, gathering the join contexts of only the
kept candidates.

:func:`sharded_norm_stats` is the DB-building reduction: mean and std over
row-sharded unit features.
"""

from __future__ import annotations

import collections
import threading
from dataclasses import dataclass

import numpy as np
import torch

from snickery_tpu_torch.ops.topk import halfphone_lattice_mask, order_topk_positions
from snickery_tpu_torch.parallel.mesh import Mesh
from snickery_tpu_torch.synth import (DeviceDB, _candidates, decode_and_concatenate,
                                      exact_scores, preselect)
from snickery_tpu_torch.voicedb.device_layout import gather_join_contexts, identity_affine

# bytes each member (d, j) has received from the candidate exchange, summed
# over steps (its own slice included, as the JAX all_to_all's operand is);
# reset by the caller
EXCHANGE_BYTES: collections.Counter = collections.Counter()
_LOCK = threading.Lock()


@dataclass(frozen=True)
class ShardedVoice:
    """A voice DB placed on a (data, db) mesh: ``members[d][j]`` is the
    :class:`~snickery_tpu_torch.synth.DeviceDB` of shard j on member
    (d, j)'s device, its rows shard-local (ids 0 .. m_shard - 1, its
    ``n_real`` the shard's count of real rows) and its waves and affines the
    replicated ones."""
    mesh: Mesh
    members: tuple[tuple[DeviceDB, ...], ...]
    n_real: int           # global: rows >= n_real are padding
    m_shard: int          # DB rows a shard (the cut points' rows / ndb)

    def nbytes(self, device) -> int:
        """Bytes the voice holds on ``device`` (shared tensors once)."""
        storages = {t.untyped_storage().data_ptr(): t.untyped_storage().nbytes()
                    for row in self.members for db in row
                    for t in [*vars(db).values(), db.spans.table]
                    if isinstance(t, torch.Tensor) and t.device == torch.device(device)}
        return sum(storages.values())


def _tensor(x, dtype=None) -> torch.Tensor:
    """``x`` (a tensor, a numpy array or a scalar) as a tensor of ``dtype``
    (by default its own), where it lies."""
    t = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
    return t if dtype is None else t.to(dtype)


def shard_voice(mesh: Mesh, raw_block, cut1, cut2, waves, mean_t, std_t,
                sqrt_wt, mean_j=None, std_j=None, sqrt_wj=None, n_real=None,
                part=None, codes=None, ctx=None, wave_scale=1.0) -> ShardedVoice:
    """Place a padded DB onto the mesh with the layout of the module
    docstring.

    ``raw_block`` (ndb * q, kd + 2) f32 is the array of
    ``build_raw_blocks(..., ndb=mesh db size, affine=(mean_t, std_t,
    sqrt_wt))``, on the host or on a device (a 1-shard block already on the
    members' device is used as it is).  ``cut1`` / ``cut2`` / ``part`` /
    ``codes`` (Mp,) and ``ctx`` (Mp, 5) cover all padded rows; ``part``,
    ``codes`` and ``ctx`` default to zeros.  ``mean_j`` / ``std_j`` /
    ``sqrt_wj`` default to identity over kd columns; ``n_real`` (an int or a
    0-dim tensor) to Mp.  Arguments may be numpy arrays or tensors."""
    ndb = mesh.shape["db"]
    raw = _tensor(raw_block, torch.float32)
    cut1, cut2 = _tensor(cut1, torch.int32), _tensor(cut2, torch.int32)
    mp = cut1.shape[0]
    kd = _tensor(mean_t).shape[0]
    if mp % ndb or raw.shape[0] % ndb:
        raise ValueError(f"{mp} DB rows and a {raw.shape[0]}-row block must "
                         f"divide into {ndb} shards")
    if raw.ndim != 2 or raw.shape[1] != kd + 2:
        raise ValueError(f"raw_block must be (ndb * q, kd + 2 = {kd + 2}): "
                         "build_raw_blocks(..., ndb=, affine=...)")
    m_shard, q = mp // ndb, raw.shape[0] // ndb
    if mean_j is None:
        mean_j, std_j, sqrt_wj = identity_affine(kd)
    n_real = mp if n_real is None else int(n_real)
    zeros = torch.zeros(mp, dtype=torch.int32)
    part = zeros if part is None else _tensor(part, torch.int32)
    codes = zeros if codes is None else _tensor(codes, torch.int32)
    ctx = torch.zeros((mp, 5), dtype=torch.int32) if ctx is None else _tensor(ctx, torch.int32)
    shared = dict(waves=_tensor(waves),
                  wave_scale=_tensor(wave_scale, torch.float32).reshape(()),
                  mean_t=_tensor(mean_t, torch.float32), std_t=_tensor(std_t, torch.float32),
                  sqrt_wt=_tensor(sqrt_wt, torch.float32), mean_j=_tensor(mean_j, torch.float32),
                  std_j=_tensor(std_j, torch.float32), sqrt_wj=_tensor(sqrt_wj, torch.float32))
    replicas = {dev: {k: v.to(dev) for k, v in shared.items()} for dev in mesh.distinct()}
    placed: dict[tuple, DeviceDB] = {}
    for row in mesh.devices:
        for j, dev in enumerate(row):
            if (dev, j) in placed:
                continue
            rows = slice(j * m_shard, (j + 1) * m_shard)
            nr_local = min(max(n_real - j * m_shard, 0), m_shard)
            placed[dev, j] = DeviceDB(
                raw=raw[j * q:(j + 1) * q].to(dev),
                n_real=torch.tensor(nr_local, dtype=torch.int32, device=dev),
                cut1=cut1[rows].to(dev), cut2=cut2[rows].to(dev),
                codes=codes[rows].to(dev), ctx=ctx[rows].to(dev),
                vids=part[rows].to(dev), **replicas[dev])
    members = tuple(tuple(placed[dev, j] for j, dev in enumerate(row))
                    for row in mesh.devices)
    return ShardedVoice(mesh, members, n_real, m_shard)


def _all_to_all(payloads, mesh: Mesh, rows_sub: int):
    """The candidate exchange: ``payloads[d][i]`` is member (d, i)'s list of
    (B_local * T, k, ...) tensors; member (d, j) receives rows
    ``[j * rows_sub, (j + 1) * rows_sub)`` of each member (d, i), joined
    along the candidate axis in shard order.  On one device a slice and a
    ``cat``; between cards PyTorch's device-to-device copy, ordered after
    both devices' current streams.  Returns ``out[d][j]``, the lists
    received, and adds the bytes to :data:`EXCHANGE_BYTES`."""
    ndb = mesh.shape["db"]
    out = []
    for d, row in enumerate(mesh.devices):
        out.append([])
        for j, dev in enumerate(row):
            got, nbytes = [], 0
            for x in range(len(payloads[d][0])):
                parts = [payloads[d][i][x][j * rows_sub:(j + 1) * rows_sub]
                         for i in range(ndb)]
                nbytes += sum(p.nbytes for p in parts)
                got.append(torch.cat([p.to(dev) for p in parts], dim=1))
            out[d].append(got)
            with _LOCK:
                EXCHANGE_BYTES[d, j] += nbytes
    return out


def _local_payload(db: DeviceDB, j: int, m_shard: int, targets, lengths, codes, ctx,
                   vids, *, n_cand: int, **select):
    """Step 1 on member (d, j) for ndb > 1: preselect ``k_local = min(n_cand
    + margin, m_shard)`` against shard j, rescore from its rows and gather
    the candidates' join contexts and cut points.  A shard whose rows are
    all padding (``n_real`` 0 there) is searched all the same: its rows
    carry the never-wins sentinel, so its candidates rank after every live
    one.  Returns [ranking key, global id (int32), target cost, jl | jr,
    cut1, cut2] (+ identity mismatch flags in halfphone mode), each
    (B_local * T, k_local, ...)."""
    tw, _, idx, scores, ling = preselect(db, targets, lengths, codes, ctx, vids,
                                         n_cand=n_cand, **select)
    rows_c, ac, rank, mism = exact_scores(db, tw, idx, scores, ling)
    jl, jr = gather_join_contexts(rows_c, db.raw, idx, db.sqrt_wj.shape[0], db.mean_j,
                                  db.std_j, db.sqrt_wj, idx < db.n_real)
    payload = [rank, (idx + j * m_shard).to(torch.int32), ac, torch.cat([jl, jr], dim=-1),
               db.cut1[idx], db.cut2[idx]]
    return payload if mism is None else payload + [mism]


def _merge(received, live, n_cand: int, halfphone: bool):
    """Step 3's merge on one member: the n_cand best of the pooled
    candidates of every shard in canonical (key, global id) order.  The
    identity fallback mask is applied here, on the global pool.  Returns
    (ids, target costs, jl | jr, cut1, cut2) of the kept candidates."""
    rank, gid, ac, jlr, c1, c2 = received[:6]
    order = order_topk_positions(rank, gid, n_cand)
    costs = torch.gather(ac, 1, order)
    if halfphone:
        costs = halfphone_lattice_mask(costs, torch.gather(received[6], 1, order))
    costs = torch.where(live.reshape(-1, 1), costs, torch.zeros((), device=costs.device))
    jlr = torch.gather(jlr, 1, order[:, :, None].expand(-1, -1, jlr.shape[2]))
    return (torch.gather(gid, 1, order).long(), costs, jlr,
            torch.gather(c1, 1, order), torch.gather(c2, 1, order))


def batched_synth_step(voice: ShardedVoice, targets, lengths, jcw, eps, voice_ids=None,
                       tgt_codes=None, tgt_ctx=None, *, mesh: Mesh, n_cand: int,
                       max_frag: int, out_len: int, taper: int,
                       precision: str = "highest", halfphone: bool = False,
                       ling_weights: tuple | None = None, greedy: bool = False,
                       squared_joins: bool = False, do_ola: bool = True,
                       margin: int = -1, zero_transient: int = -1):
    """Batched multi-utterance synthesis over the (data x db) mesh.

    ``targets`` (B, T, kd) raw unit-rate targets, ``lengths`` (B,),
    ``jcw`` / ``eps`` floats; ``voice_ids`` (B,) restricts each utterance to
    its voice of a merged DB (the partition mask); ``tgt_codes`` (B, T) and
    ``tgt_ctx`` (B, T, 5) feed the quinphone penalties with ``halfphone``.
    The batch must divide the whole mesh (B % (n_data * ndb) == 0): after
    the exchange member (d, j) decodes utterances ``[(d * ndb + j) * b_sub,
    (d * ndb + j + 1) * b_sub)``, b_sub = B / (n_data * ndb).  ``precision``,
    ``margin`` and ``zero_transient`` are the config keys, as in
    :func:`~snickery_tpu_torch.synth.synth_pipeline_step`.

    Returns (unit_ids (B, T) global ids, total costs (B,), audio (B,
    out_len) or the (B, 8) placeholder with ``do_ola=False``, total samples
    (B,)) on the mesh's first device."""
    n_data, ndb = mesh.shape["data"], mesh.shape["db"]
    if mesh != voice.mesh:
        raise ValueError("the voice was sharded onto another mesh")
    B, T, _ = targets.shape
    if B % (n_data * ndb):
        raise ValueError(f"batch {B} must be a multiple of mesh size {n_data}x{ndb}")
    b_local, b_sub = B // n_data, B // (n_data * ndb)
    multivoice = voice_ids is not None
    if voice_ids is None:
        voice_ids = torch.zeros(B, dtype=torch.int32)
    if tgt_codes is None:
        tgt_codes = torch.zeros((B, T), dtype=torch.int32)
    if tgt_ctx is None:
        tgt_ctx = torch.zeros((B, T, 5), dtype=torch.int32)
    step_vids = voice_ids.to(torch.int32).reshape(B, 1).expand(B, T)
    select = dict(margin=margin, halfphone=halfphone, multivoice=multivoice,
                  ling_weights=ling_weights, precision=precision,
                  zero_transient=zero_transient)
    finish = dict(jcw=float(jcw), eps=float(eps), greedy=greedy, squared_joins=squared_joins,
                  do_ola=do_ola, max_frag=max_frag, out_len=out_len, taper=taper)

    def inputs(dev, lo, hi):
        return [x[lo:hi].to(dev) for x in (targets, lengths, tgt_codes, tgt_ctx, step_vids)]

    outs = []
    if ndb == 1:
        cands = []
        for d, (dev,) in enumerate(mesh.devices):
            db = voice.members[d][0]
            tgt, lens, codes, ctx, vids = inputs(dev, d * b_local, (d + 1) * b_local)
            _, *cand = _candidates(db, tgt, lens, codes, ctx, vids, n_cand=n_cand,
                                   stage=None, **select)
            cands.append((db, *cand, lens))
        for args in cands:
            outs.append(decode_and_concatenate(*args, **finish))
    else:
        payloads = [[_local_payload(voice.members[d][j], j, voice.m_shard,
                                    *inputs(dev, d * b_local, (d + 1) * b_local),
                                    n_cand=n_cand, **select)
                     for j, dev in enumerate(row)] for d, row in enumerate(mesh.devices)]
        received = _all_to_all(payloads, mesh, b_sub * T)
        del payloads
        dj = voice.members[0][0].sqrt_wj.shape[0]
        for d, row in enumerate(mesh.devices):
            for j, dev in enumerate(row):
                lo = (d * ndb + j) * b_sub
                lens = lengths[lo:lo + b_sub].to(dev)
                live = torch.arange(T, device=dev)[None, :] < lens[:, None]
                cand, costs, jlr, c1, c2 = _merge(received[d][j], live, n_cand, halfphone)
                received[d][j] = None
                outs.append(decode_and_concatenate(
                    voice.members[d][j], cand, costs, jlr[..., :dj], jlr[..., dj:], lens,
                    (c1, c2), **finish))
    first = mesh.devices[0][0]
    return tuple(torch.cat([o[i].to(first) for o in outs]) for i in range(4))


def sharded_norm_stats(unit_features, n_units, *, mesh: Mesh):
    """DB-building reduction: per-dim mean and std of row-sharded unit
    features (padded rows zeroed by the caller): the rows split over the
    mesh's members in member order, each member sums its rows and their
    squares on its device, and the sums meet on the mesh's first device
    (the JAX package's psum over both axes).  Returns (mean, std) (D,)."""
    feats = _tensor(unit_features, torch.float32)
    if feats.shape[0] % mesh.size:
        raise ValueError(f"{feats.shape[0]} rows do not divide over {mesh.size} members")
    rows = feats.shape[0] // mesh.size
    first = mesh.devices[0][0]
    s = ss = torch.zeros(feats.shape[1], dtype=torch.float32, device=first)
    for m, dev in enumerate(dev for row in mesh.devices for dev in row):
        shard = feats[m * rows:(m + 1) * rows].to(dev)
        s = s + torch.sum(shard, dim=0).to(first)
        ss = ss + torch.sum(shard * shard, dim=0).to(first)
    mean = s / float(n_units)
    var = torch.clamp(ss / float(n_units) - mean * mean, min=0.0)
    return mean, torch.sqrt(torch.clamp(var, min=1e-16))

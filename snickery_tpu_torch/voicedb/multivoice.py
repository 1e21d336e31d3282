"""Multi-voice unit databases (a copy of ``snickery_tpu.voicedb.multivoice``).

BASELINE.json config #5: "Multi-voice sharded unit DB across v5e-8,
batch-64 concurrent synthesis".  The reference has no multi-voice concept
(one HDF5 DB per voice); this module merges several VoiceDBs into one
row-space so a single sharded device DB serves concurrent requests for
different voices.  Selection is restricted per utterance via the fused
partition mask over ``voice_ids`` in the preselect kernels, so one batched
step can mix voices freely.

Both unit types merge:
- *epoch/sample* DBs: a straight row concatenation.
- *halfphone* DBs: the per-voice halfphone (``unit_names``) and quinphone
  (``phone_names``) vocabularies are unified and every ``unit_code`` /
  ``context_codes`` entry remapped into the shared vocabulary, so the fused
  linguistic penalties stay meaningful across voices while the partition
  mask keeps selection within the requested voice.

Normalisation: the merged DB keeps a single global mean/std (computed over
all voices' units) so distances stay comparable inside one compiled
program.
"""

from __future__ import annotations

import numpy as np

from snickery_tpu_torch.voicedb.db import VoiceDB


def _remap_vocab(local_names: list[str], merged_vocab: dict[str, int]) -> np.ndarray:
    """Mapping array: local code -> merged code (extending merged_vocab)."""
    out = np.zeros(max(len(local_names), 1), np.int32)
    for code, name in enumerate(local_names):
        out[code] = merged_vocab.setdefault(name, len(merged_vocab))
    return out


def merge_voicedbs(dbs: list[VoiceDB], names: list[str] | None = None) -> VoiceDB:
    """Concatenate several compatible VoiceDBs into one multi-voice DB.

    The result carries a per-unit ``voice_ids`` array and the voice-name
    vocabulary in ``voice_names``; halfphone identity codes (if any) are
    remapped into a unified vocabulary.
    """
    if not dbs:
        raise ValueError("no voice DBs to merge")
    base = dbs[0]
    for db in dbs[1:]:
        if db.target_representation != base.target_representation:
            raise ValueError("cannot merge different unit types")
        if db.target_dim != base.target_dim or db.sample_rate != base.sample_rate:
            raise ValueError("cannot merge DBs with different dims/sample rates")
        if db.is_multivoice or base.is_multivoice:
            raise ValueError("cannot merge already-merged multi-voice DBs")
    names = names or [f"voice{i}" for i in range(len(dbs))]
    halfphone = base.target_representation == "halfphone"

    feats = np.concatenate([db.unit_features for db in dbs])
    mean_t = feats.mean(axis=0).astype(np.float32)
    std_t = np.maximum(feats.std(axis=0), 1e-8).astype(np.float32)
    joins = np.concatenate([np.concatenate([db.join_left, db.join_right]) for db in dbs])
    mean_j = joins.mean(axis=0).astype(np.float32)
    std_j = np.maximum(joins.std(axis=0), 1e-8).astype(np.float32)

    unit_vocab: dict[str, int] = {}
    phone_vocab: dict[str, int] = {"xx": 0}
    wave_offset = 0
    utt_offset = 0
    cuts, utts, waves, wave_offsets, filenames = [], [], [], [0], []
    voice_ids, codes, ctxs = [], [], []
    for vi, db in enumerate(dbs):
        cuts.append(db.cutpoints + wave_offset)
        utts.append(db.utt_index + utt_offset)
        waves.append(np.asarray(db.waves, np.float32))
        offs = np.asarray(db.wave_offsets[1:]) + wave_offset
        wave_offsets.extend(offs.tolist())
        filenames.extend(f"{names[vi]}/{fn}" for fn in db.filenames)
        voice_ids.append(np.full(db.n_units, vi, np.int32))
        if halfphone:
            codes.append(_remap_vocab(db.unit_names, unit_vocab)[db.unit_code])
            ctxs.append(_remap_vocab(db.phone_names, phone_vocab)[db.context_codes])
        else:
            codes.append(np.zeros(db.n_units, np.int32))
            ctxs.append(np.zeros((db.n_units, 5), np.int32))
        wave_offset += len(db.waves)
        utt_offset += len(db.filenames)

    unit_names = [None] * len(unit_vocab)
    for name, c in unit_vocab.items():
        unit_names[c] = name
    phone_names = [None] * len(phone_vocab)
    for name, c in phone_vocab.items():
        phone_names[c] = name

    return VoiceDB(
        sample_rate=base.sample_rate,
        target_representation=base.target_representation,
        multiepoch=base.multiepoch,
        stream_list=list(base.stream_list),
        datadims=dict(base.datadims),
        filenames=filenames,
        unit_names=unit_names,
        phone_names=phone_names,
        voice_names=list(names),
        unit_features=feats,
        join_left=np.concatenate([db.join_left for db in dbs]),
        join_right=np.concatenate([db.join_right for db in dbs]),
        cutpoints=np.concatenate(cuts),
        utt_index=np.concatenate(utts),
        unit_pos=np.concatenate([db.unit_pos for db in dbs]),
        unit_code=np.concatenate(codes),
        context_codes=np.concatenate(ctxs),
        voice_ids=np.concatenate(voice_ids),
        unit_lf0=np.concatenate([db.unit_lf0 for db in dbs]),
        mean_target=mean_t,
        std_target=std_t,
        mean_join=mean_j,
        std_join=std_j,
        waves=np.concatenate(waves),
        wave_offsets=np.asarray(wave_offsets, np.int64),
    )

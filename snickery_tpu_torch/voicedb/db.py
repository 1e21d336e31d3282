"""VoiceDB artifact: the single checkpoint of a unit-selection voice (a copy
of ``snickery_tpu.voicedb.db``: the same directory format both ways).

Layout on disk (``<name>.voicedb/``):
    manifest.json            — dims, counts, stream layout, normalisation refs
    arrays/*.npy             — flat arrays (see VoiceDB fields)

Design (TPU-first): all arrays are dense, row-aligned and padded so the DB
uploads to HBM as-is; ``padded()`` pads the unit axis to a multiple so the
preselect kernel tiles cleanly and the row count divides a db-shard mesh axis
(SURVEY.md §5.8).  The reference's equivalent is a single HDF5 file read by
``Synthesiser.__init__`` (SURVEY.md §3.2).
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field

import numpy as np

from snickery_tpu_torch import utils

_MANIFEST = "manifest.json"
_ARRAYS = "arrays"

# Arrays that make up a VoiceDB; each is saved as arrays/<name>.npy.
_ARRAY_FIELDS = (
    "unit_features",      # (M, d_target) raw (unnormalised) target features
    "join_left",          # (M, d_join)  features at unit start (for cost vs prev unit's end)
    "join_right",         # (M, d_join)  features at unit end
    "cutpoints",          # (M, 3) int32: wave start, centre anchor, end (samples, into `waves`)
    "utt_index",          # (M,)  int32: utterance id of each unit
    "unit_pos",           # (M,)  int32: position of unit within its utterance
    "unit_code",          # (M,)  int32: halfphone name code (0 in epoch mode)
    "context_codes",      # (M, 5) int32: quinphone codes (zeros in epoch mode)
    "voice_ids",          # (M,)  int32: voice id per unit (all 0 single-voice)
    "unit_lf0",           # (M, k) float32: per-constituent-epoch lf0 (for target-f0 imposition)
    "mean_target",        # (d_target,)
    "std_target",         # (d_target,)
    "mean_join",          # (d_join,)
    "std_join",           # (d_join,)
    "waves",              # (total_samples,) float32 concatenated corpus audio
    "wave_offsets",       # (n_utts + 1,) int64 per-utterance start offsets into waves
)


@dataclass
class VoiceDB:
    # metadata
    sample_rate: int
    target_representation: str            # "epoch" | "halfphone"
    multiepoch: int
    stream_list: list[str]
    datadims: dict[str, int]
    filenames: list[str]                  # per-utterance basenames
    unit_names: list[str] = field(default_factory=list)   # code -> halfphone name
    phone_names: list[str] = field(default_factory=list)  # code -> phone (context vocab)
    voice_names: list[str] = field(default_factory=list)  # voice id -> name (multi-voice)
    version: int = 2

    # arrays (see _ARRAY_FIELDS)
    unit_features: np.ndarray = None
    join_left: np.ndarray = None
    join_right: np.ndarray = None
    cutpoints: np.ndarray = None
    utt_index: np.ndarray = None
    unit_pos: np.ndarray = None
    unit_code: np.ndarray = None
    context_codes: np.ndarray = None
    voice_ids: np.ndarray = None
    unit_lf0: np.ndarray = None
    mean_target: np.ndarray = None
    std_target: np.ndarray = None
    mean_join: np.ndarray = None
    std_join: np.ndarray = None
    waves: np.ndarray = None
    wave_offsets: np.ndarray = None

    def __post_init__(self) -> None:
        # single-voice DBs (and version-1 artifacts) have no voice_ids array
        if self.voice_ids is None and self.unit_features is not None:
            self.voice_ids = np.zeros(self.n_units, np.int32)

    @property
    def is_multivoice(self) -> bool:
        return len(self.voice_names) > 0

    # -- basic properties --
    @property
    def n_units(self) -> int:
        return int(self.unit_features.shape[0])

    @property
    def target_dim(self) -> int:
        return int(self.unit_features.shape[1])

    @property
    def join_dim(self) -> int:
        return int(self.join_left.shape[1])

    def normalised_features(self) -> np.ndarray:
        return (self.unit_features - self.mean_target) / self.std_target

    def normalised_joins(self) -> tuple[np.ndarray, np.ndarray]:
        return (
            (self.join_left - self.mean_join) / self.std_join,
            (self.join_right - self.mean_join) / self.std_join,
        )

    # -- persistence --
    def save(self, path: str) -> None:
        utils.safe_makedir(path)
        utils.safe_makedir(os.path.join(path, _ARRAYS))
        meta = {
            "sample_rate": self.sample_rate,
            "target_representation": self.target_representation,
            "multiepoch": self.multiepoch,
            "stream_list": self.stream_list,
            "datadims": self.datadims,
            "filenames": self.filenames,
            "unit_names": self.unit_names,
            "phone_names": self.phone_names,
            "voice_names": self.voice_names,
            "version": self.version,
            "n_units": self.n_units,
        }
        with open(os.path.join(path, _MANIFEST), "w") as f:
            json.dump(meta, f, indent=2)
        for name in _ARRAY_FIELDS:
            arr = getattr(self, name)
            if arr is not None:
                np.save(os.path.join(path, _ARRAYS, f"{name}.npy"), arr)

    @classmethod
    def load(cls, path: str, mmap: bool = True) -> "VoiceDB":
        with open(os.path.join(path, _MANIFEST)) as f:
            meta = json.load(f)
        meta.pop("n_units", None)
        kwargs = dict(meta)
        mode = "r" if mmap else None
        for name in _ARRAY_FIELDS:
            p = os.path.join(path, _ARRAYS, f"{name}.npy")
            kwargs[name] = np.load(p, mmap_mode=mode) if os.path.exists(p) else None
        return cls(**kwargs)

    def tiled(self, times: int) -> "VoiceDB":
        """Replicate the inventory ``times``-fold (capacity/perf testing).

        Every per-unit and per-utterance array is tiled with utterance and
        waveform indices shifted per replica, so the result is a fully
        self-consistent VoiceDB whose decode path (raw device layout,
        cutpoint fetches, natural-join detection) behaves exactly like a
        corpus that genuinely contains ``times`` copies of every utterance.
        Selection among replicas is tie-degenerate by construction (replica
        rows are bit-identical), so this is ONLY for capacity and step-time
        measurement, never for quality numbers.  Normalisation stats are
        unchanged (the feature distribution is unchanged).
        """
        if times <= 1:
            return self
        n_files = len(self.filenames)
        wave_len = int(self.wave_offsets[-1])
        reps = range(times)

        def tile_rows(a):
            return None if a is None else np.concatenate([a] * times)

        offsets = [np.asarray(self.wave_offsets[:1])] + [
            np.asarray(self.wave_offsets[1:]) + r * wave_len for r in reps]
        return VoiceDB(
            sample_rate=self.sample_rate,
            target_representation=self.target_representation,
            multiepoch=self.multiepoch,
            stream_list=list(self.stream_list),
            datadims=dict(self.datadims),
            filenames=[f"{f}~r{r}" for r in reps for f in self.filenames],
            unit_names=list(self.unit_names),
            phone_names=list(self.phone_names),
            voice_names=list(self.voice_names),
            unit_features=tile_rows(self.unit_features),
            join_left=tile_rows(self.join_left),
            join_right=tile_rows(self.join_right),
            cutpoints=np.concatenate(
                [self.cutpoints + r * wave_len for r in reps]),
            utt_index=np.concatenate(
                [self.utt_index + r * n_files for r in reps]),
            unit_pos=tile_rows(self.unit_pos),
            unit_code=tile_rows(self.unit_code),
            context_codes=tile_rows(self.context_codes),
            voice_ids=tile_rows(self.voice_ids),
            unit_lf0=tile_rows(self.unit_lf0),
            mean_target=self.mean_target,
            std_target=self.std_target,
            mean_join=self.mean_join,
            std_join=self.std_join,
            waves=np.concatenate([np.asarray(self.waves)] * times),
            wave_offsets=np.concatenate(offsets),
        )

    def summary(self) -> str:
        return (
            f"VoiceDB[{self.target_representation}] units={self.n_units} "
            f"d_target={self.target_dim} d_join={self.join_dim} "
            f"utts={len(self.filenames)} sr={self.sample_rate} "
            f"audio={len(self.waves)/self.sample_rate:.1f}s"
        )

"""Config system (a copy of ``snickery_tpu.config``: every key and default,
TPU-only keys included, so that one config file loads in both packages).

The reference drives every CLI with ``-c CONFIG`` where CONFIG is a
Python-syntax ``.cfg`` file exec'd into a namespace (SURVEY.md §5.6,
reference config/*.cfg — unverified, mount empty).  That key vocabulary is the
de-facto public API, so we keep it verbatim and add TPU-specific knobs under
the same flat namespace.  Configs may be ``.cfg``/``.py`` (exec'd, like the
reference) or ``.json``.
"""

from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass, field
from typing import Any


@dataclass
class SnickeryConfig:
    # ---- data locations (reference key vocabulary) ----
    workdir: str = "work"
    wav_datadir: str = ""
    pm_datadir: str = ""            # pitchmark (.pm EST) files
    lab_datadir: str = ""           # HTS label files (halfphone mode)
    feat_datadir: str = ""          # root dir holding one subdir per stream
    test_data_dir: str = ""         # natural-target test features
    test_data_frameshift: float = 0.0   # >0: test_data_dir streams are
                                        # fixed-rate at this frame shift (s);
                                        # they are resampled to an epoch grid
                                        # integrated from their lf0 stream
    test_patterns: list[str] = field(default_factory=list)
    n_train_utts: int = 0           # 0 = all

    # ---- streams / dims ----
    stream_list: list[str] = field(default_factory=lambda: ["mag", "lf0"])
    datadims: dict[str, int] = field(default_factory=lambda: {"mag": 60, "lf0": 1})
    sample_rate: int = 16000

    # ---- unit type ----
    target_representation: str = "epoch"   # "epoch" | "halfphone" | "sample"
    multiepoch: int = 1                     # units span k epochs/frames (k>=1)
    join_context_frames: int = 1            # feature frames per join context
                                            # (epoch mode; wider contexts make
                                            # the join cost prefer smoother
                                            # transitions — requires
                                            # multiepoch >= this, because the
                                            # device layout derives contexts
                                            # from the raw unit rows)
    sample_hop: int = 80                    # frame hop for "sample" units (samples)

    # ---- selection ----
    n_candidates: int = 30
    # Candidate preselection mode:
    #   ""                  auto: "quinphone" for halfphone voices, "acoustic"
    #                       for epoch/sample voices
    #   "acoustic"          pure nearest-neighbour over target features; no
    #                       linguistic penalties even for halfphone voices
    #   "quinphone"         graded quinphone-mismatch penalties fused into the
    #                       preselect ranking (halfphone voices only)
    #   "quinphone_backoff" strict back-off tiers: exact-quinphone candidates
    #                       outrank ALL triphone-only matches, which outrank
    #                       all remaining same-halfphone units, regardless of
    #                       acoustic distance (halfphone voices only)
    preselection_method: str = ""
    target_stream_weights: list[float] = field(default_factory=lambda: [1.0])
    join_stream_weights: list[float] = field(default_factory=lambda: [1.0])
    join_cost_weight: float = 1.0
    # Join-cost distance: "natural" = weighted Euclidean between adjoining
    # unit edge contexts (natural successors cost exactly 0); "squared" =
    # squared Euclidean (penalises large spectral jumps quadratically and
    # skips the sqrt — a cheaper, sharper-edged variant).
    join_cost_type: str = "natural"
    search_epsilon: float = 0.0             # beam/epsilon pruning (0 = exact)
    greedy_search: bool = False             # greedy online selection variant
    # quinphone preselection penalties (halfphone mode); see const.py for the
    # rationale — these are design decisions, so they are configurable
    quinphone_context_weights: list[float] = field(
        default_factory=lambda: [1.0, 10.0, 0.0, 10.0, 1.0])
    quinphone_penalty_scale: float = 100.0
    magphase_use_target_f0: bool = True
    # Extra pitch periods of window support on each side of every frame in
    # magphase resynthesis (0 = one period each side).  Larger values trade
    # transient sharpness for smoother joins.
    magphase_overlap: int = 0
    magphase_smooth_joins: int = 0          # frames of join smoothing (0 = off)

    # ---- waveform generation ----
    taper_length: int = 50                  # samples of Hann taper for OLA joins
    # True: the whole corpus waveform lives in HBM and concatenation runs on
    # device (fastest).  False: waveforms stay on host (mmap) and the OLA
    # runs in numpy after decode — frees ~4 bytes/sample of HBM for voices
    # whose audio would not fit next to the unit DB (e.g. 48 kHz corpora).
    preload_all_waves: bool = True
    # On-device corpus audio dtype: "float32" (exact) or "int16" (PCM-style
    # quantisation at the corpus peak — halves the one replicated array's
    # HBM at ~96 dB SNR; the OLA converts gathered rows on the fly).
    waves_dtype: str = "float32"

    # ---- silence / trimming ----
    trim_silence: bool = False
    silence_symbols: list[str] = field(default_factory=lambda: ["pau", "sil", "#"])

    # ---- TPU-specific (new in this framework) ----
    length_buckets: list[int] = field(default_factory=lambda: [128, 256, 512, 1024, 2048])
    db_pad_multiple: int = 512              # pad DB rows to a multiple of this
    synth_batch: int = 1                    # utterances per batched CLI synth step
    mesh_data: int = 1                      # data-parallel axis size (synth_batch path)
    mesh_db: int = 1                        # unit-DB shard axis size (synth_batch path)
    # Preselect kernel choice — tri-state: True = Pallas kernel on TPU (XLA
    # fallback on CPU backends), False = XLA top_k everywhere, "interpret" =
    # force the Pallas path in interpret mode on ANY backend (slow; lets CPU
    # test runs exercise the real kernel code).
    use_pallas: bool | str = True
    preselect_precision: str = "highest"    # "highest" (exact f32) | "split3"
                                            # (bf16_3x) | "split3cat" (same
                                            # maths as split3 in ONE K=3d MXU
                                            # pass: ~1.7x faster preselect)
    preselect_margin: int = -1              # extra preselect rank slots under
                                            # approximate kernel precisions;
                                            # -1 = per-precision default
                                            # (const.PRESELECT_MARGIN*)
    zero_transient: int = -1                # Pallas kernel consumes the
                                            # resident raw block directly (no
                                            # per-step derived DB operand in
                                            # HBM); -1 = auto policy
                                            # (ops.topk.zero_transient_default),
                                            # 0 = off, 1 = on
    raw_block_layout: str = "auto"          # device layout of the resident
                                            # raw block: "rowmajor" (default
                                            # tiled layout), "colmajor"
                                            # (major_to_minor=(0,1): compact,
                                            # removes the lane-padded relayout
                                            # copy of the whole block — the
                                            # round-4 8 GiB capacity OOM), or
                                            # "auto" (colmajor when the
                                            # zero-transient Pallas path is
                                            # active and the copy would be
                                            # >= ~2 GiB; utils.colmajor_format)

    # ---- misc ----
    voice_name: str = "voice"
    output_dir: str = ""

    def __post_init__(self) -> None:
        if self.target_representation not in ("epoch", "halfphone", "sample"):
            raise ValueError(f"unknown target_representation {self.target_representation!r}")
        if self.multiepoch < 1:
            raise ValueError("multiepoch must be >= 1")
        if self.join_context_frames < 1:
            raise ValueError("join_context_frames must be >= 1")
        if self.join_context_frames > 1:
            if self.target_representation == "halfphone":
                raise ValueError(
                    "join_context_frames > 1 is epoch-mode only (halfphone "
                    "target rows are [first, mid, last] frames, not "
                    "contiguous speech)")
            if self.join_context_frames > self.multiepoch:
                raise ValueError(
                    f"join_context_frames ({self.join_context_frames}) must "
                    f"be <= multiepoch ({self.multiepoch}): the device "
                    "layout derives join contexts from the raw unit rows, "
                    "which hold multiepoch frames")
        if self.n_candidates < 1:
            raise ValueError("n_candidates must be >= 1")
        if self.preselection_method not in (
                "", "acoustic", "quinphone", "quinphone_backoff"):
            raise ValueError(
                f"unknown preselection_method {self.preselection_method!r}")
        if self.join_cost_type not in ("natural", "squared"):
            raise ValueError(f"unknown join_cost_type {self.join_cost_type!r}")
        if self.magphase_overlap < 0:
            raise ValueError("magphase_overlap must be >= 0")
        if self.waves_dtype not in ("float32", "int16"):
            raise ValueError(f"unknown waves_dtype {self.waves_dtype!r}")
        if self.raw_block_layout not in ("auto", "rowmajor", "colmajor"):
            raise ValueError(
                f"unknown raw_block_layout {self.raw_block_layout!r}")
        # Broadcast scalar weights across streams.
        ns = len(self.stream_list)
        for attr in ("target_stream_weights", "join_stream_weights"):
            w = getattr(self, attr)
            if isinstance(w, (int, float)):
                w = [float(w)] * ns
            if len(w) == 1 and ns > 1:
                w = list(w) * ns
            if len(w) != ns:
                raise ValueError(f"{attr} has {len(w)} entries for {ns} streams")
            setattr(self, attr, [float(x) for x in w])

    # -- derived --
    @property
    def target_dim(self) -> int:
        return sum(self.datadims[s] for s in self.stream_list)

    @property
    def stream_slices(self) -> list[tuple[str, int, int]]:
        """(stream, start, stop) column ranges inside the stacked feature matrix."""
        out, off = [], 0
        for s in self.stream_list:
            d = self.datadims[s]
            out.append((s, off, off + d))
            off += d
        return out

    @property
    def db_path(self) -> str:
        return os.path.join(self.workdir, f"{self.voice_name}.voicedb")

    def to_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)


_CONFIG_KEYS = {f.name for f in dataclasses.fields(SnickeryConfig)}

# Accepted legacy aliases from the reference vocabulary (unverified spellings).
_ALIASES = {
    "wave_datadir": "wav_datadir",
    "n_candidates_per_unit": "n_candidates",
    "output_dirname": "output_dir",
}


def config_from_dict(raw: dict[str, Any], strict: bool = False) -> SnickeryConfig:
    known: dict[str, Any] = {}
    unknown: list[str] = []
    for k, v in raw.items():
        if k.startswith("_"):
            continue
        k = _ALIASES.get(k, k)
        if k in _CONFIG_KEYS:
            known[k] = v
        elif not callable(v) and not isinstance(v, type(os)):
            unknown.append(k)
    if unknown and strict:
        raise KeyError(f"unknown config keys: {unknown}")
    cfg = SnickeryConfig(**known)
    # Keep unknown keys around for forward-compat introspection.
    cfg._extra = {k: raw[k] for k in unknown}  # type: ignore[attr-defined]
    return cfg


def load_config(path: str, strict: bool = False) -> SnickeryConfig:
    """Load a config file.

    ``.json`` files are parsed as JSON; anything else is exec'd as Python with
    ``os`` and ``path`` in scope (matching the reference's exec'd ``.cfg``
    style, so reference-era configs port over by renaming keys only where the
    vocabulary genuinely differs).
    """
    if path.endswith(".json"):
        with open(path) as f:
            raw = json.load(f)
    else:
        ns: dict[str, Any] = {"os": os, "path": os.path.dirname(os.path.abspath(path))}
        with open(path) as f:
            code = f.read()
        exec(compile(code, path, "exec"), ns)
        raw = ns
    return config_from_dict(raw, strict=strict)

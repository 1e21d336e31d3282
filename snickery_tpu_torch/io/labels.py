"""HTS label reading and halfphone segmentation (a copy of
``snickery_tpu.io.labels``).

The reference's halfphone mode reads HTS-style alignment labels
(``<start> <end> <full-context-model>`` in 100ns HTK units, with state-level
sub-lines) to cut phones into left/right halves and to attach quinphone
context names used for linguistic preselection (SURVEY.md §2 rows 1,3;
unverified, mount empty).
"""

from __future__ import annotations

import logging
import re
from dataclasses import dataclass

import numpy as np

logger = logging.getLogger("snickery_tpu_torch")

HTK_UNITS_PER_SEC = 10_000_000  # 100 ns

# two label rows may disagree about a shared boundary by this much (seconds)
# before we call them overlapping — floating-point slop, not misalignment
_OVERLAP_TOL_SEC = 1e-6

# Full-context label: ll^l-c+r=rr@... — extract the quinphone.
_QUINPHONE_RE = re.compile(r"^(.+?)\^(.+?)-(.+?)\+(.+?)=(.+?)[@/].*$")
_TRIPHONE_RE = re.compile(r"^(.+?)-(.+?)\+(.+?)$")


@dataclass
class PhoneSegment:
    start_sec: float
    end_sec: float
    phone: str                      # central phone
    quinphone: tuple[str, str, str, str, str]
    state_bounds_sec: list[float]   # interior state boundaries (may be empty)


def parse_context(model: str) -> tuple[str, tuple[str, str, str, str, str]]:
    """Extract (central phone, quinphone) from a full-context model name."""
    m = _QUINPHONE_RE.match(model)
    if m:
        ll, l, c, r, rr = m.groups()
        return c, (ll, l, c, r, rr)
    m = _TRIPHONE_RE.match(model)
    if m:
        l, c, r = m.groups()
        return c, ("xx", l, c, r, "xx")
    return model, ("xx", "xx", model, "xx", "xx")


def read_hts_label(path: str) -> list[PhoneSegment]:
    """Parse an HTS alignment label file into phone segments.

    Supports state-level alignment (lines carrying ``[2]``..``[6]`` state
    markers, or repeated model names): consecutive lines with the same model
    name are merged into one phone whose interior boundaries are kept as
    state bounds.

    Real-world hardening (VERDICT r4 item 7):
    - Times with a fractional part are interpreted as SECONDS (Festival-
      style labels) with a warning; integer times as HTK 100 ns units — a
      seconds file read as HTK units would silently shrink every phone to
      ~100 ns.
    - A row whose end precedes its start, or that overlaps the previous row
      by more than float slop, raises ValueError naming the row — shuffled
      or wrongly-concatenated label files must not misparse silently
      (silence GAPS between rows are fine).
    - Zero-length phones (start == end) are dropped with a warning: they
      carry no audio and would otherwise produce zero-width halfphones.
    """
    raw_rows: list[tuple[float, float, str]] = []
    any_fractional = False
    with open(path) as f:
        for ln in f:
            parts = ln.split()
            if len(parts) < 3:
                continue
            try:
                start = float(parts[0])
                end = float(parts[1])
            except ValueError:
                continue
            any_fractional |= (start != int(start)) or (end != int(end))
            model = parts[2]
            model = re.sub(r"\[\d+\]$", "", model)  # strip state index marker
            raw_rows.append((start, end, model))

    scale = 1.0 / HTK_UNITS_PER_SEC
    if any_fractional:
        # HTK alignment times are integral 100 ns counts; fractional values
        # mean the file is already in seconds (Festival/esps .lab style)
        logger.warning("%s: fractional times found — interpreting label "
                       "times as SECONDS, not HTK 100 ns units", path)
        scale = 1.0
    rows = [(s * scale, e * scale, m) for s, e, m in raw_rows]

    segments: list[PhoneSegment] = []
    prev_end = None
    for i, (start, end, model) in enumerate(rows):
        if end < start - _OVERLAP_TOL_SEC:
            raise ValueError(
                f"{path}: row {i} ({model!r}) ends before it starts "
                f"({start:.6f}s .. {end:.6f}s) — corrupt label file")
        if prev_end is not None and start < prev_end - _OVERLAP_TOL_SEC:
            raise ValueError(
                f"{path}: row {i} ({model!r}) starts at {start:.6f}s, "
                f"overlapping the previous row ending at {prev_end:.6f}s — "
                "label rows must be non-overlapping and time-ordered")
        prev_end = max(end, prev_end) if prev_end is not None else end
        phone, quin = parse_context(model)
        if segments and segments[-1].quinphone == quin and abs(segments[-1].end_sec - start) < 1e-9:
            seg = segments[-1]
            seg.state_bounds_sec.append(start)
            seg.end_sec = end
        else:
            segments.append(PhoneSegment(start, end, phone, quin, []))
    kept = [s for s in segments if s.end_sec > s.start_sec]
    if len(kept) != len(segments):
        logger.warning("%s: dropped %d zero-length phone segment(s)",
                       path, len(segments) - len(kept))
    return kept


@dataclass
class HalfphoneSegment:
    start_sec: float
    end_sec: float
    name: str                       # e.g. "ae_L"
    phone: str
    half: str                       # "L" | "R"
    quinphone: tuple[str, str, str, str, str]


def halfphone_segments(
    phones: list[PhoneSegment],
    midpoint_from_states: bool = True,
) -> list[HalfphoneSegment]:
    """Split each phone into left/right halves.

    The split point is the middle state boundary when state alignment is
    available (HTS 5-state models split after state 3), else the temporal
    midpoint — matching the reference's halfphone construction as described
    in SURVEY.md §2 row 1 [M].
    """
    out: list[HalfphoneSegment] = []
    for seg in phones:
        if midpoint_from_states and len(seg.state_bounds_sec) >= 2:
            mid = seg.state_bounds_sec[len(seg.state_bounds_sec) // 2]
        else:
            mid = 0.5 * (seg.start_sec + seg.end_sec)
        mid = min(max(mid, seg.start_sec), seg.end_sec)
        out.append(HalfphoneSegment(seg.start_sec, mid, f"{seg.phone}_L",
                                    seg.phone, "L", seg.quinphone))
        out.append(HalfphoneSegment(mid, seg.end_sec, f"{seg.phone}_R",
                                    seg.phone, "R", seg.quinphone))
    return out


def segments_to_sample_bounds(
    segments: list[HalfphoneSegment] | list[PhoneSegment],
    sample_rate: int,
) -> np.ndarray:
    """(n, 2) int32 start/end sample bounds."""
    return np.asarray(
        [[round(s.start_sec * sample_rate), round(s.end_sec * sample_rate)] for s in segments],
        dtype=np.int32,
    )

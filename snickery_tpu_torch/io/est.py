"""EST_File pitchmark (.pm) reader and writer.

A copy of ``snickery_tpu/io/est.py`` with the same names and behaviour: ASCII
``EST_File Track`` files and plain one-time-per-line text files are read as
epoch positions in samples (sorted, deduplicated, negative times dropped,
seconds or milliseconds told apart by the median spacing); binary tracks
and unterminated headers are refused; the writer's files read back equal.
"""

from __future__ import annotations

import logging

import numpy as np

logger = logging.getLogger("snickery_tpu_torch")

# plausible pitch-period band used for unit auto-detection, in seconds:
# 500 Hz (high female/child F0) .. 1 Hz (generous: REAPER emits marks even
# in unvoiced stretches, inflating the spacing)
_MAX_PLAUSIBLE_PERIOD_SEC = 1.0


def read_est_pitchmarks(path: str, sample_rate: int,
                        units: str = "auto") -> np.ndarray:
    """Read pitchmarks -> int32 sample positions (sorted, deduplicated).

    Handles:
    - EST_File Track ASCII: header until ``EST_Header_End`` (unknown header
      fields are ignored), then lines of ``<time_sec> <flag> [value]``.
    - Bare text: one ``<time_sec>`` (or ``<time_sec> <flag>``) per line.
    Negative-time marks (REAPER emits some) are dropped; unsorted and
    duplicate marks are sorted and deduplicated.

    ``units``: "s", "ms", or "auto".  Auto treats values as seconds unless
    the median inter-mark spacing is implausibly large for a pitch period
    (>= 1 s), in which case milliseconds are assumed iff THAT reading is
    plausible — otherwise the file is rejected.  Pass an explicit unit to
    silence the heuristic.

    Raises ValueError (with the offending detail) for binary EST tracks,
    EST headers with no ``EST_Header_End``, files with no parseable marks,
    and spacing plausible under no supported unit.
    """
    if units not in ("auto", "s", "ms"):
        raise ValueError(f"units must be 'auto', 's' or 'ms'; got {units!r}")
    times: list[float] = []
    with open(path, "rb") as f:
        raw = f.read()
    text = raw.decode("latin-1")
    lines = text.splitlines()
    in_header = False
    header_seen = False
    for ln in lines:
        s = ln.strip()
        if not s:
            continue
        if s.startswith("EST_File"):
            in_header = True
            header_seen = True
            continue
        if in_header:
            if s.startswith("EST_Header_End"):
                in_header = False
            elif s.lower().startswith("datatype") and "binary" in s.lower():
                raise ValueError(
                    f"{path}: binary EST tracks are not supported — "
                    "re-export the pitchmarks as ASCII ('DataType ascii')")
            continue
        parts = s.split()
        try:
            t = float(parts[0])
        except ValueError:
            continue
        # REAPER .pm format is "<time> <voicing> <value>"; when a voicing flag
        # is present keep only voiced==1 ... but epoch-based snickery uses all
        # marks as waveform anchor points, so we keep every non-negative time.
        if t >= 0.0:
            times.append(t)
    if header_seen and in_header:
        raise ValueError(
            f"{path}: EST_File header never ends (no EST_Header_End line) — "
            "truncated or corrupt file")
    if not times:
        if header_seen:
            # complete, valid EST header with zero records: legitimately empty
            return np.zeros(0, np.int32)
        raise ValueError(f"{path}: no parseable pitchmarks found")
    tarr = np.asarray(times, dtype=np.float64)
    scale = 1.0
    if units == "ms":
        scale = 1e-3
    elif units == "auto" and len(tarr) >= 3:
        spacing = float(np.median(np.diff(np.sort(tarr))))
        if spacing >= _MAX_PLAUSIBLE_PERIOD_SEC:
            if spacing * 1e-3 < _MAX_PLAUSIBLE_PERIOD_SEC:
                logger.warning(
                    "%s: median inter-mark spacing %.3g is implausible for "
                    "seconds (F0 < 1 Hz); interpreting pitchmarks as "
                    "MILLISECONDS (pass units='s' to override)", path, spacing)
                scale = 1e-3
            else:
                raise ValueError(
                    f"{path}: median inter-mark spacing {spacing:.3g} is "
                    "implausible as seconds OR milliseconds — specify "
                    "units= explicitly if the file really is pitchmarks")
    samples = np.unique(np.round(tarr * scale * sample_rate)).astype(np.int32)
    return samples


def write_est_pitchmarks(sample_positions: np.ndarray, path: str, sample_rate: int) -> None:
    """Write sample positions as an ASCII EST track (round-trips with the reader)."""
    times = np.asarray(sample_positions, dtype=np.float64) / float(sample_rate)
    with open(path, "w") as f:
        f.write("EST_File Track\n")
        f.write("DataType ascii\n")
        f.write(f"NumFrames {len(times)}\n")
        f.write("NumChannels 0\n")
        f.write("EqualSpace 0\n")
        f.write("BreaksPresent true\n")
        f.write("EST_Header_End\n")
        for t in times:
            f.write(f"{t:.6f} 1 1\n")

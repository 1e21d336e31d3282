"""Speech stream and wav I/O (a copy of ``snickery_tpu.io.speech``).

Role-equivalent of the reference's script/speech_manip.py
(get_speech/put_speech/read_wave/write_wave — SURVEY.md §2 row 6; unverified,
mount empty).  Stream files are headerless little-endian float32 with a known
feature dimension — the interchange format of the HTS/Merlin ecosystem.

Wav I/O uses scipy.io.wavfile (no soundfile in this environment); all audio is
normalised to float32 in [-1, 1] in memory and written as 16-bit PCM.
"""

from __future__ import annotations

import logging
import warnings

import numpy as np
from scipy.io import wavfile

logger = logging.getLogger(__name__)


def get_speech(path: str, dim: int, dtype=np.float32) -> np.ndarray:
    """Read a headerless float stream file -> (frames, dim) array."""
    data = np.fromfile(path, dtype="<f4")
    if dim <= 0:
        raise ValueError(f"dim must be positive, got {dim}")
    if data.size % dim != 0:
        raise ValueError(
            f"{path}: {data.size} floats not divisible by dim={dim}"
        )
    return data.reshape(-1, dim).astype(dtype, copy=False)


def put_speech(data: np.ndarray, path: str) -> None:
    """Write (frames, dim) or (frames,) floats as a headerless stream file."""
    np.asarray(data, dtype="<f4").tofile(path)


def read_wave(path: str) -> tuple[np.ndarray, int]:
    """Read wav -> (float32 samples in [-1, 1], sample_rate).

    Adversarial-input contract (VERDICT r4 item 7 — same standard as the
    round-4 EST/HTS parser hardening: handle or reject with a message,
    never silently misparse):

    - stereo / multi-channel -> downmixed to mono (handled);
    - 8-bit unsigned, 16/24/32-bit PCM, float32/float64 -> scaled to
      [-1, 1] float32 (24-bit arrives from scipy as int32, low byte 0);
    - clipped or DC-offset audio -> valid input, passed through (the
      epoch detector subtracts the per-segment mean from its detection
      signal, so a DC offset does not shift pitchmarks);
    - truncated data chunk (header promises more bytes than the file
      holds) -> scipy's silent-partial-read WavFileWarning is promoted
      to a logged warning naming the file, and the partial audio is
      returned (sloppy-but-real headers exist in the wild; an EMPTY
      result still rejects below);
    - truncated/garbage RIFF header -> ValueError naming the file;
    - zero audio samples -> ValueError (an empty utterance can neither
      train nor synthesise — failing here beats a shape error later);
    - non-positive sample rate -> ValueError;
    - NaN/inf float samples -> ValueError (corrupt float wav).
    """
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            sr, data = wavfile.read(path)
        for w in caught:
            logger.warning("%s: %s (partial/odd wav accepted)",
                           path, w.message)
    except ValueError as e:
        raise ValueError(f"{path}: not a readable wav file ({e})") from e
    if data.size == 0:
        raise ValueError(f"{path}: wav contains zero audio samples")
    if sr <= 0:
        raise ValueError(f"{path}: invalid sample rate {sr}")
    # normalise by the INTEGER dtype first — downmixing would promote to
    # float64 and skip the scaling branch, leaving +/-32768-range samples
    if data.dtype == np.int16:
        wave = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        wave = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        wave = (data.astype(np.float32) - 128.0) / 128.0
    else:                                    # already float
        wave = data.astype(np.float32)
    if wave.ndim > 1:                        # downmix multi-channel
        wave = wave.mean(axis=1).astype(np.float32)
    if not np.isfinite(wave).all():
        raise ValueError(f"{path}: wav contains NaN/inf samples")
    return wave, int(sr)


def write_wave(wave: np.ndarray, path: str, sample_rate: int) -> None:
    """Write float samples in [-1, 1] as 16-bit PCM wav."""
    wave = np.asarray(wave, dtype=np.float32)
    clipped = np.clip(wave, -1.0, 1.0)
    pcm = (clipped * 32767.0).astype(np.int16)
    wavfile.write(path, int(sample_rate), pcm)

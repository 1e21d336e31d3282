"""ctypes bindings for the port's own build of the native epoch detector.

``epochs.cpp`` here is a copy of the repository's ``native/epochs.cpp``.  At
first use it is compiled with g++, with the flags of ``native/Makefile``,
into ``build/snickery_tpu_torch_native/`` under a name that carries a hash
of the source and the flags (a build from another source is never loaded);
the JAX package's ``native/libsnickery_native.so`` is never loaded.  The
functions keep the signatures of ``snickery_tpu.native``; each returns None
where the library cannot be built or loaded, and the callers
(``features/epochs.py``) then run the Python detector.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

from snickery_tpu_torch import utils

_SOURCE = Path(__file__).with_name("epochs.cpp")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "snickery_tpu_torch_native"
CXXFLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall", "-pthread")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_lib_failed = False

_i64p = ctypes.POINTER(ctypes.c_int64)
_i32p = ctypes.POINTER(ctypes.c_int32)
_f32p = ctypes.POINTER(ctypes.c_float)


def lib_path() -> Path:
    """Where the library of this source and these flags is built."""
    digest = hashlib.sha256(_SOURCE.read_bytes() + " ".join(CXXFLAGS).encode()).hexdigest()
    return BUILD_DIR / f"libsnickery_native_{digest[:16]}.so"


def _find_lib() -> str | None:
    """The built library, when it is on disk."""
    path = lib_path()
    return str(path) if path.exists() else None


def _build() -> bool:
    """Compile the library (to a temporary name, then renamed into place, so
    that processes building at once never load a half-written file)."""
    path = lib_path()
    try:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        res = subprocess.run(["g++", *CXXFLAGS, "-shared", "-o", tmp, str(_SOURCE)],
                             capture_output=True, text=True, timeout=120)
        if res.returncode != 0:
            os.unlink(tmp)
            utils.logger.warning("native build failed: %s", res.stderr[-500:])
            return False
        os.replace(tmp, path)
        return True
    except Exception as e:  # noqa: BLE001
        utils.logger.warning("native build unavailable: %s", e)
        return False


def get_lib() -> ctypes.CDLL | None:
    """Load (building if needed) the native library, or None."""
    global _lib, _lib_failed
    with _lock:
        if _lib is not None or _lib_failed:
            return _lib
        path = _find_lib()
        if path is None:
            if not _build():
                _lib_failed = True
                return None
            path = str(lib_path())
        try:
            lib = ctypes.CDLL(path)
        except OSError as e:
            utils.logger.warning("cannot load native lib: %s", e)
            _lib_failed = True
            return None
        lib.snickery_detect_epochs.restype = ctypes.c_int
        lib.snickery_detect_epochs.argtypes = [
            _f32p, ctypes.c_int, ctypes.c_int,
            ctypes.c_float, ctypes.c_float, ctypes.c_float,
            _i32p, ctypes.c_int,
        ]
        lib.snickery_detect_epochs_batch.restype = ctypes.c_int
        lib.snickery_detect_epochs_batch.argtypes = [
            _f32p, _i64p, ctypes.c_int, ctypes.c_int,
            ctypes.c_float, ctypes.c_float, ctypes.c_float,
            _i32p, _i64p, _i32p,
        ]
        lib.snickery_detect_epochs_batch_mt.restype = ctypes.c_int
        lib.snickery_detect_epochs_batch_mt.argtypes = [
            _f32p, _i64p, ctypes.c_int, ctypes.c_int,
            ctypes.c_float, ctypes.c_float, ctypes.c_float,
            _i32p, _i64p, _i32p, ctypes.c_int,
        ]
        _lib = lib
        return _lib


def _max_marks(n_samples: int, sr: int, unvoiced_period_sec: float) -> int:
    return max(64, int(n_samples / max(sr * unvoiced_period_sec, 1) * 4))


def native_detect_epochs(
    wave: np.ndarray, sr: int, fmin: float = 50.0, fmax: float = 400.0,
    unvoiced_period_sec: float = 0.005,
) -> np.ndarray | None:
    """Run the C++ epoch detector; None if the native lib is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    wave32 = np.ascontiguousarray(wave, dtype=np.float32)
    max_marks = _max_marks(len(wave32), sr, unvoiced_period_sec)
    out = np.zeros(max_marks, dtype=np.int32)
    n = lib.snickery_detect_epochs(
        wave32.ctypes.data_as(_f32p), len(wave32),
        int(sr), float(fmin), float(fmax), float(unvoiced_period_sec),
        out.ctypes.data_as(_i32p), max_marks)
    if n < 0:
        return None
    return np.unique(out[:n])


def native_detect_epochs_batch(
    waves: list, sr: int, fmin: float = 50.0, fmax: float = 400.0,
    unvoiced_period_sec: float = 0.005, n_threads: int | None = None,
) -> list | None:
    """Whole-corpus epoch detection in one foreign call: the utterances are
    concatenated and the C++ side gets the offset table.  Per-utterance
    results equal :func:`native_detect_epochs`'s bit for bit at any
    ``n_threads`` (``None``: one a CPU, ``SNICKERY_EPOCH_THREADS``
    overrides); the GIL is released during the call.  None if the native
    lib is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    n_utts = len(waves)
    if n_utts == 0:
        return []
    if n_threads is None:
        n_threads = int(os.environ.get("SNICKERY_EPOCH_THREADS",
                                       os.cpu_count() or 1))
    offsets = np.zeros(n_utts + 1, dtype=np.int64)
    for i, w in enumerate(waves):
        offsets[i + 1] = offsets[i] + len(w)
    buf = np.empty(int(offsets[-1]), dtype=np.float32)
    for i, w in enumerate(waves):
        buf[offsets[i]: offsets[i + 1]] = np.asarray(w, dtype=np.float32)
    caps = np.zeros(n_utts + 1, dtype=np.int64)
    for i, w in enumerate(waves):
        caps[i + 1] = caps[i] + _max_marks(len(w), sr, unvoiced_period_sec)
    marks = np.zeros(int(caps[-1]), dtype=np.int32)
    counts = np.zeros(n_utts, dtype=np.int32)
    rc = lib.snickery_detect_epochs_batch_mt(
        buf.ctypes.data_as(_f32p), offsets.ctypes.data_as(_i64p),
        n_utts, int(sr), float(fmin), float(fmax),
        float(unvoiced_period_sec),
        marks.ctypes.data_as(_i32p), caps.ctypes.data_as(_i64p),
        counts.ctypes.data_as(_i32p), max(1, int(n_threads)))
    if rc < 0:
        return None
    return [np.unique(marks[caps[i]: caps[i] + counts[i]])
            for i in range(n_utts)]

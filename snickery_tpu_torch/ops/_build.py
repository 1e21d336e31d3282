"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Every ``csrc/*.cu`` file has a plain C interface.  At first use they are
compiled together into one shared library for ``sm_90a``::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o build/snickery_tpu_torch_kernels/<name>.so csrc/*.cu

The library's file name carries a hash of the sources and flags, so a build
from other sources is never loaded.  Only the sources in the package are
built; nothing is fetched.  The library is built and loaded once per
process, under a lock: a server's batcher thread and its streaming handlers
may reach the kernels first at the same time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from dataclasses import dataclass
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "snickery_tpu_torch_kernels"
_LOCK = threading.Lock()
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


@dataclass(frozen=True)
class KernelLibrary:
    lib: ctypes.CDLL
    path: Path
    build_seconds: float     # 0.0 when an identical build was already on disk
    compiler_log: str        # nvcc's output (ptxas register / spill report)


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([os.path.join(cuda_home, "bin", "nvcc")] if cuda_home else []) + [
            "/usr/local/cuda/bin/nvcc"]:
        if os.path.exists(cand):
            return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                           "source at first use and need the CUDA toolkit")
    return found


def kernel_library() -> KernelLibrary:
    """Compile (if needed) and load the kernels of ``csrc/``; thread-safe."""
    with _LOCK:
        return _kernel_library()


@functools.cache
def _kernel_library() -> KernelLibrary:
    sources = sorted(CSRC_DIR.glob("*.cu"))
    if not sources:
        raise RuntimeError(f"no CUDA sources under {CSRC_DIR}")
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    out = BUILD_DIR / f"libsnickery_tpu_torch_{h.hexdigest()[:16]}.so"
    seconds, log = 0.0, ""
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources)]
        t0 = time.perf_counter()
        res = subprocess.run(cmd, capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        log = res.stdout + res.stderr
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed ({res.returncode}):\n{log}")
        os.replace(tmp, out)
    return KernelLibrary(ctypes.CDLL(str(out)), out, seconds, log)

"""General utilities of the port: directories, file lists, logging, timing.

The jax-free helpers of ``snickery_tpu.utils``, copied with the same names
and behaviour.  The JAX- and TPU-only helpers there (compilation cache,
``jax.profiler`` traces, device uploads and layouts) have no counterpart.
:func:`torch_device` is the port's own: the device check of its entry
points.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import time
from typing import Iterable, Iterator

logger = logging.getLogger("snickery_tpu_torch")
if not logger.handlers:
    _h = logging.StreamHandler()
    _h.setFormatter(logging.Formatter("[%(asctime)s %(name)s %(levelname)s] %(message)s"))
    logger.addHandler(_h)
    logger.setLevel(os.environ.get("SNICKERY_LOGLEVEL", "INFO"))


def safe_makedir(path: str) -> str:
    """Create *path* (and parents) if missing; return it."""
    os.makedirs(path, exist_ok=True)
    return path


def writelist(items: Iterable[str], path: str) -> None:
    """Write one item per line."""
    with open(path, "w") as f:
        f.write("\n".join(str(x) for x in items) + "\n")


def readlist(path: str) -> list[str]:
    """Read non-empty stripped lines."""
    with open(path) as f:
        return [ln.strip() for ln in f if ln.strip()]


def basenames_in(directory: str, ext: str) -> list[str]:
    """Sorted basenames (no extension) of files with extension *ext* in *directory*."""
    if not os.path.isdir(directory):
        return []
    ext = ext.lstrip(".")
    return sorted(
        os.path.splitext(fn)[0]
        for fn in os.listdir(directory)
        if fn.endswith("." + ext)
    )


class StageTimer:
    """Accumulates per-stage wall-clock timings."""

    def __init__(self) -> None:
        self.totals: dict[str, float] = {}
        self.counts: dict[str, int] = {}

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> dict[str, float]:
        return dict(sorted(self.totals.items(), key=lambda kv: -kv[1]))

    def log(self, prefix: str = "timing") -> None:
        for name, total in self.report().items():
            logger.info("%s %-24s %8.4fs (n=%d)", prefix, name, total, self.counts[name])


def dump_json(obj, path: str) -> None:
    with open(path, "w") as f:
        json.dump(obj, f, indent=2, sort_keys=True)


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


def next_multiple(x: int, m: int) -> int:
    """Smallest multiple of *m* that is >= x (and >= m)."""
    return max(m, ((x + m - 1) // m) * m)


def torch_device(device):
    """``torch.device(device)`` for an entry point of the port: "cuda" raises
    where CUDA is absent (nothing falls back to the CPU)."""
    import torch

    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {str(device)!r}: CUDA is not available; pass "
                               "device='cpu' explicitly for the CPU path")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def bucket_length(x: int, buckets: tuple[int, ...] | list[int]) -> int:
    """Smallest bucket >= x, or round x up to a multiple of the largest bucket
    (pads variable-length utterances to a small set of shapes)."""
    for b in sorted(buckets):
        if x <= b:
            return b
    top = max(buckets)
    return next_multiple(x, top)

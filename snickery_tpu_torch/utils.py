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
import threading
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
    """Accumulates per-stage wall-clock timings (``totals``, ``counts``) and,
    while ``torch.profiler`` records on the calling thread, per-stage device
    time (:meth:`device_times`).

    ``stage(name)`` is a span of host work; ``stage(name, device)`` one that
    covers work on ``device``.  While the profiler records, every span is the
    profiler range ``snk.<name>`` (a host event on the clock of the device
    trace), and a device span on a card records a pair of timing events on
    the device's current stream, with no synchronisation; on the CPU, which
    runs a stage synchronously, its host time is its device time.  Pairs are
    turned into seconds by :meth:`resolve` where the caller has waited for
    the card, or by :meth:`device_times`, which waits for them; at most
    ``MAX_PENDING`` stay unresolved.  With the profiler off a span records
    its host time only."""

    MAX_PENDING = 1024

    def __init__(self) -> None:
        self.totals: dict[str, float] = {}
        self.counts: dict[str, int] = {}
        self._device: dict[str, list] = {}    # name -> [seconds, count]
        self._pending: list = []              # (name, start event, end event)
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def stage(self, name: str, device=None) -> Iterator[None]:
        import torch

        t0 = time.perf_counter()
        if not torch.autograd._profiler_enabled():
            try:
                yield
            finally:
                self._add_host(name, time.perf_counter() - t0)
            return
        events = None
        if device is not None and device.type == "cuda":
            stream = torch.cuda.current_stream(device)
            events = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
            events[0].record(stream)
        try:
            with torch.profiler.record_function("snk." + name):
                yield
        finally:
            dt = time.perf_counter() - t0
            self._add_host(name, dt)
            if events is not None:
                events[1].record(stream)
                with self._lock:
                    self._pending.append((name, *events))
                    full = len(self._pending) > self.MAX_PENDING
                if full:
                    self.resolve(wait=True)
            elif device is not None:
                self._add_device(name, dt)

    def _add_host(self, name: str, seconds: float) -> None:
        with self._lock:
            self.totals[name] = self.totals.get(name, 0.0) + seconds
            self.counts[name] = self.counts.get(name, 0) + 1

    def _add_device(self, name: str, seconds: float) -> None:
        with self._lock:
            acc = self._device.setdefault(name, [0.0, 0])
            acc[0] += seconds
            acc[1] += 1

    def resolve(self, wait: bool = False) -> None:
        """Adds the device time of each recorded pair whose end the card has
        reached (of every pair, waiting for them, with ``wait``)."""
        with self._lock:
            pending, self._pending = self._pending, []
        keep = []
        for name, start, end in pending:
            if wait:
                end.synchronize()
            elif not end.query():
                keep.append((name, start, end))
                continue
            self._add_device(name, start.elapsed_time(end) / 1e3)
        if keep:
            with self._lock:
                self._pending[:0] = keep

    def device_times(self) -> dict[str, tuple[float, int]]:
        """{stage: (device seconds, spans)} of the spans timed while the
        profiler recorded."""
        self.resolve(wait=True)
        with self._lock:
            return {name: (s, n) for name, (s, n) in self._device.items()}

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

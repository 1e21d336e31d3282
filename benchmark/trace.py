"""The device's side of a traced window, from ``torch.profiler``: the
seconds in which an operation ran on the device, the device time of kernels
by name, and the breakdown (the operations that took most time, and the
longest idle gaps named by what the host was doing).

An untraced run gets a :class:`Tracer` that does nothing, so the window it
measures carries no profiler.
"""

from __future__ import annotations

import contextlib
import re
import time


class Trace:
    def __init__(self, device_ops: list, host_ops: list, t0: float, t1: float):
        self.device_ops = device_ops      # (start us, end us, name), sorted
        self.host_ops = host_ops          # (start us, end us, name), sorted
        self.t0, self.t1 = t0, t1         # the window, us
        self.window_s = (t1 - t0) / 1e6
        self.busy_s = self._busy()

    def _busy(self) -> float:
        busy, end = 0.0, self.t0
        for s, e, _ in self.device_ops:
            s, e = max(s, self.t0), min(e, self.t1)
            if e > end:
                busy += e - max(s, end)
                end = e
        return busy / 1e6

    def kernel_seconds(self, pattern: str) -> float:
        """Device seconds of the operations whose names match ``pattern``."""
        rx = re.compile(pattern)
        return sum(e - s for s, e, n in self.device_ops if rx.search(n)) / 1e6

    def gaps(self) -> list:
        """(start us, length us) of each stretch of the window with nothing
        running on the device."""
        out, end = [], self.t0
        for s, e, _ in self.device_ops:
            if s > end:
                out.append((end, min(s, self.t1) - end))
            end = max(end, e)
        if self.t1 > end:
            out.append((end, self.t1 - end))
        return [g for g in out if g[1] > 0]

    def host_at(self, t: float) -> str:
        """The innermost host operation running at ``t``."""
        best = None
        for s, e, n in self.host_ops:
            if s > t:
                break
            if e > t and (best is None or s >= best[0]):
                best = (s, n)
        return best[1] if best else "no host operation recorded"

    def breakdown(self, top: int = 10) -> dict:
        by_name = {}
        for s, e, n in self.device_ops:
            by_name[n] = by_name.get(n, 0.0) + (e - s) / 1e6
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        gaps = sorted(self.gaps(), key=lambda g: -g[1])[:top]
        return {"device_ops": [[n[:200], s] for n, s in ops],
                "idle_gaps": [[self.host_at(g0 + 1e-3)[:200], g / 1e6] for g0, g in gaps]}


class Tracer:
    """``with tracer.window():`` around the measured window; with
    ``enabled`` the window runs under ``torch.profiler`` (tracing the card
    with ``cuda``) and ``trace`` holds its :class:`Trace` afterwards."""

    def __init__(self, enabled: bool, cuda: bool = True):
        self.enabled, self.cuda = enabled, cuda
        self.trace: Trace | None = None

    @contextlib.contextmanager
    def window(self):
        if not self.enabled:
            yield
            return
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self.cuda else [])
        sync = torch.cuda.synchronize if self.cuda else (lambda: None)
        sync()
        with profile(activities=acts) as prof:
            with record_function("bench.window"):
                yield
                sync()
        t_read = time.perf_counter()
        dev, host, t0, t1 = [], [], None, None
        cuda = torch.autograd.DeviceType.CUDA
        for name, start, end, kind, annotation in _events(prof):
            if kind == cuda:
                if not annotation:
                    dev.append((start, end, name))
            elif name == "bench.window":
                t0, t1 = start, end
            else:
                host.append((start, end, name))
        dev.sort()
        host.sort()
        self.trace = Trace(dev, host, t0, t1)
        self.read_s = time.perf_counter() - t_read


def _events(prof):
    """(name, start us, end us, device type, is an annotation) of every
    recorded event: from the profiler's raw results where this torch has
    them (fast), else from its event list.  An annotation (the window's own
    range, as the profiler mirrors it on the device's timeline) is no
    device operation."""
    raw = getattr(getattr(prof, "profiler", None), "kineto_results", None)
    if raw is not None and hasattr(raw, "events"):
        for e in raw.events():
            s = e.start_ns() / 1e3
            note = e.name() == "bench.window" or bool(getattr(e, "is_user_annotation",
                                                              lambda: False)())
            yield e.name(), s, s + e.duration_ns() / 1e3, e.device_type(), note
        return
    for e in prof.events():
        note = e.name == "bench.window" or bool(getattr(e, "is_user_annotation", False))
        yield e.name, e.time_range.start, e.time_range.end, e.device_type, note

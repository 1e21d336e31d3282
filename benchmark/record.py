"""What a run knows, handed to the entries that drive the program and to the
readers of the metrics."""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class Run:
    cell: object                  # registry.Cell
    seed: int
    device: str
    log: object                   # log(message): a line on standard error
    tracer: object                # trace.Tracer
    units: object = None          # the unit kind's module (registry.units)
    pool: list = None             # held-out target utterances (dicts)
    voice_rows: list = None       # units a voice, as the benchmark counts them
    synth: object = None          # the program's Synthesiser
    state: dict = field(default_factory=dict)   # an entry's own state
    # the measured window
    wall_s: float = 0.0           # its length
    asked: list = field(default_factory=list)     # traffic.Ask a due answer
    answers: list = field(default_factory=list)   # the program's, None where none came
    latencies_ms: list = None     # a due answer (open loop), inf where none came
    late_ms: list = None          # how late each request was sent (open loop)
    steps: int = 0                # synthesis steps the program ran
    audio_s: float = 0.0          # seconds of audio answered
    counters: dict = field(default_factory=dict)  # the program's counters, window deltas
    work: list = field(default_factory=list)      # a step's shapes (closed loop)
    sample: list = field(default_factory=list)    # answers the reference searches
    setup_s: float = 0.0          # process start to the window's start
    synth_peak_bytes: int = 0     # device peak from the Synthesiser's creation

    @property
    def trace(self):
        return self.tracer.trace

    def features(self, ask):
        """The target trajectory a call passes for ``ask``."""
        return self.units.features(self.pool, ask)

"""``ling_ms.hp_batch``: device time of the program's ``ling`` spans a step
in the traced window, in ms: the halfphone labels' work inside ``preselect``
(the target labels packed for the kernel) and ``rescore`` (the penalised
ranking key, the identity fallback mask), timed on the card's stream by the
``Synthesiser``'s ``timer`` (``StageTimer.device_times``), which times stages
only while the profiler records.  None where the program has no such span."""

STAGES = ("ling",)


def read(run):
    device_times = getattr(getattr(run.synth, "timer", None), "device_times", None)
    if run.trace is None or device_times is None or run.steps == 0:
        return None
    spans = device_times()
    if not any(s in spans for s in STAGES):
        return None
    return 1e3 * sum(spans[s][0] for s in STAGES if s in spans) / run.steps

"""``copy_ms.batch``: device time of the program's host-device copies a step
in the traced window, in ms: stage ``copy_in`` (targets, lengths, codes,
contexts and voice ids to the card) plus stage ``copy_out`` (ids, costs,
audio and totals back), timed on the card's stream by the ``Synthesiser``'s
``timer`` (``StageTimer.device_times``), which times stages only while the
profiler records: in the window alone."""

STAGES = ("copy_in", "copy_out")


def read(run):
    device_times = getattr(getattr(run.synth, "timer", None), "device_times", None)
    if run.trace is None or device_times is None or run.steps == 0:
        return None
    spans = device_times()
    if not any(s in spans for s in STAGES):
        return None
    return 1e3 * sum(spans[s][0] for s in STAGES if s in spans) / run.steps

"""``pad_ms.hp_batch``: host time of the program's ``pad`` span a step in the
traced window, in ms, from its ``snk.pad`` ranges on the profiler's clock:
the padded target arrays and, for halfphone voices, each target's name and
quinphone looked up in the voice's vocabularies (``Synthesiser.batch_inputs``)."""

SPAN = "snk.pad"


def read(run):
    trace = run.trace
    if trace is None or run.steps == 0:
        return None
    spans = [e - s for s, e, name in trace.host_ops if name == SPAN]
    if not spans:
        return None
    return sum(spans) / 1e3 / run.steps

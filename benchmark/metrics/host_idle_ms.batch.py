"""``host_idle_ms.batch``: the traced window's device-idle time that falls
inside the program's ``snk.synth_batch`` host ranges, a step, in ms: the
card waiting on the synthesiser's own host work (preparing and padding the
targets, staging the copies, the results).  The rest of the idle time, with
the host outside the calls, is the caller's: ``device_idle.batch`` less
this."""

CALL = "snk.synth_batch"


def read(run):
    trace = run.trace
    if trace is None or not trace.device_ops or run.steps == 0:
        return None
    calls = [(s, e) for s, e, name in trace.host_ops if name == CALL]
    if not calls:
        return None
    # calls follow one another and gaps are in order: one pass over both
    idle_us, i = 0.0, 0
    for g0, length in trace.gaps():
        g1 = g0 + length
        while i < len(calls) and calls[i][1] <= g0:
            i += 1
        j = i
        while j < len(calls) and calls[j][0] < g1:
            idle_us += max(0.0, min(g1, calls[j][1]) - max(g0, calls[j][0]))
            j += 1
    return idle_us / 1e3 / run.steps

"""``synth_step_ms.served``: the mean of the synthesiser's ``synth_step``
span (``Synthesiser.timer``: host clock around the step and its copy to the
host) over the window, in ms."""


def read(run):
    n = run.counters.get("synth_step_n", 0)
    return 1e3 * run.counters["synth_step_s"] / n if n else None

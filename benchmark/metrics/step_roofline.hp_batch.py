"""``step_roofline.hp_batch``: the sum of each halfphone step's stage bounds
over the traced window's wall time, in percent: the preselect's as
``preselect_roofline.hp_batch`` counts it (masked), the rescore's and the
decode's with join contexts one frame wide (151, against rows of 453), the
overlap-add's as ``roofline.step_bounds_ms`` counts it.  It reads the work
of the cell's shapes, whatever kernels do it."""

from benchmark import roofline


def _bounds_ms(w: dict, dj: int) -> float:
    t, n, kd = w["targets"], w["n"], w["kd"]
    return (roofline.bound_ms(t, w["rows"], kd, n, w["precision"], True,
                              work=(w["pairs"], w["rows"]))[0]
            + roofline.rescore_bound_ms(t, n, kd, dj)[0]
            + roofline.decode_bound_ms(w["decode"], t, n, dj, 8 * t + 4 * w["utterances"])[0]
            + roofline.ola_bound_ms(w["fragment_samples"], w["out_samples"])[0])


def read(run):
    if run.trace is None or not run.trace.device_ops or not run.work or run.wall_s <= 0:
        return None
    syn = run.cell.config["synth"]
    dj = sum(syn["datadims"][s] for s in syn["stream_list"])
    return 100.0 * sum(_bounds_ms(w, dj) for w in run.work) / 1e3 / run.wall_s

"""``preselect_roofline.hp_batch``: the least time the window's halfphone
preselects need over the device time of the preselect kernels, both passes,
in the window, in percent: ``roofline.bound_ms`` of each step's live targets
against the voice's rows at the unit row's width (453) and ``n`` kept
candidates, masked (the 32 bytes of label metadata of each target and row
that the ``_ling`` kernel reads).  The ``_ling`` kernel's share of its
roofline."""

from benchmark import roofline

KERNELS = r"topk_partial|topk_merge"


def read(run):
    if run.trace is None or not run.work:
        return None
    device_s = run.trace.kernel_seconds(KERNELS)
    if device_s <= 0:
        return None
    bound_ms = sum(roofline.bound_ms(w["targets"], w["rows"], w["kd"], w["n"], w["precision"],
                                     True, work=(w["pairs"], w["rows"]))[0]
                   for w in run.work)
    return 100.0 * bound_ms / 1e3 / device_s

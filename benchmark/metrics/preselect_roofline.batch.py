"""``preselect_roofline.batch``: the least time the window's preselects need
(``roofline.bound_ms`` of each step's shapes at the configured precision)
over the device time of the preselect kernels, both passes, in the window,
in percent."""

from benchmark import roofline

KERNELS = r"topk_partial|topk_merge"


def read(run):
    if run.trace is None or not run.work:
        return None
    device_s = run.trace.kernel_seconds(KERNELS)
    if device_s <= 0:
        return None
    bound_ms = sum(roofline.step_bounds_ms(w)["preselect"] for w in run.work)
    return 100.0 * bound_ms / 1e3 / device_s

"""``step_roofline.batch``: the sum of each step's stage bounds (preselect,
rescore, decode, overlap-add; ``roofline.step_bounds_ms``) over the traced
window's wall time, in percent.  It reads the work of the cell's shapes,
whatever kernels do it."""

from benchmark import roofline


def read(run):
    if run.trace is None or not run.trace.device_ops or not run.work or run.wall_s <= 0:
        return None
    bound_ms = sum(sum(roofline.step_bounds_ms(w).values()) for w in run.work)
    return 100.0 * bound_ms / 1e3 / run.wall_s

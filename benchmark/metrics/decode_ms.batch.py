"""``decode_ms.batch``: device time of the decode kernels a step in the
window, in ms."""

KERNELS = r"viterbi_kernel|greedy_kernel"


def read(run):
    if run.trace is None or run.steps == 0:
        return None
    device_s = run.trace.kernel_seconds(KERNELS)
    return 1e3 * device_s / run.steps if device_s > 0 else None

"""``batch_size_mean.served``: requests over synthesis steps in the window,
from the server's ``DynamicBatcher.batch_sizes``."""


def read(run):
    sizes = run.counters.get("batch_sizes") or {}
    steps = sum(sizes.values())
    return sum(int(k) * v for k, v in sizes.items()) / steps if steps else None

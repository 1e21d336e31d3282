"""``peak_mem_gib``: the device memory peak (``torch.cuda.max_memory_allocated``)
from the ``Synthesiser``'s creation to the window's end, in GiB; the
benchmark's own input tensors are freed before, and the reference runs
after."""


def read(run):
    return run.synth_peak_bytes / 2 ** 30 if run.synth_peak_bytes else None

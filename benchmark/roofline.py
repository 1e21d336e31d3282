"""The least time the card could take for a step's work, from its shapes: a
frozen copy of ``snickery_tpu_torch.kernel_check``'s ``bound_ms``,
``decode_bound_ms`` and peaks, and of ``partition_work``'s count (from the
targets of each voice rather than the masks), with the rescore's and the
overlap-add's bytes beside them.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at its 700 W
limit): 67 TFLOP/s FP32 outside the tensor cores, 989 TFLOP/s bf16, HBM at
3.35 TB/s.  Each bound is the larger of the operations over the peak rate of
their type and the bytes over HBM bandwidth, each input byte read once and
each output byte written once; it says which of the two binds.
"""

from __future__ import annotations

PEAK_FLOPS = {"highest": 67e12, "split3": 989e12, "split3cat": 989e12}
HBM_BYTES_PER_S = 3.35e12


def _bound(flops: float, nbytes: float, peak: float):
    t_ops, t_bytes = flops / peak, nbytes / HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def bound_ms(T: int, m_rows: int, kd: int, k: int, precision: str, masked: bool,
             row_bytes: float | None = None, work: tuple | None = None):
    """(ms, binding term) of one preselect: 2 kd FLOP a (target, DB row)
    product, ``T * m_rows`` of them or ``work[0]`` (three bf16 products at
    a split precision), against the targets, each DB row's ``row_bytes``
    (default its data and squared norm, ``4 (kd + 1)``; ``work[1]`` rows),
    the metadata rows when masked, and the (T, k) scores and ids."""
    pairs, rows = work or (T * m_rows, m_rows)
    flops = 2.0 * pairs * kd * (1 if precision == "highest" else 3)
    if row_bytes is None:
        row_bytes = 4.0 * (kd + 1)
    nbytes = 4.0 * (T * kd + 2 * T * k) + rows * row_bytes
    if masked:
        nbytes += 32.0 * (T + rows)
    return _bound(flops, nbytes, PEAK_FLOPS[precision])


def partition_work(targets_of_voice: dict, rows_of_voice) -> tuple:
    """(products, DB rows) of a partition-masked preselect: each target
    against its own voice's rows, and the rows of the voices asked for
    (``targets_of_voice``: live targets by voice id)."""
    return (sum(c * rows_of_voice[v] for v, c in targets_of_voice.items()),
            sum(rows_of_voice[v] for v in targets_of_voice))


def decode_bound_ms(kind: str, live_steps: int, n: int, dj: int, out_bytes: int):
    """(ms, binding term) of a decode over ``live_steps`` lattice steps of
    ``n`` candidates: the Viterbi reads each step's target costs and both
    contexts and does ``n^2 dj`` subtractions, multiplications and additions;
    a greedy step reads ``(dj + 1) n + dj`` and does ``n dj`` of each; FP32."""
    if kind == "viterbi":
        nbytes, flops = 4.0 * live_steps * n * (2 * dj + 1), 3.0 * live_steps * n * n * dj
    else:
        nbytes, flops = 4.0 * live_steps * (n * (dj + 1) + dj), 3.0 * live_steps * n * dj
    return _bound(flops, nbytes + out_bytes, PEAK_FLOPS["highest"])


def rescore_bound_ms(targets: int, n: int, kd: int, dj: int):
    """(ms, "bytes") of the exact rescore: each target's ``n`` candidate rows
    read (``kd`` f32), its lattice inputs written (``n`` target costs and two
    ``dj`` contexts, f32, and ``n`` int64 ids)."""
    return _bound(0.0, 4.0 * targets * n * kd + targets * n * (4.0 * (2 * dj + 1) + 8.0),
                  PEAK_FLOPS["highest"])


def ola_bound_ms(fragment_samples: int, out_samples: int):
    """(ms, "bytes") of the overlap-add: each fragment's samples read and
    the output written, f32."""
    return _bound(0.0, 4.0 * (fragment_samples + out_samples), PEAK_FLOPS["highest"])


def step_bounds_ms(step: dict) -> dict:
    """Each stage's bound (ms) of one synthesis step described by ``step``:
    ``targets`` (live target rows), ``pairs`` and ``rows`` (preselect
    products and DB rows), ``kd``, ``n`` (candidates), ``precision``,
    ``masked``, ``decode`` ("viterbi" or "greedy"), ``utterances``,
    ``fragment_samples`` and ``out_samples``."""
    t, n, kd = step["targets"], step["n"], step["kd"]
    return {
        "preselect": bound_ms(t, step["rows"], kd, n, step["precision"], step["masked"],
                              work=(step["pairs"], step["rows"]))[0],
        "rescore": rescore_bound_ms(t, n, kd, kd)[0],
        "decode": decode_bound_ms(step["decode"], t, n, kd,
                                  8 * t + 4 * step["utterances"])[0],
        "ola": ola_bound_ms(step["fragment_samples"], step["out_samples"])[0],
    }

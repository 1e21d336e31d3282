"""Checks of the preselect kernel, shared by ``chip_smoke.py`` and the card
tests (``tests/test_torch_cuda_kernel.py``).

- :func:`compare`: the kernel against its plain twin on the same tensors.
  At a split precision the tolerance on a score grows with the product's
  magnitude (:func:`split_slack`): the tensor cores accumulate in f32 but
  not as IEEE sums (partial sums are aligned and cut, not rounded), so the
  kernel's error is up to one f32 ulp of the running sum per ``mma`` step,
  and a step adds 16 products.  On correlated rows (halfphone targets and
  their own units, all products of one sign) that reaches ~5e-3 on scores
  of ~1e3 at kd 453, where independent rows stay under 5e-4.
- :func:`split_probe_error`: the kernel at a split precision against the
  float64 sum of its three bf16 products, on operands where the products
  the split drops (lo * lo) are 2.7e-6 to 2.5e-5 of each dot product: a
  kernel that splits lies within :data:`PROBE_RTOL`, one that multiplies
  in full f32 (or truncates the split) does not.  Kernel-vs-twin
  tolerances (1e-3 on scores of ~1e2) cannot tell the two apart.

On a CPU tensor :func:`~snickery_tpu_torch.ops.cuda_topk.cuda_topk_preselect`
runs the twin, so both checks also run on the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

from snickery_tpu_torch.const import ID_RANK_PENALTY
from snickery_tpu_torch.ops.cuda_topk import (cuda_topk_preselect, penalty_constants,
                                              split_scores64, topk_preselect_zt_plain)

SCORE_ATOL = 1e-3        # |kernel - plain| on scores of ~1e2: f32 sums of
                         # kd products taken in another order
TIE_RTOL = 1e-5          # a differing id must be an f32 near-tie of the k-th
F32_EPS = float(np.finfo(np.float32).eps)
MMA_DEPTH = 16           # bf16 products an mma.sync m16n8k16 step adds
PROBE_RTOL = 1e-6        # split probe: |score - f64 score| / (2 sum |t| |u|)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def scores64(raw, aff, targets, ids, masks, precision="highest"):
    """Float64 ranking scores of the rows ``ids`` (n, k) for the targets
    (n, kd), penalties and partition included.  At a split precision the
    score both sides round: the float64 sum of the three bf16 products of
    the f32-prescaled targets and the rows."""
    kd = targets.shape[1]
    rows = raw[ids]
    if precision == "highest":
        mean, std, w = (a.double() for a in aff)
        s = rows[..., kd].double() - 2.0 * torch.einsum(
            "bkc,bc->bk", rows[..., :kd].double(), targets.double() * (w / std))
    else:
        s = split_scores64(targets, rows, aff)
    if masks:
        tm, dm = masks["tgt_meta"][:, None, :], masks["db_meta"][ids]
        if masks["partition"]:
            s = torch.where(tm[..., 6] != dm[..., 6], float("inf"), s)
        if masks["ling_weights"] is not None:
            s = s + (tm[..., 0] != dm[..., 0]) * ID_RANK_PENALTY
            for c, p in enumerate(penalty_constants(masks["ling_weights"])):
                s = s + (tm[..., c + 1] != dm[..., c + 1]) * p
    return s


def split_slack(targets, raw, aff, ids, precision) -> torch.Tensor:
    """(n, k) float64 bound of a split kernel's accumulation error on the
    scores of rows ``ids`` (n, k) for targets (n, kd), 0 at "highest":
    one f32 ulp of the running sum for each of the ``ceil(3 kd / 16)`` mma
    steps, the running sum bounded by ``sum_c |t2_c| |u_c|``, times the 2
    of ``- 2 * cross``."""
    if precision == "highest":
        return torch.zeros(ids.shape, dtype=torch.float64, device=ids.device)
    kd = targets.shape[1]
    mean, std, w = aff
    t2 = (targets * (w / std)[None, :]).double().abs()
    mag = torch.einsum("nkc,nc->nk", raw[ids][..., :kd].double().abs(), t2)
    return -(-3 * kd // MMA_DEPTH) * F32_EPS * 2.0 * mag


def compare(targets, raw, aff, m_rows, k, precision="highest", **masks):
    """Kernel vs plain twin on the same card tensors.  Per row: scores
    ascending; the same number of dead slots, each (+inf, 0); id sets
    equal, except where the differing ids are f32 near-ties of the k-th
    score (checked in float64, penalties included, on the three bf16
    products at a split precision), on at most 1% of the rows; scores of
    shared ids within SCORE_ATOL (at a split precision the larger of that
    and :func:`split_slack`) plus one f32 ulp of the score (penalised
    scores sit near 2^24, ulp 2).
    Returns (max_abs_err, rows_with_differing_ids, dead slots)."""
    ik, vk = cuda_topk_preselect(targets, raw, k, aff, m_rows, precision=precision, **masks)
    ip, vp = topk_preselect_zt_plain(targets, raw, k, aff, m_rows, precision=precision,
                                     **masks)
    if vk.is_cuda:
        torch.cuda.synchronize()
    check(bool((ik >= 0).all() and (ik < m_rows).all()), "kernel ids in range")
    check(not bool(torch.isnan(vk).any() or (vk == -float("inf")).any()),
          "kernel scores are finite or +inf")
    check(bool((vk[:, 1:] >= vk[:, :-1]).all()), "kernel scores ascending")
    dead_k, dead_p = torch.isinf(vk), torch.isinf(vp)
    check(torch.equal(dead_k, dead_p), "dead (+inf) slots differ")
    check(bool((ik[dead_k] == 0).all()), "a dead slot must read index 0")
    ik_s, ok = torch.sort(ik.long(), dim=1)
    ip_s, op = torch.sort(ip.long(), dim=1)
    vk_s, vp_s = torch.gather(vk, 1, ok), torch.gather(vp, 1, op)
    same = (ik_s == ip_s).all(dim=1)
    live = same[:, None] & torch.isfinite(vp_s)
    diff = (vk_s - vp_s).abs()[live]
    err = float(diff.max()) if diff.numel() else 0.0
    slack = split_slack(targets, raw, aff, ip_s, precision)
    allowed = torch.clamp(slack[live], min=SCORE_ATOL) + F32_EPS * vp_s.abs()[live]
    check(bool((diff <= allowed).all()),
          f"score error {err} beyond max({SCORE_ATOL}, accumulation bound) + 1 ulp")
    bad = torch.nonzero(~same).flatten()
    if len(bad):
        sub = {}
        if masks:
            sub = dict(masks, tgt_meta=masks["tgt_meta"][bad])

        def worst(ids):
            s = scores64(raw, aff, targets[bad], ids[bad], sub, precision)
            return torch.where(torch.isinf(s), -float("inf"), s).max(1).values

        worst_k, worst_p = worst(ik_s), worst(ip_s)
        row_slack = slack[bad].max(1).values
        gap = float(((worst_k - worst_p - row_slack) / worst_p.abs().clamp(min=1.0)).max())
        check(gap <= TIE_RTOL, f"differing ids are not near-ties (gap {gap})")
        check(len(bad) <= 0.01 * targets.shape[0], f"{len(bad)} rows differ")
    return err, int(len(bad)), int(dead_k.sum())


def split_probe_operands(T: int = 16, n: int = 64, kd: int = 8, seed: int = 5):
    """(targets (T, kd), rows (n, kd)) f32, all positive: each value is a
    bf16-exact power of two times (1 + e), e in 0.95 * 2^-8 * [0.9, 1), so
    hi is the power of two and the lo * lo products the split drops add up
    to 2.7e-6 - 2.5e-5 of each dot product, while the f32 sums of the
    products round to about 1.5e-7."""
    rng = np.random.default_rng(seed)
    hi = 2.0 ** rng.integers(-2, 3, (T + n, kd))
    x = (hi * (1.0 + 0.95 * 2.0 ** -8 * rng.uniform(0.9, 1.0, (T + n, kd))))
    x = torch.from_numpy(x.astype(np.float32))
    return x[:T], x[T:]


def split_probe_error(device, precision: str, k: int = 48) -> float:
    """Largest |score - float64 score| / (2 sum |t| |u|) of the kernel's
    (the twin's on the CPU) k best rows for the probe operands at
    ``precision``, the float64 score being ``-2 (hh + hl + lh)``.  The block
    has sqn 0 and the affine is the identity, so a score is exactly -2
    times the kernel's dot product."""
    t2, rows = (x.to(device) for x in split_probe_operands())
    n, kd = rows.shape
    raw = torch.zeros((n, kd + 2), dtype=torch.float32, device=device)
    raw[:, :kd] = rows
    aff = (torch.zeros(kd, device=device), torch.ones(kd, device=device),
           torch.ones(kd, device=device))
    ids, scores = cuda_topk_preselect(t2, raw, k, aff, n, precision=precision)
    ids = ids.long()
    ref = split_scores64(t2, raw[ids], aff)
    scale = 2.0 * torch.einsum("tnc,tc->tn", rows[ids].double().abs(), t2.double().abs())
    return float(((scores.double() - ref).abs() / scale).max())

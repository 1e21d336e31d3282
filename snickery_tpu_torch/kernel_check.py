"""Checks of the preselect kernel, shared by ``chip_smoke.py`` and the card
tests (``tests/test_torch_cuda_kernel.py``).

- :func:`compare` (and :func:`judge`, the rule alone, for results already
  computed): the kernel against its plain twin on the same tensors,
  in either operand form (the raw block and its affine, or with ``sqn``
  the derived operand of ``cuda_topk.derive_operand``).
  At a split precision the tolerance on a score grows with the product's
  magnitude (:func:`split_slack`): the tensor cores accumulate in f32 but
  not as IEEE sums (partial sums are aligned and cut, not rounded), so the
  kernel's error is up to one f32 ulp of the running sum per ``mma`` step,
  and a step adds 16 products.  On correlated rows (halfphone targets and
  their own units, all products of one sign) that reaches ~5e-3 on scores
  of ~1e3 at kd 453, where independent rows stay under 5e-4.
  With ``select`` the same call compares a selection form: "phase" by the
  rules of "stream"; the packed forms with :func:`packed_slack` added, 127
  ulp of the ranked score (their keys drop 7 bits of it), and for
  "packed3diag" the overflow flags too.
- :data:`EDGE_CASES` and :func:`run_edge_case`: the kernel against its twin
  at the edges of its tiles (target and DB row counts that are no multiples
  of a tile, one DB split and several, kd 453 with its narrower target tile,
  k = 64) and of its screened epilogue (scores that fall with the row index,
  so that every score passes the screen and the queue overflows on every
  tile; scores that rise, so that nothing passes after the first k rows;
  bit-identical rows; a partition that starves a voice).
- :func:`pileup_block`: a run of near-duplicate rows inside one 128-row
  block, and targets that sit on them: more than three rows of one block
  in a target's top-k, the case that makes "packed3" raise its flag.
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
from snickery_tpu_torch.ops.cuda_topk import (BLOCK_ROWS, MAX_K, _prescale,
                                              cuda_topk_preselect, derive_operand, pack_meta,
                                              penalty_constants, presplit_halves,
                                              split_cross64, split_scores64,
                                              topk_preselect_dv_plain,
                                              topk_preselect_zt_plain)

SCORE_ATOL = 1e-3        # |kernel - plain| on scores of ~1e2: f32 sums of
                         # kd products taken in another order
TIE_RTOL = 1e-5          # a differing id must be an f32 near-tie of the k-th
F32_EPS = float(np.finfo(np.float32).eps)
MMA_DEPTH = 16           # bf16 products a wgmma m64nNk16 step adds
PROBE_RTOL = 1e-6        # split probe: |score - f64 score| / (2 sum |t| |u|)
PACKED_ULPS = BLOCK_ROWS - 1   # a packed key replaces the score's low 7 bits
FLAG_ROWS = 0.01         # split precision: share of targets whose packed3 flags
                         # may differ (a third key within rounding of the worst)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def _derived_rows(operand, targets, ids):
    """The DB rows ``ids`` (n, k) of a derived operand as f32, (n, k, kd),
    or as their (hi, lo) halves if it is pre-split."""
    rows = operand[ids]
    if rows.dtype == torch.bfloat16:
        return presplit_halves(rows, targets.shape[1])
    return rows


def scores64(raw, aff, targets, ids, masks, precision="highest", sqn=None):
    """Float64 ranking scores of the rows ``ids`` (n, k) for the targets
    (n, kd), penalties and partition included.  At a split precision the
    score both sides round: the float64 sum of the three bf16 products of
    the f32-prescaled targets and the rows.  With ``sqn``, ``raw`` is a
    derived operand and ``targets`` multiply it as they are."""
    kd = targets.shape[1]
    if sqn is not None:
        rows = _derived_rows(raw, targets, ids)
        if precision == "highest":
            cross = torch.einsum("bkc,bc->bk", rows.double(), targets.double())
        else:
            cross = split_cross64(targets, rows)
        s = sqn[ids].double() - 2.0 * cross
    elif precision == "highest":
        rows = raw[ids]
        mean, std, w = (a.double() for a in aff)
        s = rows[..., kd].double() - 2.0 * torch.einsum(
            "bkc,bc->bk", rows[..., :kd].double(), targets.double() * (w / std))
    else:
        s = split_scores64(targets, raw[ids], aff)
    if masks:
        tm, dm = masks["tgt_meta"][:, None, :], masks["db_meta"][ids]
        if masks["partition"]:
            s = torch.where(tm[..., 6] != dm[..., 6], float("inf"), s)
        if masks["ling_weights"] is not None:
            s = s + (tm[..., 0] != dm[..., 0]) * ID_RANK_PENALTY
            for c, p in enumerate(penalty_constants(masks["ling_weights"])):
                s = s + (tm[..., c + 1] != dm[..., c + 1]) * p
    return s


def split_slack(targets, raw, aff, ids, precision, sqn=None) -> torch.Tensor:
    """(n, k) float64 bound of a split kernel's accumulation error on the
    scores of rows ``ids`` (n, k) for targets (n, kd), 0 at "highest":
    one f32 ulp of the running sum for each of the ``ceil(3 kd / 16)`` mma
    steps, the running sum bounded by ``sum_c |t2_c| |u_c|``, times the 2
    of ``- 2 * cross`` (``sqn`` given: a derived operand, as in
    :func:`scores64`)."""
    if precision == "highest":
        return torch.zeros(ids.shape, dtype=torch.float64, device=ids.device)
    kd = targets.shape[1]
    if sqn is not None:
        rows = _derived_rows(raw, targets, ids)
        u = rows[0] + rows[1] if isinstance(rows, tuple) else rows
        t2 = targets.double().abs()
    else:
        mean, std, w = aff
        u = raw[ids][..., :kd]
        t2 = (targets * (w / std)[None, :]).double().abs()
    mag = torch.einsum("nkc,nc->nk", u.double().abs(), t2)
    return -(-3 * kd // MMA_DEPTH) * F32_EPS * 2.0 * mag


def packed_slack(vals, targets, aff, select) -> torch.Tensor:
    """(n, k) float64: how far a packed selection may move a returned score
    ``vals`` (n, k) from the one it ranked, 0 at "stream" and "phase":
    :data:`PACKED_ULPS` f32 ulps of the score before ``comp`` was added
    (``aff`` given: the zero-transient form, whose ``comp`` is taken off)."""
    if select in ("stream", "phase"):
        return torch.zeros(vals.shape, dtype=torch.float64, device=vals.device)
    s = vals.double()
    if aff is not None:
        s = s - _prescale(targets, aff)[1].double()[:, None]
    return PACKED_ULPS * F32_EPS * torch.where(torch.isfinite(s), s.abs(), 0.0)


def pileup_block(feats, targets, aff=None, start: int = 512, run: int = 10,
                 n_targets: int = 16, seed: int = 0):
    """Plant, in place, ``run`` near-duplicate rows ``base + 1e-3 i`` at
    feature rows ``start ..`` (all inside one 128-row block) of ``feats``
    (M, kd) numpy, and put the first ``n_targets`` rows of ``targets`` on
    ``base + 1e-4``: in the rows' own space, or normalised and weighted by
    ``aff = (mean, std, sqrt_w)`` where ``feats`` are raw.  Those targets
    then hold ``run`` rows of one block at the top of their list."""
    if start // BLOCK_ROWS != (start + run - 1) // BLOCK_ROWS:
        raise ValueError("the run must lie inside one 128-row block")
    base = np.random.default_rng(seed).standard_normal(feats.shape[1]).astype(np.float32)
    feats[start:start + run] = base + np.float32(1e-3) * np.arange(run, dtype=np.float32)[:, None]
    hit = base + np.float32(1e-4)
    if aff is not None:
        mean, std, w = aff
        hit = (hit - mean) / std * w
    targets[:n_targets] = hit


def compare(targets, raw, aff, m_rows, k, precision="highest", sqn=None, n_real=None,
            select="stream", **masks):
    """Kernel vs plain twin on the same card tensors, in the zero-transient
    form (``raw`` the raw block, ``aff`` its affine) or, with ``sqn``, the
    derived one (``raw`` the operand, ``aff`` None), at the selection
    ``select``: both are run and :func:`judge` holds the kernel's result to
    the twin's.  Returns (max_abs_err, rows_with_differing_ids, dead slots)."""
    got = cuda_topk_preselect(targets, raw, k, aff, m_rows, precision=precision,
                              zero_transient=sqn is None, sqn=sqn, select=select, **masks)
    if sqn is None:
        want = topk_preselect_zt_plain(targets, raw, k, aff, m_rows, precision=precision,
                                       select=select, **masks)
    else:
        want = topk_preselect_dv_plain(targets, raw, sqn, k, m_rows, precision=precision,
                                       select=select, **masks)
    return judge(got, want, targets, raw, aff, m_rows, precision, sqn=sqn, n_real=n_real,
                 select=select, **masks)


def judge(got, want, targets, raw, aff, m_rows, precision="highest", sqn=None, n_real=None,
          select="stream", **masks):
    """Hold a kernel's result ``got`` to the twin's ``want`` (each (ids,
    scores) or, at "packed3diag", (ids, scores, flags)) for the inputs of
    :func:`compare`; with ``n_real``, no live slot of the kernel may hold a
    padding row.  Per row: scores ascending; the same number of dead slots,
    each (+inf, 0); id sets equal, except where the differing ids are f32
    near-ties of the k-th score (checked in float64, penalties included, on
    the three bf16 products at a split precision), on at most 1% of the
    rows (at "packed3diag": of the rows neither side flags); scores of shared ids within SCORE_ATOL (at a split precision the
    larger of that and :func:`split_slack`) plus one f32 ulp of the score
    (penalised scores sit near 2^24, ulp 2) plus :func:`packed_slack`.  At
    "packed3diag" the flags are equal at "highest" and differ on at most
    :data:`FLAG_ROWS` of the targets at a split precision.
    Returns (max_abs_err, rows_with_differing_ids, dead slots)."""
    (ik, vk, *fk), (ip, vp, *fp) = got, want
    if vk.is_cuda:
        torch.cuda.synchronize()
    if fk:
        n_diff = int((fk[0] != fp[0]).sum())
        check(n_diff <= (0 if precision == "highest" else FLAG_ROWS * targets.shape[0]),
              f"packed3 overflow flags differ on {n_diff} targets")
    check(bool((ik >= 0).all() and (ik < m_rows).all()), "kernel ids in range")
    if n_real is not None:
        check(bool((ik[torch.isfinite(vk)] < n_real).all()), "a padding row was selected")
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
    slack = split_slack(targets, raw, aff, ip_s, precision, sqn)
    packed = packed_slack(vp_s, targets, aff if sqn is None else None, select)
    allowed = (torch.clamp(slack[live], min=SCORE_ATOL) + F32_EPS * vp_s.abs()[live]
               + packed[live])
    check(bool((diff <= allowed).all()),
          f"score error {err} beyond max({SCORE_ATOL}, accumulation bound) + 1 ulp"
          + ("" if select in ("stream", "phase") else f" + {PACKED_ULPS} ulp"))
    bad = torch.nonzero(~same).flatten()
    if len(bad):
        sub = {}
        if masks:
            sub = dict(masks, tgt_meta=masks["tgt_meta"][bad])

        def worst(ids):
            s = scores64(raw, aff, targets[bad], ids[bad], sub, precision, sqn)
            return torch.where(torch.isinf(s), -float("inf"), s).max(1).values

        worst_k, worst_p = worst(ik_s), worst(ip_s)
        row_slack = (slack + packed)[bad].max(1).values
        gap = float(((worst_k - worst_p - row_slack) / worst_p.abs().clamp(min=1.0)).max())
        check(gap <= TIE_RTOL, f"differing ids are not near-ties (gap {gap})")
        # a flagged packed3 column is the one "packed3" throws away, and it has
        # a near-tie boundary in every crowded block, not only at rank k: the
        # 1% rule counts the columns that neither side flags
        counted = bad[(fk[0][bad] == 0) & (fp[0][bad] == 0)] if fk else bad
        check(len(counted) <= 0.01 * targets.shape[0], f"{len(counted)} rows differ")
    return err, int(len(bad)), int(dead_k.sum())


# name: (T, m_rows, kd, k or None for the precision's own, what is special)
EDGE_CASES = {
    "ragged": (300, 8229, 151, None, None),          # one DB split, partial tiles
    "ragged_splits": (300, 65573, 151, None, None),  # several, the last one partial
    "kd453_k64": (300, 8229, 453, MAX_K, None),      # the narrower target tile
    "falling": (300, 8229, 151, None, "falling"),    # every score passes the screen
    "falling_splits": (200, 33000, 151, None, "falling"),
    "rising": (300, 8229, 151, None, "rising"),      # none after the first k rows
    "identical": (300, 8229, 151, None, "identical"),   # the lowest k rows must win
    "starved": (300, 8229, 151, None, "starved"),    # a voice of k // 2 rows, one of none
}
EDGE_K = {"highest": 40, "split3": 40, "split3cat": 48}


def run_edge_case(name: str, device, precision: str = "highest", zero_transient: bool = True,
                  seed: int = 0):
    """One of :data:`EDGE_CASES` through :func:`compare`, in either operand
    form.  "falling" / "rising": rows of small features whose squared norm
    is set to ``m_rows - u`` / ``u + 1``, so that for every target the score
    falls / rises with the row index u (the products stay below the step of
    1 between neighbours).  "identical": every row a copy of one, so all
    scores of a target tie and rows 0 .. k - 1 must come back, in order.
    "starved": the partition mask with a voice of k // 2 rows and one of
    none.  Returns what :func:`compare` returns."""
    from snickery_tpu_torch.voicedb.device_layout import build_raw_blocks
    T, M, kd, k, special = EDGE_CASES[name]
    k = k or EDGE_K[precision]
    rng = np.random.default_rng(seed + T + M + kd)
    feats = rng.standard_normal((M, kd), dtype=np.float32)
    if special in ("falling", "rising"):
        feats *= np.float32(0.002)
    elif special == "identical":
        feats[:] = feats[0]
    aff = ((0.1 * rng.standard_normal(kd)).astype(np.float32),
           rng.uniform(0.5, 2.0, kd).astype(np.float32),
           rng.uniform(0.2, 1.0, kd).astype(np.float32))
    jr = np.zeros_like(feats)
    jr[:-1] = feats[1:]
    raw = torch.from_numpy(build_raw_blocks(feats, jr, M, affine=aff)[0]).to(device)
    aff = tuple(torch.from_numpy(a).to(device) for a in aff)
    tg = torch.from_numpy(rng.standard_normal((T, kd), dtype=np.float32)).to(device)
    ramp = None
    if special == "falling":
        ramp = torch.arange(M, 0, -1, device=device, dtype=torch.float32)
    elif special == "rising":
        ramp = torch.arange(1, M + 1, device=device, dtype=torch.float32)
    masks = {}
    if special == "starved":
        tv = rng.integers(0, 7, T).astype(np.int32)
        tv[16:48], tv[48:56] = 7, 9
        dv = rng.integers(0, 7, M).astype(np.int32)
        dv[rng.choice(M, k // 2, replace=False)] = 7
        zeros = lambda n: torch.zeros(n, dtype=torch.int32, device=device)
        masks = dict(
            tgt_meta=pack_meta(zeros(T), zeros((T, 5)), torch.from_numpy(tv).to(device)),
            db_meta=pack_meta(zeros(M), zeros((M, 5)), torch.from_numpy(dv).to(device)),
            partition=True, ling_weights=None)
    if zero_transient:
        if ramp is not None:
            raw[:M, kd] = ramp
        args, kw = (tg, raw, aff, M, k, precision), {}
    else:
        op, sqn = derive_operand(raw, aff, M, M, precision)
        args, kw = (tg, op, None, M, k, precision), dict(sqn=sqn if ramp is None else ramp)
    out = compare(*args, **kw, **masks)
    if special == "identical":
        ids = cuda_topk_preselect(args[0], args[1], k, args[2], M, precision=precision,
                                  zero_transient=zero_transient, sqn=kw.get("sqn"))[0]
        check(bool((ids == torch.arange(k, device=ids.device)[None, :]).all()),
              "bit-identical rows: the lowest k indices must win, in order")
    if special == "starved":
        check(out[2] == 32 * (k - k // 2) + 8 * k, f"starved slots missing ({out[2]})")
    return out


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


def split_probe_error(device, precision: str, k: int = 48, select: str = "stream") -> float:
    """Largest |score - float64 score| / (2 sum |t| |u|) of the kernel's
    (the twin's on the CPU) k best rows for the probe operands at
    ``precision``, the float64 score being ``-2 (hh + hl + lh)``.  The block
    has sqn 0 and the affine is the identity, so a score is exactly -2
    times the kernel's dot product.  ``select``: "stream" or "phase", the
    selections that return the scores they ranked."""
    t2, rows = (x.to(device) for x in split_probe_operands())
    n, kd = rows.shape
    raw = torch.zeros((n, kd + 2), dtype=torch.float32, device=device)
    raw[:, :kd] = rows
    aff = (torch.zeros(kd, device=device), torch.ones(kd, device=device),
           torch.ones(kd, device=device))
    ids, scores = cuda_topk_preselect(t2, raw, k, aff, n, precision=precision, select=select)
    ids = ids.long()
    ref = split_scores64(t2, raw[ids], aff)
    scale = 2.0 * torch.einsum("tnc,tc->tn", rows[ids].double().abs(), t2.double().abs())
    return float(((scores.double() - ref).abs() / scale).max())

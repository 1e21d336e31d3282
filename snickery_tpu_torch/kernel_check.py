"""Checks of the preselect kernel and the decode kernels, shared by
``chip_smoke.py`` and the card tests (``tests/test_torch_cuda_kernel.py``,
``tests/test_torch_cuda_decode.py``).

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
  k = 64, kd 302 of multiepoch=2 units) and of its screened epilogue (scores that fall with the row index,
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
- :data:`DECODE_CASES`, :func:`run_decode_case` and :func:`judge_decode`:
  the decode kernels (``ops/viterbi.py``) against their plain versions on
  lattices made from a seed (ragged lengths with junk past them, a natural
  chain that must cost exactly 0.0, exact ties, epsilon pruning, shapes
  whose shared-memory plan holds one producer group or keeps its
  backpointers in device memory, one long utterance, more utterances than
  SMs, stream chunks), each also at every forced cluster size of
  :data:`DECODE_CLUSTERS`; :func:`decode_bound_ms` their bound.
- The yardsticks a report puts beside a kernel's time: :func:`time_ms`
  (CUDA events on a card, the host clock on the CPU), :func:`bound_ms`
  (the least time the card could take for the call, from its published
  peaks; :func:`partition_work` for the partition mask) and
  :func:`matmul_ms` (``torch.matmul`` of the product alone).

On a CPU tensor :func:`~snickery_tpu_torch.ops.cuda_topk.cuda_topk_preselect`
runs the twin, so both checks also run on the CPU.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from snickery_tpu_torch.const import ID_RANK_PENALTY
from snickery_tpu_torch.ops.cuda_topk import (BLOCK_ROWS, MAX_K, _prescale,
                                              cuda_topk_preselect, derive_operand, pack_meta,
                                              penalty_constants, presplit_halves, split_bf16,
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
# the card's published peaks (H100 SXM data sheet, dense, at 700 W): FP32
# outside the tensor cores for "highest", bf16 tensor cores for the splits
PEAK_FLOPS = {"highest": 67e12, "split3": 989e12, "split3cat": 989e12}
HBM_BYTES_PER_S = 3.35e12


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
          select="stream", max_differ=0.01, **masks):
    """Hold a kernel's result ``got`` to the twin's ``want`` (each (ids,
    scores) or, at "packed3diag", (ids, scores, flags)) for the inputs of
    :func:`compare`; with ``n_real``, no live slot of the kernel may hold a
    padding row.  Per row: scores ascending; the same number of dead slots,
    each (+inf, 0); id sets equal, except where the differing ids are f32
    near-ties of the k-th score (checked in float64, penalties included, on
    the three bf16 products at a split precision), on at most ``max_differ``
    (1%) of the rows (at "packed3diag": of the rows neither side flags); scores of shared ids within SCORE_ATOL (at a split precision the
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
        check(len(counted) <= max_differ * targets.shape[0], f"{len(counted)} rows differ")
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
    "kd302_me2": (300, 8229, 302, None, None),       # multiepoch=2 units: kd 2 x 151
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


def time_ms(fn, reps: int, device="cuda") -> float:
    """Mean ms of ``reps`` calls of ``fn`` after one warm-up call: CUDA
    events around the calls on a card (the device's time from the first
    call's start to the last one's end), the host clock on the CPU."""
    fn()
    if torch.device(device).type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return 1e3 * (time.perf_counter() - t0) / reps
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def bound_ms(T: int, m_rows: int, kd: int, k: int, precision: str, masked: bool,
             row_bytes: float | None = None, work: tuple | None = None):
    """(least time in ms, "operations" or "bytes") the card could take for
    one preselect call: 2 kd FLOP per (target, DB row) product, T m_rows of
    them (three bf16 products at a split precision), at the peak rate of its
    type, against the bytes the call must move (targets; each DB row's data
    and its sqn, ``row_bytes`` a row, by default 4 (kd + 1): the raw block's
    data and sqn columns or the derived f32 operand and its sqn; the
    metadata rows when masked; each read once; the (T, k) scores and ids
    written once) at HBM bandwidth.  ``work`` = (products, DB rows) where
    the data needs fewer (:func:`partition_work`).  The mask compares are
    integer work beside the kd products of each score and are not counted."""
    pairs, rows = work or (T * m_rows, m_rows)
    flops = 2.0 * pairs * kd * (1 if precision == "highest" else 3)
    if row_bytes is None:
        row_bytes = 4.0 * (kd + 1)
    nbytes = 4.0 * (T * kd + 2 * T * k) + rows * row_bytes
    if masked:
        nbytes += 32.0 * (T + rows)
    t_ops, t_bytes = flops / PEAK_FLOPS[precision], nbytes / HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def partition_work(masks: dict, m_rows: int) -> tuple | None:
    """(products, DB rows) a partition-masked call needs, from its masks:
    each target against the rows of its own voice id (a dead step, id -1,
    against the padding rows), and the rows of the voices its targets
    have; None without the partition mask (every target against every
    row)."""
    if not masks.get("partition"):
        return None
    dv = masks["db_meta"][:m_rows, 6].long()
    ids, counts = torch.unique(dv, return_counts=True)
    per_voice = dict(zip(ids.tolist(), counts.tolist()))
    tid, tcount = torch.unique(masks["tgt_meta"][:, 6].long(), return_counts=True)
    pairs = sum(c * per_voice.get(v, 0) for v, c in zip(tid.tolist(), tcount.tolist()))
    return pairs, sum(per_voice.get(v, 0) for v in tid.tolist())


def matmul_ms(x, rows, precision: str) -> float:
    """Device time of the product alone, ``x @ rows.T`` for targets x (T, kd)
    and DB rows (m, kd), as torch.matmul computes it at the same precision:
    f32 (no TF32) at "highest"; at a split precision bf16 operands with f32
    accumulation, one matmul over the 3 kd pairs (split3cat) or three
    (split3); bf16 ``rows`` are a pre-split operand (m, 2 kp) whose halves
    are used as they are.  Chunked over the DB so each output stays within
    1 GiB.  A yardstick only: no PyTorch call fuses the product with an
    exact top-k, and the port never calls this."""
    T, kd = x.shape
    step = max(64, (1 << 28) // T)
    if precision == "highest":
        pairs = [(x, rows)]
    else:
        bf = torch.bfloat16
        th, tl = (a.to(bf) for a in split_bf16(x))
        if rows.dtype == bf:
            kp = rows.shape[1] // 2
            rh, rl = rows[:, :kd].contiguous(), rows[:, kp:kp + kd].contiguous()
        else:
            rh, rl = (a.to(bf) for a in split_bf16(rows.contiguous()))
        if precision == "split3cat":
            pairs = [(torch.cat([th, tl, th], 1), torch.cat([rh, rh, rl], 1))]
        else:
            pairs = [(th, rh), (tl, rh), (th, rl)]

    def run():
        for lo in range(0, rows.shape[0], step):
            for a, b in pairs:
                torch.matmul(a, b[lo:lo + step].T)

    ms = time_ms(run, 1, x.device)
    del pairs
    return ms


# ------------------------------------------------------------------ decodes
DECODE_RTOL = 1e-5       # totals, kernel vs plain: f32 sums of the same terms,
                         # each join distance summed in another order
PATH_RTOL = 1e-6         # a differing path may cost no more than this in float64
DECODE_JCW = 0.7
# name: (kind, B, T, N, dj, lengths, eps, squared, special); lengths "full"
# (all T), "ragged" (T, 1, 0 and others, repeated past six utterances, junk
# in the padded steps), "one" (1 each), "none" (a stream chunk with no live
# step)
DECODE_CASES = {
    "viterbi_full": ("viterbi", 3, 128, 30, 151, "full", 0.0, False, None),
    "viterbi_ragged": ("viterbi", 6, 160, 30, 151, "ragged", 0.0, False, None),
    "viterbi_one": ("viterbi", 3, 64, 30, 151, "one", 0.0, False, None),
    "viterbi_n1": ("viterbi", 3, 50, 1, 151, "ragged", 0.0, False, None),
    "viterbi_n20_dj302": ("viterbi", 4, 128, 20, 302, "ragged", 0.0, False, None),
    "viterbi_natural": ("viterbi", 4, 200, 30, 151, "ragged", 0.0, False, "natural"),
    "viterbi_eps_bites": ("viterbi", 4, 200, 30, 151, "ragged", 0.3, False, None),
    "viterbi_eps_huge": ("viterbi", 4, 200, 30, 151, "ragged", 1e9, False, None),
    "viterbi_squared": ("viterbi", 4, 200, 30, 151, "ragged", 0.0, True, None),
    "viterbi_ties": ("viterbi", 4, 200, 30, 151, "ragged", 0.3, False, "ties"),
    "viterbi_bp_global": ("viterbi", 2, 8200, 30, 151, "ragged", 0.0, False, None),
    "viterbi_single_buffer": ("viterbi", 2, 96, 64, 302, "ragged", 0.3, True, None),
    "viterbi_single_650": ("viterbi", 1, 650, 30, 151, "full", 0.0, False, None),
    "viterbi_b160": ("viterbi", 160, 64, 30, 151, "ragged", 0.0, False, None),
    "viterbi_n33": ("viterbi", 4, 128, 33, 151, "ragged", 0.0, False, None),
    "viterbi_n33_ties_eps": ("viterbi", 6, 160, 33, 151, "ragged", 0.25, False, "ties"),
    "greedy_full": ("greedy", 3, 128, 30, 151, "full", 0.0, False, None),
    "greedy_ragged": ("greedy", 6, 160, 30, 151, "ragged", 0.0, False, None),
    "greedy_n1": ("greedy", 3, 50, 1, 151, "ragged", 0.0, False, None),
    "greedy_n20_dj302_squared": ("greedy", 4, 128, 20, 302, "ragged", 0.0, True, None),
    "greedy_natural": ("greedy", 4, 200, 30, 151, "ragged", 0.0, False, "natural"),
    "greedy_ties": ("greedy", 4, 200, 30, 151, "ragged", 0.0, False, "ties"),
    "greedy_single_buffer": ("greedy", 2, 96, 64, 302, "ragged", 0.0, False, None),
    "greedy_b160": ("greedy", 160, 64, 30, 151, "ragged", 0.0, False, None),
    "greedy_n33": ("greedy", 4, 128, 33, 151, "ragged", 0.0, False, None),
    "stream_start": ("stream", 1, 64, 30, 151, "full", 0.0, False, "start"),
    "stream_carry": ("stream", 1, 64, 30, 151, "ragged", 0.0, False, None),
    "stream_carry_dj302": ("stream", 1, 64, 20, 302, "full", 0.0, True, None),
    "stream_ties": ("stream", 1, 64, 30, 151, "full", 0.0, False, "ties"),
    "stream_empty": ("stream", 1, 64, 30, 151, "none", 0.0, False, None),
}


def decode_lattice(name: str, device, seed: int = 0) -> dict:
    """The lattice of one of :data:`DECODE_CASES`, made with numpy from
    ``seed``: target costs uniform in [0, 5), contexts N(0, 0.3^2) (join
    distances of a few units at dj 151), and per case: ragged lengths with
    junk (costs 123, contexts 9 / -7) in the padded steps; "natural": a
    chain of random states whose contexts join bit-equal and whose target
    costs are 0, every other target cost at least 1, so the best path is
    the chain at a total of exactly 0.0; "ties": every odd state a copy of
    the even one before it, so every decision ties and only even states may
    be chosen (the lowest index wins); a stream chunk's incoming context
    (zeros at the start of a stream, with ``jcw_first`` 0).  Returns the
    tensors on ``device`` and the call's keywords."""
    kind, B, T, N, dj, lens, eps, squared, special = DECODE_CASES[name]
    rng = np.random.default_rng(seed + 1000 * T + N + dj)
    tc = rng.uniform(0.0, 5.0, (B, T, N)).astype(np.float32)
    jl = (0.3 * rng.standard_normal((B, T, N, dj))).astype(np.float32)
    jr = (0.3 * rng.standard_normal((B, T, N, dj))).astype(np.float32)
    if lens == "full":
        length = np.full(B, T)
    elif lens == "one":
        length = np.ones(B, np.int64)
    elif lens == "none":
        length = np.zeros(B, np.int64)
    else:
        length = np.resize([T, 1, 0, T // 2 + 7, T - 1, 2], B) if B > 2 else \
            np.asarray([T - 3, T // 3])
    nat = None
    if special == "natural":
        tc += 1.0
        nat = rng.integers(0, N, (B, T))
        for b in range(B):
            tc[b, np.arange(T), nat[b]] = 0.0
            jl[b, np.arange(1, T), nat[b, 1:]] = jr[b, np.arange(T - 1), nat[b, :-1]]
    if special == "ties":
        tc[..., 1::2] = tc[..., 0:N - N % 2:2]
        jl[..., 1::2, :] = jl[..., 0:N - N % 2:2, :]
        jr[..., 1::2, :] = jr[..., 0:N - N % 2:2, :]
    for b in range(B):
        tc[b, length[b]:] = 123.0
        jl[b, length[b]:] = 9.0
        jr[b, length[b]:] = -7.0
    put = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(device)
    out = dict(kind=kind, tc=put(tc), jl=put(jl), jr=put(jr), length=put(length.astype(np.int64)),
               jcw=DECODE_JCW, eps=eps, squared=squared, special=special, nat=nat)
    if kind == "stream":
        start = special == "start"
        ctx = np.zeros(dj, np.float32) if start else (0.3 * rng.standard_normal(dj)).astype(
            np.float32)
        out.update(tc=out["tc"][0], jl=out["jl"][0], jr=out["jr"][0], init_ctx=put(ctx),
                   jcw_first=0.0 if start else DECODE_JCW, n_live=int(length[0]))
    return out


def run_decode(lat: dict, plain: bool = False, cluster: int | None = None):
    """One decode of a :func:`decode_lattice` lattice: through the public
    wrapper (the kernel on a card; ``cluster`` forces its cluster size), or
    with ``plain`` its plain version."""
    from snickery_tpu_torch.ops import viterbi as vit
    kind = lat["kind"]
    kw = {"squared_joins": lat["squared"]}
    if cluster is not None:
        kw["_cluster"] = cluster
    if kind == "stream":
        fn = vit.greedy_decode_stream_plain if plain else vit.greedy_decode_stream
        return fn(lat["tc"], lat["jl"], lat["jr"], lat["init_ctx"], lat["jcw_first"],
                  lat["jcw"], lat["n_live"], **kw)
    if kind == "viterbi":
        fn = vit.viterbi_decode_plain if plain else vit.viterbi_decode
        return fn(lat["tc"], lat["jl"], lat["jr"], lat["jcw"], lat["eps"], lat["length"], **kw)
    fn = vit.greedy_decode_plain if plain else vit.greedy_decode
    return fn(lat["tc"], lat["jl"], lat["jr"], lat["jcw"], lat["length"], **kw)


def _dist64(a, b, squared: bool) -> torch.Tensor:
    sq = ((a.double() - b.double()) ** 2).sum(-1)
    return sq if squared else sq.sqrt()


def path_cost64(tc, jl, jr, path, n: int, squared: bool, jcw: float,
                init_ctx=None, jcw_first: float = 0.0) -> float:
    """float64 cost of a path over the first ``n`` steps of one lattice
    (tc (T, N), contexts (T, N, dj)): its target costs and ``jcw`` times its
    join distances (from ``init_ctx`` at the first step, weighted by
    ``jcw_first``, where there is one)."""
    if n <= 0:
        return 0.0
    s = path[:n].long()
    steps = torch.arange(n, device=tc.device)
    cost = float(tc[steps, s].double().sum())
    if n > 1:
        d = _dist64(jr[steps[:-1], s[:-1]], jl[steps[1:], s[1:]], squared)
        cost += jcw * float(d.sum())
    if init_ctx is not None:
        cost += jcw_first * float(_dist64(init_ctx, jl[0, s[0]], squared))
    return cost


def _greedy_tie(tc, jl, jr, pk, pp, n, squared, jcw, init_ctx=None, jcw_first=0.0) -> None:
    """Two greedy paths that differ: at the first step where they do, both
    choices follow the same context, and the kernel's must cost no more
    there in float64 than the plain version's (an f32 near-tie)."""
    t = int(torch.nonzero(pk[:n] != pp[:n])[0, 0])
    if t == 0 and init_ctx is None:
        ctx, w = None, 0.0
    elif t == 0:
        ctx, w = init_ctx, jcw_first
    else:
        ctx, w = jr[t - 1, pk[t - 1]], jcw

    def step_cost(s):
        c = float(tc[t, s].double())
        return c if ctx is None else c + w * float(_dist64(ctx, jl[t, s], squared))
    ck, cp = step_cost(pk[t]), step_cost(pp[t])
    check(ck <= cp + PATH_RTOL * max(abs(cp), 1.0),
          f"greedy step {t}: the kernel's choice costs {ck}, the plain version's {cp}")


def judge_decode(lat: dict, got, want) -> tuple[float, int]:
    """A decode against its plain version on the same lattice: paths equal,
    or (an f32 near-tie) the kernel's no dearer in float64 (Viterbi: the
    whole path, to :data:`PATH_RTOL`; greedy: the first differing
    choice); totals to :data:`DECODE_RTOL` (a greedy pair after a tie
    excepted); a stream's outgoing context equal; the rules of the
    "natural" and "ties" cases.  Returns (max |total or context
    difference|, utterances whose paths differ)."""
    kind, squared = lat["kind"], lat["squared"]
    (pk, vk), (pp, vp) = got, want
    check(pk.dtype == torch.int64 and pk.shape == pp.shape, f"paths {pk.dtype} {tuple(pk.shape)}")
    if kind == "stream":
        n = lat["n_live"]
        check(bool((pk[n:] == 0).all()), "a stream path is not 0 past n_live")
        if torch.equal(pk, pp):
            check(torch.equal(vk, vp), "equal paths left different outgoing contexts")
            n_diff = 0
        else:
            _greedy_tie(lat["tc"], lat["jl"], lat["jr"], pk, pp, n, squared, lat["jcw"],
                        lat["init_ctx"], lat["jcw_first"])
            n_diff = 1
        if lat["special"] == "ties":
            check(bool((pk % 2 == 0).all()), "a tie went to the higher index")
        return float((vk - vp).abs().max()), n_diff
    B, T = pk.shape
    lens = lat["length"].clamp(0, T).tolist()
    err, n_diff = 0.0, 0
    for b in range(B):
        n = lens[b]
        check(bool((pk[b, max(n, 1):] == 0).all()), f"utterance {b}: path not 0 past {n}")
        tk, tp = float(vk[b]), float(vp[b])
        same = torch.equal(pk[b], pp[b])
        if not same:
            n_diff += 1
            args = (lat["tc"][b], lat["jl"][b], lat["jr"][b])
            if kind == "viterbi":
                ck = path_cost64(*args, pk[b], n, squared, lat["jcw"])
                cp = path_cost64(*args, pp[b], n, squared, lat["jcw"])
                check(ck <= cp * (1 + PATH_RTOL) + 1e-12,
                      f"utterance {b}: the kernel's path costs {ck} in float64, the plain {cp}")
            else:
                _greedy_tie(*args, pk[b], pp[b], n, squared, lat["jcw"])
        if same or kind == "viterbi":
            check(abs(tk - tp) <= DECODE_RTOL * abs(tp),
                  f"utterance {b}: totals {tk} vs {tp} (paths equal: {same})")
            err = max(err, abs(tk - tp))
        if lat.get("special") == "natural" and n > 0 and kind == "viterbi":
            check(tk == 0.0 and tp == 0.0, f"utterance {b}: natural joins cost {tk} / {tp}")
            check(bool((pk[b, :n].cpu() == torch.from_numpy(lat["nat"][b, :n])).all()),
                  f"utterance {b}: the natural chain was not chosen")
        if lat.get("special") == "ties":
            check(bool((pk[b] % 2 == 0).all()), f"utterance {b}: a tie went to the higher index")
    return err, n_diff


DECODE_CLUSTERS = (1, 2, 4, 8)   # the cluster sizes every case is forced to on a card


def run_decode_case(name: str, device, clusters=()) -> tuple[float, int]:
    """One of :data:`DECODE_CASES`: the public wrapper (the kernel on a card)
    twice, bit-identical, and against the plain version (:func:`judge_decode`);
    then at each forced cluster size of ``clusters``, bit-identical to the
    default plan's result.  Returns what :func:`judge_decode` returns."""
    lat = decode_lattice(name, device)
    got = run_decode(lat)
    again = run_decode(lat)
    check(all(torch.equal(a, b) for a, b in zip(got, again)),
          f"{name}: two runs of the decode differ")
    judged = judge_decode(lat, got, run_decode(lat, plain=True))
    for c in clusters:
        forced = run_decode(lat, cluster=c)
        check(all(torch.equal(a, b) for a, b in zip(got, forced)),
              f"{name}: the decode at cluster size {c} differs from the default plan's")
    return judged


def decode_bound_ms(kind: str, live_steps: int, n: int, dj: int, out_bytes: int):
    """(least time in ms, "operations" or "bytes") the card could take for
    a decode over ``live_steps`` lattice steps in all (the steps the data
    needs: each utterance's live ones) of N = ``n`` candidates: the Viterbi
    reads each step's target costs and both contexts, (2 dj + 1) N f32, and
    does N^2 dj subtractions, multiplications and additions; a greedy step
    needs its N target costs and left contexts and one right context,
    (dj + 1) N + dj f32, and N dj of each; ``out_bytes`` written (paths and
    totals or the outgoing context).  FP32 work at the CUDA cores' peak."""
    if kind == "viterbi":
        nbytes, flops = 4.0 * live_steps * n * (2 * dj + 1), 3.0 * live_steps * n * n * dj
    else:
        nbytes, flops = 4.0 * live_steps * (n * (dj + 1) + dj), 3.0 * live_steps * n * dj
    nbytes += out_bytes
    t_ops, t_bytes = flops / PEAK_FLOPS["highest"], nbytes / HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"

"""The selection forms of the preselect (``select="phase"``, ``"packed"``,
``"packed3"``, ``"packed3diag"``) in ``snickery_tpu_torch`` on the CPU: the
plain twins against the JAX package's Pallas kernel in interpret mode, on
inputs made with numpy from a seed.

Tolerances.  On *grid* inputs (every value a small multiple of 1/8, the
affine made of powers of two) every f32 product and sum is exact, so both
packages rank bit-equal scores and ids, scores and flags must be equal
exactly.  On Gaussian inputs the two matmuls sum in another order, so
scores agree to rtol/atol 1e-4 (2e-3 at a split precision) plus, in the
packed forms, 127 ulp (the 7 bits a key drops), and an id that only one
side keeps must be a near-tie of the other side's k-th score in float64.

Dead slots.  The Pallas packed forms fill the spare slots of a starved
target with (+inf, some row); the port writes (+inf, 0) in every form.
The comparisons below look at live (finite) slots only, and at the flags of
targets with at least k finite scores only (Pallas flags every starved
target, the port only where a block holds three of its finite scores).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from snickery_tpu.const import QUINPHONE_CONTEXT_WEIGHTS, QUINPHONE_SCALE
from snickery_tpu.ops.pallas_topk import _from_key, _to_key, pallas_topk_preselect
from snickery_tpu_torch import sweep_topk
from snickery_tpu_torch.kernel_check import compare, pileup_block, scores64
from snickery_tpu_torch.ops import cuda_topk
from snickery_tpu_torch.ops.cuda_topk import (ALL_ENTRY_POINTS, ALL_KERNELS, BLOCK_ROWS,
                                              KEY_EMPTY, SELECTS, cuda_topk_preselect,
                                              derive_operand, from_key, kernel_name,
                                              pack_meta, packed_keys, to_key,
                                              topk_preselect_dv_plain,
                                              topk_preselect_zt_plain)
from snickery_tpu_torch.voicedb.device_layout import build_raw_blocks

P = torch.from_numpy
J = jnp.asarray
T, M = 256, 8192                      # one Pallas target tile, two chunks
F32_EPS = float(np.finfo(np.float32).eps)
LING = (*QUINPHONE_CONTEXT_WEIGHTS, QUINPHONE_SCALE)


def _grid(rng, shape, lo=-16, hi=17):
    """Multiples of 1/8 in [-2, 2]: products and sums of a few dozen are
    exact in f32."""
    return (rng.integers(lo, hi, shape) / 8.0).astype(np.float32)


def _case(seed, kd, grid, pileup=0, offset=0.0, m=M):
    """(targets, feats (m, kd), aff, raw block (M, kd + 2)) numpy.  ``grid``:
    exact arithmetic (see the module docstring); ``offset`` shifts both
    sides so that many scores are negative; ``pileup`` plants a run in the
    block of row 256 under the first 16 targets."""
    rng = np.random.default_rng(seed)
    if grid:
        feats, targets = _grid(rng, (m, kd)), _grid(rng, (T, kd))
        aff = (_grid(rng, kd, -4, 5), 2.0 ** rng.integers(-1, 2, kd).astype(np.float32),
               2.0 ** rng.integers(-1, 1, kd).astype(np.float32))
        if pileup:
            base = _grid(rng, kd)
            feats[256:256 + pileup] = base
            feats[256:256 + pileup, 0] += np.arange(pileup, dtype=np.float32) / 8
            targets[:16] = (base - aff[0]) / aff[1] * aff[2]
    else:
        feats = (rng.standard_normal((m, kd)) + offset).astype(np.float32)
        targets = (rng.standard_normal((T, kd)) + offset).astype(np.float32)
        aff = ((0.1 * rng.standard_normal(kd)).astype(np.float32),
               rng.uniform(0.5, 2.0, kd).astype(np.float32),
               rng.uniform(0.2, 1.0, kd).astype(np.float32))
        if pileup:
            pileup_block(feats, targets, aff, start=256, run=pileup, seed=seed)
    jr = np.zeros_like(feats)
    jr[:-1] = feats[1:]
    raw, _, _ = build_raw_blocks(feats, jr, M, affine=aff)
    return targets, feats, aff, raw


def _both(targets, raw, aff, m, k, select, zt, precision="highest", labels=None,
          partition=False, weights=None):
    """(Pallas interpret result, twin result) as numpy tuples, each sorted
    by (score, index) per row: the zero-transient form on the raw block or
    the derived one (``db_affine`` without ``zero_transient`` there, the
    operand of ``derive_operand`` here)."""
    kd = targets.shape[1]
    pkw, tkw = {}, {}
    if labels is not None:
        tc, tx, tv, dc, dx, dv = labels
        if partition:
            pkw["partition"] = (J(tv), J(dv))
        if weights is not None:
            pkw.update(linguistic=(J(tc), J(tx), J(dc), J(dx)), ling_weights=weights)
        tkw = dict(tgt_meta=pack_meta(P(tc), P(tx), P(tv)),
                   db_meta=pack_meta(P(dc), P(dx), P(dv)), partition=partition,
                   ling_weights=weights)
    jaff = (*map(J, aff), jnp.int32(m))
    if zt:
        ref = pallas_topk_preselect(J(targets), J(raw), k=k, interpret=True,
                                    mm_precision=precision, select=select, db_affine=jaff,
                                    zero_transient=True, m_rows=M, **pkw)
        got = topk_preselect_zt_plain(P(targets), P(raw), k, tuple(map(P, aff)), M,
                                      precision=precision, select=select, **tkw)
    else:
        ref = pallas_topk_preselect(J(targets), J(raw[:M, :kd]), k=k, interpret=True,
                                    mm_precision=precision, select=select, db_affine=jaff,
                                    **pkw)
        op, sqn = derive_operand(P(raw), tuple(map(P, aff)), m, M, precision)
        got = topk_preselect_dv_plain(P(targets), op, sqn, k, M, precision=precision,
                                      select=select, **tkw)
    return tuple(np.asarray(a) for a in ref), _sorted(*(a.numpy() for a in got))


def _sorted(idx, vals, *rest):
    order = np.lexsort((idx, vals), axis=-1)
    return (np.take_along_axis(idx, order, -1), np.take_along_axis(vals, order, -1), *rest)


def _assert_live_equal(ref, got):
    """Ids and scores equal on live slots; a dead slot of the port reads
    (+inf, 0)."""
    live = np.isfinite(ref[1])
    np.testing.assert_array_equal(live, np.isfinite(got[1]))
    np.testing.assert_array_equal(ref[0][live], got[0][live])
    np.testing.assert_array_equal(ref[1][live], got[1][live])
    assert not got[0][~live].any() and np.isposinf(got[1][~live]).all()


def _assert_equal_up_to_kth_ties(ref, got):
    """Scores equal exactly; ids equal except, on under 1% of the slots,
    where the slot's score is that of the row's k-th: among exact ties at
    the cut the Pallas phase and packed loops may keep a later row (they
    take one element a block between refreshes, so a later block's tie can
    enter before an earlier block's second one); the port keeps the lowest."""
    np.testing.assert_array_equal(ref[1], got[1])
    differ = ref[0] != got[0]
    assert differ.mean() < 0.01
    assert (np.broadcast_to(got[1][:, -1:], got[1].shape)[differ] == got[1][differ]).all()


def _assert_close(ref, got, tol, ulps=0):
    """Gaussian inputs: the same live slots; rows with the same id set have
    scores within ``tol`` (rtol and atol) + ``ulps`` f32 ulp; the other rows
    are few and their k-th scores agree to that tolerance (a near-tie)."""
    live = np.isfinite(ref[1])
    np.testing.assert_array_equal(live, np.isfinite(got[1]))
    ri, gi = np.where(live, ref[0], -1), np.where(live, got[0], -1)
    same = (np.sort(ri, -1) == np.sort(gi, -1)).all(-1)
    assert same.mean() >= 0.95, f"id sets equal on {same.mean():.3f} of the rows"
    rv, gv = np.where(live, ref[1], 0.0), np.where(live, got[1], 0.0)
    allowed = tol + (tol + ulps * F32_EPS) * np.abs(rv)
    byid = lambda i, v: np.take_along_axis(v, np.argsort(i, -1, kind="stable"), -1)
    assert (np.abs(byid(ri, rv) - byid(gi, gv))[same] <= byid(ri, allowed)[same]).all()
    assert (np.abs(rv.max(-1) - gv.max(-1))[~same] <= allowed.max(-1)[~same]).all()


# ---------------------------------------------------------------- the keys
SPECIAL = np.array([0.0, -0.0, np.inf, -np.inf, 1e-45, -1e-45, 1e-40, -1e-40, 1.0, -1.0,
                    3.4e38, -3.4e38, 16777216.0, -2.5], np.float32)


@pytest.mark.parametrize("values", ["special", "random"])
def test_to_key_from_key_match_jax(values):
    """``to_key`` / ``from_key`` equal the JAX ``_to_key`` / ``_from_key``
    bit for bit on +-0, +-inf, denormals and negatives; the key order is
    the float order, -0.0 below +0.0."""
    x = SPECIAL if values == "special" else (
        np.random.default_rng(1).standard_normal(4096) * 1e3).astype(np.float32)
    key = to_key(P(x))
    np.testing.assert_array_equal(key.numpy(), np.asarray(_to_key(J(x))))
    back = from_key(key).numpy()
    np.testing.assert_array_equal(back.view(np.int32), np.asarray(_from_key(J(key.numpy()))
                                                                  ).view(np.int32))
    np.testing.assert_array_equal(back.view(np.int32), x.view(np.int32))
    order = np.argsort(key.numpy(), kind="stable")
    assert (np.diff(x[order].astype(np.float64)) >= 0).all()
    if values == "special":
        assert int(to_key(P(np.float32([-0.0])))) == -1 and int(to_key(P(np.float32([0.0])))) == 0


def test_packed_keys_match_jax_and_clamp():
    """``packed_keys`` is the Pallas expression (key with its low 7 bits
    replaced by the row in the 128-row block); unpacking moves a score by at
    most 127 ulp; KEY_EMPTY and a packed +inf both read +inf."""
    rng = np.random.default_rng(2)
    s = (rng.standard_normal((4, 300)) * 50).astype(np.float32)
    rows = np.arange(1000, 1300)
    got = packed_keys(P(s), P(rows)).numpy()
    ref = (np.asarray(_to_key(J(s))) & ~127) | (rows & 127).astype(np.int32)
    np.testing.assert_array_equal(got, ref)
    back = from_key(P(got)).numpy()
    assert (np.abs(back - s) <= 127 * np.spacing(np.abs(s))).all()
    inf_key = packed_keys(P(np.float32([np.inf])), P(np.array([77])))
    assert np.isposinf(from_key(inf_key).numpy()).all()
    assert np.isposinf(from_key(torch.tensor([KEY_EMPTY], dtype=torch.int32)).numpy()).all()


# ------------------------------------------------- packed against interpret
@pytest.mark.parametrize("zt", [True, False], ids=["zt", "dv"])
@pytest.mark.parametrize("data", ["ties", "pileup"])
def test_packed_equals_pallas_interpret_on_exact_inputs(data, zt):
    """Grid inputs (bit-equal scores, many exact ties, negative scores; with
    "pileup" the whole top-k inside one 128-row block): the packed twin's
    ids and scores equal the Pallas kernel's on every live slot."""
    k = 12
    targets, _, aff, raw = _case(11 + zt, 16, True, pileup=k if data == "pileup" else 0)
    ref, got = _both(targets, raw, aff, M, k, "packed", zt)
    assert (ref[1] < 0).any(), "the case should rank negative scores"
    _assert_live_equal(ref, got)
    if data == "pileup":
        np.testing.assert_array_equal(np.sort(got[0][:16], -1),
                                      np.tile(np.arange(256, 256 + k), (16, 1)))


@pytest.mark.parametrize("zt", [True, False], ids=["zt", "dv"])
def test_packed_margin_coverage_on_gaussians(zt):
    """Port of test_pallas_packed_select_margin_coverage (negative scores
    included): the packed top-(k + margin) covers the exact top-k of the
    stream twin on every target, and agrees with the Pallas kernel to
    1e-4 + 127 ulp."""
    from snickery_tpu_torch.const import PRESELECT_MARGIN
    k = 30
    targets, _, aff, raw = _case(61, 48, False, offset=2.0)
    ref, got = _both(targets, raw, aff, M, k + PRESELECT_MARGIN, "packed", zt)
    assert (got[1] < 0).any()
    _assert_close(ref, got, 1e-4, ulps=127)
    args = (P(targets), P(raw), k, tuple(map(P, aff)), M)
    exact = topk_preselect_zt_plain(*args)[0].numpy()
    if not zt:
        op, sqn = derive_operand(P(raw), tuple(map(P, aff)), M, M)
        exact = topk_preselect_dv_plain(P(targets), op, sqn, k, M)[0].numpy()
    covered = np.mean([len(np.intersect1d(got[0][t], exact[t])) / k for t in range(T)])
    assert covered == 1.0


def _partition_labels(rng, m, starved_rows=5):
    """4 voices; the first 8 targets ask for voice 9, which has
    ``starved_rows`` rows; padding rows are voice -1."""
    tv = rng.integers(0, 4, T).astype(np.int32)
    dv = rng.integers(0, 4, M).astype(np.int32)
    tv[:8] = 9
    dv[rng.choice(m, starved_rows, replace=False)] = 9
    dv[m:] = -1
    z = lambda n: np.zeros(n, np.int32)
    return z(T), np.zeros((T, 5), np.int32), tv, z(M), np.zeros((M, 5), np.int32), dv


@pytest.mark.parametrize("zt", [True, False], ids=["zt", "dv"])
def test_packed_split3cat_with_starved_partition(zt):
    """Port of test_pallas_packed_select_matches_stream: split3cat with the
    partition mask and a voice of 5 rows.  Against interpret: the same live
    slots (5 on the starved targets, the same 5 rows), scores to 2e-3 + 127
    ulp, differing ids near-ties.  The port's dead slots read (+inf, 0).
    Against the port's own stream twin: every id that packed alone keeps
    lies within 127 ulp of the stream k-th score in float64."""
    k, kd, m = 20, 151, M - 100
    targets, _, aff, raw = _case(63, kd, False, m=m)
    labels = _partition_labels(np.random.default_rng(64), m)
    ref, got = _both(targets, raw, aff, m, k, "packed", zt, "split3cat", labels, True)
    assert np.isfinite(got[1][:8]).sum(-1).tolist() == [5] * 8
    assert not got[0][:8, 5:].any() and np.isposinf(got[1][:8, 5:]).all()
    np.testing.assert_array_equal(np.sort(ref[0][:8, :5], -1), np.sort(got[0][:8, :5], -1))
    _assert_close(ref, got, 2e-3, ulps=127)
    assert (labels[5][got[0]] == labels[2][:, None])[np.isfinite(got[1])].all()
    A, R = tuple(map(P, aff)), P(raw)
    masks = dict(tgt_meta=pack_meta(*map(P, labels[:3])), db_meta=pack_meta(*map(P, labels[3:])),
                 partition=True, ling_weights=None)
    i_s, v_s = topk_preselect_zt_plain(P(targets), R, k, A, M, precision="split3cat", **masks)
    i_p, v_p = topk_preselect_zt_plain(P(targets), R, k, A, M, precision="split3cat",
                                       select="packed", **masks)
    s_p = scores64(R, A, P(targets), i_p.long(), masks, "split3cat").numpy()
    s_s = scores64(R, A, P(targets), i_s.long(), masks, "split3cat").numpy()
    for t in range(8, T):
        only = ~np.isin(i_p[t].numpy(), i_s[t].numpy())
        kth = s_s[t].max()
        assert (s_p[t][only] <= kth + 2 * 127 * F32_EPS * abs(kth) + 1e-3).all()


# -------------------------------------------------- invariance to the tiling
@pytest.mark.parametrize("zt", [True, False], ids=["zt", "dv"])
@pytest.mark.parametrize("select", ["phase", "packed", "packed3diag"])
def test_twin_does_not_depend_on_its_blocking(select, zt):
    """Stands in for the Pallas grid-order tests (db_major or not): the
    twin's ids, scores and flags are the same whatever ``t_block`` and
    ``chunk`` cut the work into, and M need not be a multiple of 128."""
    k, m_rows = 10, M - 37
    targets, _, aff, raw = _case(64 + zt, 24, False, pileup=6)
    A, R = tuple(map(P, aff)), P(raw)
    if zt:
        run = lambda **kw: topk_preselect_zt_plain(P(targets), R, k, A, m_rows, select=select,
                                                   **kw)
    else:
        op, sqn = derive_operand(R, A, m_rows, m_rows)
        run = lambda **kw: topk_preselect_dv_plain(P(targets), op, sqn, k, m_rows,
                                                   select=select, **kw)
    a = run()
    for kw in (dict(t_block=64, chunk=1024), dict(t_block=100, chunk=128 * 7)):
        for x, y in zip(a, run(**kw)):
            assert torch.equal(x, y)
    if select == "packed3diag":
        assert a[2].dtype == torch.int32 and a[2].shape == (T,) and bool(a[2][:16].all())


def test_packed3_chunk_must_hold_whole_blocks():
    targets, _, aff, raw = _case(3, 8, False)
    with pytest.raises(ValueError, match="multiple of 128"):
        topk_preselect_zt_plain(P(targets), P(raw), 4, tuple(map(P, aff)), M,
                                select="packed3", chunk=1000)


# --------------------------------------------------------------------- phase
@pytest.mark.parametrize("zt", [True, False], ids=["zt", "dv"])
@pytest.mark.parametrize("precision", ["highest", "split3", "split3cat"])
def test_phase_equals_stream_and_interpret(precision, zt):
    """Port of tests/test_ops.py::test_pallas_stream_select_matches_phase:
    "phase" is the exact top-k of "stream" bit for bit in the port, with
    duplicated rows (ties go to the lowest row); on grid inputs at
    "highest" its scores equal the Pallas phase kernel's exactly and its ids
    wherever the score is not tied with the k-th, on Gaussian inputs to
    2e-3."""
    k = 12
    grid = precision == "highest"
    targets, feats, aff, raw = _case(70 + zt, 16 if grid else 40, grid)
    raw[100:140] = raw[50]
    ref, got = _both(targets, raw, aff, M, k, "phase", zt, precision)
    _, stream = _both(targets, raw, aff, M, k, "stream", zt, precision)
    for x, y in zip(got, stream):
        np.testing.assert_array_equal(x, y)
    if grid:
        # bit-equal scores; among exact ties at the k-th score the Pallas
        # phase loop may keep a later row (it takes one element a block a
        # phase, so a later block's tie can enter before an earlier
        # block's second one), the port keeps the lowest
        _assert_equal_up_to_kth_ties(ref, got)
    else:
        _assert_close(ref, got, 2e-3)


# ------------------------------------------------------------------- packed3
@pytest.mark.parametrize("zt", [True, False], ids=["zt", "dv"])
def test_packed3_without_and_with_pileup(zt):
    """Port of test_pallas_packed3_margin_coverage_and_fallback.  Without a
    pile-up (k 4 over 64 blocks: no block holds three of a target's best)
    no flag is raised and "packed3" is "packed"; with a run of 10
    near-duplicates in one block under 16 targets their flags are raised
    and "packed3" is the exact "stream" result, as in the Pallas kernel."""
    k = 4
    targets, _, aff, raw = _case(66, 16, True)
    A, R, X = tuple(map(P, aff)), P(raw), P(targets)
    op, sqn = derive_operand(R, A, M, M)

    def twin(select, targets=X, R=R, op=op, sqn=sqn, k=k):
        if zt:
            return topk_preselect_zt_plain(targets, R, k, A, M, select=select)
        return topk_preselect_dv_plain(targets, op, sqn, k, M, select=select)

    flags = twin("packed3diag")[2]
    rows = (flags == 0).numpy()
    assert rows.mean() > 0.5
    fast, packed = twin("packed3diag"), twin("packed")
    assert torch.equal(fast[0][rows], packed[0][rows]) and torch.equal(fast[1][rows],
                                                                      packed[1][rows])
    quiet = P(targets[rows][:64])
    for x, y in zip(twin("packed3", quiet), twin("packed", quiet)):
        assert torch.equal(x, y)
    ref, got = _both(targets[rows][:64].repeat(4, 0), raw, aff, M, k, "packed3", zt)
    _assert_live_equal(ref, got)
    # the pile-up: flags, the fallback, and the Pallas kernel's own answer
    k = 8
    targets, _, aff, raw = _case(67, 16, True, pileup=10)
    A, R, X = tuple(map(P, aff)), P(raw), P(targets)
    op, sqn = derive_operand(R, A, M, M)
    kw = dict(targets=X, R=R, op=op, sqn=sqn, k=k)
    assert bool(twin("packed3diag", **kw)[2][:16].all())
    for x, y in zip(twin("packed3", **kw), twin("stream", **kw)):
        assert torch.equal(x, y)
    ref, got = _both(targets, raw, aff, M, k, "packed3", zt)
    _assert_live_equal(ref, got)
    np.testing.assert_array_equal(np.sort(got[0][:16], -1),
                                  np.tile(np.arange(256, 264), (16, 1)))


@pytest.mark.parametrize("mask", ["none", "part"])
def test_packed3diag_flags_match_interpret(mask):
    """Port of test_pallas_packed3_partition_starved plus the flag row: on
    grid inputs with a pile-up the flags equal the Pallas kernel's on every
    target with at least k finite scores, unflagged columns equal "packed"
    (in both packages), flagged pile-up columns hold only three rows of the
    run, and with the partition mask no unit of another voice is selected
    and a starved target keeps (+inf, 0) in its spare slots."""
    k, m = 12, M - 64
    targets, _, aff, raw = _case(68, 16, True, pileup=10, m=m)
    labels = _partition_labels(np.random.default_rng(69), m, starved_rows=3) if mask == "part" \
        else None
    ref, got = _both(targets, raw, aff, m, k, "packed3diag", True, labels=labels,
                     partition=mask == "part")
    _, packed = _both(targets, raw, aff, m, k, "packed", True, labels=labels,
                      partition=mask == "part")
    full = np.isfinite(got[1]).all(-1)
    if mask == "part":
        assert not full[:8].any() and full[8:].all()
        assert np.isfinite(got[1][:8]).sum(-1).tolist() == [3] * 8
        assert not got[0][:8, 3:].any()
        live = np.isfinite(got[1])
        assert (labels[5][got[0]] == labels[2][:, None])[live].all()
    np.testing.assert_array_equal(np.asarray(ref[2])[full] > 0, got[2][full] > 0)
    assert got[2][full].any() and not got[2][full].all()
    clear = full & (got[2] == 0)
    np.testing.assert_array_equal(got[0][clear], packed[0][clear])
    np.testing.assert_array_equal(got[1][clear], packed[1][clear])
    np.testing.assert_array_equal(ref[0][clear], got[0][clear])
    np.testing.assert_array_equal(ref[1][clear], got[1][clear])
    if mask == "none":
        assert got[2][:16].all()
        in_run = (got[0][:16] >= 256) & (got[0][:16] < 266)
        assert in_run.sum(-1).tolist() == [3] * 16


@pytest.mark.parametrize("select", ["packed", "packed3diag"])
def test_packed_with_quinphone_penalties(select):
    """The ``_ling`` mask once: penalised scores sit near 2^24, where an ulp
    is 2 and a packed key may move a score by 254, more than a context
    penalty of 100, so the packed ranking is held to the Pallas kernel's own
    (grid inputs: exact) and not to the exact top-k."""
    k = 10
    targets, _, aff, raw = _case(71, 16, True)
    rng = np.random.default_rng(72)
    codes = rng.integers(0, 6, T).astype(np.int32)
    codes[:8] = 99                           # a code no row carries
    labels = (codes, rng.integers(0, 4, (T, 5)).astype(np.int32),
              np.zeros(T, np.int32), rng.integers(0, 6, M).astype(np.int32),
              rng.integers(0, 4, (M, 5)).astype(np.int32), np.zeros(M, np.int32))
    ref, got = _both(targets, raw, aff, M, k, select, True, labels=labels, weights=LING)
    assert (got[1] > 1e7).any(), "some targets should fall back to penalised codes"
    if select == "packed":
        # near 2^24 many rows of different blocks share one key
        _assert_equal_up_to_kth_ties(ref, got)
    else:
        clear = got[2] == 0
        np.testing.assert_array_equal(np.asarray(ref[2]) > 0, got[2] > 0)
        np.testing.assert_array_equal(ref[0][clear], got[0][clear])
        np.testing.assert_array_equal(ref[1][clear], got[1][clear])


# ------------------------------------------------------- wrapper and checks
@pytest.mark.parametrize("select", SELECTS)
def test_wrapper_on_cpu_runs_the_twin_and_compare_accepts_it(select):
    """``cuda_topk_preselect(select=)`` on CPU tensors is the plain twin, in
    both forms, and launches nothing; ``kernel_check.compare`` runs at every
    selection (on the CPU: twin against twin, error 0)."""
    k = 8
    targets, _, aff, raw = _case(80, 24, False, pileup=6)
    A, R, X = tuple(map(P, aff)), P(raw), P(targets)
    before = dict(cuda_topk.LAUNCH_COUNTS)
    out = cuda_topk_preselect(X, R, k, A, M, select=select)
    ref = topk_preselect_zt_plain(X, R, k, A, M, select=select)
    assert len(out) == len(ref) == (3 if select == "packed3diag" else 2)
    for x, y in zip(out, ref):
        assert torch.equal(x, y)
    op, sqn = derive_operand(R, A, M, M, "split3cat")
    out = cuda_topk_preselect(X, op, k, None, M, precision="split3cat", zero_transient=False,
                              sqn=sqn, select=select)
    ref = topk_preselect_dv_plain(X, op, sqn, k, M, precision="split3cat", select=select)
    for x, y in zip(out, ref):
        assert torch.equal(x, y)
    assert dict(cuda_topk.LAUNCH_COUNTS) == before
    assert compare(X, R, A, M, k, "split3cat", select=select)[:2] == (0.0, 0)
    assert compare(X, op, None, M, k, "split3cat", sqn=sqn, select=select)[:2] == (0.0, 0)


@pytest.mark.parametrize("where", ["zt_plain", "dv_plain", "wrapper", "kernel_name"])
def test_unknown_select_raises(where):
    targets, _, aff, raw = _case(81, 8, False)
    A, R, X = tuple(map(P, aff)), P(raw), P(targets)
    with pytest.raises(ValueError, match="unknown select"):
        if where == "zt_plain":
            topk_preselect_zt_plain(X, R, 4, A, M, select="auto")
        elif where == "dv_plain":
            op, sqn = derive_operand(R, A, M, M)
            topk_preselect_dv_plain(X, op, sqn, 4, M, select="packed2")
        elif where == "wrapper":
            cuda_topk_preselect(X, R, 4, A, M, select="Stream")
        else:
            kernel_name(False, False, select="fast")


def test_entry_point_names():
    """96 entry points: the 24 (form x precision x masks) at each of the
    four kernels' selections; "packed3diag" runs the ``_packed3`` one."""
    assert len(ALL_KERNELS) == 24 and len(ALL_ENTRY_POINTS) == len(set(ALL_ENTRY_POINTS)) == 96
    assert set(ALL_KERNELS) <= set(ALL_ENTRY_POINTS)
    assert kernel_name(False, False) == "topk_preselect_zt"
    assert kernel_name(True, True, "split3cat", False, "phase") == \
        "topk_preselect_dv_split3cat_ling_part_phase"
    assert kernel_name(True, False, "split3", True, "packed3diag") == \
        kernel_name(True, False, "split3", True, "packed3") == \
        "topk_preselect_zt_split3_part_packed3"
    for sel in SELECTS:
        assert kernel_name(False, True, "highest", True, sel) in ALL_ENTRY_POINTS


def test_pileup_block_plants_one_block():
    rng = np.random.default_rng(5)
    feats = rng.standard_normal((1024, 12)).astype(np.float32)
    targets = rng.standard_normal((32, 12)).astype(np.float32)
    before = feats.copy()
    aff = (np.full(12, 0.5, np.float32), np.full(12, 2.0, np.float32), np.ones(12, np.float32))
    pileup_block(feats, targets, aff, start=640, run=9, n_targets=4, seed=1)
    changed = np.flatnonzero((feats != before).any(-1))
    assert changed.tolist() == list(range(640, 649)) and 640 // BLOCK_ROWS == 648 // BLOCK_ROWS
    d = (((feats - aff[0]) / aff[1] * aff[2])[None] - targets[:4, None]) ** 2
    assert (np.sort(np.argsort(d.sum(-1), -1)[:, :9], -1) == np.arange(640, 649)).all()
    with pytest.raises(ValueError, match="one 128-row block"):
        pileup_block(feats, targets, aff, start=125, run=9)


# ------------------------------------------------------------------ the sweep
@pytest.mark.parametrize("db_op", ["zt", "dv"])
def test_sweep_on_cpu_reports_overflow_with_pileup(capsys, db_op):
    """``python -m snickery_tpu_torch.sweep_topk --device cpu`` at a toy
    size: one line a combination and a BEST line; with ``--pileup 6``
    packed3diag reports a non-zero overflow count, at least the planted
    targets, and ``--scatter`` (which spreads every run of neighbours over
    many blocks, the planted ones too) lowers it."""
    argv = ["--device", "cpu", "--rows", "64", "--units", "4096", "--dim", "16", "--k", "4",
            "--iters", "1", "--db-op", db_op, "--pileup", "6", "--combos",
            "highest,stream highest,phase split3cat,packed highest,packed3 "
            "highest,packed3diag"]

    def overflow(out):
        diag = next(ln for ln in out.splitlines() if "packed3diag" in ln)
        return tuple(map(int, diag.split("overflow")[1].split()[0].split("/")))

    assert sweep_topk.main(argv) == 0
    out = capsys.readouterr().out
    lines = [ln for ln in out.splitlines() if " ms" in ln and not ln.startswith("BEST")]
    assert len(lines) == 5 and "BEST:" in out
    n, total = overflow(out)
    assert total == 64 and n >= 64 // sweep_topk.PILEUP_SHARE
    assert sweep_topk.main(argv + ["--scatter"]) == 0
    assert overflow(capsys.readouterr().out)[0] < n


@pytest.mark.parametrize("masks", ["part", "ling", "ling_part"])
def test_sweep_with_fused_masks_on_cpu(capsys, masks):
    """``--masks`` fuses the partition mask, the quinphone penalties or
    both on uniform labels (8 voices, 80 codes, 40 context phones), in
    either operand form: the sweep runs every selection and its masks are
    the ones ``cuda_topk_preselect`` takes (a partitioned target keeps only
    rows of its own voice)."""
    argv = ["--device", "cpu", "--rows", "32", "--units", "2048", "--dim", "12", "--k", "4",
            "--iters", "1", "--masks", masks, "--db-op", "dv" if masks == "ling" else "zt",
            "--combos", "highest,stream split3,phase split3cat,packed highest,packed3 "
            "highest,packed3diag"]
    assert sweep_topk.main(argv) == 0
    out = capsys.readouterr().out
    assert out.count(" ms") == 6 and "overflow" in out
    kw = sweep_topk.make_masks(32, 2048, 0, masks, torch.device("cpu"))
    assert kw["partition"] == ("part" in masks) and (kw["ling_weights"] is not None) == (
        "ling" in masks)
    assert kw["tgt_meta"].shape == (32, 8) and kw["db_meta"].shape == (2048, 8)
    if kw["partition"]:
        targets, raw, aff = sweep_topk.make_data(32, 2048, 12, 0, 0, False)
        ids, vals = cuda_topk_preselect(P(targets), P(raw), 4, tuple(map(P, aff)), 2048,
                                        select="packed", **kw)
        assert torch.equal(kw["db_meta"][ids.long(), 6], kw["tgt_meta"][:, 6, None].expand(-1, 4))
    assert sweep_topk.make_masks(32, 2048, 0, "none", torch.device("cpu")) == {}


def test_sweep_refuses_bad_arguments(capsys):
    with pytest.raises(SystemExit):
        sweep_topk.main(["--device", "cpu", "--combos", "highest,auto"])
    with pytest.raises(SystemExit):
        sweep_topk.main(["--device", "cpu", "--pileup", "500"])
    capsys.readouterr()


def test_scatter_order_is_a_permutation():
    order = sweep_topk.scatter_order(4096)
    assert sorted(order.tolist()) == list(range(4096))
    assert (np.abs(np.diff(order[:64])) > BLOCK_ROWS).all()

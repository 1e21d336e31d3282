"""The port's decodes (``snickery_tpu_torch.ops.viterbi``) on the CPU: the
public wrappers, which take the plain versions for CPU tensors, against the
JAX package's ``viterbi_decode`` / ``greedy_decode``; the streamed greedy
over chunks against one greedy decode; the checks the wrappers make on any
device; the kernels' plan (shared memory, cluster size, ring); a model of
the CUDA kernel's early stop (``csrc/viterbi.cu``: each utterance stops at
its own length) against the plain loop, which runs to the longest; and a
model of the kernels' split design (every step's join-cost table made ahead
of the recursion, the recursion and greedy choices read from the tables)
against the plain versions, bit for bit.

Inputs are made with numpy from a seed and handed to both packages.
Tolerance: paths equal, total costs rtol 1e-5 (the JAX version forms join
distances as |r|^2 + |l|^2 - 2 r.l, the port sums the differences); the
models of the kernel against the port's plain versions: bit-equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from snickery_tpu.ops import viterbi as jvit
from snickery_tpu_torch.const import BIG_PENALTY
from snickery_tpu_torch.ops import viterbi as tvit

RTOL = 1e-5
JCW = 0.7


def _lattice(seed, B, T, N, dj, lengths=None, ties=False):
    """(tc (B, T, N), jl, jr (B, T, N, dj)) f32 with junk past ``lengths``;
    with ``ties`` every odd state a copy of the even one before it."""
    rng = np.random.default_rng(seed)
    tc = rng.uniform(0.0, 3.0, (B, T, N)).astype(np.float32)
    jl = (0.5 * rng.standard_normal((B, T, N, dj))).astype(np.float32)
    jr = (0.5 * rng.standard_normal((B, T, N, dj))).astype(np.float32)
    if ties:
        for x in (tc[..., None], jl, jr):
            x[:, :, 1::2] = x[:, :, 0:N - N % 2:2]
    for b, n in enumerate(lengths if lengths is not None else []):
        tc[b, n:], jl[b, n:], jr[b, n:] = 123.0, 9.0, -7.0
    return tc, jl, jr


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


# name: (B, T, N, dj, lengths or None, epsilon, squared, ties)
CASES = {
    "full": (2, 48, 6, 12, None, 0.0, False, False),
    "length_T": (2, 48, 6, 12, [48, 48], 0.0, True, False),
    "length_1": (3, 32, 5, 8, [1, 1, 1], 0.0, False, False),
    "ragged": (4, 64, 8, 16, [64, 1, 37, 63], 0.0, False, False),
    "n1": (2, 40, 1, 8, [40, 21], 0.0, False, False),
    "ties": (3, 48, 8, 8, [48, 30, 2], 0.0, False, True),
    "epsilon_bites": (3, 64, 10, 12, [64, 50, 17], 0.25, False, False),
}


@pytest.mark.parametrize("name", list(CASES))
def test_viterbi_wrapper_matches_jax(name):
    """The wrapper on CPU tensors (the plain version) against the JAX scan
    per utterance: identical paths (0 past each length; with ties, the
    lowest index), costs rtol 1e-5."""
    B, T, N, dj, lengths, eps, squared, ties = CASES[name]
    tc, jl, jr = _lattice(len(name), B, T, N, dj, lengths, ties)
    length = None if lengths is None else torch.tensor(lengths)
    paths, costs = tvit.viterbi_decode(_t(tc), _t(jl), _t(jr), join_cost_weight=JCW,
                                       search_epsilon=eps, length=length,
                                       squared_joins=squared)
    assert paths.dtype == torch.int64 and paths.shape == (B, T)
    for b in range(B):
        kw = {} if lengths is None else {"length": lengths[b]}
        p, c = jvit.viterbi_decode(jnp.asarray(tc[b]), jnp.asarray(jl[b]), jnp.asarray(jr[b]),
                                   join_cost_weight=JCW, search_epsilon=eps,
                                   squared_joins=squared, **kw)
        np.testing.assert_array_equal(paths[b].numpy(), np.asarray(p))
        np.testing.assert_allclose(float(costs[b]), float(c), rtol=RTOL)
    if ties:
        assert bool((paths % 2 == 0).all())


@pytest.mark.parametrize("name", [n for n in CASES if CASES[n][5] == 0.0])
def test_greedy_wrapper_matches_jax(name):
    """The greedy wrapper on CPU tensors against the JAX greedy scan per
    utterance: identical paths (dead steps choose 0), costs rtol 1e-5."""
    B, T, N, dj, lengths, _, squared, ties = CASES[name]
    tc, jl, jr = _lattice(100 + len(name), B, T, N, dj, lengths, ties)
    length = None if lengths is None else torch.tensor(lengths)
    paths, costs = tvit.greedy_decode(_t(tc), _t(jl), _t(jr), join_cost_weight=JCW,
                                      length=length, squared_joins=squared)
    for b in range(B):
        kw = {} if lengths is None else {"length": lengths[b]}
        p, c = jvit.greedy_decode(jnp.asarray(tc[b]), jnp.asarray(jl[b]), jnp.asarray(jr[b]),
                                  join_cost_weight=JCW, squared_joins=squared, **kw)
        np.testing.assert_array_equal(paths[b].numpy(), np.asarray(p))
        np.testing.assert_allclose(float(costs[b]), float(c), rtol=RTOL)
    if ties:
        assert bool((paths % 2 == 0).all())


@pytest.mark.parametrize("squared", [False, True])
def test_streamed_greedy_over_chunks_matches_one_greedy(squared):
    """Three chunks of 16 steps, the context carried from chunk to chunk,
    ``jcw_first`` 0 on the first chunk (no context yet) and equal to
    ``jcw_rest`` after it: the concatenated path is the one greedy decode
    of the whole lattice chooses, in the port and in the JAX package, and
    the last outgoing context is the last choice's right context."""
    tc, jl, jr = (x[0] for x in _lattice(7, 1, 48, 8, 12))
    ctx = torch.zeros(12, dtype=torch.float32)
    parts = []
    for i in range(3):
        s = slice(16 * i, 16 * (i + 1))
        path, ctx = tvit.greedy_decode_stream(_t(tc[s]), _t(jl[s]), _t(jr[s]), ctx,
                                              0.0 if i == 0 else JCW, JCW, 16,
                                              squared_joins=squared)
        parts.append(path)
    streamed = torch.cat(parts)
    whole, _ = tvit.greedy_decode(_t(tc)[None], _t(jl)[None], _t(jr)[None],
                                  join_cost_weight=JCW, squared_joins=squared)
    ref, _ = jvit.greedy_decode(jnp.asarray(tc), jnp.asarray(jl), jnp.asarray(jr),
                                join_cost_weight=JCW, squared_joins=squared)
    np.testing.assert_array_equal(streamed.numpy(), whole[0].numpy())
    np.testing.assert_array_equal(streamed.numpy(), np.asarray(ref))
    assert torch.equal(ctx, _t(jr[47, int(streamed[-1])]))


def test_streamed_chunk_dead_steps_and_empty_chunk():
    """Steps at or past ``n_live`` choose 0 and keep the context; a chunk
    with no live step returns its incoming context."""
    tc, jl, jr = (_t(x[0]) for x in _lattice(8, 1, 16, 6, 8))
    init = torch.from_numpy(np.random.default_rng(3).standard_normal(8).astype(np.float32))
    path, ctx = tvit.greedy_decode_stream(tc, jl, jr, init, JCW, JCW, 10)
    assert bool((path[10:] == 0).all())
    assert torch.equal(ctx, jr[9, int(path[9])])
    path0, ctx0 = tvit.greedy_decode_stream(tc, jl, jr, init, JCW, JCW, 0)
    assert bool((path0 == 0).all()) and torch.equal(ctx0, init)


def _args(B=1, T=4, N=3, dj=5, dtype=torch.float32):
    return (torch.zeros((B, T, N), dtype=dtype), torch.zeros((B, T, N, dj), dtype=dtype),
            torch.zeros((B, T, N, dj), dtype=dtype))


@pytest.mark.parametrize("fn", ["viterbi_decode", "greedy_decode"])
@pytest.mark.parametrize("fault", ["dtype", "contiguity", "n_states", "shared_memory",
                                   "devices", "length_device"])
def test_wrapper_checks_raise(fn, fault):
    """On any device the wrappers refuse what the kernels do not take: a
    dtype other than f32, a non-contiguous input, more than 255 states, a
    lattice whose shared-memory plan does not fit, tensors on two devices."""
    tc, jl, jr = _args()
    length = None
    if fault == "dtype":
        tc, jl, jr = _args(dtype=torch.float64)
    elif fault == "contiguity":
        jl = torch.zeros((1, 4, 5, 3)).transpose(2, 3)
    elif fault == "n_states":
        tc, jl, jr = _args(N=256, dj=2)
    elif fault == "shared_memory":
        tc, jl, jr = _args(N=200, dj=151)
    elif fault == "devices":
        jr = jr.to("meta")
    else:
        length = torch.ones(1, dtype=torch.int64, device="meta")
    with pytest.raises(ValueError):
        getattr(tvit, fn)(tc, jl, jr, length=length)


def test_stream_checks_raise():
    tc, jl, jr = (x[0] for x in _args())
    ctx = torch.zeros(5)
    with pytest.raises(ValueError):
        tvit.greedy_decode_stream(tc, jl, jr, ctx.double(), 0.0, JCW, 2)
    with pytest.raises(ValueError):
        tvit.greedy_decode_stream(tc, jl, jr, torch.zeros(4), 0.0, JCW, 2)
    with pytest.raises(ValueError):
        tvit.greedy_decode_stream(tc, jl, jr, ctx, 0.0, JCW, 5)


@pytest.mark.parametrize("kind,n,dj,T,want", [
    ("viterbi", 30, 151, 2048, (206096, 2, True)),     # config 3: all in shared memory
    ("viterbi", 30, 302, 2048, (201936, 1, True)),     # join_context_frames 2
    ("viterbi", 30, 151, 8200, (225456, 4, False)),    # backpointers in device memory
    ("viterbi", 64, 302, 96, (228112, 1, True)),       # one group, a ring of 3
    ("greedy", 30, 151, 2048, (225200, 4, False)),
    ("greedy", 64, 302, 64, (221520, 1, False)),
    ("viterbi", 1, 1, 1, (3504, 4, True)),
])
def test_decode_plan(kind, n, dj, T, want):
    """The shared-memory plan (bytes, producer groups, where the
    backpointers live), a pure function of the shape (one lattice, a cluster
    of 8 CTAs)."""
    plan = tvit.decode_plan(kind, n, dj, T)
    assert (plan.smem, plan.groups, plan.bp_in_smem) == want
    assert plan.smem <= tvit.SMEM_LIMIT
    assert plan.smem == tvit.decode_smem(kind, n, dj, T, plan.groups, plan.ring,
                                         plan.bp_in_smem)


@pytest.mark.parametrize("B,sms,want", [(1, 132, 8), (32, 132, 4), (64, 132, 2), (200, 132, 1),
                                        (160, 132, 1), (40, 132, 3), (32, 66, 2), (1, 4, 4)])
def test_cluster_size(B, sms, want):
    """Enough clusters of one utterance each to fill the card, 1 to 8 CTAs."""
    assert tvit.cluster_size(B, sms) == want


def _in_flight(cluster, groups, ring):
    """The plan's order of preference: tables in flight, groups, ring."""
    return (min(tvit.producing_ctas(cluster) * groups, ring), groups, ring)


@pytest.mark.parametrize("kind", ["viterbi", "greedy"])
@pytest.mark.parametrize("B", [1, 32, 64, 200])
@pytest.mark.parametrize("n,dj", [(1, 151), (30, 151), (33, 151), (64, 151), (30, 302),
                                  (64, 302)])
def test_decode_plan_cluster_and_ring(kind, B, n, dj):
    """At 132 SMs (no card to ask) the plan's cluster is 8, 4, 2 and 1 CTAs
    for B = 1, 32, 64 and 200 whatever the shape; the Viterbi keeps its
    backpointers in shared memory where they fit; of the producer groups (1
    to 4) and ring slots (1 to 16) that fit beside them, none has more
    tables in flight, or as many and more groups, or as many and a deeper
    ring; the bytes are decode_smem's."""
    T = 650 if B == 1 else 2048
    plan = tvit.decode_plan(kind, n, dj, T, B=B, sms=132)
    assert plan.cluster == {1: 8, 32: 4, 64: 2, 200: 1}[B]
    assert 1 <= plan.groups <= tvit.MAX_GROUPS and 1 <= plan.ring <= tvit.MAX_RING
    assert plan.smem == tvit.decode_smem(kind, n, dj, T, plan.groups, plan.ring,
                                         plan.bp_in_smem) <= tvit.SMEM_LIMIT
    assert plan.bp_in_smem == (kind == "viterbi" and
                               tvit.decode_smem(kind, n, dj, T, 1, 1, True) <= tvit.SMEM_LIMIT)
    mine = _in_flight(plan.cluster, plan.groups, plan.ring)
    for g in range(1, tvit.MAX_GROUPS + 1):
        for r in range(1, tvit.MAX_RING + 1):
            if tvit.decode_smem(kind, n, dj, T, g, r, plan.bp_in_smem) <= tvit.SMEM_LIMIT:
                assert _in_flight(plan.cluster, g, r) <= mine
    if (kind, n, dj, B) == ("viterbi", 30, 151, 32):   # config 3: 12 tables in flight
        assert (plan.groups, plan.ring, plan.bp_in_smem) == (3, 12, True)


def test_decode_plan_fits_the_card():
    """On a card the plan lowers the cluster until the card holds all B
    clusters at once (the count the card gives for each size)."""
    held = {1: 264, 2: 66, 3: 39, 4: 30, 5: 22, 6: 17, 7: 15, 8: 15}
    seen = []

    def fits(c, smem):
        seen.append(c)
        return held[c]
    plan = tvit.decode_plan("viterbi", 30, 151, 2048, B=32, sms=132, max_clusters=fits)
    assert plan.cluster == 3 and seen == [4, 3]
    assert tvit.decode_plan("greedy", 30, 151, 64, B=1, sms=132, max_clusters=fits).cluster == 8
    assert tvit.decode_plan("greedy", 30, 151, 64, B=300, sms=132, max_clusters=fits).cluster == 1


@pytest.mark.parametrize("cluster", [1, 2, 3, 4, 8])
def test_decode_plan_forced_cluster(cluster):
    """A forced cluster size (``kernel_check``'s cases) replaces the one B
    gives; the groups and the ring follow it (here all of config 3's
    backpointers fit whatever the size)."""
    plan = tvit.decode_plan("viterbi", 30, 151, 2048, B=32, cluster=cluster)
    assert plan.cluster == cluster and plan.bp_in_smem
    assert plan == tvit._plan_at("viterbi", 30, 151, 2048, cluster)


@pytest.mark.parametrize("cluster", [0, 9, -1])
def test_decode_plan_refuses_cluster(cluster):
    with pytest.raises(ValueError, match="cluster"):
        tvit.decode_plan("greedy", 30, 151, 64, cluster=cluster)


@pytest.mark.parametrize("kind", ["viterbi", "greedy"])
def test_decode_plan_refuses_oversize(kind):
    with pytest.raises(ValueError, match="shared memory"):
        tvit.decode_plan(kind, 255, 302, 64)


def _kernel_model(tc, jl, jr, length, jcw, eps):
    """The Viterbi as ``csrc/viterbi.cu`` runs it, with the plain version's
    arithmetic: each utterance stops at L = max(1, its length); if the plain
    loop runs on past L (L < n_run) the last state and the total come from
    pruned(cost), else from cost; the path is 0 from L on."""
    B, T, N = tc.shape
    n_run = max(1, min(T, int(length.max())))
    paths = torch.zeros((B, T), dtype=torch.int64)
    totals = torch.zeros(B)
    big = torch.tensor(BIG_PENALTY, dtype=torch.float32)
    jcw, eps = torch.tensor(jcw, dtype=torch.float32), torch.tensor(eps, dtype=torch.float32)

    def pruned(cost):
        best = cost.min()
        return torch.where((eps > 0) & (cost > best + eps), big, cost)

    for b in range(B):
        n_b = max(0, min(T, int(length[b])))
        live = max(1, n_b)
        cost = tc[b, 0] if n_b > 0 else torch.zeros(N)
        bps = []
        for t in range(1, live):
            d = torch.sqrt(((jr[b, t - 1][:, None, :] - jl[b, t][None, :, :]) ** 2).sum(-1))
            trans = pruned(cost)[:, None] + jcw * d
            bps.append(torch.argmin(trans, dim=0))
            cost = trans.min(dim=0).values + tc[b, t]
        fin = pruned(cost) if live < n_run else cost
        totals[b] = fin.min()
        s = int(torch.argmin(fin))
        paths[b, live - 1] = s
        for t in range(live - 1, 0, -1):
            s = int(bps[t - 1][s])
            paths[b, t - 1] = s
    return paths, totals


@pytest.mark.parametrize("eps", [0.0, 0.25, 1e9])
@pytest.mark.parametrize("huge", [False, True])
def test_kernel_early_stop_model_matches_plain(eps, huge):
    """The kernel's early stop at each utterance's own length gives the
    plain loop's paths and totals, ragged lengths 0 and 1 included; with
    ``huge`` target costs at and above BIG_PENALTY make the running best
    exceed the pruning penalty, where the last state must come from
    pruned(cost) when dead steps follow."""
    lengths = [40, 0, 1, 17, 39]
    tc, jl, jr = _lattice(11, 5, 40, 6, 8, lengths)
    if huge:
        tc[:, 3] += 3 * BIG_PENALTY
    args = (_t(tc), _t(jl), _t(jr))
    length = torch.tensor(lengths)
    want = tvit.viterbi_decode(*args, JCW, eps, length)
    got = _kernel_model(*args, length, JCW, eps)
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1], want[1])


@pytest.mark.parametrize("name", ["viterbi_ragged", "viterbi_natural", "viterbi_ties",
                                  "greedy_ragged", "stream_carry", "stream_empty"])
def test_kernel_check_decode_cases_on_cpu(name):
    """``kernel_check``'s decode cases (the card's checks in phase 31 and
    ``tests/test_torch_cuda_decode.py``) build and judge on the CPU, where
    the wrapper is the plain version: equal, with the natural chain at a
    total of exactly 0.0 and ties to the lowest index."""
    from snickery_tpu_torch.kernel_check import run_decode_case
    assert run_decode_case(name, "cpu") == (0.0, 0)


# ------------------------------------------------- the split design's model
def _first_min_by_chains(x):
    """(values, indices) of the first minimum over dim 0 of ``x`` (i, j) as
    the Viterbi kernel's recursion takes it for each column j: four chains
    (i = k, k + 4, ...) each scanned in ascending i with a strict <, then
    met in chain order, ties to the lower index."""
    best_v = best_a = None
    for k in range(min(4, x.shape[0])):
        rows = x[k::4]
        v, a = rows[0].clone(), torch.full(rows[0].shape, k, dtype=torch.int64)
        for m in range(1, rows.shape[0]):
            better = rows[m] < v
            v = torch.where(better, rows[m], v)
            a = torch.where(better, torch.full_like(a, k + 4 * m), a)
        if best_v is None:
            best_v, best_a = v, a
        else:
            take = (v < best_v) | ((v == best_v) & (a < best_a))
            best_v, best_a = torch.where(take, v, best_v), torch.where(take, a, best_a)
    return best_v, best_a


def _viterbi_split_model(tc, jl, jr, length, jcw, eps, squared):
    """The Viterbi as the split kernel runs it, with the plain version's
    arithmetic: every step's weighted table jcw * D_t made first, for all
    steps and utterances, before any recursion; then per utterance the
    recursion to its own last live step from the tables alone (the pruning
    threshold from the published costs, a state pruned above it, the chains'
    first minimum, then the target cost), the dead-step finish and the
    backtrack."""
    B, T, N = tc.shape
    jcw_t = torch.tensor(jcw, dtype=torch.float32)
    eps_t = torch.tensor(eps, dtype=torch.float32)
    big = torch.tensor(BIG_PENALTY, dtype=torch.float32)
    tables = [jcw_t * tvit._pairwise_dists(jr[:, t - 1], jl[:, t], squared) for t in range(1, T)]
    n_run = max(1, min(T, int(length.max())))
    paths = torch.zeros((B, T), dtype=torch.int64)
    totals = torch.zeros(B)
    for b in range(B):
        n_b = max(0, min(T, int(length[b])))
        live = max(1, n_b)
        cost = tc[b, 0] if n_b > 0 else torch.zeros(N)
        bps = []
        for t in range(1, live):
            thr = cost.min() + eps_t if eps > 0 else torch.tensor(float("inf"))
            pruned = torch.where(cost > thr, big, cost)
            v, a = _first_min_by_chains(pruned[:, None] + tables[t - 1][b])
            bps.append(a)
            cost = v + tc[b, t]
        fin = cost
        if live < n_run and eps > 0:
            fin = torch.where(cost > cost.min() + eps_t, big, cost)
        totals[b] = fin.min()
        s = int(torch.argmin(fin))
        paths[b, live - 1] = s
        for t in range(live - 1, 0, -1):
            s = int(bps[t - 1][s])
            paths[b, t - 1] = s
    return paths, totals


def _greedy_table(right, left, w, squared):
    """A greedy step's whole table w * dist(right[i], left[j]) (i, j), each
    distance rounded as the plain greedy rounds it."""
    d = torch.clamp(torch.sum((left[None, :, :] - right[:, None, :]) ** 2, dim=-1), min=0.0)
    return w * (d if squared else torch.sqrt(d))


def _greedy_split_model(tc, jl, jr, length, jcw, squared):
    """Greedy from whole tables made ahead: choice_t the first argmin of
    tc[t] + W_t[choice_{t-1}], each utterance to its own last live step, the
    path 0 after it, the total summed in step order."""
    B, T, N = tc.shape
    jcw_t = torch.tensor(jcw, dtype=torch.float32)
    tables = [[_greedy_table(jr[b, t - 1], jl[b, t], jcw_t, squared) for t in range(1, T)]
              for b in range(B)]
    paths = torch.zeros((B, T), dtype=torch.int64)
    totals = torch.zeros(B)
    for b in range(B):
        n_b = max(0, min(T, int(length[b])))
        tot = tc[b, 0] if n_b > 0 else torch.zeros(N)
        c = int(torch.argmin(tot))
        acc = tot[c]
        paths[b, 0] = c
        for t in range(1, max(1, n_b)):
            tot = tc[b, t] + tables[b][t - 1][c]
            c = int(torch.argmin(tot))
            acc = acc + tot[c]
            paths[b, t] = c
        totals[b] = acc
    return paths, totals


def _stream_split_model(tc, jl, jr, init_ctx, jcw_first, jcw_rest, n_live, squared):
    """The streamed greedy from tables made ahead: step 0's table is one row
    (the incoming context, weighted by jcw_first), the others whole."""
    T = tc.shape[0]
    tables = [_greedy_table(init_ctx[None] if t == 0 else jr[t - 1], jl[t],
                            jcw_first if t == 0 else jcw_rest, squared) for t in range(n_live)]
    path = torch.zeros(T, dtype=torch.int64)
    c = 0
    for t in range(n_live):
        c = int(torch.argmin(tc[t] + tables[t][c]))
        path[t] = c
    return path, (jr[n_live - 1, c] if n_live else init_ctx)


def _model_lattice(kind, seed=5, B=5, T=40, N=9, dj=12):
    """A ragged lattice (lengths T, 0, 1, 17, T - 1) with junk past each
    length; "huge": target costs of one step above BIG_PENALTY; "ties": odd
    states copies of the even ones; "natural": a chain of states with zero
    target costs whose contexts join bit-equal, all else at least 1."""
    lengths = [T, 0, 1, 17, T - 1][:B]
    tc, jl, jr = _lattice(seed, B, T, N, dj, lengths, ties=kind == "ties")
    if kind == "huge":
        tc[:, 3] += 3 * BIG_PENALTY
    if kind == "natural":
        rng = np.random.default_rng(seed)
        tc += 1.0
        nat = rng.integers(0, N, (B, T))
        for b in range(B):
            tc[b, np.arange(T), nat[b]] = 0.0
            jl[b, np.arange(1, T), nat[b, 1:]] = jr[b, np.arange(T - 1), nat[b, :-1]]
    return _t(tc), _t(jl), _t(jr), torch.tensor(lengths)


@pytest.mark.parametrize("lattice,eps,squared", [
    ("ragged", 0.0, False), ("ragged", 0.25, False), ("ragged", 1e9, False),
    ("ragged", 0.25, True), ("huge", 0.25, False), ("huge", 0.0, False),
    ("ties", 0.25, False), ("ties", 0.0, True), ("natural", 0.0, False),
    ("natural", 0.25, False)])
def test_split_model_viterbi_matches_plain(lattice, eps, squared):
    """The decomposition the Viterbi kernel relies on: tables made ahead,
    the recursion from them (the chains' first minimum, the pruning, the
    early stop and dead-step finish, the backtrack) gives
    viterbi_decode_plain's paths and totals bit for bit."""
    tc, jl, jr, length = _model_lattice(lattice)
    want = tvit.viterbi_decode_plain(tc, jl, jr, JCW, eps, length, squared)
    got = _viterbi_split_model(tc, jl, jr, length, JCW, eps, squared)
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1], want[1])
    if lattice == "ties":
        assert bool((got[0] % 2 == 0).all())
    if lattice == "natural":
        assert float(got[1][0]) == 0.0


@pytest.mark.parametrize("N", [1, 3, 4, 5, 9, 33])
def test_first_min_by_chains_is_the_first_minimum(N):
    """The four chains met with ties to the lower index give torch.argmin's
    first minimum and its value, on ties of every kind (equal values in one
    chain, across chains, -0.0 against +0.0)."""
    rng = np.random.default_rng(N)
    x = torch.from_numpy(rng.integers(0, 3, (N, 64)).astype(np.float32))
    x[x == 1] = -0.0
    v, a = _first_min_by_chains(x)
    assert torch.equal(a, torch.argmin(x, dim=0))
    assert torch.equal(v, x[torch.argmin(x, dim=0), torch.arange(64)])


@pytest.mark.parametrize("lattice,squared", [("ragged", False), ("ragged", True),
                                             ("huge", False), ("ties", False),
                                             ("natural", False)])
def test_split_model_greedy_matches_plain(lattice, squared):
    """Greedy reading row choice_{t-1} of whole tables made ahead gives
    greedy_decode_plain's paths and totals bit for bit."""
    tc, jl, jr, length = _model_lattice(lattice, seed=6)
    want = tvit.greedy_decode_plain(tc, jl, jr, JCW, length, squared)
    got = _greedy_split_model(tc, jl, jr, length, JCW, squared)
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1], want[1])


@pytest.mark.parametrize("lattice,n_live,jcw_first,squared", [
    ("ragged", 40, JCW, False), ("ragged", 17, 0.0, False), ("ties", 40, JCW, True),
    ("natural", 33, JCW, False), ("ragged", 1, JCW, False), ("ragged", 0, JCW, False)])
def test_split_model_stream_matches_plain(lattice, n_live, jcw_first, squared):
    """The streamed greedy from tables made ahead (step 0's a row from the
    incoming context) gives greedy_decode_stream_plain's path and outgoing
    context bit for bit."""
    tc, jl, jr, _ = _model_lattice(lattice, seed=7)
    init = torch.from_numpy(np.random.default_rng(9).standard_normal(12).astype(np.float32))
    want = tvit.greedy_decode_stream_plain(tc[0], jl[0], jr[0], init, jcw_first, JCW, n_live,
                                           squared)
    got = _stream_split_model(tc[0], jl[0], jr[0], init, jcw_first, JCW, n_live, squared)
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1], want[1])


def test_decode_profile_patches_apply():
    """``python -m snickery_tpu_torch.decode_profile`` counts cycles in a
    copy of ``csrc/viterbi.cu``: each of its patches finds its one anchor in
    today's source, and a source without them is refused."""
    from snickery_tpu_torch import decode_profile
    text = decode_profile.SOURCE.read_text()
    patched = decode_profile.patched_source(text)
    assert patched.count("clock64()") >= 8 and "snk_decode_profile" in patched
    with pytest.raises(ValueError, match="anchor"):
        decode_profile.patched_source(text.replace("float acc = 0.0f;", "float acc{};"))

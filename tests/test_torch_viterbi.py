"""The port's decodes (``snickery_tpu_torch.ops.viterbi``) on the CPU: the
public wrappers, which take the plain versions for CPU tensors, against the
JAX package's ``viterbi_decode`` / ``greedy_decode``; the streamed greedy
over chunks against one greedy decode; the checks the wrappers make on any
device; the kernels' shared-memory plan; and a model of the CUDA kernel's
early stop (``csrc/viterbi.cu``: each utterance stops at its own length)
against the plain loop, which runs to the longest.

Inputs are made with numpy from a seed and handed to both packages.
Tolerance: paths equal, total costs rtol 1e-5 (the JAX version forms join
distances as |r|^2 + |l|^2 - 2 r.l, the port sums the differences).
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
    ("viterbi", 30, 151, 2048, (140432, 2, True)),     # config 3: all in shared memory
    ("viterbi", 30, 302, 2048, (213392, 2, True)),     # join_context_frames 2
    ("viterbi", 30, 151, 8200, (79008, 2, False)),     # backpointers in device memory
    ("viterbi", 64, 302, 96, (181200, 1, True)),       # one buffer a side
    ("greedy", 30, 151, 2048, (75904, 2, False)),
    ("greedy", 64, 302, 64, (159712, 1, False)),
    ("viterbi", 1, 1, 1, (144, 2, True)),
])
def test_decode_plan(kind, n, dj, T, want):
    """The shared-memory plan, a pure function of the shape, and the row
    stride (a multiple of 4 floats with an odd number of float4s)."""
    plan = tvit.decode_plan(kind, n, dj, T)
    assert (plan.smem, plan.stages, plan.bp_in_smem) == want
    assert plan.smem <= tvit.SMEM_LIMIT
    s = tvit.row_stride(dj)
    assert s >= dj and s % 4 == 0 and (s // 4) % 2 == 1


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

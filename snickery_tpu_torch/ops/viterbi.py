"""Viterbi lattice search and greedy selection, batched over B.

Counterpart of ``snickery_tpu.ops.viterbi`` (and of the greedy scan of
``snickery_tpu.synth._streaming_step``).  Each decode is one hand-written
CUDA kernel on the card (``csrc/viterbi.cu``: one thread-block cluster an
utterance, whose producer warps compute the steps' join-cost tables ahead
of the recursion warps that walk the steps and backtrack, no host
synchronisation) and its plain PyTorch version (:func:`viterbi_decode_plain`,
:func:`greedy_decode_plain`, :func:`greedy_decode_stream_plain`), in which
the JAX ``vmap`` becomes the leading batch dimension and the ``lax.scan`` a
Python loop over the steps.  The public functions dispatch on the tensors'
device: a CPU tensor takes the plain version, a CUDA tensor the kernel, and
nothing falls back from one to the other.  Both refuse the same inputs
(:func:`check_lattice`).  Semantics carried over unchanged:

- total = sum_t target_cost + jcw * sum_t join_dist (weighted Euclidean, or
  squared with ``squared_joins``);
- epsilon pruning: states more than ``search_epsilon`` above the running
  best leave the transition competition (BIG_PENALTY);
- first-minimum backpointers and choices (``torch.argmin`` returns the
  first minimum; the kernels compare with a strict ``<`` in ascending
  index order);
- steps at or beyond ``length`` are dead: zero target and join cost.

The plain Viterbi stops at the longest live length of the batch (read to
the host): past it every state carries the best cost and the JAX scan's
path is 0, which is what is returned there.  The kernel stops at each
utterance's own length and finishes as that loop would
(``csrc/viterbi.cu``), reading the lengths on the card.

A join distance is summed from the differences, so a natural join
(bit-equal contexts) costs exactly 0, where the ``|r|^2 + |l|^2 - 2 r.l``
identity of the JAX version leaves f32 cancellation noise.  Kernel and
plain version sum in different orders, so their costs agree to f32
rounding, and their paths wherever no two paths tie within it.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import numpy as np
import torch

from snickery_tpu_torch.const import BIG_PENALTY
from snickery_tpu_torch.ops import cuda_topk

MAX_STATES = 255             # a kernel backpointer is one byte
SMEM_LIMIT = 227 * 1024      # shared memory a block may use on the card
MAX_CLUSTER = 8              # the portable thread-block cluster size
MAX_RING = 16                # ring slots of join-cost tables a cluster holds at most
MAX_GROUPS = 4               # producer groups of two warps a CTA
SHARED_FIRST_CTA = 4         # clusters up to this size make tables in every CTA
H100_SMS = 132               # the SM count a plan assumes for CPU tensors
KERNELS = ("viterbi_decode", "greedy_decode", "greedy_decode_stream")
_KIND = {"viterbi": 0, "greedy": 1}


def _align16(x: int) -> int:
    return -(-x // 16) * 16


def cluster_size(B: int, sms: int) -> int:
    """CTAs of the cluster that decodes one utterance (one chunk): enough
    clusters to fill ``sms`` SMs with B utterances, at least 1 and at most
    :data:`MAX_CLUSTER` (4 at B = 32 on 132 SMs, 8 at B = 1).  On the card
    :func:`decode_plan` lowers it until the card holds all B clusters at
    once."""
    return max(1, min(MAX_CLUSTER, sms // max(1, B)))


def producing_ctas(cluster: int) -> int:
    """CTAs of a cluster that make tables: all of a cluster of up to
    :data:`SHARED_FIRST_CTA`, all but the first (the recursion's) beyond."""
    return cluster if cluster <= SHARED_FIRST_CTA else cluster - 1


def decode_smem(kind: str, n: int, dj: int, T: int, groups: int, ring: int,
                bp_in_smem: bool) -> int:
    """Bytes of dynamic shared memory a decode CTA uses (``csrc/viterbi.cu``
    ``layout``): ``ring`` + ``groups`` mbarriers; for each producer group a
    staging buffer each of the join_left and join_right slabs (N dj f32 as
    they lie in device memory, from the 16-byte boundary at or before the
    first) and of N target costs; ``ring`` slots of an (N rounded up to 32,
    N) f32 weighted join-cost table and N target costs, and one more a group
    (its table before the copy); the Viterbi's two (32 ceil(N / 32)) f32
    cost vectors; 16 bytes; and with ``bp_in_smem`` the Viterbi's (T - 1, N)
    byte backpointers."""
    viterbi = _KIND[kind] == 0
    slot = _align16(-(-n // 32) * 32 * n * 4) + _align16(n * 4)
    size = (_align16(8 * (ring + groups)) + groups * (2 * _align16((n * dj + 3) * 4)
                                                      + _align16(n * 4))
            + (ring + groups) * slot)
    if viterbi:
        size += 2 * _align16(32 * -(-n // 32) * 4)
    size += 16
    if viterbi and bp_in_smem and T > 1:
        size += _align16((T - 1) * n)
    return size


@dataclass(frozen=True)
class DecodePlan:
    smem: int            # bytes of dynamic shared memory a CTA
    groups: int          # producer groups of two warps a CTA, each a table at a time
    bp_in_smem: bool     # Viterbi backpointers in shared memory, else in global scratch
    cluster: int         # CTAs a cluster: one cluster an utterance (a chunk)
    ring: int            # slots of join-cost tables between the producers and the recursion


def decode_plan(kind: str, n: int, dj: int, T: int, B: int = 1, sms: int = H100_SMS,
                cluster: int | None = None, max_clusters=None) -> DecodePlan:
    """The kernel's plan for B (N = ``n``, ``dj``, ``T``) lattices on a card
    of ``sms`` SMs, a pure function of them: the cluster size
    :func:`cluster_size`, lowered (where ``max_clusters(cluster, smem)``, the
    card's count of clusters it holds at once, is given) until all B fit,
    or ``cluster`` forced (1 to 8); then the Viterbi backpointers in shared
    memory where they fit, else in device memory; and the producer groups
    (1 to 4 a CTA) and ring slots (1 to 16) that fit beside them with the
    most tables in flight, min(groups x producing CTAs, ring), then the
    most groups, then the deepest ring.  Raises ValueError where one group
    and one slot do not fit in :data:`SMEM_LIMIT`."""
    if cluster is not None:
        if not 1 <= cluster <= MAX_CLUSTER:
            raise ValueError(f"a decode cluster has 1 to {MAX_CLUSTER} CTAs, not {cluster}")
        return _plan_at(kind, n, dj, T, cluster)
    c = cluster_size(B, sms)
    plan = _plan_at(kind, n, dj, T, c)
    while max_clusters is not None and c > 1 and max_clusters(c, plan.smem) < B:
        c -= 1
        plan = _plan_at(kind, n, dj, T, c)
    return plan


@functools.lru_cache(maxsize=4096)
def _plan_at(kind: str, n: int, dj: int, T: int, cluster: int) -> DecodePlan:
    makers = producing_ctas(cluster)
    for bp in ((True, False) if _KIND[kind] == 0 else (False,)):
        best = None
        for groups in range(MAX_GROUPS, 0, -1):
            for ring in range(MAX_RING, 0, -1):
                size = decode_smem(kind, n, dj, T, groups, ring, bp)
                if size <= SMEM_LIMIT:
                    key = (min(makers * groups, ring), groups, ring)
                    if best is None or key > best[0]:
                        best = (key, DecodePlan(size, groups, bp, cluster, ring))
                    break
        if best is not None:
            return best[1]
    raise ValueError(f"a {kind} decode of N={n} candidates x dj={dj} needs "
                     f"{decode_smem(kind, n, dj, T, 1, 1, False)} bytes of shared memory, "
                     f"more than the {SMEM_LIMIT} a block has")


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def check_lattice(kind: str, target_costs, join_left, join_right, length=None,
                  init_ctx=None, cluster: int | None = None) -> DecodePlan:
    """Refuse what the kernels do not take, on any device: f32 costs and
    contexts, contiguous, on one device, of matching shapes, N <= 255, a
    plan whose shared memory fits (:func:`decode_plan`, returned: B the
    lattices, 1 for a chunk; the card's SM count, or :data:`H100_SMS` off
    the card; ``cluster`` forced where given; on a card, RuntimeError where
    it cannot place the plan's cluster), and ``length`` (a tensor) an
    integer vector on the same device."""
    tensors = [target_costs, join_left, join_right]
    if init_ctx is not None:
        tensors.append(init_ctx)
    dev = target_costs.device
    for x in tensors:
        if x.device != dev:
            raise ValueError(f"the lattice tensors lie on {x.device} and {dev}")
        if x.dtype != torch.float32:
            raise ValueError(f"the decode takes float32 costs and contexts, not {x.dtype}")
        if not x.is_contiguous():
            raise ValueError("the decode takes contiguous costs and contexts")
    *lead, n = target_costs.shape
    if tuple(join_left.shape) != (*lead, n, join_left.shape[-1]) or \
            join_right.shape != join_left.shape:
        raise ValueError(f"lattice shapes {tuple(target_costs.shape)}, "
                         f"{tuple(join_left.shape)}, {tuple(join_right.shape)} disagree")
    if init_ctx is not None and tuple(init_ctx.shape) != (join_left.shape[-1],):
        raise ValueError(f"init_ctx {tuple(init_ctx.shape)} is not ({join_left.shape[-1]},)")
    if not 1 <= n <= MAX_STATES:
        raise ValueError(f"the decode takes 1 to {MAX_STATES} candidates a step, not {n}")
    if isinstance(length, torch.Tensor):
        if length.device != dev:
            raise ValueError(f"length lies on {length.device}, the lattice on {dev}")
        if length.dtype.is_floating_point or length.dtype == torch.bool:
            raise ValueError(f"length must be an integer tensor, not {length.dtype}")
    B = lead[0] if len(lead) == 2 else 1
    if dev.type != "cuda":
        return decode_plan(kind, n, join_left.shape[-1], target_costs.shape[-2], B, H100_SMS,
                           cluster)
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    fits = functools.partial(_max_clusters, index, 2 if init_ctx is not None else _KIND[kind], n)
    plan = decode_plan(kind, n, join_left.shape[-1], target_costs.shape[-2], B,
                       _sm_count(index), cluster, fits)
    if fits(plan.cluster, plan.smem) < 1:
        raise RuntimeError(f"the card cannot place a {kind} decode cluster of {plan.cluster} "
                           f"CTAs with {plan.smem} bytes of shared memory each")
    return plan


@functools.cache
def _max_clusters(index: int, code: int, n: int, cluster: int, smem: int) -> int:
    """Clusters of ``cluster`` CTAs of decode kernel ``code`` (0 Viterbi, 1
    greedy, 2 streamed greedy) at N = ``n`` and ``smem`` bytes that card
    ``index`` holds at once (``cudaOccupancyMaxActiveClusters``)."""
    with torch.cuda.device(index):
        got = _kernel().snk_decode_max_clusters(code, n, cluster, smem)
    if got < 0:
        raise RuntimeError(f"cudaOccupancyMaxActiveClusters failed: cudaError_t {-got}")
    return got


def _f32(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def _live(B: int, T: int, length, device) -> torch.Tensor:
    steps = torch.arange(T, device=device)[None, :]
    if length is None:
        return torch.ones((B, T), dtype=torch.bool, device=device)
    return steps < torch.as_tensor(length, device=device).reshape(B, 1)


def _n_steps(T: int, length) -> int:
    if length is None:
        return T
    return max(1, min(T, int(torch.as_tensor(length).max())))


def _pairwise_dists(right, left, squared):
    """(B, N, N) distances between rows of right (prev) and left (next),
    summed from the differences."""
    diff = right[:, :, None, :] - left[:, None, :, :]
    sq = torch.sum(diff * diff, dim=-1)
    return sq if squared else torch.sqrt(sq)


def viterbi_decode_plain(target_costs, join_left, join_right, join_cost_weight=1.0,
                         search_epsilon=0.0, length=None, squared_joins=False):
    """The plain PyTorch version of :func:`viterbi_decode`: a Python loop
    over the steps to the longest live length (read to the host) and the
    backtrack in numpy."""
    B, T, N = target_costs.shape
    dev = target_costs.device
    jcw = _f32(join_cost_weight, dev)
    eps = _f32(search_epsilon, dev)
    big = _f32(BIG_PENALTY, dev)
    zero = _f32(0.0, dev)
    live = _live(B, T, length, dev)
    tc = torch.where(live[:, :, None], target_costs, zero)
    n = _n_steps(T, length)
    cost = tc[:, 0]
    backptrs = []
    for t in range(1, n):
        dists = _pairwise_dists(join_right[:, t - 1], join_left[:, t],
                                squared_joins)
        best = cost.min(dim=1, keepdim=True).values
        pruned = torch.where((eps > 0.0) & (cost > best + eps), big, cost)
        trans = pruned[:, :, None] + torch.where(
            live[:, t, None, None], jcw * dists, zero)
        backptrs.append(torch.argmin(trans, dim=1))
        cost = trans.min(dim=1).values + tc[:, t]
    total = cost.min(dim=1).values
    path = np.zeros((B, T), np.int64)
    state = torch.argmin(cost, dim=1).cpu().numpy()
    path[:, n - 1] = state
    if backptrs:
        bp = torch.stack(backptrs).cpu().numpy()          # (n - 1, B, N)
        rows = np.arange(B)
        for t in range(n - 1, 0, -1):
            state = bp[t - 1, rows, state]
            path[:, t - 1] = state
    return torch.from_numpy(path).to(dev), total


def greedy_decode_plain(target_costs, join_left, join_right, join_cost_weight=1.0,
                        length=None, squared_joins=False):
    """The plain PyTorch version of :func:`greedy_decode`."""
    B, T, N = target_costs.shape
    dev = target_costs.device
    jcw = _f32(join_cost_weight, dev)
    zero = _f32(0.0, dev)
    live = _live(B, T, length, dev)
    tc = torch.where(live[:, :, None], target_costs, zero)
    rows = torch.arange(B, device=dev)
    choice = torch.argmin(tc[:, 0], dim=1)
    ctx = join_right[rows, 0, choice]
    acc = tc[rows, 0, choice]
    path = [choice]
    for t in range(1, T):
        d = torch.clamp(torch.sum((join_left[:, t] - ctx[:, None, :]) ** 2,
                                  dim=-1), min=0.0)
        if not squared_joins:
            d = torch.sqrt(d)
        total = tc[:, t] + torch.where(live[:, t, None], jcw * d, zero)
        choice = torch.argmin(total, dim=1)
        ctx = join_right[rows, t, choice]
        acc = acc + total[rows, choice]
        path.append(choice)
    return torch.stack(path, dim=1), acc


def greedy_decode_stream_plain(target_costs, join_left, join_right, init_ctx,
                               jcw_first: float, jcw_rest: float, n_live: int,
                               squared_joins: bool = False):
    """The plain PyTorch version of :func:`greedy_decode_stream`."""
    T = target_costs.shape[0]
    ctx, w = init_ctx, jcw_first
    choices = []
    for t in range(n_live):
        d = torch.clamp(torch.sum((join_left[t] - ctx[None, :]) ** 2, dim=-1), min=0.0)
        if not squared_joins:
            d = torch.sqrt(d)
        choice = torch.argmin(target_costs[t] + w * d).reshape(1)
        ctx = join_right[t].index_select(0, choice)[0]
        choices.append(choice)
        w = jcw_rest
    path = torch.zeros(T, dtype=torch.int64, device=target_costs.device)
    if choices:
        path[:n_live] = torch.cat(choices)
    return path, ctx


# ---------------------------------------------------------------- kernels
def _kernel():
    """The kernel library with the decode entry points typed, built at first
    use (thread-safe: the preselect's lock)."""
    with cuda_topk._LOCK:
        return _bound_library()


@functools.cache
def _bound_library():
    from snickery_tpu_torch.ops._build import kernel_library
    lib = kernel_library().lib
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.snk_viterbi_decode.argtypes = [p] * 7 + [i] * 4 + [f, f] + [i] * 5 + [ctypes.c_size_t, p]
    lib.snk_greedy_decode.argtypes = [p] * 6 + [i] * 4 + [f] + [i] * 4 + [ctypes.c_size_t, p]
    lib.snk_greedy_decode_stream.argtypes = ([p] * 6 + [i] * 3 + [f, f] + [i] * 5
                                             + [ctypes.c_size_t, p])
    for name in KERNELS:
        getattr(lib, "snk_" + name).restype = ctypes.c_int
    lib.snk_decode_smem.argtypes = [i] * 7
    lib.snk_decode_smem.restype = ctypes.c_size_t
    lib.snk_decode_max_clusters.argtypes = [i] * 3 + [ctypes.c_size_t]
    lib.snk_decode_max_clusters.restype = ctypes.c_int
    return lib


def _library(kind: str, plan: DecodePlan, n: int, dj: int, T: int):
    """The kernel library, its layout of this plan checked against
    :func:`decode_smem`'s."""
    lib = _kernel()
    if lib.snk_decode_smem(_KIND[kind], n, dj, T, plan.groups, plan.ring,
                           int(plan.bp_in_smem)) != plan.smem:
        raise RuntimeError("the decode kernels' shared-memory layout is not decode_smem's")
    return lib


def _launched(name: str, err: int) -> None:
    """Raise on a refused launch, else count it."""
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError_t {err}")
    with cuda_topk._LOCK:
        cuda_topk.LAUNCH_COUNTS[name] += 1


def _device_length(length, B: int, dev):
    """``length`` as a contiguous (B,) int64 tensor on ``dev`` (None stays None)."""
    if length is None:
        return None
    return torch.as_tensor(length, device=dev).to(torch.int64).reshape(B).contiguous()


def viterbi_decode(target_costs, join_left, join_right, join_cost_weight=1.0,
                   search_epsilon=0.0, length=None, squared_joins=False, *, _cluster=None):
    """Best paths through B candidate lattices.

    ``target_costs`` (B, T, N); ``join_left``/``join_right`` (B, T, N, dj),
    normalised and sqrt-weighted, f32 and contiguous; ``length`` (B,) live
    steps (a tensor on the lattice's device) or None.  Returns (paths (B, T)
    int64 on the input device, total costs (B,)); paths are 0 at and past
    each length.  On a CUDA device one launch of ``snk_viterbi_decode``
    with nothing read back; on the CPU :func:`viterbi_decode_plain`.
    ``_cluster`` forces the cluster size (``kernel_check``'s cases only)."""
    plan = check_lattice("viterbi", target_costs, join_left, join_right, length,
                         cluster=_cluster)
    dev = target_costs.device
    if dev.type == "cpu":
        return viterbi_decode_plain(target_costs, join_left, join_right, join_cost_weight,
                                    search_epsilon, length, squared_joins)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    B, T, n = target_costs.shape
    dj = join_left.shape[-1]
    lib = _library("viterbi", plan, n, dj, T)
    lens = _device_length(length, B, dev)
    paths = torch.empty((B, T), dtype=torch.int64, device=dev)
    totals = torch.empty((B,), dtype=torch.float32, device=dev)
    scratch = None
    if not plan.bp_in_smem and T > 1:
        scratch = torch.empty((B, T - 1, n), dtype=torch.uint8, device=dev)
    with torch.cuda.device(dev):
        err = lib.snk_viterbi_decode(
            target_costs.data_ptr(), join_left.data_ptr(), join_right.data_ptr(),
            None if lens is None else lens.data_ptr(), paths.data_ptr(), totals.data_ptr(),
            None if scratch is None else scratch.data_ptr(), B, T, n, dj,
            float(join_cost_weight), float(search_epsilon), int(bool(squared_joins)),
            plan.groups, plan.ring, plan.cluster, int(plan.bp_in_smem), plan.smem,
            torch.cuda.current_stream(dev).cuda_stream)
    _launched("viterbi_decode", err)
    return paths, totals


def greedy_decode(target_costs, join_left, join_right, join_cost_weight=1.0,
                  length=None, squared_joins=False, *, _cluster=None):
    """Greedy online selection: each step picks the candidate minimising
    target + join-from-the-previous-choice.  Shapes as for
    :func:`viterbi_decode`; returns (paths (B, T) int64, total costs (B,)).
    On a CUDA device one launch of ``snk_greedy_decode``; on the CPU
    :func:`greedy_decode_plain`.  ``_cluster`` as for :func:`viterbi_decode`."""
    plan = check_lattice("greedy", target_costs, join_left, join_right, length,
                         cluster=_cluster)
    dev = target_costs.device
    if dev.type == "cpu":
        return greedy_decode_plain(target_costs, join_left, join_right, join_cost_weight,
                                   length, squared_joins)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    B, T, n = target_costs.shape
    dj = join_left.shape[-1]
    lib = _library("greedy", plan, n, dj, T)
    lens = _device_length(length, B, dev)
    paths = torch.empty((B, T), dtype=torch.int64, device=dev)
    totals = torch.empty((B,), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = lib.snk_greedy_decode(
            target_costs.data_ptr(), join_left.data_ptr(), join_right.data_ptr(),
            None if lens is None else lens.data_ptr(), paths.data_ptr(), totals.data_ptr(),
            B, T, n, dj, float(join_cost_weight), int(bool(squared_joins)), plan.groups,
            plan.ring, plan.cluster, plan.smem, torch.cuda.current_stream(dev).cuda_stream)
    _launched("greedy_decode", err)
    return paths, totals


def greedy_decode_stream(target_costs, join_left, join_right, init_ctx,
                         jcw_first: float, jcw_rest: float, n_live: int,
                         squared_joins: bool = False, *, _cluster=None):
    """Greedy selection over one streaming chunk, from an incoming join
    context (the scan of ``snickery_tpu.synth._streaming_step``).

    ``target_costs`` (T, N); ``join_left``/``join_right`` (T, N, dj);
    ``init_ctx`` (dj,) the context the previous chunk left, weighted by
    ``jcw_first`` at the first step (0 at the start of a stream, where there
    is none) and by ``jcw_rest`` after it; steps ``>= n_live`` (a host int,
    0 to T) are dead: they choose 0 and keep the context.  Nothing here
    waits on the device.  Returns (path (T,) int64, outgoing context (dj,)).
    On a CUDA device one launch of ``snk_greedy_decode_stream``; on the CPU
    :func:`greedy_decode_stream_plain`.  ``_cluster`` as for
    :func:`viterbi_decode`."""
    plan = check_lattice("greedy", target_costs, join_left, join_right, init_ctx=init_ctx,
                         cluster=_cluster)
    T, n = target_costs.shape
    if not 0 <= n_live <= T:
        raise ValueError(f"n_live {n_live} is not within 0..{T}")
    dev = target_costs.device
    if dev.type == "cpu":
        return greedy_decode_stream_plain(target_costs, join_left, join_right, init_ctx,
                                          jcw_first, jcw_rest, n_live, squared_joins)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    dj = join_left.shape[-1]
    lib = _library("greedy", plan, n, dj, T)
    path = torch.empty((T,), dtype=torch.int64, device=dev)
    ctx = torch.empty((dj,), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = lib.snk_greedy_decode_stream(
            target_costs.data_ptr(), join_left.data_ptr(), join_right.data_ptr(),
            init_ctx.data_ptr(), path.data_ptr(), ctx.data_ptr(), T, n, dj, float(jcw_first),
            float(jcw_rest), int(n_live), int(bool(squared_joins)), plan.groups, plan.ring,
            plan.cluster, plan.smem,
            torch.cuda.current_stream(dev).cuda_stream)
    _launched("greedy_decode_stream", err)
    return path, ctx

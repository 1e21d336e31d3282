"""Viterbi lattice search and greedy selection, batched over B.

Counterpart of ``snickery_tpu.ops.viterbi`` (and of the greedy scan of
``snickery_tpu.synth._streaming_step``).  Each decode is one hand-written
CUDA kernel on the card (``csrc/viterbi.cu``: one CTA an utterance, the loop
over the lattice steps and the backtrack inside it, no host synchronisation)
and its plain PyTorch version (:func:`viterbi_decode_plain`,
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
KERNELS = ("viterbi_decode", "greedy_decode", "greedy_decode_stream")
_KIND = {"viterbi": 0, "greedy": 1}


def row_stride(dj: int) -> int:
    """f32 columns of a context row staged in shared memory: ``dj`` rounded
    up to a multiple of 4 with an odd number of float4s (``csrc/viterbi.cu``
    ``row_stride``)."""
    s = -(-dj // 4) * 4
    return s + 4 if (s // 4) % 2 == 0 else s


def _align16(x: int) -> int:
    return -(-x // 16) * 16


def decode_smem(kind: str, n: int, dj: int, T: int, stages: int, bp_in_smem: bool) -> int:
    """Bytes of dynamic shared memory a decode CTA uses (``csrc/viterbi.cu``
    ``layout``): ``stages`` buffers each of join_left and join_right
    (N, :func:`row_stride`) f32, two of target costs, the Viterbi's (N, N|1)
    transition costs and N running costs (greedy: N totals and the incoming
    context), 16 bytes, and with ``bp_in_smem`` the Viterbi's (T - 1, N)
    byte backpointers."""
    viterbi = _KIND[kind] == 0
    stride = row_stride(dj)
    size = 2 * stages * _align16(n * stride * 4) + 2 * _align16(n * 4)
    size += _align16(n * (n | 1) * 4) if viterbi else _align16(n * 4)
    size += _align16(n * 4) if viterbi else _align16(stride * 4)
    size += 16
    if viterbi and bp_in_smem and T > 1:
        size += _align16((T - 1) * n)
    return size


@dataclass(frozen=True)
class DecodePlan:
    smem: int            # bytes of dynamic shared memory a CTA
    stages: int          # 2: the next step is staged while this one computes
    bp_in_smem: bool     # Viterbi backpointers in shared memory, else in global scratch


def decode_plan(kind: str, n: int, dj: int, T: int) -> DecodePlan:
    """The kernel's shared-memory plan for an (N = ``n``, ``dj``, ``T``)
    lattice, a pure function of the shape: a double buffer where it fits,
    else a single one; the Viterbi backpointers beside the buffers where
    they fit, else in device memory.  Raises ValueError where even a single
    buffer does not fit in :data:`SMEM_LIMIT`."""
    for stages in (2, 1):
        base = decode_smem(kind, n, dj, T, stages, False)
        if base > SMEM_LIMIT:
            continue
        with_bp = decode_smem(kind, n, dj, T, stages, True)
        if _KIND[kind] == 0 and with_bp <= SMEM_LIMIT:
            return DecodePlan(with_bp, stages, True)
        return DecodePlan(base, stages, False)
    raise ValueError(f"a {kind} decode of N={n} candidates x dj={dj} needs "
                     f"{decode_smem(kind, n, dj, T, 1, False)} bytes of shared memory, "
                     f"more than the {SMEM_LIMIT} a block has")


def check_lattice(kind: str, target_costs, join_left, join_right, length=None,
                  init_ctx=None) -> DecodePlan:
    """Refuse what the kernels do not take, on any device: f32 costs and
    contexts, contiguous, on one device, of matching shapes, N <= 255, a
    shared-memory plan that fits (:func:`decode_plan`, returned), and
    ``length`` (a tensor) an integer vector on the same device."""
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
    return decode_plan(kind, n, join_left.shape[-1], target_costs.shape[-2])


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
    lib.snk_viterbi_decode.argtypes = [p] * 7 + [i] * 4 + [f, f] + [i] * 3 + [ctypes.c_size_t, p]
    lib.snk_greedy_decode.argtypes = [p] * 6 + [i] * 4 + [f] + [i] * 2 + [ctypes.c_size_t, p]
    lib.snk_greedy_decode_stream.argtypes = ([p] * 6 + [i] * 3 + [f, f] + [i] * 3
                                             + [ctypes.c_size_t, p])
    for name in KERNELS:
        getattr(lib, "snk_" + name).restype = ctypes.c_int
    lib.snk_decode_smem.argtypes = [i] * 6
    lib.snk_decode_smem.restype = ctypes.c_size_t
    return lib


def _library(kind: str, plan: DecodePlan, n: int, dj: int, T: int):
    """The kernel library, its layout of this plan checked against
    :func:`decode_smem`'s."""
    lib = _kernel()
    if lib.snk_decode_smem(_KIND[kind], n, dj, T, plan.stages, int(plan.bp_in_smem)) != plan.smem:
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
                   search_epsilon=0.0, length=None, squared_joins=False):
    """Best paths through B candidate lattices.

    ``target_costs`` (B, T, N); ``join_left``/``join_right`` (B, T, N, dj),
    normalised and sqrt-weighted, f32 and contiguous; ``length`` (B,) live
    steps (a tensor on the lattice's device) or None.  Returns (paths (B, T)
    int64 on the input device, total costs (B,)); paths are 0 at and past
    each length.  On a CUDA device one launch of ``snk_viterbi_decode``
    with nothing read back; on the CPU :func:`viterbi_decode_plain`."""
    plan = check_lattice("viterbi", target_costs, join_left, join_right, length)
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
            plan.stages, int(plan.bp_in_smem), plan.smem,
            torch.cuda.current_stream(dev).cuda_stream)
    _launched("viterbi_decode", err)
    return paths, totals


def greedy_decode(target_costs, join_left, join_right, join_cost_weight=1.0,
                  length=None, squared_joins=False):
    """Greedy online selection: each step picks the candidate minimising
    target + join-from-the-previous-choice.  Shapes as for
    :func:`viterbi_decode`; returns (paths (B, T) int64, total costs (B,)).
    On a CUDA device one launch of ``snk_greedy_decode``; on the CPU
    :func:`greedy_decode_plain`."""
    plan = check_lattice("greedy", target_costs, join_left, join_right, length)
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
            B, T, n, dj, float(join_cost_weight), int(bool(squared_joins)), plan.stages,
            plan.smem, torch.cuda.current_stream(dev).cuda_stream)
    _launched("greedy_decode", err)
    return paths, totals


def greedy_decode_stream(target_costs, join_left, join_right, init_ctx,
                         jcw_first: float, jcw_rest: float, n_live: int,
                         squared_joins: bool = False):
    """Greedy selection over one streaming chunk, from an incoming join
    context (the scan of ``snickery_tpu.synth._streaming_step``).

    ``target_costs`` (T, N); ``join_left``/``join_right`` (T, N, dj);
    ``init_ctx`` (dj,) the context the previous chunk left, weighted by
    ``jcw_first`` at the first step (0 at the start of a stream, where there
    is none) and by ``jcw_rest`` after it; steps ``>= n_live`` (a host int,
    0 to T) are dead: they choose 0 and keep the context.  Nothing here
    waits on the device.  Returns (path (T,) int64, outgoing context (dj,)).
    On a CUDA device one launch of ``snk_greedy_decode_stream``; on the CPU
    :func:`greedy_decode_stream_plain`."""
    plan = check_lattice("greedy", target_costs, join_left, join_right, init_ctx=init_ctx)
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
            float(jcw_rest), int(n_live), int(bool(squared_joins)), plan.stages, plan.smem,
            torch.cuda.current_stream(dev).cuda_stream)
    _launched("greedy_decode_stream", err)
    return path, ctx

"""Viterbi lattice search and greedy selection in PyTorch, batched over B.

Counterpart of ``snickery_tpu.ops.viterbi``: the JAX ``vmap`` becomes the
leading batch dimension and the ``lax.scan`` a Python loop over the steps.
Each step is an (N, N, dj) difference reduction plus an (N, N) min
reduction.  Semantics carried over unchanged:

- total = sum_t target_cost + jcw * sum_t join_dist (weighted Euclidean, or
  squared with ``squared_joins``);
- epsilon pruning: states more than ``search_epsilon`` above the running
  best leave the transition competition (BIG_PENALTY);
- first-minimum backpointers (``torch.argmin`` returns the first minimum);
- steps at or beyond ``length`` are dead: zero target and join cost.

Padding invariance lets the loop stop at the longest live length of the
batch: past it every state carries the best cost and the JAX scan's path is
0, which is what is returned there.

:func:`greedy_decode_stream` is the streaming form: one chunk, a join
context carried in and out, its live length a host int.
"""

from __future__ import annotations

import numpy as np
import torch

from snickery_tpu.const import BIG_PENALTY


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
    summed from the differences: a natural join (bit-equal contexts) costs
    exactly 0, where the ``|r|^2 + |l|^2 - 2 r.l`` identity of the JAX
    version leaves f32 cancellation noise (about 2e-3 per join on the toy
    voice)."""
    diff = right[:, :, None, :] - left[:, None, :, :]
    sq = torch.sum(diff * diff, dim=-1)
    return sq if squared else torch.sqrt(sq)


def viterbi_decode(target_costs, join_left, join_right, join_cost_weight=1.0,
                   search_epsilon=0.0, length=None, squared_joins=False):
    """Best paths through B candidate lattices.

    ``target_costs`` (B, T, N); ``join_left``/``join_right`` (B, T, N, dj),
    normalised and sqrt-weighted; ``length`` (B,) live steps or None.
    Returns (paths (B, T) int64 on the input device, total costs (B,))."""
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


def greedy_decode(target_costs, join_left, join_right, join_cost_weight=1.0,
                  length=None, squared_joins=False):
    """Greedy online selection: each step picks the candidate minimising
    target + join-from-the-previous-choice.  Shapes as for
    :func:`viterbi_decode`; returns (paths (B, T) int64, total costs (B,))."""
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


def greedy_decode_stream(target_costs, join_left, join_right, init_ctx,
                         jcw_first: float, jcw_rest: float, n_live: int,
                         squared_joins: bool = False):
    """Greedy selection over one streaming chunk, from an incoming join
    context (the scan of ``snickery_tpu.synth._streaming_step``).

    ``target_costs`` (T, N); ``join_left``/``join_right`` (T, N, dj);
    ``init_ctx`` (dj,) the context the previous chunk left, weighted by
    ``jcw_first`` at the first step (0 at the start of a stream, where there
    is none) and by ``jcw_rest`` after it; steps ``>= n_live`` (a host int)
    are dead: they choose 0 and keep the context.  Nothing here waits on the
    device.  Returns (path (T,) int64, outgoing context (dj,))."""
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

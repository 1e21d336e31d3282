"""The decode kernels on a CUDA card (``csrc/viterbi.cu``): each case of
``kernel_check.DECODE_CASES`` through the public wrapper, twice
(bit-identical) and against the plain version (``judge_decode``: paths
equal or float64 near-ties, totals rtol 1e-5, natural joins 0.0, ties to
the lowest index); each case at every forced cluster size of
``kernel_check.DECODE_CLUSTERS``, bit-equal to the default plan's result;
and one Viterbi and one streamed chunk under
``torch.cuda.set_sync_debug_mode("error")``.

Marked ``cuda``; each test skips where no card is visible.  This file
imports no jax:

    python -m pytest -m cuda --noconftest -p no:cacheprovider tests/test_torch_cuda_decode.py
"""

import pytest
import torch

from snickery_tpu_torch.kernel_check import (DECODE_CASES, DECODE_CLUSTERS, decode_lattice,
                                             judge_decode, run_decode, run_decode_case)
from snickery_tpu_torch.ops import cuda_topk


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run this file on the GPU host)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(DECODE_CASES))
def test_decode_kernel_matches_plain(cuda_device, name):
    run_decode_case(name, cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("cluster", DECODE_CLUSTERS)
@pytest.mark.parametrize("name", list(DECODE_CASES))
def test_decode_kernel_cluster_sizes_agree(cuda_device, name, cluster):
    """The result does not depend on the cluster size: each distance is
    summed by one thread or one warp in one fixed order, whichever CTA makes
    its table."""
    lat = decode_lattice(name, cuda_device)
    want = run_decode(lat)
    got = run_decode(lat, cluster=cluster)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["viterbi_ragged", "greedy_ragged", "stream_carry"])
def test_decode_kernel_launches_once_without_sync(cuda_device, name):
    """One launch a decode, counted under its name, and no host
    synchronisation inside the call."""
    lat = decode_lattice(name, cuda_device)
    run_decode(lat)                          # the library is built outside the check
    torch.cuda.synchronize()
    cuda_topk.LAUNCH_COUNTS.clear()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = run_decode(lat)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    kernel = {"viterbi": "viterbi_decode", "greedy": "greedy_decode",
              "stream": "greedy_decode_stream"}[lat["kind"]]
    assert dict(cuda_topk.LAUNCH_COUNTS) == {kernel: 1}
    judge_decode(lat, got, run_decode(lat, plain=True))

"""Where a decode kernel's cycles go: clock64 counters in a copy of
``csrc/viterbi.cu``, built on its own and run at the ``kernel_ab`` decode
shapes.

    python -m snickery_tpu_torch.decode_profile [--only CASES] [--out FILE]

The copy gets counters (:data:`PATCHES`, each anchored on one line of the
source; a missing anchor stops the tool) that add up, in registers, and
write once at the end of the kernel: for each producer group's leader the
cycles a table spends waiting for its staged contexts, making the table,
and handing it over (the wait for its ring slot included); for the
recursion the cycles a step takes and how many of them it waits for its
table.  The copy is built into ``build/decode_profile/`` (this process's
kernel library is the copy: run the tool in a process of its own) and
driven through the public wrappers on :func:`kernel_ab.decode_lattice`'s
lattices.  One JSON line a case: the event time of the counted launch, the
plan, cycles a table and a step, and how many clusters of each size (at
that size's plan) the card holds at once.  Needs a CUDA card; the counters cost time,
so the times are not the kernels' (``kernel_ab`` has those).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import sys
from pathlib import Path

import numpy as np
import torch

from snickery_tpu_torch.ops import _build

PACKAGE = Path(__file__).resolve().parent
SOURCE = PACKAGE / "csrc" / "viterbi.cu"
OUT_DIR = PACKAGE.parent / "build" / "decode_profile"
SLOTS = 1024          # counter rows: 4 a CTA (a producer group each; the recursion in row 3)
CASES = ("decode_viterbi_config3", "decode_greedy_config3", "decode_viterbi_single",
         "decode_stream_chunk")

# (anchor, replacement): each anchor must occur once in csrc/viterbi.cu
PATCHES = (
    ("namespace {\n\nconstexpr int PRODUCER_WARPS",
     "__device__ unsigned long long g_prof[1024][8];\nnamespace {\n\nconstexpr int PRODUCER_WARPS"),
    ("  int idx = 0;\n  for (int u = first; u < n_tables; u += step, ++idx) {\n"
     "    if (gt == 0) bulk_wait_read<0>();",
     "  int idx = 0;\n  long long P0 = 0, P1 = 0, P2 = 0, P3 = 0;\n"
     "  for (int u = first; u < n_tables; u += step, ++idx) {\n    long long ta = clock64();\n"
     "    if (gt == 0) bulk_wait_read<0>();"),
    ("    named_sync(BAR_GROUP + g, GROUP_THREADS);    // table u staged; the out slot free\n",
     "    named_sync(BAR_GROUP + g, GROUP_THREADS);    // table u staged; the out slot free\n"
     "    long long tb = clock64();\n"),
    ("    fence_proxy_async();\n    named_sync(BAR_GROUP + g, GROUP_THREADS);",
     "    long long tc0 = clock64();\n    fence_proxy_async();\n"
     "    named_sync(BAR_GROUP + g, GROUP_THREADS);"),
    ("                full0 + 8 * s);\n    }\n",
     "                full0 + 8 * s);\n    }\n    long long td = clock64();\n"
     "    P0 += tb - ta; P1 += tc0 - tb; P2 += td - tc0; P3 += 1;\n"),
    ("  if (gt == 0) bulk_wait_read<0>();\n}\n",
     "  if (gt == 0) bulk_wait_read<0>();\n  if (gt == 0) {\n"
     "    unsigned long long* G = g_prof[blockIdx.x * 4 + g];\n"
     "    G[0] += P0; G[1] += P1; G[2] += P2; G[3] += P3;\n  }\n}\n"),
    ("    for (int t = 1; t < live; ++t) {\n      const int u = t - 1;\n",
     "    long long c0 = clock64(), A0 = 0;\n    for (int t = 1; t < live; ++t) {\n"
     "      const int u = t - 1;\n"),
    ("      mbar_wait(full + s, lap);\n      if (valid) {\n",
     "      long long w0 = clock64();\n      mbar_wait(full + s, lap);\n"
     "      A0 += clock64() - w0;\n      if (valid) {\n"),
    ("    float* sc = scost + (live & 1) * nr;\n",
     "    if (rtid == 0) {\n      unsigned long long* G = g_prof[blockIdx.x * 4 + 3];\n"
     "      G[4] += clock64() - c0; G[5] += A0; G[6] += live - 1;\n    }\n"
     "    float* sc = scost + (live & 1) * nr;\n"),
    ("    float acc = 0.0f;                    // lane 0's running total\n",
     "    float acc = 0.0f;                    // lane 0's running total\n"
     "    long long c0 = clock64(), A0 = 0;\n"),
    ("        const int u = t - first_step;\n        mbar_wait(full + s, lap);\n",
     "        const int u = t - first_step;\n        long long w0 = clock64();\n"
     "        mbar_wait(full + s, lap);\n        A0 += clock64() - w0;\n"),
    ("    for (int t = live + lane; t < t_steps; t += 32) path[t] = 0;\n",
     "    if (lane == 0) {\n      unsigned long long* G = g_prof[blockIdx.x * 4 + 3];\n"
     "      G[4] += clock64() - c0; G[5] += A0; G[6] += live;\n    }\n"
     "    for (int t = live + lane; t < t_steps; t += 32) path[t] = 0;\n"),
)
READER = ('\nextern "C" int snk_decode_profile(void* host, int clear) {\n'
          '  static unsigned long long zero[1024][8];\n'
          '  if (clear) return static_cast<int>(cudaMemcpyToSymbol(g_prof, zero, sizeof(zero)));\n'
          '  return static_cast<int>(cudaMemcpyFromSymbol(host, g_prof, sizeof(zero)));\n}\n')


def patched_source(text: str) -> str:
    """``text`` (csrc/viterbi.cu) with the counters in; raises ValueError
    where an anchor is missing or not unique."""
    for anchor, replacement in PATCHES:
        if text.count(anchor) != 1:
            raise ValueError(f"decode_profile: anchor found {text.count(anchor)} times: "
                             f"{anchor.splitlines()[0]!r}")
        text = text.replace(anchor, replacement)
    return text + READER


def build():
    """The counting copy built as this process's kernel library."""
    src = OUT_DIR / "src"
    src.mkdir(parents=True, exist_ok=True)
    (src / "viterbi.cu").write_text(patched_source(SOURCE.read_text()))
    _build.CSRC_DIR, _build.BUILD_DIR = src, OUT_DIR / "lib"
    lib = _build.kernel_library().lib
    lib.snk_decode_profile.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.snk_decode_profile.restype = ctypes.c_int
    return lib


def profile_case(lib, name: str, dev) -> dict:
    """One counted launch of a ``kernel_ab`` decode case after a warm-up."""
    from snickery_tpu_torch import kernel_ab
    from snickery_tpu_torch.ops import viterbi as vit
    lat = kernel_ab.decode_lattice(name, dev)
    call = kernel_ab.decode_call(lat)
    if lat["kind"] == "stream":
        plan = vit.check_lattice("greedy", lat["tc"], lat["jl"], lat["jr"],
                                 init_ctx=lat["init_ctx"])
    else:
        plan = vit.check_lattice(lat["kind"], lat["tc"], lat["jl"], lat["jr"], lat["length"])
    call()
    torch.cuda.synchronize()
    counts = np.zeros((SLOTS, 8), np.uint64)
    if lib.snk_decode_profile(None, 1) != 0:
        raise RuntimeError("decode_profile: clearing the counters failed")
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    call()
    stop.record()
    torch.cuda.synchronize()
    if lib.snk_decode_profile(counts.ctypes.data, 0) != 0:
        raise RuntimeError("decode_profile: reading the counters failed")
    index = torch.cuda.current_device()
    code = 2 if lat["kind"] == "stream" else vit._KIND[lat["kind"]]
    kind = "greedy" if lat["kind"] == "stream" else lat["kind"]
    n, dj, T = lat["tc"].shape[-1], lat["jl"].shape[-1], lat["tc"].shape[-2]
    held = {c: vit._max_clusters(index, code, n, c, vit._plan_at(kind, n, dj, T, c).smem)
            for c in range(1, vit.MAX_CLUSTER + 1)}
    g = counts.astype(np.float64)
    tables = g[:, 3].sum()
    per_table = g[:, :3].sum(0) / max(tables, 1.0)
    steps = g[:, 6].sum()
    return {"case": name, "ms": start.elapsed_time(stop), "cluster": plan.cluster,
            "groups": plan.groups, "ring": plan.ring, "tables": int(tables),
            "table_stage_wait_cycles": float(per_table[0]),
            "table_make_cycles": float(per_table[1]),
            "table_hand_off_cycles": float(per_table[2]), "steps": int(steps),
            "step_cycles": float(g[:, 4].sum() / max(steps, 1.0)),
            "step_wait_cycles": float(g[:, 5].sum() / max(steps, 1.0)),
            "clusters_held": held}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", default="", help="comma list of kernel_ab decode cases")
    ap.add_argument("--out", default="", help="also append the JSON lines to this file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("decode_profile: no CUDA device", file=sys.stderr)
        return 2
    from snickery_tpu_torch import kernel_ab
    names = [n for n in filter(None, args.only.split(","))] or list(CASES)
    unknown = set(names) - set(kernel_ab.DECODE_AB_CASES)
    if unknown:
        ap.error(f"unknown cases {sorted(unknown)}")
    lib = build()
    card = kernel_ab.card_line()
    for name in names:
        line = dict(profile_case(lib, name, torch.device("cuda")), card=card)
        print(json.dumps(line), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())

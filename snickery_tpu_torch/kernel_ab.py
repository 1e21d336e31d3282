"""Times and checksums of the stream preselect kernels at the main-path
shapes, for comparing two trees of this package on one card in one run.

    python -m snickery_tpu_torch.kernel_ab [--label NAME] [--reps 3] [--out FILE]

The data are the kernel sweep's (:func:`sweep_topk.make_data`: AR(1) rows,
d 151, seed 0), so two trees see the same tensors.  Cases, all
``select="stream"``, no mask:

- 65,536 targets x 1,048,576 units (the config-3 batch shape): the
  zero-transient kernel at "highest" (k 40) and "split3cat" (k 48), the
  derived-operand kernel at "highest" (k 30) and "split3cat" (k 48);
- 64 targets x 1,048,576 units (a config-4 chunk): both "split3cat" forms;
- 2,048 targets x 8,388,608 units (the capacity shape, the block tiled x8
  on the card): the zero-transient kernel at "split3" (k 40).

Each case prints one JSON line: the median of ``--reps`` timed launches
(CUDA events, after a warm-up) and the SHA-256 of the returned ids and of
the returned scores (bytes of the contiguous host copies).  At "highest"
every score is one ascending chain of ``fmaf`` and the selection is exact,
so two trees must print the same digests; at a split precision the tensor
cores' summation order may differ between designs and the digests are a
record, not a gate.  To compare with an older tree, copy this file into
that tree's package and run it there (``--label parent``), in the same
command as the run on this tree.  Needs a CUDA card.

:data:`FIRST_DESIGN_DIGESTS` records what the first design of the kernels
(64 x 64 tiles, a dense selection after every tile) printed for the two
"highest" cases on an NVIDIA H100 80GB HBM3; ``chip_smoke.py`` prints
today's beside them.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import sys

import torch

from snickery_tpu_torch import sweep_topk
from snickery_tpu_torch.ops.cuda_topk import cuda_topk_preselect, derive_operand

KD = 151
UNITS = 1 << 20
CASES = (  # (name, T, tiles of the block, zero_transient, precision, k)
    ("zt_highest", 65536, 1, True, "highest", 40),
    ("dv_highest", 65536, 1, False, "highest", 30),
    ("zt_split3cat", 65536, 1, True, "split3cat", 48),
    ("dv_split3cat", 65536, 1, False, "split3cat", 48),
    ("zt_split3cat_chunk", 64, 1, True, "split3cat", 48),
    ("dv_split3cat_chunk", 64, 1, False, "split3cat", 48),
    ("zt_split3_capacity", 2048, 8, True, "split3", 40),
)
# case: (ids_sha256, scores_sha256) of the first design
FIRST_DESIGN_DIGESTS = {"zt_highest": ("42687863318a6959", "c62f05eb8d61ae14"),
                        "dv_highest": ("8daee431bb4b3206", "0a6414f3590d49e4")}


def digest(t: torch.Tensor) -> str:
    return hashlib.sha256(t.contiguous().cpu().numpy().tobytes()).hexdigest()[:16]


def run_cases(label: str = "change", reps: int = 3, only=()) -> list[dict]:
    """Time and digest the cases named in ``only`` (all if empty) on the
    current CUDA device; one dict a case (the JSON lines of the module)."""
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    tg_np, raw_np, aff_np = sweep_topk.make_data(65536, UNITS, KD, 0, 0, False)
    tg, raw = torch.from_numpy(tg_np).to(dev), torch.from_numpy(raw_np).to(dev)
    aff = tuple(torch.from_numpy(a).to(dev) for a in aff_np)
    lines = []
    for name, T, tiles, zt, precision, k in CASES:
        if only and name not in only:
            continue
        block = raw if tiles == 1 else raw.repeat(tiles, 1)
        m_rows = block.shape[0]
        x = tg[:T].contiguous()
        if zt:
            kw = dict(db_affine=aff)
        else:
            block, sqn = derive_operand(block, aff, m_rows, m_rows, precision)
            kw = dict(db_affine=None, zero_transient=False, sqn=sqn)

        def call():
            return cuda_topk_preselect(x, block, k, m_rows=m_rows, precision=precision, **kw)

        ms, (ids, scores) = sweep_topk.time_call(call, reps, dev)
        lines.append({"label": label, "case": name, "T": T, "m_rows": m_rows, "kd": KD, "k": k,
                      "precision": precision, "ms": ms, "ids_sha256": digest(ids),
                      "scores_sha256": digest(scores), "card": card})
        del block, kw
        torch.cuda.empty_cache()
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--label", default="change")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--only", default="", help="comma list of case names (default: all)")
    ap.add_argument("--out", default="", help="also append the JSON lines to this file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    for line in run_cases(args.label, args.reps, set(filter(None, args.only.split(",")))):
        print(json.dumps(line), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())

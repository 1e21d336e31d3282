"""One sharded synthesis step on an n-member mesh, as a quick check that the
mesh path runs (counterpart of ``__graft_entry__.dryrun_multichip``).

    python -m snickery_tpu_torch.parallel.dryrun [--devices N] [--device cuda|cuda:I|cpu]

The shapes are the JAX dry run's: a synthetic voice of 131,072 units of
d = 32 with utterance-like join-right exceptions, an (N/2) x 2 (data x db)
mesh, a batch of max(8, N) utterances of 512 units, n_candidates 8.  It
runs :func:`sharded_norm_stats` and one :func:`batched_synth_step` and
checks that every DB shard contributed selected units.  ``--device cuda``
(the default) takes cards 0..N-1 and raises where there are fewer;
``--device cuda:0`` repeats card 0 N times, ``--device cpu`` the CPU (the
kernel's plain twin), as the tests do.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from snickery_tpu_torch import utils
from snickery_tpu_torch.parallel.mesh import make_mesh
from snickery_tpu_torch.parallel.sharded import (batched_synth_step, shard_voice,
                                                 sharded_norm_stats)
from snickery_tpu_torch.voicedb.device_layout import build_raw_blocks


def synthetic_voice(m_units: int, d: int, seed: int = 0):
    """Random, self-consistent DB arrays (a copy of
    ``__graft_entry__._synthetic_voice``): ``jr`` is the next unit's first
    frame, with an irregular row every 50 units standing in for utterance
    boundaries, so the jr-exception layout is exercised.  Returns (feats,
    jr, cut1, cut2, waves, mean, std, sqrt_w)."""
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((m_units, d), dtype=np.float32)
    jr = np.empty((m_units, d), np.float32)
    jr[:-1] = feats[1:]
    jr[-1] = rng.standard_normal(d).astype(np.float32)
    bnd = np.arange(49, m_units, 50)
    jr[bnd] = rng.standard_normal((len(bnd), d)).astype(np.float32)
    span = 160
    cut1 = (np.arange(m_units, dtype=np.int64) % 4096) * 8 + span
    cut2 = cut1 + span
    waves = rng.standard_normal(int(cut2.max() + 4 * span), dtype=np.float32) * np.float32(0.1)
    mean, std, sqrt_w = (np.zeros(d, np.float32), np.ones(d, np.float32),
                         np.ones(d, np.float32))
    return feats, jr, cut1.astype(np.int32), cut2.astype(np.int32), waves, mean, std, sqrt_w


def dryrun_multichip(n_devices: int, device: str = "cuda") -> dict:
    """Run the norm stats and one sharded step on an (n/2) x 2 mesh (n x 1
    for odd n) of ``n_devices`` members: cards 0..n-1 for "cuda", else
    ``device`` ("cpu", "cuda:0") repeated.  Returns what it checked (mesh,
    units, batch, the shards the selected units came from)."""
    n_db = 2 if n_devices % 2 == 0 and n_devices > 1 else 1
    n_data = n_devices // n_db
    devices = None if device == "cuda" else [device] * n_devices
    mesh = make_mesh(n_data, n_db, devices=devices)

    d, n_cand, chunk, taper, t = 32, 8, 4096, 32, 512
    m = utils.next_multiple(131_072, chunk * n_db)
    b = max(8, n_data * n_db)
    b += (-b) % (n_data * n_db)
    feats, jr, cut1, cut2, waves, mean, std, sqrt_w = synthetic_voice(m, d)
    blocks, _, _ = build_raw_blocks(feats, jr, m, ndb=n_db, affine=(mean, std, sqrt_w))
    voice = shard_voice(mesh, blocks, cut1, cut2, waves, mean, std, sqrt_w,
                        mean, std, sqrt_w, n_real=m)

    mean_s, std_s = sharded_norm_stats(feats, m, mesh=mesh)
    if not (torch.isfinite(mean_s).all() and torch.isfinite(std_s).all()):
        raise AssertionError("norm stats are not finite")

    rng = np.random.default_rng(2)
    first = mesh.devices[0][0]
    targets = torch.from_numpy(rng.standard_normal((b, t, d)).astype(np.float32)).to(first)
    lengths = torch.full((b,), t - 3, dtype=torch.int64, device=first)
    out_len = utils.next_multiple(t * 160 + 2 * taper, 128)
    unit_ids, costs, audio, totals = batched_synth_step(
        voice, targets, lengths, 0.7, 0.0, mesh=mesh, n_cand=n_cand, max_frag=512,
        out_len=out_len, taper=taper)
    unit_ids = unit_ids.cpu().numpy()
    if unit_ids.shape != (b, t) or not ((unit_ids >= 0) & (unit_ids < m)).all():
        raise AssertionError(f"unit ids of shape {unit_ids.shape} or out of range")
    if not (torch.isfinite(costs).all() and torch.isfinite(audio).all()):
        raise AssertionError("costs or audio are not finite")
    hit = sorted({int(u) // (m // n_db) for u in unit_ids[:, :t - 3].reshape(-1)})
    if len(hit) != n_db:
        raise AssertionError(f"only shards {hit} selected from")
    print(f"dryrun_multichip ok: mesh={n_data}x{n_db} on {[str(x) for x in mesh.distinct()]} "
          f"units={m} batch={b} T={t}", flush=True)
    return {"mesh": (n_data, n_db), "units": m, "batch": b, "shards_hit": hit}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--devices", type=int, default=0,
                    help="mesh members (default: every card for cuda, 8 for cpu)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (cards 0..N-1), or one device to repeat: cuda:I, cpu")
    args = ap.parse_args(argv)
    n = args.devices or (torch.cuda.device_count() if args.device == "cuda" else 8)
    dryrun_multichip(n, args.device)


if __name__ == "__main__":
    main()

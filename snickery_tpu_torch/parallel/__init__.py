"""Multi-device scale-out of the port: mesh, sharded DB search, batched
synthesis (counterpart of ``snickery_tpu.parallel``).

Unit DBs row-sharded over the ``db`` axis of a (data, db) mesh of torch
devices, a local top-k preselect per shard with the hand-written kernel,
the candidates exchanged between the shards of a data slice, and
data-parallel batched synthesis over utterances (BASELINE.json configs
#3 / #5).  One process drives every member.
"""

from snickery_tpu_torch.parallel.mesh import Mesh, make_mesh
from snickery_tpu_torch.parallel.sharded import (
    ShardedVoice,
    batched_synth_step,
    shard_voice,
    sharded_norm_stats,
)

__all__ = [
    "make_mesh",
    "Mesh",
    "ShardedVoice",
    "shard_voice",
    "batched_synth_step",
    "sharded_norm_stats",
]

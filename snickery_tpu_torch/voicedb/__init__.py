"""Voice database of the port: the ``.voicedb`` directory format
(:mod:`~snickery_tpu_torch.voicedb.db`), the builder and the multi-voice
merge (copies of ``snickery_tpu.voicedb``, same formats and numerics), and
the raw-block device layout in PyTorch."""

"""Device half of the voice DB layout (the host half is shared with
``snickery_tpu.voicedb``)."""

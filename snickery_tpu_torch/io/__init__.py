"""I/O of the port: headerless float streams, wav, HTS labels (copies of
``snickery_tpu.io.speech`` and ``snickery_tpu.io.labels``)."""

from snickery_tpu_torch.io.labels import halfphone_segments, read_hts_label
from snickery_tpu_torch.io.speech import get_speech, put_speech, read_wave, write_wave

__all__ = [
    "get_speech",
    "put_speech",
    "read_wave",
    "write_wave",
    "read_hts_label",
    "halfphone_segments",
]

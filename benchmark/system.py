"""The system under test: the port's ``VoiceDB`` built from the benchmark's
utterance arrays through its public builder (one voice, or several merged),
and its ``Synthesiser`` on the device.  The only module of the benchmark
that builds the program; the entries drive what it returns."""

from __future__ import annotations

import time

import numpy as np


def synth_config(config: dict):
    from snickery_tpu_torch.config import SnickeryConfig
    return SnickeryConfig(**config["synth"])


def build(config: dict, voices: list, device, log):
    """The ``Synthesiser`` of ``voices`` (lists of utterance dicts) on
    ``device``, with the configuration's ``synth`` keys."""
    from snickery_tpu_torch.synth import Synthesiser
    from snickery_tpu_torch.voicedb.build import UtteranceData, build_voicedb
    from snickery_tpu_torch.voicedb.multivoice import merge_voicedbs

    cfg = synth_config(config)
    t0 = time.perf_counter()
    dbs = [build_voicedb(cfg, [UtteranceData(basename=f"v{v}u{i:05d}", wave=u["wave"],
                                             epochs=np.asarray(u["epochs"], np.int32),
                                             features=u["features"],
                                             lf0=np.ascontiguousarray(u["features"][:, -1]))
                               for i, u in enumerate(utts)])
           for v, utts in enumerate(voices)]
    db = dbs[0] if len(dbs) == 1 else merge_voicedbs(dbs, [f"voice{v}" for v in range(len(dbs))])
    del dbs
    t1 = time.perf_counter()
    log(f"setup voicedb: {db.n_units} units, {t1 - t0:.2f} s")
    synth = Synthesiser(cfg, db=db, device=device)
    log(f"setup device db: {synth.n_units_padded} rows, {time.perf_counter() - t1:.2f} s")
    return synth

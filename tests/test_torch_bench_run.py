"""The port's bench end to end on the CPU: all ten modes in one run at
``--quick`` shapes, cut further through the bench's own flags, then the
epoch mode's voice and targets through the JAX ``Synthesiser``.

The kernels' plain twins run here (``--device cpu``), so the gates read
exact agreement: tie-adjusted 1.0 and a path-cost gap within 1e-5 against
the float64 oracle.
"""

import contextlib
import io
import json

import numpy as np
import pytest
import torch

from snickery_tpu.config import SnickeryConfig as JaxConfig
from snickery_tpu.synth import Synthesiser as JaxSynthesiser
from snickery_tpu.voicedb.db import VoiceDB as JaxVoiceDB
from snickery_tpu_torch import bench as tbench
from snickery_tpu_torch.synth import Synthesiser
from snickery_tpu_torch.voicedb.db import VoiceDB
from tests.test_torch_synth import _assert_same

BATCH = 2
ARGV = ["--device", "cpu", "--quick", "--batch", str(BATCH), "--iters", "5",
        "--oracle-rows", "96", "--cap-tile", "2", "--stream-chunk", "64", "--budget-sec", "0"]
BLOCKS = ("config3", "kernel_vs_twin", "config4", "config4_natural", "config3_me2",
          "capacity", "config2", "config5", "config1", "config_48k", "quality_trend")


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    root = tmp_path_factory.mktemp("bench")
    cache, out, prof = root / "cache", root / "out.json", root / "profile"
    stdout = io.StringIO()
    with contextlib.redirect_stdout(stdout):
        rc = tbench.main([*ARGV, "--cache-dir", str(cache), "--out", str(out),
                          "--profile", str(prof)])
    lines = stdout.getvalue().strip().splitlines()
    return rc, json.loads(lines[-1]), json.loads(out.read_text()), cache


def test_all_ten_modes_run_with_their_gates(run):
    rc, line, full, _ = run
    extra = full["extra"]
    assert rc == 0, {k: v for k, v in extra.items() if k.endswith("_error")}
    assert "errors" not in line["extra"] and "skipped" not in line["extra"]
    for block in BLOCKS:
        assert block in extra, block
    assert sorted(extra["mode_sec"]) == sorted(tbench.MODES)
    assert line["value"] == pytest.approx(extra["config3"]["rtf"])
    for block in ("config3", "config3_me2"):
        b = extra[block]
        assert b["agreement_tie_adjusted"] == 1.0, block
        assert abs(b["oracle_path_cost_gap_rel"]) <= 1e-5, block
        assert b["agreement_vs_f32_tie_adjusted"] == 1.0, block
        assert len(b["step_ms"]) == 5 and b["ms_per_step"] == np.median(b["step_ms"])
        assert b["ms_per_step_min"] <= b["ms_per_step"] <= b["ms_per_step_max"]
        assert line["extra"][block]["agreement_tie_adjusted"] == 1.0
    assert extra["kernel_vs_twin"] is True and line["extra"]["kernel_vs_twin"] is True
    assert [c["case"] for c in extra["kernel_check"]["cases"]] == [
        "random_highest", "random_split3cat", "config3_batch"]
    me2_kernel = extra["config3_me2"]["kernel_at_shape"]
    assert me2_kernel["kd"] == 302 and me2_kernel["max_abs_err"] == 0.0
    assert extra["config3_me2"]["inventory"] == "derived_from_benchq"
    assert extra["capacity"]["agreement_tie_adjusted"] == 1.0
    assert extra["capacity"]["n_units"] == 2 * extra["config3"]["n_units"]
    assert extra["config2"]["agreement_vs_f64_oracle"] == 1.0
    assert extra["config2"]["halfphone_identity_match"] == 1.0
    assert extra["config5"]["cross_voice_leaks"] == 0
    assert extra["config_48k"]["agreement_tie_adjusted"] == 1.0
    assert [r["voice"] for r in extra["quality_trend"]] == ["benchtoy", "benchmidq", "benchq"]
    for key in ("chunk_latency_p50_ms", "device_ms", "rtt_ms", "payload_fetch_ms",
                "quality_vs_viterbi"):
        assert key in extra["config4"], key
    # on the CPU nothing launches, and the profiler sees no device
    assert extra["config3"]["launches_per_step"] == {}
    assert extra["config3"]["profile"]["device_busy_share"] is None
    assert line["extra"]["detail"].endswith("out.json")


def test_epoch_targets_through_the_jax_synthesiser(run, monkeypatch):
    """B=2 x T=64 of the epoch mode's held-out targets on its saved voice:
    the port's ``synth_batch`` gives the JAX ``Synthesiser``'s ids, audio and
    costs (as tests/test_torch_synth.py judges ``synth_batch``)."""
    _, _, full, cache = run
    monkeypatch.setitem(tbench._STATE, "device", torch.device("cpu"))
    monkeypatch.setitem(tbench._STATE, "cache", str(cache))
    feats, _, _ = tbench.held_out_features(BATCH, 16)
    feats = [f[:66] for f in feats]                     # T = 64 units
    over = dict(length_buckets=[64], workdir=str(cache))
    cfg = tbench.bench_config(voice_name="bench1m", **over)
    jcfg = JaxConfig(**{**{k: getattr(cfg, k) for k in (
        "stream_list", "datadims", "sample_rate", "n_candidates", "taper_length",
        "join_cost_weight", "preselect_precision", "voice_name")}, **over})
    path = str(cache / "benchq.voicedb")
    db = VoiceDB.load(path)
    assert db.n_units == full["extra"]["config3"]["n_units"]
    ts = Synthesiser(cfg, db=db, device="cpu")
    ours = ts.synth_batch(feats)
    theirs = JaxSynthesiser(jcfg, db=JaxVoiceDB.load(path)).synth_batch(feats)
    for a, b, f in zip(theirs, ours, feats):
        assert b["n_units"] == 64
        _assert_same(cfg, db, ts, a, b, f)

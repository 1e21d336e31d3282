"""A benchmark tree at tiny sizes for the CPU tests: the real entries, unit
kinds and readers, small configurations, mixes and limits, and a
``BENCHMARK.json`` naming two cells, ``tiny.batch`` (the closed loop of
``epoch1m.batch``) and ``tiny.served`` (the served path, whose full-size
cell waits for a steadier host; see ``PERF.md``)."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]

SYNTH = {"stream_list": ["mag", "real", "imag", "lf0"],
         "datadims": {"mag": 60, "real": 45, "imag": 45, "lf0": 1},
         "sample_rate": 16000, "n_candidates": 30, "taper_length": 50,
         "join_cost_weight": 0.7, "preselect_precision": "split3cat",
         "length_buckets": [64, 128], "voice_name": "tiny"}
CONFIG = {"name": "tiny", "data": {"voices": 2, "utterances_per_voice": 4, "segments": 8,
                                   "seg_sec": 0.15, "sample_rate": 16000},
          "synth": SYNTH, "serving": {"max_batch": 4, "max_wait_ms": 20}}
TRAFFIC = {
    "batch": {"entry": "synth_batch", "loop": "closed", "batch": 2, "pool": 4,
              "pool_segments": 8, "epochs": {"median": 66, "sigma": 0, "min": 66, "max": 66},
              "greedy": False, "sample": 2},
    "served": {"entry": "http_synth", "loop": "open", "rate_per_s": 8.0, "pool": 4,
               "pool_segments": 8, "epochs": {"median": 50, "sigma": 0.3, "min": 40, "max": 66},
               "voices": {"zipf_s": 1.0}, "greedy": False, "sample": 2, "drain_s": 60},
}
LIMITS = {"missing": 0, "voice_leaks": 0, "total_err": 1e-5, "audio_err": 1e-5,
          "cost_gap_median": 3e-6, "id_mismatch": 0.006}


E2E = [{"name": "rtf", "unit": "s/s", "better": "lower", "bound": 0.1, "source": "host_clock",
        "workloads": ["tiny.batch"]},
       {"name": "latency_p95_ms", "unit": "ms", "better": "lower", "bound": 0.25,
        "source": "host_clock", "workloads": ["tiny.served"]},
       {"name": "peak_mem_gib", "unit": "GiB", "better": "lower", "bound": 0.01,
        "source": "host_clock"},
       {"name": "setup_s", "unit": "s", "better": "lower", "bound": 0.25, "source": "host_clock"}]
LAYER = [{"name": name, "unit": "%", "better": "higher", "source": "device_trace",
          "layer": "t", "moves": "rtf" if name.endswith("batch") else "latency_p95_ms",
          "workloads": ["tiny.batch" if name.endswith("batch") else "tiny.served"]}
         for name in ("preselect_roofline.batch", "decode_ms.batch", "step_roofline.batch",
                      "device_idle.batch", "batch_size_mean.served", "synth_step_ms.served",
                      "device_idle.served")]


def make_root(tmp: Path) -> Path:
    """``tmp`` laid out as a checkout's root holding the tiny cells."""
    real = json.loads((REPO / "BENCHMARK.json").read_text())
    bench = tmp / "benchmark"
    for sub in ("entries", "units", "e2e", "metrics"):
        shutil.copytree(REPO / "benchmark" / sub, bench / sub)
    for sub in ("configs", "traffic", "limits"):
        (bench / sub).mkdir(parents=True)
    (bench / "configs" / "tiny.json").write_text(json.dumps(CONFIG))
    cells = []
    for mix, spec in TRAFFIC.items():
        (bench / "traffic" / f"{mix}.json").write_text(json.dumps(spec))
        (bench / "limits" / f"tiny.{mix}.json").write_text(json.dumps(LIMITS))
        cells.append({"name": f"tiny.{mix}", "config": "tiny", "traffic": mix, "chips": 1,
                      "why": "tiny"})
    doc = {**real, "configs": [{"name": "tiny", "source": "tiny", "reduced": [], "why": "tiny",
                                "file": "benchmark/configs/tiny.json"}],
           "workloads": cells, "end_to_end": E2E, "per_layer": LAYER}
    (tmp / "BENCHMARK.json").write_text(json.dumps(doc))
    return tmp

"""Whole runs of the harness on the CPU at tiny sizes, past its look for a
card: the result line's keys, correct runs, runs with the program broken
underneath (each fault a cell can have) and the control coming out not
correct, and cells, mixes, configurations and metrics added as new files
only being found by name."""

import json
import math
import shutil

import numpy as np
import pytest

from benchmark import control, registry
from benchmark import run as harness
from benchmark.tests import tiny
from snickery_tpu_torch.synth import Synthesiser

SEED = 2 ** 31 + 11


def _run(root, name, trace=False, seconds=1.2):
    return harness.run_cell(registry.cell(root, name), SEED, seconds, trace, device="cpu",
                            log=lambda m: None)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(tmp_path_factory.mktemp("bench"))


@pytest.mark.parametrize("name", ["tiny.batch", "tiny.served"])
def test_an_untraced_run_is_correct_and_reports_its_end_to_end_metrics(root, name):
    line, checks = _run(root, name)
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0
    want = {"tiny.batch": {"rtf", "setup_s"}, "tiny.served": {"latency_p95_ms", "setup_s"}}
    # peak_mem_gib is a device reading: a CPU run leaves it out
    assert set(line["metrics"]) == want[name]
    assert all(set(m) == {"value", "unit"} for m in line["metrics"].values())
    assert set(line["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert [c[0] for c in checks] == list(line["checks"])
    assert all(v <= lim for _, v, lim in checks)
    json.loads(json.dumps(line))


@pytest.mark.parametrize("name", ["tiny.batch", "tiny.served"])
def test_a_traced_run_reports_device_time_and_a_breakdown(root, name):
    line, _ = _run(root, name, trace=True)
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "breakdown",
                          "checks"]
    assert line["correct"] is True
    assert line["device"]["window_s"] > 0 and line["device"]["busy_s"] == 0.0
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    # no device trace on the CPU: no device metric is read
    assert not {"device_idle.batch", "device_idle.served", "decode_ms.batch",
                "preselect_roofline.batch", "step_roofline.batch"} & set(line["metrics"])


def _broken(monkeypatch, fault):
    real = Synthesiser.synth_batch

    def synth_batch(self, feature_list, *a, **kw):
        out = real(self, feature_list, *a, **kw)
        if fault == "answer_altered":
            ids = out[0]["unit_ids"].copy()
            ids[len(ids) // 2] = (ids[len(ids) // 2] + 1) % self.n_units
            out[0] = {**out[0], "unit_ids": ids}
        elif fault == "half_the_batch_left_out":
            half = (len(out) + 1) // 2
            out = out[:half] + [out[i % half] for i in range(half, len(out))]
        return out

    monkeypatch.setattr(Synthesiser, "synth_batch", synth_batch)


@pytest.mark.parametrize("fault", ["answer_altered", "half_the_batch_left_out"])
def test_a_broken_closed_loop_comes_out_not_correct(root, monkeypatch, fault):
    _broken(monkeypatch, fault)
    line, _ = _run(root, "tiny.batch")
    assert line["correct"] is False


@pytest.fixture(scope="module")
def busy_root(tmp_path_factory):
    """The served mix at a rate that makes batches of several requests."""
    r = tiny.make_root(tmp_path_factory.mktemp("busy"))
    mix = json.loads((r / "benchmark/traffic/served.json").read_text())
    mix["rate_per_s"] = 40.0
    (r / "benchmark/traffic/served.json").write_text(json.dumps(mix))
    return r


@pytest.mark.parametrize("fault", ["answer_altered", "half_the_batch_left_out"])
def test_a_broken_server_comes_out_not_correct(busy_root, monkeypatch, fault):
    _broken(monkeypatch, fault)
    line, _ = _run(busy_root, "tiny.served")
    assert line["correct"] is False


@pytest.mark.parametrize("name", ["tiny.batch", "tiny.served"])
def test_the_control_comes_out_not_correct(root, name):
    cell = registry.cell(root, name)
    for seed in (5, 6, 7):
        nums = control.control_numbers(cell, seed, 1.2, "cpu", log=lambda m: None)
        assert nums["correct"] is False
        assert nums["audio_err"] > cell.limits["audio_err"]


def test_a_cell_mix_config_and_metric_added_as_files_are_found_by_name(tmp_path):
    r = tiny.make_root(tmp_path)
    bench = r / "benchmark"
    doc = json.loads((r / "BENCHMARK.json").read_text())
    cfg = json.loads((bench / "configs/tiny.json").read_text())
    cfg["synth"] = {**cfg["synth"], "preselect_precision": "highest"}
    (bench / "configs/tiny_exact.json").write_text(json.dumps(cfg))
    mix = {**tiny.TRAFFIC["batch"], "batch": 3}
    (bench / "traffic/batch3.json").write_text(json.dumps(mix))
    shutil.copy(bench / "limits/tiny.batch.json", bench / "limits/tiny_exact.batch3.json")
    (bench / "metrics/answers_per_step.batch3.py").write_text(
        "def read(run):\n    return len(run.answers) / run.steps\n")
    doc["configs"].append({"name": "tiny_exact", "source": "tiny", "reduced": [], "why": "t",
                           "file": "benchmark/configs/tiny_exact.json"})
    doc["workloads"].append({"name": "tiny_exact.batch3", "config": "tiny_exact",
                             "traffic": "batch3", "chips": 1, "why": "t"})
    doc["per_layer"].append({"name": "answers_per_step.batch3", "unit": "answers",
                             "better": "higher", "source": "program_counter", "layer": "t",
                             "moves": "rtf", "workloads": ["tiny_exact.batch3"]})
    doc["end_to_end"][0]["workloads"].append("tiny_exact.batch3")
    (r / "BENCHMARK.json").write_text(json.dumps(doc))
    cell = registry.cell(r, "tiny_exact.batch3")
    assert cell.config["synth"]["preselect_precision"] == "highest"
    assert [m["name"] for m in cell.per_layer] == ["answers_per_step.batch3"]
    line, _ = _run(r, "tiny_exact.batch3", trace=True)
    assert line["correct"] is True
    assert line["metrics"]["answers_per_step.batch3"]["value"] == 3
    line, _ = _run(r, "tiny_exact.batch3")
    assert set(line["metrics"]) == {"rtf", "setup_s"}


def test_open_loop_traffic_has_the_same_sizes_for_every_seed():
    from benchmark import traffic
    mix = json.loads((tiny.REPO / "benchmark/traffic/served.json").read_text())
    a = traffic.arrivals(mix, 1, 10.0, 8)
    b = traffic.arrivals(mix, 2 ** 31 + 3, 10.0, 8)
    assert sorted(x.epochs for x in a) == sorted(x.epochs for x in b)
    assert sorted(x.voice for x in a) == sorted(x.voice for x in b)
    assert [x.epochs for x in a] != [x.epochs for x in b]
    assert all(130 <= x.epochs <= 1026 for x in a)
    assert a[0].due_s == 0.0 and a[-1].due_s < 10.0
    counts = np.bincount([x.voice for x in a])
    assert list(counts) == sorted(counts, reverse=True) and counts[0] > 2 * counts[2]
    assert abs(len(a) - mix["rate_per_s"] * 10) <= 1
    assert math.isclose(np.median([x.epochs for x in a]), 386, rel_tol=0.02)

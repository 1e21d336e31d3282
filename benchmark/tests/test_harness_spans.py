"""The readers of the program's stage spans: on a tiny root with their four
entries appended for ``tiny.batch``, a traced CPU run prints the stages'
device time a step and an untraced one none of it; ``host_idle_ms.batch``
counts exactly the idle time inside the ``snk.synth_batch`` host ranges of a
hand-built trace; and, marked ``cuda``, a traced run on the card prints all
four above 0."""

import json

import pytest

from benchmark import registry
from benchmark import run as harness
from benchmark.tests import tiny
from benchmark.trace import Trace

SPAN_METRICS = {"rescore_ms.batch": "rescore", "ola_ms.batch": "overlap-add",
                "copy_ms.batch": "host-device copies",
                "host_idle_ms.batch": "synthesiser host work"}
STAGE_METRICS = ("rescore_ms.batch", "ola_ms.batch", "copy_ms.batch")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    r = tiny.make_root(tmp_path_factory.mktemp("spans"))
    doc = json.loads((r / "BENCHMARK.json").read_text())
    for name, layer in SPAN_METRICS.items():
        doc["per_layer"].append({"name": name, "unit": "ms", "better": "lower",
                                 "source": "program_span", "layer": layer, "moves": "rtf",
                                 "workloads": ["tiny.batch"]})
    (r / "BENCHMARK.json").write_text(json.dumps(doc))
    return r


def _run(root, trace, device="cpu", seconds=1.2):
    cell = registry.cell(root, "tiny.batch")
    assert set(SPAN_METRICS) <= {m["name"] for m in cell.per_layer}
    line, _ = harness.run_cell(cell, 2 ** 31 + 17, seconds, trace, device=device,
                               log=lambda m: None)
    assert line["correct"] is True
    return line["metrics"]


def test_a_traced_cpu_run_reads_the_stages_and_an_untraced_one_none(root):
    metrics = _run(root, trace=True)
    for name in STAGE_METRICS:
        assert metrics[name]["unit"] == "ms" and metrics[name]["value"] > 0
    # the CPU run has no device trace, so no idle time to put down
    assert "host_idle_ms.batch" not in metrics
    assert not set(SPAN_METRICS) & set(_run(root, trace=False))


class _Run:
    def __init__(self, trace, steps):
        self.trace, self.steps = trace, steps


def test_host_idle_counts_the_idle_time_inside_the_calls_only():
    read = registry.load_module(tiny.REPO / "benchmark/metrics/host_idle_ms.batch.py",
                                "host_idle_reader").read
    # device busy 0-10, 30-40, 70-100 us of a 0-120 us window: idle 10-30, 40-70, 100-120
    device = [(0.0, 10.0, "k"), (30.0, 40.0, "k"), (70.0, 100.0, "k")]
    host = [(5.0, 35.0, "snk.synth_batch"), (12.0, 14.0, "snk.prepare"),
            (50.0, 60.0, "aten::copy_"), (65.0, 110.0, "snk.synth_batch"),
            (112.0, 118.0, "bench.other")]
    trace = Trace(device, sorted(host), 0.0, 120.0)
    # inside the calls: 10-30 (20 us), 65-70 (5 us), 100-110 (10 us)
    assert read(_Run(trace, 2)) == pytest.approx(35.0 / 1e3 / 2)
    assert read(_Run(Trace(device, [h for h in host if h[2] != "snk.synth_batch"],
                           0.0, 120.0), 2)) is None
    assert read(_Run(Trace([], host, 0.0, 120.0), 2)) is None
    assert read(_Run(None, 2)) is None


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the stages' device time and the idle time are "
                    "read on the card")


@pytest.mark.cuda
def test_a_traced_run_on_the_card_reads_all_four(card, root):
    metrics = _run(root, trace=True, device="cuda", seconds=1.5)
    assert all(metrics[name]["value"] > 0 for name in SPAN_METRICS)

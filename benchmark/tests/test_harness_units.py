"""The unit-kind seam on the CPU at tiny sizes: a kind added as one new file,
``units/<kind>.py``, drives a whole run and the control, the harness calling
each of its functions; a configuration that names an absent kind fails and
names the file it looked for; and a closed loop over two voices gives each
call its voices in exact shares and runs correct without a leak."""

import inspect
import json
import shutil

import numpy as np
import pytest

from benchmark import control, record, registry, traffic
from benchmark import run as harness
from benchmark.tests import tiny

SEED = 2 ** 31 + 29


def _epoch_functions() -> set:
    mod = registry.load_module(tiny.REPO / "benchmark/units/epoch.py", "epoch_listed")
    return {n for n, f in vars(mod).items()
            if inspect.isfunction(f) and f.__module__ == mod.__name__ and not n.startswith("_")}


STUB = '''
"""A unit kind that wraps ``epoch`` and writes the name of each call to
``stub.calls`` beside it."""
from pathlib import Path

from benchmark import registry

_EPOCH = registry.load_module(Path(__file__).with_name("epoch.py"), "stub_wrapped_epoch")
_CALLS = Path(__file__).with_name("stub.calls")


def _wrapped(name):
    def call(*args, **kwargs):
        with open(_CALLS, "a") as f:
            f.write(name + "\\n")
        return getattr(_EPOCH, name)(*args, **kwargs)
    return call


for _name in {names!r}:
    globals()[_name] = _wrapped(_name)
'''


def _add_cell(root, config_name: str, config: dict, mix_name: str, mix: dict):
    """A configuration, a mix, their cell ``<config>.<mix>`` with the tiny
    limits, and its entry in ``BENCHMARK.json``, all as new files."""
    bench = root / "benchmark"
    (bench / "configs" / f"{config_name}.json").write_text(json.dumps(config))
    (bench / "traffic" / f"{mix_name}.json").write_text(json.dumps(mix))
    cell = f"{config_name}.{mix_name}"
    shutil.copy(bench / "limits/tiny.batch.json", bench / "limits" / f"{cell}.json")
    doc = json.loads((root / "BENCHMARK.json").read_text())
    doc["configs"].append({"name": config_name, "source": "tiny", "reduced": [], "why": "t",
                           "file": f"benchmark/configs/{config_name}.json"})
    doc["workloads"].append({"name": cell, "config": config_name, "traffic": mix_name,
                             "chips": 1, "why": "t"})
    for m in doc["end_to_end"] + doc["per_layer"]:
        if "tiny.batch" in m.get("workloads", ()):
            m["workloads"].append(cell)
    (root / "BENCHMARK.json").write_text(json.dumps(doc))
    return registry.cell(root, cell)


def _kept_runs(monkeypatch) -> list:
    runs = []

    class Kept(record.Run):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            runs.append(self)

    monkeypatch.setattr(record, "Run", Kept)
    return runs


def test_a_unit_kind_added_as_one_file_drives_a_run_and_the_control(tmp_path):
    root = tiny.make_root(tmp_path)
    functions = _epoch_functions()
    assert functions == {"inputs", "voice_rows", "build", "features", "call_kwargs",
                         "n_targets", "row_width", "reference", "numbers", "control"}
    units = root / "benchmark/units"
    (units / "stub.py").write_text(STUB.format(names=sorted(functions)))
    cell = _add_cell(root, "tiny_stub", {**tiny.CONFIG, "units": "stub"}, "batch",
                     tiny.TRAFFIC["batch"])
    assert registry.units(cell).__name__ == "bench_units_stub"
    line, _ = harness.run_cell(cell, SEED, 0.5, False, device="cpu", log=lambda m: None)
    assert line["correct"] is True and line["attempted"] > 0
    called = set((units / "stub.calls").read_text().split())
    assert called == functions - {"control"}
    nums = control.control_numbers(cell, 5, 0.5, "cpu", log=lambda m: None)
    assert nums["correct"] is False
    assert set((units / "stub.calls").read_text().split()) == functions


def test_a_configuration_that_names_an_absent_kind_names_the_missing_file(tmp_path):
    root = tiny.make_root(tmp_path)
    cell = _add_cell(root, "tiny_absent", {**tiny.CONFIG, "units": "absent"}, "batch",
                     tiny.TRAFFIC["batch"])
    with pytest.raises(FileNotFoundError, match="benchmark/units/absent.py"):
        harness.run_cell(cell, SEED, 0.5, False, device="cpu", log=lambda m: None)


def test_a_configuration_without_units_is_epoch():
    cell = registry.cell(tiny.REPO, "epoch1m.batch")
    assert "units" not in cell.config and cell.unit_kind == "epoch"
    assert registry.units(cell).row_width(cell.config) == 151


def test_two_voices_in_a_closed_loop_run_correct_in_exact_shares(tmp_path, monkeypatch):
    root = tiny.make_root(tmp_path)
    mix = {**tiny.TRAFFIC["batch"], "batch": 3, "voices": {"zipf_s": 1.0}}
    cell = _add_cell(root, "tiny2", tiny.CONFIG, "batch_voices", mix)
    runs = _kept_runs(monkeypatch)
    line, checks = harness.run_cell(cell, SEED, 1.2, False, device="cpu", log=lambda m: None)
    assert line["correct"] is True
    assert dict((k, v) for k, v, _ in checks)["voice_leaks"] == 0
    run, = runs
    calls = [run.asked[i: i + 3] for i in range(0, len(run.asked), 3)]
    # 3 x (1, 1/2) / 1.5 = (2, 1) utterances a call
    assert all(sorted(a.voice for a in c) == [0, 0, 1] for c in calls)
    assert [w["masked"] for w in run.work] == [True] * len(calls)
    assert [w["targets"] for w in run.work] == [3 * 64] * len(calls)


# utterances a call by voice: the shares batch / (rank H_n), floored, and
# the largest remainders rounded up (8 voices: 11.77, 5.89, 3.92, 2.94, 2.35,
# 1.96, 1.68, 1.47)
@pytest.mark.parametrize("batch,want", [(32, [12, 6, 4, 3, 2, 2, 2, 1]), (7, [4, 2, 1]),
                                        (5, [3, 2])])
def test_each_call_has_its_voices_in_exact_zipf_shares(batch, want):
    n_voices = len(want)
    mix = {**tiny.TRAFFIC["batch"], "batch": batch, "pool": 64, "voices": {"zipf_s": 1.0}}
    it = traffic.batches(mix, 2 ** 33 + 1, n_voices)
    orders = set()
    for _ in range(6):
        call = next(it)
        assert list(np.bincount([a.voice for a in call], minlength=n_voices)) == want
        orders.add(tuple(a.voice for a in call))
    assert len(orders) > 1


def test_one_voice_or_no_voices_key_gives_voice_0():
    with_key = {**tiny.TRAFFIC["batch"], "voices": {"zipf_s": 1.0}}
    for mix, n in ((with_key, 1), (tiny.TRAFFIC["batch"], 8)):
        it = traffic.batches(mix, 3, n)
        assert all(a.voice == 0 for _ in range(4) for a in next(it))

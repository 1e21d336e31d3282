"""The harness on the card at tiny sizes: a run through the hand-written
kernels comes out correct and reads the device's metrics, and the control
comes out not correct.  Run on a machine with a card:

    python -m pytest benchmark/tests -m cuda
"""

import pytest

from benchmark import control, registry
from benchmark import run as harness
from benchmark.tests import tiny

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the hand-written kernels run only on the card")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(tmp_path_factory.mktemp("bench"))


@pytest.mark.parametrize("name", ["tiny.batch", "tiny.served"])
def test_a_traced_run_on_the_card_is_correct_and_reads_the_device(card, root, name):
    cell = registry.cell(root, name)
    line, _ = harness.run_cell(cell, 2 ** 31 + 21, 1.5, True, log=lambda m: None)
    assert line["correct"] is True
    assert line["device"]["platform"] == "gpu" and line["device"]["busy_s"] > 0
    want = {m["name"] for m in cell.per_layer}
    assert want <= set(line["metrics"]) | {"preselect_roofline.batch", "step_roofline.batch"}
    for name_, m in line["metrics"].items():
        if name_.endswith("roofline.batch"):
            assert 0 < m["value"] <= 105


@pytest.mark.parametrize("name", ["tiny.batch", "tiny.served"])
def test_the_control_on_the_card_comes_out_not_correct(card, root, name):
    cell = registry.cell(root, name)
    for seed in (5, 6, 7):
        assert control.control_numbers(cell, seed, 1.5, "cuda", log=lambda m: None)["correct"] \
            is False

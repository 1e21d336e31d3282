"""The harness against its own record: ``tiny.batch`` run on the CPU for one
seed, and the closed loop's first draws, as the harness made them before the
unit kinds (``benchmark/units/``) took over its epoch-unit path.  The run
must draw the same inputs, ask the same utterances, count the same work a
step and compare the same numbers, bit for bit; a closed-loop mix without
``voices`` must draw the same picks and lengths, and one with ``voices`` the
same picks and lengths besides its voices.  The constants were recorded on
an x86-64 CPU with PyTorch 2.13 and numpy 2.0."""

import hashlib

import numpy as np
import pytest

from benchmark import record, registry, traffic, voices
from benchmark import run as harness
from benchmark.tests import tiny

SEED = 2 ** 31 + 11

INPUTS = {"waves": "1950f3d13a5fe2651fc6d7a373d65f47f3f9715ec8446636c4cd7766aa27a66e",
          "epochs": "cade5b1211a57bd987a0f6dafa160bdf5363de4a329c97e28fc0cbc6f960473a",
          "features": "d4c7f45433d898eb33523fbe8132b0e814b3e26cbb76817a0e28ed99aa98568f",
          "pool": "921457613af927d7c40031214ba311c9abfd103c56f2f19d329b7ab5a2210a8c"}
# (pool, epochs, voice) of each ask: the window of ``--seconds 0`` is one call
ASKED = [(1, 66, 0), (3, 66, 0)]
SAMPLE = [0, 1]
WORK = [{"targets": 128, "pairs": 65536, "rows": 512, "kd": 151, "n": 30,
         "precision": "split3cat", "masked": True, "decode": "viterbi", "utterances": 2,
         "out_samples": 17624, "fragment_samples": 30224}]
CHECKS = [("missing", 0, 0), ("voice_leaks", 0, 0),
          ("total_err", 1.1389890513233102e-07, 1e-05),
          ("audio_err", 1.5385763573475113e-07, 1e-05), ("cost_gap_median", 0.0, 3e-06),
          ("id_mismatch", 0.0, 0.006)]

MIXES = {"batch": tiny.TRAFFIC["batch"],
         "varied": {**tiny.TRAFFIC["batch"], "batch": 3, "pool": 8,
                    "epochs": {"median": 50, "sigma": 0.3, "min": 40, "max": 66}}}
# (pool, epochs) of the first three calls, by mix and seed
DRAWS = {
    ("batch", 0): [[(3, 66), (1, 66)], [(0, 66), (1, 66)], [(3, 66), (0, 66)]],
    ("batch", 2 ** 31 + 11): [[(1, 66), (3, 66)], [(2, 66), (0, 66)], [(2, 66), (3, 66)]],
    ("batch", 2 ** 40 + 3): [[(3, 66), (2, 66)], [(0, 66), (2, 66)], [(3, 66), (2, 66)]],
    ("varied", 0): [[(0, 40), (7, 50), (3, 66)], [(2, 66), (3, 40), (5, 50)],
                    [(1, 66), (0, 50), (6, 40)]],
    ("varied", 2 ** 31 + 11): [[(5, 66), (0, 50), (1, 40)], [(0, 50), (3, 40), (5, 66)],
                               [(0, 50), (6, 66), (4, 40)]],
    ("varied", 2 ** 40 + 3): [[(4, 40), (7, 66), (6, 50)], [(4, 66), (0, 40), (3, 50)],
                              [(6, 40), (4, 50), (7, 66)]],
}


def _digest(utts, keys) -> str:
    h = hashlib.sha256()
    for u in utts:
        for k in keys:
            a = np.ascontiguousarray(u[k])
            h.update(f"{a.dtype}{a.shape}".encode())
            h.update(a.tobytes())
    return h.hexdigest()


@pytest.fixture(scope="module")
def golden_run(tmp_path_factory):
    """One untraced ``tiny.batch`` run of one call, with its inputs and its
    ``Run`` kept."""
    made, runs = [], []
    real = voices.cell_data

    def cell_data(*a, **kw):
        made.append(real(*a, **kw))
        return made[-1]

    class Kept(record.Run):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            runs.append(self)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(voices, "cell_data", cell_data)
        mp.setattr(record, "Run", Kept)
        root = tiny.make_root(tmp_path_factory.mktemp("golden"))
        line, checks = harness.run_cell(registry.cell(root, "tiny.batch"), SEED, 0.0, False,
                                        device="cpu", log=lambda m: None)
    (utts, pool), = made
    run, = runs
    return line, checks, utts, pool, run


def test_the_run_draws_the_recorded_inputs(golden_run):
    _, _, utts, pool, _ = golden_run
    flat = [u for v in utts for u in v]
    assert {"waves": _digest(flat, ["wave"]), "epochs": _digest(flat, ["epochs"]),
            "features": _digest(flat, ["features"]),
            "pool": _digest(pool, ["wave", "epochs", "features"])} == INPUTS


def test_the_run_asks_and_counts_the_recorded_work(golden_run):
    line, _, _, _, run = golden_run
    assert [(a.pool, a.epochs, a.voice) for a in run.asked] == ASKED
    assert run.sample == SAMPLE
    assert run.work == WORK
    assert line["attempted"] == len(ASKED) and line["failed"] == 0


def test_the_run_compares_the_recorded_numbers(golden_run):
    line, checks, _, _, _ = golden_run
    assert [tuple(c) for c in checks] == CHECKS
    assert line["correct"] is True


@pytest.mark.parametrize("mix,seed", sorted(DRAWS))
def test_closed_loop_draws_without_voices_are_the_recorded_ones(mix, seed):
    it = traffic.batches(MIXES[mix], seed, 2)
    calls = [next(it) for _ in range(3)]
    assert [[(a.pool, a.epochs) for a in c] for c in calls] == DRAWS[(mix, seed)]
    assert all(a.voice == 0 for c in calls for a in c)


@pytest.mark.parametrize("mix,seed", sorted(DRAWS))
def test_voices_leave_the_picks_and_lengths_as_recorded(mix, seed):
    it = traffic.batches({**MIXES[mix], "voices": {"zipf_s": 1.0}}, seed, 2)
    calls = [next(it) for _ in range(3)]
    assert [[(a.pool, a.epochs) for a in c] for c in calls] == DRAWS[(mix, seed)]
    assert {a.voice for c in calls for a in c} == {0, 1}

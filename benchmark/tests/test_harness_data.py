"""The benchmark's frozen data makers and roofline arithmetic against their
sources in the port, at small sizes, so that drift on either side shows,
and the roofline counts against shapes worked by hand."""

import math

import numpy as np
import pytest
import torch

from benchmark import analysis, roofline, speech, voices
from snickery_tpu_torch import kernel_check
from snickery_tpu_torch.features.epochs import f0_from_epochs
from snickery_tpu_torch.features.magphase import magphase_analysis
from snickery_tpu_torch.synthetic_voices import PHONES, synth_utterance


def _source_draws(seed: int, n_segments: int):
    """The draws ``synth_utterance(seed)`` takes from its numpy generator,
    in the layout of ``speech.draw``."""
    rng = np.random.default_rng(seed)
    phones = rng.integers(0, len(PHONES), n_segments)
    f0 = np.array([rng.random(), rng.random()])
    L = speech.seg_len()
    b0 = int(0.55 * L)
    noise = np.zeros((n_segments, L))
    for s, p in enumerate(phones):
        if PHONES[p] in speech.STOPS:
            noise[s, : L - b0] = rng.standard_normal(L - b0)
        elif PHONES[p] in speech.FRICS:
            noise[s] = rng.standard_normal(L)
    return phones, f0, noise


@pytest.fixture(scope="module")
def rendered():
    seeds, S = (3, 4, 5, 11), 8
    draws = [_source_draws(s, S) for s in seeds]
    waves, cycles = speech.render(*(torch.tensor(np.stack(x)) for x in zip(*draws)))
    return seeds, S, waves, cycles


def test_the_renderer_gives_the_source_generators_waves(rendered):
    seeds, S, waves, _ = rendered
    for i, s in enumerate(seeds):
        want, _ = synth_utterance(s, n_segments=S)
        np.testing.assert_allclose(waves[i].numpy(), want, rtol=0, atol=1e-9)


def test_pitch_marks_are_whole_glottal_cycles(rendered):
    _, _, _, cycles = rendered
    utt, pos = speech.pitch_marks(cycles)
    for i in range(cycles.shape[0]):
        c = cycles[i].numpy()
        marks = pos[utt == i].numpy()
        assert len(marks) == int(np.floor(c[-1])) - int(np.floor(c[0]))
        assert np.all(np.floor(c[marks]) > np.floor(c[marks - 1]))


def test_the_batched_analysis_is_the_sources_analysis_of_each_utterance(rendered):
    _, _, waves, cycles = rendered
    utt, pos = speech.pitch_marks(cycles)
    rows = analysis.magphase_rows(waves, utt, pos, speech.SR)
    lf0 = analysis.lf0_rows(utt, pos, speech.SR)
    for i in range(waves.shape[0]):
        e = pos[utt == i].numpy().astype(np.int32)
        st = magphase_analysis(waves[i].numpy(), e, speech.SR, device="cpu")
        want = np.concatenate([st["mag"], st["real"], st["imag"]], 1)
        np.testing.assert_array_equal(rows[utt == i].numpy(), want)
        np.testing.assert_array_equal(lf0[utt == i].numpy(), f0_from_epochs(e, speech.SR))


@pytest.mark.parametrize("count", [128, 131])
def test_an_epoch_count_at_the_padding_multiple_keeps_the_last_gap(count):
    """The source pads the epoch axis to a multiple of 128; at a multiple the
    last epoch's next gap is its real one, else 1."""
    e = np.cumsum(np.full(count, 120)) + 600
    wave = np.sin(np.arange(e[-1] + 800) / 7.0).astype(np.float32)
    utt = torch.zeros(count, dtype=torch.int64)
    rows = analysis.magphase_rows(torch.tensor(wave)[None], utt, torch.tensor(e), speech.SR)
    st = magphase_analysis(wave, e.astype(np.int32), speech.SR, device="cpu")
    np.testing.assert_array_equal(rows.numpy()[:, :60], st["mag"])


def test_the_filterbank_and_warp_are_the_sources():
    from snickery_tpu_torch.features import magphase as port
    from snickery_tpu_torch.features.mel import mel_filterbank
    np.testing.assert_array_equal(analysis.mel_filterbank(60, 1024, 16000),
                                  mel_filterbank(60, 1024, 16000))
    np.testing.assert_array_equal(analysis.warp_matrix(513, 45, 16000),
                                  port._warp_matrix(513, 45, 16000))
    assert analysis.frame_max_for(16000) == port.frame_max_for(16000, 50.0)


def test_utterances_come_from_the_seed_and_voices_from_their_own_seeds():
    a = voices.utterances(3, 6, voices.sub_seed(9, "voice", 0), "cpu")
    b = voices.utterances(3, 6, voices.sub_seed(9, "voice", 0), "cpu")
    c = voices.utterances(3, 6, voices.sub_seed(9, "targets"), "cpu")
    for x, y in zip(a, b):
        for k in ("wave", "epochs", "features"):
            np.testing.assert_array_equal(x[k], y[k])
    assert not np.array_equal(a[0]["wave"], c[0]["wave"])
    for u in a:
        assert u["features"].shape == (len(u["epochs"]), 151)
        assert np.all(np.diff(u["epochs"]) > 0)
    assert voices.sub_seed(2 ** 31 + 5, "voice", 1) != voices.sub_seed(2 ** 31 + 5, "voice", 2)


def test_grouping_by_epochs_changes_no_row(monkeypatch):
    whole = voices.utterances(4, 6, 77, "cpu")
    monkeypatch.setattr(voices, "GROUP_EPOCHS", 100)
    grouped = voices.utterances(4, 6, 77, "cpu")
    for x, y in zip(whole, grouped):
        np.testing.assert_array_equal(x["features"], y["features"])


def test_the_preselect_bound_of_config_3():
    """65,536 targets x 1,048,576 rows x 151 at split3cat: 6 x 151 FLOP a
    pair at 989 TFLOP/s is 62.95 ms, operations-bound."""
    ms, term = roofline.bound_ms(65536, 1048576, 151, 48, "split3cat", False)
    assert term == "operations"
    assert ms == pytest.approx(2 * 65536 * 1048576 * 151 * 3 / 989e12 * 1e3)
    assert round(ms, 2) == 62.95


def test_the_bounds_by_hand():
    # highest, bytes-bound: 4 targets x 1,000 rows x 8 -> 64,000 FLOP,
    # 4 (4 * 8 + 2 * 4 * 2) + 1,000 * 36 = 36,192 bytes
    ms, term = roofline.bound_ms(4, 1000, 8, 2, "highest", False)
    assert term == "bytes" and ms == pytest.approx(36192 / 3.35e12 * 1e3)
    # the Viterbi of config 3's lattice: bytes 4 * 65,536 * 30 * 303
    ms, term = roofline.decode_bound_ms("viterbi", 65536, 30, 151, 0)
    assert term == "bytes" and ms == pytest.approx(4 * 65536 * 30 * 303 / 3.35e12 * 1e3)
    assert round(ms, 3) == 0.711
    ms, _ = roofline.rescore_bound_ms(10, 3, 4, 4)
    assert ms == pytest.approx((4 * 10 * 3 * 4 + 10 * 3 * (4 * 9 + 8)) / 3.35e12 * 1e3)
    assert roofline.ola_bound_ms(100, 50)[0] == pytest.approx(600 / 3.35e12 * 1e3)
    assert roofline.partition_work({0: 2, 1: 1}, {0: 10, 1: 7, 2: 99}) == (27, 17)


@pytest.mark.parametrize("args", [(65536, 1048576, 151, 48, "split3cat", False),
                                  (2048, 8388608, 151, 40, "split3", False),
                                  (512, 57344, 453, 30, "highest", True),
                                  (64, 1000, 151, 30, "highest", False)])
def test_the_frozen_bounds_equal_the_ports(args):
    assert roofline.bound_ms(*args) == kernel_check.bound_ms(*args)


def test_the_frozen_decode_bounds_and_peaks_equal_the_ports():
    for kind in ("viterbi", "greedy"):
        assert (roofline.decode_bound_ms(kind, 65536, 30, 151, 1000)
                == kernel_check.decode_bound_ms(kind, 65536, 30, 151, 1000))
    assert roofline.PEAK_FLOPS == kernel_check.PEAK_FLOPS
    assert roofline.HBM_BYTES_PER_S == kernel_check.HBM_BYTES_PER_S


def test_a_steps_bounds_add_its_stages():
    step = {"targets": 65536, "pairs": 65536 * 1046000, "rows": 1046000, "kd": 151, "n": 30,
            "precision": "split3cat", "masked": False, "decode": "viterbi", "utterances": 32,
            "fragment_samples": 16_000_000, "out_samples": 10_000_000}
    b = roofline.step_bounds_ms(step)
    assert set(b) == {"preselect", "rescore", "decode", "ola"}
    assert 62 < b["preselect"] < 63 and b["decode"] == pytest.approx(0.711, abs=1e-3)
    assert math.isclose(sum(b.values()), 62.7 + 1.07 + 0.71 + 0.031, rel_tol=0.01)

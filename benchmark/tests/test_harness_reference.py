"""The plain reference against brute force in float64 on tiny voices: its
preselection against a full stable sort, its Viterbi against every path,
its overlap-add against a sample-by-sample loop, its voice against the
documented unit semantics; and the control's precision steps."""

import itertools

import numpy as np
import pytest
import torch

from benchmark import voices
from benchmark.reference import search
from benchmark.reference import voice as ref_voice

DIMS = {"mag": 60, "real": 45, "imag": 45, "lf0": 1}
STREAMS = list(DIMS)


@pytest.fixture(scope="module")
def tiny_voice():
    utts = [voices.utterances(2, 4, voices.sub_seed(3, "voice", v), "cpu") for v in range(2)]
    return utts, ref_voice.build(utts, DIMS, STREAMS, [1.0] * 4, [1.0] * 4, "cpu")


def test_the_voice_follows_the_unit_semantics(tiny_voice):
    utts, v = tiny_voice
    u0 = utts[0][0]
    E = len(u0["epochs"])
    np.testing.assert_array_equal(v.feats[: E - 2], u0["features"][1: E - 1])
    np.testing.assert_array_equal(v.jr[: E - 2], u0["features"][2:E])
    np.testing.assert_array_equal(v.cut_start[: E - 2].numpy(), u0["epochs"][1: E - 1])
    first_of_1 = sum(len(u["epochs"]) - 2 for u in utts[0])
    assert v.voice_rows == [(0, first_of_1), (first_of_1, v.feats.shape[0])]
    off = sum(len(u["wave"]) for u in utts[0])
    assert int(v.cut_start[first_of_1]) == utts[1][0]["epochs"][1] + off
    # the statistics in float32 as numpy sums them, the rest in float64
    f = v.feats
    m, sd = f.mean(0).astype(np.float64), f.std(0).astype(np.float64)
    np.testing.assert_allclose(v.fw.numpy(), (f - m) / sd, atol=1e-12)
    a, b = v.voice_rows[0]
    j = np.concatenate([f[a:b], v.jr[a:b], f[b:], v.jr[b:]])
    m, sd = j.mean(0).astype(np.float64), j.std(0).astype(np.float64)
    np.testing.assert_allclose(v.jrw.numpy(), (v.jr - m) / sd, atol=1e-12)


def test_weights_scale_each_stream(tiny_voice):
    utts, _ = tiny_voice
    w = ref_voice.build(utts, DIMS, STREAMS, [1.0, 4.0, 1.0, 9.0], [1.0] * 4, "cpu")
    np.testing.assert_allclose(w.sqrt_wt.numpy()[[0, 60, 150]], [1.0, 2.0, 3.0])


def test_preselect_is_the_stable_sort_of_the_exact_distances(tiny_voice, monkeypatch):
    _, v = tiny_voice
    tw = v.targets(np.random.default_rng(0).standard_normal((40, 151)).astype(np.float32))
    lo, hi = v.voice_rows[1]
    monkeypatch.setattr(search, "BLOCK_ROWS", 37)
    monkeypatch.setattr(search, "BLOCK_TARGETS", 16)
    ids, sq = search.preselect(tw, v.fw, lo, hi, 7)
    d = ((tw.numpy()[:, None, :] - v.fw.numpy()[None, lo:hi, :]) ** 2).sum(-1)
    want = np.argsort(d, axis=1, kind="stable")[:, :7] + lo
    np.testing.assert_array_equal(ids.numpy(), want)
    np.testing.assert_allclose(sq.numpy(), np.take_along_axis(d, want - lo, 1), rtol=1e-12)


@pytest.mark.parametrize("block", [4, 5, 131072])
def test_ties_go_to_the_lower_unit_id(monkeypatch, block):
    monkeypatch.setattr(search, "BLOCK_ROWS", block)
    fw = torch.tensor([[1.0, 0.0], [0.0, 0.0], [0.0, 1.0], [0.0, 0.0]], dtype=torch.float64)
    ids, _ = search.preselect(torch.zeros((1, 2), dtype=torch.float64), fw, 0, 4, 3)
    assert ids.tolist() == [[1, 3, 0]]
    # a class of 12 bit-equal rows, more than the 3 kept: the lowest ids
    fw = torch.cat([torch.ones((3, 2)), torch.zeros((12, 2))]).double()
    ids, _ = search.preselect(torch.zeros((2, 2), dtype=torch.float64), fw, 0, 15, 3)
    assert ids.tolist() == [[3, 4, 5]] * 2


def test_the_viterbi_finds_the_cheapest_of_all_paths():
    rng = np.random.default_rng(1)
    B, T, N, d = 3, 5, 4, 3
    tc = torch.tensor(rng.random((B, T, N)))
    jl, jr = torch.tensor(rng.random((B, T, N, d))), torch.tensor(rng.random((B, T, N, d)))
    lengths = [5, 3, 1]
    paths, totals = search.viterbi(tc, jl, jr, lengths, 0.7)
    for b, n in enumerate(lengths):
        best = None
        for p in itertools.product(range(N), repeat=n):
            c = sum(float(tc[b, t, p[t]]) for t in range(n)) + 0.7 * sum(
                float(torch.linalg.norm(jl[b, t, p[t]] - jr[b, t - 1, p[t - 1]]))
                for t in range(1, n))
            if best is None or c < best[0] - 1e-12:
                best = (c, p)
        assert totals[b].item() == pytest.approx(best[0], rel=1e-12)
        assert tuple(paths[b, :n].tolist()) == best[1]


def test_the_reference_path_is_optimal_over_all_candidates(tiny_voice):
    """With every unit of a voice a candidate, the reference's path costs no
    more than any other path (brute force over 3 targets)."""
    utts, v = tiny_voice
    lo, hi = v.voice_rows[0]
    n = hi - lo
    feats = utts[1][0]["features"][:5]                      # 3 unit-rate targets
    ans = search.synthesise(v, [feats], [0], n, 0.7, 50)[0]
    tw = v.targets(feats)
    best = float(search.path_costs(tw, torch.as_tensor(ans["unit_ids"]), v.fw, v.jlw, v.jrw, 0.7))
    tc = torch.sqrt(((v.fw[lo:hi][None] - tw[:, None]) ** 2).sum(-1))      # (3, n)
    jd = torch.cdist(v.jrw[lo:hi], v.jlw[lo:hi],                          # prev x cur
                     compute_mode="donot_use_mm_for_euclid_dist")
    total = tc[0][:, None, None] + 0.7 * jd[:, :, None] + tc[1][None, :, None] \
        + 0.7 * jd[None, :, :] + tc[2][None, None, :]
    assert best == pytest.approx(float(total.min()), rel=1e-12)
    assert ans["total"] == pytest.approx(best, rel=1e-12)


def _ola_loop(waves, starts, ends, taper):
    t2 = 2 * taper
    spans = ends - starts
    out = np.zeros(int(spans.sum()) + t2)
    ramp = 0.5 - 0.5 * np.cos(np.pi * (np.arange(t2) + 0.5) / t2)
    anchor = taper
    for s, e in zip(starts, ends):
        L = int(e - s) + t2
        for p in range(L):
            src = int(s) - taper + p
            w = min(ramp[p] if p < t2 else 1.0, ramp[L - 1 - p] if p >= L - t2 else 1.0)
            if 0 <= src < len(waves):
                out[anchor - taper + p] += waves[src] * w
        anchor += int(e - s)
    return out


def test_the_overlap_add_is_the_crossfade_loop():
    waves = torch.tensor(np.random.default_rng(2).standard_normal(400), dtype=torch.float32)
    starts, ends = np.array([5, 100, 180, 320]), np.array([60, 170, 300, 395])
    got = search.overlap_add(waves, torch.tensor(starts), torch.tensor(ends), 8)
    np.testing.assert_allclose(got.numpy(), _ola_loop(waves.double().numpy(), starts, ends, 8),
                               atol=1e-12)


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11, -3.14159],
                     dtype=torch.float32)
    y = search.to_tf32(x)
    assert y[:4].tolist() == [1.0, 1.0 + 2 ** -10, 1.0, 1.0 + 2 ** -9]
    assert abs(y[4].item() + 3.14159) < 2 ** -9 and y[4].item() != x[4].item()
    bits = y.view(torch.int32) & 0x1FFF
    assert bits.eq(0).all()


@pytest.mark.parametrize("n_voices", [1, 3])
def test_the_statistics_are_the_builders_bit_for_bit(n_voices):
    """The reference works the statistics out itself by the builder's rule;
    they come out equal to the port's builder's and merger's."""
    from snickery_tpu_torch.config import SnickeryConfig
    from snickery_tpu_torch.voicedb.build import UtteranceData, build_voicedb
    from snickery_tpu_torch.voicedb.multivoice import merge_voicedbs

    utts = [voices.utterances(3, 6, voices.sub_seed(8, "voice", v), "cpu")
            for v in range(n_voices)]
    ref = ref_voice.build(utts, DIMS, STREAMS, [1.0] * 4, [1.0] * 4, "cpu")
    cfg = SnickeryConfig(stream_list=STREAMS, datadims=DIMS)
    dbs = [build_voicedb(cfg, [UtteranceData(f"u{i}", u["wave"], u["epochs"], u["features"],
                                             u["features"][:, -1]) for i, u in enumerate(v)])
           for v in utts]
    db = dbs[0] if n_voices == 1 else merge_voicedbs(dbs)
    np.testing.assert_array_equal(ref.mean_t.numpy(), db.mean_target)
    np.testing.assert_array_equal(ref.std_t.numpy(), db.std_target)
    np.testing.assert_array_equal(ref.feats, db.unit_features)
    np.testing.assert_array_equal(ref.jr, db.join_right)
    np.testing.assert_array_equal(ref.cut_start.numpy(), db.cutpoints[:, 1])
    np.testing.assert_array_equal(ref.cut_end.numpy(), db.cutpoints[:, 2])
    jl, jr = db.normalised_joins()
    np.testing.assert_allclose(ref.jrw.numpy(), jr, rtol=1e-6, atol=1e-6)

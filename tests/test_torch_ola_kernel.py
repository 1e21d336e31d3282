"""The overlap-add kernel (``csrc/ola.cu``) and what surrounds it.

On the CPU: the ramp table the kernel reads gives the plain version's
weights bit for bit at every fragment length; the grid helper; a CPU call
launches nothing and returns the plain version's values; and a numpy model
of the kernel's walk (tiles of ``OLA_TILE`` samples, the 32-way search,
units staged 256 at a time, a pointer per thread) equals the plain version
bit for bit on every case below that fits a Python loop.

On a CUDA card (marked ``cuda``; each test skips where no card is visible):
each case through the kernel against ``overlap_add_units_plain`` on a CPU
copy of the same inputs, bit for bit (both sum a sample's fragments in
ascending unit order from 0.0 with the same f32 products), and against
``host_overlap_add`` per utterance to 1e-6 of the peak where no fragment
is longer than ``max_frag`` (numpy's float32 cosine rounds some weights one
ulp away from torch's); one launch a call,
counted, with no host synchronisation.  This file imports no jax:

    python -m pytest -m cuda --noconftest -p no:cacheprovider tests/test_torch_ola_kernel.py
"""

import numpy as np
import pytest
import torch

from snickery_tpu_torch.ops import cuda_topk, ola


def _edges(rng):
    """The CPU OLA test's case: units at the corpus edges, a padded slot,
    a natural run."""
    corpus = rng.standard_normal(5000).astype(np.float32)
    starts = np.asarray([[10, 900, 3777, 4801, 450],
                         [500, 900, 1300, 1700, 0]])
    ends = starts + np.asarray([[300, 411, 129, 190, 333],
                                [400, 400, 400, 400, 0]])
    return dict(corpus=corpus, starts=starts, ends=ends, n_units=np.asarray([5, 4]),
                taper=24, max_frag=512, out_len=4096)


def _random(rng, B, U, lo, hi, taper, S, out_len=None, n_min=None, zero_share=0.0):
    """B utterances of up to U units with spans in [lo, hi) (a share of
    them 0), anywhere in a corpus of S samples, edges included."""
    corpus = rng.standard_normal(S).astype(np.float32)
    spans = rng.integers(lo, hi, size=(B, U))
    spans[rng.random((B, U)) < zero_share] = 0
    starts = rng.integers(-taper, S - hi + taper, size=(B, U)).clip(0)
    n_units = rng.integers(n_min if n_min is not None else U // 2, U + 1, size=B)
    max_frag = -(-(hi + 2 * taper) // 128) * 128
    if out_len is None:
        out_len = -(-int(spans.sum(axis=1).max() + 2 * taper) // 128) * 128
    return dict(corpus=corpus, starts=starts, ends=starts + spans, n_units=n_units,
                taper=taper, max_frag=max_frag, out_len=out_len)


def _zero_spans(rng):
    """Zero-length spans (300 of them on one spot: more units on one tile
    than a CTA stages at once) and spans under 2 * taper, where three
    fragments cover one sample."""
    c = _random(rng, 3, 400, 0, 40, 32, 20000, n_min=380)
    c["ends"][0, 50:350] = c["starts"][0, 50:350]
    return c


def _short_out(rng):
    """An output shorter than the totals: the tail dropped mid-fragment."""
    c = _random(rng, 4, 30, 100, 400, 50, 30000)
    c["out_len"] = 2500
    return c


def _int16(rng):
    c = _random(rng, 5, 40, 80, 400, 50, 40000)
    c["scale"] = np.float32(np.abs(c["corpus"]).max() / 32767.0)
    c["corpus"] = np.round(c["corpus"] / c["scale"]).astype(np.int16)
    return c


def _stream(rng):
    """One streaming chunk of 32 epochs, its last 7 dead."""
    c = _random(rng, 1, 32, 80, 400, 50, 60000)
    c["n_units"] = np.asarray([25])
    return c


def _over_max_frag(rng):
    """Fragments longer than max_frag: the plain version drops their tail
    (no synthesiser passes such a max_frag)."""
    c = _random(rng, 2, 12, 100, 600, 24, 9000)
    c["max_frag"] = 384
    return c


def _halfphone(rng):
    """The halfphone cell's step: 512 utterances of up to 64 halfphones of
    ~1,200 samples, int16 waves."""
    c = _random(rng, 512, 64, 900, 1500, 50, 3_000_000, n_min=20)
    c["scale"] = np.float32(np.abs(c["corpus"]).max() / 32767.0)
    c["corpus"] = np.round(c["corpus"] / c["scale"]).astype(np.int16)
    return c


def _epoch(rng):
    """The epoch cell's step: 32 utterances of 2,048 epochs of 80-400
    samples, f32 waves."""
    return _random(rng, 32, 2048, 80, 400, 50, 2_000_000, n_min=1500)


CASES = {"edges": _edges, "zero_spans": _zero_spans, "short_out": _short_out,
         "int16": _int16, "stream": _stream, "over_max_frag": _over_max_frag,
         "halfphone": _halfphone, "epoch": _epoch}
MODEL_CASES = ["edges", "zero_spans", "short_out", "int16", "stream", "over_max_frag"]


def _case(name, seed=23):
    c = CASES[name](np.random.default_rng(seed))
    c.setdefault("scale", np.float32(1.0))
    return c


def _plain(c):
    return ola.overlap_add_units_plain(
        torch.from_numpy(c["corpus"]), torch.from_numpy(c["starts"]),
        torch.from_numpy(c["ends"]), torch.from_numpy(c["n_units"]), c["max_frag"],
        c["out_len"], c["taper"], torch.tensor(c["scale"]))


def _kernel_model(c):
    """The kernel's walk in numpy float32, CTA by CTA and thread by thread."""
    waves, scale = c["corpus"], np.float32(c["scale"])
    taper, max_frag, out_len = c["taper"], c["max_frag"], c["out_len"]
    B, U = c["starts"].shape
    n_live = np.clip(c["n_units"], 0, U)
    spans = np.where(np.arange(U)[None, :] < n_live[:, None], c["ends"] - c["starts"], 0)
    incl = np.cumsum(spans, axis=1)
    ramp = ola.ramp_table(taper).numpy()
    two_t, threads, items = 2 * taper, 256, ola.OLA_TILE // 256
    tiles, _ = ola.ola_grid(B, out_len)
    out = np.full((B, out_len), np.nan, np.float32)
    for b in range(B):
        n, cb = int(n_live[b]), incl[b]
        for tile in range(tiles):
            t0 = tile * ola.OLA_TILE
            t_end = min(t0 + ola.OLA_TILE, out_len)
            lo, hi = 0, n
            while hi > lo:
                step = (hi - lo + 31) // 32
                idx = [lo + (lane + 1) * step - 1 for lane in range(32)]
                past = [i >= hi or cb[i] + two_t > t0 for i in idx]
                if not any(past):
                    lo = hi
                else:
                    f = past.index(True)
                    lo, hi = lo + f * step, min(idx[f], hi)
            acc = np.zeros((threads, items), np.float32)
            base = lo
            while True:
                staged = []
                for u in range(base, min(base + threads, n)):
                    s = int(cb[u - 1]) if u > 0 else 0
                    if s >= t_end:
                        break
                    length = int(cb[u]) - s + two_t
                    staged.append((s, length, min(length, max_frag),
                                   int(c["starts"][b, u]) - taper))
                for tid in range(threads):
                    f = 0
                    for k in range(items):
                        j = t0 + tid + k * threads
                        if j >= t_end:
                            continue
                        while f < len(staged) and staged[f][0] + staged[f][1] <= j:
                            f += 1
                        a = acc[tid, k]
                        for s, length, reach, src0 in staged[f:]:
                            if s > j:
                                break
                            p, src = j - s, src0 + j - s
                            if p < reach and 0 <= src < len(waves):
                                x = np.float32(waves[src]) * scale
                                w = min(ramp[min(p, two_t)], ramp[min(length - 1 - p, two_t)])
                                a = np.float32(a + np.float32(x * w))
                        acc[tid, k] = a
                if len(staged) < threads:
                    break
                base += threads
            for tid in range(threads):
                for k in range(items):
                    j = t0 + tid + k * threads
                    if j < t_end:
                        out[b, j] = acc[tid, k]
    return out, 2 * taper + spans.sum(axis=1)


def _ramp_weights(taper, frag_len):
    """The weights of a fragment of ``frag_len`` samples as the kernel reads
    them from ``ola.ramp_table``."""
    t = ola.ramp_table(taper)
    p = torch.arange(frag_len)
    return torch.minimum(t[p.clamp(max=2 * taper)], t[(frag_len - 1 - p).clamp(max=2 * taper)])


def _bits(x):
    return torch.as_tensor(x).contiguous().view(torch.int32)


# ------------------------------------------------------------------ CPU
@pytest.mark.parametrize("taper,max_frag", [(24, 512), (50, 1408), (32, 640), (0, 64),
                                            (1, 64), (160, 1024)])
def test_ramp_table_gives_the_plain_weights(taper, max_frag):
    """For every fragment length from 2 * taper (a zero span) to max_frag,
    the weights read from the ramp table equal the plain version's
    min(rise, fall) bit for bit (read off the plain OLA of a corpus of
    ones, one fragment an utterance)."""
    lengths = np.arange(2 * taper, max_frag + 1)
    B = len(lengths)
    starts = torch.full((B, 1), taper, dtype=torch.int64)
    ends = starts + torch.from_numpy(lengths - 2 * taper)[:, None]
    audio, _ = ola.overlap_add_units_plain(torch.ones(max_frag + 2 * taper), starts, ends,
                                           torch.ones(B, dtype=torch.int64), max_frag,
                                           max_frag, taper)
    for b, L in enumerate(lengths.tolist()):
        assert torch.equal(_bits(audio[b, :L]), _bits(_ramp_weights(taper, L))), L


def test_ola_grid():
    """Tiles of OLA_TILE samples, B utterances, at most MAX_GRID_Y."""
    assert ola.OLA_TILE == 2048
    assert ola.ola_grid(512, 53_000) == (26, 512)
    assert ola.ola_grid(32, 2048) == (1, 32)
    assert ola.ola_grid(32, 2049) == (2, 32)
    assert ola.ola_grid(1, 1) == (1, 1)
    assert ola.ola_grid(3, 0) == (0, 3)
    assert ola.ola_grid(ola.MAX_GRID_Y, 10) == (1, ola.MAX_GRID_Y)
    with pytest.raises(ValueError, match="utterances"):
        ola.ola_grid(ola.MAX_GRID_Y + 1, 10)


@pytest.mark.parametrize("name", ["edges", "int16", "zero_spans"])
def test_cpu_call_is_the_plain_path(name):
    """A CPU call launches no kernel and returns the plain version's values."""
    c = _case(name)
    before = dict(cuda_topk.LAUNCH_COUNTS)
    audio, totals = ola.overlap_add_units(
        torch.from_numpy(c["corpus"]), torch.from_numpy(c["starts"]),
        torch.from_numpy(c["ends"]), torch.from_numpy(c["n_units"]), max_frag=c["max_frag"],
        out_len=c["out_len"], taper=c["taper"], wave_scale=torch.tensor(c["scale"]))
    assert dict(cuda_topk.LAUNCH_COUNTS) == before
    want, want_totals = _plain(c)
    assert torch.equal(_bits(audio), _bits(want))
    assert torch.equal(totals, want_totals)


@pytest.mark.parametrize("name", MODEL_CASES)
def test_kernel_model_matches_plain(name):
    """The kernel's walk, modelled in numpy float32, writes every output
    sample once and equals the plain version bit for bit."""
    c = _case(name)
    got, totals = _kernel_model(c)
    want, want_totals = _plain(c)
    assert not np.isnan(got).any()
    assert torch.equal(_bits(got), _bits(want))
    np.testing.assert_array_equal(totals, want_totals.numpy())


# ------------------------------------------------------------------ card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run this file on the GPU host)")
    return torch.device("cuda")


def _on(c, dev):
    return (torch.from_numpy(c["corpus"]).to(dev), torch.from_numpy(c["starts"]).to(dev),
            torch.from_numpy(c["ends"]).to(dev), torch.from_numpy(c["n_units"]).to(dev),
            torch.tensor(c["scale"]).to(dev))


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CASES))
def test_ola_kernel_matches_plain(cuda_device, name):
    """The kernel against the plain version on a CPU copy, bit for bit, and
    against the numpy host OLA per utterance (atol 1e-6 x peak) where no
    fragment is longer than max_frag (the host OLA keeps a longer one
    whole); one launch a call, counted, and no host synchronisation inside
    it."""
    c = _case(name)
    waves, starts, ends, n_units, scale = _on(c, cuda_device)
    kw = dict(max_frag=c["max_frag"], out_len=c["out_len"], taper=c["taper"], wave_scale=scale)
    ola.overlap_add_units(waves, starts, ends, n_units, **kw)  # build and ramp outside the check
    torch.cuda.synchronize()
    before = cuda_topk.LAUNCH_COUNTS["overlap_add"]
    torch.cuda.set_sync_debug_mode("error")
    try:
        audio, totals = ola.overlap_add_units(waves, starts, ends, n_units, **kw)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert cuda_topk.LAUNCH_COUNTS["overlap_add"] == before + 1
    want, want_totals = _plain(c)
    assert torch.equal(_bits(audio.cpu()), _bits(want))
    assert torch.equal(totals.cpu(), want_totals)
    audio = audio.cpu().numpy()
    corpus = c["corpus"].astype(np.float32) * c["scale"]
    peak = float(np.abs(corpus).max())
    if (c["ends"] - c["starts"]).max() + 2 * c["taper"] > c["max_frag"]:
        return
    for b in range(0, len(c["n_units"]), max(1, len(c["n_units"]) // 16)):
        n = min(int(c["n_units"][b]), c["starts"].shape[1])
        host = ola.host_overlap_add(corpus, c["starts"][b, :n], c["ends"][b, :n], c["taper"])
        m = min(len(host), c["out_len"])
        np.testing.assert_allclose(audio[b, :m], host[:m], atol=1e-6 * peak)
        assert not audio[b, m:].any()


@pytest.mark.cuda
def test_ola_kernel_int32_cuts(cuda_device):
    """int32 cut points (the device DB's) give the same bits as int64 cuts."""
    c = _case("int16")
    waves, starts, ends, n_units, scale = _on(c, cuda_device)
    kw = dict(max_frag=c["max_frag"], out_len=c["out_len"], taper=c["taper"], wave_scale=scale)
    a, ta = ola.overlap_add_units(waves, starts, ends, n_units, **kw)
    b, tb = ola.overlap_add_units(waves, starts.int(), ends.int(), n_units, **kw)
    assert torch.equal(_bits(a), _bits(b)) and torch.equal(ta, tb)

"""Spans of two kinds, on the CPU (and, marked ``cuda``, on a card).

The partition kernels' voice spans: the per-voice table
(``cuda_topk.voice_spans_of``), the per-tile spans (``tile_spans``), the
CTAs' row mapping (``cta_rows``, the kernel's ``cta_rows`` / ``Rows::base``
in Python) and the split plan over the spans.  A tile's scanned rows must
hold every row that can score finite for one of its targets (a row of the
target's voice; for a dead step, voice id -1, a padding row), each scanned
once whatever the split plan; then the twin with every other row forced to
+inf equals the full twin bit for bit, which is what lets the kernel skip
them.

The synthesiser's stage spans (``utils.StageTimer`` as ``Synthesiser.timer``):
under ``torch.profiler`` a ``synth_batch`` call is the range
``snk.synth_batch`` holding its stages' ranges in order, each stage that
covers device work gets device time once a call, a stream chunk shows its
greedy decode and OLA, nothing is recorded with the profiler off, and the
answers do not change.
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from snickery_tpu_torch.ops import cuda_topk
from snickery_tpu_torch.ops.cuda_topk import (MIN_SPLIT_ROWS, BLOCK_ROWS, cta_rows,
                                              pack_meta, split_plan, tile_spans,
                                              topk_preselect_zt_plain, voice_spans_of)
from snickery_tpu_torch import utils
from snickery_tpu_torch.config import SnickeryConfig
from snickery_tpu_torch.synth import Synthesiser
from snickery_tpu_torch.synthetic_voices import DATADIMS, SR, make_utterances
from snickery_tpu_torch.voicedb.build import build_voicedb
from snickery_tpu_torch.voicedb.device_layout import build_raw_blocks

N_SM = 132


def db_vids(layout: str) -> np.ndarray:
    """Voice ids of the DB rows of one layout (padding rows -1)."""
    if layout == "unaligned":          # voices of 1,000 / 5,003 / 37 rows, then padding
        return np.concatenate([np.full(1000, 0), np.full(5003, 1), np.full(37, 2),
                               np.full(200, -1)]).astype(np.int32)
    if layout == "gaps":               # ids 0, 3, 7 (none of 1, 2, 4-6); voice 3 in two runs
        return np.concatenate([np.full(500, 3), np.full(700, 0), np.full(300, 7),
                               np.full(129, 3), np.full(90, -1)]).astype(np.int32)
    if layout == "no_padding":         # 8 voices of 256 rows, no padding row
        return np.repeat(np.arange(8), 256).astype(np.int32)
    if layout == "padding_only":       # a mesh shard that holds padding rows only
        return np.full(1500, -1, np.int32)
    raise ValueError(layout)


def tgt_vids(T: int, layout: str) -> np.ndarray:
    """Target voice ids: runs of one voice (a tile of one voice, tiles that
    span two), dead steps (-1), an id no row has, and one below -1."""
    rng = np.random.default_rng(T)
    voices = np.unique(db_vids(layout))
    voices = voices[voices >= 0] if (voices >= 0).any() else np.array([0])
    ids = np.repeat(rng.choice(voices, -(-T // 40)), 40)[:T].astype(np.int32)
    ids[rng.random(T) < 0.1] = -1
    ids[T // 3] = 99
    ids[T // 2] = -5
    return ids


def scanned(span, m_rows, splits, chunk, R):
    """Every DB row the CTAs of one target tile scan, in order, from the
    tile bases of ``cta_rows`` over all splits."""
    rows = []
    for s in range(splits):
        for base in cta_rows(span, s, splits, chunk, m_rows, R):
            rows.extend(range(base, min(base + R, m_rows)))
    return rows


LAYOUTS = ["unaligned", "gaps", "no_padding", "padding_only"]


@pytest.mark.parametrize("layout", LAYOUTS)
def test_voice_table_holds_each_voice_hull(layout):
    """Row v + 1 of the table: voice v's hull rounded out to 128-row blocks
    and cut at m_rows; row 0: the padding rows'; low ends negated."""
    vids = db_vids(layout)
    m = len(vids)
    spans = voice_spans_of(torch.from_numpy(vids), m)
    table = spans.table.numpy()
    assert spans.table.dtype == torch.int32 and spans.m_rows == m
    assert table.shape == (max(int(vids.max()) + 1, 0) + 2, 4)
    longest = 0
    for v in range(-1, table.shape[0] - 1):
        rows = np.nonzero(vids == v)[0]
        col = (2, 3) if v == -1 else (0, 1)
        other = (0, 1) if v == -1 else (2, 3)
        assert table[v + 1, other[0]] == -cuda_topk._NO_ROW and table[v + 1, other[1]] == 0
        if len(rows) == 0:
            assert table[v + 1, col[0]] == -cuda_topk._NO_ROW and table[v + 1, col[1]] == 0
            continue
        lo = rows[0] // BLOCK_ROWS * BLOCK_ROWS
        hi = min(-(-(rows[-1] + 1) // BLOCK_ROWS) * BLOCK_ROWS, m)
        assert (-table[v + 1, col[0]], table[v + 1, col[1]]) == (lo, hi)
        if v >= 0:
            longest = max(longest, hi - lo)
    pad = np.nonzero(vids == -1)[0]
    if len(pad):
        longest += min(-(-(pad[-1] + 1) // BLOCK_ROWS) * BLOCK_ROWS, m) - pad[0] // BLOCK_ROWS * BLOCK_ROWS
    assert spans.longest == max(longest, 1)


def test_voice_table_refuses_ids_below_minus_one():
    with pytest.raises(ValueError, match="voice id -3"):
        voice_spans_of(torch.tensor([0, 1, -3], dtype=torch.int32), 3)


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("tile_rows", [64, 128])
@pytest.mark.parametrize("plan", ["planned", "one", "three"])
@pytest.mark.parametrize("R", [64, 128])
def test_tile_rows_cover_every_finite_row_once(layout, tile_rows, plan, R):
    """Each tile's scanned rows hold every row whose voice id one of its
    targets has, and no row twice, whatever the split count and chunk
    (a tile of two voices scans their hull in several chunks a CTA)."""
    vids = db_vids(layout)
    m = len(vids)
    T = 300
    tv = tgt_vids(T, layout)
    spans = voice_spans_of(torch.from_numpy(vids), m)
    per_tile = tile_spans(spans, torch.from_numpy(tv), tile_rows).numpy()
    assert per_tile.shape == (-(-T // tile_rows), 4)
    if plan == "planned":
        splits, chunk = split_plan(T, spans.longest, N_SM, tile_rows, R)
    else:
        splits = 1 if plan == "one" else 3
        chunk = -(-spans.longest // splits // 128) * 128 or 128
    for j in range(per_tile.shape[0]):
        rows = scanned(per_tile[j], m, splits, chunk, R)
        assert len(rows) == len(set(rows)), "a row scanned twice"
        ids = set(tv[j * tile_rows:(j + 1) * tile_rows].tolist())
        ids = {-1 if i < -1 else i for i in ids}
        need = np.nonzero(np.isin(vids, list(ids)))[0]
        missing = set(need.tolist()) - set(rows)
        assert not missing, f"tile {j}: {len(missing)} rows of its voices not scanned"
        if layout == "padding_only" and -1 not in ids:
            assert rows == []


def test_tile_spans_hull_and_padding_interval():
    """A tile of one voice scans that voice's run, rounded out to 128-row
    blocks; a tile with a dead step also the padding rows, as a second
    interval (not the hull of both), made one with the first where the two
    overlap; a tile of two voices their hull."""
    vids = db_vids("unaligned")           # voice 0 [0, 1000), 1 [1000, 6003), 2 .. 6040
    spans = voice_spans_of(torch.from_numpy(vids), len(vids))
    tv = torch.tensor([0] * 64 + [2] * 63 + [-1] + [0] * 32 + [1] * 32, dtype=torch.int32)
    got = tile_spans(spans, tv, 64).tolist()
    no = cuda_topk._NO_ROW
    assert got[0] == [0, 1024, -no, 0]
    assert got[1] == [-5888, 6144, -6016, 6240]      # voice 2 [5888, 6144), padding [6016, 6240)
    assert got[2] == [0, 6016, -no, 0]
    assert cta_rows(got[1], 0, 1, 1024, 6240, 64) == list(range(5888, 6240, 64))


@pytest.mark.parametrize("layout", ["unaligned", "gaps", "padding_only"])
@pytest.mark.parametrize("tile_rows", [64, 128])
def test_twin_over_the_spans_equals_the_full_twin(layout, tile_rows):
    """The plain twin with every row outside a target tile's scanned rows
    forced to +inf returns exactly the full twin's ids and scores: the rows
    the kernel skips could not have entered any list."""
    vids = db_vids(layout)
    m, kd, T, k = len(vids), 12, 200, 40
    rng = np.random.default_rng(3)
    feats = rng.standard_normal((m, kd)).astype(np.float32)
    aff = (np.zeros(kd, np.float32), np.ones(kd, np.float32), np.ones(kd, np.float32))
    jr = np.roll(feats, -1, 0)
    raw = torch.from_numpy(build_raw_blocks(feats, jr, m, affine=aff)[0])
    aff = tuple(map(torch.from_numpy, aff))
    tv = tgt_vids(T, layout)
    zeros = lambda n: torch.zeros(n, dtype=torch.int32)
    masks = dict(tgt_meta=pack_meta(zeros(T), zeros((T, 5)), torch.from_numpy(tv)),
                 db_meta=pack_meta(zeros(m), zeros((m, 5)), torch.from_numpy(vids)),
                 partition=True)
    x = torch.from_numpy(rng.standard_normal((T, kd)).astype(np.float32))
    full = topk_preselect_zt_plain(x, raw, k, aff, m, **masks)
    spans = voice_spans_of(masks["db_meta"][:, 6], m)
    per_tile = tile_spans(spans, masks["tgt_meta"][:, 6], tile_rows).numpy()
    splits, chunk = split_plan(T, spans.longest, N_SM, tile_rows, 128)
    allowed = torch.zeros((len(per_tile), m), dtype=torch.bool)
    for j, span in enumerate(per_tile):
        allowed[j, scanned(span, m, splits, chunk, 128)] = True
    calls = []
    real = cuda_topk._masked_scores

    def masked_scores(scores_of, t0, t1, lo, hi, *args):
        calls.append(1)
        s = real(scores_of, t0, t1, lo, hi, *args)
        keep = allowed[torch.arange(t0, t1) // tile_rows][:, lo:hi]
        return torch.where(keep, s, torch.tensor(float("inf")))

    cuda_topk._masked_scores = masked_scores
    try:
        over = topk_preselect_zt_plain(x, raw, k, aff, m, **masks)
    finally:
        cuda_topk._masked_scores = real
    assert calls
    assert torch.equal(over[0], full[0])
    assert torch.equal(over[1].view(torch.int32), full[1].view(torch.int32))


@pytest.mark.parametrize("T,voice,pad", [(64, 32768, 4096), (1024, 32768, 0), (16384, 32768, 0),
                                         (64, 37, 200), (300, 5003, 200)])
@pytest.mark.parametrize("R", [64, 128])
def test_split_plan_over_the_spans(T, voice, pad, R):
    """split_plan over the longest voice and the padding rows: whole DB
    tiles a split, no empty split, the span covered, splits no shorter than
    MIN_SPLIT_ROWS where the span has that many rows, and no more CTAs than
    four waves; a tile of two voices is covered too (several chunks a CTA)."""
    vids = np.concatenate([np.repeat(np.arange(8), voice), np.full(pad, -1)]).astype(np.int32)
    spans = voice_spans_of(torch.from_numpy(vids), len(vids))
    rows = spans.longest
    splits, chunk = split_plan(T, rows, N_SM, 128 if T > 64 else 64, R)
    assert chunk % R == 0 and splits >= 1
    assert splits * chunk >= rows and (splits - 1) * chunk < rows
    if rows >= MIN_SPLIT_ROWS:
        assert chunk >= MIN_SPLIT_ROWS or splits == 1
    assert -(-T // (128 if T > 64 else 64)) * splits <= 4 * N_SM
    two = tile_spans(spans, torch.tensor([0] * 32 + [3] * 31 + [-1], dtype=torch.int32), 64)[0]
    got = scanned(two.tolist(), len(vids), splits, chunk, R)
    need = np.nonzero(np.isin(vids, [0, 3, -1]))[0]
    assert set(need.tolist()) <= set(got) and len(got) == len(set(got))


def test_device_db_carries_its_spans_and_the_masks_pass_them():
    """DeviceDB makes its span table once; fused_masks hands it to the
    kernel with the partition mask and not without."""
    from snickery_tpu_torch.synth import DeviceDB, fused_masks
    vids = torch.from_numpy(db_vids("unaligned"))
    m = vids.shape[0]
    z = lambda *s: torch.zeros(s, dtype=torch.float32)
    zi = lambda *s: torch.zeros(s, dtype=torch.int32)
    db = DeviceDB(raw=z(m + 2, 4), n_real=torch.tensor(m - 200, dtype=torch.int32),
                  cut1=zi(m), cut2=zi(m), waves=z(128), wave_scale=torch.tensor(1.0),
                  mean_t=z(2), std_t=z(2) + 1, sqrt_wt=z(2) + 1, mean_j=z(2),
                  std_j=z(2) + 1, sqrt_wj=z(2) + 1, codes=zi(m), ctx=zi(m, 5), vids=vids)
    assert torch.equal(db.spans.table, voice_spans_of(vids, m).table)
    args = (zi(1, 4), zi(1, 4, 5), zi(1, 4))
    assert fused_masks(db, *args, halfphone=False, multivoice=True,
                       ling_weights=None)["voice_spans"] is db.spans
    assert fused_masks(db, *args, halfphone=True, multivoice=False,
                       ling_weights=None)["voice_spans"] is None


# ------------------------------------------------------------- stage spans
# the stages of one single-device synth_batch call, in order; "derive" comes
# before "preselect" where the config's zero_transient is 0
CALL_STAGES = ["synth_batch", "prepare", "pad", "copy_in", "synth_step", "preselect",
               "rescore", "decode", "ola", "copy_out", "results"]
STEP_STAGES = {"derive", "preselect", "rescore", "decode", "ola", "copy_out"}
DEVICE_STAGES = {"copy_in", "derive", "preselect", "rescore", "decode", "ola", "copy_out"}


def stage_voice(device: str, zero_transient: int):
    """A Synthesiser over a small numpy voice (~700 epoch units) and three
    held-out trajectories of 64 units."""
    cfg = SnickeryConfig(stream_list=list(DATADIMS), datadims=dict(DATADIMS), sample_rate=SR,
                         n_candidates=8, taper_length=50, length_buckets=[64],
                         voice_name="spans", preselect_precision="split3cat",
                         zero_transient=zero_transient)
    db = build_voicedb(cfg, make_utterances(np.random.default_rng(3), 6, 120, "u"))
    held = [u.features for u in make_utterances(np.random.default_rng(4), 3, 66, "h")]
    return Synthesiser(cfg, db=db, device=device), held


@pytest.fixture(scope="module", params=[1, 0], ids=["raw_block", "derived"])
def voice(request):
    return (*stage_voice("cpu", request.param), request.param)


def call_stages(zero_transient: int) -> list:
    stages = list(CALL_STAGES)
    if zero_transient == 0:
        stages.insert(stages.index("preselect"), "derive")
    return stages


def snk_ranges(prof) -> list:
    """(start, end, stage) of each ``snk.*`` host range the profiler recorded,
    in order of start (not the copies a card trace mirrors on its timeline)."""
    host = torch.autograd.DeviceType.CPU
    return sorted((e.time_range.start, e.time_range.end, e.name[len("snk."):])
                  for e in prof.events()
                  if e.name.startswith("snk.") and e.device_type == host)


def within(inner, outer) -> bool:
    return outer[0] <= inner[0] and inner[1] <= outer[1]


def traced(fn, cuda: bool = False):
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        out = fn()
    return out, prof


@pytest.mark.parametrize("greedy", [False, True], ids=["viterbi", "greedy"])
def test_synth_batch_spans_nest_in_order_once_a_call(voice, greedy):
    synth, held, zt = voice
    before = dict(synth.timer.device_times())
    calls = 2
    _, prof = traced(lambda: [synth.synth_batch(held, greedy=greedy) for _ in range(calls)])
    ranges = snk_ranges(prof)
    want = call_stages(zt)
    assert [r[2] for r in ranges] == want * calls
    for c in range(calls):
        call = ranges[c * len(want):(c + 1) * len(want)]
        by_name = {r[2]: r for r in call}
        assert all(within(r, by_name["synth_batch"]) for r in call)
        assert all(within(r, by_name["synth_step"]) for r in call if r[2] in STEP_STAGES)
        # siblings follow one another without overlapping
        top = [r for r in call[1:] if r[2] not in STEP_STAGES]
        step = [r for r in call if r[2] in STEP_STAGES]
        for level in (top, step):
            assert all(a[1] <= b[0] for a, b in zip(level, level[1:]))
    times = synth.timer.device_times()
    assert set(times) == DEVICE_STAGES - ({"derive"} if zt else set())
    for name, (seconds, n) in times.items():
        assert n - before.get(name, (0.0, 0))[1] == calls
        assert seconds > before.get(name, (0.0, 0))[0]


def test_a_stream_chunk_shows_its_greedy_decode_and_ola(voice):
    synth, held, zt = voice
    before = synth.timer.device_times()
    chunks = [held[0][i:i + 20] for i in range(0, len(held[0]), 20)]
    _, prof = traced(lambda: list(synth.synth_streaming(iter(chunks))))
    names = [r[2] for r in snk_ranges(prof)]
    n_chunks = names.count("greedy")
    assert n_chunks >= 3 and names.count("ola") == n_chunks and "decode" not in names
    step = ["derive"] if zt == 0 else []
    assert names == (step + ["preselect", "rescore", "greedy", "ola"]) * n_chunks
    after = synth.timer.device_times()
    for name in ("greedy", "ola"):
        assert after[name][1] - before.get(name, (0.0, 0))[1] == n_chunks


def test_with_the_profiler_off_nothing_is_recorded_or_pending(voice):
    synth, held, _ = voice
    synth.timer = utils.StageTimer()
    synth.synth_batch(held)
    list(synth.synth_streaming(iter([held[0][:40], held[0][40:]])))
    assert synth.timer._pending == [] and synth.timer.device_times() == {}
    # the host clock still times every stage
    assert synth.timer.counts["synth_batch"] == 1 and synth.timer.counts["copy_in"] == 1
    assert synth.timer.counts["ola"] >= 2 and synth.timer.counts["greedy"] >= 1


@pytest.mark.parametrize("greedy", [False, True], ids=["viterbi", "greedy"])
def test_answers_are_bit_equal_with_the_profiler_on_and_off(voice, greedy):
    synth, held, _ = voice
    off = synth.synth_batch(held, greedy=greedy)
    on, _ = traced(lambda: synth.synth_batch(held, greedy=greedy))
    for a, b in zip(off, on):
        assert np.array_equal(a["unit_ids"], b["unit_ids"])
        assert np.array_equal(a["wave"], b["wave"]) and a["total_cost"] == b["total_cost"]


@pytest.mark.parametrize("device", [None, "cpu"], ids=["host", "cpu_device"])
def test_a_span_is_a_profiler_range_and_times_the_cpu_device_by_the_host(device):
    timer = utils.StageTimer()
    dev = None if device is None else torch.device(device)
    with timer.stage("outside", dev):
        pass

    def span():
        with timer.stage("a", dev):
            pass

    _, prof = traced(span)
    assert [r[2] for r in snk_ranges(prof)] == ["a"]
    assert timer.counts == {"outside": 1, "a": 1}
    times = timer.device_times()
    if device is None:
        assert times == {}
    else:
        assert list(times) == ["a"] and times["a"][1] == 1
        assert times["a"][0] <= timer.totals["a"]


class FakeEvent:
    """A timing event on a made-up stream: recording one advances the clock
    by 1 ms; it completes when ``finish`` or ``synchronize`` says so."""
    clock = 0.0

    def __init__(self, enable_timing=False):
        self.t, self.done = None, False

    def record(self, stream=None):
        FakeEvent.clock += 1.0
        self.t = FakeEvent.clock

    def query(self):
        return self.done

    def synchronize(self):
        self.done = True

    def elapsed_time(self, end):
        assert end.done           # and so the start, recorded before it on the stream
        return end.t - self.t


def test_card_spans_record_event_pairs_resolved_later_and_bounded(monkeypatch):
    """The card's path of a span, with the events faked: a pair a span, no
    device time until the pair completes, and never more than
    ``MAX_PENDING`` pairs waiting."""
    monkeypatch.setattr(torch.cuda, "Event", FakeEvent)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: "stream")
    timer = utils.StageTimer()
    timer.MAX_PENDING = 4
    card = torch.device("cuda")
    waiting = []

    def spans():
        for i in range(3):
            with timer.stage("a", card):
                pass
        timer.resolve()
        waiting.append(len(timer._pending))
        timer._pending[0][2].done = True
        timer.resolve()
        waiting.append(len(timer._pending))
        for i in range(7):
            with timer.stage("b", card):
                pass
            waiting.append(len(timer._pending))

    traced(spans)
    assert waiting[:2] == [3, 2] and max(waiting) <= timer.MAX_PENDING
    assert timer.device_times() == {"a": (3e-3, 3), "b": (7e-3, 7)}
    assert timer._pending == []


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: device-timed spans are read on the card")


@pytest.mark.cuda
@pytest.mark.parametrize("greedy", [False, True], ids=["viterbi", "greedy"])
def test_every_device_timed_stage_reads_above_zero_on_the_card(card, greedy):
    synth, held = stage_voice("cuda", 0)
    synth.synth_batch(held, greedy=greedy)                        # builds the kernels
    _, prof = traced(lambda: synth.synth_batch(held, greedy=greedy), cuda=True)
    assert [r[2] for r in snk_ranges(prof)] == call_stages(0)
    times = synth.timer.device_times()
    assert set(times) == DEVICE_STAGES
    assert all(seconds > 0 and n == 1 for seconds, n in times.values())
    chunks = [held[0][i:i + 20] for i in range(0, len(held[0]), 20)]
    traced(lambda: list(synth.synth_streaming(iter(chunks))), cuda=True)
    times = synth.timer.device_times()
    assert times["greedy"][0] > 0 and times["greedy"][1] >= 3

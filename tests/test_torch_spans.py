"""The partition kernels' voice spans, on the CPU: the per-voice table
(``cuda_topk.voice_spans_of``), the per-tile spans (``tile_spans``), the
CTAs' row mapping (``cta_rows``, the kernel's ``cta_rows`` / ``Rows::base``
in Python) and the split plan over the spans.

A tile's scanned rows must hold every row that can score finite for one
of its targets (a row of the target's voice; for a dead step, voice id
-1, a padding row), each scanned once whatever the split plan; then the
twin with every other row forced to +inf equals the full twin bit for
bit, which is what lets the kernel skip them.
"""

import numpy as np
import pytest
import torch

from snickery_tpu_torch.ops import cuda_topk
from snickery_tpu_torch.ops.cuda_topk import (MIN_SPLIT_ROWS, BLOCK_ROWS, cta_rows,
                                              pack_meta, split_plan, tile_spans,
                                              topk_preselect_zt_plain, voice_spans_of)
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

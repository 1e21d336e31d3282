"""Constants shared across the pipeline (a copy of ``snickery_tpu.const``).

Mirrors the *role* of the reference's script/const.py (unverified — reference
mount empty; see SURVEY.md §2 row 7): big-penalty sentinels, label field
layout, default stream names.
"""

# Large-but-finite penalty used to mask out invalid lattice transitions /
# padded candidates.  Finite (not inf) so Viterbi argmin tie-breaking stays
# well-defined in f32 and XLA does not propagate NaNs through min-reductions.
BIG_PENALTY = 1.0e10

# Padded / invalid unit id sentinel in candidate matrices.
PAD_UNIT = -1

# Stream names used by the magphase-style feature family
# (reference README: mag/real/imag/lf0 epoch-synchronous streams).
MAGPHASE_STREAMS = ("mag", "real", "imag", "lf0")

# Halfphone naming: each phone contributes a left half ("<phone>_L") and a
# right half ("<phone>_R").
HALFPHONE_TAGS = ("L", "R")

# Unvoiced lf0 sentinel on the linear-Hz scale before interpolation.
UNVOICED_LF0 = -1.0e10

# Quinphone linguistic-preselection penalties (halfphone mode).  A wrong
# halfphone identity costs ID_RANK_PENALTY; context mismatches cost
# weight * QUINPHONE_SCALE so that immediate neighbours (weight 10)
# dominate second-order context (weight 1) and any context mismatch
# outranks acoustic distance.  The centre weight is 0 because the centre
# phone IS the unit identity (already hard-matched).  These are design
# decisions (reference mount empty — SURVEY.md provenance warning),
# overridable per-voice via config keys quinphone_context_weights /
# quinphone_penalty_scale.
QUINPHONE_CONTEXT_WEIGHTS = (1.0, 10.0, 0.0, 10.0, 1.0)
QUINPHONE_SCALE = 100.0

# Halfphone-identity penalty in the preselect RANKING scores.  2^24: large
# enough that every identity-mismatched unit ranks after every same-name
# unit (it dominates the largest context tier, 2^23 in backoff mode, plus
# any realistic squared distance on normalised features, ~1e5), yet small
# enough that f32 ulp at the shifted scores is 2.0 — so the ACOUSTIC
# ordering among mismatched units survives the shift and the fallback
# candidate pool (steps whose same-name pool is exhausted) matches the
# float64 oracle's, up to boundary noise the preselect margin + exact
# rescoring already absorb.  BIG_PENALTY (1e10, f32 ulp 1024) here would
# absorb the acoustic order entirely and id-order the fallback pool
# (measured: 0.9625 vs 1.000 halfphone oracle agreement).  NOT used for
# lattice costs — the lattice applies the identity rule as a mask
# (synth.synth_pipeline_step).
ID_RANK_PENALTY = float(2 ** 24)

# Default sample rate (Hz) — reference voices are 16 kHz or 48 kHz.
DEFAULT_SAMPLE_RATE = 16000

# Join context: how the trainer summarises each unit's edges for join costs.
# "first"/"last" frame of each unit's feature trajectory (reference behaviour
# per SURVEY.md §2 row 1).
JOIN_CONTEXT_FRAMES = 1

# Preselect rank margin for approximate (bf16-split) kernel precisions.
# Measured cost: k=40 vs k=30 kernel = 179.5 vs 169.9 ms at 16k rows x
# 1.15M units (~4% of the full step) — cheap insurance for the ≥99%
# agreement guarantee; do not trim without re-running the bench oracle gate.
# the Pallas kernel RANKS with split3/split3cat matmuls (~1e-3 absolute
# score error), so the true k-th candidate can fall just past rank k.
# Selecting k + PRESELECT_MARGIN and keeping the exact-f32 top-k after
# rescoring makes a boundary miss require a ranking error larger than the
# rank-k -> rank-(k+margin) score gap (measured: closes the last ~2% of
# unit-sequence disagreement vs the float64 oracle at 1M units).  Exact
# precisions ("highest", and the XLA fallback path) need no margin.
PRESELECT_MARGIN = 10

# split3cat concentrates all three bf16 product terms into ONE MXU pass and
# is the production speed mode.  Round-4 sweep at the 1.05M-unit voice
# (scripts/exp_fidelity.py, 65k decoded rows vs exact f32, zero-transient
# operand): margin 10 -> tie-adjusted 0.99991 / worst f64 path-cost gap
# 2.6e-4 @ 975 ms/step; margin 18 -> 0.99998 / 2.3e-5 @ 1006 ms (+3.2%,
# matching split3's broad-gate numbers exactly); margin 34 -> identical to
# 18 @ 1076 ms.  18 is the knee — the residual gap is shared with split3
# (same bf16 hi/lo representation, see ROADMAP.md), not a rank-margin
# artefact, so paying for 34 buys nothing.  NOTE: these numbers hold for
# the ZERO-TRANSIENT operand form (in-kernel bf16 split); the materialised
# HBM operand form was measured raw 0.92 at ANY margin (10/18/34/66) —
# scrambled rows at the Pallas parameter boundary, not ranking noise — and
# is no longer reachable by default (ops.topk.zero_transient_default).
PRESELECT_MARGIN_SPLIT3CAT = 18

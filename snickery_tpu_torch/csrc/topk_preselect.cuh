// Fused distance + top-k preselect, hand-written CUDA C++ for Hopper
// (sm_90a): the kernels and their launchers, shared by the two sources that
// export entry points, topk_preselect.cu (the zero-transient form) and
// topk_derived.cu (the derived-operand form), each with one sibling per
// selection variant (_phase, _packed, _packed3).  Each source is compiled
// on its own, in parallel.
//
// Replaces snickery_tpu/ops/pallas_topk.py::pallas_topk_preselect
// (_topk_kernel + _compute_scores and its selection loops), with
// zero_transient=True (:745-794) or False (the derived operand, :795-811),
// in every selection form: select="stream" (_stream_select, the form the
// synthesis paths run), "phase" (:572-641), "packed" (_packed_select) and
// "packed3" / "packed3diag" (_packed3_select); see "Selection" below.  At
// precision "highest" with or without the fused partition mask (multi-voice
// DBs, _compute_scores :187-191) and the fused quinphone penalties
// (halfphone voices, :192-208): topk_partial<PART, LING>.  At the bf16-split precisions "split3"
// (_split3_dot :77-93) and "split3cat" (_bf16_split :96-99, the [hi|hi|lo]
// concat :112-130, :158-178), with the same fused masks applied after the
// product (:156-208 composed): topk_partial_split<PREC, PART, LING,
// PRESPLIT>.  Both templates take the selection as a last parameter SEL.
// One exported entry point per (form, precision, masks, selection), 96 in
// all: 24 a selection, exported by one source per (form, selection).
//
// For every target row t and DB row u in [0, m_rows):
//
//     score(t, u) = sqn[u] - 2 * cross(t, u),  cross = sum_{c < kd} db[u, c] * t2[t, c]
//
// Zero-transient form: db is the (q, kd + 2) block [data kd | sqn | ptr]
// built by voicedb.device_layout.build_raw_blocks(affine=...), t2 the
// targets prescaled by sqrt_w / std, and comp[t] = 2 * (t2[t] . mean) is
// added to the returned scores.  Column kd holds the squared norm of the
// normalised row (1e6-sentinel norm for padding rows); column kd + 1 holds
// int32 pointer BITS and is never loaded (as f32 it can be NaN or denormal).
// Derived form: db is the normalised, weighted operand the wrapper derives
// each step (padding rows 1e6 * sqrt_w), sqn a separate (m_rows,) vector of
// its squared row norms, t2 the normalised, weighted targets themselves, and
// nothing is added back.  At "highest" and "split3" the operand is (m_rows,
// kd) f32; at "split3cat" it is pre-split: (m_rows, 2 kp) bf16 rows
// [hi | lo], hi = bf16_rn(x), lo = bf16_rn(x - hi), each half zero-padded
// to kp = kd rounded up to KC, so a row is 4 kp bytes (640 at kd 151), a
// multiple of 128, and is staged with 16-byte loads.  The kernels read sqn
// through a pointer and a stride: the raw block's column kd (stride width)
// or the vector (stride 1).  Per target the k smallest (score, u) pairs are
// kept, the lowest u winning ties.
//
// Precisions.  "highest": cross in FP32 FMAs on the CUDA cores.  The split
// precisions cut each operand once into bf16 hi = bf16_rn(x) and
// lo = bf16_rn(x - hi), as JAX's astype(bfloat16) does, and form
// cross = hi.hi + hi.lo + lo.hi (raw side first) on the tensor cores
// (mma.sync m16n8k16, bf16 in, f32 accumulate).  Each bf16 x bf16 product is
// exact in f32, so only the summation order differs from the TPU kernel:
// "split3cat" keeps one accumulator over the 3 * kd pairs (the TPU's one
// K = 3d pass), "split3" three, combined as (hh + hl) + lh (its three
// passes).
//
// Fused masks, at every precision, applied to the score after the product in
// the Pallas order (so at "highest" the plain twin agrees bit for bit):
//   PART: score = +inf where vid(t) != vid(u);
//   LING: score += 2^24 (const.ID_RANK_PENALTY) where code(t) != code(u),
//         then score += pen[c] where ctx_c(t) != ctx_c(u), c = 0..4 in order,
//         skipping slots whose constant is 0; pen[c] = float32(w_c * scale)
//         is rounded on the host.
// Each side describes a row with 8 int32 [code, ctx0..ctx4, vid, 0] (two
// int4 loads); target rows of the tile and the DB rows of each tile are
// staged in shared memory.  A +inf score never enters a list, so a slot that
// no finite score reaches (a voice with fewer than k rows) is written as
// (+inf, index 0): the Pallas contract for partition-starved columns.
//
// Shape of the work on Hopper.  The TPU kernel walks the DB chunk by chunk
// in sequence and carries a k-slot state in VMEM.  Here blocks run in
// parallel and in no order, so the DB is cut into S contiguous splits as
// well as the targets into tiles of TT rows:
//
//   pass 1 (topk_partial, topk_partial_split), grid (target tiles) x
//     (S splits): the target tile sits in shared memory; DB rows stream
//     through shared memory in tiles of R rows x KC columns, f32 rows with
//     scalar loads (neither the raw block's 4 * (kd + 2)-byte row stride
//     nor the derived operand's 4 * kd is 16-byte aligned at kd 151 or
//     453), pre-split rows with one 16-byte load per 8 bf16.
//     "highest": each thread accumulates a 4 x 4 register tile with FP32
//     FMAs (no TF32).  Split precisions: an f32 tile is split to bf16 hi /
//     lo while it is stored (a pre-split one is copied as it is), and each
//     warp computes a 16-row x 32-target block of the 64 x 64 tile with
//     mma.sync.  After each DB tile one warp per
//     target offers the tile's 64 scores to a sorted k-slot list in shared
//     memory: a candidate enters only if it beats the worst (score, index)
//     pair, so a warm list costs one ballot per 32 scores.
//   pass 2 (topk_merge): one warp per target merges the S sorted partial
//     lists under the same (score, index) order and adds comp (the
//     zero-transient form only).
//
// S is chosen by the wrapper so that tiles x S fills the card at small T
// (one utterance: 2 to 32 target tiles) as well as at large T.
//
// Selection (SEL), the epilogue that follows each DB tile's scores; the
// product, the masks and the two-pass shape are the same in all four:
//   STREAM  (offer_tile): every score that beats the list's worst (score,
//     index) pair is inserted, in lane order; exact, lowest index on ties.
//   PHASE   (phase_tile): rounds of warp minimum, lowest index holding it,
//     insert, mask the extracted element, until the tile's remaining
//     minimum no longer beats the list's worst: the same exact top-k, bit
//     for bit, found the way the Pallas phase loop finds it.
//   PACKED  (packed_tile): the lists hold int keys, key = to_key(score) with
//     the low 7 bits replaced by u & 127 (pallas_topk.py:212-217, :524-527,
//     BLOCK = 128), ordered by (key, u); a candidate is screened with one
//     int compare.  Pass 2 unpacks (from_key, :220-226) and adds comp, so a
//     returned score lies within 127 ulp of the score that was ranked.
//   PACKED3 (packed3_tile): per target and 128-row block the three
//     smallest keys, by three warp reductions a tile (a block spans two
//     tiles; the running three wait in shared memory), offered to the list
//     at the block's end, and the least third key of any block kept per
//     (target, split).  Pass 2 raises a target's overflow flag where that
//     least third key lies below the worst key kept: some block may hold a
//     fourth row that belongs in the list.  A target without flag has
//     exactly the PACKED result.  Splits start on multiples of 128.
// In the packed forms a +inf score (a masked row) gets no key and enters no
// list, as in the other two, so dead slots read (+inf, 0) in all four; the
// Pallas kernel fills them with (+inf, some row).
//
// Shared memory of pass 1 ("highest") is 4 * (64 * kd + 8,256 + 128 * k)
// bytes, plus 4 KB of metadata in the masked variants: at kd = 151 (epoch
// units) two CTAs fit per SM; at kd = 453 (halfphone units, [first | mid |
// last] frames) about 150-160 KB, so one CTA per SM.  The split variants
// hold the target tile as bf16 hi and lo (the same bytes as one f32 copy,
// row stride padded by 8 against bank conflicts): 4 * (4,160 + 128 * k) +
// 256 * (kd rounded up to 32, + 8) + 10,240 bytes, plus the same 4 KB of
// metadata in the masked variants: about 96 KB at kd 151 and k 48, so two
// CTAs still fit per SM; about 176 KB at kd 453 (halfphone), one CTA.  The
// derived form uses the same layouts, and the pre-split operand stages
// into the same bf16 hi / lo tiles, so each derived variant needs exactly
// the shared memory of its zero-transient twin (partial_smem).
//
// Bound: at the config-3 batch shape (65,536 targets x 1,048,576 units x
// kd = 151) "highest" is about 2.1e13 FLOP of FP32 FMA, so it is bound by
// FP32 FMA throughput and shared-memory operand traffic, in either form.
// The split variants do 3x the products at bf16 tensor-core rate, which
// leaves them bound by the DB staging (every target tile reads the ~640 MB
// block or operand, from device memory about once per wave of resident
// tiles and from L2 for the rest) and by the selection epilogue.  The
// derived form moves more bytes than the zero-transient one (the operand is
// written and read each step) but the same FLOP, so it stays bound by
// operations; its pre-split split3cat operand removes the split arithmetic
// and the scalar loads from the staging, which is what it measures.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstddef>
#include <cstdint>

namespace {

constexpr int TT = 64;                  // target rows per CTA
constexpr int R = 64;                   // DB rows per tile
constexpr int KC = 32;                  // DB columns per shared-memory stage
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int KMAX = 64;                // list slots: two per lane
constexpr unsigned FULL = 0xffffffffu;
constexpr int META = 8;                 // [code, ctx0..ctx4, vid, 0]
constexpr float ID_RANK_PENALTY = 16777216.f;   // 2^24, const.ID_RANK_PENALTY
// preselect precisions; the values are the ``precision`` argument of
// snk_topk_partial_smem
constexpr int HIGHEST = 0, SPLIT3 = 1, SPLIT3CAT = 2;
// selections; the values are the ``select`` argument of snk_topk_partial_smem
constexpr int STREAM = 0, PHASE = 1, PACKED = 2, PACKED3 = 3;
constexpr int BLOCK = 128;              // rows of a packed3 block; a packed key
                                        // carries u & (BLOCK - 1)
constexpr int KEY_EMPTY = INT_MAX;      // no key: an empty slot, a +inf score
constexpr int B3 = 4;                   // packed3 state a target: the block's
                                        // three least keys, the least third
constexpr int KS = 16;                  // mma depth (bf16 pairs)
constexpr int SPAD = 8;                 // bf16 row padding of the split tiles
constexpr int DS = KC + SPAD;           // bf16 row stride of the DB stage

struct Penalties {
  float w[5];                             // float32(w_c * scale); 0 = skip
};

__device__ __forceinline__ float pos_inf() { return __int_as_float(0x7f800000); }

__device__ __forceinline__ bool lex_less(float av, int ai, float bv, int bi) {
  return av < bv || (av == bv && ai < bi);
}

__device__ __forceinline__ bool lex_less(int ak, int ai, int bk, int bi) {
  return ak < bk || (ak == bk && ai < bi);
}

// Order-preserving f32 -> int32 key (pallas_topk._to_key): non-negative bit
// patterns as they are, negative ones with their magnitude bits flipped.
__device__ __forceinline__ int to_key(float s) {
  const int u = __float_as_int(s);
  return u < 0 ? u ^ 0x7fffffff : u;
}

// Its inverse for packed keys (pallas_topk._from_key): clamped at the +inf
// pattern, so KEY_EMPTY reads +inf.
__device__ __forceinline__ float from_key(int key) {
  key = min(key, 0x7f800000);
  return __int_as_float(key < 0 ? key ^ 0x7fffffff : key);
}

// The key of score s at DB row u, or KEY_EMPTY where the row takes no part
// (past the split's end, or a score that is not below +inf).
__device__ __forceinline__ int packed_key(float s, int u, bool in_range) {
  return in_range && s < pos_inf()
             ? (to_key(s) & ~(BLOCK - 1)) | (u & (BLOCK - 1))
             : KEY_EMPTY;
}

// Insert (v, i) into the ascending k-slot list (lv, li) in shared memory
// (V float: scores; V int: packed keys).  Warp-cooperative; the caller has
// checked that (v, i) beats slot k - 1.
template <typename V>
__device__ void warp_insert(V* lv, int* li, int k, V v, int i, int lane) {
  const int j0 = lane, j1 = lane + 32;
  const bool in0 = j0 < k, in1 = j1 < k;
  const V v0 = in0 ? lv[j0] : V(0);
  const int i0 = in0 ? li[j0] : 0;
  const V v1 = in1 ? lv[j1] : V(0);
  const int i1 = in1 ? li[j1] : 0;
  const unsigned b0 = __ballot_sync(FULL, in0 && lex_less(v0, i0, v, i));
  const unsigned b1 = __ballot_sync(FULL, in1 && lex_less(v1, i1, v, i));
  const int p = __popc(b0) + __popc(b1);       // insertion slot
  // slot j keeps itself below p, takes (v, i) at p and slot j - 1 above p
  const V pv0 = (in0 && j0 > 0) ? lv[j0 - 1] : V(0);
  const int pi0 = (in0 && j0 > 0) ? li[j0 - 1] : 0;
  const V pv1 = in1 ? lv[j1 - 1] : V(0);
  const int pi1 = in1 ? li[j1 - 1] : 0;
  __syncwarp();
  if (in0 && j0 >= p) {
    lv[j0] = j0 == p ? v : pv0;
    li[j0] = j0 == p ? i : pi0;
  }
  if (in1 && j1 >= p) {
    lv[j1] = j1 == p ? v : pv1;
    li[j1] = j1 == p ? i : pi1;
  }
  __syncwarp();
}

// Offer one candidate per lane (ok = the lane holds one) to the list; the
// finite candidates that beat the worst slot are inserted one at a time in
// lane order, each re-checked against the worst slot as it stands then.
__device__ void warp_offer(float* lv, int* li, int k, float v, int i, bool ok,
                           int lane) {
  unsigned m = __ballot_sync(
      FULL, ok && v < pos_inf() && lex_less(v, i, lv[k - 1], li[k - 1]));
  while (m) {
    const int src = __ffs(m) - 1;
    m &= m - 1;
    const float cv = __shfl_sync(FULL, v, src);
    const int ci = __shfl_sync(FULL, i, src);
    if (lex_less(cv, ci, lv[k - 1], li[k - 1])) {
      warp_insert(lv, li, k, cv, ci, lane);
    }
  }
}

// The packed forms' offer: one candidate key per lane (ok = the lane holds
// one; never KEY_EMPTY).  One int compare screens a candidate against the
// worst key; the ones that pass (an equal key among them) are inserted one
// at a time in lane order under the (key, index) order.
__device__ void warp_offer_key(int* lk, int* li, int k, int key, int i, bool ok,
                               int lane) {
  unsigned m = __ballot_sync(FULL, ok && key <= lk[k - 1]);
  while (m) {
    const int src = __ffs(m) - 1;
    m &= m - 1;
    const int ck = __shfl_sync(FULL, key, src);
    const int ci = __shfl_sync(FULL, i, src);
    if (lex_less(ck, ci, lk[k - 1], li[k - 1])) {
      warp_insert(lk, li, k, ck, ci, lane);
    }
  }
}

// Every list of the CTA empty: (+inf, INT_MAX) in each slot, or
// (KEY_EMPTY, INT_MAX) where the lists hold packed keys; the packed3 state
// sB3 [TT][B3] all KEY_EMPTY.
template <int SEL>
__device__ void init_lists(float* lv, int* li, int* sB3, int k, int tid) {
  constexpr bool KEYS = SEL == PACKED || SEL == PACKED3;
  const float none = KEYS ? __int_as_float(KEY_EMPTY) : pos_inf();
  for (int e = tid; e < TT * k; e += THREADS) {
    lv[e] = none;
    li[e] = INT_MAX;
  }
  if constexpr (SEL == PACKED3) {
    for (int e = tid; e < TT * B3; e += THREADS) sB3[e] = KEY_EMPTY;
  }
}

// STREAM.  One warp per target offers the tile's R scores sS[t][.] (DB rows
// base .. base + R - 1, those at or past row_hi left out) to its list.
__device__ void offer_tile(const float* sS, float* lv, int* li, int k, int t0,
                           int T, int base, int row_hi, int warp, int lane) {
  for (int t = warp; t < TT; t += WARPS) {
    if (t0 + t >= T) continue;            // uniform across the warp
    for (int h = 0; h < R; h += 32) {
      const int u = base + h + lane;
      warp_offer(lv + t * k, li + t * k, k, sS[t * R + h + lane], u,
                 u < row_hi, lane);
    }
  }
}

// PHASE.  One warp per target; a lane holds the tile's rows lane and
// lane + 32.  Each round finds the least remaining score of the tile (warp
// minimum), the lowest row that holds it (warp minimum of the indices),
// inserts the pair and masks that element, and the rounds end when the
// pair no longer beats the list's worst: the exact (score, index) top-k of
// offer_tile, bit for bit (the inserted value is the element's own).
__device__ void phase_tile(const float* sS, float* lv, int* li, int k, int t0,
                           int T, int base, int row_hi, int warp, int lane) {
  const int u0 = base + lane, u1 = u0 + 32;
  for (int t = warp; t < TT; t += WARPS) {
    if (t0 + t >= T) continue;            // uniform across the warp
    float* tv = lv + t * k;
    int* ti = li + t * k;
    float a = sS[t * R + lane], b = sS[t * R + 32 + lane];
    if (!(u0 < row_hi && a < pos_inf())) a = pos_inf();
    if (!(u1 < row_hi && b < pos_inf())) b = pos_inf();
    while (true) {
      const bool first = a <= b;          // u0 < u1: the lower row on a tie
      const float cv = first ? a : b;
      const int ci = first ? u0 : u1;
      float vmin = cv;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        vmin = fminf(vmin, __shfl_xor_sync(FULL, vmin, o));
      }
      if (!(vmin < pos_inf())) break;     // nothing finite is left
      const int imin = __reduce_min_sync(FULL, cv == vmin ? ci : INT_MAX);
      if (!lex_less(vmin, imin, tv[k - 1], ti[k - 1])) break;
      const bool own = cv == vmin && ci == imin;
      const int src = __ffs(__ballot_sync(FULL, own)) - 1;
      warp_insert(tv, ti, k, __shfl_sync(FULL, cv, src), imin, lane);
      if (own) {
        if (first) a = pos_inf(); else b = pos_inf();
      }
    }
  }
}

// PACKED.  As offer_tile on the packed keys of the scores.
__device__ void packed_tile(const float* sS, int* lk, int* li, int k, int t0,
                            int T, int base, int row_hi, int warp, int lane) {
  for (int t = warp; t < TT; t += WARPS) {
    if (t0 + t >= T) continue;            // uniform across the warp
    for (int h = 0; h < R; h += 32) {
      const int u = base + h + lane;
      const int key = packed_key(sS[t * R + h + lane], u, u < row_hi);
      warp_offer_key(lk + t * k, li + t * k, k, key, u, key != KEY_EMPTY, lane);
    }
  }
}

__device__ __forceinline__ int above(int key, int floor) {
  return key > floor ? key : KEY_EMPTY;
}

// PACKED3.  A 128-row block is two tiles (splits start on multiples of
// BLOCK, tiles advance by R = BLOCK / 2; the DB's last block may be short).
// Per target the three least keys of the block so far wait in sB3[t][0..2];
// each tile merges its 64 keys into them with three warp minima (keys are
// distinct within a block: their low bits are the row).  At the block's end
// the three are offered to the list, their rows rebuilt from the low bits,
// and the third lowers sB3[t][3], the least third key of the split.
__device__ void packed3_tile(const float* sS, int* lk, int* li, int* sB3, int k,
                             int t0, int T, int base, int row_hi, int warp,
                             int lane) {
  const bool block_ends = base % BLOCK + R >= BLOCK || base + R >= row_hi;
  const int u0 = base + lane, u1 = u0 + 32;
  for (int t = warp; t < TT; t += WARPS) {
    if (t0 + t >= T) continue;            // uniform across the warp
    int* st = sB3 + t * B3;
    const int a = packed_key(sS[t * R + lane], u0, u0 < row_hi);
    const int b = packed_key(sS[t * R + 32 + lane], u1, u1 < row_hi);
    const int c = lane < 3 ? st[lane] : KEY_EMPTY;
    const int m1 = __reduce_min_sync(FULL, min(a, min(b, c)));
    const int m2 = __reduce_min_sync(
        FULL, min(above(a, m1), min(above(b, m1), above(c, m1))));
    const int m3 = __reduce_min_sync(
        FULL, min(above(a, m2), min(above(b, m2), above(c, m2))));
    const int mine = lane == 0 ? m1 : lane == 1 ? m2 : m3;
    __syncwarp();                         // st was read by lanes 0..2
    if (block_ends) {
      const int u = base / BLOCK * BLOCK + (mine & (BLOCK - 1));
      warp_offer_key(lk + t * k, li + t * k, k, mine, u,
                     lane < 3 && mine != KEY_EMPTY, lane);
      if (lane < 3) st[lane] = KEY_EMPTY;
      if (lane == 3) st[3] = min(st[3], m3);
    } else if (lane < 3) {
      st[lane] = mine;
    }
    __syncwarp();
  }
}

// The selection SEL of one DB tile's scores.
template <int SEL>
__device__ __forceinline__ void select_tile(const float* sS, float* lv, int* li,
                                            int* sB3, int k, int t0, int T,
                                            int base, int row_hi, int warp,
                                            int lane) {
  if constexpr (SEL == STREAM) {
    offer_tile(sS, lv, li, k, t0, T, base, row_hi, warp, lane);
  } else if constexpr (SEL == PHASE) {
    phase_tile(sS, lv, li, k, t0, T, base, row_hi, warp, lane);
  } else if constexpr (SEL == PACKED) {
    packed_tile(sS, reinterpret_cast<int*>(lv), li, k, t0, T, base, row_hi,
                warp, lane);
  } else {
    packed3_tile(sS, reinterpret_cast<int*>(lv), li, sB3, k, t0, T, base,
                 row_hi, warp, lane);
  }
}

// The CTA's lists (scores or keys, copied as they are) to its slot of the
// (T, splits, k) partial outputs, and with part_third (PACKED3) each
// target's least third key to its slot of the (T, splits) array.
__device__ void store_lists(const float* lv, const int* li, const int* sB3,
                            float* part_v, int* part_i, int* part_third, int k,
                            int t0, int T, int split, int splits, int warp,
                            int lane) {
  for (int t = warp; t < TT; t += WARPS) {
    if (t0 + t >= T) continue;
    const size_t o = (static_cast<size_t>(t0 + t) * splits + split) * k;
    for (int j = lane; j < k; j += 32) {
      part_v[o + j] = lv[t * k + j];
      part_i[o + j] = li[t * k + j];
    }
    if (part_third != nullptr && lane == 0) {
      part_third[static_cast<size_t>(t0 + t) * splits + split] = sB3[t * B3 + 3];
    }
  }
}

// Score of target row tt against DB row r of the tile (both in shared
// memory), with the variant's fused masks applied in the Pallas order.
template <bool PART, bool LING>
__device__ __forceinline__ float fused_score(float s, const int* tm,
                                             const int* dm,
                                             const Penalties& pen) {
  if constexpr (PART || LING) {
    const int4 ta = *reinterpret_cast<const int4*>(tm);
    const int4 tb = *reinterpret_cast<const int4*>(tm + 4);
    const int4 da = *reinterpret_cast<const int4*>(dm);
    const int4 db = *reinterpret_cast<const int4*>(dm + 4);
    if constexpr (PART) {
      if (tb.z != db.z) s = pos_inf();
    }
    if constexpr (LING) {
      s += ta.x != da.x ? ID_RANK_PENALTY : 0.f;
      if (pen.w[0] != 0.f) s += ta.y != da.y ? pen.w[0] : 0.f;
      if (pen.w[1] != 0.f) s += ta.z != da.z ? pen.w[1] : 0.f;
      if (pen.w[2] != 0.f) s += ta.w != da.w ? pen.w[2] : 0.f;
      if (pen.w[3] != 0.f) s += tb.x != db.x ? pen.w[3] : 0.f;
      if (pen.w[4] != 0.f) s += tb.y != db.y ? pen.w[4] : 0.f;
    }
  }
  return s;
}

// Pass 1 at "highest".  raw: f32 DB rows of row stride width (the raw block
// or the derived operand); sqn[u * sqn_stride]: the squared norm of row u.
template <bool PART, bool LING, int SEL>
__global__ void __launch_bounds__(THREADS, 2)
topk_partial(const float* __restrict__ t2, const float* __restrict__ raw,
             const float* __restrict__ sqn, int sqn_stride,
             const int* __restrict__ tmeta, const int* __restrict__ dmeta,
             Penalties pen, float* __restrict__ part_v,
             int* __restrict__ part_i, int* __restrict__ part_third, int T,
             int kd, int width, int m_rows, int rows_per_split, int k,
             int splits) {
  constexpr bool MASKED = PART || LING;
  extern __shared__ __align__(16) float smem[];
  float* sT = smem;                       // [kd][TT]  targets, column-major
  float* sD = sT + kd * TT;               // [KC][R]   DB tile stage
  float* sS = sD + KC * R;                // [TT][R]   scores of the tile
  float* sSqn = sS + TT * R;              // [R]       sqn column of the tile
  int* sTM = reinterpret_cast<int*>(sSqn + R);     // [TT][META] if MASKED
  int* sDM = sTM + (MASKED ? TT * META : 0);       // [R][META]  if MASKED
  float* lv = reinterpret_cast<float*>(sDM + (MASKED ? R * META : 0));
                                          // [TT][k]   list values or keys
  int* li = reinterpret_cast<int*>(lv + TT * k);   // [TT][k] list indices
  int* sB3 = li + TT * k;                 // [TT][B3]  if SEL == PACKED3

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int t0 = blockIdx.x * TT;
  const int split = blockIdx.y;
  const int row_lo = split * rows_per_split;
  const int row_hi = min(row_lo + rows_per_split, m_rows);

  for (int e = tid; e < kd * TT; e += THREADS) {
    const int t = e % TT, c = e / TT;
    sT[e] = (t0 + t < T) ? t2[static_cast<size_t>(t0 + t) * kd + c] : 0.f;
  }
  if constexpr (MASKED) {
    for (int e = tid; e < TT * META; e += THREADS) {
      const int t = t0 + e / META;
      sTM[e] = t < T ? tmeta[static_cast<size_t>(t) * META + e % META] : -1;
    }
  }
  init_lists<SEL>(lv, li, sB3, k, tid);
  __syncthreads();                        // lists are owned per warp below

  const int tx = tid & 15;                // DB rows tx * 4 .. tx * 4 + 3
  const int ty = tid >> 4;                // targets ty * 4 .. ty * 4 + 3
  for (int base = row_lo; base < row_hi; base += R) {
    float acc[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) acc[a][b] = 0.f;

    for (int c0 = 0; c0 < kd; c0 += KC) {
      __syncthreads();                    // previous stage / selection done
      const int kc = min(KC, kd - c0);
      for (int e = tid; e < KC * R; e += THREADS) {
        const int r = e % R, cc = e / R;
        const int u = base + r;
        sD[e] = (cc < kc && u < row_hi)
                    ? __ldg(raw + static_cast<size_t>(u) * width + c0 + cc)
                    : 0.f;
      }
      if (c0 == 0 && tid < R) {
        const int u = base + tid;
        sSqn[tid] = u < row_hi
                        ? __ldg(sqn + static_cast<size_t>(u) * sqn_stride)
                        : 0.f;
      }
      if constexpr (MASKED) {
        if (c0 == 0) {
          for (int e = tid; e < R * META; e += THREADS) {
            const int u = base + e / META;
            sDM[e] = u < row_hi
                         ? __ldg(dmeta + static_cast<size_t>(u) * META + e % META)
                         : -1;
          }
        }
      }
      __syncthreads();
#pragma unroll 4
      for (int cc = 0; cc < kc; ++cc) {
        const float4 a =
            *reinterpret_cast<const float4*>(sT + (c0 + cc) * TT + ty * 4);
        const float4 b = *reinterpret_cast<const float4*>(sD + cc * R + tx * 4);
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int* tm = sTM + (ty * 4 + i) * META;
      float v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        v[j] = fused_score<PART, LING>(sSqn[tx * 4 + j] - 2.f * acc[i][j], tm,
                                       sDM + (tx * 4 + j) * META, pen);
      }
      *reinterpret_cast<float4*>(sS + (ty * 4 + i) * R + tx * 4) =
          make_float4(v[0], v[1], v[2], v[3]);
    }
    __syncthreads();
    select_tile<SEL>(sS, lv, li, sB3, k, t0, T, base, row_hi, warp, lane);
  }
  store_lists(lv, li, sB3, part_v, part_i, part_third, k, t0, T, split, splits,
              warp, lane);
}

// bf16 hi / lo split of x (hi = bf16_rn(x), lo = bf16_rn(x - hi), the
// split of pallas_topk._bf16_split), stored as raw bf16 bits.
__device__ __forceinline__ void split_store(float x, unsigned short* hi,
                                            unsigned short* lo) {
  const __nv_bfloat16 h = __float2bfloat16_rn(x);
  *hi = __bfloat16_as_ushort(h);
  *lo = __bfloat16_as_ushort(__float2bfloat16_rn(x - __bfloat162float(h)));
}

__device__ __forceinline__ uint32_t ld_pair(const unsigned short* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// d += a * b, one m16n8k16 bf16 tensor-core product with f32 accumulation.
// a: 16 x 16 row-major fragment (4 registers of 2 bf16), b: 16 x 8
// column-major fragment (2 registers), d: 16 x 8 f32 fragment.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Pass 1 at the split precisions.  Shared memory: the tile's scores, lists
// and packed3 state as in topk_partial, the metadata rows of the target
// tile and of the DB tile when a mask is fused (MASKED), the target tile as bf16
// [TT][kp + SPAD] hi and lo (kp = kd rounded up to KC, zero past kd), and
// the DB stage as bf16 [R][DS] hi and lo.  Warp w computes DB rows
// (w % 4) * 16 .. + 16 against targets (w / 4) * 32 .. + 32: one A fragment
// (DB rows, row-major over columns) and four B fragments (8 targets each)
// per 16 columns.  Fragment layouts (PTX ISA, mma.m16n8k16 .bf16), with
// g = lane / 4 and q = lane % 4: a0 = (g, 2q..2q+1), a1 = (g + 8, 2q..),
// a2 = (g, 2q + 8..), a3 = (g + 8, 2q + 8..); b0 = (k 2q..2q+1, n g),
// b1 = (k 2q + 8.., n g); d0..d3 = (g, 2q), (g, 2q + 1), (g + 8, 2q),
// (g + 8, 2q + 1).  Row indices are int and element offsets size_t: the
// capacity block has 8.4 M rows x 153 columns.  The fused masks are
// applied to each score in the epilogue, after the product and before the
// selection, in the order of topk_partial (fused_score).
// db: f32 rows of row stride width, split while staged; with PRESPLIT,
// bf16 rows [hi | lo] of row stride width = 2 kp elements (4 kp bytes, a
// multiple of 128), copied into the hi / lo stages with one 16-byte load
// and one 16-byte store per 8 values.  sqn[u * sqn_stride]: the squared
// norm of row u.
template <int PREC, bool PART, bool LING, bool PRESPLIT, int SEL>
__global__ void __launch_bounds__(THREADS, 2)
topk_partial_split(const float* __restrict__ t2, const void* __restrict__ db,
                   const float* __restrict__ sqn, int sqn_stride,
                   const int* __restrict__ tmeta, const int* __restrict__ dmeta,
                   Penalties pen, float* __restrict__ part_v,
                   int* __restrict__ part_i, int* __restrict__ part_third,
                   int T, int kd, int width, int m_rows, int rows_per_split,
                   int k, int splits) {
  // split3: accumulators hh, hl, lh; split3cat: one for all three
  constexpr int NACC = PREC == SPLIT3 ? 3 : 1;
  constexpr int HL = NACC == 3 ? 1 : 0, LH = NACC == 3 ? 2 : 0;
  constexpr bool MASKED = PART || LING;
  extern __shared__ __align__(16) float smem[];
  const int kp = (kd + KC - 1) / KC * KC;
  const int ts = kp + SPAD;               // bf16 row stride of the target tile
  float* sS = smem;                       // [TT][R]   scores of the tile
  float* sSqn = sS + TT * R;              // [R]       sqn column of the tile
  float* lv = sSqn + R;                   // [TT][k]   list values
  int* li = reinterpret_cast<int*>(lv + TT * k);   // [TT][k] list indices
  int* sB3 = li + TT * k;                          // [TT][B3] if SEL == PACKED3
  int* sTM = sB3 + (SEL == PACKED3 ? TT * B3 : 0);   // [TT][META] if MASKED
  int* sDM = sTM + (MASKED ? TT * META : 0);       // [R][META]  if MASKED
  unsigned short* sThi =
      reinterpret_cast<unsigned short*>(sDM + (MASKED ? R * META : 0));
  unsigned short* sTlo = sThi + TT * ts;  // [TT][ts]  target tile, bf16
  unsigned short* sDhi = sTlo + TT * ts;  // [R][DS]   DB stage, bf16
  unsigned short* sDlo = sDhi + R * DS;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int t0 = blockIdx.x * TT;
  const int split = blockIdx.y;
  const int row_lo = split * rows_per_split;
  const int row_hi = min(row_lo + rows_per_split, m_rows);

  for (int e = tid; e < TT * kp; e += THREADS) {
    const int t = e / kp, c = e % kp;
    const float x = (t0 + t < T && c < kd)
                        ? t2[static_cast<size_t>(t0 + t) * kd + c]
                        : 0.f;
    split_store(x, sThi + t * ts + c, sTlo + t * ts + c);
  }
  if constexpr (MASKED) {
    for (int e = tid; e < TT * META; e += THREADS) {
      const int t = t0 + e / META;
      sTM[e] = t < T ? tmeta[static_cast<size_t>(t) * META + e % META] : -1;
    }
  }
  init_lists<SEL>(lv, li, sB3, k, tid);
  __syncthreads();

  const int g = lane >> 2, q = lane & 3;
  const int m0 = (warp & 3) * 16;         // DB rows of this warp's block
  const int n0 = (warp >> 2) * 32;        // targets of this warp's block
  for (int base = row_lo; base < row_hi; base += R) {
    float acc[NACC][4][4];
#pragma unroll
    for (int s = 0; s < NACC; ++s)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int h = 0; h < 4; ++h) acc[s][j][h] = 0.f;

    for (int c0 = 0; c0 < kp; c0 += KC) {
      __syncthreads();                    // previous stage / selection done
      if constexpr (PRESPLIT) {
        // 8 loads a row: 4 of the hi half, then 4 of the lo half (columns
        // past kd are zero in the operand)
        constexpr int V = 8, PER_HALF = KC / V;
        const unsigned short* pre = static_cast<const unsigned short*>(db);
        for (int e = tid; e < R * 2 * PER_HALF; e += THREADS) {
          const int r = e / (2 * PER_HALF), j = e % (2 * PER_HALF);
          const int half = j / PER_HALF, cc = (j % PER_HALF) * V;
          const int u = base + r;
          uint4 v = make_uint4(0u, 0u, 0u, 0u);
          if (u < row_hi) {
            v = __ldg(reinterpret_cast<const uint4*>(
                pre + static_cast<size_t>(u) * width + half * kp + c0 + cc));
          }
          *reinterpret_cast<uint4*>((half ? sDlo : sDhi) + r * DS + cc) = v;
        }
      } else {
        const float* raw = static_cast<const float*>(db);
        for (int e = tid; e < R * KC; e += THREADS) {
          const int r = e / KC, cc = e % KC;
          const int u = base + r, c = c0 + cc;
          const float x = (c < kd && u < row_hi)
                              ? __ldg(raw + static_cast<size_t>(u) * width + c)
                              : 0.f;
          split_store(x, sDhi + r * DS + cc, sDlo + r * DS + cc);
        }
      }
      if (c0 == 0 && tid < R) {
        const int u = base + tid;
        sSqn[tid] = u < row_hi
                        ? __ldg(sqn + static_cast<size_t>(u) * sqn_stride)
                        : 0.f;
      }
      if constexpr (MASKED) {
        if (c0 == 0) {
          for (int e = tid; e < R * META; e += THREADS) {
            const int u = base + e / META;
            sDM[e] = u < row_hi
                         ? __ldg(dmeta + static_cast<size_t>(u) * META + e % META)
                         : -1;
          }
        }
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < KC; kk += KS) {
        const int ra = (m0 + g) * DS + kk + 2 * q;
        const uint32_t ah[4] = {ld_pair(sDhi + ra), ld_pair(sDhi + ra + 8 * DS),
                                ld_pair(sDhi + ra + 8),
                                ld_pair(sDhi + ra + 8 * DS + 8)};
        const uint32_t al[4] = {ld_pair(sDlo + ra), ld_pair(sDlo + ra + 8 * DS),
                                ld_pair(sDlo + ra + 8),
                                ld_pair(sDlo + ra + 8 * DS + 8)};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int rb = (n0 + j * 8 + g) * ts + c0 + kk + 2 * q;
          const uint32_t bh[2] = {ld_pair(sThi + rb), ld_pair(sThi + rb + 8)};
          const uint32_t bl[2] = {ld_pair(sTlo + rb), ld_pair(sTlo + rb + 8)};
          mma_bf16(acc[0][j], ah, bh);    // db_hi . t_hi
          mma_bf16(acc[HL][j], ah, bl);   // db_hi . t_lo
          mma_bf16(acc[LH][j], al, bh);   // db_lo . t_hi
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        const int r = m0 + g + (h >> 1) * 8;
        const int t = n0 + j * 8 + 2 * q + (h & 1);
        float cross = acc[0][j][h];
        if constexpr (PREC == SPLIT3) {
          cross = (acc[0][j][h] + acc[1][j][h]) + acc[2][j][h];
        }
        sS[t * R + r] = fused_score<PART, LING>(sSqn[r] - 2.f * cross,
                                                sTM + t * META, sDM + r * META,
                                                pen);
      }
    }
    __syncthreads();
    select_tile<SEL>(sS, lv, li, sB3, k, t0, T, base, row_hi, warp, lane);
  }
  store_lists(lv, li, sB3, part_v, part_i, part_third, k, t0, T, split, splits,
              warp, lane);
}

// comp: (T,) constants added to the merged scores (zero-transient form), or
// nullptr (derived form: the scores are returned as ranked).  KEYS: the
// lists hold packed keys, merged under the (key, index) order and unpacked
// here.  part_third (T, splits) and flags (T,), both or neither (PACKED3):
// a target's flag is 1 where the least third key of any block lies below
// the worst key kept (KEY_EMPTY while the list has room).
template <bool KEYS>
__global__ void __launch_bounds__(THREADS)
topk_merge(const float* __restrict__ part_v, const int* __restrict__ part_i,
           const float* __restrict__ comp, const int* __restrict__ part_third,
           float* __restrict__ out_v, int* __restrict__ out_i,
           int* __restrict__ flags, int T, int k, int splits) {
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* lv = smem + warp * k;
  int* lk = reinterpret_cast<int*>(lv);
  int* li = reinterpret_cast<int*>(smem + WARPS * k) + warp * k;
  const int t = blockIdx.x * WARPS + warp;
  if (t >= T) return;                     // whole warp; no block sync follows
  for (int j = lane; j < k; j += 32) {
    if constexpr (KEYS) lk[j] = KEY_EMPTY; else lv[j] = pos_inf();
    li[j] = INT_MAX;
  }
  __syncwarp();
  for (int s = 0; s < splits; ++s) {
    const size_t o = (static_cast<size_t>(t) * splits + s) * k;
    for (int h = 0; h < k; h += 32) {
      const int j = h + lane;
      const bool in = j < k;
      const int i = in ? part_i[o + j] : INT_MAX;
      if constexpr (KEYS) {
        const int key = in ? reinterpret_cast<const int*>(part_v)[o + j] : KEY_EMPTY;
        warp_offer_key(lk, li, k, key, i, in && i != INT_MAX, lane);
      } else {
        const float v = in ? part_v[o + j] : pos_inf();
        warp_offer(lv, li, k, v, i, in && i != INT_MAX, lane);
      }
    }
  }
  __syncwarp();
  const float add = comp != nullptr ? comp[t] : 0.f;
  for (int j = lane; j < k; j += 32) {
    // an unfilled slot is (+inf, INT_MAX) here and leaves as (+inf, 0)
    float v;
    if constexpr (KEYS) v = from_key(lk[j]); else v = lv[j];
    out_v[static_cast<size_t>(t) * k + j] = comp != nullptr ? v + add : v;
    out_i[static_cast<size_t>(t) * k + j] = li[j] == INT_MAX ? 0 : li[j];
  }
  if constexpr (KEYS) {
    if (flags != nullptr) {
      int third = KEY_EMPTY;
      for (int s = lane; s < splits; s += 32) {
        third = min(third, part_third[static_cast<size_t>(t) * splits + s]);
      }
      third = __reduce_min_sync(FULL, third);
      if (lane == 0) flags[t] = third < lk[k - 1] ? 1 : 0;
    }
  }
}

size_t partial_smem(int kd, int k, bool masked, int prec, int sel) {
  if (kd < 1 || k < 1 || k > KMAX || prec < HIGHEST || prec > SPLIT3CAT ||
      sel < STREAM || sel > PACKED3) {
    return 0;
  }
  const size_t state = sel == PACKED3 ? TT * B3 * sizeof(int) : 0;
  if (prec != HIGHEST) {
    const size_t ts = static_cast<size_t>((kd + KC - 1) / KC * KC + SPAD);
    return static_cast<size_t>(TT * R + R + 2 * TT * k) * sizeof(float) + state +
           static_cast<size_t>(masked ? (TT + R) * META : 0) * sizeof(int) +
           2 * (TT * ts + R * DS) * sizeof(unsigned short);
  }
  return static_cast<size_t>(kd * TT + KC * R + TT * R + R + TT * k) *
             sizeof(float) +
         static_cast<size_t>(TT * k + (masked ? (TT + R) * META : 0)) *
             sizeof(int) +
         state;
}

// The DB side of a launch: the rows, their stride (in elements of the row
// type), the least stride the form allows at this kd, and where each row's
// squared norm lies (sqn[u * sqn_stride]).
struct Operand {
  const void* rows;
  int width;
  int min_width;
  const float* sqn;
  int sqn_stride;
};

// What a launch writes: the (T, splits, k) partial lists, the (T, k)
// results and, for PACKED3 only, the (T, splits) least third keys and the
// (T,) overflow flags.
struct Outputs {
  float* part_v;
  int* part_i;
  int* part_third;
  float* out_v;
  int* out_i;
  int* flags;
};

bool bad_shape(size_t smem, int T, const Operand& db, int m_rows, int k,
               int splits, int rows_per_split) {
  return smem == 0 || T < 1 || db.rows == nullptr || db.sqn == nullptr ||
         db.width < db.min_width || m_rows < k || splits < 1 ||
         rows_per_split < 1 ||
         static_cast<long long>(splits) * rows_per_split < m_rows;
}

template <bool KEYS>
int merge(const Outputs& o, const float* comp, int T, int k, int splits,
          cudaStream_t stream) {
  const size_t smem2 = static_cast<size_t>(WARPS * k) * (sizeof(float) + sizeof(int));
  topk_merge<KEYS><<<(T + WARPS - 1) / WARPS, THREADS, smem2, stream>>>(
      o.part_v, o.part_i, comp, o.part_third, o.out_v, o.out_i, o.flags, T, k,
      splits);
  return static_cast<int>(cudaGetLastError());
}

// Both passes of one variant on `stream`; returns a cudaError_t.  PRESPLIT
// (the derived split3cat operand) must start on a 16-byte boundary; PACKED3
// needs splits of whole 128-row blocks and its two extra outputs.
template <int PREC, bool PART, bool LING, bool PRESPLIT, int SEL>
int launch(const float* t2, const Operand& db, const float* comp,
           const int* tmeta, const int* dmeta, Penalties pen, const Outputs& o,
           int T, int kd, int m_rows, int k, int splits, int rows_per_split,
           cudaStream_t stream) {
  static_assert(!PRESPLIT || PREC == SPLIT3CAT, "only split3cat is pre-split");
  constexpr bool MASKED = PART || LING;
  const size_t smem1 = partial_smem(kd, k, MASKED, PREC, SEL);
  if (bad_shape(smem1, T, db, m_rows, k, splits, rows_per_split) ||
      (MASKED && (tmeta == nullptr || dmeta == nullptr)) ||
      (PRESPLIT && reinterpret_cast<uintptr_t>(db.rows) % 16 != 0) ||
      (SEL == PACKED3 && (rows_per_split % BLOCK != 0 ||
                          o.part_third == nullptr || o.flags == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int* part_third = SEL == PACKED3 ? o.part_third : nullptr;
  const dim3 grid1((T + TT - 1) / TT, splits);
  cudaError_t err;
  if constexpr (PREC == HIGHEST) {
    err = cudaFuncSetAttribute(topk_partial<PART, LING, SEL>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem1));
    if (err != cudaSuccess) return static_cast<int>(err);
    topk_partial<PART, LING, SEL><<<grid1, THREADS, smem1, stream>>>(
        t2, static_cast<const float*>(db.rows), db.sqn, db.sqn_stride, tmeta,
        dmeta, pen, o.part_v, o.part_i, part_third, T, kd, db.width, m_rows,
        rows_per_split, k, splits);
  } else {
    err = cudaFuncSetAttribute(
        topk_partial_split<PREC, PART, LING, PRESPLIT, SEL>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem1));
    if (err != cudaSuccess) return static_cast<int>(err);
    topk_partial_split<PREC, PART, LING, PRESPLIT, SEL>
        <<<grid1, THREADS, smem1, stream>>>(
            t2, db.rows, db.sqn, db.sqn_stride, tmeta, dmeta, pen, o.part_v,
            o.part_i, part_third, T, kd, db.width, m_rows, rows_per_split, k,
            splits);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  Outputs m = o;
  if (SEL != PACKED3) m.part_third = m.flags = nullptr;
  return merge<SEL == PACKED || SEL == PACKED3>(m, comp, T, k, splits, stream);
}

}  // namespace

// Every exported entry point has this signature: three leading pointers
// (the targets, the DB rows and, per form, comp or sqn), the metadata rows
// tmeta (T, 8) and dmeta (m_rows, 8) read by the masked variants only, the
// penalties p0..p4 read by the linguistic ones only, the partial and final
// outputs (part_third (T, splits) and flags (T,) written by the packed3
// selection only, null elsewhere), the shape, the split plan and the
// stream.  It launches both passes and returns the cudaError_t of the
// launches.
#define SNK_TOPK_SIGNATURE(NAME, DB_T, THIRD)                                 \
  int NAME(const float* t2, const DB_T* db_rows, const float* THIRD,        \
           const int* tmeta, const int* dmeta, float p0, float p1, float p2, \
           float p3, float p4, float* part_v, int* part_i, int* part_third,  \
           float* out_v, int* out_i, int* flags, int T, int kd, int width,   \
           int m_rows, int k, int splits, int rows_per_split,                \
           cudaStream_t stream)

// Zero-transient form: t2 (T, kd) prescaled targets; db_rows the (q, width)
// raw block, width >= kd + 2, whose column kd is the squared norm; comp (T,).
#define SNK_ZT_ENTRY(NAME, PREC, PART, LING, SEL)                            \
  SNK_TOPK_SIGNATURE(NAME, float, comp) {                                    \
    const Penalties pen = {{p0, p1, p2, p3, p4}};                           \
    const Operand db = {db_rows, width, kd + 2,                             \
                        db_rows == nullptr ? nullptr : db_rows + kd, width}; \
    const Outputs o = {part_v, part_i, part_third, out_v, out_i, flags};    \
    return launch<PREC, PART, LING, false, SEL>(t2, db, comp, tmeta, dmeta,  \
                                                pen, o, T, kd, m_rows, k,    \
                                                splits, rows_per_split,      \
                                                stream);                     \
  }

// Derived form: t2 (T, kd) normalised, weighted targets; db_rows the derived
// operand; sqn (m_rows,) its squared row norms.
#define SNK_DV_ENTRY(NAME, PREC, PART, LING, PRESPLIT, SEL)                  \
  SNK_TOPK_SIGNATURE(NAME, void, sqn) {                                      \
    const Penalties pen = {{p0, p1, p2, p3, p4}};                           \
    const int kp = (kd + KC - 1) / KC * KC;                                 \
    const Operand db = {db_rows, width, PRESPLIT ? 2 * kp : kd, sqn, 1};    \
    const Outputs o = {part_v, part_i, part_third, out_v, out_i, flags};    \
    return launch<PREC, PART, LING, PRESPLIT, SEL>(t2, db, nullptr, tmeta,   \
                                                   dmeta, pen, o, T, kd,     \
                                                   m_rows, k, splits,        \
                                                   rows_per_split, stream);  \
  }

// The twelve entry points of a form at one selection: SFX is the name's
// suffix ("" for STREAM, else _phase, _packed, _packed3).
#define SNK_ZT_ENTRIES(SFX, SEL)                                                   \
  SNK_ZT_ENTRY(snk_topk_preselect_zt##SFX, HIGHEST, false, false, SEL)             \
  SNK_ZT_ENTRY(snk_topk_preselect_zt_part##SFX, HIGHEST, true, false, SEL)         \
  SNK_ZT_ENTRY(snk_topk_preselect_zt_ling##SFX, HIGHEST, false, true, SEL)         \
  SNK_ZT_ENTRY(snk_topk_preselect_zt_ling_part##SFX, HIGHEST, true, true, SEL)     \
  SNK_ZT_ENTRY(snk_topk_preselect_zt_split3##SFX, SPLIT3, false, false, SEL)       \
  SNK_ZT_ENTRY(snk_topk_preselect_zt_split3_part##SFX, SPLIT3, true, false, SEL)   \
  SNK_ZT_ENTRY(snk_topk_preselect_zt_split3_ling##SFX, SPLIT3, false, true, SEL)   \
  SNK_ZT_ENTRY(snk_topk_preselect_zt_split3_ling_part##SFX, SPLIT3, true, true,    \
               SEL)                                                                \
  SNK_ZT_ENTRY(snk_topk_preselect_zt_split3cat##SFX, SPLIT3CAT, false, false, SEL) \
  SNK_ZT_ENTRY(snk_topk_preselect_zt_split3cat_part##SFX, SPLIT3CAT, true, false,  \
               SEL)                                                                \
  SNK_ZT_ENTRY(snk_topk_preselect_zt_split3cat_ling##SFX, SPLIT3CAT, false, true,  \
               SEL)                                                                \
  SNK_ZT_ENTRY(snk_topk_preselect_zt_split3cat_ling_part##SFX, SPLIT3CAT, true,    \
               true, SEL)

#define SNK_DV_ENTRIES(SFX, SEL)                                                   \
  SNK_DV_ENTRY(snk_topk_preselect_dv##SFX, HIGHEST, false, false, false, SEL)      \
  SNK_DV_ENTRY(snk_topk_preselect_dv_part##SFX, HIGHEST, true, false, false, SEL)  \
  SNK_DV_ENTRY(snk_topk_preselect_dv_ling##SFX, HIGHEST, false, true, false, SEL)  \
  SNK_DV_ENTRY(snk_topk_preselect_dv_ling_part##SFX, HIGHEST, true, true, false,   \
               SEL)                                                                \
  SNK_DV_ENTRY(snk_topk_preselect_dv_split3##SFX, SPLIT3, false, false, false,     \
               SEL)                                                                \
  SNK_DV_ENTRY(snk_topk_preselect_dv_split3_part##SFX, SPLIT3, true, false, false, \
               SEL)                                                                \
  SNK_DV_ENTRY(snk_topk_preselect_dv_split3_ling##SFX, SPLIT3, false, true, false, \
               SEL)                                                                \
  SNK_DV_ENTRY(snk_topk_preselect_dv_split3_ling_part##SFX, SPLIT3, true, true,    \
               false, SEL)                                                         \
  SNK_DV_ENTRY(snk_topk_preselect_dv_split3cat##SFX, SPLIT3CAT, false, false,      \
               true, SEL)                                                          \
  SNK_DV_ENTRY(snk_topk_preselect_dv_split3cat_part##SFX, SPLIT3CAT, true, false,  \
               true, SEL)                                                          \
  SNK_DV_ENTRY(snk_topk_preselect_dv_split3cat_ling##SFX, SPLIT3CAT, false, true,  \
               true, SEL)                                                          \
  SNK_DV_ENTRY(snk_topk_preselect_dv_split3cat_ling_part##SFX, SPLIT3CAT, true,    \
               true, true, SEL)

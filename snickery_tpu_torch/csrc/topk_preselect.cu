// Fused distance + top-k preselect over the resident raw unit block,
// hand-written CUDA C++ for Hopper (sm_90a).
//
// Replaces snickery_tpu/ops/pallas_topk.py::pallas_topk_preselect in the
// forms the synthesis paths run: zero_transient=True, select="stream"
// (_topk_kernel + _compute_scores + _stream_select).  At precision "highest"
// with or without the fused partition mask (multi-voice DBs,
// _compute_scores :187-191) and the fused quinphone penalties (halfphone
// voices, :192-208): topk_partial<PART, LING>.  At the bf16-split precisions
// "split3" (_split3_dot :77-93) and "split3cat" (_bf16_split :96-99, the
// in-kernel [hi|hi|lo] concat :158-178), with the same fused masks applied
// after the product (:156-208 composed): topk_partial_split<PREC, PART,
// LING>.  One exported entry point per variant, twelve in all.
//
// For every target row t and DB row u in [0, m_rows):
//
//     score(t, u) = sqn[u] - 2 * cross(t, u),  cross = sum_{c < kd} raw[u, c] * t2[t, c]
//
// where raw is the (q, kd + 2) block [data kd | sqn | ptr] built by
// voicedb.device_layout.build_raw_blocks(affine=...).  Column kd holds the
// squared norm of the normalised row (1e6-sentinel norm for padding rows);
// column kd + 1 holds int32 pointer BITS and is never loaded (as f32 it can
// be NaN or denormal).  Per target the k smallest (score, u) pairs are kept,
// the lowest u winning ties, and comp[t] is added to the returned scores.
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
//     through shared memory in tiles of R rows x KC columns with scalar
//     loads (the 4 * (kd + 2)-byte row stride is not 16-byte aligned).
//     "highest": each thread accumulates a 4 x 4 register tile with FP32
//     FMAs (no TF32).  Split precisions: the tile is split to bf16 hi / lo
//     while it is stored, and each warp computes a 16-row x 32-target block
//     of the 64 x 64 tile with mma.sync.  After each DB tile one warp per
//     target offers the tile's 64 scores to a sorted k-slot list in shared
//     memory: a candidate enters only if it beats the worst (score, index)
//     pair, so a warm list costs one ballot per 32 scores.
//   pass 2 (topk_merge): one warp per target merges the S sorted partial
//     lists under the same (score, index) order and adds comp.
//
// S is chosen by the wrapper so that tiles x S fills the card at small T
// (one utterance: 2 to 32 target tiles) as well as at large T.
//
// Shared memory of pass 1 ("highest") is 4 * (64 * kd + 8,256 + 128 * k)
// bytes, plus 4 KB of metadata in the masked variants: at kd = 151 (epoch
// units) two CTAs fit per SM; at kd = 453 (halfphone units, [first | mid |
// last] frames) about 150-160 KB, so one CTA per SM.  The split variants
// hold the target tile as bf16 hi and lo (the same bytes as one f32 copy,
// row stride padded by 8 against bank conflicts): 4 * (4,160 + 128 * k) +
// 256 * (kd rounded up to 32, + 8) + 10,240 bytes, plus the same 4 KB of
// metadata in the masked variants: about 96 KB at kd 151 and k 48, so two
// CTAs still fit per SM; about 176 KB at kd 453 (halfphone), one CTA.
//
// Bound: at the config-3 batch shape (65,536 targets x 1,048,576 units x
// kd = 151) "highest" is about 2.1e13 FLOP of FP32 FMA, so it is bound by
// FP32 FMA throughput and shared-memory operand traffic.  The split
// variants do 3x the products at bf16 tensor-core rate, which leaves them
// bound by the DB staging (every target tile reads the ~640 MB block, from
// device memory about once per wave of resident tiles and from L2 for the
// rest, scalar loads) and by the selection epilogue.

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

// Insert (v, i) into the ascending k-slot list (lv, li) in shared memory.
// Warp-cooperative; the caller has checked that (v, i) beats slot k - 1.
__device__ void warp_insert(float* lv, int* li, int k, float v, int i,
                            int lane) {
  const int j0 = lane, j1 = lane + 32;
  const bool in0 = j0 < k, in1 = j1 < k;
  const float v0 = in0 ? lv[j0] : 0.f;
  const int i0 = in0 ? li[j0] : 0;
  const float v1 = in1 ? lv[j1] : 0.f;
  const int i1 = in1 ? li[j1] : 0;
  const unsigned b0 = __ballot_sync(FULL, in0 && lex_less(v0, i0, v, i));
  const unsigned b1 = __ballot_sync(FULL, in1 && lex_less(v1, i1, v, i));
  const int p = __popc(b0) + __popc(b1);       // insertion slot
  // slot j keeps itself below p, takes (v, i) at p and slot j - 1 above p
  const float pv0 = (in0 && j0 > 0) ? lv[j0 - 1] : 0.f;
  const int pi0 = (in0 && j0 > 0) ? li[j0 - 1] : 0;
  const float pv1 = in1 ? lv[j1 - 1] : 0.f;
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

// Every list of the CTA empty: (+inf, INT_MAX) in each slot.
__device__ void init_lists(float* lv, int* li, int k, int tid) {
  for (int e = tid; e < TT * k; e += THREADS) {
    lv[e] = pos_inf();
    li[e] = INT_MAX;
  }
}

// One warp per target offers the tile's R scores sS[t][.] (DB rows
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

// The CTA's lists to its slot of the (T, splits, k) partial outputs.
__device__ void store_lists(const float* lv, const int* li, float* part_v,
                            int* part_i, int k, int t0, int T, int split,
                            int splits, int warp, int lane) {
  for (int t = warp; t < TT; t += WARPS) {
    if (t0 + t >= T) continue;
    const size_t o = (static_cast<size_t>(t0 + t) * splits + split) * k;
    for (int j = lane; j < k; j += 32) {
      part_v[o + j] = lv[t * k + j];
      part_i[o + j] = li[t * k + j];
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

template <bool PART, bool LING>
__global__ void __launch_bounds__(THREADS, 2)
topk_partial(const float* __restrict__ t2, const float* __restrict__ raw,
             const int* __restrict__ tmeta, const int* __restrict__ dmeta,
             Penalties pen, float* __restrict__ part_v,
             int* __restrict__ part_i, int T, int kd, int width, int m_rows,
             int rows_per_split, int k, int splits) {
  constexpr bool MASKED = PART || LING;
  extern __shared__ __align__(16) float smem[];
  float* sT = smem;                       // [kd][TT]  targets, column-major
  float* sD = sT + kd * TT;               // [KC][R]   DB tile stage
  float* sS = sD + KC * R;                // [TT][R]   scores of the tile
  float* sSqn = sS + TT * R;              // [R]       sqn column of the tile
  int* sTM = reinterpret_cast<int*>(sSqn + R);     // [TT][META] if MASKED
  int* sDM = sTM + (MASKED ? TT * META : 0);       // [R][META]  if MASKED
  float* lv = reinterpret_cast<float*>(sDM + (MASKED ? R * META : 0));
                                          // [TT][k]   list values
  int* li = reinterpret_cast<int*>(lv + TT * k);   // [TT][k] list indices

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
  init_lists(lv, li, k, tid);
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
                        ? __ldg(raw + static_cast<size_t>(u) * width + kd)
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
    offer_tile(sS, lv, li, k, t0, T, base, row_hi, warp, lane);
  }
  store_lists(lv, li, part_v, part_i, k, t0, T, split, splits, warp, lane);
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

// Pass 1 at the split precisions.  Shared memory: the tile's scores and
// lists as in topk_partial, the metadata rows of the target tile and of the
// DB tile when a mask is fused (MASKED), the target tile as bf16
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
template <int PREC, bool PART, bool LING>
__global__ void __launch_bounds__(THREADS, 2)
topk_partial_split(const float* __restrict__ t2, const float* __restrict__ raw,
                   const int* __restrict__ tmeta, const int* __restrict__ dmeta,
                   Penalties pen, float* __restrict__ part_v,
                   int* __restrict__ part_i, int T, int kd, int width,
                   int m_rows, int rows_per_split, int k, int splits) {
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
  int* sTM = li + TT * k;                          // [TT][META] if MASKED
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
  init_lists(lv, li, k, tid);
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
      for (int e = tid; e < R * KC; e += THREADS) {
        const int r = e / KC, cc = e % KC;
        const int u = base + r, c = c0 + cc;
        const float x = (c < kd && u < row_hi)
                            ? __ldg(raw + static_cast<size_t>(u) * width + c)
                            : 0.f;
        split_store(x, sDhi + r * DS + cc, sDlo + r * DS + cc);
      }
      if (c0 == 0 && tid < R) {
        const int u = base + tid;
        sSqn[tid] = u < row_hi
                        ? __ldg(raw + static_cast<size_t>(u) * width + kd)
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
    offer_tile(sS, lv, li, k, t0, T, base, row_hi, warp, lane);
  }
  store_lists(lv, li, part_v, part_i, k, t0, T, split, splits, warp, lane);
}

__global__ void __launch_bounds__(THREADS)
topk_merge(const float* __restrict__ part_v, const int* __restrict__ part_i,
           const float* __restrict__ comp, float* __restrict__ out_v,
           int* __restrict__ out_i, int T, int k, int splits) {
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* lv = smem + warp * k;
  int* li = reinterpret_cast<int*>(smem + WARPS * k) + warp * k;
  const int t = blockIdx.x * WARPS + warp;
  if (t >= T) return;                     // whole warp; no block sync follows
  for (int j = lane; j < k; j += 32) {
    lv[j] = pos_inf();
    li[j] = INT_MAX;
  }
  __syncwarp();
  for (int s = 0; s < splits; ++s) {
    const size_t o = (static_cast<size_t>(t) * splits + s) * k;
    for (int h = 0; h < k; h += 32) {
      const int j = h + lane;
      const bool in = j < k;
      const int i = in ? part_i[o + j] : INT_MAX;
      const float v = in ? part_v[o + j] : pos_inf();
      warp_offer(lv, li, k, v, i, in && i != INT_MAX, lane);
    }
  }
  __syncwarp();
  const float c = comp[t];
  for (int j = lane; j < k; j += 32) {
    // an unfilled slot is (+inf, INT_MAX) here and leaves as (+inf, 0)
    out_v[static_cast<size_t>(t) * k + j] = lv[j] + c;
    out_i[static_cast<size_t>(t) * k + j] = li[j] == INT_MAX ? 0 : li[j];
  }
}

size_t partial_smem(int kd, int k, bool masked, int prec) {
  if (kd < 1 || k < 1 || k > KMAX || prec < HIGHEST || prec > SPLIT3CAT) {
    return 0;
  }
  if (prec != HIGHEST) {
    const size_t ts = static_cast<size_t>((kd + KC - 1) / KC * KC + SPAD);
    return static_cast<size_t>(TT * R + R + 2 * TT * k) * sizeof(float) +
           static_cast<size_t>(masked ? (TT + R) * META : 0) * sizeof(int) +
           2 * (TT * ts + R * DS) * sizeof(unsigned short);
  }
  return static_cast<size_t>(kd * TT + KC * R + TT * R + R + TT * k) *
             sizeof(float) +
         static_cast<size_t>(TT * k + (masked ? (TT + R) * META : 0)) *
             sizeof(int);
}

bool bad_shape(size_t smem, int T, int kd, int width, int m_rows, int k,
               int splits, int rows_per_split) {
  return smem == 0 || T < 1 || width < kd + 2 || m_rows < k || splits < 1 ||
         rows_per_split < 1 ||
         static_cast<long long>(splits) * rows_per_split < m_rows;
}

int merge(const float* part_v, const int* part_i, const float* comp,
          float* out_v, int* out_i, int T, int k, int splits,
          cudaStream_t stream) {
  const size_t smem2 = static_cast<size_t>(WARPS * k) * (sizeof(float) + sizeof(int));
  topk_merge<<<(T + WARPS - 1) / WARPS, THREADS, smem2, stream>>>(
      part_v, part_i, comp, out_v, out_i, T, k, splits);
  return static_cast<int>(cudaGetLastError());
}

template <bool PART, bool LING>
int launch(const float* t2, const float* raw, const float* comp,
           const int* tmeta, const int* dmeta, Penalties pen, float* part_v,
           int* part_i, float* out_v, int* out_i, int T, int kd, int width,
           int m_rows, int k, int splits, int rows_per_split,
           cudaStream_t stream) {
  constexpr bool MASKED = PART || LING;
  const size_t smem1 = partial_smem(kd, k, MASKED, HIGHEST);
  if (bad_shape(smem1, T, kd, width, m_rows, k, splits, rows_per_split) ||
      (MASKED && (tmeta == nullptr || dmeta == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaFuncSetAttribute(
      topk_partial<PART, LING>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem1));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid1((T + TT - 1) / TT, splits);
  topk_partial<PART, LING><<<grid1, THREADS, smem1, stream>>>(
      t2, raw, tmeta, dmeta, pen, part_v, part_i, T, kd, width, m_rows,
      rows_per_split, k, splits);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return merge(part_v, part_i, comp, out_v, out_i, T, k, splits, stream);
}

template <int PREC, bool PART, bool LING>
int launch_split(const float* t2, const float* raw, const float* comp,
                 const int* tmeta, const int* dmeta, Penalties pen,
                 float* part_v, int* part_i, float* out_v, int* out_i, int T,
                 int kd, int width, int m_rows, int k, int splits,
                 int rows_per_split, cudaStream_t stream) {
  constexpr bool MASKED = PART || LING;
  const size_t smem1 = partial_smem(kd, k, MASKED, PREC);
  if (bad_shape(smem1, T, kd, width, m_rows, k, splits, rows_per_split) ||
      (MASKED && (tmeta == nullptr || dmeta == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaFuncSetAttribute(
      topk_partial_split<PREC, PART, LING>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem1));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid1((T + TT - 1) / TT, splits);
  topk_partial_split<PREC, PART, LING><<<grid1, THREADS, smem1, stream>>>(
      t2, raw, tmeta, dmeta, pen, part_v, part_i, T, kd, width, m_rows,
      rows_per_split, k, splits);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return merge(part_v, part_i, comp, out_v, out_i, T, k, splits, stream);
}

}  // namespace

extern "C" {

// Dynamic shared memory pass 1 needs (masked != 0: a variant with fused
// masks; precision: 0 highest, 1 split3, 2 split3cat); 0 if the shape or
// the combination is not supported.
size_t snk_topk_partial_smem(int kd, int k, int masked, int precision) {
  return partial_smem(kd, k, masked != 0, precision);
}

int snk_topk_tile_rows() { return TT; }

int snk_topk_db_tile_rows() { return R; }

// Each entry point launches both passes on `stream` and returns the
// cudaError_t of the launches.  tmeta (T, 8) and dmeta (m_rows, 8) are read
// by the masked variants only; p0..p4 by the linguistic ones only.  All
// entry points share one signature.
#define SNK_TOPK_ENTRY(NAME, CALL)                                            \
  int NAME(const float* t2, const float* raw, const float* comp,            \
           const int* tmeta, const int* dmeta, float p0, float p1, float p2, \
           float p3, float p4, float* part_v, int* part_i, float* out_v,     \
           int* out_i, int T, int kd, int width, int m_rows, int k,          \
           int splits, int rows_per_split, cudaStream_t stream) {            \
    const Penalties pen = {{p0, p1, p2, p3, p4}};                           \
    (void)pen;                                                              \
    return CALL;                                                            \
  }

#define SNK_MASKED(PART, LING)                                               \
  launch<PART, LING>(t2, raw, comp, tmeta, dmeta, pen, part_v, part_i, out_v, \
                     out_i, T, kd, width, m_rows, k, splits, rows_per_split,  \
                     stream)
#define SNK_SPLIT(PREC, PART, LING)                                          \
  launch_split<PREC, PART, LING>(t2, raw, comp, tmeta, dmeta, pen, part_v,   \
                                 part_i, out_v, out_i, T, kd, width, m_rows, \
                                 k, splits, rows_per_split, stream)

SNK_TOPK_ENTRY(snk_topk_preselect_zt, SNK_MASKED(false, false))
SNK_TOPK_ENTRY(snk_topk_preselect_zt_part, SNK_MASKED(true, false))
SNK_TOPK_ENTRY(snk_topk_preselect_zt_ling, SNK_MASKED(false, true))
SNK_TOPK_ENTRY(snk_topk_preselect_zt_ling_part, SNK_MASKED(true, true))
SNK_TOPK_ENTRY(snk_topk_preselect_zt_split3, SNK_SPLIT(SPLIT3, false, false))
SNK_TOPK_ENTRY(snk_topk_preselect_zt_split3_part, SNK_SPLIT(SPLIT3, true, false))
SNK_TOPK_ENTRY(snk_topk_preselect_zt_split3_ling, SNK_SPLIT(SPLIT3, false, true))
SNK_TOPK_ENTRY(snk_topk_preselect_zt_split3_ling_part,
               SNK_SPLIT(SPLIT3, true, true))
SNK_TOPK_ENTRY(snk_topk_preselect_zt_split3cat,
               SNK_SPLIT(SPLIT3CAT, false, false))
SNK_TOPK_ENTRY(snk_topk_preselect_zt_split3cat_part,
               SNK_SPLIT(SPLIT3CAT, true, false))
SNK_TOPK_ENTRY(snk_topk_preselect_zt_split3cat_ling,
               SNK_SPLIT(SPLIT3CAT, false, true))
SNK_TOPK_ENTRY(snk_topk_preselect_zt_split3cat_ling_part,
               SNK_SPLIT(SPLIT3CAT, true, true))

#undef SNK_SPLIT
#undef SNK_MASKED
#undef SNK_TOPK_ENTRY

}  // extern "C"

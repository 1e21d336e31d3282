// Exact fused distance + top-k preselect over the resident raw unit block,
// hand-written CUDA C++ for Hopper (sm_90a).
//
// Replaces snickery_tpu/ops/pallas_topk.py::pallas_topk_preselect in the
// form the synthesis main path runs: precision "highest", zero_transient=True,
// select="stream" (_topk_kernel + _compute_scores + _stream_select).
//
// For every target row t and DB row u in [0, m_rows):
//
//     score(t, u) = sqn[u] - 2 * sum_{c < kd} raw[u, c] * t2[t, c]
//
// where raw is the (q, kd + 2) block [data kd | sqn | ptr] built by
// voicedb.device_layout.build_raw_blocks(affine=...).  Column kd holds the
// squared norm of the normalised row (1e6-sentinel norm for padding rows);
// column kd + 1 holds int32 pointer BITS and is never loaded (as f32 it can
// be NaN or denormal).  Per target the k smallest (score, u) pairs are kept,
// the lowest u winning ties, and comp[t] is added to the returned scores.
//
// Shape of the work on Hopper.  The TPU kernel walks the DB chunk by chunk
// in sequence and carries a k-slot state in VMEM.  Here blocks run in
// parallel and in no order, so the DB is cut into S contiguous splits as
// well as the targets into tiles of TT rows:
//
//   pass 1 (topk_partial), grid (target tiles) x (S splits): the target tile
//     sits in shared memory (column-major); DB rows stream through shared
//     memory in tiles of R rows x KC columns with coalesced-by-row scalar
//     loads (the 4 * (kd + 2)-byte row stride is not 16-byte aligned); each
//     thread accumulates a 4 x 4 register tile with FP32 FMAs on the CUDA
//     cores (no TF32).  After each DB tile one warp per target offers the
//     tile's 64 scores to a sorted k-slot list in shared memory: a candidate
//     enters only if it beats the worst (score, index) pair, so a warm list
//     costs one ballot per 32 scores.
//   pass 2 (topk_merge): one warp per target merges the S sorted partial
//     lists under the same (score, index) order and adds comp.
//
// S is chosen by the wrapper so that tiles x S fills the card at small T
// (one utterance: 2 to 32 target tiles) as well as at large T.
//
// Bound: at the config-3 batch shape (65,536 targets x 1,048,576 units x
// kd = 151) the work is about 2.1e13 FLOP of FP32 FMA, so the kernel is
// bound by FP32 FMA throughput and shared-memory operand traffic; the DB
// (about 640 MB) is read from device memory about once per wave of
// resident target tiles, and from L2 by the other tiles of that wave.

#include <cuda_runtime.h>

#include <climits>
#include <cstddef>

namespace {

constexpr int TT = 64;                  // target rows per CTA
constexpr int R = 64;                   // DB rows per tile
constexpr int KC = 32;                  // DB columns per shared-memory stage
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int KMAX = 64;                // list slots: two per lane
constexpr unsigned FULL = 0xffffffffu;

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
// candidates that beat the worst slot are inserted one at a time in lane
// order, each re-checked against the worst slot as it stands then.
__device__ void warp_offer(float* lv, int* li, int k, float v, int i, bool ok,
                           int lane) {
  unsigned m = __ballot_sync(FULL, ok && lex_less(v, i, lv[k - 1], li[k - 1]));
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

__global__ void __launch_bounds__(THREADS, 2)
topk_partial(const float* __restrict__ t2, const float* __restrict__ raw,
             float* __restrict__ part_v, int* __restrict__ part_i, int T,
             int kd, int width, int m_rows, int rows_per_split, int k,
             int splits) {
  extern __shared__ __align__(16) float smem[];
  float* sT = smem;                       // [kd][TT]  targets, column-major
  float* sD = sT + kd * TT;               // [KC][R]   DB tile stage
  float* sS = sD + KC * R;                // [TT][R]   scores of the tile
  float* sSqn = sS + TT * R;              // [R]       sqn column of the tile
  float* lv = sSqn + R;                   // [TT][k]   list values
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
  for (int e = tid; e < TT * k; e += THREADS) {
    lv[e] = pos_inf();
    li[e] = INT_MAX;
  }
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
      float4 s;
      s.x = sSqn[tx * 4 + 0] - 2.f * acc[i][0];
      s.y = sSqn[tx * 4 + 1] - 2.f * acc[i][1];
      s.z = sSqn[tx * 4 + 2] - 2.f * acc[i][2];
      s.w = sSqn[tx * 4 + 3] - 2.f * acc[i][3];
      *reinterpret_cast<float4*>(sS + (ty * 4 + i) * R + tx * 4) = s;
    }
    __syncthreads();
    for (int t = warp; t < TT; t += WARPS) {
      if (t0 + t >= T) continue;          // uniform across the warp
      for (int h = 0; h < R; h += 32) {
        const int u = base + h + lane;
        warp_offer(lv + t * k, li + t * k, k, sS[t * R + h + lane], u,
                   u < row_hi, lane);
      }
    }
  }

  for (int t = warp; t < TT; t += WARPS) {
    if (t0 + t >= T) continue;
    const size_t o = (static_cast<size_t>(t0 + t) * splits + split) * k;
    for (int j = lane; j < k; j += 32) {
      part_v[o + j] = lv[t * k + j];
      part_i[o + j] = li[t * k + j];
    }
  }
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
    out_v[static_cast<size_t>(t) * k + j] = lv[j] + c;
    out_i[static_cast<size_t>(t) * k + j] = li[j];
  }
}

}  // namespace

extern "C" {

// Dynamic shared memory pass 1 needs; 0 if the shape is not supported.
size_t snk_topk_partial_smem(int kd, int k) {
  if (kd < 1 || k < 1 || k > KMAX) return 0;
  return static_cast<size_t>(kd * TT + KC * R + TT * R + R + TT * k) *
             sizeof(float) +
         static_cast<size_t>(TT * k) * sizeof(int);
}

int snk_topk_tile_rows() { return TT; }

int snk_topk_db_tile_rows() { return R; }

// Launches both passes on `stream`; returns the cudaError_t of the launches.
int snk_topk_preselect_zt(const float* t2, const float* raw, const float* comp,
                          float* part_v, int* part_i, float* out_v, int* out_i,
                          int T, int kd, int width, int m_rows, int k,
                          int splits, int rows_per_split, cudaStream_t stream) {
  const size_t smem1 = snk_topk_partial_smem(kd, k);
  if (smem1 == 0 || T < 1 || width < kd + 2 || m_rows < k || splits < 1 ||
      rows_per_split < 1 ||
      static_cast<long long>(splits) * rows_per_split < m_rows) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaFuncSetAttribute(
      topk_partial, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem1));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid1((T + TT - 1) / TT, splits);
  topk_partial<<<grid1, THREADS, smem1, stream>>>(
      t2, raw, part_v, part_i, T, kd, width, m_rows, rows_per_split, k, splits);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem2 = static_cast<size_t>(WARPS * k) * (sizeof(float) + sizeof(int));
  topk_merge<<<(T + WARPS - 1) / WARPS, THREADS, smem2, stream>>>(
      part_v, part_i, comp, out_v, out_i, T, k, splits);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

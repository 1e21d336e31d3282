// Overlap-add of the selected units of B utterances, hand-written CUDA C++
// for Hopper (sm_90a): each output sample is owned by one thread, summed in
// a register over the fragments that cover it and written once.
//
// Replaces the scatter-add of the JAX package's overlap-add
// (snickery_tpu/ops/ola.py, overlap_add_units: the fragments' rows rolled
// into place and summed into the output with a scatter-add); its plain
// PyTorch version is overlap_add_units_plain in snickery_tpu_torch/ops/ola.py,
// which builds every (B, U, max_frag) fragment slot and sums them with an
// atomic index_add_.  No atomics and no fragment tensors here.
//
// Semantics (those of the plain version).  Unit u < n_units[b] of utterance
// b has the span [cut_start, cut_end); its fragment is the corpus samples
// [cut_start - taper, cut_end + taper), L = span + 2 taper of them, placed at
// s_u = the sum of the spans before it, so neighbours overlap by 2 taper.
// Sample p of the fragment (p < min(L, max_frag)) adds
// (waves[src] * scale) * min(ramp[min(p, 2 taper)], ramp[min(L - 1 - p, 2 taper)])
// to output s_u + p where 0 <= src = cut_start - taper + p < n_waves (else
// nothing); samples at or past out_len are dropped and the rest of the
// output is 0.  ramp holds the f32 raised cosine at positions 0..2 taper as
// the plain version computes it, whose fall at p is its rise at L - 1 - p,
// so the weights are the plain version's bits.  Products and sums use
// __fmul_rn / __fadd_rn, so nothing is contracted into an FMA, and a sample
// sums its fragments in ascending unit order from 0.0: the order in which
// the CPU's index_add_ adds them, so the two agree bit for bit.
//
// Placement.  The wrapper passes incl, the inclusive sum of the live spans
// along each utterance: s_u = incl[u - 1] (0 for u = 0) and the fragment
// ends at e_u = incl[u] + 2 taper, both non-decreasing in u (spans are not
// negative).  A CTA owns OLA_TILE consecutive samples of one utterance (grid:
// tiles of out_len x B).  Its first warp finds the first unit with e_u past
// the tile's start by a 32-way search over incl (three rounds at U = 2,048);
// the CTA then stages the units that start before the tile's end in shared
// memory, 256 at a time, and each thread walks them for its OLA_ITEMS
// samples (a stride of 256 apart: neighbouring threads read neighbouring
// corpus samples and write neighbouring outputs), a pointer per thread
// skipping the units that end before its sample.  A sample is covered by
// about two fragments of halfphones and up to three where a span is shorter
// than 2 taper.
//
// What bounds it: the fragments' samples read once and the output written
// once (benchmark/roofline.py ola_bound_ms): at 512 halfphone utterances of
// up to 64 units ~30 M samples each way, ~0.07 ms at 3.35 TB/s.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int OLA_THREADS = 256;
constexpr int OLA_ITEMS = 8;
constexpr int OLA_TILE = OLA_THREADS * OLA_ITEMS;   // output samples a CTA owns

__device__ __forceinline__ int64_t lmin(int64_t a, int64_t b) { return a < b ? a : b; }
__device__ __forceinline__ int64_t lmax(int64_t a, int64_t b) { return a > b ? a : b; }
__device__ __forceinline__ float sample(const float* w, int64_t i) { return __ldg(w + i); }
__device__ __forceinline__ float sample(const int16_t* w, int64_t i) {
  return static_cast<float>(__ldg(w + i));
}

template <typename W>
__global__ void __launch_bounds__(OLA_THREADS)
ola_kernel(const W* __restrict__ waves, int64_t n_waves, const float* __restrict__ scale_ptr,
           const int64_t* __restrict__ cut_start,
           const int64_t* __restrict__ incl, const int64_t* __restrict__ n_units,
           const float* __restrict__ ramp, int64_t taper, int64_t max_frag, int64_t units,
           int64_t out_len, float* __restrict__ out) {
  __shared__ int64_t sh_start[OLA_THREADS];   // s_u
  __shared__ int64_t sh_len[OLA_THREADS];     // L
  __shared__ int64_t sh_reach[OLA_THREADS];   // min(L, max_frag)
  __shared__ int64_t sh_src[OLA_THREADS];     // cut_start - taper
  __shared__ int64_t sh_first;

  const int b = blockIdx.y;
  const int64_t t0 = static_cast<int64_t>(blockIdx.x) * OLA_TILE;
  const int64_t t_end = lmin(t0 + OLA_TILE, out_len);
  const int64_t two_t = 2 * taper;
  const int64_t n = lmin(lmax(n_units[b], 0), units);
  const int64_t* cb = incl + b * units;
  const int64_t* cs = cut_start + b * units;

  if (threadIdx.x < 32) {
    // the first u in [0, n) with incl[u] + 2 taper > t0 (n where none)
    const int lane = threadIdx.x;
    int64_t lo = 0, hi = n;
    while (hi > lo) {
      const int64_t step = (hi - lo + 31) / 32;
      const int64_t idx = lo + (lane + 1) * step - 1;
      const bool past = idx >= hi || cb[idx] + two_t > t0;
      const unsigned m = __ballot_sync(0xffffffffu, past);
      if (m == 0) {
        lo = hi;
      } else {
        const int f = __ffs(m) - 1;
        const int64_t top = lmin(lo + (f + 1) * step - 1, hi);
        lo += f * step;
        hi = top;
      }
    }
    if (lane == 0) sh_first = lo;
  }
  __syncthreads();

  const float scale = __ldg(scale_ptr);
  float acc[OLA_ITEMS];
#pragma unroll
  for (int k = 0; k < OLA_ITEMS; ++k) acc[k] = 0.0f;

  for (int64_t base = sh_first;; base += OLA_THREADS) {
    const int64_t u = base + threadIdx.x;
    bool staged = false;
    if (u < n) {
      const int64_t s = u > 0 ? cb[u - 1] : 0;
      if (s < t_end) {
        const int64_t len = cb[u] - s + two_t;
        sh_start[threadIdx.x] = s;
        sh_len[threadIdx.x] = len;
        sh_reach[threadIdx.x] = lmin(len, max_frag);
        sh_src[threadIdx.x] = cs[u] - taper;
        staged = true;
      }
    }
    // the units staged are a prefix of the batch: starts do not decrease
    const int count = __syncthreads_count(staged);
    int f = 0;
#pragma unroll
    for (int k = 0; k < OLA_ITEMS; ++k) {
      const int64_t j = t0 + threadIdx.x + k * OLA_THREADS;
      if (j < t_end) {
        while (f < count && sh_start[f] + sh_len[f] <= j) ++f;
        float a = acc[k];
        for (int i = f; i < count && sh_start[i] <= j; ++i) {
          const int64_t p = j - sh_start[i];
          const int64_t src = sh_src[i] + p;
          if (p < sh_reach[i] && src >= 0 && src < n_waves) {
            const float x = __fmul_rn(sample(waves, src), scale);
            const float w = fminf(__ldg(ramp + lmin(p, two_t)),
                                  __ldg(ramp + lmin(sh_len[i] - 1 - p, two_t)));
            a = __fadd_rn(a, __fmul_rn(x, w));
          }
        }
        acc[k] = a;
      }
    }
    if (count < OLA_THREADS) break;
    __syncthreads();
  }

  float* row = out + b * out_len;
#pragma unroll
  for (int k = 0; k < OLA_ITEMS; ++k) {
    const int64_t j = t0 + threadIdx.x + k * OLA_THREADS;
    if (j < t_end) row[j] = acc[k];
  }
}

}  // namespace

extern "C" {

// Output samples a CTA owns; the wrapper's grid must use the same.
int snk_overlap_add_tile() { return OLA_TILE; }

// Overlap-add of B utterances: waves (n_waves,) f32 (wave_kind 0) or int16
// (1), read as waves * scale (scale_ptr, a device f32); cut_start and incl
// (B, units) int64, incl the inclusive sum of the live spans; n_units (B,)
// int64; ramp (2 taper + 1,) f32; out (B, out_len) f32, every sample
// written.  The wrapper (ops/ola.py) checks the shapes; returns the launch's
// cudaError_t.
int snk_overlap_add(const void* waves, int wave_kind, int64_t n_waves, const float* scale_ptr,
                    const int64_t* cut_start, const int64_t* incl, const int64_t* n_units,
                    const float* ramp, int64_t taper, int64_t max_frag, int n_batch,
                    int64_t units, int64_t out_len, float* out, void* stream) {
  const dim3 grid(static_cast<unsigned>((out_len + OLA_TILE - 1) / OLA_TILE),
                  static_cast<unsigned>(n_batch));
  auto s = static_cast<cudaStream_t>(stream);
  if (wave_kind == 1)
    ola_kernel<int16_t><<<grid, OLA_THREADS, 0, s>>>(
        static_cast<const int16_t*>(waves), n_waves, scale_ptr, cut_start, incl, n_units, ramp,
        taper, max_frag, units, out_len, out);
  else
    ola_kernel<float><<<grid, OLA_THREADS, 0, s>>>(
        static_cast<const float*>(waves), n_waves, scale_ptr, cut_start, incl, n_units, ramp,
        taper, max_frag, units, out_len, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

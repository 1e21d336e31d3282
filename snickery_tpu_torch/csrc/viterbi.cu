// Decodes of the candidate lattice, hand-written CUDA C++ for Hopper
// (sm_90a): the Viterbi search with its backtrack, greedy selection, and
// greedy selection over one streaming chunk.  One CTA an utterance (grid B),
// the loop over the lattice steps inside the CTA, nothing back to the host
// between the first step and the path.
//
// Replaces the XLA scans of the JAX package (no Pallas kernel there):
//   snk_viterbi_decode       snickery_tpu/ops/viterbi.py:102 (the forward
//                            lax.scan, step :79-100) and :117 (the reverse
//                            scan of the backtrack);
//   snk_greedy_decode        snickery_tpu/ops/viterbi.py:155 (step :145-153);
//   snk_greedy_decode_stream snickery_tpu/synth.py:337 (_streaming_step's
//                            scan, step :325-335).
// Their plain PyTorch versions are viterbi_decode_plain, greedy_decode_plain
// and greedy_decode_stream_plain in snickery_tpu_torch/ops/viterbi.py, whose
// arithmetic the kernels repeat operation for operation, with one exception:
// a join distance is summed here in one fixed order (ascending column, one
// fmaf a column in the Viterbi, lane-strided partial sums and a fixed
// butterfly in the greedy forms), where torch.sum picks its own.  A natural
// join (bit-equal contexts) costs exactly 0.0 in both, which the
// |r|^2 + |l|^2 - 2 r.l form of the JAX version does not give.  Cost
// arithmetic outside the distance uses __fmul_rn / __fadd_rn, so the
// compiler contracts nothing there into an FMA that the plain version does
// not make.  No atomics: the same inputs give the same bits on every run.
//
// Semantics (those of the plain versions).  Viterbi: cost_0 = tc[0];
// cost_t[j] = min_i(pruned(cost_{t-1})[i] + jcw * D_t[i, j]) + tc[t, j],
// D_t[i, j] the (squared with `squared`) Euclidean distance between
// join_right[t-1, i] and join_left[t, j]; pruned() sets BIG_PENALTY on
// states above the running best + eps when eps > 0; the backpointer is the
// first minimum (ascending i, strict <).  The plain loop runs to
// n_run = max(1, min(T, max_b length[b])) and treats steps at or past
// length[b] as dead (no target or join cost).  A dead step makes every
// state's cost min(pruned(cost)) and points it at that minimum's first
// state, and a later dead step changes nothing, so the kernel stops at the
// utterance's own last live step L = max(1, length[b]) and finishes as the
// plain loop would: if L < n_run the last state is the first argmin of
// pruned(cost_{L-1}) and the total its minimum, else those of cost_{L-1};
// path[t] = 0 for t >= L.  Each CTA reads every length to find n_run on
// the device.  Greedy: choice_0 = first argmin tc[0], then
// choice_t = first argmin(tc[t] + jcw * dist(join_left[t], ctx)),
// ctx = join_right[t-1, choice_{t-1}], the total summed in step order;
// dead steps choose 0 and add nothing.  The streamed form starts from an
// incoming context weighted by jcw_first, runs its n_live (a host int)
// steps at jcw_rest after the first, and writes the outgoing context.
//
// What bounds it.  At config 3 (B = 32 utterances, T = 2,048 steps,
// N = 30 candidates, dj = 151) the Viterbi reads B T N (2 dj + 1) 4 bytes =
// 2.38 GB (0.71 ms at 3.35 TB/s) and does B T N^2 dj 3 = 26.7 GFLOP of FP32
// work (0.40 ms at 67 TFLOP/s): bytes bound it on paper.  In practice it
// is bound by the chain of dependent steps: one CTA an utterance puts only
// B of the 132 SMs to work, and each walks its T steps in order, with block
// barriers in every step.  What the design does about it: the next step's
// contexts and target costs are copied into shared memory with cp.async
// while the current step computes (a double buffer, STAGES = 2, where it
// fits; STAGES = 1 loads after the step's distances otherwise), so a step
// waits on shared memory and not on device memory; the N x N distances are
// spread over 512 threads, each a 1 x 2 register tile read as float4 from
// rows padded to a stride whose quarter is odd (no bank conflicts); the
// min over i is one warp a column j with shuffles; the running best for
// the pruning is recomputed by every warp from shared memory, so a step
// has two block barriers.  The backpointers (one byte a state: N <= 255)
// stay in shared memory when (T - 1) N bytes fit beside the buffers (61 KB
// at config 3), else in a global scratch the wrapper allocates; the CTA
// backtracks from them itself after its last step and writes its path and
// total.  Splitting an utterance over a cluster, and wgmma for the
// distances, are later work.
//
// The shared-memory plan (decode_smem) is a pure function of the kind, N,
// dj, T, the stage count and where the backpointers live; the Python
// wrapper computes the same plan (ops/viterbi.py::decode_plan) and passes
// its byte count, which each launcher checks against its own.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int VIT_THREADS = 512;
constexpr int GREEDY_THREADS = 256;
constexpr int MAX_STATES = 255;        // a backpointer is one byte
constexpr size_t SMEM_LIMIT = 227 * 1024;
constexpr float BIG_PENALTY = 1.0e10f;  // snickery_tpu_torch/const.py
constexpr int KIND_VITERBI = 0;
constexpr int KIND_GREEDY = 1;

// floats of a staged context row: dj rounded up to a multiple of 4, with an
// odd number of float4s, so the 8 rows a quarter-warp reads as float4 fall
// in 8 distinct bank groups.  Columns past dj are zero on both sides.
__host__ __device__ inline int row_stride(int dj) {
  int s = (dj + 3) / 4 * 4;
  return ((s / 4) % 2 == 0) ? s + 4 : s;
}

__host__ __device__ inline size_t align16(size_t x) { return (x + 15) / 16 * 16; }

// Byte offsets into the dynamic shared memory of one CTA.
struct Layout {
  size_t left;    // stages x (N, stride) f32: join_left of a step
  size_t right;   // stages x (N, stride) f32: join_right of the step before
  size_t tc;      // 2 x N f32: target costs of a step
  size_t trans;   // Viterbi: (N, N | 1) f32 transition costs [j][i]; greedy: N totals
  size_t aux;     // Viterbi: N running costs; greedy: the incoming context (stride)
  size_t misc;    // 16 bytes: the greedy choice
  size_t bp;      // Viterbi with bp_in_smem: (T - 1, N) bytes of backpointers
  size_t total;
  size_t buf;     // bytes of one (N, stride) buffer
  size_t tcw;     // floats of one target-cost buffer
  int stride;
};

__host__ __device__ inline Layout layout(int kind, int n, int dj, int t_steps, int stages,
                                         int bp_in_smem) {
  Layout l;
  l.stride = row_stride(dj);
  l.buf = align16(static_cast<size_t>(n) * l.stride * 4);
  l.tcw = align16(static_cast<size_t>(n) * 4) / 4;
  size_t off = 0;
  l.left = off;
  off += stages * l.buf;
  l.right = off;
  off += stages * l.buf;
  l.tc = off;
  off += 2 * l.tcw * 4;
  l.trans = off;
  off += kind == KIND_VITERBI ? align16(static_cast<size_t>(n) * (n | 1) * 4)
                              : align16(static_cast<size_t>(n) * 4);
  l.aux = off;
  off += kind == KIND_VITERBI ? align16(static_cast<size_t>(n) * 4)
                              : align16(static_cast<size_t>(l.stride) * 4);
  l.misc = off;
  off += 16;
  l.bp = off;
  if (kind == KIND_VITERBI && bp_in_smem && t_steps > 1)
    off += align16(static_cast<size_t>(t_steps - 1) * n);
  l.total = off;
  return l;
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// The first minimum of a warp's (value, index) pairs: the least value, the
// lowest index among equal values.  Every lane gets the result.
__device__ __forceinline__ void warp_argmin(float& v, int& a) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, v, off);
    const int oa = __shfl_xor_sync(0xffffffffu, a, off);
    if (ov < v || (ov == v && oa < a)) {
      v = ov;
      a = oa;
    }
  }
}

// First minimum over x[0..n) by one warp: lane l scans l, l + 32, ... in
// ascending order with a strict <, then the warp combines.
__device__ __forceinline__ void warp_first_min(const float* x, int n, int lane, float& v,
                                               int& a) {
  v = __int_as_float(0x7f800000);
  a = 0x7fffffff;
  for (int i = lane; i < n; i += 32) {
    const float y = x[i];
    if (a == 0x7fffffff || y < v) {
      v = y;
      a = i;
    }
  }
  warp_argmin(v, a);
}

__device__ __forceinline__ float warp_min(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fminf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// The step's staging: join_left[t] into its left buffer, join_right[t-1]
// (t >= 1) into its right buffer and tc[t] into its target-cost buffer, by
// 4-byte cp.async (a (N, dj) slab of the input starts on a 4-byte boundary
// only), one warp a row and its lanes along the columns.
template <int THREADS>
__device__ __forceinline__ void stage_step(float* dl, float* dr, float* dt, const float* jl,
                                           const float* jr, const float* tc, int n, int dj,
                                           int stride, int tid) {
  const int warp = tid >> 5, lane = tid & 31;
  for (int r = warp; r < n; r += THREADS / 32) {
    for (int c = lane; c < dj; c += 32) {
      cp_async4(dl + r * stride + c, jl + r * dj + c);
      if (dr != nullptr) cp_async4(dr + r * stride + c, jr + r * dj + c);
    }
  }
  for (int j = tid; j < n; j += THREADS) cp_async4(dt + j, tc + j);
}

// Zero the padding columns [dj, stride) of `rows` staged rows.
__device__ __forceinline__ void zero_pads(float* base, int rows, int dj, int stride, int tid,
                                          int threads) {
  const int pad = stride - dj;
  for (int e = tid; e < rows * pad; e += threads) base[(e / pad) * stride + dj + e % pad] = 0.0f;
}

// --------------------------------------------------------------- Viterbi
template <int STAGES>
__global__ void __launch_bounds__(VIT_THREADS, 1)
    viterbi_kernel(const float* __restrict__ tc, const float* __restrict__ jl,
                   const float* __restrict__ jr, const int64_t* __restrict__ length,
                   int64_t* __restrict__ paths, float* __restrict__ totals,
                   uint8_t* __restrict__ bp_global, int n_batch, int t_steps, int n, int dj,
                   float jcw, float eps, int squared, int bp_in_smem) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L = layout(KIND_VITERBI, n, dj, t_steps, STAGES, bp_in_smem);
  const int S = L.stride, NS = n | 1;
  const int b = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  constexpr int NW = VIT_THREADS / 32;
  float* sl = reinterpret_cast<float*>(smem + L.left);
  float* sr = reinterpret_cast<float*>(smem + L.right);
  float* stc = reinterpret_cast<float*>(smem + L.tc);
  float* strans = reinterpret_cast<float*>(smem + L.trans);
  float* scost = reinterpret_cast<float*>(smem + L.aux);
  uint8_t* bp = bp_in_smem ? smem + L.bp
                           : bp_global + static_cast<size_t>(b) * (t_steps - 1) * n;
  const size_t slab = static_cast<size_t>(n) * dj;
  const float* tcb = tc + static_cast<size_t>(b) * t_steps * n;
  const float* jlb = jl + static_cast<size_t>(b) * t_steps * slab;
  const float* jrb = jr + static_cast<size_t>(b) * t_steps * slab;
  const int fbuf = static_cast<int>(L.buf / 4);

  // the plain loop's length n_run, and this utterance's live steps
  int n_run = t_steps, len_b = t_steps;
  if (length != nullptr) {
    int64_t most = length[0];
    for (int i = 1; i < n_batch; ++i) most = most > length[i] ? most : length[i];
    most = most < t_steps ? most : t_steps;
    n_run = most > 1 ? static_cast<int>(most) : 1;
    const int64_t lb = length[b];
    len_b = lb < 0 ? 0 : (lb < t_steps ? static_cast<int>(lb) : t_steps);
  }
  const int live = len_b > 1 ? len_b : 1;
  auto slot = [](int t) { return STAGES == 2 ? (t & 1) : 0; };
  auto issue = [&](int t) {
    stage_step<VIT_THREADS>(sl + slot(t) * fbuf, sr + slot(t - 1) * fbuf,
                            stc + (t & 1) * L.tcw, jlb + t * slab, jrb + (t - 1) * slab,
                            tcb + static_cast<size_t>(t) * n, n, dj, S, tid);
  };

  zero_pads(sl, STAGES * (fbuf / S), dj, S, tid, VIT_THREADS);
  zero_pads(sr, STAGES * (fbuf / S), dj, S, tid, VIT_THREADS);
  for (int j = tid; j < n; j += VIT_THREADS) scost[j] = len_b == 0 ? 0.0f : tcb[j];
  if (live > 1) issue(1);
  cp_async_commit();

  const int nj = (n + 1) / 2;             // a thread's tile: one i, columns j and j + nj
  const int n_tiles = n * nj;
  const int nc4 = (dj + 3) / 4;
  for (int t = 1; t < live; ++t) {
    cp_async_wait_all();
    __syncthreads();                      // (A) step t staged; cost_{t-1} visible
    if (STAGES == 2 && t + 1 < live) issue(t + 1);
    cp_async_commit();
    const float* R = sr + slot(t - 1) * fbuf;
    const float* Lf = sl + slot(t) * fbuf;
    float best = 0.0f;
    if (eps > 0.0f) {
      float m = __int_as_float(0x7f800000);
      for (int i = lane; i < n; i += 32) m = fminf(m, scost[i]);
      best = warp_min(m);
    }
    for (int p = tid; p < n_tiles; p += VIT_THREADS) {
      const int i = p / nj, j0 = p - i * nj, j1 = j0 + nj;
      const float4* r = reinterpret_cast<const float4*>(R + i * S);
      const float4* l0 = reinterpret_cast<const float4*>(Lf + j0 * S);
      const float4* l1 = reinterpret_cast<const float4*>(Lf + (j1 < n ? j1 : j0) * S);
      float a0 = 0.0f, a1 = 0.0f;
#pragma unroll 4
      for (int c = 0; c < nc4; ++c) {
        const float4 x = r[c], y = l0[c], z = l1[c];
        float d;
        d = x.x - y.x; a0 = fmaf(d, d, a0);
        d = x.y - y.y; a0 = fmaf(d, d, a0);
        d = x.z - y.z; a0 = fmaf(d, d, a0);
        d = x.w - y.w; a0 = fmaf(d, d, a0);
        d = x.x - z.x; a1 = fmaf(d, d, a1);
        d = x.y - z.y; a1 = fmaf(d, d, a1);
        d = x.z - z.z; a1 = fmaf(d, d, a1);
        d = x.w - z.w; a1 = fmaf(d, d, a1);
      }
      if (!squared) {
        a0 = sqrtf(a0);
        a1 = sqrtf(a1);
      }
      const float ci = scost[i];
      const float pr = (eps > 0.0f && ci > __fadd_rn(best, eps)) ? BIG_PENALTY : ci;
      strans[j0 * NS + i] = __fadd_rn(pr, __fmul_rn(jcw, a0));
      if (j1 < n) strans[j1 * NS + i] = __fadd_rn(pr, __fmul_rn(jcw, a1));
    }
    __syncthreads();                      // (B) the transitions are in
    if (STAGES == 1 && t + 1 < live) issue(t + 1);
    cp_async_commit();
    const float* tct = stc + (t & 1) * L.tcw;
    uint8_t* bpt = bp + static_cast<size_t>(t - 1) * n;
    for (int j = warp; j < n; j += NW) {
      float v;
      int a;
      warp_first_min(strans + j * NS, n, lane, v, a);
      if (lane == 0) {
        scost[j] = __fadd_rn(v, tct[j]);
        bpt[j] = static_cast<uint8_t>(a);
      }
    }
  }
  cp_async_wait_all();
  __syncthreads();                        // the last costs and backpointers are in

  if (warp == 0) {
    // the final state: of pruned(cost) where the plain loop runs dead steps
    // past this utterance, of cost where it ends with it
    float* fin = strans;                  // free now
    const bool dead_after = live < n_run && eps > 0.0f;
    float best = 0.0f;
    if (dead_after) {
      float m = __int_as_float(0x7f800000);
      for (int i = lane; i < n; i += 32) m = fminf(m, scost[i]);
      best = warp_min(m);
    }
    for (int i = lane; i < n; i += 32) {
      const float c = scost[i];
      fin[i] = (dead_after && c > __fadd_rn(best, eps)) ? BIG_PENALTY : c;
    }
    __syncwarp();
    float v;
    int a;
    warp_first_min(fin, n, lane, v, a);
    if (lane == 0) {
      totals[b] = v;
      int64_t* path = paths + static_cast<size_t>(b) * t_steps;
      int s = a;
      path[live - 1] = s;
      for (int t = live - 1; t >= 1; --t) {
        s = bp[static_cast<size_t>(t - 1) * n + s];
        path[t - 1] = s;
      }
    }
  }
  for (int t = live + tid; t < t_steps; t += VIT_THREADS)
    paths[static_cast<size_t>(b) * t_steps + t] = 0;
}

// ---------------------------------------------------------------- greedy
// STREAM: one chunk (grid 1) from an incoming context, n_live steps, the
// outgoing context written; else one utterance a CTA from no context.
template <bool STREAM, int STAGES>
__global__ void __launch_bounds__(GREEDY_THREADS, 1)
    greedy_kernel(const float* __restrict__ tc, const float* __restrict__ jl,
                  const float* __restrict__ jr, const int64_t* __restrict__ length,
                  const float* __restrict__ init_ctx, int64_t* __restrict__ paths,
                  float* __restrict__ totals, float* __restrict__ ctx_out, int t_steps, int n,
                  int dj, float jcw_first, float jcw, int squared, int n_live) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L = layout(KIND_GREEDY, n, dj, t_steps, STAGES, 0);
  const int S = L.stride;
  const int b = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  constexpr int NW = GREEDY_THREADS / 32;
  float* sl = reinterpret_cast<float*>(smem + L.left);
  float* sr = reinterpret_cast<float*>(smem + L.right);
  float* stc = reinterpret_cast<float*>(smem + L.tc);
  float* stot = reinterpret_cast<float*>(smem + L.trans);
  float* sctx0 = reinterpret_cast<float*>(smem + L.aux);
  int* schoice = reinterpret_cast<int*>(smem + L.misc);
  const size_t slab = static_cast<size_t>(n) * dj;
  const float* tcb = tc + static_cast<size_t>(b) * t_steps * n;
  const float* jlb = jl + static_cast<size_t>(b) * t_steps * slab;
  const float* jrb = jr + static_cast<size_t>(b) * t_steps * slab;
  const int fbuf = static_cast<int>(L.buf / 4);

  // steps to run; a batch utterance of length 0 still takes step 0 with
  // zero target costs (it chooses 0 and costs 0)
  int live;
  bool tc_zero = false;
  if (STREAM) {
    live = n_live;
  } else {
    int len_b = t_steps;
    if (length != nullptr) {
      const int64_t lb = length[b];
      len_b = lb < 0 ? 0 : (lb < t_steps ? static_cast<int>(lb) : t_steps);
    }
    tc_zero = len_b == 0;
    live = len_b > 1 ? len_b : 1;
  }
  auto slot = [](int t) { return STAGES == 2 ? (t & 1) : 0; };
  auto issue = [&](int t) {
    stage_step<GREEDY_THREADS>(sl + slot(t) * fbuf, t >= 1 ? sr + slot(t - 1) * fbuf : nullptr,
                               stc + (t & 1) * L.tcw, jlb + t * slab,
                               jrb + (t >= 1 ? (t - 1) * slab : 0),
                               tcb + static_cast<size_t>(t) * n, n, dj, S, tid);
  };

  zero_pads(sl, STAGES * (fbuf / S), dj, S, tid, GREEDY_THREADS);
  zero_pads(sr, STAGES * (fbuf / S), dj, S, tid, GREEDY_THREADS);
  if (STREAM) {
    for (int c = tid; c < S; c += GREEDY_THREADS) sctx0[c] = c < dj ? init_ctx[c] : 0.0f;
  }
  if (live > 0) issue(0);
  cp_async_commit();

  float acc = 0.0f;                       // thread 0's running total
  for (int t = 0; t < live; ++t) {
    cp_async_wait_all();
    __syncthreads();                      // (A) step t staged; choice_{t-1} visible
    if (STAGES == 2 && t + 1 < live) issue(t + 1);
    cp_async_commit();
    const float* Lf = sl + slot(t) * fbuf;
    const float* tct = stc + (t & 1) * L.tcw;
    const bool join = STREAM || t > 0;
    const float* ctx = t == 0 ? sctx0 : sr + slot(t - 1) * fbuf + schoice[0] * S;
    const float w = t == 0 ? jcw_first : jcw;
    for (int j = warp; j < n; j += NW) {
      float tot;
      if (join) {
        float a = 0.0f;
        for (int c = lane; c < dj; c += 32) {
          const float d = Lf[j * S + c] - ctx[c];
          a = fmaf(d, d, a);
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) a += __shfl_xor_sync(0xffffffffu, a, off);
        if (!squared) a = sqrtf(a);
        tot = __fadd_rn(tct[j], __fmul_rn(w, a));
      } else {
        tot = tc_zero ? 0.0f : tct[j];
      }
      if (lane == 0) stot[j] = tot;
    }
    __syncthreads();                      // (B) the step's totals are in
    if (STAGES == 1 && t + 1 < live) issue(t + 1);
    cp_async_commit();
    if (warp == 0) {
      float v;
      int a;
      warp_first_min(stot, n, lane, v, a);
      if (lane == 0) {
        schoice[0] = a;
        paths[static_cast<size_t>(b) * t_steps + t] = a;
        acc = t == 0 ? v : __fadd_rn(acc, v);
      }
    }
  }
  cp_async_wait_all();
  for (int t = live + tid; t < t_steps; t += GREEDY_THREADS)
    paths[static_cast<size_t>(b) * t_steps + t] = 0;
  if (STREAM) {
    __syncthreads();                      // the last choice is in
    const float* src = live == 0 ? init_ctx
                                 : jrb + (live - 1) * slab + static_cast<size_t>(schoice[0]) * dj;
    for (int c = tid; c < dj; c += GREEDY_THREADS) ctx_out[c] = src[c];
  } else if (tid == 0) {
    totals[b] = acc;
  }
}

template <typename K>
cudaError_t prepare(K kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

bool bad_shape(int kind, int n, int dj, int t_steps, int stages, int bp_in_smem, size_t smem) {
  if (n < 1 || n > MAX_STATES || dj < 1 || t_steps < 1 || (stages != 1 && stages != 2))
    return true;
  const size_t want = layout(kind, n, dj, t_steps, stages, bp_in_smem).total;
  return smem != want || smem > SMEM_LIMIT;
}

}  // namespace

extern "C" {

// Dynamic shared memory of a decode (kind 0 Viterbi, 1 greedy / streamed
// greedy) at this shape and plan; the wrapper's plan must give the same.
size_t snk_decode_smem(int kind, int n, int dj, int t_steps, int stages, int bp_in_smem) {
  return layout(kind, n, dj, t_steps, stages, bp_in_smem).total;
}

// Viterbi over B lattices: tc (B, T, N), jl / jr (B, T, N, dj) f32
// contiguous; length (B,) int64 or null (all live); paths (B, T) int64 and
// totals (B,) f32 out; bp_scratch (B, T - 1, N) bytes when !bp_in_smem.
// Returns a cudaError_t (cudaErrorInvalidValue for a shape or plan it does
// not take).
int snk_viterbi_decode(const float* tc, const float* jl, const float* jr,
                       const int64_t* length, int64_t* paths, float* totals,
                       uint8_t* bp_scratch, int n_batch, int t_steps, int n, int dj,
                       float jcw, float eps, int squared, int stages, int bp_in_smem,
                       size_t smem, void* stream) {
  if (n_batch < 1 || bad_shape(KIND_VITERBI, n, dj, t_steps, stages, bp_in_smem, smem) ||
      (!bp_in_smem && t_steps > 1 && bp_scratch == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (stages == 2) {
    if ((err = prepare(viterbi_kernel<2>, smem)) != cudaSuccess) return static_cast<int>(err);
    viterbi_kernel<2><<<n_batch, VIT_THREADS, smem, s>>>(tc, jl, jr, length, paths, totals,
                                                         bp_scratch, n_batch, t_steps, n, dj,
                                                         jcw, eps, squared, bp_in_smem);
  } else {
    if ((err = prepare(viterbi_kernel<1>, smem)) != cudaSuccess) return static_cast<int>(err);
    viterbi_kernel<1><<<n_batch, VIT_THREADS, smem, s>>>(tc, jl, jr, length, paths, totals,
                                                         bp_scratch, n_batch, t_steps, n, dj,
                                                         jcw, eps, squared, bp_in_smem);
  }
  return static_cast<int>(cudaGetLastError());
}

// Greedy over B lattices (shapes as for snk_viterbi_decode).
int snk_greedy_decode(const float* tc, const float* jl, const float* jr, const int64_t* length,
                      int64_t* paths, float* totals, int n_batch, int t_steps, int n, int dj,
                      float jcw, int squared, int stages, size_t smem, void* stream) {
  if (n_batch < 1 || bad_shape(KIND_GREEDY, n, dj, t_steps, stages, 0, smem))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (stages == 2) {
    if ((err = prepare(greedy_kernel<false, 2>, smem)) != cudaSuccess)
      return static_cast<int>(err);
    greedy_kernel<false, 2><<<n_batch, GREEDY_THREADS, smem, s>>>(
        tc, jl, jr, length, nullptr, paths, totals, nullptr, t_steps, n, dj, 0.0f, jcw,
        squared, 0);
  } else {
    if ((err = prepare(greedy_kernel<false, 1>, smem)) != cudaSuccess)
      return static_cast<int>(err);
    greedy_kernel<false, 1><<<n_batch, GREEDY_THREADS, smem, s>>>(
        tc, jl, jr, length, nullptr, paths, totals, nullptr, t_steps, n, dj, 0.0f, jcw,
        squared, 0);
  }
  return static_cast<int>(cudaGetLastError());
}

// Greedy over one streaming chunk: tc (T, N), jl / jr (T, N, dj), init_ctx
// (dj,); path (T,) int64 and ctx_out (dj,) f32 out; 0 <= n_live <= T.
int snk_greedy_decode_stream(const float* tc, const float* jl, const float* jr,
                             const float* init_ctx, int64_t* path, float* ctx_out,
                             int t_steps, int n, int dj, float jcw_first, float jcw_rest,
                             int n_live, int squared, int stages, size_t smem, void* stream) {
  if (n_live < 0 || n_live > t_steps || bad_shape(KIND_GREEDY, n, dj, t_steps, stages, 0, smem))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (stages == 2) {
    if ((err = prepare(greedy_kernel<true, 2>, smem)) != cudaSuccess)
      return static_cast<int>(err);
    greedy_kernel<true, 2><<<1, GREEDY_THREADS, smem, s>>>(
        tc, jl, jr, nullptr, init_ctx, path, nullptr, ctx_out, t_steps, n, dj, jcw_first,
        jcw_rest, squared, n_live);
  } else {
    if ((err = prepare(greedy_kernel<true, 1>, smem)) != cudaSuccess)
      return static_cast<int>(err);
    greedy_kernel<true, 1><<<1, GREEDY_THREADS, smem, s>>>(
        tc, jl, jr, nullptr, init_ctx, path, nullptr, ctx_out, t_steps, n, dj, jcw_first,
        jcw_rest, squared, n_live);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

// Decodes of the candidate lattice, hand-written CUDA C++ for Hopper
// (sm_90a): the Viterbi search with its backtrack, greedy selection, and
// greedy selection over one streaming chunk.  One thread-block cluster of C
// CTAs an utterance (a chunk for the streamed form): producer warps in the
// CTAs of the cluster compute the join-cost tables of the lattice steps ahead
// of the recursion and hand them through distributed shared memory to the
// recursion warps of the cluster's first CTA, which walk the steps in order.
// Nothing goes back to the host between the first step and the path.
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
// a join distance is summed here in one fixed order, where torch.sum picks
// its own: one thread sums it, ascending columns, one fmaf a column (the
// first design's Viterbi order; its greedy forms summed lane-strided partial
// sums over a warp, so greedy now rounds some distances differently from
// it, as from torch.sum).  The order does not depend on the cluster size,
// the producer groups or the ring depth.  A natural
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
// path[t] = 0 for t >= L.  The recursion reads every length to find n_run
// on the device.  Greedy: choice_0 = first argmin tc[0], then
// choice_t = first argmin(tc[t] + jcw * dist(join_left[t], ctx)),
// ctx = join_right[t-1, choice_{t-1}], the total summed in step order;
// dead steps choose 0 and add nothing.  The streamed form starts from an
// incoming context weighted by jcw_first, runs its n_live (a host int)
// steps at jcw_rest after the first, and writes the outgoing context.
//
// What bounds it.  At config 3 (B = 32 utterances, T = 2,048 steps,
// N = 30 candidates, dj = 151) the Viterbi reads B T N (2 dj + 1) 4 bytes =
// 2.38 GB (0.71 ms at 3.35 TB/s) and does B T N^2 dj 3 = 26.7 GFLOP of FP32
// work (0.40 ms at 67 TFLOP/s): bytes bound it on paper.  The first design
// (one CTA an utterance) ran at 18x that, held by a chain of dependent
// steps: each step computed its N x N distances, then took the minima, with
// two block barriers between, on B of the 132 SMs.  But the distances D_t
// do not depend on the recursion; only min_i(pruned(cost)[i] + jcw D_t[i, j])
// does.  So the design splits them:
//   - Tables ahead.  Each step's weighted table W_t = jcw * D_t (f32,
//     rounded as the recursion would round it; rows padded to a multiple
//     of 32, +inf past N in the Viterbi) and its target costs are made
//     ahead of the recursion by producer groups of two warps (1 to 4 a CTA,
//     as many as shared memory holds), in every CTA of the utterance's
//     cluster of up to 4, in all but the first of a larger one (a small
//     batch, whose recursion then has its SM to itself).  Group g of the
//     k-th producing CTA takes the tables u = k + P g, k + P g + P G, ...
//     (table u is step u + 1; in the streamed form step u, whose step 0
//     joins from the incoming context: a table of one row).  A group stages
//     a table's two context slabs as they lie in device memory, one
//     cp.async.bulk each from the 16-byte boundary at or before the slab
//     (dj 151 leaves slabs 4-byte aligned) plus a cp.async tail of at most
//     3 floats, while the other groups compute; it makes the table in its
//     out slot and hands it to ring slot u % R of the first CTA with one
//     cp.async.bulk shared::cta -> shared::cluster, which completes the
//     slot's full mbarrier there (the recursion arms it with the slot's
//     bytes one step ahead).  Before it overwrites a slot, the group's
//     leader polls the recursion's count of consumed tables in the first
//     CTA's shared memory (a plain store there, a remote load here): the
//     recursion issues no remote operation at all, which kept its loads
//     waiting behind it.  A distance is one thread's: 8 x 8 threads over
//     each 32 x 32 block, a 4 x 4 register tile each, scalar loads (8 a
//     column for 16 distances; a warp's fall on consecutive rows, distinct
//     banks for odd dj).  Greedy needs only row choice_{t-1} of each table;
//     it computes the whole table, so that no table waits on the recursion.
//   - The recursion in one warp (ceil(N / 32) warps where N > 32, which
//     meet on a named barrier of their own; no block barrier in the loop).
//     Lane j holds state j's cost.  A step publishes the costs to shared
//     memory, finds the pruning threshold from them, waits for its table,
//     and scans i in blocks of 32 rows, all loads of a block issued together
//     and nothing branching: __fadd_rn(pruned_i, W_t[i][j]), the first
//     minimum kept with a strict < in four interleaved chains that meet with
//     ties to the lower index (the same first minimum); then it adds
//     tc[t, j] and writes a one-byte backpointer.  Greedy: lane j forms
//     tc[t, j] + W_t[c][j] from the row of the previous choice c, then a warp
//     first-minimum by two redux.sync (value key, then lowest index).
// What bounds it now (NVIDIA H100 80GB HBM3, 700 W, clock64 counters in a
// copy of this file, python -m snickery_tpu_torch.decode_profile; PERF.md
// section 6).  Config 3's Viterbi: a group
// makes a table in ~15,200 cycles (three groups a CTA, two instructions a
// distance-column beside the loads) and a recursion step takes ~2,560, 710
// of them waiting for its table: the recursion, slowed by its CTA's own
// producers, and the tables about balance.  One utterance (clusters of 8,
// the first CTA's SM the recursion's alone): ~1,010 cycles a step, 270 of
// them waiting: the recursion.  Greedy (four groups a CTA): ~16,600 cycles
// a table a group, a step ~1,810 cycles, 640 of them waiting.  The CTAs of
// a cluster are co-scheduled, which is what lets the recursion wait on
// other CTAs inside one launch.  C is a pure function of B and the SM count
// (ops/viterbi.py::cluster_size: enough clusters to fill the card, at most
// 8), lowered on the card until cudaOccupancyMaxActiveClusters holds all B
// clusters at once (3 at B = 32: the card holds 30 clusters of 4 at this
// shared memory), and the wrapper refuses a size the card cannot place.
// The backpointers (one byte a state: N <= 255) stay in the first CTA's
// shared memory when (T - 1) N bytes fit beside the buffers and the ring
// (61 KB at config 3), else in a global scratch the wrapper allocates; the
// recursion backtracks from them after its last step and writes the path
// and total.  No CTA waits at the end: only the first CTA's shared memory
// is reached from another CTA, and it finishes only after the last table's
// copy has landed.
//
// The shared-memory plan (layout) is a pure function of the kind, N, dj, T,
// the group count, the ring depth and where the backpointers live; the
// Python wrapper computes the same plan (ops/viterbi.py::decode_plan) and
// passes its byte count, which each launcher checks against its own.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int PRODUCER_WARPS = 8;
constexpr int PRODUCER_THREADS = PRODUCER_WARPS * 32;
constexpr int GROUP_THREADS = 64;       // a producer group: two warps, one table at a time
constexpr int MAX_GROUPS = PRODUCER_THREADS / GROUP_THREADS;
constexpr int MAX_STATES = 255;         // a backpointer is one byte
constexpr int MAX_CLUSTER = 8;          // the portable cluster size
constexpr int MAX_RING = 16;
constexpr size_t SMEM_LIMIT = 227 * 1024;
constexpr float BIG_PENALTY = 1.0e10f;  // snickery_tpu_torch/const.py
constexpr int KIND_VITERBI = 0;
constexpr int KIND_GREEDY = 1;
constexpr int BAR_GROUP = 1;            // named barriers: 1 + g a producer group's
constexpr int BAR_RECURSION = 1 + MAX_GROUPS;   // (0 is __syncthreads')

__host__ __device__ inline size_t align16(size_t x) { return (x + 15) / 16 * 16; }

// Warps of the recursion: a lane a state in the Viterbi, one warp in greedy.
__host__ __device__ inline int recursion_warps(int kind, int n) {
  return kind == KIND_VITERBI ? (n + 31) / 32 : 1;
}

// Rows of a ring slot's table: N rounded up to a multiple of 32, the rows
// past N +inf in the Viterbi, so that the recursion scans whole blocks of
// 32 rows without a test.
__host__ __device__ inline int padded_rows(int n) { return (n + 31) / 32 * 32; }

// Bytes of a staged (N, dj) slab: its floats as they lie in device memory,
// copied from the 16-byte boundary at or before its first (up to 3 floats
// earlier).
__host__ __device__ inline size_t span_bytes(int n, int dj) {
  return align16((static_cast<size_t>(n) * dj + 3) * 4);
}

// Byte offsets into the dynamic shared memory of one CTA (every CTA of the
// cluster has the same layout; only the first uses the ring, the recursion's
// area and the backpointers).
struct Layout {
  size_t bars;    // mbarriers: full[R] (the first CTA's), staged[G] (a group's)
  size_t left;    // G x span: join_left of a group's table's step
  size_t right;   // G x span: join_right of the step before
  size_t tcs;     // G x N f32: the table's target costs
  size_t ring;    // R slots: the (N32, N) f32 weighted table, then N f32 target costs
  size_t out;     // G slots: a group's table as it is made, before its copy
  size_t aux;     // Viterbi: 2 x (32 NW) f32 costs; then 16 bytes: the tables consumed
  size_t bp;      // Viterbi with bp_in_smem: (T - 1, N) bytes of backpointers
  size_t total;
  size_t span;    // bytes of one staged slab
  size_t slot;    // bytes of one ring slot: rows padded to a multiple of 32
  size_t tc_off;  // floats from a slot's start to its target costs
  size_t aux_count;  // bytes from aux to the count of consumed tables
};

__host__ __device__ inline Layout layout(int kind, int n, int dj, int t_steps, int groups,
                                         int ring, int bp_in_smem) {
  Layout l;
  l.span = span_bytes(n, dj);
  l.tc_off = align16(static_cast<size_t>(padded_rows(n)) * n * 4) / 4;
  l.slot = l.tc_off * 4 + align16(static_cast<size_t>(n) * 4);
  size_t off = 0;
  l.bars = off;
  off += align16(static_cast<size_t>(ring + groups) * 8);
  l.left = off;
  off += groups * l.span;
  l.right = off;
  off += groups * l.span;
  l.tcs = off;
  off += groups * align16(static_cast<size_t>(n) * 4);
  l.ring = off;
  off += ring * l.slot;
  l.out = off;
  off += groups * l.slot;
  l.aux = off;
  l.aux_count = kind == KIND_VITERBI ? 2 * align16(static_cast<size_t>(32) * recursion_warps(kind, n) * 4) : 0;
  off += l.aux_count + 16;
  l.bp = off;
  if (kind == KIND_VITERBI && bp_in_smem && t_steps > 1)
    off += align16(static_cast<size_t>(t_steps - 1) * n);
  l.total = off;
  return l;
}

// ------------------------------------------------------------ primitives
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ unsigned cluster_size() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(r));
  return r;
}

// Every thread of every CTA of the cluster (not .aligned: the warps reach
// it from different roles).
__device__ __forceinline__ void cluster_sync_all() {
  asm volatile("barrier.cluster.arrive.release;\nbarrier.cluster.wait.acquire;\n" ::: "memory");
}

// The shared::cluster address of `p` (in this CTA's shared memory) in CTA
// `rank`'s shared memory.
__device__ __forceinline__ uint32_t cluster_addr(const void* p, unsigned rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(out) : "r"(smem_u32(p)), "r"(rank));
  return out;
}

// Generic-proxy writes to this CTA's shared memory made visible to the
// async proxy that cp.async.bulk reads through.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// A bulk copy of `bytes` (a multiple of 16, both ends 16-byte aligned) from
// device memory into this CTA's shared memory, completing that many bytes
// of the transaction count of the mbarrier at `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// A bulk copy of `bytes` (a multiple of 16, both ends 16-byte aligned) from
// this CTA's shared memory into another CTA's, completing that many bytes
// of the transaction count of the mbarrier at `bar` there: a table's hand-off
// is one instruction and needs no fence.
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];\n" ::"r"(dst),
      "r"(smem_u32(src)), "r"(bytes), "r"(bar)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's bulk copies still read their source.
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// One arrival on this CTA's barrier, announcing `bytes` that bulk copies
// complete in this phase.
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// The recursion's count of consumed tables, published in the first CTA's
// shared memory by a plain store: a table's loads have all returned before
// the store issues (its values decided the step), so a producer that reads
// the count may overwrite those slots.
__device__ __forceinline__ void publish(int* count, int value) {
  asm volatile("st.volatile.shared.s32 [%0], %1;\n" ::"r"(smem_u32(count)), "r"(value) : "memory");
}

// Wait until the count at `addr` (a shared::cluster address in the first
// CTA) reaches `want`.  2^26 reads mean a lost consumer: trap.
__device__ __forceinline__ void wait_count(uint32_t addr, int want) {
  for (uint32_t n = 0;; ++n) {
    int have;
    asm volatile("ld.volatile.shared::cluster.s32 %0, [%1];\n" : "=r"(have) : "r"(addr) : "memory");
    if (have >= want) return;
    if (n >= 0x4000000u) __trap();
  }
}

// Wait until this CTA's barrier has completed the phase of this parity.
// 2^26 failed tries (seconds) mean a lost arrival: trap, so that the launch
// fails instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n.reg .pred p, q;\n.reg .u32 n;\nmov.u32 n, 0;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra DONE;\n"
      "add.u32 n, n, 1;\n"
      "setp.lt.u32 q, n, 0x4000000;\n"
      "@q bra WAIT;\n"
      "trap;\n"
      "DONE:\n}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// The first minimum of a warp's (value, index) pairs, every lane getting
// it, by two warp reductions: the least value as an order-preserving key
// (-0.0 counted as +0.0, as a float compare counts it), then the lowest
// index holding it; the value is the winning lane's own.
__device__ __forceinline__ void warp_argmin(float& v, int& a) {
  uint32_t k = __float_as_uint(v + 0.0f);
  k = (k & 0x80000000u) ? ~k : (k | 0x80000000u);
  const uint32_t best = __reduce_min_sync(0xffffffffu, k);
  const int win = static_cast<int>(
      __reduce_min_sync(0xffffffffu, k == best ? static_cast<uint32_t>(a) : 0xffffffffu));
  v = __shfl_sync(0xffffffffu, v, win & 31);
  a = win;
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

// -------------------------------------------------------------- producers
// Where a table comes from: table u is step t = u + first_step, its right
// rows join_right[t - 1] (N rows) or, at t = 0 of the streamed form, the
// incoming context (one row); its left rows join_left[t]; its weight jcw, or
// jcw_first at t = 0.
struct Lattice {
  const float* tc;   // (T, N) of this utterance or chunk
  const float* jl;   // (T, N, dj)
  const float* jr;
  const float* init_ctx;
  int n, dj, first_step, squared;
  float jcw_first, jcw;
};

__device__ __forceinline__ const float* left_src(const Lattice& lat, int t) {
  return lat.jl + static_cast<size_t>(t) * lat.n * lat.dj;
}

__device__ __forceinline__ const float* right_src(const Lattice& lat, int t) {
  return t == 0 ? lat.init_ctx : lat.jr + static_cast<size_t>(t - 1) * lat.n * lat.dj;
}

// Floats between the 16-byte boundary at or before `p` and `p`.
__device__ __forceinline__ int head(const float* p) {
  return static_cast<int>((reinterpret_cast<uintptr_t>(p) & 15) / 4);
}

// Bytes of the 16-byte-aligned body of count floats at `p`.
__device__ __forceinline__ uint32_t body_bytes(const float* p, int count) {
  const uintptr_t s = reinterpret_cast<uintptr_t>(p), e = s + 4 * static_cast<uintptr_t>(count);
  const uintptr_t a = s & ~static_cast<uintptr_t>(15), e16 = e & ~static_cast<uintptr_t>(15);
  return e16 > a ? static_cast<uint32_t>(e16 - a) : 0u;
}

// Stage count floats at `p` into `dst` (float head(p) of dst holds p[0]):
// thread 0 copies the 16-byte-aligned body in one bulk copy on `bar`, the
// threads the tail of at most 3 floats by cp.async.  Reading from the
// boundary at or before p stays inside p's allocation, which starts on one.
__device__ __forceinline__ void stage_span(float* dst, const float* p, int count, uint64_t* bar,
                                           int gt) {
  const uintptr_t s = reinterpret_cast<uintptr_t>(p), e = s + 4 * static_cast<uintptr_t>(count);
  const uintptr_t a = s & ~static_cast<uintptr_t>(15), e16 = e & ~static_cast<uintptr_t>(15);
  if (gt == 0 && e16 > a)
    bulk_load(dst, reinterpret_cast<const void*>(a), static_cast<uint32_t>(e16 - a), bar);
  const uintptr_t from = e16 > s ? e16 : s;
  if (gt < static_cast<int>((e - from) / 4))
    cp_async4(dst + (from - a) / 4 + gt, reinterpret_cast<const float*>(from) + gt);
}

// Stage table u for a producer group: both context slabs (bulk copies on
// `bar`, whose arrival the group's thread 0 makes with their bytes) and the
// step's target costs (cp.async).
__device__ __forceinline__ void stage_table(const Lattice& lat, int u, float* left, float* right,
                                            float* tcs, uint64_t* bar, int gt) {
  const int t = u + lat.first_step;
  const float* l = left_src(lat, t);
  const float* r = right_src(lat, t);
  const int nl = lat.n * lat.dj, nr = t == 0 ? lat.dj : nl;
  if (gt == 0) mbar_expect(bar, body_bytes(l, nl) + body_bytes(r, nr));
  stage_span(left, l, nl, bar, gt);
  stage_span(right, r, nr, bar, gt);
  const float* tct = lat.tc + static_cast<size_t>(t) * lat.n;
  for (int j = gt; j < lat.n; j += GROUP_THREADS) cp_async4(tcs + j, tct + j);
}

// One weighted table, a thread a distance, by one producer group: 8 x 8 threads over each 32 x 32 block of the table, a
// thread's tile rows ib + it + 8k and columns jb + jt + 8q (k, q < 4), each
// of its 16 distances summed column by column in ascending order; a warp's
// loads of a column fall on 4 consecutive right rows and 8 consecutive left
// rows (distinct banks where dj is odd).  The rows past N of a padded block
// are +inf.
__device__ __forceinline__ void table_by_threads(const float* R, const float* Lf, float* dst,
                                                 int n, int n_right, int dj, int squared,
                                                 float w, int gt) {
  const int it = gt >> 3, jt = gt & 7;
  const int bi = (n_right + 31) / 32, bj = (n + 31) / 32;
  for (int blk = 0; blk < bi * bj; ++blk) {
    const int ib = blk / bj * 32, jb = (blk - blk / bj * bj) * 32;
    const float* r[4];
    const float* l[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int i = ib + it + 8 * k, j = jb + jt + 8 * k;
      r[k] = R + (i < n_right ? i : n_right - 1) * dj;
      l[k] = Lf + (j < n ? j : n - 1) * dj;
    }
    float a[4][4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
      for (int q = 0; q < 4; ++q) a[k][q] = 0.0f;
    auto column = [&](int c) {
      float x[4], y[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        x[k] = r[k][c];
        y[k] = l[k][c];
      }
#pragma unroll
      for (int k = 0; k < 4; ++k)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float d = x[k] - y[q];
          a[k][q] = fmaf(d, d, a[k][q]);
        }
    };
    int c0 = 0;
    for (; c0 + 4 <= dj; c0 += 4) {         // four columns from row pointers that walk
#pragma unroll
      for (int c = 0; c < 4; ++c) column(c);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        r[k] += 4;
        l[k] += 4;
      }
    }
    for (int c = 0; c < dj - c0; ++c) column(c);
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int i = ib + it + 8 * k, j = jb + jt + 8 * q;
        if (i < n_right && j < n) dst[i * n + j] = __fmul_rn(w, squared ? a[k][q] : sqrtf(a[k][q]));
      }
  }
  for (int e = n_right * n + gt; e < padded_rows(n_right) * n; e += GROUP_THREADS)
    dst[e] = __int_as_float(0x7f800000);
}

// The CTAs that make tables: every CTA of a cluster of up to 4 (where the
// tables are what bounds a batch), every CTA but the first in a larger one
// (a small batch, whose recursion then has its SM to itself).
constexpr unsigned SHARED_FIRST_CTA = 4;
__device__ __forceinline__ int producers(unsigned C) {
  return C > SHARED_FIRST_CTA ? static_cast<int>(C) - 1 : static_cast<int>(C);
}
__device__ __forceinline__ int first_producer(unsigned C) { return C > SHARED_FIRST_CTA ? 1 : 0; }

// The producer warps of one CTA, in `groups` groups of two warps: group g
// of the k-th producing CTA makes tables u = k + P g, k + P g + P G, ...
// < n_tables (P = producers(C), G = groups), one at a time: staged into the
// group's buffer (bulk copies, while the other groups compute), made into
// the group's out slot, and copied (one cp.async.bulk, once the
// recursion's count of consumed tables shows the ring slot's previous
// table read) into ring slot u % R of the first CTA, completing the slot's
// full barrier there.
__device__ void produce(const Lattice& lat, const Layout& L, unsigned char* smem, unsigned rank,
                        unsigned C, int ring, int groups, int n_tables, int ptid) {
  const int k = static_cast<int>(rank) - first_producer(C), g = ptid / GROUP_THREADS;
  if (k < 0 || g >= groups) return;
  const int gt = ptid - g * GROUP_THREADS, n = lat.n;
  const int fspan = static_cast<int>(L.span / 4), fslot = static_cast<int>(L.slot / 4);
  const int ftc = static_cast<int>(align16(static_cast<size_t>(n) * 4) / 4);
  float* left = reinterpret_cast<float*>(smem + L.left) + g * fspan;
  float* right = reinterpret_cast<float*>(smem + L.right) + g * fspan;
  float* tcs = reinterpret_cast<float*>(smem + L.tcs) + g * ftc;
  float* out = reinterpret_cast<float*>(smem + L.out) + g * fslot;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L.bars);
  uint64_t* staged = full + ring + g;
  const uint32_t ring0 = cluster_addr(smem + L.ring, 0), full0 = cluster_addr(full, 0);
  const uint32_t consumed0 = cluster_addr(smem + L.aux + L.aux_count, 0);
  const int step = producers(C) * groups, first = k + producers(C) * g;
  if (first < n_tables) stage_table(lat, first, left, right, tcs, staged, gt);
  cp_async_commit();
  int idx = 0;
  for (int u = first; u < n_tables; u += step, ++idx) {
    if (gt == 0) bulk_wait_read<0>();    // the out slot's last copy has read it
    mbar_wait(staged, idx & 1);
    cp_async_wait_all();
    named_sync(BAR_GROUP + g, GROUP_THREADS);    // table u staged; the out slot free
    const int t = u + lat.first_step;
    const float w = t == 0 ? lat.jcw_first : lat.jcw;
    const int n_right = t == 0 ? 1 : n;
    const float* R = right + head(right_src(lat, t));
    const float* Lf = left + head(left_src(lat, t));
    table_by_threads(R, Lf, out, n, n_right, lat.dj, lat.squared, w, gt);
    for (int j = gt; j < n; j += GROUP_THREADS) out[L.tc_off + j] = tcs[j];
    fence_proxy_async();
    named_sync(BAR_GROUP + g, GROUP_THREADS);    // table u is in the out slot; buffers free
    if (gt == 0) {
      const int s = u % ring;
      if (u >= ring) wait_count(consumed0, u - ring + 1);   // slot s's last table was read
      bulk_copy(ring0 + static_cast<uint32_t>(s * L.slot), out, static_cast<uint32_t>(L.slot),
                full0 + 8 * s);
    }
    if (u + step < n_tables) stage_table(lat, u + step, left, right, tcs, staged, gt);
    cp_async_commit();
  }
  if (gt == 0) bulk_wait_read<0>();
}

// Set up a CTA: the barriers (full: the consumer's one arrival with a slot's
// bytes, which the producer's bulk copy completes; staged: a group's thread
// 0's arrival with the bulk bytes of its staged table) and the count of consumed
// tables, then meet the cluster, so no CTA touches another's shared memory
// before it is ready.
__device__ __forceinline__ void setup(const Layout& L, unsigned char* smem, int ring, int groups,
                                      int tid) {
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L.bars);
  if (tid == 0) {
    for (int s = 0; s < ring + groups; ++s) mbar_init(bars + s, 1);
    *reinterpret_cast<int*>(smem + L.aux + L.aux_count) = 0;
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster_sync_all();
}

// The Viterbi recursion's scan of one block of 32 rows i0 + k of the table
// (column j of each, a stride of n apart; rows past N are +inf and never
// win): x_i = pruned(cost_i) + W[i][j], the first minimum kept in four
// chains (i mod 4), each in ascending i with a strict <.  The loads of the
// block are issued together and nothing branches.
template <bool FIRST>
__device__ __forceinline__ void scan_block(const float* W, const float* sc, int i0, int n,
                                           float thr, float (&bv)[4], int (&ba)[4]) {
  float wv[32], cv[32];
#pragma unroll
  for (int k = 0; k < 32; ++k) wv[k] = W[(i0 + k) * n];
#pragma unroll
  for (int k4 = 0; k4 < 8; ++k4) {
    const float4 c4 = reinterpret_cast<const float4*>(sc + i0)[k4];
    cv[4 * k4] = c4.x;
    cv[4 * k4 + 1] = c4.y;
    cv[4 * k4 + 2] = c4.z;
    cv[4 * k4 + 3] = c4.w;
  }
#pragma unroll
  for (int k = 0; k < 32; ++k) {
    const float x = __fadd_rn(cv[k] > thr ? BIG_PENALTY : cv[k], wv[k]);
    if (FIRST && k < 4) {
      bv[k] = x;
      ba[k] = k;
    } else if (x < bv[k & 3]) {
      bv[k & 3] = x;
      ba[k & 3] = i0 + k;
    }
  }
}

// --------------------------------------------------------------- Viterbi
__global__ void __launch_bounds__(PRODUCER_THREADS + 32 * 8, 1)
    viterbi_kernel(const float* __restrict__ tc, const float* __restrict__ jl,
                   const float* __restrict__ jr, const int64_t* __restrict__ length,
                   int64_t* __restrict__ paths, float* __restrict__ totals,
                   uint8_t* __restrict__ bp_global, int n_batch, int t_steps, int n, int dj,
                   float jcw, float eps, int squared, int groups, int ring, int bp_in_smem) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L = layout(KIND_VITERBI, n, dj, t_steps, groups, ring, bp_in_smem);
  const unsigned C = cluster_size(), rank = cluster_rank();
  const int b = blockIdx.x / C, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nw = recursion_warps(KIND_VITERBI, n);
  const size_t slab = static_cast<size_t>(n) * dj;
  const float* tcb = tc + static_cast<size_t>(b) * t_steps * n;

  int len_b = t_steps;
  if (length != nullptr) {
    const int64_t lb = length[b];
    len_b = lb < 0 ? 0 : (lb < t_steps ? static_cast<int>(lb) : t_steps);
  }
  const int live = len_b > 1 ? len_b : 1;
  const int n_tables = live - 1;
  setup(L, smem, ring, groups, tid);

  if (warp < PRODUCER_WARPS) {
    const Lattice lat{tcb, jl + static_cast<size_t>(b) * t_steps * slab,
                      jr + static_cast<size_t>(b) * t_steps * slab, nullptr, n, dj, 1, squared,
                      jcw, jcw};
    produce(lat, L, smem, rank, C, ring, groups, n_tables, tid);
  } else if (rank == 0) {
    // the recursion: lane j of recursion warp rw holds state 32 rw + lane
    const int rtid = tid - PRODUCER_THREADS, j = rtid, nr = 32 * nw;
    const bool valid = j < n;
    int n_run = t_steps;
    if (length != nullptr) {
      int64_t most = length[0];
      for (int i = 1; i < n_batch; ++i) most = most > length[i] ? most : length[i];
      most = most < t_steps ? most : t_steps;
      n_run = most > 1 ? static_cast<int>(most) : 1;
    }
    uint64_t* full = reinterpret_cast<uint64_t*>(smem + L.bars);
    int* consumed = reinterpret_cast<int*>(smem + L.aux + L.aux_count);
    const float* ringp = reinterpret_cast<const float*>(smem + L.ring);
    const int fslot = static_cast<int>(L.slot / 4);
    float* scost = reinterpret_cast<float*>(smem + L.aux);   // 2 x nr: by step parity
    uint8_t* bp = bp_in_smem ? smem + L.bp
                             : bp_global + static_cast<size_t>(b) * (t_steps - 1) * n;
    auto rsync = [&]() {
      if (nw > 1)
        named_sync(BAR_RECURSION, nr);
      else
        __syncwarp();
    };
    const uint32_t slot_bytes = static_cast<uint32_t>(L.slot);
    if (rtid == 0 && n_tables > 0) mbar_expect(full, slot_bytes);
    int s = 0, lap = 0;
    float cost = valid ? (len_b == 0 ? 0.0f : tcb[j]) : 0.0f;
    for (int t = 1; t < live; ++t) {
      const int u = t - 1;
      float* sc = scost + (t & 1) * nr;
      sc[j] = valid ? cost : 0.0f;
      rsync();                           // cost_{t-1} visible; table u - 1 read by all
      if (rtid == 0 && u >= 1) publish(consumed, u);   // tables 0 .. u - 1 read by all
      float thr = __int_as_float(0x7f800000);
      if (eps > 0.0f) {
        float m0 = thr, m1 = thr, m2 = thr, m3 = thr;
        int i = 0;
        for (; i + 4 <= n; i += 4) {
          const float4 c4 = *reinterpret_cast<const float4*>(sc + i);
          m0 = fminf(m0, c4.x); m1 = fminf(m1, c4.y); m2 = fminf(m2, c4.z); m3 = fminf(m3, c4.w);
        }
        for (; i < n; ++i) m0 = fminf(m0, sc[i]);
        thr = __fadd_rn(fminf(fminf(m0, m1), fminf(m2, m3)), eps);
      }
      mbar_wait(full + s, lap);
      if (valid) {
        const float* W = ringp + s * fslot;
        float bv[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        int ba[4] = {-1, -1, -1, -1};
        scan_block<true>(W + j, sc, 0, n, thr, bv, ba);
        for (int i0 = 32; i0 < n; i0 += 32) scan_block<false>(W + j, sc, i0, n, thr, bv, ba);
        float v = bv[0];
        int a = ba[0];
#pragma unroll
        for (int k = 1; k < 4; ++k)
          if (bv[k] < v || (bv[k] == v && ba[k] < a)) {
            v = bv[k];
            a = ba[k];
          }
        cost = __fadd_rn(v, W[L.tc_off + j]);
        bp[static_cast<size_t>(u) * n + j] = static_cast<uint8_t>(a);
      }
      if (++s == ring) {
        s = 0;
        lap ^= 1;
      }
      if (rtid == 0 && u + 1 < n_tables) mbar_expect(full + s, slot_bytes);
    }
    float* sc = scost + (live & 1) * nr;
    if (valid) sc[j] = cost;
    rsync();                             // the last costs and backpointers are in
    if (rtid < 32) {
      // the final state: of pruned(cost) where the plain loop runs dead steps
      // past this utterance, of cost where it ends with it
      float* fin = scost + ((live & 1) ^ 1) * nr;
      const bool dead_after = live < n_run && eps > 0.0f;
      float best = 0.0f;
      if (dead_after) {
        float m = __int_as_float(0x7f800000);
        for (int i = lane; i < n; i += 32) m = fminf(m, sc[i]);
        best = warp_min(m);
      }
      for (int i = lane; i < n; i += 32) {
        const float c = sc[i];
        fin[i] = (dead_after && c > __fadd_rn(best, eps)) ? BIG_PENALTY : c;
      }
      __syncwarp();
      float v;
      int a;
      warp_first_min(fin, n, lane, v, a);
      if (lane == 0) {
        totals[b] = v;
        int64_t* path = paths + static_cast<size_t>(b) * t_steps;
        int st = a;
        path[live - 1] = st;
        for (int t = live - 1; t >= 1; --t) {
          st = bp[static_cast<size_t>(t - 1) * n + st];
          path[t - 1] = st;
        }
      }
    }
    for (int t = live + rtid; t < t_steps; t += nr) paths[static_cast<size_t>(b) * t_steps + t] = 0;
  }
  // No closing cluster barrier: only the first CTA's shared memory is
  // reached from another CTA, and it finishes only after the last table's
  // copy has landed; a warp with nothing left to do leaves at once.
}

// ---------------------------------------------------------------- greedy
// STREAM: one chunk (one cluster) from an incoming context, n_live steps,
// the outgoing context written; else one utterance a cluster from no
// context.
template <bool STREAM>
__global__ void __launch_bounds__(PRODUCER_THREADS + 32, 1)
    greedy_kernel(const float* __restrict__ tc, const float* __restrict__ jl,
                  const float* __restrict__ jr, const int64_t* __restrict__ length,
                  const float* __restrict__ init_ctx, int64_t* __restrict__ paths,
                  float* __restrict__ totals, float* __restrict__ ctx_out, int t_steps, int n,
                  int dj, float jcw_first, float jcw, int squared, int n_live, int groups,
                  int ring) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L = layout(KIND_GREEDY, n, dj, t_steps, groups, ring, 0);
  const unsigned C = cluster_size(), rank = cluster_rank();
  const int b = blockIdx.x / C, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t slab = static_cast<size_t>(n) * dj;
  const float* tcb = tc + static_cast<size_t>(b) * t_steps * n;
  const float* jrb = jr + static_cast<size_t>(b) * t_steps * slab;

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
  const int first_step = STREAM ? 0 : 1;
  const int n_tables = live - first_step;
  setup(L, smem, ring, groups, tid);

  if (warp < PRODUCER_WARPS) {
    const Lattice lat{tcb, jl + static_cast<size_t>(b) * t_steps * slab, jrb, init_ctx, n, dj,
                      first_step, squared, jcw_first, jcw};
    produce(lat, L, smem, rank, C, ring, groups, n_tables, tid);
  } else if (rank == 0) {
    uint64_t* full = reinterpret_cast<uint64_t*>(smem + L.bars);
    int* consumed = reinterpret_cast<int*>(smem + L.aux + L.aux_count);
    const float* ringp = reinterpret_cast<const float*>(smem + L.ring);
    const int fslot = static_cast<int>(L.slot / 4);
    const uint32_t slot_bytes = static_cast<uint32_t>(L.slot);
    int64_t* path = paths + static_cast<size_t>(b) * t_steps;
    if (lane == 0 && n_tables > 0) mbar_expect(full, slot_bytes);
    int s = 0, lap = 0;
    float acc = 0.0f;                    // lane 0's running total
    int choice = 0;
    for (int t = 0; t < live; ++t) {
      float v = __int_as_float(0x7f800000);
      int a = 0x7fffffff;
      if (!STREAM && t == 0) {
        for (int j = lane; j < n; j += 32) {
          const float y = tc_zero ? 0.0f : tcb[j];
          if (a == 0x7fffffff || y < v) {
            v = y;
            a = j;
          }
        }
      } else {
        const int u = t - first_step;
        mbar_wait(full + s, lap);
        const float* W = ringp + s * fslot;
        const float* row = W + choice * n;
        for (int j = lane; j < n; j += 32) {
          const float y = __fadd_rn(W[L.tc_off + j], row[j]);
          if (a == 0x7fffffff || y < v) {
            v = y;
            a = j;
          }
        }
        __syncwarp();                    // every lane has read slot s
        if (lane == 0) publish(consumed, u + 1);
        if (++s == ring) {
          s = 0;
          lap ^= 1;
        }
        if (lane == 0 && u + 1 < n_tables) mbar_expect(full + s, slot_bytes);
      }
      warp_argmin(v, a);
      choice = a;
      if (lane == 0) {
        path[t] = a;
        acc = t == 0 ? v : __fadd_rn(acc, v);
      }
    }
    for (int t = live + lane; t < t_steps; t += 32) path[t] = 0;
    if (STREAM) {
      const float* src = live == 0 ? init_ctx : jrb + (live - 1) * slab + static_cast<size_t>(choice) * dj;
      for (int c = lane; c < dj; c += 32) ctx_out[c] = src[c];
    } else if (lane == 0) {
      totals[b] = acc;
    }
  }
}

// ------------------------------------------------------------- launching
bool bad_shape(int kind, int n, int dj, int t_steps, int groups, int ring, int cluster,
               int bp_in_smem, size_t smem) {
  if (n < 1 || n > MAX_STATES || dj < 1 || t_steps < 1 || groups < 1 || groups > MAX_GROUPS ||
      ring < 1 || ring > MAX_RING || cluster < 1 || cluster > MAX_CLUSTER)
    return true;
  const size_t want = layout(kind, n, dj, t_steps, groups, ring, bp_in_smem).total;
  return smem != want || smem > SMEM_LIMIT;
}

// One cluster launch of `grid` CTAs in clusters of `cluster`: the shared
// memory attribute set, the launch made (the wrapper's plan has asked
// snk_decode_max_clusters that the card can place the cluster).
template <typename K, typename... Args>
int launch(K kernel, int grid, int threads, int cluster, size_t smem, void* stream,
           Args... args) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(grid, 1, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if ((err = cudaLaunchKernelEx(&cfg, kernel, args...)) != cudaSuccess)
    return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Dynamic shared memory of a decode CTA (kind 0 Viterbi, 1 greedy / streamed
// greedy) at this shape and plan; the wrapper's plan must give the same.
size_t snk_decode_smem(int kind, int n, int dj, int t_steps, int groups, int ring,
                       int bp_in_smem) {
  return layout(kind, n, dj, t_steps, groups, ring, bp_in_smem).total;
}

// Clusters of `cluster` CTAs of a decode kernel (kind 0 Viterbi, 1 greedy,
// 2 streamed greedy) at N = n and this dynamic shared memory that the card
// holds at once (cudaOccupancyMaxActiveClusters); negative: a cudaError_t.
int snk_decode_max_clusters(int kind, int n, int cluster, size_t smem) {
  const int threads = PRODUCER_THREADS + 32 * recursion_warps(kind == 0 ? KIND_VITERBI : KIND_GREEDY, n);
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(cluster, 1, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  cudaError_t err;
  if (kind == 0) {
    if ((err = cudaFuncSetAttribute(viterbi_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    static_cast<int>(smem))) == cudaSuccess)
      err = cudaOccupancyMaxActiveClusters(&clusters, viterbi_kernel, &cfg);
  } else if (kind == 1) {
    if ((err = cudaFuncSetAttribute(greedy_kernel<false>,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    static_cast<int>(smem))) == cudaSuccess)
      err = cudaOccupancyMaxActiveClusters(&clusters, greedy_kernel<false>, &cfg);
  } else {
    if ((err = cudaFuncSetAttribute(greedy_kernel<true>,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    static_cast<int>(smem))) == cudaSuccess)
      err = cudaOccupancyMaxActiveClusters(&clusters, greedy_kernel<true>, &cfg);
  }
  if (err != cudaSuccess) {
    cudaGetLastError();
    return -static_cast<int>(err);
  }
  return clusters;
}

// Viterbi over B lattices: tc (B, T, N), jl / jr (B, T, N, dj) f32
// contiguous; length (B,) int64 or null (all live); paths (B, T) int64 and
// totals (B,) f32 out; bp_scratch (B, T - 1, N) bytes when !bp_in_smem.
// One cluster of `cluster` CTAs an utterance, a ring of `ring` tables.
// Returns a cudaError_t (cudaErrorInvalidValue for a shape or plan it does
// not take).
int snk_viterbi_decode(const float* tc, const float* jl, const float* jr,
                       const int64_t* length, int64_t* paths, float* totals,
                       uint8_t* bp_scratch, int n_batch, int t_steps, int n, int dj,
                       float jcw, float eps, int squared, int groups, int ring, int cluster,
                       int bp_in_smem, size_t smem, void* stream) {
  if (n_batch < 1 ||
      bad_shape(KIND_VITERBI, n, dj, t_steps, groups, ring, cluster, bp_in_smem, smem) ||
      (!bp_in_smem && t_steps > 1 && bp_scratch == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int threads = PRODUCER_THREADS + 32 * recursion_warps(KIND_VITERBI, n);
  return launch(viterbi_kernel, n_batch * cluster, threads, cluster, smem, stream, tc, jl, jr,
                length, paths, totals, bp_scratch, n_batch, t_steps, n, dj, jcw, eps, squared,
                groups, ring, bp_in_smem);
}

// Greedy over B lattices (shapes as for snk_viterbi_decode).
int snk_greedy_decode(const float* tc, const float* jl, const float* jr, const int64_t* length,
                      int64_t* paths, float* totals, int n_batch, int t_steps, int n, int dj,
                      float jcw, int squared, int groups, int ring, int cluster, size_t smem,
                      void* stream) {
  if (n_batch < 1 || bad_shape(KIND_GREEDY, n, dj, t_steps, groups, ring, cluster, 0, smem))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch(greedy_kernel<false>, n_batch * cluster, PRODUCER_THREADS + 32, cluster, smem,
                stream, tc, jl, jr, length, static_cast<const float*>(nullptr), paths, totals,
                static_cast<float*>(nullptr), t_steps, n, dj, 0.0f, jcw, squared, 0, groups,
                ring);
}

// Greedy over one streaming chunk: tc (T, N), jl / jr (T, N, dj), init_ctx
// (dj,); path (T,) int64 and ctx_out (dj,) f32 out; 0 <= n_live <= T.
int snk_greedy_decode_stream(const float* tc, const float* jl, const float* jr,
                             const float* init_ctx, int64_t* path, float* ctx_out,
                             int t_steps, int n, int dj, float jcw_first, float jcw_rest,
                             int n_live, int squared, int groups, int ring, int cluster,
                             size_t smem, void* stream) {
  if (n_live < 0 || n_live > t_steps ||
      bad_shape(KIND_GREEDY, n, dj, t_steps, groups, ring, cluster, 0, smem))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch(greedy_kernel<true>, cluster, PRODUCER_THREADS + 32, cluster, smem, stream, tc,
                jl, jr, static_cast<const int64_t*>(nullptr), init_ctx, path,
                static_cast<float*>(nullptr), ctx_out, t_steps, n, dj, jcw_first, jcw_rest,
                squared, n_live, groups, ring);
}

}  // extern "C"

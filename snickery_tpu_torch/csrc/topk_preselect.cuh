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
// (halfphone voices, :192-208): topk_partial<TT, PART, LING, SEL, BULK>.  At the
// bf16-split precisions "split3" (_split3_dot :77-93) and "split3cat"
// (_bf16_split :96-99, the [hi|hi|lo] concat :112-130, :158-178), with the
// same fused masks applied after the product (:156-208 composed):
// topk_partial_split<TT, PREC, PART, LING, PRESPLIT, SEL, CL>.  One exported
// entry point per (form, precision, masks, selection), 96 in all: 24 a
// selection, exported by one source per (form, selection).
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
// to kp = kd rounded up to 32, so a row is 4 kp bytes (640 at kd 151), a
// multiple of 128, and is staged with 16-byte copies.  The kernels read sqn
// through a pointer and a stride: the raw block's column kd (stride width)
// or the vector (stride 1).  Per target the k smallest (score, u) pairs are
// kept, the lowest u winning ties.
//
// Precisions.  "highest": cross in FP32 FMAs on the CUDA cores, one fmaf a
// column in ascending column order, so a score does not depend on the tile
// shape.  The split precisions cut each operand once into bf16
// hi = bf16_rn(x) and lo = bf16_rn(x - hi), as JAX's astype(bfloat16) does,
// and form cross = hi.hi + hi.lo + lo.hi (raw side first) on the tensor
// cores (wgmma m64nNk16, bf16 in, f32 accumulate).  Each bf16 x bf16
// product is exact in f32, so only the summation order differs from the TPU
// kernel: "split3cat" keeps one accumulator over the 3 * kd pairs (the
// TPU's one K = 3d pass), "split3" three, combined as (hh + hl) + lh (its
// three passes).  A wgmma adds 16 products, as the warp-level mma of the
// first design did; a product always runs over whole stages of 64 columns
// (columns past kd are zero on both sides and add exact zeros: a step count
// that depends on kd makes the compiler wait for every wgmma in turn).
//
// Fused masks, at every precision, applied to the score after the product in
// the Pallas order (so at "highest" the plain twin agrees bit for bit):
//   PART: score = +inf where vid(t) != vid(u);
//   LING: score += 2^24 (const.ID_RANK_PENALTY) where code(t) != code(u),
//         then score += pen[c] where ctx_c(t) != ctx_c(u), c = 0..4 in order,
//         skipping slots whose constant is 0; pen[c] = float32(w_c * scale)
//         is rounded on the host.
// Each side describes a row with 8 int32 [code, ctx0..ctx4, vid, 0] (two
// int4 loads); the target rows of the tile sit in shared memory and the DB
// rows of each tile ride in the staging ring.  A +inf score never enters a
// list, so a slot that no finite score reaches (a voice with fewer than k
// rows) is written as (+inf, index 0): the Pallas contract for
// partition-starved columns.
//
// Shape of the work on Hopper.  The TPU kernel walks the DB chunk by chunk
// in sequence and carries a k-slot state in VMEM.  Here blocks run in
// parallel and in no order, so the DB is cut into S contiguous splits as
// well as the targets into tiles of TT rows (128, or 64 where 128 do not
// fit in shared memory or T <= 64), one CTA an SM:
//
//   pass 1, grid (target tiles) x (S splits).  The target tile stays in
//     shared memory; the split's DB rows stream through a ring of stages
//     filled ahead of the arithmetic, and a sparse epilogue keeps sorted
//     k-slot lists in shared memory (below).
//     topk_partial ("highest"): 256 threads, DB tiles of 128 rows, stages of
//     16 columns in a ring of three filled by 4-byte cp.async (an f32 row
//     of 4 (kd + 2) or 4 kd bytes is only 4-byte aligned at kd 151 and
//     453), one __syncthreads a stage, the loads of stage s + 2 in flight
//     while stage s is multiplied.  Each thread owns an 8 x 8 register tile
//     (8 x 4 at TT = 64), read as two float4 a side: 64 FMAs for four
//     LDS.128.  The stage is stored column-major, [column][row] with the
//     row stride padded from 128 to 132 floats: a warp copies 8 columns of
//     4 rows, which land in 32 different banks (bank = 4 column + row),
//     and the float4 reads along the rows stay 16-byte aligned and free of
//     conflicts; the global reads are runs of 32 bytes along a row.
//     topk_partial_split (split precisions): 384 threads.  One producer
//     warpgroup fills a ring of four stages, each 64 DB rows x 64 columns of
//     bf16 hi and lo in the 128-byte-swizzled K-major layout wgmma reads (a
//     row is 128 bytes, its 16-byte chunk c sits at chunk c ^ (row % 8); tiles
//     are 1,024-byte aligned): pre-split rows by 16-byte cp.async whose
//     completion itself arrives on the stage's barrier
//     (cp.async.mbarrier.arrive; the consumer makes the fence.proxy.async);
//     f32 rows by loads along the row, split in registers (one cvt.rn.bf16x2 a
//     pair and half) and stored as packed bf16x2 words, the loads of the next
//     two stages in flight while the current one is split.  Two consumer
//     warpgroups take alternate 64-row DB tiles and multiply them (M = 64 DB
//     rows) by the resident target tile (N = TT targets, bf16 hi and lo in the
//     same layout) with wgmma, the f32 sums in registers, so one warpgroup's
//     epilogue runs under the other's products.  A tile's first wgmma writes
//     the sums without reading them, so they are not live across the epilogue,
//     and the epilogue keeps its values in registers of their own: sums
//     touched in conditional code make the compiler serialize the wgmma.
//     Stages are handed over with mbarriers (full: the producer's 128
//     arrivals, after a fence.proxy.async where it stored the stage itself, on
//     the barrier of the warpgroup that takes the tile, so that each group
//     sees every phase of the barriers it waits on and a parity names one
//     phase; empty: the consumer's 128 after the wgmma that read the stage
//     completed); a tile's sqn and metadata rows travel with its last stage,
//     which goes back to the producer as soon as the sqn are in registers
//     (after the scores in the masked variants).  "split3" runs at TT = 64
//     (three accumulators).
//     Clusters (f32 rows, no partition mask, two target tiles or more:
//     ops/cuda_topk.py::launch_shape; the kernel's CL).  Every CTA of a
//     split streams the same rows, and on f32 rows its producer's loads and
//     split stand beside the tensor cores' time (PERF.md: the pre-split
//     operand, whose producer only copies, is 35% faster on the same rows).
//     So pass 1 runs as clusters of CLUSTER CTAs along the target-tile axis
//     (a tile count that is not a multiple is padded with dead tiles, t0 >=
//     T, which write nothing: one launch and one code path for the rare
//     ragged count): the producer of rank r loads and splits only rows
//     [r R2 / CS, (r + 1) R2 / CS) of each stage, their sqn and metadata
//     rows too, and stores them into the same slot of its own ring and of
//     every other CTA's, so a DB row is loaded and split once for CS target
//     tiles.  A remote store is st.async at the address mapa gives, whose
//     bytes complete on the receiving CTA's full barrier of the stage
//     (complete_tx): the producer neither waits for it nor fences, a full
//     barrier still counts the CTA's own 128 producer threads, one of which
//     expects the bytes the others bring, and the consumers make the stage
//     visible to wgmma after their wait (fence.proxy.async).  A slot is
//     empty only when the consumers of every CTA have read it: the empty
//     barrier counts the own group's 128 threads and lane 0 of each warp of
//     the other groups.  The CTAs meet at a cluster barrier once their
//     barriers are made and again before they exit, as a CTA's barriers
//     may take the others' arrivals to the end.  The ring, the consumers,
//     the lists, the split plan and pass 2 are those of a CTA alone, and a
//     score is the same wgmma chain over the same bf16 values, so the
//     result does not depend on the launch's shape.  Budget: no shared
//     memory beyond a CTA's (223 KB at kd 151, k 48: one CTA an SM), so a
//     cluster needs CS SMs of one GPC free at once: the H100 holds 66
//     clusters of 2 (all 132 SMs) and 30 of 4 (120), and at 4 the stores to
//     three rings cost more than they save (PERF.md).  What bounds it then:
//     the ring of four stages (1.33 DB tiles for two consumer groups that
//     take alternate tiles) hands each stage over just in time, so both
//     sides wait on each other's barriers about half the time.
//   pass 2 (topk_merge): gw warps a target (1 to 8: more where there are
//     few targets and many splits) merge the S sorted partial lists under
//     the same (score, index) order, each warp its share by sorted-list
//     merges (a bitonic half-cleaner network, the loads of four lists in
//     flight, empty lists skipped), then the target's first warp the
//     others' lists; comp is added (the zero-transient form only).
//
// S is chosen by the wrapper so that tiles x S fills the card at small T
// (one utterance: 1 to 16 target tiles) as well as at large T.  The CTA of
// split s takes the chunks s, s + S, ... of rows_per_split rows of the rows
// its target tile scans (cta_rows): all of [0, m_rows), or with the
// partition mask the tile's voice spans, which the wrapper computes per
// tile (the hull of its targets' voices' rows, and the padding rows where a
// target is dead, voice id -1 as padding rows have; rounded out to 128-row
// blocks): a merged DB holds each voice's rows in one run, so a tile of one
// voice scans that run and nothing of the other voices, whose scores would
// all be +inf.  The plan covers the longest voice and the padding rows in
// one chunk a CTA; a tile of two voices takes more chunks.
//
// The sparse epilogue.  A finished score is compared in registers with its
// target's threshold, the worst kept (score, row) pair (slot k - 1 of the
// list), under the lists' own order, so that of many rows with one score
// (padding rows, duplicates) only those pass that can still win.  In the
// STREAM selection the survivors then reach the lists in bulk: a target's
// survivors of one DB tile are sorted by a warp's bitonic network and
// merged with its sorted list held in registers (FEW or fewer are inserted
// one at a time by a ballot and a shuffle), one merge a (target, tile with
// survivors), in the manner of
// WarpSelect's warp merges (arXiv:1702.08734, section 5).  A split's first
// tile passes every finite score against the open thresholds, so its
// scores are sorted into the empty lists at once and the thresholds start
// warm.  In topk_partial (splits of at most BULK_ROWS rows; longer ones,
// whose tiles are nearly all warm, keep the queue below) a warp holds every
// score of the tile for its own 16 targets (warp_select: no queue, no
// atomics, no barrier); in topk_partial_split a target's scores lie in all
// four
// warps of a consumer warpgroup, so the first tile and a tile whose
// survivors overflow the queue go through shared memory, 8 targets a round
// (group_rounds), under the CTA's list lock, and the few survivors of a
// warm tile through the queue below.  The other selections (PHASE, PACKED,
// PACKED3, sweep only), STREAM's long splits in topk_partial and its warm
// tiles in topk_partial_split append the survivors, as (value, target, row), to a queue of QCAP
// entries in shared memory (QCAP = 1024 in topk_partial, QCAP2 = 512 for
// each consumer warpgroup of topk_partial_split).  The queue is drained into
// the lists, each entry inserted by the warp that owns its target under the
// exact (score, index) order, only when it is half full, when an entry found
// it full, or after the last tile; a tile that drains nothing costs one
// barrier.  The exact top-k under a total order does not depend on the
// order of insertion, and a pair of the final top-k beats every worst pair
// its list ever had, so it passes the screen whenever it is computed,
// against a worst value that is out of date too (it is larger and only lets
// more through): the result is that of offering every score.  Overflow
// rule: an entry that finds the queue full stays pending in its thread's
// registers; the queue is drained, the pending scores are screened again
// against the lowered worst and appended again, until none is pending (cold
// lists at the start of a split, a DB sorted by falling score); in STREAM
// the pending scores go into the lists in bulk after the one drain.  A warm
// list takes k / rows_seen of a tile's scores, so after the first few tiles
// a tile adds a handful of entries.  Without masks and with score lists
// (STREAM, PHASE) the screen is two instructions a score: one fmaf forms it
// (a row past the split's end has sqn +inf) and one `<=` with the
// threshold's score is OR-ed into a flag; the threshold's score is the
// worst kept score but FLT_MAX at most (a +inf score fails) and -inf for a
// target past T; the mask of the survivors is built, with the exact pair
// compare, only by the threads whose flag is set.  In topk_partial_split
// both consumer warpgroups insert into the same lists, so a warpgroup
// drains its own queue while it holds the CTA's list lock.
//
// Selection (SEL): how the survivors reach the lists.
//   STREAM: sorted batches merged with the lists (a warm tile's few in
//     queue order in topk_partial_split); exact, lowest index on ties.
//   PHASE:  by rounds of warp minimum over a batch of queue entries, lowest
//     row holding it, insert, mask the extracted entry: the same exact
//     top-k, bit for bit, found the way the Pallas phase loop finds it.
//   PACKED: the lists hold int keys, key = to_key(score) with the low 7
//     bits replaced by u & 127 (pallas_topk.py:212-217, :524-527,
//     BLOCK = 128), ordered by (key, u); the screen is one int compare.
//     Pass 2 unpacks (from_key, :220-226) and adds comp, so a returned
//     score lies within 127 ulp of the score that was ranked.
//   PACKED3: per target and 128-row block the three smallest keys, kept in
//     shared memory by an atomicMin cascade (a key that loses a slot moves
//     to the next, so the three slots end as the three least whatever the
//     order), offered to the list through the queue at the block's end
//     (drained at once), and
//     the least third key of any block kept per (target, split).  Pass 2
//     raises a target's overflow flag where that least third key lies below
//     the worst key kept: some block may hold a fourth row that belongs in
//     the list.  A target without flag has exactly the PACKED result.
//     Splits start on multiples of 128; in topk_partial_split a block's two
//     64-row tiles go to the same warpgroup.
// In the packed forms a +inf score (a masked row) gets no key and enters no
// list, as in the other two, so dead slots read (+inf, 0) in all four; the
// Pallas kernel fills them with (+inf, some row).
//
// Shared memory of pass 1 (partial_smem), one CTA an SM.  "highest":
// 4 * (TT * kd16 + 3 * 16 * 132 + 3 * 128 + 2 * TT * k) + 12 KB of queue
// (8 KB of staging in the bulk epilogue), kd16 = kd rounded up to
// 16, plus 12 KB + 32 TT of metadata in the masked variants: 159 KB (155 KB
// bulk) at kd 151, k 40, TT 128; at kd 453 TT 128 would need 232 KB for the
// targets alone, so TT is 64 there (about 175 KB).  Split precisions: the target
// tile 2 * TT * 128 * ceil(kd / 64) bytes (96 KB at kd 151 and TT 128, 128
// KB at kd 453 and TT 64), the ring 16 KB a stage (four where they fit, two
// at the least: split_stages), the lists 8 TT k, two queues of 6 KB: 223 KB
// at kd 151, k 48, TT 128 with four stages.  The
// ring is what is short: four stages are one tile and a third, so a
// warpgroup's next tile is fetched only as the other's is consumed, and the
// latency of L2 is not hidden (PERF.md).
//
// Bound: at the config-3 batch shape (65,536 targets x 1,048,576 units x
// kd = 151) "highest" is 2.1e13 FLOP of FP32 FMA against 640 MB of DB, so
// it is bound by the FP32 FMA rate; what the design removes is what kept
// the FMA pipe idle: shared-memory operand traffic (8 x 8 tile), exposed
// load latency and barriers (the ring), the dense score tile and its idle
// selection phase (the screen).  The split variants do 3x the products at
// the bf16 tensor-core rate; with wgmma the products alone run near that
// rate, and what stands beside them is the L2 stream of the DB (each target
// tile streams the whole operand: halved by TT = 128; about 390 GB a call,
// near what L2 delivers in the tensor cores' time), its latency behind a
// ring of four stages, the epilogue's instructions (the sums live in the
// register file, so they do not run under the other warpgroup's wgmma for
// free) and, for f32 rows, the producer's loads and split arithmetic, which
// a cluster shares among its CTAs (the L2 stream of f32 rows falls to 1 /
// CLUSTER, the producer's work a stage to 1 / CLUSTER plus the remote stores
// and arrivals); what remains beside the products is the consumers' side:
// the ring's latency and the epilogue.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstddef>
#include <cstdint>
#include <type_traits>

namespace {

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
constexpr int QCAP = 1024;              // queue entries of topk_partial
constexpr int STAGE1 = 128;             // staged survivors of a warp (STREAM): a
                                        //   target's in a 128-row tile
constexpr int QCAP2 = 512;              // of each consumer warpgroup of
                                        // topk_partial_split
constexpr int SMEM_LIMIT = 232448;      // 227 KB: what a block may use

// topk_partial ("highest")
constexpr int THREADS = 256;
constexpr int R1 = 128;                 // DB rows per tile
constexpr int KC1 = 16;                 // DB columns per stage
constexpr int NS1 = 3;                  // stages in the ring
constexpr int SD = R1 + 4;              // row stride of a stage column (floats)

// topk_partial_split (split precisions)
constexpr int THREADS2 = 384;           // two consumer warpgroups, one producer
constexpr int R2 = 64;                  // DB rows per tile: the M of wgmma
constexpr int KC2 = 64;                 // bf16 columns per stage: one 128-byte row
constexpr int NS2 = 4;                  // stages in the ring, where they fit
constexpr int HALF2 = R2 * KC2 * 2;     // bytes of a stage's hi (or lo) tile
constexpr int KPAD = 32;                // a pre-split half is padded to this

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

// What the screen compares a target's scores with: the worst kept score,
// but FLT_MAX at most, so that a +inf score fails `<=` without a test of its
// own.  (Targets past T get -inf: nothing passes.)
__device__ __forceinline__ int screen_bits(float worst) {
  return __float_as_int(fminf(worst, 3.402823466e+38f));
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
// (past the split's end, a target past T, or a score that is not below +inf).
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

// ------------------------------------------------- warp sorting networks
// A warp holds a sequence of 64 (value, row) pairs, two a lane: element
// 2 lane + r in v[r], x[r] (V float: scores; V int: packed keys), ordered
// by lex_less, so the lowest row wins a tie.  The pair (none, INT_MAX) is
// an empty slot and sorts after every real pair (a real score is finite, a
// real key below KEY_EMPTY).  The networks are those of Batcher's bitonic
// sort, as the warp-level merges of WarpSelect (Johnson, Douze and Jegou,
// "Billion-scale similarity search with GPUs", arXiv:1702.08734, section 5)
// run them.
template <typename V>
__device__ __forceinline__ V none_value() {
  if constexpr (std::is_same<V, int>::value) {
    return KEY_EMPTY;
  } else {
    return pos_inf();
  }
}

// One compare-exchange step: element i against element i ^ d; the lower
// index keeps the smaller pair where the block of s elements that holds i
// sorts ascending ((i & s) == 0), the larger where it sorts descending.
template <typename V>
__device__ __forceinline__ void bitonic_step(V (&v)[2], int (&x)[2], int s, int d,
                                             int lane) {
  if (d == 1) {                           // both elements in this lane
    const bool asc = ((2 * lane) & s) == 0;
    if (asc ? lex_less(v[1], x[1], v[0], x[0]) : lex_less(v[0], x[0], v[1], x[1])) {
      const V tv = v[0];
      const int tx = x[0];
      v[0] = v[1];
      x[0] = x[1];
      v[1] = tv;
      x[1] = tx;
    }
    return;
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const V pv = __shfl_xor_sync(FULL, v[r], d >> 1);
    const int px = __shfl_xor_sync(FULL, x[r], d >> 1);
    const int i = 2 * lane + r;
    const bool keep_min = ((i & d) == 0) == ((i & s) == 0);
    if (keep_min ? lex_less(pv, px, v[r], x[r]) : lex_less(v[r], x[r], pv, px)) {
      v[r] = pv;
      x[r] = px;
    }
  }
}

// Sort the first W elements ascending (W a power of two, 1..64, the same in
// every lane); elements W.. must be empty slots, so the 64 end ascending.
template <typename V>
__device__ __forceinline__ void bitonic_sort(V (&v)[2], int (&x)[2], int W, int lane) {
  for (int s = 2; s <= W; s <<= 1) {
    for (int d = s >> 1; d > 0; d >>= 1) bitonic_step(v, x, s, d, lane);
  }
}

// The 64 least pairs of two ascending sequences, ascending, into (l, lx):
// element i of l against element 63 - i of c (lane 31 - lane, the other
// element) keeps the less, which leaves a bitonic sequence holding the 64
// least, and the half-cleaners of the last stage sort it.
template <typename V>
__device__ __forceinline__ void merge_sorted(V (&l)[2], int (&lx)[2], const V (&c)[2],
                                             const int (&cx)[2], int lane) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const V cv = __shfl_sync(FULL, c[1 - r], 31 - lane);
    const int ci = __shfl_sync(FULL, cx[1 - r], 31 - lane);
    if (lex_less(cv, ci, l[r], lx[r])) {
      l[r] = cv;
      lx[r] = ci;
    }
  }
  for (int d = 32; d > 0; d >>= 1) bitonic_step(l, lx, 64, d, lane);
}

// Pair j of the list (lv, li) of k slots, or an empty slot past k.
template <typename V>
__device__ __forceinline__ void load_pairs(const V* lv, const int* li, int k, V (&v)[2],
                                           int (&x)[2], int lane) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int j = 2 * lane + r;
    v[r] = j < k ? lv[j] : none_value<V>();
    x[r] = j < k ? li[j] : INT_MAX;
  }
}

// Insert the pair (v, u), the same in every lane, into the ascending
// sequence (l, lx) held in registers (element 2 lane + r): its rank p is
// the count of elements below it (two ballots), element j keeps itself
// below p, takes (v, u) at p and element j - 1 above p (one shuffle).
// Only the first k elements are kept in the end: a pair of rank k or more
// lands past them, and elements past k never lower a later pair's rank
// below k (each is above every one of the first k).
template <typename V>
__device__ __forceinline__ void reg_insert(V (&l)[2], int (&lx)[2], V v, int u, int lane) {
  const int p = __popc(__ballot_sync(FULL, lex_less(l[0], lx[0], v, u))) +
                __popc(__ballot_sync(FULL, lex_less(l[1], lx[1], v, u)));
  const V up = __shfl_up_sync(FULL, l[1], 1);
  const int upx = __shfl_up_sync(FULL, lx[1], 1);
  const int j0 = 2 * lane, j1 = j0 + 1;
  const V n1 = j1 < p ? l[1] : j1 == p ? v : l[0];
  const int x1 = j1 < p ? lx[1] : j1 == p ? u : lx[0];
  if (j0 >= p) {
    l[0] = j0 == p ? v : up;
    lx[0] = j0 == p ? u : upx;
  }
  l[1] = n1;
  lx[1] = x1;
}

// Batches of at most this many survivors of one target go into its list
// one pair at a time (reg_insert); larger ones are sorted by the bitonic
// network and merged with it (merge_sorted), which costs about as much as
// this many inserts whatever the batch's size.
constexpr int FEW = 8;

// Sort the n survivors (cv, ci)[0..n) (shared memory, any order) and merge
// them, 64 at a time, into the ascending sequence (l, lx) held in
// registers.
__device__ __forceinline__ void merge_staged(float (&l)[2], int (&lx)[2], const float* cv,
                                             const int* ci, int n, int lane) {
  for (int b = 0; b < n; b += 64) {
    const int m = min(64, n - b);
    float c[2];
    int cx[2];
    load_pairs(cv + b, ci + b, m, c, cx, lane);
    int W = 2;
    while (W < m) W <<= 1;
    bitonic_sort(c, cx, W, lane);
    merge_sorted(l, lx, c, cx, lane);
  }
}

// Store the first k elements of (l, lx) as the list (lv, li) and its worst
// kept pair (element k - 1) as the screen's threshold *worst (screen_bits
// of its score, its row).
__device__ __forceinline__ void store_list(float* lv, int* li, int k, const float (&l)[2],
                                           const int (&lx)[2], int2* worst, int lane) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int j = 2 * lane + r;
    if (j < k) {
      lv[j] = l[r];
      li[j] = lx[r];
    }
  }
  const float wv = __shfl_sync(FULL, (k - 1) & 1 ? l[1] : l[0], (k - 1) >> 1);
  const int wx = __shfl_sync(FULL, (k - 1) & 1 ? lx[1] : lx[0], (k - 1) >> 1);
  if (lane == 0) *worst = make_int2(screen_bits(wv), wx);
  __syncwarp();
}

// Merge the n survivors (cv, ci)[0..n) of one target (shared memory, any
// order) into its ascending list (lv, li) of k slots, keeping the k least
// pairs, and store the list's new threshold in *worst.  Warp-cooperative.
// Survivors were screened against a threshold that may be out of date: one
// that no longer beats the list is dropped here.
__device__ __forceinline__ void merge_batch(float* lv, int* li, int k, const float* cv,
                                            const int* ci, int n, int2* worst, int lane) {
  float l[2];
  int lx[2];
  load_pairs(lv, li, k, l, lx, lane);
  if (n <= FEW) {
    for (int c = 0; c < n; ++c) reg_insert(l, lx, cv[c], ci[c], lane);
  } else {
    merge_staged(l, lx, cv, ci, n, lane);
  }
  __syncwarp();
  store_list(lv, li, k, l, lx, worst, lane);
}

// ---------------------------------------------------------------- selection
// What the sparse epilogue of one group of threads works on: the CTA's
// lists (values or keys, and rows; the worst kept pair of each once more
// in an array of its own, which the screen reads free of bank conflicts),
// the group's queue (ranked value bits, target of the tile, DB row; one
// count) and, for PACKED3, the group's per-target block state [TT][B3].
struct Select {
  float* lv;
  int* li;
  int2* worst;                            // [TT] the screen's thresholds: (screen_bits of
                                          //   the worst kept score, or the worst key; its row)
  int* qbits;
  int* qtgt;
  int* qrow;
  int* qcount;
  int* sB3;
  int k;
  int cap;                                // queue entries; drained when half full
};

// The group that runs an epilogue together.  topk_partial: the whole CTA;
// nobody else touches the lists, so the lock is empty.
struct CtaGroup {
  int tid, warp;
  static constexpr int threads = THREADS, warps = THREADS / 32;
  __device__ __forceinline__ void sync() const { __syncthreads(); }
  // a barrier that also tells every thread whether any thread's flag is set
  __device__ __forceinline__ bool any(bool flag) const { return __syncthreads_or(flag); }
  __device__ __forceinline__ void lock() const {}
  __device__ __forceinline__ void unlock() const { __syncthreads(); }
};

// topk_partial_split: one consumer warpgroup (named barrier 1 + id).  The
// other warpgroup inserts into the same lists, so a drain runs under the
// CTA's list lock (an int in shared memory, 0 = free), taken by the
// group's first thread.
struct WarpGroup {
  int tid, warp, id;
  int* mutex;
  static constexpr int threads = 128, warps = 4;
  __device__ __forceinline__ void sync() const {
    asm volatile("bar.sync %0, 128;\n" ::"r"(id + 1) : "memory");
  }
  __device__ __forceinline__ bool any(bool flag) const {
    uint32_t out;
    asm volatile(
        "{\n.reg .pred p, q;\nsetp.ne.b32 p, %1, 0;\n"
        "bar.red.or.pred q, %2, 128, p;\nselp.u32 %0, 1, 0, q;\n}\n"
        : "=r"(out)
        : "r"(static_cast<uint32_t>(flag)), "r"(id + 1)
        : "memory");
    return out != 0;
  }
  __device__ __forceinline__ void lock() const {
    if (tid == 0) {
      const long long t0 = clock64();
      while (atomicCAS(mutex, 0, 1) != 0) {
        __nanosleep(32);
        if (clock64() - t0 > (1ll << 33)) __trap();   // seconds: a lost unlock
      }
      __threadfence_block();
    }
    sync();
  }
  __device__ __forceinline__ void unlock() const {
    sync();
    if (tid == 0) {
      __threadfence_block();
      atomicExch(mutex, 0);
    }
  }
};

// Does the score v at DB row u pass the screen of a list whose threshold
// pair is w?  The exact (score, row) order, so that of many rows with one
// and the same score (padding rows, duplicates) only those pass that can
// still win.  The pair may be out of date: it is then larger, and lets more
// through.
__device__ __forceinline__ bool passes_pair(float v, int u, int2 w) {
  const float wv = __int_as_float(w.x);
  return v < wv || (v == wv && u < w.y);
}

// Does the packed key pass the screen of a list whose worst key is `worst`?
// `<=` so that an equal key still reaches the exact (key, row) compare of
// the drain.
__device__ __forceinline__ bool passes_key(int key, int worst) {
  return key != KEY_EMPTY && key <= worst;
}

// Append one entry and return its slot; at slot >= cap the queue was full and
// nothing was written (the entry stays pending).
__device__ __forceinline__ int push(const Select& s, int bits, int t, int u) {
  const int slot = atomicAdd(s.qcount, 1);
  if (slot < s.cap) {
    s.qbits[slot] = bits;
    s.qtgt[slot] = t;
    s.qrow[slot] = u;
  }
  return slot;
}

// Insert the first n queue entries into their lists.  Every warp of the
// group reads all entries, 32 at a time, and takes those whose target it
// owns (t % warps == warp), so no two warps write one list.
template <int SEL, typename G>
__device__ void drain_queue(const Select& s, int n, const G& g, int lane) {
  constexpr bool KEYS = SEL == PACKED || SEL == PACKED3;
  const int k = s.k;
  for (int b = 0; b < n; b += 32) {
    const int e = b + lane;
    const bool has = e < n;
    const int bits = has ? s.qbits[e] : 0;
    const int t = has ? s.qtgt[e] : 0;
    const int u = has ? s.qrow[e] : 0;
    bool alive = has && t % G::warps == g.warp;
    if constexpr (SEL == PHASE) {
      // rounds: the least (score, row) among the batch's entries left, then
      // insert it if it still beats its list's worst
      while (true) {
        const float cv = alive ? __int_as_float(bits) : pos_inf();
        float vmin = cv;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
          vmin = fminf(vmin, __shfl_xor_sync(FULL, vmin, o));
        }
        if (!(vmin < pos_inf())) break;   // queued scores are finite: none left
        const int imin = __reduce_min_sync(FULL, alive && cv == vmin ? u : INT_MAX);
        const bool own = alive && cv == vmin && u == imin;
        const int src = __ffs(__ballot_sync(FULL, own)) - 1;
        const int ct = __shfl_sync(FULL, t, src);
        const float v = __shfl_sync(FULL, cv, src);
        float* tv = s.lv + ct * k;
        int* ti = s.li + ct * k;
        if (lex_less(v, imin, tv[k - 1], ti[k - 1])) {
          warp_insert(tv, ti, k, v, imin, lane);
          if (lane == 0) s.worst[ct] = make_int2(screen_bits(tv[k - 1]), ti[k - 1]);
        }
        if (lane == src) alive = false;
      }
    } else {
      unsigned m = __ballot_sync(FULL, alive);
      while (m) {
        const int src = __ffs(m) - 1;
        m &= m - 1;
        const int cb = __shfl_sync(FULL, bits, src);
        const int ct = __shfl_sync(FULL, t, src);
        const int cu = __shfl_sync(FULL, u, src);
        int* ti = s.li + ct * k;
        if constexpr (KEYS) {
          int* tk = reinterpret_cast<int*>(s.lv) + ct * k;
          if (lex_less(cb, cu, tk[k - 1], ti[k - 1])) {
            warp_insert(tk, ti, k, cb, cu, lane);
            if (lane == 0) s.worst[ct] = make_int2(tk[k - 1], ti[k - 1]);
          }
        } else {
          float* tv = s.lv + ct * k;
          const float cv = __int_as_float(cb);
          if (lex_less(cv, cu, tv[k - 1], ti[k - 1])) {
            warp_insert(tv, ti, k, cv, cu, lane);
            if (lane == 0) s.worst[ct] = make_int2(screen_bits(tv[k - 1]), ti[k - 1]);
          }
        }
      }
    }
  }
}

// PACKED3: merge key x into a block's three least keys s[0..2].  Each slot
// keeps the least key it has seen and hands the other on, so whatever the
// order of concurrent calls the slots end as the three least of all keys.
__device__ __forceinline__ void insert3(int* s, int x) {
  int o = atomicMin(s, x);
  x = max(o, x);
  o = atomicMin(s + 1, x);
  x = max(o, x);
  atomicMin(s + 2, x);
}

// topk_partial_split, STREAM: survivors of one warpgroup's DB tile into the
// lists in bulk, where the queue would take them a pair at a time: the
// group's first tile, whose every finite score passed the open thresholds,
// and the survivors left pending when the queue overflowed (sparse_select).
// A target's scores of a tile lie in all four warps of the group (warp w
// holds DB rows 16 w .. and 16 w + 8 ..), so the survivors go through the
// group's queue area, which is empty then: 8 targets a round (the values e
// of a thread with e / 4 = j: targets 8 j .. 8 j + 7), each thread
// appending its survivors (bits) of the round's targets to the target's
// staging row (64 slots: a tile has 64 rows), and warp w merging the
// round's targets w and w + 4 into their lists (merge_batch): one merge a
// (target, tile).  Rounds without survivors are skipped (the group's mask
// of 8-target groups with survivors, OR-ed in shared memory).  The caller
// holds the CTA's list lock: the other warpgroup updates the same lists.
constexpr int RT2 = 8;                  // targets a round

template <int N, typename TOf, typename UOf>
__device__ __forceinline__ void group_rounds(const float (&vals)[N], unsigned long long bits,
                                             TOf t_of, UOf u_of, const Select& s,
                                             const WarpGroup& g, int lane) {
  constexpr int NG = N / 4;               // 8-target groups of the tile
  float* sv = reinterpret_cast<float*>(s.qbits);        // [RT2][R2] values
  int* si = s.qbits + RT2 * R2;                         // [RT2][R2] rows
  int* cnt = si + RT2 * R2;                             // [RT2]
  int* gmask = cnt + RT2;
  static_assert(2 * RT2 * R2 + RT2 + 1 <= 3 * QCAP2, "the rounds fit in the queue area");
  if (g.tid <= RT2) cnt[g.tid] = 0;       // the counts and the mask
  g.sync();
  unsigned gm = 0;
#pragma unroll
  for (int j = 0; j < NG; ++j) gm |= ((bits >> (4 * j)) & 0xfull) != 0 ? 1u << j : 0u;
  if (gm) atomicOr(reinterpret_cast<unsigned*>(gmask), gm);
  g.sync();
  const unsigned todo = *reinterpret_cast<volatile unsigned*>(gmask);
  for (int j0 = 0; j0 < NG; ++j0) {
    if (((todo >> j0) & 1u) == 0) continue;
#pragma unroll
    for (int e = 0; e < N; ++e) {
      if (((bits >> e) & 1) && (e >> 2) == j0) {
        const int tl = t_of(e) - 8 * j0;
        const int pos = atomicAdd(cnt + tl, 1);
        sv[tl * R2 + pos] = vals[e];
        si[tl * R2 + pos] = u_of(e);
      }
    }
    g.sync();
    for (int tl = g.warp; tl < RT2; tl += WarpGroup::warps) {
      const int n = cnt[tl];
      if (n > 0) {
        const int t = 8 * j0 + tl;
        merge_batch(s.lv + t * s.k, s.li + t * s.k, s.k, sv + tl * R2, si + tl * R2, n,
                    s.worst + t, lane);
        if (lane == 0) cnt[tl] = 0;
      }
    }
    g.sync();
  }
}

// The sparse epilogue of one DB tile for one group of threads.  vals[e]:
// the thread's N ranked values as float bit patterns, in the registers of
// the sums they replace (score bits, or packed keys; +inf bits / KEY_EMPTY
// where the row or the target takes no part); pass: bit e set
// where vals[e] passed the screen against its list's worst value (for
// PACKED3: where it is a key at all); t_of(e), u_of(e): its target in the
// tile and its DB row.  The survivors are appended to the group's queue,
// which is drained into the lists only when it is half full, when an entry found it full, or with `flush` (the group's last
// tile): until then the screen reads worst values that are out of date,
// which are larger and only let more through.  A tile that drains nothing
// costs one barrier.  block_ends, block_base (PACKED3): the tile closes the
// 128-row block that starts at that row; its three keys a target are queued
// and drained at once, so the queue is empty whenever a block ends.
template <int SEL, int TT, int N, typename G, typename TOf, typename UOf>
__device__ __forceinline__ void sparse_select(const float (&vals)[N],
                                              unsigned long long pass, TOf t_of,
                                              UOf u_of, const Select& s,
                                              const G& g, bool flush,
                                              bool block_ends, int block_base,
                                              int t0, int T, int lane) {
  constexpr bool KEYS = SEL == PACKED || SEL == PACKED3;
  static_assert(N <= 64, "one pending bit per value");
  unsigned long long pend = 0;
  bool due = flush;
  if constexpr (SEL == PACKED3) {
    if (pass) {
#pragma unroll
      for (int e = 0; e < N; ++e) {
        int* st = s.sB3 + t_of(e) * B3;
        if ((pass >> e & 1) && __float_as_int(vals[e]) < *reinterpret_cast<volatile int*>(st + 2)) {
          insert3(st, __float_as_int(vals[e]));
        }
      }
    }
    if (block_ends) {
      g.sync();
      for (int t = g.tid; t < TT; t += G::threads) {
        int* st = s.sB3 + t * B3;
        st[3] = min(st[3], st[2]);
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          const int key = st[j];
          st[j] = KEY_EMPTY;
          // 3 TT entries at most into an empty queue: it cannot overflow
          if (t0 + t < T && passes_key(key, s.worst[t].x)) {
            push(s, key, t, block_base + (key & (BLOCK - 1)));
          }
        }
      }
      due = true;
    }
  } else {
    if (pass) {
#pragma unroll
      for (int e = 0; e < N; ++e) {
        if (pass >> e & 1) {
          const int slot = push(s, __float_as_int(vals[e]), t_of(e), u_of(e));
          if (slot >= s.cap) pend |= 1ull << e;
          due |= slot + 1 >= s.cap / 2;
        }
      }
    }
  }
  if (!g.any(due)) return;                // a barrier: the queue is complete
  int total = *reinterpret_cast<volatile int*>(s.qcount);
  g.lock();
  while (true) {
    drain_queue<SEL>(s, min(total, s.cap), g, lane);
    g.sync();                             // drained, and every thread read total
    if (g.tid == 0) *s.qcount = 0;
    if (total <= s.cap) break;            // nothing was left pending
    if constexpr (SEL == STREAM && std::is_same<G, WarpGroup>::value) {
      // a heavy tile: its pending survivors into the lists in bulk
      group_rounds<N>(vals, pend, t_of, u_of, s, g, lane);
      break;
    }
    g.sync();
    if (pend) {
#pragma unroll
      for (int e = 0; e < N; ++e) {
        if (pend >> e & 1) {
          const int t = t_of(e);
          const long long raw = *reinterpret_cast<volatile long long*>(s.worst + t);
          const int2 w = make_int2(static_cast<int>(raw), static_cast<int>(raw >> 32));
          const bool still = KEYS ? passes_key(__float_as_int(vals[e]), w.x)
                                  : passes_pair(vals[e], u_of(e), w);
          if (!still || push(s, __float_as_int(vals[e]), t, u_of(e)) < s.cap) {
            pend &= ~(1ull << e);
          }
        }
      }
    }
    g.sync();
    total = *reinterpret_cast<volatile int*>(s.qcount);
  }
  g.unlock();                             // a barrier: the count reads 0 again
}

// Every list of the CTA empty: (+inf, INT_MAX) in each slot, or
// (KEY_EMPTY, INT_MAX) where the lists hold packed keys; the screen's
// thresholds open (KEY_EMPTY; for scores FLT_MAX, and -inf for the n_tgt -
// n_live targets past T); n3 ints of packed3 state all KEY_EMPTY; nq queue
// counters 0.
template <int SEL>
__device__ void init_state(float* lv, int* li, int n_list, int2* worst, int n_tgt,
                           int n_live, int* sB3, int n3, int* counters, int nq,
                           int tid, int threads) {
  constexpr bool KEYS = SEL == PACKED || SEL == PACKED3;
  const float none = KEYS ? __int_as_float(KEY_EMPTY) : pos_inf();
  for (int e = tid; e < n_list; e += threads) {
    lv[e] = none;
    li[e] = INT_MAX;
  }
  for (int e = tid; e < n_tgt; e += threads) {
    worst[e] = make_int2(KEYS ? KEY_EMPTY
                              : e < n_live ? screen_bits(pos_inf())
                                           : __float_as_int(-pos_inf()),
                         INT_MAX);
  }
  if constexpr (SEL == PACKED3) {
    for (int e = tid; e < n3; e += threads) sB3[e] = KEY_EMPTY;
  }
  if (tid < nq) counters[tid] = 0;
}

// The CTA's lists (scores or keys, copied as they are) to its slot of the
// (T, splits, k) partial outputs, and with part_third (PACKED3) each
// target's least third key (over the `groups` block states) to its slot of
// the (T, splits) array.
template <int TT>
__device__ void store_lists(const float* lv, const int* li, const int* sB3,
                            int groups, float* part_v, int* part_i,
                            int* part_third, int k, int t0, int T, int split,
                            int splits, int warp, int warps, int lane) {
  for (int t = warp; t < TT; t += warps) {
    if (t0 + t >= T) continue;
    const size_t o = (static_cast<size_t>(t0 + t) * splits + split) * k;
    for (int j = lane; j < k; j += 32) {
      part_v[o + j] = lv[t * k + j];
      part_i[o + j] = li[t * k + j];
    }
    if (part_third != nullptr && lane == 0) {
      int third = KEY_EMPTY;
      for (int gq = 0; gq < groups; ++gq) third = min(third, sB3[(gq * TT + t) * B3 + 3]);
      part_third[static_cast<size_t>(t0 + t) * splits + split] = third;
    }
  }
}

// Score of a target row against a DB row (their metadata rows in shared
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

// The ranked value of a score: its bits, or its packed key.
template <bool KEYS>
__device__ __forceinline__ int ranked_bits(float s, int u, bool in_range) {
  if constexpr (KEYS) {
    return packed_key(s, u, in_range);
  } else {
    return __float_as_int(in_range ? s : pos_inf());
  }
}

// cp.async of 4 or 16 bytes; n_src < the size zero-fills the rest (0: all).
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int n_src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(n_src)
               : "memory");
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int n_src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(n_src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// One arrival on the mbarrier, made when every cp.async this thread has
// started so far has completed; counted among the barrier's expected arrivals.
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(bar)))
               : "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ------------------------------------------------------------ rows of a CTA
// The DB rows a CTA of pass 1 scans.  A target tile's rows are one or two
// intervals of the DB ("pieces": [lo0, lo0 + len0) and [lo1, lo1 + total -
// len0)), read in concatenation; the CTA of split s takes the chunks s,
// s + splits, s + 2 splits, ... of `chunk` rows of that concatenation.  A
// chunk is a whole number of DB tiles and a piece but the last is a whole
// number of 128-row blocks, so no tile straddles two pieces and a packed3
// block lies in one.  Rows at or past m_rows are masked (+inf scores).
// SPANS false (no partition mask): one piece, [0, m_rows), and one chunk a
// CTA (the plan covers m_rows), so a tile's row is split * chunk + jt R.
template <bool SPANS>
struct Rows {
  int lo0, len0, lo1, total;
  int start, chunk, stride;               // split * chunk; chunk; splits * chunk
  int tpc;                                // DB tiles a chunk
  int n_tiles;                            // DB tiles of R rows the CTA takes
  // the first DB row of the CTA's tile jt (no division unless the CTA
  // takes several chunks)
  __device__ __forceinline__ int base(int jt, int R) const {
    int p = start + jt * R;
    if constexpr (!SPANS) return p;
    if (jt >= tpc) p += jt / tpc * (stride - chunk);
    return p < len0 ? lo0 + p : lo1 + (p - len0);
  }
};

// The rows of target tile `tile` for the CTA of split `split`: with spans
// (the wrapper's per-tile table, 4 ints a tile: -lo, hi of the voices' rows
// and -lo, hi of the padding rows, each rounded out to 128-row blocks and
// empty where hi <= lo), those intervals, made one where they overlap or
// touch; without, all of [0, m_rows).
template <bool SPANS>
__device__ Rows<SPANS> cta_rows(const int* spans, int tile, int split, int splits, int chunk,
                                int m_rows, int R) {
  int lo0 = 0, hi0 = m_rows, lo1 = 0, hi1 = 0;
  if (SPANS && spans != nullptr) {
    const int* s = spans + 4 * tile;
    lo0 = -s[0];
    hi0 = s[1];
    lo1 = -s[2];
    hi1 = s[3];
    if (hi0 <= lo0) {                     // no live voice: the padding rows alone
      lo0 = lo1;
      hi0 = hi1;
      lo1 = hi1 = 0;
    }
    if (hi1 <= lo1) {
      lo1 = hi1 = 0;
    } else {
      if (lo1 < lo0) {
        const int a = lo0, b = hi0;
        lo0 = lo1;
        hi0 = hi1;
        lo1 = a;
        hi1 = b;
      }
      if (lo1 <= hi0) {                   // overlapping or touching: their hull
        hi0 = max(hi0, hi1);
        lo1 = hi1 = 0;
      }
    }
    if (hi0 <= lo0) lo0 = hi0 = 0;        // no rows at all
  }
  Rows<SPANS> r;
  r.lo0 = lo0;
  r.lo1 = lo1;
  r.len0 = hi1 > lo1 ? (hi0 - lo0 + BLOCK - 1) / BLOCK * BLOCK : hi0 - lo0;
  r.total = r.len0 + (hi1 - lo1);
  r.start = split * chunk;
  r.chunk = chunk;
  r.stride = splits * chunk;
  r.tpc = chunk / R;
  r.n_tiles = 0;
  for (int p = r.start; p < r.total; p += r.stride) {
    r.n_tiles += (min(chunk, r.total - p) + R - 1) / R;
  }
  return r;
}

// ------------------------------------------------------------ pass 1, highest
// Splits of at most this many rows run topk_partial's bulk epilogue
// (warp_select, STREAM only), longer ones the queue: a warm tile has few
// survivors, which the queue takes for less (PERF.md, PR 10: at 3,584 rows
// a CTA the bulk epilogue is ~30% faster, at 32,768 rows the queue ~8%).
constexpr int BULK_ROWS = 8192;

// Bytes of shared memory topk_partial<TT> needs (bulk: its bulk epilogue);
// the kernel carves the same regions in the same order.
size_t partial_smem_highest(int TT, int kd, int k, bool masked, int sel, bool bulk) {
  const size_t kd16 = static_cast<size_t>((kd + KC1 - 1) / KC1 * KC1);
  return (kd16 * TT + NS1 * KC1 * SD + NS1 * R1 + 2 * static_cast<size_t>(TT) * k) * 4 +
         (masked ? (NS1 * R1 + TT) * META * 4 : 0) +
         ((bulk ? 2 * STAGE1 * (THREADS / 32) : 3 * QCAP + 4) + 2 * TT) * 4 +
         (sel == PACKED3 ? TT * B3 * 4 : 0);
}

// topk_partial, STREAM, short splits: the epilogue of one DB tile, warp by
// warp.  Thread (tx, ty) holds the scores of targets trow(i) at rows
// rrow(j), so warp w (ty = 2 w in lanes 0-15, 2 w + 1 in lanes 16-31) holds
// every score of the tile for its 8 (TT = 64) or 16 targets, and only it
// touches their lists and thresholds: no queue, no atomics, no barrier.
// For each target with survivors (pass bit i * 8 + j of the lanes of its
// half), the list is read into registers once; FEW survivors or fewer are
// inserted one by one, broadcast from the lanes that hold them
// (reg_insert), more are packed into the warp's staging area (STAGE1 pairs)
// by ballots, sorted and merged (merge_staged): a split's first tile, where
// every finite score passes the open thresholds, fills the empty lists in
// bulk.  Then the list and its threshold are stored once.
template <int TM, typename TOf, typename UOf>
__device__ __forceinline__ void warp_select(const float (&vals)[TM * 8],
                                            unsigned long long pass, TOf t_of, UOf u_of,
                                            float* lv, int* li, int2* sW, int k,
                                            float* stv, int* sti, int lane) {
  if (!__any_sync(FULL, pass != 0)) return;
  const int h = lane >> 4;
  const unsigned below = (1u << lane) - 1;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const unsigned byte = static_cast<unsigned>(pass >> (8 * i)) & 0xffu;
    if (!__any_sync(FULL, byte != 0)) continue;
    unsigned bal[8];
    int n[2] = {0, 0};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      bal[j] = __ballot_sync(FULL, (byte >> j) & 1u);
      n[0] += __popc(bal[j] & 0x0000ffffu);
      n[1] += __popc(bal[j] & 0xffff0000u);
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      if (n[hh] == 0) continue;
      const unsigned half = hh ? 0xffff0000u : 0x0000ffffu;
      const int t = t_of(hh, i);
      float l[2];
      int lx[2];
      load_pairs(lv + t * k, li + t * k, k, l, lx, lane);
      if (n[hh] <= FEW) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          unsigned m = bal[j] & half;
          while (m) {
            const int src = __ffs(m) - 1;
            m &= m - 1;
            reg_insert(l, lx, __shfl_sync(FULL, vals[i * 8 + j], src),
                       __shfl_sync(FULL, u_of(j), src), lane);
          }
        }
      } else {
        int base = 0;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (h == hh && ((byte >> j) & 1u)) {
            const int pos = base + __popc(bal[j] & half & below);
            stv[pos] = vals[i * 8 + j];
            sti[pos] = u_of(j);
          }
          base += __popc(bal[j] & half);
        }
        __syncwarp();
        merge_staged(l, lx, stv, sti, n[hh], lane);
      }
      __syncwarp();                       // the staged pairs are read
      store_list(lv + t * k, li + t * k, k, l, lx, sW + t, lane);
    }
  }
}

// Pass 1 at "highest".  raw: f32 DB rows of row stride width (the raw block
// or the derived operand); sqn[u * sqn_stride]: the squared norm of row u;
// spans: the per-tile rows of the partition variants (cta_rows); without
// them a CTA scans rows [split * rows_per_split, + rows_per_split).  BULK
// (STREAM, short splits): the bulk epilogue (warp_select), else the queue
// (sparse_select).
// Thread (tx, ty) = (tid % 16, tid / 16) owns DB rows tx * 4 .. + 3 and
// 64 + tx * 4 .. + 3 of the tile and targets ty * 4 .. + 3 (and, at
// TT = 128, 64 + ty * 4 .. + 3): two float4 a side per column.
template <int TT, bool PART, bool LING, int SEL, bool BULK>
__global__ void __launch_bounds__(THREADS, 1)
topk_partial(const float* __restrict__ t2, const float* __restrict__ raw,
             const float* __restrict__ sqn, int sqn_stride,
             const int* __restrict__ tmeta, const int* __restrict__ dmeta,
             const int* __restrict__ spans, Penalties pen, float* __restrict__ part_v,
             int* __restrict__ part_i, int* __restrict__ part_third, int T,
             int kd, int width, int m_rows, int rows_per_split, int k,
             int splits) {
  constexpr bool MASKED = PART || LING;
  constexpr bool KEYS = SEL == PACKED || SEL == PACKED3;
  constexpr int TM = TT / 16;             // targets a thread: 8 or 4
  constexpr int N = TM * 8;
  extern __shared__ __align__(16) float smem[];
  const int nk = (kd + KC1 - 1) / KC1;    // stages a DB tile
  float* sT = smem;                       // [nk * KC1][TT] targets, column-major,
                                          //   zero past kd
  float* sD = sT + nk * KC1 * TT;         // [NS1][KC1][SD] the ring
  float* sSqn = sD + NS1 * KC1 * SD;      // [NS1][R1] sqn of a tile
  int* sDM = reinterpret_cast<int*>(sSqn + NS1 * R1);   // [NS1][R1][META] if MASKED
  int* sTM = sDM + (MASKED ? NS1 * R1 * META : 0);      // [TT][META] if MASKED
  float* lv = reinterpret_cast<float*>(sTM + (MASKED ? TT * META : 0));
                                          // [TT][k] list values or keys
  int* li = reinterpret_cast<int*>(lv + TT * k);        // [TT][k] list rows
  // BULK: [warps][STAGE1] staged values, then as many rows; else 3 x [QCAP]
  // queue, then 4 counters
  static_assert(!BULK || SEL == STREAM, "the bulk epilogue is STREAM's");
  int* queue = li + TT * k;
  int2* sW = reinterpret_cast<int2*>(
      queue + (BULK ? 2 * STAGE1 * (THREADS / 32) : 3 * QCAP + 4));  // [TT]
  int* sB3 = reinterpret_cast<int*>(sW + TT);                 // [TT][B3] if PACKED3

  const int tid = threadIdx.x, lane = tid & 31;
  const CtaGroup grp = {tid, tid >> 5};
  const Select sel = {lv, li, sW, queue, queue + QCAP, queue + 2 * QCAP,
                      queue + 3 * QCAP, sB3, k, QCAP};
  float* stv = reinterpret_cast<float*>(queue) + grp.warp * STAGE1;
  int* sti = queue + CtaGroup::warps * STAGE1 + grp.warp * STAGE1;
  const int t0 = blockIdx.x * TT;
  const int split = blockIdx.y;
  const auto rows = cta_rows<PART>(spans, blockIdx.x, split, splits, rows_per_split, m_rows, R1);
  // without spans, rows [row_lo, row_hi) in tiles row_lo + jt R1
  const int row_lo = split * rows_per_split;
  const int row_hi = PART ? m_rows : min(row_lo + rows_per_split, m_rows);
  const int n_tiles = PART ? rows.n_tiles : (row_hi - row_lo + R1 - 1) / R1;
  const int n_stages = n_tiles * nk;

  for (int e = tid; e < nk * KC1 * TT; e += THREADS) {
    const int t = e / (nk * KC1), c = e % (nk * KC1);   // lanes along a row
    sT[c * TT + t] = (t0 + t < T && c < kd)
                         ? t2[static_cast<size_t>(t0 + t) * kd + c]
                         : 0.f;
  }
  if constexpr (MASKED) {
    for (int e = tid; e < TT * META; e += THREADS) {
      const int t = t0 + e / META;
      sTM[e] = t < T ? tmeta[static_cast<size_t>(t) * META + e % META] : -1;
    }
  }
  init_state<SEL>(lv, li, TT * k, sW, TT, T - t0, sB3, TT * B3, queue + 3 * QCAP,
                  BULK ? 0 : 4, tid, THREADS);

  // Stage (tile jt, column block ck) into ring slot `slot`: thread tid
  // copies column (i / 4) * 8 + tid % 8 of rows tid / 8 + 32 * (i % 4),
  // i = 0..7; the tile's sqn (and metadata rows) go with its first stage
  // into slot jt % NS1 of their own rings.
  int fbase = rows.base(0, R1);           // with spans: the row of the tile being filled
  auto fill = [&](int jt, int ck, int slot) {
    const int base = PART ? fbase : row_lo + jt * R1;
    const int c0 = ck * KC1;
    float* buf = sD + slot * KC1 * SD;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int c = (i >> 2) * 8 + (tid & 7);
      const int r = (tid >> 3) + 32 * (i & 3);
      const int u = base + r;
      const bool ok = u < row_hi && c0 + c < kd;
      cp_async4(buf + c * SD + r,
                ok ? raw + static_cast<size_t>(u) * width + c0 + c : raw,
                ok ? 4 : 0);
    }
    if (ck == 0) {
      const int ts = jt % NS1;
      if (tid < R1) {
        const int u = base + tid;
        const bool ok = u < row_hi;
        cp_async4(sSqn + ts * R1 + tid,
                  ok ? sqn + static_cast<size_t>(u) * sqn_stride : sqn, ok ? 4 : 0);
      }
      if constexpr (MASKED) {
        const int u = base + (tid >> 1);
        const bool ok = u < row_hi;
        cp_async16(sDM + (ts * R1 + (tid >> 1)) * META + (tid & 1) * 4,
                   ok ? dmeta + static_cast<size_t>(u) * META + (tid & 1) * 4 : dmeta,
                   ok ? 16 : 0);
      }
    }
  };

  // the ring runs NS1 - 1 stages ahead: (ij, ik) is the next stage to fill
  int ij = 0, ik = 0, is = 0;
  auto fill_next = [&]() {
    if (is < n_stages) {
      fill(ij, ik, is % NS1);
      if (++ik == nk) {
        ik = 0;
        ++ij;
        if constexpr (PART) fbase = rows.base(ij, R1);
      }
    }
    ++is;
    cp_async_commit();                    // one group a stage, empty past the end
  };
#pragma unroll
  for (int s = 0; s < NS1 - 1; ++s) fill_next();

  const int tx = tid & 15, ty = tid >> 4;
  auto trow = [&](int i) { return i < 4 ? ty * 4 + i : 64 + ty * 4 + (i - 4); };
  auto rrow = [&](int j) { return j < 4 ? tx * 4 + j : 64 + tx * 4 + (j - 4); };
  float acc[N];                           // [TM][8]: target i, DB row j at 8 i + j
  int jt = 0, ck = 0;
  for (int s = 0; s < n_stages; ++s) {
    cp_async_wait<NS1 - 2>();             // this thread's part of stage s landed
    __syncthreads();                      // everyone's did; stage s - 1 is consumed
    fill_next();                          // into the slot of stage s - 1
    if (ck == 0) {
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i * 8 + j] = 0.f;
    }
    const float* a_col = sT + ck * KC1 * TT + ty * 4;
    const float* b_col = sD + (s % NS1) * KC1 * SD + tx * 4;
#pragma unroll
    for (int cc = 0; cc < KC1; ++cc) {
      float av[TM], bv[8];
#pragma unroll
      for (int h = 0; h < TM / 4; ++h) {
        const float4 a = *reinterpret_cast<const float4*>(a_col + cc * TT + 64 * h);
        av[4 * h] = a.x, av[4 * h + 1] = a.y, av[4 * h + 2] = a.z, av[4 * h + 3] = a.w;
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float4 b = *reinterpret_cast<const float4*>(b_col + cc * SD + 64 * h);
        bv[4 * h] = b.x, bv[4 * h + 1] = b.y, bv[4 * h + 2] = b.z, bv[4 * h + 3] = b.w;
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i * 8 + j] = fmaf(av[i], bv[j], acc[i * 8 + j]);
    }
    if (++ck < nk) continue;
    // the tile's products are complete: scores, screen, selection
    ck = 0;
    const int base = PART ? rows.base(jt, R1) : row_lo + jt * R1;
    const int ts = jt % NS1;
    unsigned long long pass = 0;
    if constexpr (!KEYS && !MASKED) {
      // the common case in two instructions a score: the score itself (a
      // row past the split's end gets sqn +inf and so a +inf score) and one
      // compare with the target's threshold, OR-ed into one flag; the mask
      // of the scores that passed is built only where the flag is set
      float sq[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int r = rrow(j);
        sq[j] = base + r < row_hi ? sSqn[ts * R1 + r] : pos_inf();
      }
      bool hit = false;
#pragma unroll
      for (int h = 0; h < TM / 4; ++h) {
        const int4 wa = *reinterpret_cast<const int4*>(sW + 64 * h + ty * 4);
        const int4 wb = *reinterpret_cast<const int4*>(sW + 64 * h + ty * 4 + 2);
        const int w[4] = {wa.x, wa.z, wb.x, wb.z};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int e = (4 * h + i) * 8 + j;
            acc[e] = fmaf(-2.f, acc[e], sq[j]);
            hit |= acc[e] <= __int_as_float(w[i]);
          }
      }
      if (hit) {
#pragma unroll
        for (int e = 0; e < N; ++e) {
          const bool ok = passes_pair(acc[e], base + rrow(e & 7), sW[trow(e >> 3)]);
          pass |= static_cast<unsigned long long>(ok) << e;
        }
      }
    } else {
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const int t = trow(i);
        const bool t_ok = t0 + t < T;
        const int2 worst = sW[t];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int r = rrow(j);
          const int u = base + r;
          const float sc = fused_score<PART, LING>(
              sSqn[ts * R1 + r] - 2.f * acc[i * 8 + j], sTM + t * META,
              sDM + (ts * R1 + r) * META, pen);
          const int b = ranked_bits<KEYS>(sc, u, t_ok && u < row_hi);
          acc[i * 8 + j] = __int_as_float(b);
          const bool ok = SEL == PACKED3 ? b != KEY_EMPTY
                          : KEYS         ? passes_key(b, worst.x)
                                         : passes_pair(__int_as_float(b), u, worst);
          pass |= static_cast<unsigned long long>(ok) << (i * 8 + j);
        }
      }
    }
    if constexpr (BULK) {
      const int w2 = grp.warp * 2;        // ty of lanes 0-15; lanes 16-31 hold w2 + 1
      warp_select<TM>(
          acc, pass,
          [&](int hh, int i) {
            const int y = w2 + hh;
            return i < 4 ? y * 4 + i : 64 + y * 4 + (i - 4);
          },
          [&](int j) { return base + rrow(j); }, lv, li, sW, k, stv, sti, lane);
    } else {
      sparse_select<SEL, TT>(
          acc, pass, [&](int e) { return trow(e >> 3); },
          [&](int e) { return base + rrow(e & 7); }, sel, grp, jt == n_tiles - 1,
          true, base, t0, T, lane);
    }
    ++jt;
  }
  __syncthreads();
  store_lists<TT>(lv, li, sB3, 1, part_v, part_i, part_third, k, t0, T, split,
                  splits, grp.warp, CtaGroup::warps, lane);
}

// ------------------------------------------------- pass 1, split precisions
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

// Wait until the barrier's phase of this parity has completed.  The loop
// lives inside the asm statement, so that the compiler sees straight-line
// code and keeps the warpgroup's wgmma in flight across it.  2^26 failed
// tries (seconds) mean a lost arrival: trap, so that the launch fails
// instead of hanging the card.
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

// Writes to shared memory by ordinary stores or cp.async, made visible to
// the reads wgmma makes through the async proxy.
__device__ __forceinline__ void fence_async_proxy() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ---------------------------------------------- the cluster of pass 1 (split)
// Target tiles a cluster of topk_partial_split holds over the same DB rows,
// where its launch is clustered (ops/cuda_topk.py::launch_shape decides).
constexpr int CLUSTER = 2;

__device__ __forceinline__ int cluster_rank() {
  int r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// Every thread of every CTA of the cluster (not .aligned: the roles reach
// it at different points of their code).
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\nbarrier.cluster.wait.acquire;\n" ::: "memory");
}

// The shared::cluster address of shared address `a` of this CTA in CTA `rank`.
__device__ __forceinline__ uint32_t cluster_addr(uint32_t a, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(out) : "r"(a), "r"(rank));
  return out;
}

// A store into another CTA's shared memory (shared::cluster address `a`)
// whose bytes, once written, count on that CTA's barrier at `bar` (its
// complete_tx): the producer neither waits for it nor fences.
__device__ __forceinline__ void st_async(uint32_t a, uint32_t v, uint32_t bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];\n" ::"r"(a),
               "r"(v), "r"(bar)
               : "memory");
}

__device__ __forceinline__ void st_async(uint32_t a, int4 v, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], {%1, %2, %3, %4}, "
      "[%5];\n" ::"r"(a),
      "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w), "r"(bar)
      : "memory");
}

// Arrive, and expect `bytes` more on the barrier's current phase.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Arrive on another CTA's barrier (shared::cluster address `a`), only where
// `on` (predicated inside the asm statement, so that the consumers' code
// stays straight-line).
__device__ __forceinline__ void mbar_arrive_remote(uint32_t a, bool on) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %1, 0;\n"
      "@p mbarrier.arrive.shared::cluster.b64 _, [%0];\n}\n" ::"r"(a),
      "r"(static_cast<uint32_t>(on))
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Shared-memory matrix descriptor of a K-major bf16 tile in the 128-byte
// swizzle: rows of 128 bytes, groups of 8 rows 1,024 bytes apart (the
// stride byte offset; the leading byte offset is not used by this layout),
// the tile 1,024-byte aligned.  `addr` may point 32, 64 or 96 bytes into
// the first row: the next 16 columns of the same tile.
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3ffff) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

// d (+)= a * b^T for a 64 x 16 tile a (DB rows) and an N x 16 tile b
// (targets), both bf16 from shared memory, f32 sums in registers.  FIRST:
// d = a * b^T, the sums are written only (scale-d 0), so that they are not
// live between two tiles and the epilogue's values can take their registers.
// Thread (warp w of the group, g = lane / 4, q = lane % 4)
// holds d[4 j + h] = (row 16 w + g + 8 (h / 2), column 8 j + 2 q + h % 2).
template <bool FIRST>
__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t da, uint64_t db) {
  if constexpr (FIRST) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31, "
      " %32, %33, %34, %35, %36, %37, %38, %39, "
      " %40, %41, %42, %43, %44, %45, %46, %47, "
      " %48, %49, %50, %51, %52, %53, %54, %55, "
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]),
        "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7]),
        "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]),
        "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]),
        "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]),
        "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]),
        "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]),
        "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31]),
        "=f"(d[32]), "=f"(d[33]), "=f"(d[34]), "=f"(d[35]),
        "=f"(d[36]), "=f"(d[37]), "=f"(d[38]), "=f"(d[39]),
        "=f"(d[40]), "=f"(d[41]), "=f"(d[42]), "=f"(d[43]),
        "=f"(d[44]), "=f"(d[45]), "=f"(d[46]), "=f"(d[47]),
        "=f"(d[48]), "=f"(d[49]), "=f"(d[50]), "=f"(d[51]),
        "=f"(d[52]), "=f"(d[53]), "=f"(d[54]), "=f"(d[55]),
        "=f"(d[56]), "=f"(d[57]), "=f"(d[58]), "=f"(d[59]),
        "=f"(d[60]), "=f"(d[61]), "=f"(d[62]), "=f"(d[63])
      : "l"(da), "l"(db), "r"(0));
  } else {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31, "
      " %32, %33, %34, %35, %36, %37, %38, %39, "
      " %40, %41, %42, %43, %44, %45, %46, %47, "
      " %48, %49, %50, %51, %52, %53, %54, %55, "
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
  }
}

template <bool FIRST>
__device__ __forceinline__ void wgmma_n64(float (&d)[32], uint64_t da, uint64_t db) {
  if constexpr (FIRST) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]),
        "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7]),
        "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]),
        "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]),
        "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]),
        "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]),
        "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]),
        "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31])
      : "l"(da), "l"(db), "r"(0));
  } else {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
  }
}

template <int TT, bool FIRST>
__device__ __forceinline__ void wgmma_tile(float (&d)[TT / 2], uint32_t a, uint32_t b) {
  if constexpr (TT == 128) {
    wgmma_n128<FIRST>(d, wgmma_desc(a), wgmma_desc(b));
  } else {
    wgmma_n64<FIRST>(d, wgmma_desc(a), wgmma_desc(b));
  }
}

// Keeps the compiler from moving reads or writes of the sums across the
// asynchronous products' fence and wait.
template <int N>
__device__ __forceinline__ void fence_sums(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// bf16 hi / lo split of two neighbouring columns (hi = bf16_rn(x),
// lo = bf16_rn(x - hi), the split of pallas_topk._bf16_split) as packed
// bf16x2 words, the lower column in the low half.
__device__ __forceinline__ void split_pair(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);   // one conversion for both
  hi = *reinterpret_cast<const uint32_t*>(&h);
  // a bf16 is the upper half of its f32
  const float h0 = __uint_as_float(hi << 16), h1 = __uint_as_float(hi & 0xffff0000u);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x0 - h0, x1 - h1);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// Byte offset of 32-bit word w (columns 2 w, 2 w + 1) of row r in a
// 128-byte-swizzled tile of 128-byte rows.
__device__ __forceinline__ int swizzled_word(int r, int w) {
  return r * 128 + ((((w >> 2) ^ (r & 7)) << 4) | ((w & 3) << 2));
}

// Bytes of shared memory topk_partial_split<TT> needs with a ring of ns
// stages (1,024 of them to align the tiles); the kernel carves the same
// regions in the same order.
size_t partial_smem_split(int TT, int kd, int k, bool masked, int sel, int ns) {
  const size_t nch = static_cast<size_t>((kd + KC2 - 1) / KC2);
  return 1024 + 2 * nch * TT * 128 + ns * 2 * HALF2 + 3 * NS2 * 8 + 16 +
         ns * R2 * 4 + (masked ? (ns * R2 + TT) * META * 4 : 0) +
         2 * static_cast<size_t>(TT) * k * 4 + 2 * (3 * QCAP2 + 4) * 4 + TT * 8 +
         (sel == PACKED3 ? 2 * TT * B3 * 4 : 0);
}

// Stages of the ring at this shape: as many of NS2 as fit beside the target
// tile and the lists, two at the least; 0 if not even two fit.
int split_stages(int TT, int kd, int k, bool masked, int sel) {
  for (int ns = NS2; ns >= 2; --ns) {
    if (partial_smem_split(TT, kd, k, masked, sel, ns) <= SMEM_LIMIT) return ns;
  }
  return 0;
}

// Pass 1 at the split precisions.  Threads 0..255: two consumer
// warpgroups; 256..383: the producer warpgroup.  db: f32 rows of row stride
// width, split by the producer; with PRESPLIT, bf16 rows [hi | lo] of row
// stride width = 2 kp elements, copied as they are.  sqn[u * sqn_stride]:
// the squared norm of row u.  Row indices are int and element offsets
// size_t: the capacity block has 8.4 M rows x 153 columns.  The fused masks
// are applied to each score in the epilogue, after the product and before
// the screen, in the order of topk_partial (fused_score).
template <int TT, int PREC, bool PART, bool LING, bool PRESPLIT, int SEL, bool CL>
__global__ void __launch_bounds__(THREADS2, 1)
topk_partial_split(const float* __restrict__ t2, const void* __restrict__ db,
                   const float* __restrict__ sqn, int sqn_stride,
                   const int* __restrict__ tmeta, const int* __restrict__ dmeta,
                   const int* __restrict__ spans, Penalties pen,
                   float* __restrict__ part_v, int* __restrict__ part_i,
                   int* __restrict__ part_third, int T, int kd, int width, int m_rows,
                   int rows_per_split, int k, int splits, int ns) {
  // split3: sums hh, hl, lh; split3cat: one for all three
  constexpr int NACC = PREC == SPLIT3 ? 3 : 1;
  constexpr int HL = NACC == 3 ? 1 : 0, LH = NACC == 3 ? 2 : 0;
  constexpr bool MASKED = PART || LING;
  constexpr bool KEYS = SEL == PACKED || SEL == PACKED3;
  constexpr int N = TT / 2;               // sums a thread: 2 DB rows x TT / 4 targets
  constexpr int QINTS = 3 * QCAP2 + 4;    // a queue: 3 x [QCAP2], then 4 counters
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nch = (kd + KC2 - 1) / KC2;   // stages a DB tile
  unsigned char* p = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* sTh = p;                 // [nch][TT][128 B] targets hi, swizzled
  unsigned char* sTl = sTh + nch * TT * 128;            // lo
  unsigned char* ring = sTl + nch * TT * 128;           // [ns][hi | lo] stages
  // full[w][slot]: the stage in this slot is ready for consumer warpgroup w
  // (each group waits only on its own barriers, so it sees every phase of
  // them and a parity names one phase); empty[slot]: its reader is done
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + ns * 2 * HALF2);
  uint64_t* empty = full + 2 * NS2;
  int* mutex = reinterpret_cast<int*>(empty + NS2);     // the list lock (+ padding)
  float* sSqn = reinterpret_cast<float*>(mutex + 4);    // [ns][R2] sqn with a
                                                        //   tile's last stage
  int* sDM = reinterpret_cast<int*>(sSqn + ns * R2);    // [ns][R2][META] if MASKED
  int* sTM = sDM + (MASKED ? ns * R2 * META : 0);       // [TT][META] if MASKED
  float* lv = reinterpret_cast<float*>(sTM + (MASKED ? TT * META : 0));
  int* li = reinterpret_cast<int*>(lv + TT * k);
  int* queues = li + TT * k;              // one per consumer warpgroup
  int2* sW = reinterpret_cast<int2*>(queues + 2 * QINTS);     // [TT] thresholds
  int* sB3 = reinterpret_cast<int*>(sW + TT);                 // [2][TT][B3] if PACKED3

  const int tid = threadIdx.x, lane = tid & 31;
  // the warpgroup's index, read from lane 0 so that the compiler knows the
  // branches on it to be uniform within a warp (wgmma in a path it takes
  // for divergent is serialized)
  const int wgroup = __shfl_sync(FULL, tid >> 7, 0);
  const int t0 = blockIdx.x * TT;
  const int split = blockIdx.y;
  const auto rows = cta_rows<PART>(spans, blockIdx.x, split, splits, rows_per_split, m_rows, R2);
  const int n_tiles = rows.n_tiles;
  // CL: a clustered launch (never with PART, whose tiles scan rows of their
  // own, nor PRESPLIT, which has no split to share), whose CS CTAs hold
  // neighbouring target tiles over the same rows and fill each stage together
  static_assert(!CL || (!PART && !PRESPLIT), "clusters share f32 rows of one split");
  constexpr int CS = CL ? CLUSTER : 1;

  // the target tile, split once: word w of row t holds columns 2 w, 2 w + 1
  for (int e = tid; e < TT * nch * 32; e += THREADS2) {
    const int t = e / (nch * 32), w = e % (nch * 32);
    const int c = 2 * w;
    const float* row = t2 + static_cast<size_t>(t0 + t) * kd;
    const float x0 = (t0 + t < T && c < kd) ? row[c] : 0.f;
    const float x1 = (t0 + t < T && c + 1 < kd) ? row[c + 1] : 0.f;
    uint32_t hi, lo;
    split_pair(x0, x1, hi, lo);
    const int off = (w >> 5) * TT * 128 + swizzled_word(t, w & 31);
    *reinterpret_cast<uint32_t*>(sTh + off) = hi;
    *reinterpret_cast<uint32_t*>(sTl + off) = lo;
  }
  if constexpr (MASKED) {
    for (int e = tid; e < TT * META; e += THREADS2) {
      const int t = t0 + e / META;
      sTM[e] = t < T ? tmeta[static_cast<size_t>(t) * META + e % META] : -1;
    }
  }
  init_state<SEL>(lv, li, TT * k, sW, TT, T - t0, sB3, 2 * TT * B3, queues + 3 * QCAP2,
                  4, tid, THREADS2);
  if (tid < 4) queues[QINTS + 3 * QCAP2 + tid] = 0;     // the second queue's counters
  if (tid == 0) {
    // full: every producer thread arrives (in a cluster the other CTAs'
    // stores complete bytes it expects); empty: every thread of the
    // consuming group and, in a cluster, each warp of the other CTAs'
    for (int s = 0; s < ns; ++s) {
      mbar_init(full + s, 128);
      mbar_init(full + NS2 + s, 128);
      mbar_init(empty + s, 128 + 4 * (CS - 1));
    }
    *mutex = 0;
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  fence_async_proxy();                    // the target tile, for wgmma
  // in a cluster no CTA touches another's barriers before they are made
  if constexpr (CL) {
    cluster_sync();
  } else {
    __syncthreads();
  }

  if (wgroup == 2) {
    // ---- producer: stage g = (tile g / nch, column block g % nch) into
    // slot g % ns, after the consumer of stage g - ns released it
    const int ptid = tid - 256, pwarp = ptid >> 5;
    const int n_stages = n_tiles * nch;
    // the full barrier of stage g: that of the warpgroup which takes its tile
    auto full_of = [&](int g) {
      const int jt = g / nch;
      return full + ((SEL == PACKED3 ? jt >> 1 : jt) & 1) * NS2 + g % ns;
    };
    // the sqn and metadata rows [r0, r0 + n) of the tile, with its last stage
    auto side_rows = [&](int base, int slot, int r0, int n, auto copy4, auto copy16) {
      if (ptid < n) {
        const int u = base + r0 + ptid;
        copy4(sSqn + slot * R2 + r0 + ptid, sqn + static_cast<size_t>(u) * sqn_stride,
              u < m_rows);
      }
      if constexpr (MASKED) {
        if (ptid < 2 * n) {
          const int r = r0 + (ptid >> 1), u = base + r;
          copy16(sDM + (slot * R2 + r) * META + (ptid & 1) * 4,
                 dmeta + static_cast<size_t>(u) * META + (ptid & 1) * 4, u < m_rows);
        }
      }
    };
    if constexpr (PRESPLIT) {
      const __nv_bfloat16* pre = static_cast<const __nv_bfloat16*>(db);
      const int kp = (kd + KPAD - 1) / KPAD * KPAD;     // columns of a half
      int jt = 0, c = 0, base = rows.base(0, R2);
      for (int g = 0; g < n_stages; ++g) {
        const int slot = g % ns;
        mbar_wait(empty + slot, ((g / ns) & 1) ^ 1);
        unsigned char* stage = ring + slot * 2 * HALF2;
#pragma unroll
        for (int i = 0; i < 8; ++i) {     // 16 bytes: chunk ch of row r of a half
          const int idx = ptid + 128 * i;
          const int half = idx >> 9, r = (idx >> 3) & 63, ch = idx & 7;
          const int u = base + r, col = c * KC2 + ch * 8;
          const bool ok = u < m_rows && col < kp;
          cp_async16(stage + half * HALF2 + r * 128 + ((ch ^ (r & 7)) << 4),
                     ok ? pre + static_cast<size_t>(u) * width + half * kp + col : pre,
                     ok ? 16 : 0);
        }
        if (c == nch - 1) {
          side_rows(
              base, slot, 0, R2,
              [&](float* d, const float* s, bool ok) { cp_async4(d, ok ? s : sqn, ok ? 4 : 0); },
              [&](int* d, const int* s, bool ok) { cp_async16(d, ok ? s : dmeta, ok ? 16 : 0); });
        }
        // this thread's arrival is made by the hardware when its copies have
        // landed, so the producer never waits for data and a stage is handed
        // over as soon as it is whole (the consumer makes it visible to
        // wgmma: fence_async_proxy after its wait)
        cp_async_arrive(full_of(g));
        if (++c == nch) {
          c = 0;
          base = rows.base(++jt, R2);
        }
      }
    } else {
      // f32 rows, split here.  Lane l loads columns 2 l, 2 l + 1 of the
      // block (a warp reads 256 contiguous bytes of a row), rows row0 + 4 i.
      // NSET sets of registers rotate, so that the loads of the next two
      // stages are in flight while one is stored (four, which the registers
      // of a cluster's fewer rows would hold, were slower: PERF.md).  In a
      // cluster the producer of rank r takes rows [r R2 / CS, (r + 1) R2 /
      // CS) of each stage and stores them into the same slot of every CTA's
      // ring: its own by st.shared, the others' by st.async, whose bytes
      // complete on their full barrier of the stage.
      const float* raw = static_cast<const float*>(db);
      constexpr int RPT = R2 / 4 / CS;    // rows a thread loads a stage
      constexpr int NSET = 3;
      constexpr int NP = CS > 1 ? CS - 1 : 1;   // the other CTAs (none alone)
      const int rank = CL ? cluster_rank() : 0;
      const int row0 = rank * (R2 / CS) + pwarp;
      // the other CTAs' shared::cluster address of this CTA's base p: a
      // CTA's shared memory is one window, laid out alike in each
      uint32_t peer[NP];
#pragma unroll
      for (int d = 0; d < CS - 1; ++d) peer[d] = cluster_addr(smem_u32(p), (rank + 1 + d) % CS);
      auto at = [&](int d, const void* q) { return peer[d] + (smem_u32(q) - smem_u32(p)); };
      int ljt = 0, lbase = rows.base(0, R2);  // the tile of the last load, its row
      auto load = [&](int g, float (&x)[2 * RPT]) {
        const int jt = g / nch, c = g - jt * nch;
        const int col = c * KC2 + 2 * lane;
        if (jt != ljt) {
          ljt = jt;
          lbase = rows.base(jt, R2);
        }
        const int base = lbase;
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          const int u = base + row0 + 4 * i;
          const float* src = raw + static_cast<size_t>(u) * width + col;
          x[2 * i] = (u < m_rows && col < kd) ? __ldg(src) : 0.f;
          x[2 * i + 1] = (u < m_rows && col + 1 < kd) ? __ldg(src + 1) : 0.f;
        }
      };
      // bytes a stage brings from each other CTA: its rows' hi and lo,
      // with the tile's last stage their sqn and metadata rows
      auto peer_bytes = [&](int g) {
        return (R2 / CS) * 256 + (g % nch == nch - 1 ? (R2 / CS) * (MASKED ? 36 : 4) : 0);
      };
      auto emit = [&](int g, const float (&x)[2 * RPT]) {
        const int slot = g % ns;
        // split before the wait (the empty asm statement keeps the
        // compiler from sinking it past), so that a freed slot waits for
        // the stores and the arrival alone
        uint32_t hw[RPT], lw[RPT];
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          split_pair(x[2 * i], x[2 * i + 1], hw[i], lw[i]);
          asm volatile("" : "+r"(hw[i]), "+r"(lw[i]));
        }
        // the slot is free once the consumers of every CTA released it
        mbar_wait(empty + slot, ((g / ns) & 1) ^ 1);
        unsigned char* stage = ring + slot * 2 * HALF2;
        uint32_t bar[NP];                 // the others' full barrier of stage g
#pragma unroll
        for (int d = 0; d < CS - 1; ++d) bar[d] = at(d, full_of(g));
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          const int off = swizzled_word(row0 + 4 * i, lane);
          *reinterpret_cast<uint32_t*>(stage + off) = hw[i];
          *reinterpret_cast<uint32_t*>(stage + HALF2 + off) = lw[i];
#pragma unroll
          for (int d = 0; d < CS - 1; ++d) {
            st_async(at(d, stage + off), hw[i], bar[d]);
            st_async(at(d, stage + HALF2 + off), lw[i], bar[d]);
          }
        }
        if (g % nch == nch - 1) {
          side_rows(
              rows.base(g / nch, R2), slot, rank * (R2 / CS), R2 / CS,
              [&](float* d, const float* s, bool ok) {
                const float v = ok ? __ldg(s) : 0.f;
                *d = v;
#pragma unroll
                for (int e = 0; e < CS - 1; ++e) st_async(at(e, d), __float_as_uint(v), bar[e]);
              },
              [&](int* d, const int* s, bool ok) {
                const int4 v =
                    ok ? __ldg(reinterpret_cast<const int4*>(s)) : make_int4(0, 0, 0, 0);
                *reinterpret_cast<int4*>(d) = v;
#pragma unroll
                for (int e = 0; e < CS - 1; ++e) st_async(at(e, d), v, bar[e]);
              });
        }
        if constexpr (!CL) {
          fence_async_proxy();
          mbar_arrive(full_of(g));
        } else {
          // alone, the stores are made visible to wgmma here; in a
          // cluster the consumers fence after their wait, which covers the
          // other CTAs' stores as well.  One thread announces the bytes
          // the others' stores bring.
          if (ptid == 0) {
            mbar_arrive_expect_tx(full_of(g), (CS - 1) * peer_bytes(g));
          } else {
            mbar_arrive(full_of(g));
          }
        }
      };
      float x[NSET][2 * RPT];
#pragma unroll
      for (int j = 0; j < NSET - 1; ++j) {
        if (j < n_stages) load(j, x[j]);
      }
      for (int g = 0; g < n_stages; g += NSET) {
#pragma unroll
        for (int j = 0; j < NSET; ++j) {
          if (g + j < n_stages) {
            if (g + j + NSET - 1 < n_stages) load(g + j + NSET - 1, x[(j + NSET - 1) % NSET]);
            emit(g + j, x[j]);
          }
        }
      }
    }
  } else {
    // ---- consumers: warpgroup wg takes every other DB tile (with PACKED3
    // every other pair of tiles: a 128-row block stays in one group)
    const int wg = wgroup, wtid = tid & 127, wwarp = wtid >> 5;
    const WarpGroup grp = {wtid, wwarp, wg, mutex};
    int* q = queues + wg * QINTS;
    const Select sel = {lv, li, sW, q, q + QCAP2, q + 2 * QCAP2, q + 3 * QCAP2,
                        sB3 + wg * TT * B3, k, QCAP2};
    const int g8 = lane >> 2, q4 = lane & 3;
    const int r0 = wwarp * 16 + g8;       // this thread's DB rows: r0, r0 + 8
    float acc[NACC][N];
    unsigned phases = 0;                  // bit s: parity of full[wg][s]'s next phase
    // a stage read is released to this CTA's producer by every thread and,
    // in a cluster, to each other CTA's producer by lane 0 of each warp
    uint32_t peer_empty[CLUSTER - 1];
    if constexpr (CL) {
      const int rank = cluster_rank();
#pragma unroll
      for (int d = 0; d < CS - 1; ++d) {
        peer_empty[d] = cluster_addr(smem_u32(empty), (rank + 1 + d) % CS);
      }
    }
    auto release = [&](int s) {
      mbar_arrive(empty + s);
      if constexpr (CL) {
#pragma unroll
        for (int d = 0; d < CS - 1; ++d) mbar_arrive_remote(peer_empty[d] + 8 * s, lane == 0);
      }
    };
    for (int jt = 0; jt < n_tiles; ++jt) {
      if ((SEL == PACKED3 ? jt >> 1 : jt) % 2 != wg) continue;
      const int base = rows.base(jt, R2);
      int slot = 0;
      // One stage: all four 16-column steps of its 64 columns, whatever kd
      // (the columns past kd are zero on both sides and add exact zeros;
      // with a step count that depends on kd the compiler takes the wgmma
      // for conditional and waits for each where it is started).  first: the
      // tile's first stage, whose first step starts the sums.
      auto stage = [&](int c, auto first) {
        constexpr bool FIRST = decltype(first)::value;
        const int g = jt * nch + c;
        const int prev = slot;
        slot = g % ns;
        mbar_wait(full + wg * NS2 + slot, phases >> slot & 1);
        phases ^= 1u << slot;
        if constexpr (PRESPLIT) fence_async_proxy();    // the copies, for wgmma
        if constexpr (CL) fence_async_proxy();          // every CTA's stores, for wgmma
        if constexpr (!FIRST) {
#pragma unroll
          for (int a = 0; a < NACC; ++a) fence_sums(acc[a]);
        }
        wgmma_fence();
        const uint32_t a_hi = smem_u32(ring + slot * 2 * HALF2), a_lo = a_hi + HALF2;
        const uint32_t b_hi = smem_u32(sTh + c * TT * 128);
        const uint32_t b_lo = smem_u32(sTl + c * TT * 128);
        wgmma_tile<TT, FIRST>(acc[0], a_hi, b_hi);                   // db_hi . t_hi
        wgmma_tile<TT, FIRST && NACC == 3>(acc[HL], a_hi, b_lo);     // db_hi . t_lo
        wgmma_tile<TT, FIRST && NACC == 3>(acc[LH], a_lo, b_hi);     // db_lo . t_hi
#pragma unroll
        for (int ks = 1; ks < KC2 / 16; ++ks) {
          wgmma_tile<TT, false>(acc[0], a_hi + 32 * ks, b_hi + 32 * ks);
          wgmma_tile<TT, false>(acc[HL], a_hi + 32 * ks, b_lo + 32 * ks);
          wgmma_tile<TT, false>(acc[LH], a_lo + 32 * ks, b_hi + 32 * ks);
        }
        wgmma_commit();
        if constexpr (!FIRST) {           // the stage before this one is read
          wgmma_wait<1>();
          release(prev);
        }
      };
      stage(0, std::true_type{});
      for (int c = 1; c < nch; ++c) stage(c, std::false_type{});
      wgmma_wait<0>();
#pragma unroll
      for (int a = 0; a < NACC; ++a) fence_sums(acc[a]);
      // scores and screen; sqn and metadata rows lie with the last stage
      // (the ranked values get registers of their own: the sums stay
      // untouched outside this straight-line code, or the compiler would
      // wait for every wgmma where it is started)
      unsigned long long pass = 0;
      float vals[N];
      float sq[2] = {sSqn[slot * R2 + r0], sSqn[slot * R2 + r0 + 8]};
      // the tile's last stage goes back to the producer before the scores
      // are formed, unless they read its metadata rows (in a cluster lane 0
      // releases for its warp: after every lane's reads)
      if constexpr (!MASKED) {
        if constexpr (CL) __syncwarp();
        release(slot);
      }
      if constexpr (!KEYS && !MASKED) {
        // the common case in two instructions a score, as in topk_partial
        if (base + r0 >= m_rows) sq[0] = pos_inf();
        if (base + r0 + 8 >= m_rows) sq[1] = pos_inf();
        bool hit = false;
#pragma unroll
        for (int j = 0; j < N / 4; ++j) {
          const int4 w = *reinterpret_cast<const int4*>(sW + 8 * j + 2 * q4);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int e = 4 * j + i;
            float cross = acc[0][e];
            if constexpr (NACC == 3) cross = (acc[0][e] + acc[1][e]) + acc[2][e];
            vals[e] = fmaf(-2.f, cross, sq[i >> 1]);
            hit |= vals[e] <= __int_as_float(i & 1 ? w.z : w.x);
          }
        }
        if (hit) {
#pragma unroll
          for (int e = 0; e < N; ++e) {
            const bool ok = passes_pair(vals[e], base + r0 + 8 * ((e >> 1) & 1),
                                        sW[(e >> 2) * 8 + 2 * q4 + (e & 1)]);
            pass |= static_cast<unsigned long long>(ok) << e;
          }
        }
      } else {
#pragma unroll
        for (int e = 0; e < N; ++e) {
          const int t = (e >> 2) * 8 + 2 * q4 + (e & 1);
          const int h = (e >> 1) & 1;
          const int u = base + r0 + 8 * h;
          float cross = acc[0][e];
          if constexpr (NACC == 3) cross = (acc[0][e] + acc[1][e]) + acc[2][e];
          const float sc = fused_score<PART, LING>(
              sq[h] - 2.f * cross, sTM + t * META,
              sDM + (slot * R2 + r0 + 8 * h) * META, pen);
          const int b = ranked_bits<KEYS>(sc, u, t0 + t < T && u < m_rows);
          vals[e] = __int_as_float(b);
          const int2 worst = sW[t];
          const bool ok = SEL == PACKED3 ? b != KEY_EMPTY
                          : KEYS         ? passes_key(b, worst.x)
                                         : passes_pair(__int_as_float(b), u, worst);
          pass |= static_cast<unsigned long long>(ok) << e;
        }
      }
      if constexpr (MASKED) {
        if constexpr (CL) __syncwarp();
        release(slot);
      }
      auto t_of = [&](int e) { return (e >> 2) * 8 + 2 * q4 + (e & 1); };
      auto u_of = [&](int e) { return base + r0 + 8 * ((e >> 1) & 1); };
      // a 128-row block is two tiles jt & ~1, jt | 1 (chunks and pieces are
      // whole blocks), unless the CTA's rows end after its first
      const bool block_ends = (jt & 1) == 1 || jt + 1 == n_tiles;
      auto queued = [&]() {
        sparse_select<SEL, TT>(vals, pass, t_of, u_of, sel, grp,
                               SEL != PACKED3 && jt + 2 >= n_tiles, block_ends,
                               rows.base(jt & ~1, R2), t0, T, lane);
      };
      if constexpr (SEL == STREAM) {
        if (jt < 2) {
          // the group's first tile: every finite score passed the open
          // thresholds, so it goes into the lists in bulk, not through the
          // queue
          grp.lock();
          group_rounds<N>(vals, pass, t_of, u_of, sel, grp, lane);
          grp.unlock();
        } else {
          queued();
        }
      } else {
        queued();
      }
    }
  }
  __syncthreads();
  store_lists<TT>(lv, li, sB3, 2, part_v, part_i, part_third, k, t0, T, split,
                  splits, tid >> 5, THREADS2 / 32, lane);
  // the other CTAs' consumers may still arrive on this CTA's empty barriers
  if constexpr (CL) cluster_sync();
}

constexpr int WARPS = THREADS / 32;     // warps a CTA of pass 2

// Pass 2: merge each target's `splits` partial lists (ascending, empty
// slots (none, INT_MAX) at their ends) under the (score, index) order, or
// (key, index) with KEYS, whose keys are unpacked here; add comp (T,) (the
// zero-transient form; nullptr: the derived form, scores as ranked).  A
// target takes gw warps (1, 2, 4 or 8: the wrapper gives a target more
// where there are few targets and many splits), a CTA 8 / gw targets.  Warp
// w of a target merges lists w, w + gw, ...: four at a time, their loads
// issued together, each a merge of two sorted sequences (merge_sorted); an
// empty list is skipped.  The target's first warp then merges the gw - 1
// others' lists from shared memory and writes the result; a slot no pair
// reached leaves as (+inf, 0).  part_third (T, splits) and flags (T,), both
// or neither (PACKED3): a target's flag is 1 where the least third key of
// any block lies below the worst key kept (KEY_EMPTY while the list has
// room).
template <bool KEYS>
__global__ void __launch_bounds__(THREADS)
topk_merge(const float* __restrict__ part_v, const int* __restrict__ part_i,
           const float* __restrict__ comp, const int* __restrict__ part_third,
           float* __restrict__ out_v, int* __restrict__ out_i,
           int* __restrict__ flags, int T, int k, int splits, int gw) {
  using V = typename std::conditional<KEYS, int, float>::type;
  __shared__ V sv[WARPS][64];
  __shared__ int si[WARPS][64];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int t = blockIdx.x * (WARPS / gw) + warp / gw;
  const int w = warp % gw;
  const V* pv = reinterpret_cast<const V*>(part_v);
  V l[2] = {none_value<V>(), none_value<V>()};
  int lx[2] = {INT_MAX, INT_MAX};
  if (t < T) {
    const size_t o = static_cast<size_t>(t) * splits * k;
    for (int s0 = w; s0 < splits; s0 += 4 * gw) {
      V c[4][2];
      int cx[4][2];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int s = s0 + q * gw;
        if (s < splits) {
          load_pairs(pv + o + static_cast<size_t>(s) * k, part_i + o + static_cast<size_t>(s) * k,
                     k, c[q], cx[q], lane);
        } else {
          c[q][0] = c[q][1] = none_value<V>();
          cx[q][0] = cx[q][1] = INT_MAX;
        }
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (__shfl_sync(FULL, cx[q][0], 0) != INT_MAX) merge_sorted(l, lx, c[q], cx[q], lane);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    sv[warp][2 * lane + r] = l[r];
    si[warp][2 * lane + r] = lx[r];
  }
  __syncthreads();
  if (t >= T || w != 0) return;
  for (int q = 1; q < gw; ++q) {
    V c[2];
    int cx[2];
    load_pairs(sv[warp + q], si[warp + q], 64, c, cx, lane);
    if (__shfl_sync(FULL, cx[0], 0) != INT_MAX) merge_sorted(l, lx, c, cx, lane);
  }
  const float add = comp != nullptr ? comp[t] : 0.f;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int j = 2 * lane + r;
    if (j < k) {
      float v;
      if constexpr (KEYS) v = from_key(l[r]); else v = l[r];
      out_v[static_cast<size_t>(t) * k + j] = comp != nullptr ? v + add : v;
      out_i[static_cast<size_t>(t) * k + j] = lx[r] == INT_MAX ? 0 : lx[r];
    }
  }
  if constexpr (KEYS) {
    if (flags != nullptr) {
      int third = KEY_EMPTY;
      for (int s = lane; s < splits; s += 32) {
        third = min(third, part_third[static_cast<size_t>(t) * splits + s]);
      }
      third = __reduce_min_sync(FULL, third);
      const int worst = __shfl_sync(FULL, (k - 1) & 1 ? l[1] : l[0], (k - 1) >> 1);
      if (lane == 0) flags[t] = third < worst ? 1 : 0;
    }
  }
}

// Target rows a CTA of pass 1 takes at this shape: 128 where the tile fits
// in shared memory and there are more than 64 targets ("split3" keeps three
// sums a score and stays at 64), else 64; 0 if the shape or the combination
// is not supported.
int tile_rows(int kd, int k, bool masked, int prec, int sel, int T) {
  if (kd < 1 || k < 1 || k > KMAX || prec < HIGHEST || prec > SPLIT3CAT ||
      sel < STREAM || sel > PACKED3) {
    return 0;
  }
  if (prec == HIGHEST) {
    // (the queue's layout, the larger: a STREAM launch takes either)
    return T > 64 && partial_smem_highest(128, kd, k, masked, sel, false) <= SMEM_LIMIT ? 128
                                                                                        : 64;
  }
  return prec == SPLIT3CAT && T > 64 && split_stages(128, kd, k, masked, sel) >= 3
             ? 128
             : 64;
}

// Dynamic shared memory of pass 1 with TT target rows a CTA; 0 if the shape
// or the combination is not supported.
size_t partial_smem(int TT, int kd, int k, bool masked, int prec, int sel) {
  if (tile_rows(kd, k, masked, prec, sel, TT) == 0) return 0;
  if (prec == HIGHEST) return partial_smem_highest(TT, kd, k, masked, sel, false);
  const int ns = split_stages(TT, kd, k, masked, sel);
  // where not even two stages fit, the size that was refused
  return partial_smem_split(TT, kd, k, masked, sel, ns == 0 ? 2 : ns);
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
  return smem == 0 || smem > SMEM_LIMIT || T < 1 || db.rows == nullptr ||
         db.sqn == nullptr || db.width < db.min_width || m_rows < k ||
         splits < 1 || rows_per_split < 1;
}

// Warps pass 2 gives a target: a warp at least two lists, eight warps at
// most.
int merge_warps(int splits) {
  int gw = 1;
  while (gw < WARPS && 4 * gw <= splits) gw *= 2;
  return gw;
}

template <bool KEYS>
int merge(const Outputs& o, const float* comp, int T, int k, int splits,
          cudaStream_t stream) {
  const int gw = merge_warps(splits);
  const int per_cta = WARPS / gw;
  topk_merge<KEYS><<<(T + per_cta - 1) / per_cta, THREADS, 0, stream>>>(
      o.part_v, o.part_i, comp, o.part_third, o.out_v, o.out_i, o.flags, T, k,
      splits, gw);
  return static_cast<int>(cudaGetLastError());
}

struct Shape {
  int T, kd, m_rows, k, splits, rows_per_split;
  int cluster;                            // CTAs a cluster of pass 1: 1 or CLUSTER
};

// Pass 1 with TT target rows a CTA; returns a cudaError_t.
template <int TT, int PREC, bool PART, bool LING, bool PRESPLIT, int SEL>
cudaError_t launch_partial(const float* t2, const Operand& db, const int* tmeta,
                           const int* dmeta, const int* spans, Penalties pen,
                           const Outputs& o, int* part_third, const Shape& s,
                           size_t smem, cudaStream_t stream) {
  const dim3 grid((s.T + TT - 1) / TT, s.splits);
  cudaError_t err;
  if constexpr (PREC == HIGHEST) {
    auto run = [&](auto kernel, bool bulk) {
      const size_t bytes =
          partial_smem_highest(TT, s.kd, s.k, PART || LING, SEL, bulk);
      cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(bytes));
      if (e != cudaSuccess) return e;
      kernel<<<grid, THREADS, bytes, stream>>>(
          t2, static_cast<const float*>(db.rows), db.sqn, db.sqn_stride, tmeta, dmeta,
          spans, pen, o.part_v, o.part_i, part_third, s.T, s.kd, db.width, s.m_rows,
          s.rows_per_split, s.k, s.splits);
      return cudaGetLastError();
    };
    if constexpr (SEL == STREAM) {
      if (s.rows_per_split <= BULK_ROWS) return run(topk_partial<TT, PART, LING, SEL, true>, true);
    }
    return run(topk_partial<TT, PART, LING, SEL, false>, false);
  } else {
    const int ns = split_stages(TT, s.kd, s.k, PART || LING, SEL);
    if (s.cluster == 1) {
      auto kernel = topk_partial_split<TT, PREC, PART, LING, PRESPLIT, SEL, false>;
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(smem));
      if (err != cudaSuccess) return err;
      kernel<<<grid, THREADS2, smem, stream>>>(
          t2, db.rows, db.sqn, db.sqn_stride, tmeta, dmeta, spans, pen, o.part_v, o.part_i,
          part_third, s.T, s.kd, db.width, s.m_rows, s.rows_per_split, s.k, s.splits, ns);
    } else if constexpr (!PART && !PRESPLIT) {
      // clusters of s.cluster neighbouring target tiles of one split, the
      // tile count padded with dead tiles (t0 >= T: thresholds -inf, nothing
      // written) to a whole number of clusters
      auto kernel = topk_partial_split<TT, PREC, PART, LING, PRESPLIT, SEL, true>;
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(smem));
      if (err != cudaSuccess) return err;
      cudaLaunchConfig_t cfg = {};
      cudaLaunchAttribute attr[1];
      attr[0].id = cudaLaunchAttributeClusterDimension;
      attr[0].val.clusterDim.x = s.cluster;
      attr[0].val.clusterDim.y = 1;
      attr[0].val.clusterDim.z = 1;
      cfg.gridDim = dim3((grid.x + s.cluster - 1) / s.cluster * s.cluster, grid.y);
      cfg.blockDim = dim3(THREADS2);
      cfg.dynamicSmemBytes = smem;
      cfg.stream = stream;
      cfg.attrs = attr;
      cfg.numAttrs = 1;
      err = cudaLaunchKernelEx(&cfg, kernel, t2, db.rows, db.sqn, db.sqn_stride, tmeta, dmeta,
                               spans, pen, o.part_v, o.part_i, part_third, s.T, s.kd,
                               db.width, s.m_rows, s.rows_per_split, s.k, s.splits, ns);
      if (err != cudaSuccess) return err;
    } else {
      return cudaErrorInvalidValue;         // launch() refuses it first
    }
  }
  return cudaGetLastError();
}

// Both passes of one variant on `stream`; returns a cudaError_t.  PRESPLIT
// (the derived split3cat operand) must start on a 16-byte boundary; PACKED3
// needs chunks of whole 128-row blocks and its two extra outputs; a chunk
// (rows_per_split) is a whole number of DB tiles.  spans: the per-tile rows
// (cta_rows; PART only), or nullptr for all of [0, m_rows).
template <int PREC, bool PART, bool LING, bool PRESPLIT, int SEL>
int launch(const float* t2, const Operand& db, const float* comp,
           const int* tmeta, const int* dmeta, const int* spans, Penalties pen,
           const Outputs& o, int T, int kd, int m_rows, int k, int splits,
           int rows_per_split, int cluster, cudaStream_t stream) {
  static_assert(!PRESPLIT || PREC == SPLIT3CAT, "only split3cat is pre-split");
  constexpr bool MASKED = PART || LING;
  const int tt = tile_rows(kd, k, MASKED, PREC, SEL, T);
  const size_t smem1 = tt == 0 ? 0 : partial_smem(tt, kd, k, MASKED, PREC, SEL);
  if (bad_shape(smem1, T, db, m_rows, k, splits, rows_per_split) ||
      rows_per_split % (PREC == HIGHEST ? R1 : R2) != 0 ||
      (MASKED && (tmeta == nullptr || dmeta == nullptr)) || (spans != nullptr && !PART) ||
      // without spans a CTA takes one chunk: the splits must cover the rows
      (!PART && static_cast<long long>(splits) * rows_per_split < m_rows) ||
      (PRESPLIT && reinterpret_cast<uintptr_t>(db.rows) % 16 != 0) ||
      (SEL == PACKED3 && (rows_per_split % BLOCK != 0 ||
                          o.part_third == nullptr || o.flags == nullptr)) ||
      // clusters share the f32 rows of one split among the target tiles
      (cluster != 1 && (cluster != CLUSTER || PREC == HIGHEST || PART || PRESPLIT))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int* part_third = SEL == PACKED3 ? o.part_third : nullptr;
  const Shape s = {T, kd, m_rows, k, splits, rows_per_split, cluster};
  cudaError_t err;
  if (tt == 128) {
    if constexpr (PREC == SPLIT3) {
      return static_cast<int>(cudaErrorInvalidValue);   // tile_rows never says so
    } else {
      err = launch_partial<128, PREC, PART, LING, PRESPLIT, SEL>(
          t2, db, tmeta, dmeta, spans, pen, o, part_third, s, smem1, stream);
    }
  } else {
    err = launch_partial<64, PREC, PART, LING, PRESPLIT, SEL>(
        t2, db, tmeta, dmeta, spans, pen, o, part_third, s, smem1, stream);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  Outputs m = o;
  if (SEL != PACKED3) m.part_third = m.flags = nullptr;
  return merge<SEL == PACKED || SEL == PACKED3>(m, comp, T, k, splits, stream);
}

}  // namespace

// Every exported entry point has this signature: three leading pointers
// (the targets, the DB rows and, per form, comp or sqn), the metadata rows
// tmeta (T, 8) and dmeta (m_rows, 8) read by the masked variants only, the
// per-tile rows spans (ceil(T / tile rows), 4) of the partition variants or
// nullptr (cta_rows), the penalties p0..p4 read by the linguistic ones only, the partial and final
// outputs (part_third (T, splits) and flags (T,) written by the packed3
// selection only, null elsewhere), the shape, the split plan and the
// CTAs a cluster of pass 1 (1, or CLUSTER at the split precisions on f32
// rows without the partition mask: ops/cuda_topk.py::launch_shape) and the
// stream.  It launches both passes and returns the cudaError_t of the
// launches.
#define SNK_TOPK_SIGNATURE(NAME, DB_T, THIRD)                                 \
  int NAME(const float* t2, const DB_T* db_rows, const float* THIRD,        \
           const int* tmeta, const int* dmeta, const int* spans, float p0,  \
           float p1, float p2, float p3, float p4, float* part_v,           \
           int* part_i, int* part_third, float* out_v, int* out_i,          \
           int* flags, int T, int kd, int width, int m_rows, int k,         \
           int splits, int rows_per_split, int cluster, cudaStream_t stream)

// Zero-transient form: t2 (T, kd) prescaled targets; db_rows the (q, width)
// raw block, width >= kd + 2, whose column kd is the squared norm; comp (T,).
#define SNK_ZT_ENTRY(NAME, PREC, PART, LING, SEL)                            \
  SNK_TOPK_SIGNATURE(NAME, float, comp) {                                    \
    const Penalties pen = {{p0, p1, p2, p3, p4}};                           \
    const Operand db = {db_rows, width, kd + 2,                             \
                        db_rows == nullptr ? nullptr : db_rows + kd, width}; \
    const Outputs o = {part_v, part_i, part_third, out_v, out_i, flags};    \
    return launch<PREC, PART, LING, false, SEL>(t2, db, comp, tmeta, dmeta,  \
                                                spans, pen, o, T, kd, m_rows, \
                                                k, splits, rows_per_split,   \
                                                cluster, stream);            \
  }

// Derived form: t2 (T, kd) normalised, weighted targets; db_rows the derived
// operand; sqn (m_rows,) its squared row norms.
#define SNK_DV_ENTRY(NAME, PREC, PART, LING, PRESPLIT, SEL)                  \
  SNK_TOPK_SIGNATURE(NAME, void, sqn) {                                      \
    const Penalties pen = {{p0, p1, p2, p3, p4}};                           \
    const int kp = (kd + KPAD - 1) / KPAD * KPAD;                                 \
    const Operand db = {db_rows, width, PRESPLIT ? 2 * kp : kd, sqn, 1};    \
    const Outputs o = {part_v, part_i, part_third, out_v, out_i, flags};    \
    return launch<PREC, PART, LING, PRESPLIT, SEL>(t2, db, nullptr, tmeta,   \
                                                   dmeta, spans, pen, o, T,  \
                                                   kd, m_rows, k, splits,    \
                                                   rows_per_split, cluster,  \
                                                   stream);                  \
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

// The zero-transient form of the preselect at select="stream": twelve
// entry points (precision x fused masks) that read the resident raw block
// [data kd | sqn | ptr] directly, with the DB affine folded into prescaled
// targets t2 and comp added back to the scores
// (snickery_tpu/ops/pallas_topk.py:745-794).  The kernels, the selections,
// their shape on Hopper and their bound are described in topk_preselect.cuh.

#include "topk_preselect.cuh"

extern "C" {

// Dynamic shared memory pass 1 needs at its narrower target tile (64 rows),
// the least a shape must find room for (masked != 0: a variant with fused
// masks; precision: 0 highest, 1 split3, 2 split3cat; select: 0 stream,
// 1 phase, 2 packed, 3 packed3), in either form; 0 if the shape or the
// combination is not supported.
size_t snk_topk_partial_smem(int kd, int k, int masked, int precision,
                             int select) {
  return partial_smem(64, kd, k, masked != 0, precision, select);
}

// Target rows a CTA of pass 1 takes for T targets at this shape (128 or
// 64; 0 if unsupported) and DB rows of one of its tiles at this precision:
// the wrapper's split plan is made of them.
int snk_topk_tile_rows(int kd, int k, int masked, int precision, int select,
                       int T) {
  return tile_rows(kd, k, masked != 0, precision, select, T);
}

int snk_topk_db_tile_rows(int precision) { return precision == HIGHEST ? R1 : R2; }

// Rows of a packed3 block: a packed3 split is a whole number of them.
int snk_topk_block_rows() { return BLOCK; }

// CTAs a clustered launch of pass 1 puts in a cluster (CLUSTER).
int snk_topk_cluster_ctas() { return CLUSTER; }

// Clusters of `cluster` CTAs of pass 1 at "split3cat" (this form, no masks,
// the tile of a large T) at this kd and k that the card holds at once
// (cudaOccupancyMaxActiveClusters); negative: a cudaError_t.
int snk_topk_max_clusters(int kd, int k, int cluster) {
  const int tt = tile_rows(kd, k, false, SPLIT3CAT, STREAM, 1 << 20);
  const size_t smem = tt == 0 ? 0 : partial_smem(tt, kd, k, false, SPLIT3CAT, STREAM);
  if (smem == 0 || smem > SMEM_LIMIT || cluster < 1) {
    return -static_cast<int>(cudaErrorInvalidValue);
  }
  auto kernel = tt == 128 ? &topk_partial_split<128, SPLIT3CAT, false, false, false, STREAM, true>
                          : &topk_partial_split<64, SPLIT3CAT, false, false, false, STREAM, true>;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(cluster, 1, 1);
  cfg.blockDim = dim3(THREADS2, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return -static_cast<int>(err);
  }
  return clusters;
}

SNK_ZT_ENTRIES(, STREAM)

}  // extern "C"

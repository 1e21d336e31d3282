// The zero-transient form of the preselect at select="packed3" (its flags
// returned: "packed3diag"): the twelve entry points of topk_preselect.cu
// (precision x fused masks, the same arguments) with the suffix _packed3,
// running the PACKED3 selection epilogue of topk_preselect.cuh
// (snickery_tpu/ops/pallas_topk.py:309-411, :521-554, :917-936).

#include "topk_preselect.cuh"

extern "C" {

SNK_ZT_ENTRIES(_packed3, PACKED3)

}  // extern "C"

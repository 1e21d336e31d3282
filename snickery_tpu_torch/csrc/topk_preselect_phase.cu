// The zero-transient form of the preselect at select="phase": the twelve
// entry points of topk_preselect.cu (precision x fused masks, the same
// arguments) with the suffix _phase, running the PHASE selection epilogue of
// topk_preselect.cuh (snickery_tpu/ops/pallas_topk.py:572-641).

#include "topk_preselect.cuh"

extern "C" {

SNK_ZT_ENTRIES(_phase, PHASE)

}  // extern "C"

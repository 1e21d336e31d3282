// The zero-transient form of the preselect at select="packed": the twelve
// entry points of topk_preselect.cu (precision x fused masks, the same
// arguments) with the suffix _packed, running the PACKED selection epilogue
// of topk_preselect.cuh (snickery_tpu/ops/pallas_topk.py:212-306, :521-554).

#include "topk_preselect.cuh"

extern "C" {

SNK_ZT_ENTRIES(_packed, PACKED)

}  // extern "C"

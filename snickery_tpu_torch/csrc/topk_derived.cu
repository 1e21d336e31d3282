// The derived-operand form of the preselect (zero_transient=False,
// snickery_tpu/ops/pallas_topk.py:795-811): twelve entry points that read
// the normalised, weighted operand the wrapper derives each step and a
// separate (m_rows,) vector of its squared row norms, with the normalised,
// weighted targets themselves and nothing added back to the scores.  At
// "highest" and "split3" the operand is (m_rows, kd) f32 (width kd); at
// "split3cat" it is pre-split, (m_rows, 2 kp) bf16 rows [hi | lo] (width
// 2 kp, kp = kd rounded up to KC), staged with 16-byte loads.  Shared
// memory, shape of the work and bound: topk_preselect.cuh.

#include "topk_preselect.cuh"

extern "C" {

// t2 (T, kd) normalised, weighted targets; db_rows the derived operand;
// sqn (m_rows,) its squared row norms.
#define SNK_DV_ENTRY(NAME, PREC, PART, LING, PRESPLIT)                       \
  SNK_TOPK_SIGNATURE(NAME, void, sqn) {                                      \
    const Penalties pen = {{p0, p1, p2, p3, p4}};                           \
    const int kp = (kd + KC - 1) / KC * KC;                                 \
    const Operand db = {db_rows, width, PRESPLIT ? 2 * kp : kd, sqn, 1};    \
    return launch<PREC, PART, LING, PRESPLIT>(t2, db, nullptr, tmeta, dmeta, \
                                              pen, part_v, part_i, out_v,    \
                                              out_i, T, kd, m_rows, k,       \
                                              splits, rows_per_split,        \
                                              stream);                       \
  }

SNK_DV_ENTRY(snk_topk_preselect_dv, HIGHEST, false, false, false)
SNK_DV_ENTRY(snk_topk_preselect_dv_part, HIGHEST, true, false, false)
SNK_DV_ENTRY(snk_topk_preselect_dv_ling, HIGHEST, false, true, false)
SNK_DV_ENTRY(snk_topk_preselect_dv_ling_part, HIGHEST, true, true, false)
SNK_DV_ENTRY(snk_topk_preselect_dv_split3, SPLIT3, false, false, false)
SNK_DV_ENTRY(snk_topk_preselect_dv_split3_part, SPLIT3, true, false, false)
SNK_DV_ENTRY(snk_topk_preselect_dv_split3_ling, SPLIT3, false, true, false)
SNK_DV_ENTRY(snk_topk_preselect_dv_split3_ling_part, SPLIT3, true, true, false)
SNK_DV_ENTRY(snk_topk_preselect_dv_split3cat, SPLIT3CAT, false, false, true)
SNK_DV_ENTRY(snk_topk_preselect_dv_split3cat_part, SPLIT3CAT, true, false, true)
SNK_DV_ENTRY(snk_topk_preselect_dv_split3cat_ling, SPLIT3CAT, false, true, true)
SNK_DV_ENTRY(snk_topk_preselect_dv_split3cat_ling_part, SPLIT3CAT, true, true,
             true)

#undef SNK_DV_ENTRY

}  // extern "C"

// The zero-transient form of the preselect: twelve entry points that read
// the resident raw block [data kd | sqn | ptr] directly, with the DB affine
// folded into prescaled targets t2 and comp added back to the scores
// (snickery_tpu/ops/pallas_topk.py:745-794).  The kernels, their shape on
// Hopper and their bound are described in topk_preselect.cuh.

#include "topk_preselect.cuh"

extern "C" {

// Dynamic shared memory pass 1 needs (masked != 0: a variant with fused
// masks; precision: 0 highest, 1 split3, 2 split3cat), in either form; 0 if
// the shape or the combination is not supported.
size_t snk_topk_partial_smem(int kd, int k, int masked, int precision) {
  return partial_smem(kd, k, masked != 0, precision);
}

int snk_topk_tile_rows() { return TT; }

int snk_topk_db_tile_rows() { return R; }

// t2 (T, kd) prescaled targets; db_rows the (q, width) raw block, width >=
// kd + 2, whose column kd is the squared norm; comp (T,).
#define SNK_ZT_ENTRY(NAME, PREC, PART, LING)                                 \
  SNK_TOPK_SIGNATURE(NAME, float, comp) {                                    \
    const Penalties pen = {{p0, p1, p2, p3, p4}};                           \
    const Operand db = {db_rows, width, kd + 2,                             \
                        db_rows == nullptr ? nullptr : db_rows + kd, width}; \
    return launch<PREC, PART, LING, false>(t2, db, comp, tmeta, dmeta, pen,  \
                                           part_v, part_i, out_v, out_i, T,  \
                                           kd, m_rows, k, splits,            \
                                           rows_per_split, stream);          \
  }

SNK_ZT_ENTRY(snk_topk_preselect_zt, HIGHEST, false, false)
SNK_ZT_ENTRY(snk_topk_preselect_zt_part, HIGHEST, true, false)
SNK_ZT_ENTRY(snk_topk_preselect_zt_ling, HIGHEST, false, true)
SNK_ZT_ENTRY(snk_topk_preselect_zt_ling_part, HIGHEST, true, true)
SNK_ZT_ENTRY(snk_topk_preselect_zt_split3, SPLIT3, false, false)
SNK_ZT_ENTRY(snk_topk_preselect_zt_split3_part, SPLIT3, true, false)
SNK_ZT_ENTRY(snk_topk_preselect_zt_split3_ling, SPLIT3, false, true)
SNK_ZT_ENTRY(snk_topk_preselect_zt_split3_ling_part, SPLIT3, true, true)
SNK_ZT_ENTRY(snk_topk_preselect_zt_split3cat, SPLIT3CAT, false, false)
SNK_ZT_ENTRY(snk_topk_preselect_zt_split3cat_part, SPLIT3CAT, true, false)
SNK_ZT_ENTRY(snk_topk_preselect_zt_split3cat_ling, SPLIT3CAT, false, true)
SNK_ZT_ENTRY(snk_topk_preselect_zt_split3cat_ling_part, SPLIT3CAT, true, true)

#undef SNK_ZT_ENTRY

}  // extern "C"

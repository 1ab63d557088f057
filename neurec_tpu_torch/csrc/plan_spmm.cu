// K2: plan SpMM, out = A @ x over the chunked-COO scatter plan, for sm_90a,
// with x in f32 or bf16 and the output f32. Over the plan of A^T the same
// kernel computes the backward A^T @ g (ops/graph.py::PlanSpmm), as the TPU
// design does.
//
// Replaces the Pallas TPU kernel neurec_tpu/ops/pallas_spmm.py
// ::_scatter_kernel (driven by scatter_arrays / plan_spmm / make_spmm):
// out[chunk_tile[i]*tile_r + rows[i,e]] += vals[i,e] * x[cols[i,e]].
// The TPU design gathers x in XLA first, an E x d intermediate (~89 MB per
// layer at gowalla), and sums a chunk with a one-hot matmul; here the gather
// is fused, and the work is split by the plan's edge-balanced schedule, not
// by row tile: the design, the bound and the sum order are in
// plan_spmm_core.cuh, which K3 shares.
//
// K2 addresses the plan's arrays as they are (a value's position is its
// plan position), and its lanes split a load by the row's width: a 256 B
// f32 slab row takes 16 lanes of 16 bytes, so one cp.async instruction of
// the warp fetches two edges' rows; a bf16 row takes 8 lanes, four rows.

#include "plan_spmm_core.cuh"

namespace {

struct PlanIndex {
  __device__ __forceinline__ int operator()(int p) const { return p; }
};

template <typename T>
int launch(const neurec::Schedule& sc, const float* vals, const void* x, float* out,
           float* partial, int d, cudaStream_t stream) {
  const int esize = (int)sizeof(T);
  const int unit = neurec::pick_unit(d, esize, 1);
  if (unit == 0) return (int)cudaErrorInvalidValue;
  return neurec::dispatch_unit<T>(unit, sc, vals, PlanIndex{}, x, out, partial, d,
                                  neurec::lanes_for(d, esize, unit), stream);
}

}  // namespace

// perm, cols, row_ptr, spans (n_spans x 4), split (n_split x 3): the plan's
// schedule (ops/spmm.py::SpmmSchedule); vals: the plan's values; partial:
// n_spans x d f32 scratch; x aligned to 16 bytes, d * sizeof(x) a multiple
// of 4; x_bf16: 0 for f32 features, 1 for bf16 ones
extern "C" int neurec_plan_spmm(const int32_t* perm, const int32_t* cols, const int32_t* row_ptr,
                                const int32_t* spans, const int32_t* split, const float* vals,
                                const void* x, float* out, float* partial, int n_spans,
                                int n_split, int d, int x_bf16, cudaStream_t stream) {
  if (n_spans <= 0 || d <= 0) return 0;
  const neurec::Schedule sc{perm, cols, row_ptr, reinterpret_cast<const int4*>(spans), split,
                            n_spans, n_split};
  return x_bf16 ? launch<__nv_bfloat16>(sc, vals, x, out, partial, d, stream)
                : launch<float>(sc, vals, x, out, partial, d, stream);
}

extern "C" const char* neurec_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

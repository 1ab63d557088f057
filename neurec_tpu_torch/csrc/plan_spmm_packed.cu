// K3: lane-packed plan SpMM, out = A @ x over the parity-grouped chunked-COO
// plan, for sm_90a; x in f32 or bf16, pack 2 or 4, the output f32. Over the
// plan of A^T the same kernel computes the backward A^T @ g.
//
// Replaces the Pallas TPU kernel neurec_tpu/ops/pallas_spmm.py
// ::_scatter_kernel_packed (driven by plan_spmm_packed, and through
// plan_spmm / make_spmm under NEUREC_SPMM_PACK=2/4). Its contract: for chunk
// i, parity group h and packed row j,
//   out[chunk_tile[i]*tile_r + rows_p[i*pack+h, j]] +=
//       vals_p[i*pack+h, j] * x[cols[i, j*pack+h]],
// with rows_p / vals_p of shape (n_chunks*pack, chunk/pack) and cols the
// plan's (n_chunks, chunk).
//
// What packing means on this card. On the TPU a (N, 64) gathered operand is
// padded to 128 lanes, and packing `pack` edges into one 128-lane row
// restores full lane density. The H100 has no lane padding; what it rewards
// is wide, coalesced loads. Here `pack` is the number of edges whose rows
// one cp.async instruction of the warp fetches: the lanes split into `pack`
// groups of 32/pack, each lane copying the widest unit (up to 16 bytes) that
// keeps its group busy (d = 64 f32 at pack 2: 16 lanes x 16 B, one 256 B
// row a group; at pack 4, 8 lanes x 2 x 16 B; bf16 at pack 2 8 B a lane, at
// pack 4 16 B).
//
// The work is split, and every row summed, by the plan's edge-balanced
// schedule, in the core K2 shares (plan_spmm_core.cuh). The schedule lists
// plan positions; K3 maps each to its parity-grouped position to read the
// edge value from vals_p (the row and the column come from the schedule).
// The sum order per (row, column) is therefore K2's, and K3 gives K2's bits
// over the same plan.

#include "plan_spmm_core.cuh"

namespace {

// plan position p = i * chunk + j * PACK + h -> (i * PACK + h) * (chunk / PACK) + j
template <int PACK>
struct PackedIndex {
  int chunk;
  __device__ __forceinline__ int operator()(int p) const {
    const int i = p / chunk, pos = p - i * chunk;
    return (i * PACK + pos % PACK) * (chunk / PACK) + pos / PACK;
  }
};

template <typename T, int PACK>
int launch(const neurec::Schedule& sc, const float* vals_p, const void* x, float* out,
           float* partial, int chunk, int d, cudaStream_t stream) {
  constexpr int lanes = 32 / PACK;
  const int unit = neurec::pick_unit(d, (int)sizeof(T), lanes);
  if (unit == 0) return (int)cudaErrorInvalidValue;
  return neurec::dispatch_unit<T>(unit, sc, vals_p, PackedIndex<PACK>{chunk}, x, out, partial, d,
                                  lanes, stream);
}

}  // namespace

// The schedule and scratch as for neurec_plan_spmm; vals_p the parity-grouped
// values; pack: 2 or 4 (chunk a multiple of pack); x aligned to 16 bytes,
// d * sizeof(x) a multiple of 4; x_bf16: 0 for f32 features, 1 for bf16 ones
extern "C" int neurec_plan_spmm_packed(const int32_t* perm, const int32_t* cols,
                                       const int32_t* row_ptr, const int32_t* spans,
                                       const int32_t* split, const float* vals_p, const void* x,
                                       float* out, float* partial, int n_spans, int n_split,
                                       int chunk, int d, int pack, int x_bf16,
                                       cudaStream_t stream) {
  if (n_spans <= 0 || d <= 0) return 0;
  if ((pack != 2 && pack != 4) || chunk % pack != 0) return (int)cudaErrorInvalidValue;
  const neurec::Schedule sc{perm, cols, row_ptr, reinterpret_cast<const int4*>(spans), split,
                            n_spans, n_split};
  if (x_bf16)
    return pack == 2 ? launch<__nv_bfloat16, 2>(sc, vals_p, x, out, partial, chunk, d, stream)
                     : launch<__nv_bfloat16, 4>(sc, vals_p, x, out, partial, chunk, d, stream);
  return pack == 2 ? launch<float, 2>(sc, vals_p, x, out, partial, chunk, d, stream)
                   : launch<float, 4>(sc, vals_p, x, out, partial, chunk, d, stream);
}

extern "C" const char* neurec_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

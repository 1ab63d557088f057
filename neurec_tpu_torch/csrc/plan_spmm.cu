// K2: plan SpMM, out = A @ x over the chunked-COO scatter plan, for sm_90a,
// with x in f32 or bf16 (one template over the x type) and the output f32.
// Over the plan of A^T the same kernel computes the backward A^T @ g
// (ops/graph.py::PlanSpmm), as the TPU design does.
//
// Replaces the Pallas TPU kernel neurec_tpu/ops/pallas_spmm.py
// ::_scatter_kernel (driven by scatter_arrays / plan_spmm / make_spmm):
// out[chunk_tile[i]*tile_r + rows[i,e]] += vals[i,e] * x[cols[i,e]].
// The plan is the JAX package's, array for array; tile_ptr (n_tiles + 1)
// lists each row tile's chunks, tile_ptr[t] .. tile_ptr[t+1] - 1.
//
// What bounds it on the H100: bytes. At gowalla (68,404 nodes, ~350k
// edges, d=64) the work is ~45 MFLOP against ~40 MB that must move (x read
// once, the plan arrays, the output written once): ~12 us at 3.35 TB/s.
// In practice the random gather of x rows (256 B each) and its latency
// decide the time.
//
// Design: one block per output row tile (tile_r rows) and 64-column feature
// slab (grid.y covers wider d). The block zeroes a tile_r x 64 f32
// accumulator in shared memory (64 KB at tile_r=256, dynamic shared memory
// opt-in) — which also covers the empty tiles that own one all-padding
// chunk — and walks its tile's chunks. The TPU design gathers x in XLA
// first, an E x d intermediate (~89 MB per layer at gowalla); here the
// gather is fused: each warp reads 32 edges at a time, keeps the edges whose
// destination row it owns (row % warps == warp), and for each, in plan
// order, adds vals * x[col] to that row, one column per lane. Every
// (row, column) is therefore summed by one thread in plan order: no
// atomics, the same bits on every run, and each output row is written to
// device memory once. Up to four owned edges have their x rows loaded
// before the adds, to keep several gathers in flight per warp. Zero-valued
// (padding) edges are skipped.
//
// bf16: the TPU kernel casts its selector to the feature type
// (sel.astype(g.dtype)), so the edge values are rounded to bf16 as well as
// x; each product of two bf16 values is exact in f32, and the sums and the
// output stay f32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int SLAB = 64;    // feature columns per block
constexpr int WARPS = 16;
constexpr int THREADS = WARPS * 32;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// an edge value as the products see it: rounded to the feature type
template <typename T>
__device__ __forceinline__ float selector(float v) { return v; }
template <>
__device__ __forceinline__ float selector<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
plan_spmm_kernel(const int32_t* __restrict__ rows, const int32_t* __restrict__ cols,
                 const float* __restrict__ vals, const int32_t* __restrict__ tile_ptr,
                 const T* __restrict__ x, float* __restrict__ out, int chunk,
                 int tile_r, int n_rows, int d) {
  extern __shared__ float acc[];  // [tile_r][SLAB]
  const int tile = blockIdx.x;
  const int c0 = blockIdx.y * SLAB;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  for (int i = threadIdx.x; i < tile_r * SLAB; i += THREADS) acc[i] = 0.f;
  __syncthreads();

  const int ca = c0 + lane, cb = c0 + lane + 32;
  const bool va = ca < d, vb = cb < d;
  const long long e_end = (long long)tile_ptr[tile + 1] * chunk;
  for (long long base = (long long)tile_ptr[tile] * chunk; base < e_end; base += 32) {
    const long long e = base + lane;
    int r = 0, c = 0;
    float v = 0.f;
    if (e < e_end) {
      v = selector<T>(vals[e]);
      r = rows[e];
      c = cols[e];
    }
    unsigned own = __ballot_sync(FULL, v != 0.f && r % WARPS == warp);
    while (own) {  // warp-uniform
      int src[4];
      int n = 0;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        src[q] = 0;
        if (own) {
          src[q] = __ffs(own) - 1;
          own &= own - 1;
          n = q + 1;
        }
      }
      int rr[4];
      float vv[4], xa[4], xb[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        rr[q] = __shfl_sync(FULL, r, src[q]);
        const int cc = __shfl_sync(FULL, c, src[q]);
        vv[q] = __shfl_sync(FULL, v, src[q]);
        const T* xr = x + (long long)cc * d;
        xa[q] = (q < n && va) ? to_f32(xr[ca]) : 0.f;
        xb[q] = (q < n && vb) ? to_f32(xr[cb]) : 0.f;
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (q < n) {
          float* ar = acc + rr[q] * SLAB;
          ar[lane] = fmaf(vv[q], xa[q], ar[lane]);
          ar[lane + 32] = fmaf(vv[q], xb[q], ar[lane + 32]);
        }
      }
    }
  }
  __syncthreads();

  const long long row0 = (long long)tile * tile_r;
  for (int i = threadIdx.x; i < tile_r * SLAB; i += THREADS) {
    const int r = i / SLAB, j = i % SLAB;
    if (row0 + r < n_rows && c0 + j < d) out[(row0 + r) * d + c0 + j] = acc[i];
  }
}

template <typename T>
int launch(const int32_t* rows, const int32_t* cols, const float* vals, const int32_t* tile_ptr,
           const void* x, float* out, int n_tiles, int chunk, int tile_r, int n_rows, int d,
           cudaStream_t stream) {
  const int smem = tile_r * SLAB * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(plan_spmm_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(n_tiles, (d + SLAB - 1) / SLAB);
  plan_spmm_kernel<T><<<grid, THREADS, smem, stream>>>(
      rows, cols, vals, tile_ptr, static_cast<const T*>(x), out, chunk, tile_r, n_rows, d);
  return (int)cudaGetLastError();
}

}  // namespace

// x_bf16: 0 for f32 features, 1 for bf16 ones
extern "C" int neurec_plan_spmm(const int32_t* rows, const int32_t* cols, const float* vals,
                                const int32_t* tile_ptr, const void* x, float* out,
                                int n_tiles, int chunk, int tile_r, int n_rows, int d,
                                int x_bf16, cudaStream_t stream) {
  if (n_tiles <= 0 || d <= 0) return 0;
  return x_bf16 ? launch<__nv_bfloat16>(rows, cols, vals, tile_ptr, x, out, n_tiles, chunk, tile_r,
                                        n_rows, d, stream)
                : launch<float>(rows, cols, vals, tile_ptr, x, out, n_tiles, chunk, tile_r, n_rows,
                                d, stream);
}

extern "C" const char* neurec_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

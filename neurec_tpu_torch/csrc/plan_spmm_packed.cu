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
// plan's (n_chunks, chunk). tile_ptr (n_tiles + 1) lists each row tile's
// chunks, as for K2.
//
// What packing means on this card. On the TPU a (N, 64) gathered operand is
// padded to 128 lanes, and packing `pack` edges into one 128-lane row
// restores full lane density. The H100 has no lane padding; what it rewards
// is wide, coalesced loads. So one warp-wide load fetches `pack` edges'
// feature rows at once: lanes split into `pack` groups of 32/pack, each lane
// reading 2*pack consecutive columns of its group's edge (d = 64 f32 at pack
// 2: 16 lanes x 16 B = one 256 B row per half warp; at pack 4, 8 lanes x
// 2 x 16 B; bf16 rows take 8 B per lane at pack 2 and 16 B at pack 4). The
// gather is fused, as in K2: no (E/pack, pack*d) intermediate.
//
// Sum order. A packed load groups edges by position in the chunk, while K2's
// determinism comes from grouping by destination row. This kernel keeps
// K2's: one block per row tile and 64-column slab, a shared-memory f32
// accumulator of tile_r x 64, warps owning rows (row % 16 == warp); each
// warp takes its owned edges in plan order, four at a time (4/pack loads),
// and adds them group after group with a __syncwarp between, since two
// edges of one load may share a destination row. Every (row, column) is
// therefore summed by fmaf in plan order, with no atomics: the same bits on
// every run, and the same bits as K2 over the same plan.
//
// What bounds it: bytes, as K2 (x read once, the plan arrays, the output
// written once; ~12 us at gowalla). The random gather's latency decides the
// time in practice.
//
// bf16: the edge values are rounded to bf16 as the TPU kernel's
// sel.astype(g.dtype) does; products of two bf16 values are exact in f32,
// the sums stay f32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int SLAB = 64;  // feature columns per block
constexpr int WARPS = 16;
constexpr int THREADS = WARPS * 32;
constexpr int EDGES = 4;  // owned edges taken per step of a warp
constexpr unsigned FULL = 0xffffffffu;

template <typename T>
__device__ __forceinline__ float selector(float v) { return v; }
template <>
__device__ __forceinline__ float selector<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// C consecutive features from p (aligned to C * sizeof(T)), as f32
template <int C>
__device__ __forceinline__ void load_cols(const float* __restrict__ p, float (&f)[C]) {
#pragma unroll
  for (int k = 0; k < C / 4; ++k) {
    const float4 q = reinterpret_cast<const float4*>(p)[k];
    f[4 * k] = q.x;
    f[4 * k + 1] = q.y;
    f[4 * k + 2] = q.z;
    f[4 * k + 3] = q.w;
  }
}

template <int C>
__device__ __forceinline__ void load_cols(const __nv_bfloat16* __restrict__ p, float (&f)[C]) {
  uint32_t w[C / 2];
  if constexpr (C == 8) {
    const uint4 q = *reinterpret_cast<const uint4*>(p);
    w[0] = q.x; w[1] = q.y; w[2] = q.z; w[3] = q.w;
  } else {
    const uint2 q = *reinterpret_cast<const uint2*>(p);
    w[0] = q.x; w[1] = q.y;
  }
#pragma unroll
  for (int k = 0; k < C / 2; ++k) {  // the lower address is the low half
    f[2 * k] = __uint_as_float(w[k] << 16);
    f[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
  }
}

template <typename T, int PACK>
__global__ void __launch_bounds__(THREADS)
plan_spmm_packed_kernel(const int32_t* __restrict__ rows_p, const int32_t* __restrict__ cols,
                        const float* __restrict__ vals_p, const int32_t* __restrict__ tile_ptr,
                        const T* __restrict__ x, float* __restrict__ out, int chunk, int tile_r,
                        int n_rows, int d) {
  constexpr int L = 32 / PACK;       // lanes per edge of a load
  constexpr int C = SLAB / L;        // columns per lane: 4 at pack 2, 8 at pack 4
  constexpr int LOADS = EDGES / PACK;
  extern __shared__ float4 acc4[];   // [tile_r][SLAB / 4]
  float* acc = reinterpret_cast<float*>(acc4);
  const int tile = blockIdx.x;
  const int c0 = blockIdx.y * SLAB;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int grp = lane / L;                 // which edge of a load this lane fetches
  const int col = c0 + (lane % L) * C;      // C divides d: all C columns in range, or none
  const bool has_col = col < d;
  const int cpp = chunk / PACK;

  for (int i = threadIdx.x; i < tile_r * SLAB; i += THREADS) acc[i] = 0.f;
  __syncthreads();

  const long long e_end = (long long)tile_ptr[tile + 1] * chunk;
  for (long long base = (long long)tile_ptr[tile] * chunk; base < e_end; base += 32) {
    // lane t reads edge base + t in plan order: chunk i, position j*PACK + h,
    // stored at row i*PACK + h, column j of the parity-grouped arrays
    const long long e = base + lane;
    int r = 0, c = 0;
    float v = 0.f;
    if (e < e_end) {
      const long long i = e / chunk;
      const int pos = (int)(e - i * chunk);
      const long long p = (i * PACK + pos % PACK) * cpp + pos / PACK;
      v = selector<T>(vals_p[p]);
      r = rows_p[p];
      c = cols[e];
    }
    unsigned own = __ballot_sync(FULL, v != 0.f && r % WARPS == warp);
    while (own) {  // warp-uniform
      int src[EDGES];
      int n = 0;
#pragma unroll
      for (int q = 0; q < EDGES; ++q) {
        src[q] = 0;
        if (own) {
          src[q] = __ffs(own) - 1;
          own &= own - 1;
          n = q + 1;
        }
      }
      // load b: this lane's group fetches owned edge b*PACK + grp
      int rr[LOADS];
      float vv[LOADS];
      bool act[LOADS];
      float f[LOADS][C];
#pragma unroll
      for (int b = 0; b < LOADS; ++b) {
        const int q = b * PACK + grp;
        int mine = src[0];
#pragma unroll
        for (int k = 1; k < EDGES; ++k) mine = (q == k) ? src[k] : mine;
        rr[b] = __shfl_sync(FULL, r, mine);
        const int cc = __shfl_sync(FULL, c, mine);
        vv[b] = __shfl_sync(FULL, v, mine);
        act[b] = q < n && has_col;
        if (act[b]) load_cols<C>(x + (long long)cc * d + col, f[b]);
      }
      // the adds in plan order (edge b*PACK + h), one group at a time
#pragma unroll
      for (int b = 0; b < LOADS; ++b) {
#pragma unroll
        for (int h = 0; h < PACK; ++h) {
          if (act[b] && grp == h) {
            float4* a = acc4 + rr[b] * (SLAB / 4) + (col - c0) / 4;
#pragma unroll
            for (int k = 0; k < C / 4; ++k) {
              float4 t = a[k];
              t.x = fmaf(vv[b], f[b][4 * k], t.x);
              t.y = fmaf(vv[b], f[b][4 * k + 1], t.y);
              t.z = fmaf(vv[b], f[b][4 * k + 2], t.z);
              t.w = fmaf(vv[b], f[b][4 * k + 3], t.w);
              a[k] = t;
            }
          }
          __syncwarp();
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

template <typename T, int PACK>
int launch(const int32_t* rows_p, const int32_t* cols, const float* vals_p,
           const int32_t* tile_ptr, const void* x, float* out, int n_tiles, int chunk,
           int tile_r, int n_rows, int d, cudaStream_t stream) {
  const int smem = tile_r * SLAB * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(plan_spmm_packed_kernel<T, PACK>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(n_tiles, (d + SLAB - 1) / SLAB);
  plan_spmm_packed_kernel<T, PACK><<<grid, THREADS, smem, stream>>>(
      rows_p, cols, vals_p, tile_ptr, static_cast<const T*>(x), out, chunk, tile_r, n_rows, d);
  return (int)cudaGetLastError();
}

}  // namespace

// pack: 2 or 4 (d a multiple of 2*pack, x aligned to 16 bytes);
// x_bf16: 0 for f32 features, 1 for bf16 ones
extern "C" int neurec_plan_spmm_packed(const int32_t* rows_p, const int32_t* cols,
                                       const float* vals_p, const int32_t* tile_ptr,
                                       const void* x, float* out, int n_tiles, int chunk,
                                       int tile_r, int n_rows, int d, int pack, int x_bf16,
                                       cudaStream_t stream) {
  if (n_tiles <= 0 || d <= 0) return 0;
  if ((pack != 2 && pack != 4) || chunk % pack != 0 || d % (2 * pack) != 0)
    return (int)cudaErrorInvalidValue;
#define NEUREC_LAUNCH(T, P) \
  launch<T, P>(rows_p, cols, vals_p, tile_ptr, x, out, n_tiles, chunk, tile_r, n_rows, d, stream)
  if (x_bf16) return pack == 2 ? NEUREC_LAUNCH(__nv_bfloat16, 2) : NEUREC_LAUNCH(__nv_bfloat16, 4);
  return pack == 2 ? NEUREC_LAUNCH(float, 2) : NEUREC_LAUNCH(float, 4);
#undef NEUREC_LAUNCH
}

extern "C" const char* neurec_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

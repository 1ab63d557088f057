// The device-side core of K2 (plan_spmm.cu) and K3 (plan_spmm_packed.cu):
// A @ x over a chunked-COO plan, walked along the plan's edge-balanced
// schedule (ops/spmm.py::spmm_schedule), for sm_90a. x is f32 or bf16, the
// output f32.
//
// Why a schedule. The plan groups edges by 256-row tile, and the degrees of
// a recommender graph are skewed: on gowalla's `pre` plan a tile holds
// 1,400 edges on average and 5,218 at most, and the heaviest of the rows a
// warp would own by `row % 16` add up to 1,017 edges (a hub of degree 786).
// A block per tile therefore lasts as long as its slowest warp. The
// schedule lists the real edges by (row, plan order) (`perm`, `row_ptr`)
// and cuts them into spans of at most SPAN edges and SPAN rows. A span
// holds whole rows, except that a row of more than SPAN edges (a hub) is cut
// into pieces of SPAN edges, each at the start of its own span. Every warp
// takes one span, so no warp's work exceeds SPAN edges whatever the skew.
// Rows without edges are in spans too (each counts as one edge), so every
// output row is written exactly once and nothing is zeroed first.
//
// What bounds it on the H100: bytes. At gowalla (68,404 nodes, 375,786
// edges, d 64) the plan arrays, x and the output are ~40 MB: ~12 us at
// 3.35 TB/s. The gather of x rows (256 B each in f32) is random, so what
// decides the time is how many gathers are in flight, and the L2 traffic
// they make (each x row is read once per edge). A warp reads its span's
// columns coalesced (the schedule keeps them in its order) and issues every
// x row of the span at once with cp.async into a shared-memory stage: up to
// SPAN = 32 rows in flight per warp, and the loads cost no registers. The
// edge values, read through the plan positions, are needed only for the
// sums, so their load overlaps the gather. Each cp.async moves UNIT bytes (16 where the row allows), so a
// half warp covers one 256 B f32 row and a bf16 row takes 8 columns a lane.
// Per-row bulk copies (TMA) were not used: the copy-rate probe (K4) issues
// ~28 M bulk copies/s from one thread, too few for ~375k rows of 256 B in a
// few microseconds, while cp.async is issued by all 32 lanes.
//
// Sum order, without float atomics. After the stage is filled, lane l owns
// columns l and l + 32 of the 64-column slab, and walks the span's rows in
// order, each row's edges in plan order: acc = fmaf(val, x, acc) from 0.
// A row inside one span is therefore one fmaf chain in plan order, the
// order of a kernel whose threads own whole rows. A hub row's pieces are
// summed so into a scratch row each (one
// slot per span, allocated by the wrapper), and the fix-up kernel adds the
// pieces in span order, left to right. The schedule does not depend on the
// plan's chunk or padding, so every plan of one graph gives the same bits,
// and so do K2 and K3, which differ only in how they address the edge
// values and how their lanes split a load.
//
// bf16: the edge values are rounded to bf16 as the TPU kernel's
// sel.astype(g.dtype) does; products of two bf16 values are exact in f32,
// the sums stay f32.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace neurec {

constexpr int SPAN = 32;   // edges and rows a warp takes; ops/spmm.py SPAN
constexpr int SLAB = 64;   // feature columns per block; grid.y covers wider d
constexpr int WARPS = 4;   // 4 stages of 32 x 64 f32 = 32 KB of shared memory a block
constexpr int THREADS = WARPS * 32;
constexpr unsigned FULL = 0xffffffffu;

// the schedule's arrays on the device (ops/spmm.py::SpmmSchedule)
struct Schedule {
  const int32_t* perm;     // n_edges plan positions, by (row, plan order)
  const int32_t* cols;     // n_edges source columns, in the same order
  const int32_t* row_ptr;  // n_rows + 1
  const int4* spans;       // n_spans x (e0, e1, r0, r1)
  const int32_t* split;    // n_split x (row, s0, s1)
  int n_spans, n_split;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// an edge value as the products see it: rounded to the feature type
template <typename T>
__device__ __forceinline__ float selector(float v) { return v; }
template <>
__device__ __forceinline__ float selector<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// 16-byte copies bypass L1 (.cg): with 7 stages a SM it has ~30 KB left,
// and a gathered row is rarely read twice by one SM
template <int UNIT>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (UNIT == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s), "l"(src), "n"(UNIT)
                 : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// One warp per span and 64-column slab. `index` maps a plan position (flat
// over the plan's (n_chunks, chunk) arrays) to the position of its value in
// `vals`; `lanes` is how many lanes fetch one edge's row, so one cp.async
// instruction of the warp fetches 32 / lanes edges' rows.
template <typename T, int UNIT, typename Index>
__global__ void __launch_bounds__(THREADS)
span_spmm_kernel(const Schedule sc, const float* __restrict__ vals, Index index,
                 const T* __restrict__ x, float* __restrict__ out, float* __restrict__ partial,
                 int d, int lanes) {
  __shared__ __align__(16) T stage[WARPS][SPAN][SLAB];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int s = (int)blockIdx.x * WARPS + warp;
  if (s >= sc.n_spans) return;  // warp-uniform; the block never synchronises
  const int c0 = (int)blockIdx.y * SLAB;
  const int w = min(SLAB, d - c0);
  const int4 sp = sc.spans[s];  // edges e0..e1-1, rows r0..r1-1
  const int e0 = sp.x, e1 = sp.y, r0 = sp.z, nr = sp.w - sp.z, n = e1 - e0;

  int c = 0;
  float v = 0.f;
  if (lane < n) {  // the value is needed only for the sums, after the gather
    c = sc.cols[e0 + lane];
    v = selector<T>(vals[index(sc.perm[e0 + lane])]);
  }
  const int rp = lane < nr ? sc.row_ptr[r0 + lane] : 0;
  const int r_end = sc.row_ptr[sp.w];

  // the gather: every x row of the span in flight at once
  T* st = &stage[warp][0][0];
  const int units = w * (int)sizeof(T) / UNIT;
  const int g = lane / lanes, li = lane % lanes, per_load = 32 / lanes;
  for (int base = 0; base < n; base += per_load) {
    const int j = base + g;
    const int cj = __shfl_sync(FULL, c, j & 31);
    if (j < n) {
      const char* src = reinterpret_cast<const char*>(x + (size_t)cj * d + c0);
      char* dst = reinterpret_cast<char*>(st + j * SLAB);
      for (int u = li; u < units; u += lanes) cp_async<UNIT>(dst + u * UNIT, src + u * UNIT);
    }
  }
  cp_async_wait_all();
  __syncwarp();

  // the sums: rows in order, each row's edges in plan order
  for (int k = 0; k < nr; ++k) {
    const int a0 = __shfl_sync(FULL, rp, k);
    const int next = __shfl_sync(FULL, rp, (k + 1) & 31);
    const int b0 = k + 1 < nr ? next : r_end;
    const int a = max(a0, e0) - e0, b = min(b0, e1) - e0;
    float acc0 = 0.f, acc1 = 0.f;
    for (int j = a; j < b; ++j) {
      const float vj = __shfl_sync(FULL, v, j);
      acc0 = fmaf(vj, to_f32(st[j * SLAB + lane]), acc0);
      acc1 = fmaf(vj, to_f32(st[j * SLAB + lane + 32]), acc1);
    }
    // a piece of a hub row goes to this span's scratch row, the rest to out
    float* dst = (a0 < e0 || b0 > e1) ? partial + (size_t)s * d : out + (size_t)(r0 + k) * d;
    if (lane < w) dst[c0 + lane] = acc0;
    if (lane + 32 < w) dst[c0 + lane + 32] = acc1;
  }
}

// One warp per hub row and slab: out[row] = the row's pieces, spans s0..s1-1,
// added in span order.
__global__ void __launch_bounds__(THREADS)
span_fixup_kernel(const Schedule sc, const float* __restrict__ partial, float* __restrict__ out,
                  int d) {
  const int i = (int)blockIdx.x * WARPS + (int)(threadIdx.x >> 5);
  if (i >= sc.n_split) return;
  const int lane = threadIdx.x & 31;
  const int row = sc.split[3 * i], s0 = sc.split[3 * i + 1], s1 = sc.split[3 * i + 2];
  const int c_end = min(d, ((int)blockIdx.y + 1) * SLAB);
  for (int col = (int)blockIdx.y * SLAB + lane; col < c_end; col += 32) {
    float acc = partial[(size_t)s0 * d + col];
#pragma unroll 4
    for (int s = s0 + 1; s < s1; ++s) acc += partial[(size_t)s * d + col];
    out[(size_t)row * d + col] = acc;
  }
}

// The widest cp.async unit (16, 8 or 4 bytes) that divides a row of d
// features and leaves no lane of `lanes` idle on the first slab; 0 if none
// (a bf16 row of odd d).
inline int pick_unit(int d, int esize, int lanes) {
  const int slab_bytes = (d < SLAB ? d : SLAB) * esize;
  for (int unit = 16; unit >= 4; unit /= 2)
    if ((d * esize) % unit == 0 && (unit == 4 || unit * lanes <= slab_bytes)) return unit;
  return 0;
}

// K2's lanes per edge: enough 16-byte (or `unit`) loads to cover the first
// slab's row, rounded up to a power of two.
inline int lanes_for(int d, int esize, int unit) {
  const int units = (d < SLAB ? d : SLAB) * esize / unit;
  int lanes = 1;
  while (lanes < units && lanes < 32) lanes *= 2;
  return lanes;
}

// Launch the span kernel and, where the schedule cut hub rows, the fix-up;
// returns the first cudaError_t that is not cudaSuccess.
template <typename T, int UNIT, typename Index>
int launch_spans(const Schedule& sc, const float* vals, Index index, const void* x, float* out,
                 float* partial, int d, int lanes, cudaStream_t stream) {
  const int slabs = (d + SLAB - 1) / SLAB;
  span_spmm_kernel<T, UNIT, Index><<<dim3((sc.n_spans + WARPS - 1) / WARPS, slabs), THREADS, 0,
                                     stream>>>(sc, vals, index, static_cast<const T*>(x), out,
                                               partial, d, lanes);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || sc.n_split == 0) return (int)err;
  span_fixup_kernel<<<dim3((sc.n_split + WARPS - 1) / WARPS, slabs), THREADS, 0, stream>>>(
      sc, partial, out, d);
  return (int)cudaGetLastError();
}

// launch_spans at the cp.async unit `unit` (pick_unit)
template <typename T, typename Index>
int dispatch_unit(int unit, const Schedule& sc, const float* vals, Index index, const void* x,
                  float* out, float* partial, int d, int lanes, cudaStream_t stream) {
  switch (unit) {
    case 16: return launch_spans<T, 16>(sc, vals, index, x, out, partial, d, lanes, stream);
    case 8: return launch_spans<T, 8>(sc, vals, index, x, out, partial, d, lanes, stream);
    case 4: return launch_spans<T, 4>(sc, vals, index, x, out, partial, d, lanes, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace neurec

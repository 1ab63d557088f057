// K4: a probe of how fast one thread can issue small copies from on-chip
// memory to dynamic offsets of device memory, for sm_90a.
//
// Replaces the Pallas TPU kernels benchmarks/dma_rate.py::_serial_kernel and
// ::_pipelined_kernel (driven by build / pallas_call): n_dma copies of a
// (rows, 128) f32 tile held on chip, rows in {1, 4, 16} (512 B, 2 KB, 8 KB),
// to rows offs[k % n_offs] .. + rows - 1 of a (65536, 128) f32 buffer, the
// offsets int32; serial (each copy waited for) or with 8 in flight.
//
// The Hopper design that measures the same thing: one block. The tile
// lives in shared memory, filled with 1.0 and fenced for the async proxy;
// one thread issues each copy with the bulk-copy engine (TMA's
// non-tensor form), cp.async.bulk.global.shared::cta.bulk_group, one bulk
// group per copy:
//   serial:    commit_group, then wait_group 0 (the copy's writes done),
//              as the TPU kernel's start(); wait();
//   pipelined: commit_group, then wait_group.read 7, so that at most 8
//              copies are still reading the tile: the condition for reusing
//              a staging buffer, which is what the TPU's 8-slot semaphore
//              ring guards.
// The offsets are staged into shared memory in blocks of STAGE by the other
// threads while thread 0 issues the previous block (the TPU kernel reads
// them from SMEM, scalar-prefetched); thread 0 reads four at a time.
//
// What bounds it: the issue rate and the latency of single copies, not
// bytes (bound = bytes written / 3.35 TB/s, far below).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int COLS = 128;      // f32 columns of a buffer row: 512 B
constexpr int MAX_ROWS = 16;   // the largest tile: 8 KB
constexpr int STAGE = 4096;    // offsets staged per block of copies
constexpr int THREADS = 256;

template <bool SERIAL>
__device__ __forceinline__ void issue(float* out, int off, uint32_t src, uint32_t bytes) {
  float* dst = out + (long long)off * COLS;
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
               :: "l"(dst), "r"(src), "r"(bytes) : "memory");
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
  if (SERIAL) {
    asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
  } else {
    asm volatile("cp.async.bulk.wait_group.read 7;" ::: "memory");
  }
}

__device__ __forceinline__ void stage(int32_t* buf, const int32_t* __restrict__ offs, int n_offs,
                                      long long k0, long long n_dma, int t0, int step) {
  for (int t = t0; t < STAGE && k0 + t < n_dma; t += step) buf[t] = offs[(k0 + t) % n_offs];
}

template <bool SERIAL>
__global__ void __launch_bounds__(THREADS)
dma_rate_kernel(const int32_t* __restrict__ offs, int n_offs, long long n_dma, int rows,
                float* __restrict__ out) {
  __shared__ __align__(128) float tile[MAX_ROWS * COLS];
  __shared__ __align__(16) int32_t staged[2][STAGE];
  for (int i = threadIdx.x; i < rows * COLS; i += THREADS) tile[i] = 1.f;
  stage(staged[0], offs, n_offs, 0, n_dma, threadIdx.x, THREADS);
  // the generic-proxy writes to the tile become visible to the bulk copies
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  __syncthreads();

  const uint32_t src = (uint32_t)__cvta_generic_to_shared(tile);
  const uint32_t bytes = (uint32_t)(rows * COLS * sizeof(float));
  int b = 0;
  for (long long k0 = 0; k0 < n_dma; k0 += STAGE, b ^= 1) {
    if (threadIdx.x == 0) {
      const int32_t* buf = staged[b];
      const int n = (int)min((long long)STAGE, n_dma - k0);
      int t = 0;
      for (; t + 4 <= n; t += 4) {
        const int4 o = *reinterpret_cast<const int4*>(buf + t);
        issue<SERIAL>(out, o.x, src, bytes);
        issue<SERIAL>(out, o.y, src, bytes);
        issue<SERIAL>(out, o.z, src, bytes);
        issue<SERIAL>(out, o.w, src, bytes);
      }
      for (; t < n; ++t) issue<SERIAL>(out, buf[t], src, bytes);
    } else {
      stage(staged[b ^ 1], offs, n_offs, k0 + STAGE, n_dma, threadIdx.x - 1, THREADS - 1);
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

}  // namespace

// serial: 1 for a wait after every copy, 0 for 8 in flight; rows 1..16;
// offsets in [0, n_out_rows - rows], n_offs > 0
extern "C" int neurec_dma_rate(const int32_t* offs, int n_offs, long long n_dma, int rows,
                               int serial, float* out, cudaStream_t stream) {
  if (n_dma <= 0) return 0;
  if (rows < 1 || rows > MAX_ROWS || n_offs <= 0) return (int)cudaErrorInvalidValue;
  if (serial) {
    dma_rate_kernel<true><<<1, THREADS, 0, stream>>>(offs, n_offs, n_dma, rows, out);
  } else {
    dma_rate_kernel<false><<<1, THREADS, 0, stream>>>(offs, n_offs, n_dma, rows, out);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* neurec_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

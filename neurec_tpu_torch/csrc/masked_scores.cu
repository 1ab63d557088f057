// K1: fused full-catalogue score + train-item mask, f32, for sm_90a.
//
// Replaces the Pallas TPU kernel neurec_tpu/ops/pallas_kernels.py
// ::_masked_scores_kernel (driven by masked_scores): out[b, i] =
// u[b] . items[i], or -inf where user b's mask marks item i.
//
// Mask formats (template parameter MODE):
//   0  int8 membership, mask[b * mask_stride + i] != 0 (the Pallas
//      kernel's own operand, built by build_train_mask);
//   1  bit-plane bytes of the evaluator's default "bits" tier with one
//      global block of width W: item i sits in byte i % (W/8), bit
//      i / (W/8) of row b (plane_bytes = W/8).
//
// What bounds it on the H100: at the eval shapes (B=2048, I=38,546, d=64)
// the product is 10.1 GFLOP, 0.15 ms at the 67 TFLOP/s f32 (non-tensor)
// peak, against 336 MB of traffic (the (B, I) f32 output dominates),
// 0.10 ms at 3.35 TB/s — so f32 operations bound it, narrowly. The port
// computes in exact f32, as the JAX package does on the CPU, so no TF32
// tensor cores.
//
// Design: a classic shared-memory tiled SGEMM. Each 256-thread block owns a
// 64x64 output tile; u and items tiles are staged transposed through shared
// memory 16 deep along d (zero-filled past B, I and d, so ragged shapes and
// any d work); each thread keeps a 4x4 accumulator in registers, its rows
// and columns 16 apart so that a half-warp stores 16 consecutive floats.
// The epilogue reads the mask byte, applies -inf and writes each of the I
// real columns exactly once — the (B, I) scores never round-trip through
// device memory unmasked. Simple and right first: wgmma/TMA and larger
// register tiles are later work.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;   // users per block tile
constexpr int BN = 64;   // items per block tile
constexpr int BK = 16;   // depth staged per step
constexpr int THREADS = 256;

template <int MODE>
__global__ void __launch_bounds__(THREADS)
masked_scores_kernel(const float* __restrict__ u, const float* __restrict__ items,
                     const uint8_t* __restrict__ mask, float* __restrict__ out,
                     int B, int I, int d, long long mask_stride, int plane_bytes) {
  __shared__ float As[BK][BM + 1];
  __shared__ float Bs[BK][BN + 1];
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < d; k0 += BK) {
    for (int e = threadIdx.x; e < BM * BK; e += THREADS) {
      const int m = e / BK, k = e % BK;
      const int gk = k0 + k;
      const int gr = row0 + m, gc = col0 + m;
      As[k][m] = (gr < B && gk < d) ? u[(long long)gr * d + gk] : 0.f;
      Bs[k][m] = (gc < I && gk < d) ? items[(long long)gc * d + gk] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[k][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[k][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty + 16 * i;
    if (r >= B) continue;
    const uint8_t* mrow = mask + (long long)r * mask_stride;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = col0 + tx + 16 * j;
      if (c >= I) continue;
      bool masked;
      if (MODE == 0) {
        masked = mrow[c] != 0;
      } else {
        masked = (mrow[c % plane_bytes] >> (c / plane_bytes)) & 1;
      }
      out[(long long)r * I + c] = masked ? -INFINITY : acc[i][j];
    }
  }
}

}  // namespace

extern "C" int neurec_masked_scores(const float* u, const float* items, const uint8_t* mask,
                                    float* out, int B, int I, int d, long long mask_stride,
                                    int plane_bytes, int mode, cudaStream_t stream) {
  if (B <= 0 || I <= 0) return 0;
  const dim3 grid((I + BN - 1) / BN, (B + BM - 1) / BM);
  if (mode == 0) {
    masked_scores_kernel<0><<<grid, THREADS, 0, stream>>>(u, items, mask, out, B, I, d,
                                                           mask_stride, plane_bytes);
  } else {
    masked_scores_kernel<1><<<grid, THREADS, 0, stream>>>(u, items, mask, out, B, I, d,
                                                           mask_stride, plane_bytes);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* neurec_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

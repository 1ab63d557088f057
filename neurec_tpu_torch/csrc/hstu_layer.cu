// HSTU's layer around its attention, forward, for sm_90a: the two passes
// of ops/hstu.py::layer on either side of neurec::hstu_attn_fwd, taken in
// evaluation (no gradient wanted, no dropout):
//   hstu_layer_in:  uvqk = SiLU(LN(x) W1 + b1)          x (rows, d) -> (rows, W)
//   hstu_layer_out: x'   = x + ((u * LN(attn)) W2 + b2)  attn, u (rows, hv), x (rows, d) -> (rows, d)
// with LN over a row, no affine, eps 1e-6: the mean, then the mean of the
// centred squares, then (v - mean) rsqrt(var + eps), as
// ops/hstu.py::layer_norm; SiLU(s) = s / (1 + exp(-s)).
// float32 in and out; the products are f32 FMAs (no TF32), summed over k
// in order, and the bias added after the sum, as the plain version adds it.
//
// It replaces no TPU kernel: the JAX package has no HSTU. The plain
// version (ops/hstu.py::layer_in_reference, layer_out_reference) runs
// LayerNorm as a reduction and broadcast passes, the projections as cuBLAS
// f32 GEMMs, then + b1, SiLU, the gate on u's strided columns, + b2 and
// the residual as elementwise passes: ~3.4 GB of device traffic a layer at
// the evaluation's (2048 x 200 rows, d 50, W 200), where the work needs
// 0.74 GB.
//
// What bounds it on the H100. hstu_layer_in reads x (200 B a row) and
// writes uvqk (800 B a row), 410 MB a layer at (409,600 rows, 50, 200):
// 0.122 ms at 3.35 TB/s, against 2 d W = 20,000 operations a row, 8.2
// GFLOP: 0.122 ms at the card's 67 TFLOP/s of f32 FMAs. The two weigh
// alike, so the product is register-tiled (64 FMAs a thread for 4 shared
// memory reads) and the SiLU is applied before the one store.
// hstu_layer_out reads attn, u and x (600 B a row) and writes x' (200 B),
// 328 MB: 0.098 ms, against 2 hv d = 5,000 operations a row (0.03 ms): it
// is bound by its bytes, which it reads and writes once each.
//
// Design: persistent blocks (as many as fit on the SMs) walk tiles of 64
// rows; the weight and bias stay in shared memory for the block's life,
// padded with zero columns. A tile's rows lie together in device memory (64
// rows of x are 12.8 KB), so they are staged whole by cp.async, 16 bytes a
// copy, and the next tile's copies are issued as soon as the LayerNorm has
// read the current one, so that they land behind the product. The
// LayerNorm (and the gate) runs from shared memory on every thread, a few
// threads a row each summing a strided part (two barriers between the sums),
// and writes the normalised row transposed, (k, row), so that the product
// reads a thread's rows as float4s. hstu_layer_in: a thread owns 8 rows
// (4rg .. 4rg + 3 and 32 + those) by 8 columns (4cg .. 4cg + 3 and the same
// past half the padded width), so a warp's reads of both operands touch one
// 128 B line each and its stores cover whole sectors; thread cg * 8 + rg; the
// SiLU's division by the reciprocal (__fdividef, 2 ulp). hstu_layer_out: 4
// rows by 4 columns a thread, its x read to registers before the next tile's
// copies, the new rows written to shared memory and stored as they lie.
// The kernels launch on the caller's stream, allocate nothing and read
// nothing back, so a CUDA graph captures them. Pad positions are computed
// as any other row.
//
// What is left (PERF.md's kernel table): at the evaluation's shape the two
// run at ~28% and ~42% of these bounds. A block's tile runs its phases in
// turn (LayerNorm, product, stores), and the two or three blocks an SM holds
// (hstu_layer_in: 127 registers a thread) overlap them only in part: the
// product alone is ~0.18 of hstu_layer_in's ~0.41 ms, its stores ~0.1 more.
// Smaller tiles and a product split by column halves did not help.

#include <cuda_runtime.h>
#include <stdint.h>

// a named namespace: a trace names the kernels neurec::hstu_layer_in and
// neurec::hstu_layer_out
namespace neurec {

constexpr int TM = 64;       // rows a tile
constexpr int MAX_D = 64;    // the widest stream d and attention output h dv
constexpr int MAX_W = 256;   // the widest fused projection 2 h (dv + dqk)
constexpr int MAX_DEVICES = 16;
constexpr float LN_EPS = 1e-6f;

struct InArgs {
  const float* x;   // (rows, d), contiguous, 16-byte aligned
  const float* w1;  // (d, W), contiguous
  const float* b1;  // (W,)
  float* out;       // (rows, W), contiguous, 16-byte aligned
  long long rows;
  int d, W;
  int wp;           // W rounded up to 8: the staged weight's row
};

struct OutArgs {
  const float* attn;  // (rows, hv), contiguous, 16-byte aligned
  const float* u;     // row r's hv columns at u + r * ldu
  long long ldu;
  const float* x;     // (rows, d), contiguous, 16-byte aligned
  const float* w2;    // (hv, d), contiguous
  const float* b2;    // (d,)
  float* out;         // (rows, d), contiguous, 16-byte aligned
  long long rows;
  int hv, d;
  int dp;             // d rounded up to 4: the staged weight's row
};

// the LayerNorm's threads a row: as many as the block has for TM rows
__host__ __device__ constexpr int ln_parts(int threads) { return threads < 2 * TM ? 1 : threads / TM; }

// shared memory a block takes, in floats
__host__ __device__ constexpr int in_smem_floats(int d, int wp, int threads) {
  return d * wp + wp + 2 * TM * d + 2 * TM * ln_parts(threads);
}
__host__ __device__ constexpr int out_smem_floats(int hv, int d, int dp, int threads) {
  return hv * dp + dp + 2 * TM * hv + TM * d + TM * (hv > d ? hv : d) + 2 * TM * ln_parts(threads);
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

// n floats from src to dst, both 16-byte aligned, copied without waiting:
// 16-byte copies, then the tail
__device__ __forceinline__ void stage(float* dst, const float* __restrict__ src, int n) {
  const int n4 = n >> 2;
  for (int e = threadIdx.x; e < n4; e += blockDim.x) cp_async16(dst + 4 * e, src + 4 * e);
  for (int e = (n4 << 2) + threadIdx.x; e < n; e += blockDim.x) cp_async4(dst + e, src + e);
}

// LayerNorm of the tile's rows (rows of n at a stride of n in src; nr of
// them real), written transposed to dst[k * TM + r], times gate[r * n + k]
// where there is a gate; zero rows past nr. `parts` threads a row, each
// summing the columns k = p, p + parts, ..., the partial sums in red (2 TM
// parts floats). Three barriers; the caller's barrier before it has made
// src ready, and one after it makes dst ready.
__device__ __forceinline__ void layer_norm_rows(const float* src, const float* gate, float* dst, float* red, int n,
                                                int nr, int parts) {
  const int tid = threadIdx.x;
  float* sums = red;
  float* squares = red + TM * parts;
  for (int e = tid; e < TM * parts; e += blockDim.x) {
    const int r = e / parts, p = e - r * parts;
    float s = 0.f;
    if (r < nr)
      for (int k = p; k < n; k += parts) s += src[r * n + k];
    sums[e] = s;
  }
  __syncthreads();
  for (int e = tid; e < TM * parts; e += blockDim.x) {
    const int r = e / parts, p = e - r * parts;
    float s = 0.f;
    for (int i = 0; i < parts; ++i) s += sums[r * parts + i];
    const float mean = s / (float)n;
    float q = 0.f;
    if (r < nr)
      for (int k = p; k < n; k += parts) {
        const float c = src[r * n + k] - mean;
        q = fmaf(c, c, q);
      }
    squares[e] = q;
  }
  __syncthreads();
  for (int e = tid; e < TM * parts; e += blockDim.x) {
    const int r = e / parts, p = e - r * parts;
    if (r >= nr) {
      for (int k = p; k < n; k += parts) dst[k * TM + r] = 0.f;
      continue;
    }
    float s = 0.f, q = 0.f;
    for (int i = 0; i < parts; ++i) {
      s += sums[r * parts + i];
      q += squares[r * parts + i];
    }
    const float mean = s / (float)n, rstd = rsqrtf(q / (float)n + LN_EPS);
    for (int k = p; k < n; k += parts) {
      const float z = (src[r * n + k] - mean) * rstd;
      dst[k * TM + r] = gate ? gate[r * n + k] * z : z;
    }
  }
}

// the weight (k rows of n columns) and the bias into shared memory at a
// row of np >= n, zero past n
__device__ __forceinline__ void stage_weight(float* ws, float* bs, const float* __restrict__ w,
                                             const float* __restrict__ b, int k, int n, int np) {
  for (int e = threadIdx.x; e < k * np; e += blockDim.x) {
    const int r = e / np, c = e - r * np;
    ws[e] = c < n ? __ldg(w + (long long)r * n + c) : 0.f;
  }
  for (int c = threadIdx.x; c < np; c += blockDim.x) bs[c] = c < n ? __ldg(b + c) : 0.f;
}

__global__ void __launch_bounds__(MAX_W) hstu_layer_in(const InArgs a) {
  extern __shared__ __align__(16) float smem[];
  const int d = a.d, W = a.W, wp = a.wp, half = wp >> 1;
  const int parts = ln_parts(blockDim.x);
  float* ws = smem;         // [d][wp]
  float* bs = ws + d * wp;  // [wp]
  float* xs = bs + wp;      // [TM * d]: the tile's rows as they lie
  float* xt = xs + TM * d;  // [d][TM]: LN of the rows, transposed
  float* red = xt + d * TM; // [2 TM parts]
  const int tid = threadIdx.x;
  const int rg = tid & 7, cg = tid >> 3;
  const bool vec = (W & 3) == 0;  // rows of 16-byte multiples: float4 stores
  const long long tiles = (a.rows + TM - 1) / TM;
  if (blockIdx.x < tiles) {
    const long long r0 = blockIdx.x * (long long)TM;
    stage(xs, a.x + r0 * d, (int)min((long long)TM, a.rows - r0) * d);
    cp_async_commit();
  }
  stage_weight(ws, bs, a.w1, a.b1, d, W, wp);

  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const long long r0 = t * TM;
    const int nr = (int)min((long long)TM, a.rows - r0);
    cp_async_wait();
    __syncthreads();  // xs holds the tile; the last tile's product is done with xt
    layer_norm_rows(xs, nullptr, xt, red, d, nr, parts);
    __syncthreads();  // xt is ready and xs free: the next tile's rows go there behind the product
    if (t + gridDim.x < tiles) {
      const long long n0 = (t + gridDim.x) * TM;
      stage(xs, a.x + n0 * d, (int)min((long long)TM, a.rows - n0) * d);
      cp_async_commit();
    }

    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
#pragma unroll 2
    for (int k = 0; k < d; ++k) {
      const float4 xa = *reinterpret_cast<const float4*>(xt + k * TM + 4 * rg);
      const float4 xb = *reinterpret_cast<const float4*>(xt + k * TM + 32 + 4 * rg);
      const float4 wa = *reinterpret_cast<const float4*>(ws + k * wp + 4 * cg);
      const float4 wb = *reinterpret_cast<const float4*>(ws + k * wp + half + 4 * cg);
      const float xr[8] = {xa.x, xa.y, xa.z, xa.w, xb.x, xb.y, xb.z, xb.w};
      const float wc[8] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(xr[i], wc[j], acc[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = (i & 4) * 8 + 4 * rg + (i & 3);
      if (r >= nr) continue;
      float* orow = a.out + (r0 + r) * W;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int c = hf * half + 4 * cg;
        if (c >= W) continue;
        float v[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float s = acc[i][4 * hf + j] + bs[c + j];
          v[j] = __fdividef(s, 1.f + expf(-s));
        }
        if (vec) {
          *reinterpret_cast<float4*>(orow + c) = make_float4(v[0], v[1], v[2], v[3]);
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (c + j < W) orow[c + j] = v[j];
        }
      }
    }
  }
  cp_async_wait();
}

// the tile's attention rows, u's rows and x's rows, copied without waiting
__device__ __forceinline__ void stage_out_tile(const OutArgs& a, long long t, float* as, float* us, float* xs) {
  const long long r0 = t * TM;
  const int nr = (int)min((long long)TM, a.rows - r0), hv = a.hv;
  stage(as, a.attn + r0 * hv, nr * hv);
  stage(xs, a.x + r0 * a.d, nr * a.d);
  for (int e = threadIdx.x; e < nr * 32; e += blockDim.x) {  // 32 threads a row of u, at its own stride
    const int r = e >> 5;
    const float* src = a.u + (r0 + r) * a.ldu;
    for (int c = e & 31; c < hv; c += 32) cp_async4(us + r * hv + c, src + c);
  }
  cp_async_commit();
}

__global__ void __launch_bounds__(4 * MAX_D) hstu_layer_out(const OutArgs a) {
  extern __shared__ __align__(16) float smem[];
  const int hv = a.hv, d = a.d, dp = a.dp;
  const int parts = ln_parts(blockDim.x);
  float* ws = smem;                       // [hv][dp]
  float* bs = ws + hv * dp;               // [dp]
  float* as = bs + dp;                    // [TM * hv]: the attention's rows
  float* us = as + TM * hv;               // [TM * hv]: u's rows
  float* xs = us + TM * hv;               // [TM * d]: x's rows
  float* yt = xs + TM * d;                // [hv][TM]: u * LN(attn), transposed; then x''s rows
  float* red = yt + TM * (hv > d ? hv : d);  // [2 TM parts]
  const int tid = threadIdx.x;
  const int rg = tid & 15, cg = tid >> 4;  // rows 4rg + i, columns 4cg + j
  const long long tiles = (a.rows + TM - 1) / TM;
  if (blockIdx.x < tiles) stage_out_tile(a, blockIdx.x, as, us, xs);
  stage_weight(ws, bs, a.w2, a.b2, hv, d, dp);

  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const long long r0 = t * TM;
    const int nr = (int)min((long long)TM, a.rows - r0);
    cp_async_wait();
    __syncthreads();  // the tile is staged; the last tile's store is done with yt
    layer_norm_rows(as, us, yt, red, hv, nr, parts);
    float xr[4][4];   // this thread's x, read before the next tile's rows land in xs
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = 4 * rg + i, c = 4 * cg + j;
        xr[i][j] = (r < nr && c < d) ? xs[r * d + c] : 0.f;
      }
    __syncthreads();  // yt is ready; as, us and xs are free: the next tile goes there behind the product
    if (t + gridDim.x < tiles) stage_out_tile(a, t + gridDim.x, as, us, xs);

    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 2
    for (int k = 0; k < hv; ++k) {
      const float4 y = *reinterpret_cast<const float4*>(yt + k * TM + 4 * rg);
      const float4 w = *reinterpret_cast<const float4*>(ws + k * dp + 4 * cg);
      const float yr[4] = {y.x, y.y, y.z, y.w};
      const float wc[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(yr[i], wc[j], acc[i][j]);
    }
    __syncthreads();  // the product is done with yt: the new rows are written there
    float* os = yt;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = 4 * rg + i;
      if (r >= nr) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = 4 * cg + j;
        if (c < d) os[r * d + c] = xr[i][j] + (acc[i][j] + bs[c]);
      }
    }
    __syncthreads();
    float* dst = a.out + r0 * d;
    const int n = nr * d, n4 = n >> 2;
    for (int e = tid; e < n4; e += blockDim.x)
      reinterpret_cast<float4*>(dst)[e] = reinterpret_cast<const float4*>(os)[e];
    for (int e = (n4 << 2) + tid; e < n; e += blockDim.x) dst[e] = os[e];
  }
  cp_async_wait();
}

// the persistent grid: as many blocks as fit on the card's SMs, at most one
// a tile; the dynamic shared memory allowed once a device
template <typename Kernel>
static cudaError_t grid_for(Kernel kernel, int threads, int smem, long long tiles, int* attr_set, int* grid) {
  int dev, sms, per_sm;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (attr_set[dev] < smem) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    attr_set[dev] = smem;
  }
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *grid = (int)(tiles < (long long)per_sm * sms ? tiles : (long long)per_sm * sms);
  return cudaSuccess;
}

}  // namespace neurec

using namespace neurec;

// x (rows, d) and out (rows, W) float32, contiguous and 16-byte aligned; w1
// (d, W) and b1 (W,) float32, contiguous. d <= 64, W <= 256.
extern "C" int neurec_hstu_layer_in(const float* x, const float* w1, const float* b1, float* out, long long rows,
                                    int d, int W, cudaStream_t stream) {
  if (rows < 0 || d < 1 || d > MAX_D || W < 1 || W > MAX_W) return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  InArgs a{x, w1, b1, out, rows, d, W, (W + 7) / 8 * 8};
  const int threads = a.wp;  // 8 row groups by wp / 8 column groups
  const int smem = (int)sizeof(float) * in_smem_floats(d, a.wp, threads);
  static int attr_set[MAX_DEVICES];
  int grid;
  cudaError_t err = grid_for(hstu_layer_in, threads, smem, (rows + TM - 1) / TM, attr_set, &grid);
  if (err != cudaSuccess) return (int)err;
  hstu_layer_in<<<grid, threads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// attn (rows, hv), x and out (rows, d) float32, contiguous and 16-byte
// aligned; u's row r at u + r * ldu (hv floats, ldu >= hv); w2 (hv, d) and
// b2 (d,) float32, contiguous. hv, d <= 64.
extern "C" int neurec_hstu_layer_out(const float* attn, const float* u, long long ldu, const float* x,
                                     const float* w2, const float* b2, float* out, long long rows, int hv, int d,
                                     cudaStream_t stream) {
  if (rows < 0 || hv < 1 || hv > MAX_D || d < 1 || d > MAX_D || ldu < hv) return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  OutArgs a{attn, u, ldu, x, w2, b2, out, rows, hv, d, (d + 3) / 4 * 4};
  const int threads = 4 * a.dp;  // 16 row groups by dp / 4 column groups
  const int smem = (int)sizeof(float) * out_smem_floats(hv, d, a.dp, threads);
  static int attr_set[MAX_DEVICES];
  int grid;
  cudaError_t err = grid_for(hstu_layer_out, threads, smem, (rows + TM - 1) / TM, attr_set, &grid);
  if (err != cudaSuccess) return (int)err;
  hstu_layer_out<<<grid, threads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

extern "C" const char* neurec_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// HSTU's pointwise attention, forward, for sm_90a: for each user b and
// head, A v with A[i, j] = SiLU(q_i . k_j + rab[i, j]) / N on the causal
// pairs j <= i < n_b, 0 elsewhere, and
// rab[i, j] = w_p[N - 1 + j - i] + w_t[bucket(ts[b, i + 1] - ts[b, j])]
// (ops/hstu.py states the layout and the bucket). float32 in and out; the
// products are f32 FMAs (no TF32).
//
// It replaces no TPU kernel: the JAX package has no HSTU. It is the port's
// own, for the HSTU model (models/sequential/hstu.py), whose plain version
// (ops/hstu.py::attention_reference) writes the B x h x N x N scores, their
// bias and mask to device memory several times over.
//
// What bounds it on the H100. A call reads q, k and v once and writes the
// output once: at the evaluation's (2048, 200, 2, 25) that is 328 MB, 98 us
// at 3.35 TB/s, against 2 h (dqk + dv) = 200 operations a causal pair, 8.2
// GFLOP for users of full length: 17 us at the TF32 rate, 123 us at the
// card's 67 TFLOP/s of f32 FMAs. At about 25 operations a byte the f32
// arithmetic and the bytes weigh alike: the design reads each input once
// from device memory, keeps the scores, their bias and the mask on the SM
// and never writes them, and skips the work no real pair needs.
//
// Design: a block of 128 threads a (user, 32-query tile). A tile past the
// user's length writes its zero rows and ends. Otherwise:
//  1. the bias strip of the tile's rows against keys 0 .. kend - 1 (kend the
//     tile's last real query + 1, rounded up to 32) is computed once into
//     shared memory, for every head: the position term from w_p, the time
//     term from w_t at the bucket of |ts[i + 1] - ts[j]|, found by a binary
//     search of the 128 bucket edges (ops/hstu.py::bucket_edges) staged in
//     shared memory;
//  2. for each head: the query tile is staged, transposed; for each 32-key
//     tile up to kend the key tile (transposed) and the value tile are
//     staged, each thread computes a 2 x 4 block of scores by FMAs over
//     dqk, adds the bias, applies SiLU, 1/N and the mask, and the 32 x 32
//     tile goes to shared memory; then each thread adds its 2 x 4 block of
//     the output (rows x value columns) over the tile's 32 keys. Key tiles
//     past kend, and so past the query tile and the user's length, are never
//     visited.
// The kernel launches on the caller's stream, allocates nothing and reads
// nothing back, so a CUDA graph captures it.

#include <cuda_runtime.h>
#include <stdint.h>

// a named namespace: a trace names the kernel neurec::hstu_attn_fwd
namespace neurec {

constexpr int BQ = 32;       // queries a block
constexpr int BK = 32;       // keys a tile
constexpr int THREADS = 128;
constexpr int DMAX = 32;     // the widest head
constexpr int NB = 128;      // time buckets past bucket 0
constexpr int QS = BQ + 4;   // row strides of the transposed tiles (16-byte rows)
constexpr int KS = BK + 4;
constexpr int SS = BK + 1;
constexpr int MAX_DEVICES = 16;

struct HstuArgs {
  const float* q;  // element (b, i, head, c) at q + (b * N + i) * ld + head * dqk + c
  const float* k;
  const float* v;  // at v + (b * N + i) * ld + head * dv + c
  long long ld;
  const int* lengths;        // (B,)
  const long long* ts;       // (B, N + 1)
  const float* w_p;          // (2N - 1,)
  const float* w_t;          // (NB + 1,)
  const long long* edges;    // (NB,): the least |delta| of buckets 1 .. NB
  float* out;                // (B, N, h * dv)
  int B, N, h, dqk, dv;
  int kpad;                  // the bias strip's row: N rounded up to BK
};

// shared memory a block takes: the edges, w_t, the bias strip, the tiles
__host__ __device__ constexpr int smem_bytes(int kpad) {
  return 8 * NB + 4 * (NB + 4) + 4 * (BQ * kpad + DMAX * QS + DMAX * KS + BK * DMAX + BQ * SS);
}

__global__ void __launch_bounds__(THREADS) hstu_attn_fwd(const HstuArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  long long* edges = (long long*)smem;
  float* wt = (float*)(edges + NB);
  float* bias = wt + NB + 4;
  float* qs = bias + BQ * a.kpad;  // [DMAX][QS]: qs[c * QS + r]
  float* ks = qs + DMAX * QS;      // [DMAX][KS]
  float* vs = ks + DMAX * KS;      // [BK][DMAX]
  float* ss = vs + BK * DMAX;      // [BQ][SS]

  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int N = a.N, HD = a.h * a.dv;
  const int n = min(max(a.lengths[b], 0), N);
  float* outb = a.out + (long long)b * N * HD;
  const int rows = min(BQ, N - q0);

  if (q0 >= n) {  // no real query: zero rows
    for (int e = tid; e < rows * HD; e += THREADS) outb[(long long)q0 * HD + e] = 0.f;
    return;
  }
  const int kend = min(q0 + BQ, n);
  const int ktiles = (kend + BK - 1) / BK;
  const int kcols = ktiles * BK;
  const long long* tsb = a.ts + (long long)b * (N + 1);
  const float nf = (float)N;  // A's divisor, the padded length

  for (int e = tid; e < NB; e += THREADS) edges[e] = a.edges[e];
  for (int e = tid; e <= NB; e += THREADS) wt[e] = a.w_t[e];
  __syncthreads();

  // 1. the bias strip
  for (int e = tid; e < BQ * kcols; e += THREADS) {
    const int r = e / kcols, j = e - r * kcols, i = q0 + r;
    float val = 0.f;
    if (i < n && j <= i) {
      long long d = tsb[i + 1] - tsb[j];
      d = d < 0 ? -d : d;
      int bkt = 0;  // the number of edges <= d
#pragma unroll
      for (int step = NB; step >= 1; step >>= 1)
        if (bkt + step <= NB && edges[bkt + step - 1] <= d) bkt += step;
      val = __ldg(a.w_p + (N - 1 + j - i)) + wt[bkt];
    }
    bias[r * a.kpad + j] = val;
  }

  const int rg = (tid >> 3) * 2;  // this thread's two rows
  const int cg = (tid & 7) * 4;   // its four key columns (scores) or value columns (output)

  for (int hd = 0; hd < a.h; ++hd) {
    __syncthreads();  // the last head's readers are done with qs
    for (int e = tid; e < BQ * DMAX; e += THREADS) {
      const int r = e / DMAX, c = e - r * DMAX, i = q0 + r;
      qs[c * QS + r] = (c < a.dqk && i < N) ? a.q[((long long)b * N + i) * a.ld + hd * a.dqk + c] : 0.f;
    }
    float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};

    for (int kt = 0; kt < ktiles; ++kt) {
      const int j0 = kt * BK;
      __syncthreads();  // the last tile's readers are done with ks, vs, ss
      for (int e = tid; e < BK * DMAX; e += THREADS) {
        const int jj = e / DMAX, c = e - jj * DMAX, j = j0 + jj;
        const long long row = ((long long)b * N + j) * a.ld;
        const bool in = j < kend;
        ks[c * KS + jj] = (in && c < a.dqk) ? a.k[row + hd * a.dqk + c] : 0.f;
        vs[jj * DMAX + c] = (in && c < a.dv) ? a.v[row + hd * a.dv + c] : 0.f;
      }
      __syncthreads();

      float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
      for (int c = 0; c < a.dqk; ++c) {
        const float2 qa = *reinterpret_cast<const float2*>(qs + c * QS + rg);
        const float4 kb = *reinterpret_cast<const float4*>(ks + c * KS + cg);
        s[0][0] = fmaf(qa.x, kb.x, s[0][0]);
        s[0][1] = fmaf(qa.x, kb.y, s[0][1]);
        s[0][2] = fmaf(qa.x, kb.z, s[0][2]);
        s[0][3] = fmaf(qa.x, kb.w, s[0][3]);
        s[1][0] = fmaf(qa.y, kb.x, s[1][0]);
        s[1][1] = fmaf(qa.y, kb.y, s[1][1]);
        s[1][2] = fmaf(qa.y, kb.z, s[1][2]);
        s[1][3] = fmaf(qa.y, kb.w, s[1][3]);
      }
#pragma unroll
      for (int ri = 0; ri < 2; ++ri) {
        const int i = q0 + rg + ri;
#pragma unroll
        for (int ci = 0; ci < 4; ++ci) {
          const int j = j0 + cg + ci;
          float p = 0.f;
          if (i < n && j <= i) {
            const float x = s[ri][ci] + bias[(rg + ri) * a.kpad + j];
            p = x / (1.f + expf(-x)) / nf;
          }
          ss[(rg + ri) * SS + cg + ci] = p;
        }
      }
      __syncthreads();

      for (int jj = 0; jj < BK; ++jj) {
        const float p0 = ss[rg * SS + jj], p1 = ss[(rg + 1) * SS + jj];
        const float4 vb = *reinterpret_cast<const float4*>(vs + jj * DMAX + cg);
        acc[0][0] = fmaf(p0, vb.x, acc[0][0]);
        acc[0][1] = fmaf(p0, vb.y, acc[0][1]);
        acc[0][2] = fmaf(p0, vb.z, acc[0][2]);
        acc[0][3] = fmaf(p0, vb.w, acc[0][3]);
        acc[1][0] = fmaf(p1, vb.x, acc[1][0]);
        acc[1][1] = fmaf(p1, vb.y, acc[1][1]);
        acc[1][2] = fmaf(p1, vb.z, acc[1][2]);
        acc[1][3] = fmaf(p1, vb.w, acc[1][3]);
      }
    }

#pragma unroll
    for (int ri = 0; ri < 2; ++ri) {
      const int i = q0 + rg + ri;
      if (i >= N) continue;
#pragma unroll
      for (int ci = 0; ci < 4; ++ci) {
        const int c = cg + ci;
        if (c < a.dv) outb[(long long)i * HD + hd * a.dv + c] = i < n ? acc[ri][ci] : 0.f;
      }
    }
  }
}

}  // namespace neurec

using namespace neurec;

// q, k, v: float32 rows of B * N positions at a stride of ld floats (a
// head's dqk or dv columns together, heads side by side); lengths (B,)
// int32; ts (B, N + 1) int64; w_p (2N - 1,) and w_t (129,) float32; edges
// (128,) int64; out (B, N, h * dv) float32, contiguous. dqk, dv <= 32.
extern "C" int neurec_hstu_attn_fwd(const float* q, const float* k, const float* v, long long ld,
                                    const int* lengths, const long long* ts, const float* w_p, const float* w_t,
                                    const long long* edges, float* out, int B, int N, int h, int dqk, int dv,
                                    cudaStream_t stream) {
  if (B < 0 || N < 1 || h < 1 || dqk < 1 || dv < 1 || dqk > DMAX || dv > DMAX || B > 65535)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  HstuArgs a{q, k, v, ld, lengths, ts, w_p, w_t, edges, out, B, N, h, dqk, dv, 0};
  a.kpad = (N + BK - 1) / BK * BK;
  const int smem = smem_bytes(a.kpad);
  static int attr_set[MAX_DEVICES];
  int dev;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (attr_set[dev] < smem) {
    err = cudaFuncSetAttribute(hstu_attn_fwd, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    attr_set[dev] = smem;
  }
  dim3 grid((unsigned)((N + BQ - 1) / BQ), (unsigned)B);
  hstu_attn_fwd<<<grid, THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

extern "C" const char* neurec_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

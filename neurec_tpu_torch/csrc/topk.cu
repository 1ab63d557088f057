// Top-K of each row of a float32 (B, I) block, for sm_90a: the K largest
// entries of a row, descending in the IEEE total order (-NaN < -inf < ... <
// -0 < +0 < ... < +inf < +NaN), the lowest id first among equal values; the
// values as float32 (the entries' own bits) and the ids as int64.
//
// It replaces no TPU kernel: the JAX package ranks with jax.lax.top_k, XLA's
// own kernel. On the card it replaces a library call and its fix-up
// (ops/topk.py::top_k_reference: torch.topk of order keys, which promises no
// order among ties, then a full-row running count of the ties at the K-th
// key, a searchsorted and three sorts), which ran at ~3% of the bound below.
//
// What bounds it on the H100. The scores are read once, 4 I bytes a row, and
// K values and ids written, 12 K bytes: at the evaluation's (2048, 38,546,
// 20) that is 316 MB, 94 us at 3.35 TB/s. The work is about two operations a
// byte, far under the card's ridge, so device memory bounds it: the design
// reads every score from device memory once and keeps every later pass on
// the SM. A pass over a staged row costs the SM about 300 cycles for each
// instruction it spends on an entry (1,024 threads, 38,546 entries), so the
// common case makes two passes over the whole row, each of a few
// instructions an entry.
//
// Design: a radix select on a 64-bit composite of each entry,
// (order key << 32) | ((idmask - id) << (32 - idbits)), idbits = ceil(log2 I),
// so that a larger composite is a higher value or, at an equal value, a lower
// id. Composites are distinct, so the K-th largest one is a single entry and
// its ties need no second pass: the lowest-id rule is in the order itself.
//  1. The first digit, the key's top D0 = 12 bits (sign, exponent and 3 bits
//     of mantissa), is counted in a histogram in shared memory (atomics that
//     return nothing; a warp of one digit adds once) as the row arrives. A scan over the block's threads finds the bin of the
//     K-th entry. While that bin holds more entries than the candidate buffer
//     (scores of a narrow spread share their top bits), the key's next 12
//     bits, then its last 8, are counted over the row among the bin's entries.
//  2. The split, one pass: entries above the bin are winners, the bin's own
//     are candidates (for scores of one spread, tens of the row's tens of
//     thousands); a chunk of four keys all under the bin costs one compare
//     and one vote. An append takes one atomic a warp for four entries a
//     lane.
//  3. Few candidates (no more than the row's threads): each one's rank among
//     them, by counting, picks the rest of the winners. More: 8-bit digits
//     of their composites until a bin's entries all win; the winners are then
//     every candidate from the resolved prefix up. One key with more entries
//     than the buffer (a row of few values): its first entries in the row's
//     order, by a count over the threads a pass of chunks at a time.
//  4. The winners, at most a round of them, are ordered by counting, for
//     each, the winners above it, and written at their rank. K larger than a
//     round runs in rounds, each below the last round's least winner.
//
// One block of 1,024 threads a row, on one of two paths that this file
// chooses by the row's length and reports to the caller:
//  - resident (I <= RESIDENT_MAX_ITEMS: gowalla's 38,546 items, and every
//    shorter row: the item-shard merge's n_shards x K, the sampled
//    candidates, ml-1m): the row streams into shared memory by 16-byte
//    cp.async copies, 8 in flight a thread, each chunk turned into order keys
//    in place as it lands while the first digit is counted; every later pass
//    reads shared memory. A gowalla row takes 154 KB of the block's 227 KB.
//  - streamed (longer rows, Amazon-Book's 91,599 items): the same passes over
//    the row in device memory (the second read mostly from L2), the
//    candidates in shared memory.
// A row may start anywhere 4-byte aligned and rows may lie apart (a slice of
// a wider block): loads take the row's aligned 16-byte chunks and drop the
// words outside it. The kernel launches on the caller's stream, allocates
// nothing, and reads nothing back, so a CUDA graph captures it.

#include <cuda_runtime.h>
#include <stdint.h>

// a named namespace: a trace names the kernel neurec::topk_kernel<...>
namespace neurec {

constexpr int SMEM_MAX = 232448;  // a block's dynamic shared memory on the H100 (227 KB)
constexpr int RESIDENT_MAX_ITEMS = 49877;
constexpr int G = 1024;               // threads a block, a row
constexpr int ROUND = 1024;           // winners a round
constexpr int MIN_CANDIDATES = 1024;  // a resident row leaves room for at least these
constexpr int D0 = 12;                // the first digit's bits
constexpr int NB0 = 1 << D0;
constexpr int MAX_DEVICES = 16;
constexpr unsigned FULL = 0xffffffffu;

struct Ctrl {
  unsigned long long last;  // the previous round's least winner: later rounds take composites below it
  unsigned bin, above, in_bin;  // the scan's bin, the entries above it and in it
  unsigned nwin, ncand;         // winners and candidates appended
  unsigned total;               // block_exclusive's
  unsigned warp_sums[32];       // block_exclusive's
};
static_assert(sizeof(Ctrl) % 16 == 0, "the winners after the control block stay 16-byte aligned");

// shared memory a row takes besides its staged keys, winners and candidates
constexpr int FIXED_BYTES = 4 * NB0 + (int)sizeof(Ctrl);

// 16-byte chunks a row spans at most (it may start 3 words into its first)
__host__ __device__ constexpr int row_bytes(int I) { return 16 * ((I + 6) / 4); }

constexpr int resident_bytes(int I) {
  return row_bytes(I) + 8 * (ROUND + MIN_CANDIDATES) + FIXED_BYTES;
}
static_assert(resident_bytes(RESIDENT_MAX_ITEMS) <= SMEM_MAX, "a resident row and its buffers fit a block");
static_assert(resident_bytes(RESIDENT_MAX_ITEMS + 1) > SMEM_MAX, "RESIDENT_MAX_ITEMS is the longest such row");

struct Args {
  const float* x;
  long long ld;  // row stride, in floats
  int B, I, k;
  float* vals;
  long long* ids;
  int round;        // winners a round
  int cap;          // candidates the buffer holds
  int row_bytes;    // the staged row (0 on the streamed path)
};

// unsigned keys whose order is the IEEE total order of the floats' bits
__device__ __forceinline__ unsigned order_key(unsigned bits) {
  return bits ^ ((unsigned)((int)bits >> 31) | 0x80000000u);
}

__device__ __forceinline__ unsigned value_bits(unsigned key) {
  return key ^ ((key & 0x80000000u) ? 0x80000000u : FULL);
}

__device__ __forceinline__ unsigned long long composite(unsigned key, int e, int idbits, unsigned idmask) {
  return ((unsigned long long)key << 32) | ((unsigned long long)(idmask - (unsigned)e) << (32 - idbits));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"((unsigned)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// one count of `bin` (a negative bin: none); every lane calls it. Atomics that
// return nothing, so no lane waits on one; a warp of one bin (a row of one
// value) adds its 32 at once rather than 32 times to one address
__device__ __forceinline__ void hist_add(unsigned* hist, int bin) {
  const int first = __shfl_sync(FULL, bin, 0);
  if (__all_sync(FULL, bin == first)) {
    if ((threadIdx.x & 31u) == 0 && first >= 0) atomicAdd(hist + first, 32u);
  } else if (bin >= 0) {
    atomicAdd(hist + bin, 1u);
  }
}

// four composites a lane, and whether each is an entry of the row
struct Quad {
  unsigned long long c[4];
  bool valid[4];
};

// a 16-byte chunk of the row: four order keys, the first word's entry, and
// whether each is an entry of the row
struct Keys {
  unsigned key[4];
  int e;
  bool valid[4];
};

// append the composites at(i) that take marks to dst, in slots from one
// atomic a warp for all four; every lane calls it
template <class At>
__device__ __forceinline__ void append(unsigned long long* dst, unsigned* count, const bool (&take)[4], At&& at) {
  unsigned ball[4], total = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    ball[i] = __ballot_sync(FULL, take[i]);
    total += __popc(ball[i]);
  }
  if (total == 0u) return;
  const unsigned lane = threadIdx.x & 31u;
  unsigned base = 0;
  if (lane == 0) base = atomicAdd(count, total);
  base = __shfl_sync(FULL, base, 0);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (take[i]) dst[base + __popc(ball[i] & ((1u << lane) - 1u))] = at(i);
    base += __popc(ball[i]);
  }
}

// f(keys) over the row's 16-byte chunks, a chunk a lane and call, each thread
// the same number of calls (f's warp primitives take the whole warp). GLOBAL:
// the chunks are the row's floats in device memory; else its keys in shared.
// The hot sweeps stay in 32 bits; composites are made where they are needed.
template <bool GLOBAL, class F>
__device__ __forceinline__ void sweep_row(const uint4* w, int m, int I, int tid, F&& f) {
  const int nch = (I + m + 3) >> 2;
  const int trips = (nch + G - 1) / G;
  for (int t = 0; t < trips; ++t) {
    const int j = t * G + tid;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (j < nch) {
      if constexpr (GLOBAL) v = __ldg(w + j); else v = w[j];
    }
    const unsigned word[4] = {v.x, v.y, v.z, v.w};
    Keys k;
    k.e = 4 * j - m;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      k.key[i] = GLOBAL ? order_key(word[i]) : word[i];
      k.valid[i] = k.e + i >= 0 && k.e + i < I;
    }
    f(k);
  }
}

// f(quad) over n candidates, four a lane and call
template <class F>
__device__ __forceinline__ void sweep_cands(const unsigned long long* c, int n, int tid, F&& f) {
  const int trips = (n + 4 * G - 1) / (4 * G);
  for (int t = 0; t < trips; ++t) {
    Quad q;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int at = (4 * t + i) * G + tid;
      q.valid[i] = at < n;
      q.c[i] = at < n ? c[at] : 0ull;
    }
    f(q);
  }
}

// the exclusive prefix of v over the block's threads, and its total; every
// thread calls it (its barriers leave ctrl's warp sums free once it returns)
__device__ __forceinline__ unsigned block_exclusive(unsigned v, unsigned* total, Ctrl* ctrl, int tid) {
  const int lane = tid & 31, warp = tid >> 5;
  unsigned incl = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned u = __shfl_up_sync(FULL, incl, o);
    if (lane >= o) incl += u;
  }
  static_assert(G / 32 == 32, "a warp's lanes take the block's warp sums");
  if (lane == 31) ctrl->warp_sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const unsigned x = ctrl->warp_sums[lane];
    unsigned w = x;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned u = __shfl_up_sync(FULL, w, o);
      if (lane >= o) w += u;
    }
    ctrl->warp_sums[lane] = w - x;
    if (lane == 31) ctrl->total = w;
  }
  __syncthreads();
  *total = ctrl->total;
  return incl - v + ctrl->warp_sums[warp];
}

// the bin of the need-th largest entry counted in hist's NBINS bins (need >= 1
// and no more than the count), the entries in the bins above it and in it: a
// scan over the block's threads, each taking PER bins from the top; the thread
// where the count reaches need walks its own. Every thread calls it.
template <int NBINS>
__device__ __forceinline__ void scan(const unsigned* hist, Ctrl* ctrl, unsigned need, int tid) {
  constexpr int PER = NBINS >= G ? NBINS / G : 1;
  const int top = NBINS - 1 - PER * tid;
  unsigned h[PER], s = 0;
  if constexpr (PER % 4 == 0) {  // 16-byte loads: a thread's bins are whole, aligned quads
#pragma unroll
    for (int q = 0; q < PER; q += 4) {
      const uint4 v = *reinterpret_cast<const uint4*>(hist + top - q - 3);
      h[q] = v.w;
      h[q + 1] = v.z;
      h[q + 2] = v.y;
      h[q + 3] = v.x;
    }
  } else {
#pragma unroll
    for (int q = 0; q < PER; ++q) h[q] = top - q >= 0 ? hist[top - q] : 0u;
  }
#pragma unroll
  for (int q = 0; q < PER; ++q) s += h[q];
  unsigned total;
  unsigned run = block_exclusive(s, &total, ctrl, tid);
  if (run < need && need <= run + s) {
    bool found = false;  // no break: the bins stay in registers
#pragma unroll
    for (int q = 0; q < PER; ++q) {
      if (!found && run + h[q] >= need) {
        ctrl->bin = top - q;
        ctrl->above = run;
        ctrl->in_bin = h[q];
        found = true;
      }
      if (!found) run += h[q];
    }
  }
}

template <bool RESIDENT>
__device__ __forceinline__ void topk_row(const Args& a, long long row, unsigned char* s, int tid) {
  const float* xr = a.x + row * a.ld;
  const int m = (int)((reinterpret_cast<uintptr_t>(xr) >> 2) & 3);
  const uint4* gx = reinterpret_cast<const uint4*>(xr - m);
  const int I = a.I;
  const int idbits = I > 1 ? 32 - __clz(I - 1) : 1;
  const unsigned idmask = (1u << idbits) - 1u;
  // the row's staged keys, the histogram, the control block, the winners and
  // the candidates, each 16-byte aligned but the last
  uint4* rowk = reinterpret_cast<uint4*>(s);
  unsigned* hist = reinterpret_cast<unsigned*>(s + a.row_bytes);
  Ctrl* ctrl = reinterpret_cast<Ctrl*>(hist + NB0);
  unsigned long long* win = reinterpret_cast<unsigned long long*>(ctrl + 1);
  unsigned long long* cand = win + a.round;
  const uint4* src = RESIDENT ? rowk : gx;
  auto over_row = [&](auto&& f) { sweep_row<!RESIDENT>(src, m, I, tid, f); };
  auto comp = [&](const Keys& k, int i) { return composite(k.key[i], k.e + i, idbits, idmask); };

  if constexpr (RESIDENT) {  // stage the row's keys, counting the first digit on the way in
    // 16-byte cp.async copies straight into shared memory, DEPTH a thread in
    // flight ahead of the chunk it turns into keys: each thread keys the
    // chunks it copied, so the copies need no barrier
    constexpr int DEPTH = 8;
    for (int i = tid; i < NB0; i += G) hist[i] = 0;
    __syncthreads();
    const int nch = (I + m + 3) >> 2;
    const int trips = (nch + G - 1) / G;
#pragma unroll
    for (int i = 0; i < DEPTH - 1; ++i) {
      const int j = i * G + tid;
      if (j < nch) cp_async16(rowk + j, gx + j);
      cp_async_commit();
    }
    for (int i = 0; i < trips; ++i) {
      const int ahead = (i + DEPTH - 1) * G + tid;
      if (ahead < nch) cp_async16(rowk + ahead, gx + ahead);
      cp_async_commit();
      cp_async_wait<DEPTH - 1>();
      const int j = i * G + tid;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (j < nch) v = rowk[j];
      const unsigned kw[4] = {order_key(v.x), order_key(v.y), order_key(v.z), order_key(v.w)};
      if (j < nch) rowk[j] = make_uint4(kw[0], kw[1], kw[2], kw[3]);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int e = 4 * j + q - m;
        hist_add(hist, e >= 0 && e < I ? (int)(kw[q] >> (32 - D0)) : -1);
      }
    }
    cp_async_wait<0>();
  }

  // the last round's least winner: later rounds take the entries below it
  unsigned last_key = FULL;
  int last_id = -1;
  for (int base = 0; base < a.k;) {
    const unsigned n_round = (unsigned)min(a.k - base, a.round);
    const bool first = base == 0;
    auto below = [&](const Keys& k, int i) {
      return first || k.key[i] < last_key || (k.key[i] == last_key && k.e + i > last_id);
    };
    if (!RESIDENT || !first) {
      for (int i = tid; i < NB0; i += G) hist[i] = 0;
      __syncthreads();
      over_row([&](const Keys& k) {
#pragma unroll
        for (int i = 0; i < 4; ++i) hist_add(hist, k.valid[i] && below(k, i) ? (int)(k.key[i] >> (32 - D0)) : -1);
      });
    }
    __syncthreads();
    if (tid == 0) {
      ctrl->nwin = 0;
      ctrl->ncand = 0;
    }
    scan<NB0>(hist, ctrl, n_round, tid);
    __syncthreads();
    // the key's next digits over the row (12 bits, then the last 8) while
    // the bin of the K-th overflows the candidate buffer: scores of a narrow
    // spread share their top bits
    int res = D0;  // the key's bits resolved
    unsigned prefix = ctrl->bin, need = n_round - ctrl->above, in_bin = ctrl->in_bin;
    while (in_bin != need && in_bin > (unsigned)a.cap && res < 32) {
      const int width = 32 - res < D0 ? 32 - res : D0, shift = 32 - res - width;
      for (int i = tid; i < NB0; i += G) hist[i] = 0;
      __syncthreads();
      over_row([&](const Keys& k) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const bool live = k.valid[i] && (k.key[i] >> (32 - res)) == prefix && below(k, i);
          hist_add(hist, live ? (int)((k.key[i] >> shift) & ((1u << width) - 1u)) : -1);
        }
      });
      __syncthreads();
      scan<NB0>(hist, ctrl, need, tid);
      __syncthreads();
      prefix = (prefix << width) | ctrl->bin;
      res += width;
      need -= ctrl->above;
      in_bin = ctrl->in_bin;
    }
    const bool done = in_bin == need;
    const bool fits = !done && in_bin <= (unsigned)a.cap;
    // the split: above the bin, winners; the bin, winners (done), candidates
    // (fits), or, where one key has more entries than the buffer holds, left
    // for the ties' pass
    const int rshift = 32 - res;
    const unsigned lo = prefix << rshift;  // the bin's least key
    over_row([&](const Keys& k) {
      const unsigned top = max(max(k.key[0], k.key[1]), max(k.key[2], k.key[3]));
      if (!__any_sync(FULL, top >= lo)) return;
      bool to_win[4], to_cand[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const unsigned d = k.key[i] >> rshift;
        const bool live = k.valid[i] && d >= prefix && below(k, i);
        to_win[i] = live && (d > prefix || done);
        to_cand[i] = fits && live && d == prefix;
      }
      auto at = [&](int i) { return comp(k, i); };
      append(win, &ctrl->nwin, to_win, at);
      if (fits) append(cand, &ctrl->ncand, to_cand, at);
    });
    __syncthreads();
    const int ncand = (int)ctrl->ncand;
    if (fits && ncand <= G) {
      // few candidates: the need highest by their rank among them
      if (tid < ncand) {
        const unsigned long long c = cand[tid];
        unsigned r = 0;
        for (int j = 0; j < ncand; ++j) r += cand[j] > c;
        if (r < need) win[atomicAdd(&ctrl->nwin, 1u)] = c;
      }
      __syncthreads();
    } else if (fits) {
      // 8-bit digits of the candidates' composites under the resolved
      // prefix, until a bin's entries all win
      unsigned long long prefix64 = (unsigned long long)prefix << (64 - res), resolved = ~0ull << (64 - res);
      for (int shift = 64 - res; shift > 0;) {
        shift = shift > 8 ? shift - 8 : 0;
        for (int i = tid; i < 256; i += G) hist[i] = 0;
        __syncthreads();
        sweep_cands(cand, ncand, tid, [&](const Quad& q) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const unsigned long long c = q.c[i];
            hist_add(hist, q.valid[i] && (c & resolved) == prefix64 ? (int)((c >> shift) & 255u) : -1);
          }
        });
        __syncthreads();
        scan<256>(hist, ctrl, need, tid);
        __syncthreads();
        prefix64 |= (unsigned long long)ctrl->bin << shift;
        resolved = ~0ull << shift;
        need -= ctrl->above;
        if (ctrl->in_bin == need) break;  // the bin's entries all win
      }
      // the bin's winners: every candidate from the prefix up
      sweep_cands(cand, ncand, tid, [&](const Quad& q) {
        bool to_win[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) to_win[i] = q.valid[i] && q.c[i] >= prefix64;
        append(win, &ctrl->nwin, to_win, [&](int i) { return q.c[i]; });
      });
      __syncthreads();
    } else if (!done) {
      // the ties: the need first entries of the K-th key in the row's order
      // (a chunk a lane, the lanes and warps in order), by a count over the
      // threads a pass of chunks
      unsigned taken = 0;
      over_row([&](const Keys& k) {
        bool tie[4];
        unsigned n = 0;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          tie[i] = k.valid[i] && k.key[i] == prefix && below(k, i);
          n += tie[i];
        }
        unsigned total;
        unsigned rank = taken + block_exclusive(n, &total, ctrl, tid);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (tie[i] && rank < need) win[atomicAdd(&ctrl->nwin, 1u)] = comp(k, i);
          rank += tie[i];
        }
        taken += total;
      });
      __syncthreads();
    }
    // each winner's rank is the count of winners above it
    const int nwin = (int)ctrl->nwin;
    float* vo = a.vals + row * a.k + base;
    long long* io = a.ids + row * a.k + base;
    for (int i = tid; i < nwin; i += G) {
      const unsigned long long c = win[i];
      int r = 0;
      for (int j = 0; j < nwin; ++j) r += win[j] > c;
      vo[r] = __uint_as_float(value_bits((unsigned)(c >> 32)));
      io[r] = (long long)(idmask - (unsigned)((c & 0xffffffffull) >> (32 - idbits)));
      if (r == nwin - 1) ctrl->last = c;
    }
    __syncthreads();
    last_key = (unsigned)(ctrl->last >> 32);
    last_id = (int)(idmask - (unsigned)((ctrl->last & 0xffffffffull) >> (32 - idbits)));
    if (nwin == 0) break;
    base += nwin;
  }
}

// a block a row
template <bool RESIDENT>
__global__ void __launch_bounds__(G) topk_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  topk_row<RESIDENT>(a, blockIdx.x, smem, threadIdx.x);
}

template <bool RESIDENT>
int launch(const Args& a, int smem, cudaStream_t stream) {
  static int attr_set[MAX_DEVICES];
  int dev;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  auto kernel = topk_kernel<RESIDENT>;
  if (!attr_set[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
    if (err != cudaSuccess) return (int)err;
    attr_set[dev] = 1;
  }
  kernel<<<(unsigned)a.B, G, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace neurec

using namespace neurec;

// x: B rows of I floats, row r at x + r * ld (ld >= I, 4-byte aligned);
// vals (B, k) f32 and ids (B, k) int64, contiguous; 1 <= k <= I. *path: the
// path taken, 0 resident (I <= 49,877), 1 streamed (longer rows, or any row
// where `streamed` asks for it: the tests hold both paths to one answer).
extern "C" int neurec_topk(const float* x, long long ld, int B, int I, int k, float* vals, long long* ids,
                           int streamed, int* path, cudaStream_t stream) {
  if (I <= 0 || k < 1 || k > I || ld < I) return (int)cudaErrorInvalidValue;
  const bool resident = !streamed && I <= RESIDENT_MAX_ITEMS;
  *path = resident ? 0 : 1;
  if (B <= 0) return 0;
  Args a{x, ld, B, I, k, vals, ids, 0, 0, 0};
  a.round = k < ROUND ? k : ROUND;
  a.row_bytes = resident ? row_bytes(I) : 0;
  const long long room = ((long long)SMEM_MAX - a.row_bytes - 8LL * a.round - FIXED_BYTES) / 8;
  a.cap = (int)(room < I ? room : I);  // room >= MIN_CANDIDATES on both paths (resident_bytes)
  const int smem = a.row_bytes + 8 * (a.round + a.cap) + FIXED_BYTES;
  return resident ? launch<true>(a, smem, stream) : launch<false>(a, smem, stream);
}

extern "C" const char* neurec_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

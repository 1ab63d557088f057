// K1: fused full-catalogue score + train-item mask, f32 in and out, for
// sm_90a.
//
// Replaces the Pallas TPU kernel neurec_tpu/ops/pallas_kernels.py
// ::_masked_scores_kernel (driven by masked_scores): out[b, i] =
// u[b] . items[i], or -inf where user b's mask marks item i. u is (B, d)
// and items (I, d), both row-major; out is (B, I), each real column written
// exactly once.
//
// Mask formats (template parameter MODE):
//   0  int8 membership, mask[b * mask_stride + i] != 0 (the Pallas
//      kernel's own operand, built by build_train_mask);
//   1  bit-plane bytes of the evaluator's default "bits" tier with one
//      global block of width W: item i sits in byte i % (W/8), bit
//      i / (W/8) of row b (plane_bytes = W/8).
//
// What bounds it on the H100. At the eval shapes (B 2048, I 38,546) the
// (B, I) f32 output alone is 315.8 MB: 0.094 ms at 3.35 TB/s. The product
// is 10.1 GFLOP at d 64 and 40.4 GFLOP at d 256, 0.15 / 0.60 ms at the
// 67 TFLOP/s of f32 outside the tensor cores, so the tensor cores do it.
//
// Tensor cores at f32 accuracy: a 3xTF32 split. The port keeps TF32 off
// for every f32 product (a one-pass TF32 product keeps ~3 decimal digits).
// Each operand x is split in registers into hi = tf32(x) and
// lo = tf32(x - hi), both rounded to nearest, ties away from zero, as
// cvt.rna.tf32.f32 rounds. Each depth-8 step forms a_lo*b_hi + a_hi*b_lo +
// a_hi*b_hi with three mma.sync.m16n8k8 into a fresh partial, small terms
// first, and an f32 add takes the partial into the accumulator. hi + lo
// carries 22 of x's 24 significant bits and every TF32 product is exact, so
// what is lost is the a_lo*b_lo term and the lo parts' rounding, ~2^-21 of
// a product. The partial matters: the tensor cores do not round their sums
// to nearest, and a first version that chained every step through one
// accumulator missed the 1e-5 bar against the plain f32 product at d 64
// (randn factors); partials of 8 products keep that error small, and the
// adds round to nearest. Three products at 495 TFLOP/s dense TF32: 0.061 /
// 0.245 ms, so at d 64 the store bounds the kernel and at d 256 the
// products do. Non-finite factors give NaN where the plain product may give
// +-inf (the lo part of an inf is inf - inf).
//
// Two paths, one arithmetic (mma.sync, not wgmma: a first design for the
// card's tensor cores). Each warp owns a 32 x 64 sub-tile of a 128 x 128
// output tile (2 x 8 m16n8 tiles, 64 accumulators) and walks 32-deep k
// slabs; both operands are K-major as they lie, and ldmatrix (8 rows of 16
// bytes = a TF32 fragment's 8 x 4 block) loads every fragment free of bank
// conflicts. No atomics: each output is one thread's fixed chain of steps,
// the same bits on every run, and the same bits on either path.
//
//  - The TMA path (16-byte operand rows, whole mask tiles: every evaluator
//    call). One block a SM, warp-specialized: a producer warp keeps TMA
//    loads of the u and item slabs (128-byte swizzled rows) and each tile's
//    mask bytes in flight through a ring of 3 stages and 2 mask slots; 8
//    compute warps take the slabs as they land; 4 store warps stream each
//    finished tile out of a staging buffer while the compute warps go on.
//    With cp.async, the loads and the stores shared the load/store units,
//    and a block's store burst stalled its next loads; here they overlap.
//  - The cp.async path (any d, any alignment, any W): two blocks of 8 warps
//    a SM, two stages of 16-byte copies where d % 4 == 0 and the operands
//    are 16-byte aligned, 4-byte copies otherwise, zero-filled past B, I
//    and d (rows padded to 36 floats); the tile's epilogue reuses the stage.
//    A mask the tile copy cannot take (unaligned, or W/8 not a multiple of
//    128) is read from global memory.
//
// Common to both:
//  - A persistent grid walks the tiles in row bands: consecutive tiles run
//    along the items of one band of 128 users, so the tiles in flight cover
//    about one band: its mask rows (622 KB of the 10 MB bits table) are read
//    from DRAM once and from L2 by the 8 planes' tiles that share each byte,
//    and neighbouring tiles write the two halves of each 32-byte sector
//    their rows share at about the same time. No limit on B or I beyond int
//    indices.
//  - The mask is decoded once per tile: W is a multiple of 1024 in the
//    evaluator (tiers.global_bits_width), so W/8 is a multiple of 128 and a
//    128-aligned item tile lies inside one bit plane: one plane index and
//    one base byte per tile, one shift per byte, two bytes (two columns) a
//    read. Any W that is a multiple of 8 is right: an item past the tile's
//    plane takes the division.
//  - The epilogue stages the masked rows in shared memory, each row shifted
//    by its misalignment in the output, so that every lane writes 16
//    aligned bytes and a half warp 256 contiguous bytes (I is odd in
//    general, so rows start at any float). The stores stream past L2
//    (st.global.cs): the output is far larger than L2.
//
// What holds it back (PERF.md): the products. The 3xTF32 step spends ~7
// integer and float operations per operand value beside its three mma, and
// two compute warps a scheduler do not hide the mma chains' latency. wgmma,
// reading both operands' hi and lo parts from shared memory, is the next
// design.
//
// The f32 path (d <= FMA_MAX_D, chosen by neurec_masked_scores from d alone;
// ops/masked_scores.py::k1_path states the same choice for the tests). The
// split keeps 22 of 24 significand bits of each operand, ~2^-21 of each
// product, while f32 FMAs add d * 2^-24 of sum |u_k i_k| at most: at small d
// the split is farther from the exact product than f32 itself. There each
// score is one fmaf chain from 0 over k in order, on the CUDA cores
// (neurec_fma_chain, a test entry, computes the same chain a thread a score,
// and the tests hold this path to its bits). The products cost
// 2 B I d / 67 TFLOP/s, under the output's bytes (B I 4 / 3.35 TB/s) for every
// d <= 2 * 67 / 3.35 = 40, so the stores bound it. The design (PERF.md, §6):
//  - A persistent grid of two blocks a SM (the occupancy query's count, 128
//    registers a thread) walks 128 x 128 tiles in row bands, as the split
//    does: the tiles in flight share their users' rows and mask rows in L2.
//    Each block takes its tiles' steps in turn (copies landed, pack and
//    marks, FMAs, epilogue); the other block's steps run beside them.
//  - Output sectors: I is odd in general, so a row's 128 items start
//    anywhere in a 32-byte sector, and with tiles 128 items apart the two
//    tiles beside a boundary each wrote part of its sector: that ran slower
//    than rows of whole sectors (I a multiple of 8). So item tiles
//    start F_STEP = 120 apart and span 128: of each row a tile writes the
//    sectors that start in its 120 items, all inside its 128, and every
//    sector of the output is written whole by one tile (those across a row's
//    end aside). The 8 items a tile computes twice cost 1/15 more FMAs.
//  - Operands: a tile's rows of a contiguous (n, d) f32 array are one run of
//    128 d floats that starts 16-byte aligned at every d (ragged d too)
//    wherever the base is (512 d bytes a user tile, 480 d an item tile), so
//    the run is copied as it lies by 16-byte cp.async (4-byte copies for an
//    unaligned base; a ragged run's last copy reads what is there). The next
//    tile's runs and mask bytes are in flight while this tile multiplies
//    and stores. Each run is packed to rows at a pitch of d rounded up to an
//    odd multiple of 4 floats, so that a quarter warp's 16-byte reads of 8
//    consecutive item rows hit 8 distinct bank groups at every d (at the
//    run's own pitch an even d conflicts): one float4 of 4 depths a column,
//    one broadcast float4 a user row, 20 shared loads to 256 FMAs (16 x 4
//    scores a thread: a warp 16 rows, a lane every 32nd column); the last
//    d % 4 depths take the float4 and use only its first components, so
//    each chain stops at d.
//  - The mask: a tile's 128 x 128 mask bytes copied once, 8 bytes a copy (an
//    item tile 120 apart is 8-byte aligned), each copy inside one bit plane;
//    a tile spans at most two planes (W/8 >= 128), its plane boundary one
//    compare. All of a thread's marks are read into a 64-bit word as the
//    tile starts, so the mask room takes the next tile's bytes at once. A
//    layout the copy cannot take (W/8 not a multiple of 8 or under 128, an
//    unaligned table) is read from global memory (marked_global).
//  - The epilogue, a warp at a time: the split's staging (the masked rows, 8
//    at a time, over the packed rows the FMAs are done with, each shifted by
//    its misalignment in the output), then each row's aligned part as one
//    bulk copy to global memory (cp.async.bulk, evict-first in L2: streaming
//    16-byte-aligned stores issued by the copy engine, a lane a row), its
//    unaligned ends at a row's start or end by st.global.cs.
//  Tried and slower: 4 store warps beside 8 compute warps (one block a SM, as
//  the TMA path), which kept too few stores in flight; the same stores from
//  the warps themselves (store_slot, st.global.cs), which slowed the FMAs
//  beside them; 64 x 128 tiles at three blocks a SM. What holds it back: a
//  block's FMAs wait for the copy engine to read its staged rows, and the
//  staged rows go over the packed ones for want of shared memory, so at d >=
//  16 the FMAs and the stores add up rather than overlap.

#include <cuda.h>  // CUtensorMap; the encoder comes through cudaGetDriverEntryPoint
#include <cudaTypedefs.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;             // users per tile
constexpr int BN = 128;             // items per tile
constexpr int BK = 32;              // depth per stage
constexpr int STAGES = 2;
constexpr int LDK = BK + 4;         // padded row of a staged slab (floats)
constexpr int WARPS = 8;            // 4 along users x 2 along items
constexpr int THREADS = WARPS * 32;
constexpr int BLOCKS_PER_SM = 2;
constexpr int WM = 32, WN = 64;     // a warp's sub-tile
constexpr int MT = WM / 16, NT = WN / 8;
constexpr int EPI_ROWS = 16;        // epilogue rows a warp stages at once
constexpr int EPI_LD = WN + 4;      // room for a shift of up to 3 floats
constexpr int EPI_SLOTS = WN / 4 + 1;  // 16-byte slots a shifted row spans
constexpr int MASK_TILE = BM * BN;  // mask bytes of a tile, one per item
constexpr int SLAB_FLOATS = (BM + BN) * LDK;  // a staged u slab and item slab
// a stage: the slabs, and on a tile's last slab the tile's mask bytes
constexpr int STAGE_FLOATS = SLAB_FLOATS + MASK_TILE / 4;
constexpr int SMEM_BYTES = STAGES * STAGE_FLOATS * 4;
static_assert(WARPS * EPI_ROWS * EPI_LD <= SLAB_FLOATS, "the epilogue reuses a stage's slabs");
constexpr int MAX_DEVICES = 16;

struct Args {
  const float* u;
  const float* items;
  const uint8_t* mask;
  float* out;
  int B, I, d;
  long long mask_stride;
  int plane_bytes;
  int m_tiles, n_tiles;
  int mask_tiles;  // whole mask tiles copied to shared memory (aligned, one plane a tile)
};

// Round to TF32 (10 mantissa bits), nearest, ties away from zero, as
// cvt.rna.tf32.f32 does on every value but NaN: add half of the dropped 13
// bits' range to the magnitude's bits and clear them (the carry takes the
// largest finite floats to inf). Two integer operations. Only the hi part
// needs a guard, which keeps inf and NaN (the instruction would clear a
// NaN's low payload bits, and a NaN with no other payload becomes inf):
// x - hi is finite wherever x is.
__device__ __forceinline__ uint32_t rna_tf32(uint32_t x) { return (x + 0x1000u) & 0xffffe000u; }

__device__ __forceinline__ uint32_t to_tf32(float x) {
  return isfinite(x) ? rna_tf32(__float_as_uint(x)) : __float_as_uint(x);
}

__device__ __forceinline__ void split(uint32_t x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(__uint_as_float(x));
  lo = rna_tf32(__float_as_uint(__uint_as_float(x) - __uint_as_float(hi)));
}

__device__ __forceinline__ void mma_tf32(float* c, const uint32_t* a, const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c = a * b, from a zero accumulator
__device__ __forceinline__ void mma_tf32_first(float* c, const uint32_t* a, const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%10,%10,%10,%10};\n"
      : "=f"(c[0]), "=f"(c[1]), "=f"(c[2]), "=f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]), "f"(0.f));
}

// four 8 x 4 f32 blocks (8 rows of 16 bytes), one register each; lanes
// 8m..8m+7 give block m's row addresses
__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const float* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

// cp.async of UNIT bytes; src_bytes 0 zero-fills the destination
template <int UNIT>
__device__ __forceinline__ void cp_async(void* dst, const void* src, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (UNIT == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(src_bytes)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src), "r"(src_bytes)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

// Where a thread's copies of a tile's slabs come from: its first u row and
// item row (the others ROW_STEP rows apart), and which of them exist.
template <int UNIT>
struct Source {
  static constexpr int PER_ROW = BK * 4 / UNIT;  // copies per staged row
  static constexpr int ROW_STEP = THREADS / PER_ROW;
  static constexpr int EACH = BM / ROW_STEP;      // copies per thread and operand
  static_assert(BM == BN, "one loop stages both operands");
  const float* u;
  const float* items;
  uint32_t u_ok, i_ok;  // bit i: row i exists

  __device__ __forceinline__ void at(const Args& a, int m0, int n0) {
    const int row = (int)threadIdx.x / PER_ROW, kc = ((int)threadIdx.x % PER_ROW) * (UNIT / 4);
    u = a.u + (size_t)min(m0 + row, a.B - 1) * a.d + kc;
    items = a.items + (size_t)min(n0 + row, a.I - 1) * a.d + kc;
    u_ok = i_ok = 0;
#pragma unroll
    for (int i = 0; i < EACH; ++i) {
      u_ok |= (uint32_t)(m0 + row + i * ROW_STEP < a.B) << i;
      i_ok |= (uint32_t)(n0 + row + i * ROW_STEP < a.I) << i;
    }
  }

  // k slab k0 of the tile into a stage's slabs
  __device__ __forceinline__ void load(const Args& a, float* As, float* Bs, int k0) const {
    const int row = (int)threadIdx.x / PER_ROW, kc = ((int)threadIdx.x % PER_ROW) * (UNIT / 4);
    const bool k_ok = k0 + kc < a.d;  // UNIT 16 only when d % 4 == 0
    const size_t step = (size_t)ROW_STEP * a.d;
#pragma unroll
    for (int i = 0; i < EACH; ++i) {
      const int off = (row + i * ROW_STEP) * LDK + kc;
      const bool uo = k_ok && (u_ok >> i & 1), io = k_ok && (i_ok >> i & 1);
      cp_async<UNIT>(As + off, uo ? u + i * step + k0 : a.u, uo ? UNIT : 0);
      cp_async<UNIT>(Bs + off, io ? items + i * step + k0 : a.items, io ? UNIT : 0);
    }
  }
};

// A tile's mask bytes, 128 a row from byte `off0` of each mask row (the
// tile's first item, or its first byte in the plane).
__device__ __forceinline__ void load_mask_tile(const Args& a, uint8_t* Ms, int m0, int off0) {
#pragma unroll
  for (int i = 0; i < MASK_TILE / 16 / THREADS; ++i) {
    const int c = (int)threadIdx.x + i * THREADS;
    const int row = c / (BN / 16), ch = (c % (BN / 16)) * 16;
    const bool ok = m0 + row < a.B;
    cp_async<16>(Ms + row * BN + ch, ok ? a.mask + (m0 + row) * a.mask_stride + off0 + ch : a.mask,
                 ok ? 16 : 0);
  }
}

// Is item c of row r marked, read from global memory? For the layouts that
// the tile copy does not take. `plane0` and `pb = plane0 * P` are the tile's
// plane and its first byte; an item past that plane takes the division.
template <int MODE>
__device__ __forceinline__ bool marked_global(const Args& a, int r, int c, int plane0, int pb) {
  const uint8_t* mrow = a.mask + (long long)r * a.mask_stride;
  if (MODE == 0) return mrow[c] != 0;
  const int P = a.plane_bytes;
  const int off = c - pb;
  if (off < P) return (mrow[off] >> plane0) & 1;
  const int p = c / P;
  return (mrow[c - p * P] >> p) & 1;
}

// One 16-byte slot of an output row, `o` at column c_first (16-byte
// aligned): the columns in [lo, hi) only, as one vector store where the
// slot lies inside, else column by column (a row's ragged ends).
__device__ __forceinline__ void store_slot(float* o, int c_first, const float4& v, int lo, int hi) {
  if (c_first >= lo && c_first + 4 <= hi) {
    __stcs(reinterpret_cast<float4*>(o), v);
    return;
  }
  if (c_first >= lo && c_first < hi) __stcs(o, v.x);
  if (c_first + 1 >= lo && c_first + 1 < hi) __stcs(o + 1, v.y);
  if (c_first + 2 >= lo && c_first + 2 < hi) __stcs(o + 2, v.z);
  if (c_first + 3 >= lo && c_first + 3 < hi) __stcs(o + 3, v.w);
}

// A staged mask byte as a mark: int8 membership, or the tile's bit plane
template <int MODE>
__device__ __forceinline__ bool byte_marks(uint32_t byte, int plane0) {
  return MODE == 0 ? (byte & 0xffu) != 0 : (byte >> plane0) & 1u;
}

// Where the step loop stands: tile j of this block, k slab k, at (m0, n0).
// Tiles run in row bands: tile t covers users t / n_tiles, items t % n_tiles.
struct Cursor {
  int j, k, m0, n0;

  __device__ __forceinline__ void at_tile(const Args& a) {
    const int t = (int)blockIdx.x + j * (int)gridDim.x;
    const int m = t / a.n_tiles;
    m0 = m * BM;
    n0 = (t - m * a.n_tiles) * BN;
  }

  __device__ __forceinline__ void next(const Args& a, int KS) {
    if (++k < KS) return;
    k = 0;
    ++j;
    at_tile(a);
  }
};

template <int MODE, int UNIT>
__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM) masked_scores_kernel(const Args a) {
  extern __shared__ __align__(16) float smem[];
  const int warp = (int)threadIdx.x >> 5, lane = (int)threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int wm = (warp & 3) * WM, wn = (warp >> 2) * WN;
  // ldmatrix row addresses: block lane / 8 of a fragment, row lane % 8
  const int lm = lane >> 3, lr = lane & 7;
  const int a_row = wm + lr + (lm & 1) * 8, a_col = (lm >> 1) * 4;  // a0..a3
  const int b_row = wn + lr + (lm >> 1) * 8, b_col = (lm & 1) * 4;  // b0, b1 of two n tiles

  const int KS = (a.d + BK - 1) / BK;
  const int tiles = a.m_tiles * a.n_tiles;
  const int my_tiles = (tiles - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;
  const int steps = my_tiles * KS;

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  Cursor ld{0, 0, 0, 0};  // the next slab to load
  ld.at_tile(a);
  Cursor cur = ld;        // the slab to compute
  Source<UNIT> src;
  src.at(a, ld.m0, ld.n0);
  auto issue = [&](int s) {  // step s's slab, and on a tile's last slab its mask
    if (s < steps) {
      float* As = smem + (s % STAGES) * STAGE_FLOATS;
      src.load(a, As, As + BM * LDK, ld.k * BK);
      if (ld.k == KS - 1 && a.mask_tiles)
        load_mask_tile(a, reinterpret_cast<uint8_t*>(As + SLAB_FLOATS), ld.m0,
                       MODE == 0 ? ld.n0 : ld.n0 % a.plane_bytes);
      ld.next(a, KS);
      if (ld.k == 0 && s + 1 < steps) src.at(a, ld.m0, ld.n0);
    }
    cp_async_commit();  // an empty group past the end keeps the count
  };

  issue(0);
  for (int s = 0; s < steps; ++s) {
    cp_async_wait_all();
    __syncthreads();  // step s has landed; every warp is done with step s - 1's stage
    issue(s + 1);

    const float* As = smem + (s % STAGES) * STAGE_FLOATS;
    const float* Bs = As + BM * LDK;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 8) {
      uint32_t ah[MT][4], al[MT][4], bh[NT][2], bl[NT][2];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        uint32_t x[4];
        ldmatrix_x4(x, As + (a_row + 16 * i) * LDK + kk + a_col);
#pragma unroll
        for (int e = 0; e < 4; ++e) split(x[e], ah[i][e], al[i][e]);
      }
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        uint32_t x[4];
        ldmatrix_x4(x, Bs + (b_row + 8 * j) * LDK + kk + b_col);
        split(x[0], bh[j][0], bl[j][0]);
        split(x[1], bh[j][1], bl[j][1]);
        split(x[2], bh[j + 1][0], bl[j + 1][0]);
        split(x[3], bh[j + 1][1], bl[j + 1][1]);
      }
      // each m16n8 tile: a fresh partial of the three products, small
      // terms first, then one f32 add into the accumulator
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          float t[4];
          mma_tf32_first(t, al[i], bh[j]);
          mma_tf32(t, ah[i], bl[j]);
          mma_tf32(t, ah[i], bh[j]);
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][j][e] += t[e];
        }
    }

    const int m0 = cur.m0, n0 = cur.n0;
    const bool last = cur.k == KS - 1;
    cur.next(a, KS);
    if (!last) continue;
    // -- epilogue of the tile: mask the accumulators, stage them by rows in
    // this stage's slabs (once every warp is done with them), then 16-byte
    // streaming stores
    __syncthreads();
    float* eb = smem + (s % STAGES) * STAGE_FLOATS + warp * EPI_ROWS * EPI_LD;
    const uint8_t* Ms = reinterpret_cast<const uint8_t*>(As + SLAB_FLOATS);
    const int cw0 = n0 + wn;
    const int cw_end = min(cw0 + WN, a.I);
    const int plane0 = MODE == 1 ? n0 / a.plane_bytes : 0;
    const int pb = plane0 * a.plane_bytes;
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const int r_base = m0 + wm + 16 * i;
      if (cw0 < a.I && r_base < a.B) {  // warp-uniform
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int rr = g + 8 * h, r = r_base + rr;
          // the row's first column sits (r * I + cw0) % 4 floats past a
          // 16-byte boundary: shift the staged row by as much
          const int sh = ((r & 3) * (a.I & 3) + cw0) & 3;
          float* dst = eb + rr * EPI_LD + sh + 2 * tq;
          const uint8_t* mt = Ms + (wm + 16 * i + rr) * BN + wn + 2 * tq;
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            bool m_a, m_b;
            if (a.mask_tiles) {
              const uint32_t pair = *reinterpret_cast<const uint16_t*>(mt + 8 * j);
              m_a = byte_marks<MODE>(pair, plane0);
              m_b = byte_marks<MODE>(pair >> 8, plane0);
            } else {
              const int c = cw0 + 8 * j + 2 * tq;
              m_a = r < a.B && c < a.I && marked_global<MODE>(a, r, c, plane0, pb);
              m_b = r < a.B && c + 1 < a.I && marked_global<MODE>(a, r, c + 1, plane0, pb);
            }
            dst[8 * j] = m_a ? -INFINITY : acc[i][j][2 * h];
            dst[8 * j + 1] = m_b ? -INFINITY : acc[i][j][2 * h + 1];
          }
        }
        __syncwarp();
#pragma unroll
        for (int it = 0; it < (EPI_ROWS * EPI_SLOTS + 31) / 32; ++it) {
          const int idx = lane + 32 * it;
          const int rr = idx / EPI_SLOTS, q = idx - rr * EPI_SLOTS;
          const int r = r_base + rr;
          if (idx < EPI_ROWS * EPI_SLOTS && r < a.B) {
            const int c_first = cw0 - (((r & 3) * (a.I & 3) + cw0) & 3) + 4 * q;
            store_slot(a.out + (long long)r * a.I + c_first, c_first,
                       *reinterpret_cast<const float4*>(eb + rr * EPI_LD + 4 * q), cw0, cw_end);
          }
        }
        __syncwarp();
      }
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
    }
  }
}

// -- the TMA path ------------------------------------------------------------
// Warp-specialized: a producer warp keeps TMA loads of the u and item slabs
// (and each tile's mask bytes) in flight through a ring of stages, 8
// compute warps take the slabs as they land, and 4 store warps stream each
// finished tile from a staging buffer while the compute warps go on to the
// next tile. The loads leave the load/store units to the copy engine, and
// the stores overlap the products instead of stalling them.

constexpr int T_STAGES = 3;
constexpr int T_SLAB_BYTES = BM * BK * 4;           // one operand's slab, 128-byte rows
constexpr int T_STAGE_BYTES = 2 * T_SLAB_BYTES;     // u slab, then item slab
constexpr int T_MASK_SLOTS = 2;
constexpr int T_STG_LD = BN + 4;                    // a staged output row (floats)
constexpr int T_STORE_WARPS = 4;
constexpr int T_THREADS = (WARPS + T_STORE_WARPS + 1) * 32;  // compute, store, producer
constexpr int T_MASK_OFF = T_STAGES * T_STAGE_BYTES;
constexpr int T_STG_OFF = T_MASK_OFF + T_MASK_SLOTS * MASK_TILE;
constexpr int T_BAR_OFF = T_STG_OFF + BM * T_STG_LD * 4;
constexpr int T_BARS = 2 * T_STAGES + 2 * T_MASK_SLOTS + 2;
constexpr int T_SMEM_BYTES = T_BAR_OFF + T_BARS * 8 + 1024;  // + alignment of the base
static_assert(BK * 4 == 128 && BN == 128, "128-byte swizzled rows");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// a box of the tensor map at (x, y) into shared memory, counted on `bar`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int x, int y, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3}], "
      "[%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(bar)
      : "memory");
}

// byte offset of 16-byte chunk `chunk` of row `row` in a 128-byte-swizzled
// box (the TMA's SWIZZLE_128B: chunk index XOR row % 8)
__device__ __forceinline__ uint32_t swz(int row, int chunk) {
  return (uint32_t)(row * 128 + ((chunk ^ (row & 7)) << 4));
}

template <int MODE>
__global__ void __launch_bounds__(T_THREADS, 1)
masked_scores_tma_kernel(const Args a, const __grid_constant__ CUtensorMap tm_u,
                         const __grid_constant__ CUtensorMap tm_items,
                         const __grid_constant__ CUtensorMap tm_mask) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - smem_u32(smem_raw) % 1024) % 1024);  // swizzled boxes: 1024-aligned
  const uint32_t base = smem_u32(smem);
  const uint32_t bars = base + T_BAR_OFF;
  auto full = [&](int s) { return bars + 8 * s; };                 // a stage has landed
  auto empty = [&](int s) { return bars + 8 * (T_STAGES + s); };   // the compute warps are done with it
  auto mask_full = [&](int m) { return bars + 8 * (2 * T_STAGES + m); };
  auto mask_empty = [&](int m) { return bars + 8 * (2 * T_STAGES + T_MASK_SLOTS + m); };
  const uint32_t stg_full = bars + 8 * (T_BARS - 2), stg_empty = bars + 8 * (T_BARS - 1);
  float* stg = reinterpret_cast<float*>(smem + T_STG_OFF);
  const int warp = (int)threadIdx.x >> 5, lane = (int)threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < T_STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), WARPS);
    }
    for (int m = 0; m < T_MASK_SLOTS; ++m) {
      mbar_init(mask_full(m), 1);
      mbar_init(mask_empty(m), WARPS);
    }
    mbar_init(stg_full, WARPS);
    mbar_init(stg_empty, T_STORE_WARPS);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int KS = (a.d + BK - 1) / BK;
  const int tiles = a.m_tiles * a.n_tiles;
  const int my_tiles = (tiles - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;
  Cursor tile{0, 0, 0, 0};
  tile.at_tile(a);

  if (warp == WARPS + T_STORE_WARPS) {  // -- the producer ----------------------
    if (lane != 0) return;
    int it = 0;
    for (int j = 0; j < my_tiles; ++j, tile.next(a, 1)) {
      const int m = j % T_MASK_SLOTS;
      mbar_wait(mask_empty(m), ((j / T_MASK_SLOTS) & 1) ^ 1);
      mbar_expect_tx(mask_full(m), MASK_TILE);
      tma_load(base + T_MASK_OFF + m * MASK_TILE, &tm_mask, MODE == 0 ? tile.n0 : tile.n0 % a.plane_bytes,
               tile.m0, mask_full(m));
      for (int k = 0; k < KS; ++k, ++it) {
        const int s = it % T_STAGES;
        mbar_wait(empty(s), ((it / T_STAGES) & 1) ^ 1);
        mbar_expect_tx(full(s), T_STAGE_BYTES);
        const uint32_t st = base + s * T_STAGE_BYTES;
        tma_load(st, &tm_u, k * BK, tile.m0, full(s));
        tma_load(st + T_SLAB_BYTES, &tm_items, k * BK, tile.n0, full(s));
      }
    }
    return;
  }

  if (warp >= WARPS) {  // -- the store warps: 32 rows of each tile each -------
    const int row0 = (warp - WARPS) * (BM / T_STORE_WARPS);
    constexpr int SLOTS = BN / 4 + 1;  // 16-byte slots a shifted row spans
    for (int j = 0; j < my_tiles; ++j, tile.next(a, 1)) {
      mbar_wait(stg_full, j & 1);
      const int cw_end = min(tile.n0 + BN, a.I);
#pragma unroll 4
      for (int idx = lane; idx < (BM / T_STORE_WARPS) * SLOTS; idx += 32) {
        const int rr = row0 + idx / SLOTS, q = idx % SLOTS;
        const int r = tile.m0 + rr;
        if (r >= a.B) continue;
        const int c_first = tile.n0 - (((r & 3) * (a.I & 3) + tile.n0) & 3) + 4 * q;
        if (c_first >= cw_end) continue;
        store_slot(a.out + (long long)r * a.I + c_first, c_first,
                   *reinterpret_cast<const float4*>(stg + rr * T_STG_LD + 4 * q), tile.n0, cw_end);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(stg_empty);
    }
    return;
  }

  // -- the compute warps --------------------------------------------------------
  const int g = lane >> 2, tq = lane & 3;
  const int wm = (warp & 3) * WM, wn = (warp >> 2) * WN;
  // ldmatrix rows: block lane / 8 of a fragment, row lane % 8 (so row % 8 is
  // lane % 8 in every fragment, the swizzle's XOR)
  const int lm = lane >> 3, lr = lane & 7;
  const int a_row = wm + lr + (lm & 1) * 8, a_chunk = lm >> 1;  // a0..a3
  const int b_row = wn + lr + (lm >> 1) * 8, b_chunk = lm & 1;  // b0, b1 of two n tiles

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  int it = 0;
  for (int jt = 0; jt < my_tiles; ++jt, tile.next(a, 1)) {
    for (int k = 0; k < KS; ++k, ++it) {
      const int s = it % T_STAGES;
      mbar_wait(full(s), (it / T_STAGES) & 1);
      const uint8_t* As = smem + s * T_STAGE_BYTES;
      const uint8_t* Bs = As + T_SLAB_BYTES;
#pragma unroll
      for (int kk = 0; kk < BK; kk += 8) {
        uint32_t ah[MT][4], al[MT][4], bh[NT][2], bl[NT][2];
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          uint32_t x[4];
          ldmatrix_x4(x, reinterpret_cast<const float*>(As + swz(a_row + 16 * i, kk / 4 + a_chunk)));
#pragma unroll
          for (int e = 0; e < 4; ++e) split(x[e], ah[i][e], al[i][e]);
        }
#pragma unroll
        for (int j = 0; j < NT; j += 2) {
          uint32_t x[4];
          ldmatrix_x4(x, reinterpret_cast<const float*>(Bs + swz(b_row + 8 * j, kk / 4 + b_chunk)));
          split(x[0], bh[j][0], bl[j][0]);
          split(x[1], bh[j][1], bl[j][1]);
          split(x[2], bh[j + 1][0], bl[j + 1][0]);
          split(x[3], bh[j + 1][1], bl[j + 1][1]);
        }
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int i = 0; i < MT; ++i) {
            float t[4];
            mma_tf32_first(t, al[i], bh[j]);
            mma_tf32(t, ah[i], bl[j]);
            mma_tf32(t, ah[i], bh[j]);
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[i][j][e] += t[e];
          }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(s));
    }

    // -- the tile's epilogue: mask the accumulators into the staging buffer
    const int m = jt % T_MASK_SLOTS;
    mbar_wait(mask_full(m), (jt / T_MASK_SLOTS) & 1);
    mbar_wait(stg_empty, (jt & 1) ^ 1);
    const uint8_t* Ms = smem + T_MASK_OFF + m * MASK_TILE;
    const int plane0 = MODE == 1 ? tile.n0 / a.plane_bytes : 0;
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int rr = wm + 16 * i + g + 8 * h, r = tile.m0 + rr;
        // the row's first column sits (r * I + n0) % 4 floats past a
        // 16-byte boundary: shift the staged row by as much
        float* dst = stg + rr * T_STG_LD + (((r & 3) * (a.I & 3) + tile.n0) & 3) + wn + 2 * tq;
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const int c = wn + 8 * j + 2 * tq;
          const uint32_t pair = *reinterpret_cast<const uint16_t*>(Ms + swz(rr, c / 16) + c % 16);
          dst[8 * j] = byte_marks<MODE>(pair, plane0) ? -INFINITY : acc[i][j][2 * h];
          dst[8 * j + 1] = byte_marks<MODE>(pair >> 8, plane0) ? -INFINITY : acc[i][j][2 * h + 1];
          acc[i][j][2 * h] = acc[i][j][2 * h + 1] = 0.f;
        }
      }
    __syncwarp();
    if (lane == 0) {
      mbar_arrive(mask_empty(m));
      mbar_arrive(stg_full);
    }
  }
}

// A 2D tensor map over rows of `row_bytes` (a row stride of `stride`
// bytes), boxes of 128 rows by 128 bytes, 128-byte swizzle; false if the
// driver refuses it.
static bool encode_map(CUtensorMap* map, CUtensorMapDataType type, const void* ptr, uint64_t inner,
                       uint64_t rows, uint64_t stride, uint32_t box_inner) {
  static PFN_cuTensorMapEncodeTiled_v12000 encode = nullptr;
  if (encode == nullptr) {
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", reinterpret_cast<void**>(&encode), cudaEnableDefault,
                                &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      encode = nullptr;
    if (encode == nullptr) return false;
  }
  const cuuint64_t dims[2] = {inner, rows};
  const cuuint64_t strides[1] = {stride};
  const cuuint32_t box[2] = {box_inner, 128};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, type, 2, const_cast<void*>(ptr), dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The TMA path; returns -1 where a tensor map cannot be encoded (the caller
// takes the cp.async path).
template <int MODE>
int launch_tma(const Args& a, cudaStream_t stream) {
  static int sms[MAX_DEVICES], attr_set[MAX_DEVICES];
  int dev;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  CUtensorMap tm_u, tm_items, tm_mask;
  if (!encode_map(&tm_u, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, a.u, a.d, a.B, (uint64_t)a.d * 4, BK) ||
      !encode_map(&tm_items, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, a.items, a.d, a.I, (uint64_t)a.d * 4, BK) ||
      !encode_map(&tm_mask, CU_TENSOR_MAP_DATA_TYPE_UINT8, a.mask, a.mask_stride, a.B, a.mask_stride, BN))
    return -1;
  auto kernel = masked_scores_tma_kernel<MODE>;
  if (!attr_set[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T_SMEM_BYTES);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    attr_set[dev] = 1;
  }
  const long long tiles = (long long)a.m_tiles * a.n_tiles;
  const int grid = (int)(tiles < sms[dev] ? tiles : sms[dev]);
  kernel<<<grid, T_THREADS, T_SMEM_BYTES, stream>>>(a, tm_u, tm_items, tm_mask);
  return (int)cudaGetLastError();
}

// blocks a SM and SMs of each device, found once per kernel and device
template <int MODE, int UNIT>
int launch(const Args& a, cudaStream_t stream) {
  static int blocks_per_sm[MAX_DEVICES], sms[MAX_DEVICES];
  int dev;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  auto kernel = masked_scores_kernel<MODE, UNIT>;
  if (blocks_per_sm[dev] == 0) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks_per_sm[dev], kernel, THREADS,
                                                          SMEM_BYTES);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    if (blocks_per_sm[dev] == 0) return (int)cudaErrorInvalidConfiguration;
  }
  const long long tiles = (long long)a.m_tiles * a.n_tiles;
  const long long fit = (long long)blocks_per_sm[dev] * sms[dev];
  const int grid = (int)(tiles < fit ? tiles : fit);
  kernel<<<grid, THREADS, SMEM_BYTES, stream>>>(a);
  return (int)cudaGetLastError();
}

// -- the f32 path --------------------------------------------------------------
constexpr int FMA_MAX_D = 40;                  // ops/masked_scores.py K1_FMA_MAX_D
constexpr int F_WARPS = 8;                     // each 16 rows of a tile
constexpr int F_THREADS = F_WARPS * 32;
constexpr int F_BLOCKS_PER_SM = 2;             // one block's FMAs under the other's copies and stores
constexpr int F_TM = 16;                       // rows a thread (its warp's)
constexpr int F_TN = 4;                        // columns a thread: lane + 32 j
constexpr int F_EPI_ROWS = 8;                  // rows a warp stages at once
constexpr int F_STEP = BN - 8;                 // item tiles start 120 apart and overlap by a sector
constexpr int F_CHUNK = 8;                     // mask bytes a copy

// The pitch (floats) of a packed row: d rounded up to an odd multiple of 4.
// A quarter warp's 16-byte reads of 8 consecutive rows then start 16 * pitch
// / 4 bytes apart, an odd number of 16-byte bank groups: 8 distinct groups.
__host__ __device__ constexpr int fma_pitch(int d) {
  return ((d + 3) & ~3) % 8 == 0 ? ((d + 3) & ~3) + 4 : (d + 3) & ~3;
}

constexpr int F_RUN = BM * FMA_MAX_D;          // a tile's rows as they lie (floats)
constexpr int F_PACKED = BM * fma_pitch(FMA_MAX_D);  // the same rows at the pitch (floats)
constexpr int F_RUN_U = 0, F_RUN_I = F_RUN;    // offsets in floats
constexpr int F_UP = 2 * F_RUN, F_IP = F_UP + F_PACKED;
constexpr int F_MASK_OFF = (F_IP + F_PACKED) * 4;  // a tile's mask bytes (bytes)
constexpr int F_SMEM_BYTES = F_MASK_OFF + MASK_TILE;
static_assert(BM == F_WARPS * F_TM && BN == 32 * F_TN, "8 warps x 32 lanes cover a tile");
static_assert(F_WARPS * F_EPI_ROWS * T_STG_LD <= 2 * F_PACKED, "the staged rows fit the packed rows' room");
static_assert(F_STEP % 8 == 0 && F_STEP + 7 < BN, "a tile holds every sector that starts in its step");
static_assert(MASK_TILE / F_CHUNK % F_THREADS == 0, "the mask copies spread evenly");

// item tiles of the f32 path: a window of BN items every F_STEP
int fma_item_tiles(int I) { return I <= BN ? 1 : 1 + (I - BN + F_STEP - 1) / F_STEP; }

// 8-byte cp.async; src_bytes 0 zero-fills the destination
__device__ __forceinline__ void cp_async8(void* dst, const void* src, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(s), "l"(src), "r"(src_bytes) : "memory");
}

// `floats` floats from `src` into `run` as they lie: 16 bytes a copy where
// the source is 16-byte aligned (a ragged run's last copy reads only what is
// there and zero-fills the rest), else 4
__device__ __forceinline__ void load_run(float* run, const float* src, int floats, bool aligned) {
  const int t = (int)threadIdx.x;
  if (aligned) {
    for (int c = 4 * t; c < floats; c += 4 * F_THREADS) cp_async<16>(run + c, src + c, min(4, floats - c) * 4);
  } else {
    for (int c = t; c < floats; c += F_THREADS) cp_async<4>(run + c, src + c, 4);
  }
}

// A run of rows of d floats into rows at `pitch`: thread t moves elements t,
// t + F_THREADS, ... (row and depth stepped by q = F_THREADS / d rows and
// rmd = F_THREADS % d depths)
__device__ __forceinline__ void pack_run(float* packed, const float* run, int floats, int d, int pitch, int q,
                                         int rmd) {
  int e = (int)threadIdx.x, n = e / d, k = e - n * d;
  for (; e < floats; e += F_THREADS) {
    packed[n * pitch + k] = run[e];
    n += q;
    k += rmd;
    if (k >= d) {
      k -= d;
      ++n;
    }
  }
}

// The mask bytes of the tile at (m0, n0), 128 a row, 8 bytes a copy: item
// n0 + c of row b is byte n0 + c (int8) or (n0 + c) % P (bit planes; a copy
// never straddles planes, P % 8 == 0); bytes past an int8 row read as 0
template <int MODE>
__device__ __forceinline__ void load_mask_window(const Args& a, uint8_t* Ms, int m0, int n0) {
#pragma unroll
  for (int i = 0; i < MASK_TILE / F_CHUNK / F_THREADS; ++i) {
    const int c = (int)threadIdx.x + i * F_THREADS;
    const int row = c / (BN / F_CHUNK), col = (c % (BN / F_CHUNK)) * F_CHUNK;
    const long long off = MODE == 0 ? n0 + col : (n0 + col) % a.plane_bytes;
    const bool ok = m0 + row < a.B && off + F_CHUNK <= a.mask_stride;
    cp_async8(Ms + row * BN + col, ok ? a.mask + (m0 + row) * a.mask_stride + off : a.mask, ok ? F_CHUNK : 0);
  }
}

// A bulk copy of `bytes` (a multiple of 16, both ends 16-byte aligned) from
// shared to global memory by the copy engine, evict-first in L2
__device__ __forceinline__ void bulk_store(float* dst, const float* src, int bytes, uint64_t policy) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group.L2::cache_hint [%0], [%1], %2, %3;\n" ::"l"(dst),
               "r"(smem_u32(src)), "r"(bytes), "l"(policy)
               : "memory");
}

template <int MODE>
__global__ void __launch_bounds__(F_THREADS, F_BLOCKS_PER_SM) masked_scores_fma_kernel(const Args a,
                                                                                      const int aligned) {
  extern __shared__ __align__(16) float fs[];
  float* const run_u = fs + F_RUN_U;
  float* const run_i = fs + F_RUN_I;
  float* const Up = fs + F_UP;
  float* const Ip = fs + F_IP;
  uint8_t* const Ms = reinterpret_cast<uint8_t*>(fs) + F_MASK_OFF;
  const int warp = (int)threadIdx.x >> 5, lane = (int)threadIdx.x & 31;
  const int row0 = warp * F_TM;
  float* const eb = Up + warp * F_EPI_ROWS * T_STG_LD;  // the warp's staged rows, over the packed ones
  const int d = a.d, pitch = fma_pitch(d), d1 = max(d, 1);
  const int q = F_THREADS / d1, rmd = F_THREADS % d1;
  const int d4 = d & ~3, rem = d & 3;

  // tile t: users (t / n_tiles) * BM, items (t % n_tiles) * F_STEP, in row bands
  const int tiles = a.m_tiles * a.n_tiles;
  int t = (int)blockIdx.x;
  auto m0_of = [&](int s) { return s / a.n_tiles * BM; };
  auto n0_of = [&](int s) { return s % a.n_tiles * F_STEP; };
  auto load = [&](int s) {  // a tile's runs and mask bytes, one commit group
    const int m0 = m0_of(s), n0 = n0_of(s);
    load_run(run_u, a.u + (size_t)m0 * d, min(BM, a.B - m0) * d, aligned);
    load_run(run_i, a.items + (size_t)n0 * d, min(BN, a.I - n0) * d, aligned);
    if (a.mask_tiles) load_mask_window<MODE>(a, Ms, m0, n0);
    cp_async_commit();
  };

  float acc[F_TM][F_TN];
#pragma unroll
  for (int i = 0; i < F_TM; ++i)
#pragma unroll
    for (int j = 0; j < F_TN; ++j) acc[i][j] = 0.f;

  load(t);
  for (; t < tiles; t += (int)gridDim.x) {
    const int m0 = m0_of(t), n0 = n0_of(t), last_n = t % a.n_tiles == a.n_tiles - 1;
    cp_async_wait_all();
    __syncthreads();  // the tile's runs and mask bytes have landed; the last epilogue is done
    pack_run(Up, run_u, min(BM, a.B - m0) * d, d1, pitch, q, rmd);
    pack_run(Ip, run_i, min(BN, a.I - n0) * d, d1, pitch, q, rmd);
    // the marks of the thread's scores, bit i * F_TN + j: the mask tile
    // (one or two planes a window), else global memory
    uint64_t marks = 0;
    {
      const int p0 = MODE == 1 ? n0 / a.plane_bytes : 0;
      const int cb = (p0 + 1) * a.plane_bytes - n0;  // the window's first item of plane p0 + 1
#pragma unroll
      for (int i = 0; i < F_TM; ++i) {
        const int rr = row0 + i, r = m0 + rr;
#pragma unroll
        for (int j = 0; j < F_TN; ++j) {
          const int c = lane + 32 * j;
          bool m;
          if (a.mask_tiles)
            m = byte_marks<MODE>(Ms[rr * BN + c], c < cb ? p0 : p0 + 1);
          else
            m = r < a.B && n0 + c < a.I && marked_global<MODE>(a, r, n0 + c, p0, p0 * a.plane_bytes);
          marks |= (uint64_t)m << (i * F_TN + j);
        }
      }
    }
    __syncthreads();  // packed, marks read: the runs and the mask room are free
    if (t + (int)gridDim.x < tiles) load(t + (int)gridDim.x);

    // rows row0 + i, columns lane + 32 j: each score one fmaf chain over k in order
    const float* up = Up + row0 * pitch;
    const float* ip = Ip + lane * pitch;
    for (int k = 0; k < d4; k += 4) {
      float4 iv[F_TN];
#pragma unroll
      for (int j = 0; j < F_TN; ++j) iv[j] = *reinterpret_cast<const float4*>(ip + 32 * j * pitch + k);
#pragma unroll
      for (int i = 0; i < F_TM; ++i) {
        const float4 uv = *reinterpret_cast<const float4*>(up + i * pitch + k);  // a broadcast
#pragma unroll
        for (int j = 0; j < F_TN; ++j) {
          acc[i][j] = fmaf(uv.x, iv[j].x, acc[i][j]);
          acc[i][j] = fmaf(uv.y, iv[j].y, acc[i][j]);
          acc[i][j] = fmaf(uv.z, iv[j].z, acc[i][j]);
          acc[i][j] = fmaf(uv.w, iv[j].w, acc[i][j]);
        }
      }
    }
    if (rem) {  // the last d % 4 depths: the float4's first components only
      float4 iv[F_TN];
#pragma unroll
      for (int j = 0; j < F_TN; ++j) iv[j] = *reinterpret_cast<const float4*>(ip + 32 * j * pitch + d4);
#pragma unroll
      for (int i = 0; i < F_TM; ++i) {
        const float4 uv = *reinterpret_cast<const float4*>(up + i * pitch + d4);
#pragma unroll
        for (int j = 0; j < F_TN; ++j) {
          acc[i][j] = fmaf(uv.x, iv[j].x, acc[i][j]);
          if (rem > 1) acc[i][j] = fmaf(uv.y, iv[j].y, acc[i][j]);
          if (rem > 2) acc[i][j] = fmaf(uv.z, iv[j].z, acc[i][j]);
        }
      }
    }

    // -- the tile's epilogue: each warp stages its masked rows over the
    // packed ones, F_EPI_ROWS at a time, each shifted by (r * I + n0) % 4
    // floats, and writes the sectors its tile owns: of row r, items [lo, hi)
    // between the first sector boundaries at or past n0 and n0 + F_STEP
    // (from 0 in the first tile, to I in the last)
    __syncthreads();  // every warp is done with the packed rows
#pragma unroll
    for (int h = 0; h < F_TM / F_EPI_ROWS; ++h) {
#pragma unroll
      for (int e = 0; e < F_EPI_ROWS; ++e) {
        const int i = h * F_EPI_ROWS + e, r = m0 + row0 + i;
        float* dst = eb + e * T_STG_LD + (((r & 3) * (a.I & 3) + n0) & 3) + lane;
#pragma unroll
        for (int j = 0; j < F_TN; ++j) {
          dst[32 * j] = (marks >> (i * F_TN + j)) & 1 ? -INFINITY : acc[i][j];
          acc[i][j] = 0.f;
        }
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // the staged rows, to the copy engine
      __syncwarp();
      const int r = m0 + row0 + h * F_EPI_ROWS + lane;
      if (lane < F_EPI_ROWS && r < a.B) {  // a lane a row
        const int x8 = (r & 7) * (a.I & 7);  // r * I, mod 8
        const int lo = n0 == 0 ? 0 : n0 + ((8 - ((x8 + n0) & 7)) & 7);
        const int hi = last_n ? a.I : n0 + F_STEP + ((8 - ((x8 + n0 + F_STEP) & 7)) & 7);
        // 16-byte aligned from lo_a to hi_a, by the copy engine; the row's
        // own ends (the first and last tiles' unaligned ends) by hand
        const int lo_a = lo + ((4 - ((x8 + lo) & 3)) & 3), hi_a = max(lo_a, hi - ((x8 + hi) & 3));
        const float* srow = eb + lane * T_STG_LD + ((x8 + n0) & 3);  // srow[c - n0]: item c
        float* orow = a.out + (long long)r * a.I;
        uint64_t policy;
        asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(policy));
        if (hi_a > lo_a) bulk_store(orow + lo_a, srow + lo_a - n0, (hi_a - lo_a) * 4, policy);
        for (int c = lo; c < min(lo_a, hi); ++c) __stcs(orow + c, srow[c - n0]);
        for (int c = max(hi_a, lo); c < hi; ++c) __stcs(orow + c, srow[c - n0]);
        asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
        asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");  // the staged rows are free
      }
      __syncwarp();
    }
  }
}

// F_BLOCKS_PER_SM blocks a SM (the occupancy query's count) and the SMs of
// each device, found once per kernel and device; `aligned`: u and items
// 16-byte aligned
template <int MODE>
int launch_fma(const Args& a, int aligned, cudaStream_t stream) {
  static int blocks_per_sm[MAX_DEVICES], sms[MAX_DEVICES];
  int dev;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  auto kernel = masked_scores_fma_kernel<MODE>;
  if (blocks_per_sm[dev] == 0) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, F_SMEM_BYTES);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks_per_sm[dev], kernel, F_THREADS, F_SMEM_BYTES);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    if (blocks_per_sm[dev] == 0) return (int)cudaErrorInvalidConfiguration;
  }
  Args f = a;
  f.n_tiles = fma_item_tiles(a.I);
  // 8-byte copies of the mask: an 8-byte aligned table, rows and planes
  // (bit planes of at least a tile's items: a tile spans two planes at most)
  f.mask_tiles = reinterpret_cast<uintptr_t>(a.mask) % 8 == 0 && a.mask_stride % 8 == 0 &&
                 (MODE == 0 || (a.plane_bytes % 8 == 0 && a.plane_bytes >= BN));
  const long long tiles = (long long)f.m_tiles * f.n_tiles;
  const long long fit = (long long)blocks_per_sm[dev] * sms[dev];
  const int grid = (int)(tiles < fit ? tiles : fit);
  kernel<<<grid, F_THREADS, F_SMEM_BYTES, stream>>>(f, aligned);
  return (int)cudaGetLastError();
}

// The f32 path's arithmetic a thread a score: one fmaf chain from 0 over k
// in order, no mask. A test entry (neurec_fma_chain), on no path.
__global__ void fma_chain_kernel(const float* __restrict__ u, const float* __restrict__ items,
                                 float* __restrict__ out, int B, int I, int d) {
  const long long n = (long long)B * I;
  for (long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x; idx < n;
       idx += (long long)gridDim.x * blockDim.x) {
    const long long b = idx / I, i = idx - b * I;
    float acc = 0.f;
    for (int k = 0; k < d; ++k) acc = fmaf(u[b * d + k], items[i * d + k], acc);
    out[idx] = acc;
  }
}

// the card's own rounding instruction, which rna_tf32 reproduces on every
// value but NaN
__global__ void round_tf32_kernel(const float* __restrict__ x, float* __restrict__ y, long long n) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    uint32_t r;
    asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x[i]));
    y[i] = __uint_as_float(r);
  }
}

}  // namespace

// aligned: u and items 16-byte aligned (16-byte copies). The f32 path takes
// d <= FMA_MAX_D, the 3xTF32 split every wider d (16-byte rows where d % 4 == 0).
extern "C" int neurec_masked_scores(const float* u, const float* items, const uint8_t* mask,
                                    float* out, int B, int I, int d, long long mask_stride,
                                    int plane_bytes, int mode, int aligned, cudaStream_t stream) {
  if (B <= 0 || I <= 0) return 0;
  Args a{u, items, mask, out, B, I, d, mask_stride, plane_bytes,
         (B + BM - 1) / BM, (I + BN - 1) / BN, 0};
  if (d <= FMA_MAX_D) return mode == 0 ? launch_fma<0>(a, aligned, stream) : launch_fma<1>(a, aligned, stream);
  const int vec16 = aligned && d % 4 == 0;
  const bool mask_aligned = reinterpret_cast<uintptr_t>(mask) % 16 == 0 && mask_stride % 16 == 0;
  // the int8 mask spans the items rounded up to 512 (ops/masked_scores.py),
  // so a tile's 128 bytes stay in the row; bit planes of W/8 % 128 == 0
  // bytes hold whole tiles
  a.mask_tiles = mask_aligned && (mode == 0 ? mask_stride >= (long long)a.n_tiles * BN : plane_bytes % BN == 0);
  if (vec16 && a.mask_tiles) {  // the TMA path takes 16-byte rows and whole mask tiles
    const int code = mode == 0 ? launch_tma<0>(a, stream) : launch_tma<1>(a, stream);
    if (code != -1) return code;
  }
  if (mode == 0) return vec16 ? launch<0, 16>(a, stream) : launch<0, 4>(a, stream);
  return vec16 ? launch<1, 16>(a, stream) : launch<1, 4>(a, stream);
}

// The f32 path's chain a thread a score, unmasked: out[b, i] = fmaf chain of
// u[b] and items[i] over k in order. For the tests that hold the f32 path's
// bits (ops/masked_scores.py::fma_chain_scores); never called by the wrapper.
extern "C" int neurec_fma_chain(const float* u, const float* items, float* out, int B, int I, int d,
                                cudaStream_t stream) {
  if (B <= 0 || I <= 0) return 0;
  const long long blocks = ((long long)B * I + 255) / 256;
  fma_chain_kernel<<<(int)(blocks < 8192 ? blocks : 8192), 256, 0, stream>>>(u, items, out, B, I, d);
  return (int)cudaGetLastError();
}

// cvt.rna.tf32.f32 over n floats, for the tests that hold K1's rounding
// (and its plain version, round_tf32_reference) to the instruction.
extern "C" int neurec_round_tf32(const float* x, float* y, long long n, cudaStream_t stream) {
  if (n <= 0) return 0;
  round_tf32_kernel<<<(int)((n + 255) / 256 < 1024 ? (n + 255) / 256 : 1024), 256, 0, stream>>>(x, y, n);
  return (int)cudaGetLastError();
}

extern "C" const char* neurec_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Batched structured-grid affine stencil as banded products on the tensor
// cores, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel vbicm_tpu/ops/stencil_mxu.py,
// stencil_affine_matvec_mxu (bodies _row_kernel_bf16x3 and _row_kernel_f32).
// The function is stencil_affine.cu's, q = (c0 K_lam + c1 K_mu) u on the
// (NY, NX) grid, written as one dense product per (grid row y, 128-lane
// output tile t): the three u rows' 136-lane windows starting at lane
// t*128 - 3, and 8 zeros, make a (B, 416) operand A; the table holds a
// (416, 256) banded matrix M[y, t] whose column halves are the two parts:
//
//     acc = A M[y, t]                               (B, 256), float32
//     q[b, y, t*128 + k] = c0[b] acc[b, k] + c1[b] acc[b, 128 + k]
//
// Precision modes, as the TPU kernel's:
//   bf16x3: A is split in the kernel into bfloat16 high and low halves
//     (__float2bfloat16_rn), the table comes split (Mh, Ml), and
//     Ah Mh + Al Mh + Ah Ml is accumulated in float32 by BF16 m16n8k16 MMAs.
//   f32: one float32 table; both operands are split into TF32 big and small
//     parts (tf32x3.cuh) and As Mb + Ab Ms + Ab Mb is accumulated in
//     float32 by TF32 m16n8k8 MMAs (3xTF32, the tensor cores' counterpart of
//     the TPU's Precision.HIGHEST; about 2e-7 of max|q| from the exact
//     operator, where one TF32 product would give 1e-3).
//
// The band. Column p*128 + k of M[y, t] is nonzero only at rows
// dy*136 + k + d (d = 0..6), and only where lane t*128 + k < 2NX; rows
// 408-415 are zero. So the 8-column n-tile at k = n0..n0+7 meets, in each
// window dy, only the aligned k-steps (16 rows for BF16, 8 for TF32) that
// hold rows dy*136 + n0 .. dy*136 + kmax + 6 (kmax = n0 + 7, or the last
// lane inside the grid): 1-2 a window in BF16, 1-2 in TF32. Every other
// (k-step, n-tile) block of the table is zero (ops/stencil_mxu.py::
// band_ksteps states the rule once; the CPU tests check it on the packed
// tables). At 160x80 that leaves 366 of 2,496 BF16 blocks a grid row and
// 486 of 4,992 TF32 ones.
//
// Bits. Each accumulator sees its band k-steps in ascending order with the
// three products in the order above, as the densified kernel did. A block
// that is skipped is all zeros and adds exact zeros for finite u; so do the
// A rows that meet only zero table rows in the slice's columns, which this
// kernel reads as zeros. So q is bitwise the densified kernel's.
//
// What bounds it on an H100: at 160x80 (NY = 81, T = 3) and B = 256 the
// band blocks are 20.4 MB of bf16x3 tables (10.1 MB f32, at 32-byte
// sectors) against 103.5 MB densified, plus 53.4 MB of u and q: 22 us and
// 19 us of bytes at 3.35 TB/s, against 5.8 GFLOP (bf16x3) and 3.9 GFLOP
// (3xTF32) of band MMAs, 6 and 8 us at peak. Bytes bound it.
//
// Design:
//   - one block per (32-lane slice of tile t, grid row y, group of sample
//     tiles), the group the fastest block index, so the blocks that read
//     one table slice run together and share it through L2;
//   - the slice's band blocks (18 a column half in BF16 x 2 tables, 24 in
//     TF32) are staged once, compactly (a (rows, 8) block of 256 bytes
//     each) with 16-byte cp.async;
//   - the block walks its group's tiles of 64 samples through one u buffer
//     (54 KB of shared memory in all, four blocks an SM: the other blocks'
//     products cover a block's copies; two buffers at two blocks an SM
//     measured slower, tools/stencil_breakdown.py): for each sample, of each
//     of the three grid rows only the 42 lanes the slice's band rows read,
//     as 8-byte cp.async (u's rows are 8-byte aligned: 2NX is even), zero
//     outside the grid and past B; every union k-step's A rows map to them,
//     or to 8 zeros, at offsets fixed at compile time;
//   - 4 warps, a 16-sample m-tile each, over all 4 n-tiles in both column
//     halves (8 accumulators), so each A value is split once and the
//     combine of the halves is in registers;
//   - BF16 B fragments by ldmatrix.x4.trans (hi and lo of a block in one
//     instruction), TF32 B by 32-bit loads, both free of bank conflicts in
//     the compact blocks; A is split as fragments are built; the three
//     products are issued across the warp's accumulators in turn; a slice
//     inside the grid runs a body with no branch on its live blocks;
//   - the groups a launch makes are planned from the built kernel's
//     occupancy and the card's SMs (plan_groups).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstddef>
#include <cstdint>
#include <type_traits>
#include <utility>

#include "tf32x3.cuh"

namespace {

constexpr int kWin = 136;
constexpr int kKdim = 3 * kWin + 8;  // 416
constexpr int kCols = 256;
constexpr int kHalf = 128;
constexpr int kSlice = 32;            // output lanes a block
constexpr int kNT = kSlice / 8;       // n-tiles a column half
constexpr int kBM = 64;               // samples a tile: a 16-sample m-tile a warp
constexpr int kStages = 1;            // u tile buffers
constexpr int kMinBlocks = 4;         // blocks an SM is to hold (caps the registers)
constexpr int kThreads = 128;
constexpr int kBlk = 256;             // bytes of a staged (k-step, n-tile) block
// u staged a sample: for each of the three grid rows, kPairs lane pairs from
// lane t*128 + col0 - 4 (the band's rows of the slice, w = col0 .. col0 + 39
// of each window, start at lane t*128 + col0 - 3); then 8 zeros
constexpr int kPairs = 21;
constexpr int kLanes = 2 * kPairs;    // 42
constexpr int kZero = 3 * kLanes;     // offset of the zeros: 126
constexpr int kAStride = 140;         // floats a sample: = 4 mod 8, fragment reads spread over the banks
static_assert(kZero + 8 <= kAStride && kAStride % 8 == 4, "the staged sample row");
constexpr int kMaxDevices = 64;

// The slice's k-steps in window dy start at (dy*136 + s*32) / S; s*32 is a
// multiple of S, so relative to s*32 / S the structure is the same for
// every slice.
__host__ __device__ constexpr int first_kstep(int S, int dy) { return dy * kWin / S; }

// k-steps of window dy that rows dy*136 + s*32 + [0, 37] meet
__host__ __device__ constexpr int union_ksteps(int S, int dy) {
  return (dy * kWin + kSlice + 5) / S - first_kstep(S, dy) + 1;
}

// the rule of band_ksteps for a full n-tile j of the slice: k-step kk of
// window dy's union holds rows of dy*136 + 8j + [0, 13]
__host__ __device__ constexpr bool member(int S, int dy, int kk, int j) {
  const int row = (first_kstep(S, dy) + kk) * S;
  return row <= dy * kWin + 8 * j + 13 && row + S - 1 >= dy * kWin + 8 * j;
}

template <int S>
__host__ __device__ constexpr int union_count() {
  return union_ksteps(S, 0);
}

// staged blocks a column half: the members over (j, dy, kk)
template <int S>
__host__ __device__ constexpr int band_blocks() {
  int n = 0;
  for (int j = 0; j < kNT; ++j)
    for (int dy = 0; dy < 3; ++dy)
      for (int kk = 0; kk < union_count<S>(); ++kk) n += member(S, dy, kk, j);
  return n;
}

// the staged slot of block (j, dy, kk): members before it, j-major
template <int S>
__host__ __device__ constexpr int slot_of(int j, int dy, int kk) {
  int n = 0;
  for (int jj = 0; jj < kNT; ++jj)
    for (int d = 0; d < 3; ++d)
      for (int k = 0; k < union_count<S>(); ++k) {
        if (jj == j && d == dy && k == kk) return n;
        n += member(S, d, k, jj);
      }
  return n;
}

static_assert(union_ksteps(16, 0) == 3 && union_ksteps(16, 1) == 3 && union_ksteps(16, 2) == 3,
              "BF16: three k-steps a window");
static_assert(union_ksteps(8, 0) == 5 && union_ksteps(8, 1) == 5 && union_ksteps(8, 2) == 5,
              "TF32: five k-steps a window");
static_assert(band_blocks<16>() == 18 && band_blocks<8>() == 24, "band blocks a column half");
static_assert(kNT * 3 * 5 <= 64, "a block's live mask fits 64 bits");
static_assert(first_kstep(16, 2) + 3 + 6 <= kKdim / 16, "the last slice's k-steps stay in M");

struct Bf16x3 {
  using Table = uint16_t;  // bfloat16 bits
  static constexpr int kTables = 2;
  static constexpr int kStep = 16;
};

struct Tf32x3 {
  using Table = float;
  static constexpr int kTables = 1;
  static constexpr int kStep = 8;
};

template <class Mode>
__host__ __device__ constexpr size_t table_bytes() {
  return static_cast<size_t>(Mode::kTables) * 2 * band_blocks<Mode::kStep>() * kBlk;
}

template <class Mode>
constexpr size_t smem_bytes() {
  return table_bytes<Mode>() + static_cast<size_t>(kStages) * kBM * kAStride * sizeof(float);
}

// Where the 8 A rows (k = K0 .. K0 + 7) of M[y, t] at K0 = col0 + c lie in a
// staged sample row: window d = K0 / 136 at w0 = K0 - 136 d; the slice's
// band rows are w = col0 .. col0 + 37 of each window, so only w0 = col0 ..
// col0 + 32 are staged (lanes t*128 + w0 - 3 ..), the rest are rows whose
// table entries are zero in all the slice's columns and read the zeros.
// c is the same for every slice, and so is the offset.
__host__ __device__ constexpr int a_offset(int c) {
  for (int d = 0; d < 3; ++d)
    if (c - kWin * d >= 0 && c - kWin * d <= kSlice) return d * kLanes + (c - kWin * d) + 1;
  return kZero;
}

__device__ __forceinline__ void cp_async_8(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 8 : 0));
}

__device__ __forceinline__ void cp_async_16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// (x, y) -> packed (high, low) bfloat16 pairs: hi = bf16(x), lo = bf16(x - hi),
// x in the low 16 bits; each rounded to nearest, as __float2bfloat16_rn
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x - __low2float(h), y - __high2float(h));
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// four 8x8 bfloat16 matrices, transposed: lane l gives the row address of
// matrix l / 8; lane (g, t4) receives rows 2t4, 2t4+1 of column g of each
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(row)));
}

// i = 0, 1, ..., N - 1 as compile-time constants: f(std::integral_constant<int, i>)
template <class F, int... I>
__device__ __forceinline__ void static_for_impl(F&& f, std::integer_sequence<int, I...>) {
  (f(std::integral_constant<int, I>{}), ...);
}

template <int N, class F>
__device__ __forceinline__ void static_for(F&& f) {
  static_for_impl(f, std::make_integer_sequence<int, N>{});
}

// bit (j, dy, kk) of a block's live mask
template <int S>
__host__ __device__ constexpr int live_bit(int j, int dy, int kk) {
  return (j * 3 + dy) * union_count<S>() + kk;
}

// The band blocks of the slice at these lanes: the member rule with each
// n-tile's last lane inside the grid (lim[j] = 2NX - 1 - its first lane;
// an n-tile past the grid has none).
template <int S>
__device__ __forceinline__ uint64_t live_blocks(const int (&lim)[kNT]) {
  uint64_t live = 0;
  static_for<kNT>([&](auto jc) {
    constexpr int j = decltype(jc)::value;
    static_for<3>([&](auto dyc) {
      constexpr int dy = decltype(dyc)::value;
      static_for<union_count<S>()>([&](auto kkc) {
        constexpr int kk = decltype(kkc)::value;
        if constexpr (member(S, dy, kk, j)) {
          constexpr int bit = live_bit<S>(j, dy, kk);
          if (lim[j] >= 0 &&
              (first_kstep(S, dy) + kk) * S <= dy * kWin + 8 * j + min(7, lim[j]) + 6)
            live |= uint64_t{1} << bit;
        }
      });
    });
  });
  return live;
}

// The live mask of a slice inside the grid: every member block.
template <int S>
__host__ __device__ constexpr uint64_t all_blocks() {
  uint64_t live = 0;
  for (int j = 0; j < kNT; ++j)
    for (int dy = 0; dy < 3; ++dy)
      for (int kk = 0; kk < union_count<S>(); ++kk)
        if (member(S, dy, kk, j)) live |= uint64_t{1} << live_bit<S>(j, dy, kk);
  return live;
}

// Start the copies of the slice's live band blocks: block (j, dy, kk) of
// table tb, column half h at Tab + ((tb*2 + h) * blocks + slot) * kBlk
// bytes, a (S, 8) row-major block.
template <class Mode>
__device__ __forceinline__ void load_table(unsigned char* Tab, const typename Mode::Table* m0,
                                           const typename Mode::Table* m1, size_t tab_row0,
                                           int col0, int ks0, uint64_t live) {
  using Table = typename Mode::Table;
  constexpr int S = Mode::kStep;
  constexpr int kBlocks = band_blocks<S>();
  constexpr int kPieces = kBlk / 16;               // 16-byte pieces a block
  constexpr int kPerRow = 8 * sizeof(Table) / 16;  // pieces a block row
  constexpr int kCopies = Mode::kTables * 2 * kPieces;
  static_for<kNT>([&](auto jc) {
    constexpr int j = decltype(jc)::value;
    static_for<3>([&](auto dyc) {
      constexpr int dy = decltype(dyc)::value;
      static_for<union_count<S>()>([&](auto kkc) {
        constexpr int kk = decltype(kkc)::value;
        if constexpr (member(S, dy, kk, j)) {
          constexpr int slot = slot_of<S>(j, dy, kk);
          constexpr int bit = live_bit<S>(j, dy, kk);
          if (!((live >> bit) & 1)) return;
          const size_t row = tab_row0 + static_cast<size_t>(ks0 + first_kstep(S, dy) + kk) * S;
          for (int e = threadIdx.x; e < kCopies; e += kThreads) {
            const int tb = e / (2 * kPieces);
            const int h = (e / kPieces) % 2;
            const int p = e % kPieces;
            const int r = p / kPerRow;
            const int c = (p % kPerRow) * (16 / static_cast<int>(sizeof(Table)));
            const Table* src = (tb ? m1 : m0) + (row + r) * kCols + h * kHalf + col0 + j * 8 + c;
            cp_async_16(Tab + ((tb * 2 + h) * kBlocks + slot) * kBlk + p * 16, src);
          }
        }
      });
    });
  });
}

// The copies a thread makes of each sample tile: lane pair p of grid row
// y + d - 1 (zero outside the grid) for the samples m = m_first + 2i.
struct TileCopy {
  int dst;     // float offset in a staged sample row
  int src;     // float offset in a sample of u, or -1 (zeros)
  int m_first;
};

__device__ __forceinline__ TileCopy tile_copy(int y, int lane0, int NY, int NX2) {
  TileCopy c{0, -1, 0};
  const int k = threadIdx.x % 64;  // 63 (d, pair) a sample, two samples at once
  c.m_first = threadIdx.x / 64;
  if (k >= 3 * kPairs) {
    c.m_first = kBM;  // the last thread of each half copies nothing
    return c;
  }
  const int d = k / kPairs, p = k % kPairs;
  const int lane = lane0 - 4 + 2 * p, gy = y + d - 1;
  c.dst = d * kLanes + 2 * p;
  if (gy >= 0 && gy < NY && lane >= 0 && lane < NX2) c.src = gy * NX2 + lane;  // NX2 is even
  return c;
}

// Start the copies of sample tile [s0, s0 + kBM) into As; samples past B zero.
__device__ __forceinline__ void load_tile(float* As, const TileCopy& c,
                                          const float* __restrict__ u, int s0, int B,
                                          size_t ndof) {
#pragma unroll 4
  for (int m = c.m_first; m < kBM; m += 2) {
    const int b = s0 + m;
    const bool valid = c.src >= 0 && b < B;
    cp_async_8(As + m * kAStride + c.dst, valid ? u + b * ndof + c.src : u, valid);
  }
}

// acc[j][h][4]: the warp's n-tile j in column half h
using Acc = float[kNT][2][4];

// For each union k-step (dy, kk) of the slice, ascending: body(dy, kk) with
// both as compile-time constants (std::integral_constant).
template <int S, class Body>
__device__ __forceinline__ void for_union_ksteps(Body&& body) {
  static_for<3>([&](auto dyc) {
    static_for<union_count<S>()>([&](auto kkc) { body(dyc, kkc); });
  });
}

// One tile's products for the warp's m-tile (rows a_row, a_row + 8 rows)
// over the slice's live band blocks; lane = (g, t4).
template <bool kAll>
__device__ __forceinline__ void tile_mma(const Bf16x3&, const float* a_row,
                                         const unsigned char* Tab, uint64_t live, int lane,
                                         Acc& acc) {
  constexpr int S = 16;
  constexpr int kBlocks = band_blocks<S>();
  // ldmatrix: lane l addresses row l % 8 of matrix l / 8 = (hi, lo) x (rows 0-7, 8-15)
  const int mat = lane / 8;
  const unsigned char* b_lane = Tab + (mat / 2) * 2 * kBlocks * kBlk + (mat % 2) * 128 +
                                (lane % 8) * 16;
  for_union_ksteps<S>([&](auto dyc, auto kkc) {
    constexpr int dy = decltype(dyc)::value, kk = decltype(kkc)::value;
    bool use[kNT];
    bool any = false;
    static_for<kNT>([&](auto jc) {
      constexpr int j = decltype(jc)::value;
      if constexpr (member(S, dy, kk, j)) {
        constexpr int bit = live_bit<S>(j, dy, kk);
        use[j] = kAll || ((live >> bit) & 1);
      } else {
        use[j] = false;
      }
      any |= use[j];
    });
    if (!any) return;
    // rows 0-7 and 8-15 of the k-step; a0-a1: (g, 2t4..), a2-a3: (g+8, 2t4..),
    // a4-a5: (g, 2t4+8..), a6-a7: (g+8, 2t4+8..)
    constexpr int c = (first_kstep(S, dy) + kk) * S;
    constexpr int off0 = a_offset(c), off1 = a_offset(c + 8);
    uint32_t ah[4], al[4];
    const float* r1 = a_row + 8 * kAStride;
    split_bf16(a_row[off0], a_row[off0 + 1], ah[0], al[0]);
    split_bf16(r1[off0], r1[off0 + 1], ah[1], al[1]);
    split_bf16(a_row[off1], a_row[off1 + 1], ah[2], al[2]);
    split_bf16(r1[off1], r1[off1 + 1], ah[3], al[3]);
    uint32_t bf[kNT][2][4];  // [j][h]: hi rows 0-7, hi rows 8-15, lo rows 0-7, lo rows 8-15
    static_for<kNT>([&](auto jc) {
      constexpr int j = decltype(jc)::value;
      if constexpr (member(S, dy, kk, j)) {
        constexpr int slot = slot_of<S>(j, dy, kk);
        if (use[j]) {
#pragma unroll
          for (int h = 0; h < 2; ++h)
            ldmatrix_x4_trans(bf[j][h], b_lane + (h * kBlocks + slot) * kBlk);
        }
      }
    });
    // the three products in turn across the accumulators, each
    // accumulator's in the order Ah Mh, Al Mh, Ah Ml
#pragma unroll
    for (int p = 0; p < 3; ++p) {
      static_for<kNT>([&](auto jc) {
        constexpr int j = decltype(jc)::value;
        if constexpr (member(S, dy, kk, j)) {
          if (use[j]) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const uint32_t* b = bf[j][h] + (p == 2 ? 2 : 0);
              mma_bf16(acc[j][h], p == 1 ? al : ah, b[0], b[1]);
            }
          }
        }
      });
    }
  });
}

template <bool kAll>
__device__ __forceinline__ void tile_mma(const Tf32x3&, const float* a_row,
                                         const unsigned char* Tab, uint64_t live, int lane,
                                         Acc& acc) {
  constexpr int S = 8;
  constexpr int kBlocks = band_blocks<S>();
  const int g = lane / 4, t4 = lane % 4;
  const float* b_lane = reinterpret_cast<const float*>(Tab) + t4 * 8 + g;
  for_union_ksteps<S>([&](auto dyc, auto kkc) {
    constexpr int dy = decltype(dyc)::value, kk = decltype(kkc)::value;
    bool use[kNT];
    bool any = false;
    static_for<kNT>([&](auto jc) {
      constexpr int j = decltype(jc)::value;
      if constexpr (member(S, dy, kk, j)) {
        constexpr int bit = live_bit<S>(j, dy, kk);
        use[j] = kAll || ((live >> bit) & 1);
      } else {
        use[j] = false;
      }
      any |= use[j];
    });
    if (!any) return;
    // a0: (g, t4), a1: (g+8, t4), a2: (g, t4+4), a3: (g+8, t4+4)
    constexpr int off = a_offset((first_kstep(S, dy) + kk) * S);
    uint32_t ab[4], asl[4];
    const float* r1 = a_row + 8 * kAStride;
    split_tf32(a_row[off], ab[0], asl[0]);
    split_tf32(r1[off], ab[1], asl[1]);
    split_tf32(a_row[off + 4], ab[2], asl[2]);
    split_tf32(r1[off + 4], ab[3], asl[3]);
    uint32_t bb[kNT][2][2], bs[kNT][2][2];  // [j][h][b0, b1]
    static_for<kNT>([&](auto jc) {
      constexpr int j = decltype(jc)::value;
      if constexpr (member(S, dy, kk, j)) {
        constexpr int slot = slot_of<S>(j, dy, kk);
        if (use[j]) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            // b0: row t4, b1: row t4+4; column g
            const float* b = b_lane + (h * kBlocks + slot) * (kBlk / 4);
            split_tf32(b[0], bb[j][h][0], bs[j][h][0]);
            split_tf32(b[32], bb[j][h][1], bs[j][h][1]);
          }
        }
      }
    });
    // each accumulator's products in the order As Mb, Ab Ms, Ab Mb
#pragma unroll
    for (int p = 0; p < 3; ++p) {
      static_for<kNT>([&](auto jc) {
        constexpr int j = decltype(jc)::value;
        if constexpr (member(S, dy, kk, j)) {
          if (use[j]) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const uint32_t(&b)[2] = p == 1 ? bs[j][h] : bb[j][h];
              mma_tf32(acc[j][h], p == 0 ? asl : ab, b[0], b[1]);
            }
          }
        }
      });
    }
  });
}

template <class Mode>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    stencil_mxu_kernel(const typename Mode::Table* __restrict__ m0,
                       const typename Mode::Table* __restrict__ m1,
                       const float* __restrict__ coeffs, const float* __restrict__ u,
                       float* __restrict__ q, int B, int NY, int NX2, int T, int slices,
                       int groups) {
  constexpr int S = Mode::kStep;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* Tab = smem_raw;
  float* As = reinterpret_cast<float*>(smem_raw + table_bytes<Mode>());

  const int ys = blockIdx.y;  // y * slices + slice
  const int y = ys / slices;
  const int gs = ys % slices;
  const int t = gs / (kHalf / kSlice);
  const int col0 = (gs % (kHalf / kSlice)) * kSlice;  // the slice's first lane in tile t
  const int lane0 = t * kHalf + col0;                 // ... in the grid row
  const size_t ndof = static_cast<size_t>(NY) * NX2;
  int lim[kNT];
#pragma unroll
  for (int j = 0; j < kNT; ++j) lim[j] = NX2 - 1 - (lane0 + 8 * j);
  const uint64_t live = live_blocks<S>(lim);

  // the group's tiles of samples, balanced
  const int tiles = (B + kBM - 1) / kBM;
  const int tile_lo = static_cast<int>(static_cast<long long>(blockIdx.x) * tiles / groups);
  const int tile_hi = static_cast<int>(static_cast<long long>(blockIdx.x + 1) * tiles / groups);
  const int n = tile_hi - tile_lo;

  // the zeros of every staged sample row, written once
  for (int e = threadIdx.x; e < kStages * kBM * 8; e += kThreads)
    As[(e / 8) * kAStride + kZero + e % 8] = 0.f;
  const TileCopy copy = tile_copy(y, lane0, NY, NX2);
  load_table<Mode>(Tab, m0, m1, static_cast<size_t>(y * T + t) * kKdim, col0, col0 / S, live);
  load_tile(As, copy, u, tile_lo * kBM, B, ndof);
  cp_async_commit();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  for (int i = 0; i < n; ++i) {
    const int s0 = (tile_lo + i) * kBM;
    const int b0 = s0 + warp * 16 + g;  // the thread's rows of the output: b0, b0 + 8
    float2 c[2] = {make_float2(0.f, 0.f), make_float2(0.f, 0.f)};
#pragma unroll
    for (int half = 0; half < 2; ++half)
      if (b0 + 8 * half < B) c[half] = reinterpret_cast<const float2*>(coeffs)[b0 + 8 * half];
    cp_async_wait_all();  // tile i (and the table, with tile 0) has landed
    __syncthreads();      // ... for every thread; tile i - 1's buffer is free
    if (kStages > 1 && i + 1 < n) {
      load_tile(As + ((i + 1) % kStages) * kBM * kAStride, copy, u, s0 + kBM, B, ndof);
      cp_async_commit();
    }

    Acc acc;
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[j][h][r] = 0.f;
    const float* a_row = As + ((i % kStages) * kBM + warp * 16 + g) * kAStride +
                         (S == 16 ? 2 * t4 : t4);
    if (live == all_blocks<S>())  // no branch on the live mask: the compiler schedules freely
      tile_mma<true>(Mode{}, a_row, Tab, live, lane, acc);
    else
      tile_mma<false>(Mode{}, a_row, Tab, live, lane, acc);

    // q = c0 acc[:, k] + c1 acc[:, 128 + k]; acc[..][0..1]: row g, [2..3]: row g + 8
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int b = b0 + 8 * half;
      if (b >= B) continue;
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        const int lane_out = lane0 + j * 8 + 2 * t4;  // even; NX2 is even
        if (lane_out >= NX2) continue;
        float2 v;
        v.x = __fadd_rn(__fmul_rn(c[half].x, acc[j][0][2 * half]),
                        __fmul_rn(c[half].y, acc[j][1][2 * half]));
        v.y = __fadd_rn(__fmul_rn(c[half].x, acc[j][0][2 * half + 1]),
                        __fmul_rn(c[half].y, acc[j][1][2 * half + 1]));
        *reinterpret_cast<float2*>(q + b * ndof + static_cast<size_t>(y) * NX2 + lane_out) = v;
      }
    }
    if (kStages == 1 && i + 1 < n) {  // one buffer: refill it once every warp is done
      __syncthreads();
      load_tile(As, copy, u, s0 + kBM, B, ndof);
      cp_async_commit();
    }
  }
}

// Blocks of the kernel an SM of the current device holds, and the device's
// SMs; cached per device (a race only writes the same values twice).
template <class Mode>
cudaError_t slots(int* blocks_per_sm, int* sms) {
  static std::atomic<int> cache[kMaxDevices][2];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && cache[dev][0].load() > 0) {
    *blocks_per_sm = cache[dev][0].load();
    *sms = cache[dev][1].load();
    return cudaSuccess;
  }
  constexpr size_t smem = smem_bytes<Mode>();
  err = cudaFuncSetAttribute(stencil_mxu_kernel<Mode>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, stencil_mxu_kernel<Mode>,
                                                        kThreads, smem);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  if (*blocks_per_sm <= 0) return cudaErrorInvalidConfiguration;
  if (dev < kMaxDevices) {
    cache[dev][1].store(*sms);
    cache[dev][0].store(*blocks_per_sm);
  }
  return cudaSuccess;
}

// The sample-tile groups of a launch: blocks = groups x (NY x slices) run in
// waves of per_sm x sms; a block's time is its tiles plus about one tile for
// its table. The fewest groups of the least (waves x (tiles a group + 1)).
int plan_groups(int tiles, long long work, int per_sm, int sms) {
  const long long wave = static_cast<long long>(per_sm) * sms;
  int best = 1;
  long long best_cost = -1;
  for (int g = 1; g <= tiles; ++g) {
    const long long waves = (work * g + wave - 1) / wave;
    const long long cost = waves * ((tiles + g - 1) / g + 1);
    if (best_cost < 0 || cost < best_cost) {
      best = g;
      best_cost = cost;
    }
  }
  return best;
}

int shape_ok(int B, int NY, int NX2) {
  return B > 0 && NY > 0 && NX2 > 0 && NX2 % 2 == 0 &&
         static_cast<long long>(NY) * ((NX2 + kSlice - 1) / kSlice) <= 65535;
}

template <class Mode>
int plan(int B, int NY, int NX2, int* out) {
  if (!shape_ok(B, NY, NX2)) return static_cast<int>(cudaErrorInvalidValue);
  int per_sm = 0, sms = 0;
  const cudaError_t err = slots<Mode>(&per_sm, &sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (B + kBM - 1) / kBM;
  out[0] = plan_groups(tiles, static_cast<long long>(NY) * ((NX2 + kSlice - 1) / kSlice), per_sm,
                       sms);
  out[1] = per_sm;
  out[2] = sms;
  return 0;
}

template <class Mode>
int launch(const void* m0, const void* m1, const void* coeffs, const void* u, void* q, int B,
           int NY, int NX2, void* stream) {
  if (!shape_ok(B, NY, NX2)) return static_cast<int>(cudaErrorInvalidValue);
  // the table blocks are copied as 16-byte pieces, u as 8-byte pairs
  if (reinterpret_cast<size_t>(m0) % 16 || reinterpret_cast<size_t>(m1) % 16 ||
      reinterpret_cast<size_t>(u) % 8 || reinterpret_cast<size_t>(coeffs) % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  int out[3];  // the plan also sets the kernel's shared-memory attribute
  const int err = plan<Mode>(B, NY, NX2, out);
  if (err != 0) return err;
  const int groups = out[0];
  const int slices = (NX2 + kSlice - 1) / kSlice;
  using Table = typename Mode::Table;
  const dim3 grid(groups, NY * slices);
  stencil_mxu_kernel<Mode><<<grid, kThreads, smem_bytes<Mode>(), static_cast<cudaStream_t>(stream)>>>(
      static_cast<const Table*>(m0), static_cast<const Table*>(m1),
      static_cast<const float*>(coeffs), static_cast<const float*>(u), static_cast<float*>(q), B,
      NY, NX2, (NX2 + kHalf - 1) / kHalf, slices, groups);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points, bound with ctypes. All arrays are dense row-major on
// the current device: the tables (NY * T * 416, 256), T = ceil(NX2 / 128),
// 16-byte aligned, bfloat16 (m_hi, m_lo) or one float32 table (m_hi; m_lo
// unused); coeffs (B, 2), u and q (B, NY * NX2) float32, coeffs and u
// 8-byte aligned. Returns the CUDA error code of the launch (0 = success).
extern "C" int vbicm_stencil_mxu_bf16x3(const void* m_hi, const void* m_lo, const void* coeffs,
                                        const void* u, void* q, int B, int NY, int NX2,
                                        void* stream) {
  if (m_lo == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return launch<Bf16x3>(m_hi, m_lo, coeffs, u, q, B, NY, NX2, stream);
}

extern "C" int vbicm_stencil_mxu_f32(const void* m_hi, const void* /*m_lo*/, const void* coeffs,
                                     const void* u, void* q, int B, int NY, int NX2,
                                     void* stream) {
  return launch<Tf32x3>(m_hi, m_hi, coeffs, u, q, B, NY, NX2, stream);
}

// The launch the entry points above make at (B, NY, NX2) on the current
// device: out[3] = (sample-tile groups, blocks an SM holds, the device's
// SMs). Returns a CUDA error code (cudaErrorInvalidValue where the kernel
// takes no such launch).
extern "C" int vbicm_stencil_mxu_plan_bf16x3(int B, int NY, int NX2, int* out) {
  return plan<Bf16x3>(B, NY, NX2, out);
}

extern "C" int vbicm_stencil_mxu_plan_f32(int B, int NY, int NX2, int* out) {
  return plan<Tf32x3>(B, NY, NX2, out);
}

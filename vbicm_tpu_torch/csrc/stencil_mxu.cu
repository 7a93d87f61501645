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
//     operator, where one TF32 product would give 1e-3). FP64 DMMA is the
//     other float32-accurate choice: one product at the 67 TFLOP/s FP64
//     tensor-core rate against three at 494.7 TFLOP/s (165 TFLOP/s of
//     useful work), so 3xTF32 is chosen by the data sheet; unmeasured.
//
// What bounds it on an H100: at 160x80 (NY = 81, T = 3) and B = 256 the
// tables are 25.9 M entries, 103.5 MB in either mode, read once, plus 53.4
// MB of u and q; the densified products are 13.25 GFLOP a pass (3 passes):
// 40 us at the BF16 peak, 80 us at the TF32 peak, against 47 us of bytes.
// The band needs 19x fewer flops than the densified form.
//
// Design (simple; the band's zero blocks are computed, as on the TPU):
//   - one block per (tile of 64 samples, (y, t)), the sample tile the
//     fastest block index, so the 4 blocks that read one table block run
//     together and share it through L2;
//   - 8 warps as 2 (32 samples) x 4 (32 output lanes, in both column halves,
//     so the combine of the halves is in registers);
//   - the 416 table rows stream through shared memory in 13 chunks of 32,
//     double-buffered with cp.async: the table chunk as 16-byte copies, the
//     u window element by element with zero fill outside the grid;
//   - fragments are read from shared memory by each thread as the PTX
//     fragment layouts ask; the splits are made as fragments are built.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "tf32x3.cuh"

namespace {

constexpr int kWin = 136;
constexpr int kKdim = 3 * kWin + 8;  // 416
constexpr int kCols = 256;
constexpr int kHalf = 128;
constexpr int kBM = 64;  // samples a block
constexpr int kKC = 32;  // table rows a chunk
constexpr int kChunks = kKdim / kKC;  // 13
constexpr int kBStride = kCols + 8;  // shared row stride of a table chunk
constexpr int kThreads = 256;
static_assert(kKdim % kKC == 0, "chunks must tile the window");

struct Bf16x3 {
  using Table = uint16_t;  // bfloat16 bits
  static constexpr int kTables = 2;
  static constexpr int kAStride = kKC + 8;  // 40 floats: float2 fragment reads free of conflicts
  static constexpr int kStep = 16;
};

struct Tf32x3 {
  using Table = float;
  static constexpr int kTables = 1;
  static constexpr int kAStride = kKC + 4;  // 36 floats
  static constexpr int kStep = 8;
};

template <class Mode>
constexpr size_t smem_bytes() {
  return 2 * (static_cast<size_t>(kBM) * Mode::kAStride * sizeof(float) +
              static_cast<size_t>(Mode::kTables) * kKC * kBStride * sizeof(typename Mode::Table));
}

__device__ __forceinline__ void cp_async_4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }

__device__ __forceinline__ void cp_async_wait_all_but_newest() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t pack2(uint16_t lo, uint16_t hi) {
  return static_cast<uint32_t>(lo) | (static_cast<uint32_t>(hi) << 16);
}

// float2 -> packed (high, low) bfloat16 pairs: hi = bf16(x), lo = bf16(x - hi)
__device__ __forceinline__ void split_bf16(float2 x, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat16 h0 = __float2bfloat16_rn(x.x), h1 = __float2bfloat16_rn(x.y);
  const __nv_bfloat16 l0 = __float2bfloat16_rn(x.x - __bfloat162float(h0));
  const __nv_bfloat16 l1 = __float2bfloat16_rn(x.y - __bfloat162float(h1));
  hi = pack2(__bfloat16_as_ushort(h0), __bfloat16_as_ushort(h1));
  lo = pack2(__bfloat16_as_ushort(l0), __bfloat16_as_ushort(l1));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc[mt][h][j]: m-tile mt (16 samples), column half h, 8-lane n-tile j
using Acc = float[2][2][4][4];

// One chunk's products for the warp at (wm, wn); lane = (g, t4).
__device__ __forceinline__ void chunk_mma(const Bf16x3&, const float* As, const uint16_t* Bs,
                                          int wm, int wn, int g, int t4, Acc& acc) {
  const uint16_t* Bh = Bs;
  const uint16_t* Bl = Bs + kKC * kBStride;
#pragma unroll
  for (int ks = 0; ks < kKC / Bf16x3::kStep; ++ks) {
    const int kb = ks * Bf16x3::kStep;
    uint32_t ah[2][4], al[2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const float* r0 = As + (wm * 32 + mt * 16 + g) * Bf16x3::kAStride + kb + 2 * t4;
      const float* r1 = r0 + 8 * Bf16x3::kAStride;
      // a0-a1: (g, 2t4..), a2-a3: (g+8, 2t4..), a4-a5: (g, 2t4+8..), a6-a7: (g+8, 2t4+8..)
      split_bf16(*reinterpret_cast<const float2*>(r0), ah[mt][0], al[mt][0]);
      split_bf16(*reinterpret_cast<const float2*>(r1), ah[mt][1], al[mt][1]);
      split_bf16(*reinterpret_cast<const float2*>(r0 + 8), ah[mt][2], al[mt][2]);
      split_bf16(*reinterpret_cast<const float2*>(r1 + 8), ah[mt][3], al[mt][3]);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = h * kHalf + wn * 32 + j * 8 + g;
        const int k0 = (kb + 2 * t4) * kBStride + n;
        // b0-b1: rows 2t4, 2t4+1; b2-b3: rows 2t4+8, 2t4+9; column g
        const uint32_t bh0 = pack2(Bh[k0], Bh[k0 + kBStride]);
        const uint32_t bh1 = pack2(Bh[k0 + 8 * kBStride], Bh[k0 + 9 * kBStride]);
        const uint32_t bl0 = pack2(Bl[k0], Bl[k0 + kBStride]);
        const uint32_t bl1 = pack2(Bl[k0 + 8 * kBStride], Bl[k0 + 9 * kBStride]);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          mma_bf16(acc[mt][h][j], ah[mt], bh0, bh1);
          mma_bf16(acc[mt][h][j], al[mt], bh0, bh1);
          mma_bf16(acc[mt][h][j], ah[mt], bl0, bl1);
        }
      }
    }
  }
}

__device__ __forceinline__ void chunk_mma(const Tf32x3&, const float* As, const float* Bs, int wm,
                                          int wn, int g, int t4, Acc& acc) {
#pragma unroll
  for (int ks = 0; ks < kKC / Tf32x3::kStep; ++ks) {
    const int kb = ks * Tf32x3::kStep;
    uint32_t ab[2][4], asl[2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const float* r0 = As + (wm * 32 + mt * 16 + g) * Tf32x3::kAStride + kb + t4;
      const float* r1 = r0 + 8 * Tf32x3::kAStride;
      // a0: (g, t4), a1: (g+8, t4), a2: (g, t4+4), a3: (g+8, t4+4)
      split_tf32(r0[0], ab[mt][0], asl[mt][0]);
      split_tf32(r1[0], ab[mt][1], asl[mt][1]);
      split_tf32(r0[4], ab[mt][2], asl[mt][2]);
      split_tf32(r1[4], ab[mt][3], asl[mt][3]);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = h * kHalf + wn * 32 + j * 8 + g;
        // b0: row t4, b1: row t4+4; column g
        uint32_t bb0, bs0, bb1, bs1;
        split_tf32(Bs[(kb + t4) * kBStride + n], bb0, bs0);
        split_tf32(Bs[(kb + t4 + 4) * kBStride + n], bb1, bs1);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          mma_tf32(acc[mt][h][j], asl[mt], bb0, bb1);
          mma_tf32(acc[mt][h][j], ab[mt], bs0, bs1);
          mma_tf32(acc[mt][h][j], ab[mt], bb0, bb1);
        }
      }
    }
  }
}

// Start the copies of chunk c: the u window (kBM x kKC, zero outside the
// grid and past B) and each table's kKC rows.
template <class Mode>
__device__ __forceinline__ void load_chunk(int c, float* As, typename Mode::Table* Bs,
                                           const typename Mode::Table* const (&tab)[2],
                                           const float* __restrict__ u, size_t tab_row0, int y,
                                           int t, int s0, int B, int NY, int NX2) {
  using Table = typename Mode::Table;
  const size_t ndof = static_cast<size_t>(NY) * NX2;
  const int k0 = c * kKC;
  for (int e = threadIdx.x; e < kBM * kKC; e += kThreads) {
    const int m = e / kKC;
    const int kk = e % kKC;
    const int k = k0 + kk;
    const int dy = k / kWin;
    const int lane = t * kHalf + (k - dy * kWin) - 3;
    const int gy = y + dy - 1;
    const int b = s0 + m;
    const bool valid = dy < 3 && lane >= 0 && lane < NX2 && gy >= 0 && gy < NY && b < B;
    const float* src = valid ? u + b * ndof + static_cast<size_t>(gy) * NX2 + lane : u;
    cp_async_4(As + m * Mode::kAStride + kk, src, valid);
  }
  constexpr int kPieces = kCols * sizeof(Table) / 16;  // 16-byte pieces a table row
#pragma unroll
  for (int tb = 0; tb < Mode::kTables; ++tb) {
    for (int e = threadIdx.x; e < kKC * kPieces; e += kThreads) {
      const int r = e / kPieces;
      const int p = e % kPieces;
      const Table* src = tab[tb] + (tab_row0 + k0 + r) * kCols + p * (16 / sizeof(Table));
      cp_async_16(Bs + (tb * kKC + r) * kBStride + p * (16 / sizeof(Table)), src);
    }
  }
}

template <class Mode>
__global__ void __launch_bounds__(kThreads)
    stencil_mxu_kernel(const typename Mode::Table* __restrict__ m0,
                       const typename Mode::Table* __restrict__ m1,
                       const float* __restrict__ coeffs, const float* __restrict__ u,
                       float* __restrict__ q, int B, int NY, int NX2, int T) {
  using Table = typename Mode::Table;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* As[2];
  Table* Bs[2];
  {
    float* a = reinterpret_cast<float*>(smem_raw);
    As[0] = a;
    As[1] = a + kBM * Mode::kAStride;
    Table* b = reinterpret_cast<Table*>(a + 2 * kBM * Mode::kAStride);
    Bs[0] = b;
    Bs[1] = b + Mode::kTables * kKC * kBStride;
  }
  const Table* const tab[2] = {m0, m1};

  const int s0 = blockIdx.x * kBM;
  const int yt = blockIdx.y;  // y * T + t
  const int y = yt / T;
  const int t = yt % T;
  const size_t tab_row0 = static_cast<size_t>(yt) * kKdim;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int wm = warp / 4, wn = warp % 4;
  const int g = lane / 4, t4 = lane % 4;

  Acc acc;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[mt][h][j][r] = 0.f;

  load_chunk<Mode>(0, As[0], Bs[0], tab, u, tab_row0, y, t, s0, B, NY, NX2);
  cp_async_commit();
  for (int c = 0; c < kChunks; ++c) {
    if (c + 1 < kChunks)
      load_chunk<Mode>(c + 1, As[(c + 1) & 1], Bs[(c + 1) & 1], tab, u, tab_row0, y, t, s0, B,
                       NY, NX2);
    cp_async_commit();  // an empty group after the last chunk keeps the count
    cp_async_wait_all_but_newest();  // chunk c has landed
    __syncthreads();
    chunk_mma(Mode{}, As[c & 1], Bs[c & 1], wm, wn, g, t4, acc);
    __syncthreads();  // chunk c's buffers are refilled next iteration
  }

  // q = c0 acc[:, k] + c1 acc[:, 128 + k]; c[0..1]: row g, c[2..3]: row g + 8
  const size_t ndof = static_cast<size_t>(NY) * NX2;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int b = s0 + wm * 32 + mt * 16 + g + 8 * half;
      if (b >= B) continue;
      const float c0 = coeffs[2 * b], c1 = coeffs[2 * b + 1];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int lane_out = t * kHalf + wn * 32 + j * 8 + 2 * t4;  // even; NX2 is even
        if (lane_out >= NX2) continue;
        float2 v;
        v.x = __fadd_rn(__fmul_rn(c0, acc[mt][0][j][2 * half]),
                        __fmul_rn(c1, acc[mt][1][j][2 * half]));
        v.y = __fadd_rn(__fmul_rn(c0, acc[mt][0][j][2 * half + 1]),
                        __fmul_rn(c1, acc[mt][1][j][2 * half + 1]));
        *reinterpret_cast<float2*>(q + b * ndof + static_cast<size_t>(y) * NX2 + lane_out) = v;
      }
    }
  }
}

template <class Mode>
int launch(const void* m0, const void* m1, const void* coeffs, const void* u, void* q, int B,
           int NY, int NX2, void* stream) {
  if (B <= 0 || NY <= 0 || NX2 <= 0 || NX2 % 2 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const int T = (NX2 + kHalf - 1) / kHalf;
  if (static_cast<long long>(NY) * T > 65535) return static_cast<int>(cudaErrorInvalidValue);
  constexpr size_t smem = smem_bytes<Mode>();
  cudaError_t err = cudaFuncSetAttribute(stencil_mxu_kernel<Mode>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  using Table = typename Mode::Table;
  const dim3 grid((B + kBM - 1) / kBM, NY * T);
  stencil_mxu_kernel<Mode><<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const Table*>(m0), static_cast<const Table*>(m1),
      static_cast<const float*>(coeffs), static_cast<const float*>(u), static_cast<float*>(q), B,
      NY, NX2, T);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points, bound with ctypes. All arrays are dense row-major on
// the current device: the tables (NY * T * 416, 256), T = ceil(NX2 / 128),
// bfloat16 (m_hi, m_lo) or one float32 table (m_hi; m_lo unused); coeffs
// (B, 2), u and q (B, NY * NX2) float32. Returns the CUDA error code of the
// launch (0 = success).
extern "C" int vbicm_stencil_mxu_bf16x3(const void* m_hi, const void* m_lo, const void* coeffs,
                                        const void* u, void* q, int B, int NY, int NX2,
                                        void* stream) {
  if (m_lo == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return launch<Bf16x3>(m_hi, m_lo, coeffs, u, q, B, NY, NX2, stream);
}

extern "C" int vbicm_stencil_mxu_f32(const void* m_hi, const void* /*m_lo*/, const void* coeffs,
                                     const void* u, void* q, int B, int NY, int NX2,
                                     void* stream) {
  return launch<Tf32x3>(m_hi, nullptr, coeffs, u, q, B, NY, NX2, stream);
}

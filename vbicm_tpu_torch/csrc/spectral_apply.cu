// Batched spectral solve-apply for Hopper (sm_90a), as two tiled
// tensor-core products.
//
// Replaces the Pallas TPU kernel vbicm_tpu/ops/spectral_pallas.py,
// spectral_apply_batched (body _apply_kernel). For every sample s of a batch
//
//     a[s] = (b[s] V) / d[s],   d[s] = c0[s] * g + c1[s]      (eigen-coordinates)
//     x[s] = a[s] V^T                                          (= K(c_s)^-1 b[s])
//
// with V (n x n) the generalized eigenvectors of the stiffness pencil
// (K_lam, K_mu) and g its eigenvalues. The training step runs this for every
// forward solve, refinement and adjoint solve, and the two-level solvers once
// a CG iteration as their coarse solve.
//
// What bounds it on an H100: 2 x 2 B n^2 flops against n^2 + 3 B n values
// moved. At the coarse solve's (B, n) = (256, 1680) that is 2.9 GFLOP against
// 16.6 MB (f32): 43 us on the CUDA cores' 67 TFLOP/s, 5 us of HBM, so the
// arithmetic rate bounds it. The tensor cores take it below the CUDA cores'
// bound: float32 runs as 3xTF32 (three TF32 products, 17.5 us at the 494.7
// TFLOP/s TF32 peak), float64 as DMMA (the 67 TFLOP/s FP64 tensor rate). One
// TF32 or bf16 pass is not float32 accuracy and is not offered: the JAX
// package runs this apply at Precision.HIGHEST.
//
// Design: two GEMM-shaped launches on the caller's stream, M = B, N = K = n.
//   1. a = (b V) / d: the epilogue forms d[s, j] = c0[s] g[j] + c1[s],
//      rounded as the plain version rounds it, and multiplies by its
//      reciprocal, so the diagonal scale is fused and d never exists in
//      memory; a is always stored.
//   2. x = a V^T: V's rows are the "col" operand of the MMA as they lie in
//      memory, so no transposed copy of V exists.
//   The (B, n) intermediate a goes through device memory (1.7 MB at
//   (256, 1680), L2-resident): the TPU kernel's fusion of both products in
//   one program capped the grid at B / tile blocks, which left most of the
//   132 SMs idle (32 blocks of 4 warps at B = 256).
// Each launch tiles the (B, n) output in BM x BN blocks; the caller picks
// (BM, BN) from B and n (ops/spectral_kernel.py, launch_plan). Where those
// tiles leave SMs idle (76 of them for 132 SMs at (256, 1200)) the caller
// also splits the k-range S ways (gridDim.z): each slice's block stores its
// sum in a (S, B, n) scratch, and a second pass (spectral_combine_kernel)
// adds the S sums in order and finishes the output. A block is
// two groups of 4 warps: both groups compute the whole output tile, each
// over its half of every k-tile, so that a 64 x 64 tile keeps 8 warps on an
// SM, and the two sums meet in shared memory in a fixed order (no atomics,
// no second pass). k-tiles of both operands (64 deep in float32, 16 in
// float64) are staged in shared memory by cp.async, three stages deep (a
// copy group a stage, wait_group 1 before a stage is read), the row strides
// padded so that the fragment reads are free of bank conflicts. Each thread
// sets its copies' addresses once (Copier); a k-tile adds its offset and
// checks k against n. Rows of a whole number of 16-byte pieces take 16-byte
// copies; other n (e.g. f32 n = 130, 520-byte rows) take element copies.
// Ragged B, n and k-tiles are zero-filled by copies of src-size 0; masked
// outputs get no d and no store. The finished tile goes through shared
// memory so that neighbouring threads store neighbouring columns. No
// atomics: every output is summed in one fixed order, so a call is bitwise
// repeatable.
//   - float32: operands split into TF32 big and small parts as fragments
//     are built (tf32x3.cuh), As Bb + Ab Bs + Ab Bb by m16n8k8 MMAs. The
//     tensor cores truncate as they accumulate, so each k-tile's MMAs sum
//     into a fresh register tile that is then added to the total with a
//     rounded float32 add (one chain over all of K drifts by 3e-5 of max|x|
//     at n = 1680; this keeps it at 2e-6).
//   - float64: m8n8k4 DMMA, accumulated in float64.
// Not used yet: Hopper's wgmma and TMA. Bring-up probes found the copies,
// the shared-memory fragment reads and the operand split, more than the
// MMAs, setting the time; wgmma reads its operands from shared memory and
// TMA issues a tile's copy from one thread, which would remove most of that.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "tf32x3.cuh"

namespace {

constexpr int kKSplit = 2;                // warp groups that split each k-tile
constexpr int kThreads = 128 * kKSplit;  // 4 warps a group
constexpr int kStages = 3;

// The MMA shape of each dtype and the shared-memory row pads that make its
// fragment reads conflict-free (g = lane / 4, t4 = lane % 4): a [row][k]
// tile is read at (row g, k t4), in float32 at k 2 t4 and 2 t4 + 1 as one
// 64-bit read (stage_mma), a [k][col] tile at (k t4, col g), in float32 at
// k 2 t4 and 2 t4 + 1.
template <typename T>
struct Mma;

template <>
struct Mma<float> {  // 3xTF32, m16n8k8
  static constexpr int kM = 16;
  static constexpr int kK = 8;
  static constexpr int kBK = 64;
  static constexpr int kAcc = 4;
  static constexpr int kPadRowK = 8;  // stride = 8 mod 32 words (64-bit fragment reads)
  static constexpr int kPadKCol = 4;  // stride = 4 mod 32 words
  static constexpr bool kFlush = true;  // a k-tile's sum is added to the total in float32
};

template <>
struct Mma<double> {  // DMMA, m8n8k4
  static constexpr int kM = 8;
  static constexpr int kK = 4;
  static constexpr int kBK = 16;
  static constexpr int kAcc = 2;
  static constexpr int kPadRowK = 4;  // stride = 4 mod 16 doubles
  static constexpr int kPadKCol = 4;
  static constexpr bool kFlush = false;
};

// One launch's tiling: BM x BN outputs a block, warps of WM x WN; kBack is
// launch 2 (the V operand staged as [col][k] rows of V) rather than launch
// 1 (staged as [k][col]).
template <typename T, int BM, int BN, int WM, int WN, bool kBack>
struct Tiling {
  using M = Mma<T>;
  static constexpr int kBK = M::kBK;
  static constexpr int kSA = kBK + M::kPadRowK;
  static constexpr int kSB = kBack ? kBK + M::kPadRowK : BN + M::kPadKCol;
  static constexpr int kAElems = BM * kSA;
  static constexpr int kStageElems = kAElems + (kBack ? BN : kBK) * kSB;
  static constexpr int kSR = BN + 4;  // row stride of the output tile in the epilogue
  static constexpr size_t kStagesBytes =
      static_cast<size_t>(kStages) * kStageElems * sizeof(T);
  static constexpr size_t kOutBytes = static_cast<size_t>(kKSplit) * BM * kSR * sizeof(T);
  static constexpr size_t kSmem = kStagesBytes > kOutBytes ? kStagesBytes : kOutBytes;
  static constexpr int kMT = WM / M::kM;
  static constexpr int kNT = WN / 8;
  static constexpr int kWarpsN = BN / WN;
  static constexpr int kGroupK = kBK / kKSplit;
  static_assert((BM / WM) * (BN / WN) * 32 * kKSplit == kThreads, "4 warps a group");
  static_assert(WM % M::kM == 0 && WN % 8 == 0 && kGroupK % M::kK == 0, "whole MMA tiles");
};

// Global -> shared, asynchronously; `valid` false writes zeros and reads
// nothing (src-size 0).
template <int kBytes>
__device__ __forceinline__ void cp_async(void* dst, const void* src, bool valid) {
  const int size = valid ? kBytes : 0;
  if constexpr (kBytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
                 "l"(src), "r"(size));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(smem_addr(dst)),
                 "l"(src), "n"(kBytes), "r"(size));
  }
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// A thread's copies of one operand's k-tiles: an R x C tile of a row-major
// matrix with leading dimension ld, kV values a copy, into shared memory of
// row stride S. Thread t copies tile rows rt + i kRowStep at column ct. The
// k index runs along the tile's columns (kKCols: b, a, and launch 2's rows
// of V) or its rows (launch 1's rows of V). Addresses and the bound of the
// fixed index are set once; a k-tile only adds k0 and checks k against n.
// Copies outside the matrix read nothing and write zeros.
template <typename T, int R, int C, int S, int kV, bool kKCols>
struct Copier {
  static constexpr int kCPR = C / kV;  // copies a tile row
  static_assert(kThreads % kCPR == 0, "whole tile rows a pass");
  static constexpr int kRowStep = kThreads / kCPR;
  static constexpr int kPer = (R + kRowStep - 1) / kRowStep;
  const T* first;  // the thread's first copy at k = 0
  size_t step;     // kRowStep rows
  int sm;          // its shared-memory offset
  int rt, ct;
  int fixed_left;  // kKCols: rows left in the matrix from the thread's first row;
                   // else 1 if its column is in the matrix

  __device__ __forceinline__ Copier(const T* src, int ld, int r0, int c0, int rlim, int clim) {
    rt = static_cast<int>(threadIdx.x) / kCPR;
    ct = static_cast<int>(threadIdx.x) % kCPR * kV;
    first = src + static_cast<size_t>(r0 + rt) * ld + c0 + ct;
    step = static_cast<size_t>(kRowStep) * ld;
    sm = rt * S + ct;
    fixed_left = kKCols ? rlim - r0 - rt : (c0 + ct < clim ? 1 : 0);
  }

  __device__ __forceinline__ void copy(T* stage, const T* src, int ld, int k0, int n) const {
    const bool col_in = kKCols ? k0 + ct < n : fixed_left > 0;
    const T* p = first + (kKCols ? static_cast<size_t>(k0) : static_cast<size_t>(k0) * ld);
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      if (R % kRowStep != 0 && rt + i * kRowStep >= R) break;
      const bool valid = col_in && (kKCols ? i * kRowStep < fixed_left
                                           : k0 + rt + i * kRowStep < n);
      cp_async<kV * static_cast<int>(sizeof(T))>(stage + sm + i * kRowStep * S,
                                                 valid ? p + i * step : src, valid);
    }
  }
};

// One staged k-tile's products for the warp at (wm0, wn0): float32 as
// 3xTF32. Each k-step builds the warp's fragments once, then issues the
// three products as three passes over its kMT x kNT MMA tiles. Within an
// 8-deep step the k order is permuted alike in both operands: the MMA's k
// t4 and t4 + 4 are the tile's columns (or rows) 2 t4 and 2 t4 + 1, so that
// a fragment pair of A, and of launch 2's V rows, is one 64-bit read.
template <class Cfg, bool kBack>
__device__ __forceinline__ void stage_mma(const float* As, const float* Bs, int wm0, int wn0,
                                          int g, int t4, float (&acc)[Cfg::kMT][Cfg::kNT][4]) {
#pragma unroll
  for (int kb = 0; kb < Cfg::kGroupK; kb += 8) {
    uint32_t ab[Cfg::kMT][4], asl[Cfg::kMT][4], bb[Cfg::kNT][2], bs[Cfg::kNT][2];
#pragma unroll
    for (int mt = 0; mt < Cfg::kMT; ++mt) {
      const float* row = As + (wm0 + mt * 16 + g) * Cfg::kSA + kb + 2 * t4;
      const float2 lo = *reinterpret_cast<const float2*>(row);
      const float2 hi = *reinterpret_cast<const float2*>(row + 8 * Cfg::kSA);
      split_tf32(lo.x, ab[mt][0], asl[mt][0]);
      split_tf32(hi.x, ab[mt][1], asl[mt][1]);
      split_tf32(lo.y, ab[mt][2], asl[mt][2]);
      split_tf32(hi.y, ab[mt][3], asl[mt][3]);
    }
#pragma unroll
    for (int nt = 0; nt < Cfg::kNT; ++nt) {
      const int col = wn0 + nt * 8 + g;
      float v0, v1;
      if constexpr (kBack) {
        const float2 v = *reinterpret_cast<const float2*>(Bs + col * Cfg::kSB + kb + 2 * t4);
        v0 = v.x;
        v1 = v.y;
      } else {
        v0 = Bs[(kb + 2 * t4) * Cfg::kSB + col];
        v1 = Bs[(kb + 2 * t4 + 1) * Cfg::kSB + col];
      }
      split_tf32(v0, bb[nt][0], bs[nt][0]);
      split_tf32(v1, bb[nt][1], bs[nt][1]);
    }
#pragma unroll
    for (int nt = 0; nt < Cfg::kNT; ++nt)
#pragma unroll
      for (int mt = 0; mt < Cfg::kMT; ++mt) mma_tf32(acc[mt][nt], asl[mt], bb[nt][0], bb[nt][1]);
#pragma unroll
    for (int nt = 0; nt < Cfg::kNT; ++nt)
#pragma unroll
      for (int mt = 0; mt < Cfg::kMT; ++mt) mma_tf32(acc[mt][nt], ab[mt], bs[nt][0], bs[nt][1]);
#pragma unroll
    for (int nt = 0; nt < Cfg::kNT; ++nt)
#pragma unroll
      for (int mt = 0; mt < Cfg::kMT; ++mt) mma_tf32(acc[mt][nt], ab[mt], bb[nt][0], bb[nt][1]);
  }
}

__device__ __forceinline__ void mma_f64(double (&d)[2], double a, double b) {
  asm volatile("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0,%1}, {%2}, {%3}, {%0,%1};\n"
               : "+d"(d[0]), "+d"(d[1])
               : "d"(a), "d"(b));
}

// The same for float64 on DMMA. Fragments: a (row g, k t4), b (k t4, col g),
// d0-d1 (g, 2t4..2t4+1).
template <class Cfg, bool kBack>
__device__ __forceinline__ void stage_mma(const double* As, const double* Bs, int wm0, int wn0,
                                          int g, int t4, double (&acc)[Cfg::kMT][Cfg::kNT][2]) {
#pragma unroll
  for (int kb = 0; kb < Cfg::kGroupK; kb += 4) {
    double av[Cfg::kMT];
#pragma unroll
    for (int mt = 0; mt < Cfg::kMT; ++mt) av[mt] = As[(wm0 + mt * 8 + g) * Cfg::kSA + kb + t4];
#pragma unroll
    for (int nt = 0; nt < Cfg::kNT; ++nt) {
      const int col = wn0 + nt * 8 + g;
      const double bv = kBack ? Bs[col * Cfg::kSB + kb + t4] : Bs[(kb + t4) * Cfg::kSB + col];
#pragma unroll
      for (int mt = 0; mt < Cfg::kMT; ++mt) mma_f64(acc[mt][nt], av[mt], bv);
    }
  }
}

// 1 / d without the IEEE division's slow-path call (whose saved registers
// spilled): the hardware's approximate reciprocal and Newton steps, within
// 1 ulp (float32: from 2^-23; float64: from ~2^-20 via two steps) for the
// positive, normal d of the pencil.
__device__ __forceinline__ float recip(float d) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;\n" : "=f"(r) : "f"(d));
  return __fmaf_rn(r, __fmaf_rn(-d, r, 1.0f), r);
}

__device__ __forceinline__ double recip(double d) {
  double r;
  asm("rcp.approx.ftz.f64 %0, %1;\n" : "=d"(r) : "d"(d));
  r = __fma_rn(r, __fma_rn(-d, r, 1.0), r);
  return __fma_rn(r, __fma_rn(-d, r, 1.0), r);
}

__device__ __forceinline__ float mul_rn(float x, float y) { return __fmul_rn(x, y); }
__device__ __forceinline__ double mul_rn(double x, double y) { return __dmul_rn(x, y); }
__device__ __forceinline__ float add_rn(float x, float y) { return __fadd_rn(x, y); }
__device__ __forceinline__ double add_rn(double x, double y) { return __dadd_rn(x, y); }

// Launch 1 (kBack false): out = a = (A V) / d with A = b. Launch 2 (kBack
// true): out = x = A V^T with A = a. A and out are (B, n), V (n, n). kVec:
// 16-byte copies. With gridDim.z = S > 1 block z sums its S-th of the
// k-tiles and stores the raw sum in ws[z] (S, B, n); spectral_combine_kernel
// then adds the S sums in order and finishes out.
template <typename T, int BM, int BN, int WM, int WN, bool kBack, bool kVec>
__global__ void __launch_bounds__(kThreads)
    spectral_apply_kernel(const T* __restrict__ A, const T* __restrict__ V,
                          const T* __restrict__ g, const T* __restrict__ coeffs,
                          T* __restrict__ out, T* __restrict__ ws, int B, int n) {
  using Cfg = Tiling<T, BM, BN, WM, WN, kBack>;
  constexpr int kBK = Cfg::kBK;
  constexpr int kV = kVec ? 16 / static_cast<int>(sizeof(T)) : 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);

  const int s0 = blockIdx.x * BM;  // the sample tile is the fastest block index:
  const int j0 = blockIdx.y * BN;  // the blocks that share V's panel run together
  const int warp = threadIdx.x / 32 % 4;
  const int group = threadIdx.x / 128;
  const int lane = threadIdx.x % 32;
  const int wm0 = warp / Cfg::kWarpsN * WM;
  const int wn0 = warp % Cfg::kWarpsN * WN;
  const int gq = lane / 4;
  const int t4 = lane % 4;

  // acc: the total; part: the current k-tile's sum (float32 only). The
  // tensor cores truncate as they accumulate, so one chain of MMAs over all
  // of K drifts (3e-5 of max|x| at n = 1680); each k-tile's chain is added
  // to the total with a rounded float32 add.
  T acc[Cfg::kMT][Cfg::kNT][Mma<T>::kAcc], part[Cfg::kMT][Cfg::kNT][Mma<T>::kAcc];
#pragma unroll
  for (int mt = 0; mt < Cfg::kMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < Cfg::kNT; ++nt)
#pragma unroll
      for (int r = 0; r < Mma<T>::kAcc; ++r) acc[mt][nt][r] = part[mt][nt][r] = T(0);

  const Copier<T, BM, kBK, Cfg::kSA, kV, true> copy_a(A, n, s0, 0, B, n);
  using CopyV = Copier<T, kBack ? BN : kBK, kBack ? kBK : BN, Cfg::kSB, kV, kBack>;
  const CopyV copy_v = kBack ? CopyV(V, n, j0, 0, n, n) : CopyV(V, n, 0, j0, n, n);
  const int ktiles_all = (n + kBK - 1) / kBK;
  const int kt_begin = static_cast<int>(blockIdx.z * ktiles_all / gridDim.z);
  const int ktiles = static_cast<int>((blockIdx.z + 1) * ktiles_all / gridDim.z) - kt_begin;
  auto load_stage = [&](int kt, int stage) {
    T* As = smem + stage * Cfg::kStageElems;
    copy_a.copy(As, A, n, (kt_begin + kt) * kBK, n);
    copy_v.copy(As + Cfg::kAElems, V, n, (kt_begin + kt) * kBK, n);
  };

#pragma unroll
  for (int kt = 0; kt < kStages - 1; ++kt) {
    if (kt < ktiles) load_stage(kt, kt);
    cp_async_commit();
  }
  int read_stage = 0, write_stage = kStages - 1;
  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<kStages - 2>();  // k-tile kt has landed (this thread's copies)
    __syncthreads();               // ... everyone's, and k-tile kt - 1 is consumed
    if (kt + kStages - 1 < ktiles) load_stage(kt + kStages - 1, write_stage);
    cp_async_commit();  // an empty group near the end keeps the count
    const T* As = smem + read_stage * Cfg::kStageElems + group * Cfg::kGroupK;
    const T* Bs = smem + read_stage * Cfg::kStageElems + Cfg::kAElems +
                  group * Cfg::kGroupK * (kBack ? 1 : Cfg::kSB);
    if constexpr (Mma<T>::kFlush) {
      stage_mma<Cfg, kBack>(As, Bs, wm0, wn0, gq, t4, part);
#pragma unroll
      for (int mt = 0; mt < Cfg::kMT; ++mt)
#pragma unroll
        for (int nt = 0; nt < Cfg::kNT; ++nt)
#pragma unroll
          for (int r = 0; r < Mma<T>::kAcc; ++r) {
            acc[mt][nt][r] = add_rn(acc[mt][nt][r], part[mt][nt][r]);
            part[mt][nt][r] = T(0);
          }
    } else {
      stage_mma<Cfg, kBack>(As, Bs, wm0, wn0, gq, t4, acc);
    }
    read_stage = read_stage + 1 == kStages ? 0 : read_stage + 1;
    write_stage = write_stage + 1 == kStages ? 0 : write_stage + 1;
  }

  // The output tile goes through shared memory (free once every copy has
  // landed and every thread has passed the last k-tile), so that each output
  // is finished and stored by one thread, neighbouring threads on
  // neighbouring columns. Accumulator r of MMA tile (mt, nt) is at row
  // g + 8 (r / 2), column 2 t4 + r % 2.
  cp_async_wait<0>();
  __syncthreads();
#pragma unroll
  for (int mt = 0; mt < Cfg::kMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < Cfg::kNT; ++nt)
#pragma unroll
      for (int r = 0; r < Mma<T>::kAcc; ++r)
        smem[(group * BM + wm0 + mt * Mma<T>::kM + gq + 8 * (r / 2)) * Cfg::kSR + wn0 +
             nt * 8 + 2 * t4 + r % 2] = acc[mt][nt][r];
  __syncthreads();
  for (int e = threadIdx.x; e < BM * BN; e += kThreads) {
    const int row = e / BN;
    const int col = e % BN;
    const int s = s0 + row;
    const int j = j0 + col;
    if (s >= B || j >= n) continue;  // masked: no d, no store
    T v = smem[row * Cfg::kSR + col];
#pragma unroll
    for (int q = 1; q < kKSplit; ++q) v = add_rn(v, smem[(q * BM + row) * Cfg::kSR + col]);
    const size_t at = static_cast<size_t>(s) * n + j;
    if (gridDim.z > 1) {
      ws[blockIdx.z * static_cast<size_t>(B) * n + at] = v;
      continue;
    }
    if constexpr (!kBack)
      v = mul_rn(v, recip(add_rn(mul_rn(coeffs[2 * s], g[j]), coeffs[2 * s + 1])));
    out[at] = v;
  }
}

// The second pass of a split apply: out = the sum of ws's S (B, n) partial
// sums, in order (then / d after launch 1).
template <typename T, bool kBack>
__global__ void __launch_bounds__(256)
    spectral_combine_kernel(const T* __restrict__ ws, int S, const T* __restrict__ g,
                            const T* __restrict__ coeffs, T* __restrict__ out, int B, int n) {
  const size_t total = static_cast<size_t>(B) * n;
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= total) return;
  T v = ws[i];
  for (int z = 1; z < S; ++z) v = add_rn(v, ws[z * total + i]);
  if constexpr (!kBack) {
    const size_t s = i / n;
    v = mul_rn(v, recip(add_rn(mul_rn(coeffs[2 * s], g[i - s * n]), coeffs[2 * s + 1])));
  }
  out[i] = v;
}

// One product, and with split > 1 its second pass.
template <typename T, int BM, int BN, int WM, int WN, bool kBack, bool kVec>
int launch_one(dim3 grid, const T* A, const T* V, const T* g, const T* coeffs, T* out, T* ws,
               int B, int n, cudaStream_t stream) {
  constexpr size_t smem = Tiling<T, BM, BN, WM, WN, kBack>::kSmem;
  auto* kernel = spectral_apply_kernel<T, BM, BN, WM, WN, kBack, kVec>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, kThreads, smem, stream>>>(A, V, g, coeffs, out, ws, B, n);
  if (grid.z > 1) {
    const size_t total = static_cast<size_t>(B) * n;
    spectral_combine_kernel<T, kBack><<<static_cast<unsigned>((total + 255) / 256), 256, 0,
                                        stream>>>(ws, static_cast<int>(grid.z), g, coeffs, out,
                                                  B, n);
  }
  return static_cast<int>(cudaGetLastError());
}

// a = (b V) / d, then x = a V^T, in stream order.
template <typename T, int BM, int BN, int WM, int WN, bool kVec>
int launch_tiles(const T* V, const T* g, const T* coeffs, const T* b, T* x, T* a, T* ws, int B,
                 int n, int split, cudaStream_t stream) {
  const dim3 grid((B + BM - 1) / BM, (n + BN - 1) / BN, split);
  const int err =
      launch_one<T, BM, BN, WM, WN, false, kVec>(grid, b, V, g, coeffs, a, ws, B, n, stream);
  if (err != 0) return err;
  return launch_one<T, BM, BN, WM, WN, true, kVec>(grid, a, V, g, coeffs, x, ws, B, n, stream);
}

template <typename T, int BM, int BN, int WM, int WN>
int launch_tiles(const T* V, const T* g, const T* coeffs, const T* b, T* x, T* a, T* ws, int B,
                 int n, int split, bool vec, cudaStream_t stream) {
  return vec ? launch_tiles<T, BM, BN, WM, WN, true>(V, g, coeffs, b, x, a, ws, B, n, split,
                                                     stream)
             : launch_tiles<T, BM, BN, WM, WN, false>(V, g, coeffs, b, x, a, ws, B, n, split,
                                                      stream);
}

template <typename T>
int launch(const void* V, const void* g, const void* coeffs, const void* b, void* x, void* a,
           void* ws, int B, int n, int bm, int bn, int split, int vec, void* stream) {
  if (B <= 0 || n <= 0 || n > 65535 * 32 || a == nullptr || split < 1 || split > 8 ||
      (split > 1 && ws == nullptr) || static_cast<long long>(B) * n >= (1LL << 31) ||
      static_cast<long long>(n) * n >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  if (vec && n % (16 / static_cast<int>(sizeof(T))) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const T* pV = static_cast<const T*>(V);
  const T* pg = static_cast<const T*>(g);
  const T* pc = static_cast<const T*>(coeffs);
  const T* pb = static_cast<const T*>(b);
  T* px = static_cast<T*>(x);
  T* pa = static_cast<T*>(a);
  T* pw = static_cast<T*>(ws);
  const bool v = vec != 0;
  // the tiles of ops/spectral_kernel.py's TILES; a group's warps 2 x 2 (1 x 4 at BM 16)
  if (bm == 64 && bn == 64)
    return launch_tiles<T, 64, 64, 32, 32>(pV, pg, pc, pb, px, pa, pw, B, n, split, v, s);
  if (bm == 64 && bn == 32)
    return launch_tiles<T, 64, 32, 32, 16>(pV, pg, pc, pb, px, pa, pw, B, n, split, v, s);
  if (bm == 32 && bn == 32)
    return launch_tiles<T, 32, 32, 16, 16>(pV, pg, pc, pb, px, pa, pw, B, n, split, v, s);
  if (bm == 16 && bn == 32)
    return launch_tiles<T, 16, 32, 16, 8>(pV, pg, pc, pb, px, pa, pw, B, n, split, v, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Plain C entry points, bound with ctypes. All arrays are dense row-major on
// the current device: V (n, n); g (n,); coeffs (B, 2); b, x, a (B, n), a
// always written (launch 2 reads it); ws (split, B, n) scratch when split > 1
// (else unused). (bm, bn) is the output tile, one of ops/spectral_kernel.py's
// TILES; split the k-range split (1 to 8); vec selects 16-byte copies (n a
// multiple of 16 bytes' worth of values, V, b and a 16-byte aligned).
// Returns the CUDA error code of the launches (0 = success).
extern "C" int vbicm_spectral_apply_f32(const void* V, const void* g, const void* coeffs,
                                        const void* b, void* x, void* a, void* ws, int B, int n,
                                        int bm, int bn, int split, int vec, void* stream) {
  return launch<float>(V, g, coeffs, b, x, a, ws, B, n, bm, bn, split, vec, stream);
}

extern "C" int vbicm_spectral_apply_f64(const void* V, const void* g, const void* coeffs,
                                        const void* b, void* x, void* a, void* ws, int B, int n,
                                        int bm, int bn, int split, int vec, void* stream) {
  return launch<double>(V, g, coeffs, b, x, a, ws, B, n, bm, bn, split, vec, stream);
}

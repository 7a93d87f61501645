// Batched structured-grid affine stencil matvec for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel vbicm_tpu/ops/stencil_pallas.py,
// stencil_affine_matvec_pallas (body _row_kernel). On the structured quad4
// grid of Cook's membrane the assembled stiffness couples a node only to its
// 8 neighbours; with the dofs interleaved along a grid row (lane i = 2x + a)
// the 2x2 block stencil is a 7-tap stencil along the row for each of the
// three rows y-1, y, y+1. For every sample s, grid row y and lane i
//
//     q[s, y, i] = c0[s] * sum_{dy, d} W0[y, dy, d, i] * u[s, y+dy-1, i+d-3]
//                + c1[s] * sum_{dy, d} W1[y, dy, d, i] * u[s, y+dy-1, i+d-3]
//
// with dy in 0..2, d in 0..6: 42 coefficient planes, stored (NY, 42, 2NX)
// with plane (p*3 + dy)*7 + d. Rows and lanes outside the grid contribute
// zero. The conjugate-gradient loop of the two-level solver runs this for
// every iteration, and the refinement residual and the adjoint's
// coefficient cotangents run the float64 instance.
//
// What bounds it on an H100: per sample and lane 42 multiply-adds against
// 42 coefficients that every sample shares; at 160x80 (NY = 81, 2NX = 322)
// and B = 256 that is 0.28 G multiply-adds, 27 MB of u read and 27 MB of q
// written in float32, and 8.8 MB of planes. Memory traffic and the
// shared-memory reads of u bound it, not arithmetic.
//
// Design: one block per (grid row y, tile of TS samples).
//   1. the tile's three u rows, with three zero halo lanes on each side and
//      zero rows above and below the grid, are staged in shared memory
//      (TS * 3 * (2NX + 6) values); samples beyond B are not staged;
//   2. each thread owns lanes i = tid, tid + blockDim, ...; for each lane it
//      reads the 42 coefficients of row y once into registers and reuses
//      them for every sample of the tile, so the planes are read once per
//      tile, not once per sample;
//   3. per sample, 21 shared-memory reads of u feed both parts' sums, and
//      c0, c1 are applied in registers.
// Neighbouring threads read neighbouring lanes of u, W and q, so global
// loads and stores coalesce and shared-memory reads are free of conflicts.
//
// Rows-per-block option (replaces the Pallas TPU kernel
// stencil_affine_matvec_pallas_mr, body _mr_kernel, in the same file): one
// block per (RPP consecutive grid rows, tile of TS samples). The one-row
// design stages each u row three times, once for each output row it feeds;
// here a block stages its RPP + 2 rows once, with cp.async copies that fill
// the halo lanes and the rows outside the grid with zeros. Rows 0-2 are one
// copy group and each further row its own, so the copy of row r + 3 is in
// flight while row r is computed (the TPU kernel's double-buffered DMA). The
// last block takes the rows left when RPP does not divide NY. Both kernels
// compute every output in lane_value, with explicit FMAs in one order, so the
// option is bitwise equal to the one-row kernel in float32 and float64.
//
// Not yet done (later work): TMA, tensor cores (see stencil_mxu.cu for the
// banded tensor-core form of the same function).

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kTaps = 7;
constexpr int kRows = 3;
constexpr int kPlanes = 2 * kRows * kTaps;  // 42
constexpr int kHalo = 3;

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float fma_rn(float a, float b, float c) { return __fmaf_rn(a, b, c); }
__device__ __forceinline__ double fma_rn(double a, double b, double c) { return __fma_rn(a, b, c); }

// q at one (sample, row, lane): ur points at lane i - 3 of the sample's
// staged row y - 1, rows L apart; w0, w1 are the lane's 21 coefficients of
// each part. Explicit FMAs in a fixed order: both kernels call this, so
// their results are equal bit for bit.
template <typename T>
__device__ __forceinline__ T lane_value(const T* ur, int L, const T (&w0)[kRows * kTaps],
                                        const T (&w1)[kRows * kTaps], T c0, T c1) {
  T a0 = T(0), a1 = T(0);
#pragma unroll
  for (int dy = 0; dy < kRows; ++dy) {
#pragma unroll
    for (int d = 0; d < kTaps; ++d) {
      const T v = ur[dy * L + d];
      a0 = fma_rn(w0[dy * kTaps + d], v, a0);
      a1 = fma_rn(w1[dy * kTaps + d], v, a1);
    }
  }
  return fma_rn(c0, a0, mul_rn(c1, a1));
}

template <typename T>
__device__ __forceinline__ void load_lane_planes(const T* wy, int NX2, int i,
                                                 T (&w0)[kRows * kTaps],
                                                 T (&w1)[kRows * kTaps]) {
#pragma unroll
  for (int k = 0; k < kRows * kTaps; ++k) {
    w0[k] = __ldg(wy + static_cast<size_t>(k) * NX2 + i);
    w1[k] = __ldg(wy + static_cast<size_t>(kRows * kTaps + k) * NX2 + i);
  }
}

template <typename T>
__global__ void stencil_affine_kernel(const T* __restrict__ w, const T* __restrict__ coeffs,
                                      const T* __restrict__ u, T* __restrict__ q, int B, int NY,
                                      int NX2, int TS) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int L = NX2 + 2 * kHalo;  // staged row length
  T* us = reinterpret_cast<T*>(smem_raw);  // (TS, 3, L)
  T* cs = us + static_cast<size_t>(TS) * kRows * L;  // (TS, 2)

  const int y = blockIdx.x;
  const int s0 = blockIdx.y * TS;
  const int ns = min(TS, B - s0);
  const size_t ndof = static_cast<size_t>(NY) * NX2;

  for (int k = threadIdx.x; k < ns * kRows * L; k += blockDim.x) {
    const int j = k % L;
    const int sr = k / L;  // s * 3 + dy
    const int s = sr / kRows;
    const int yy = y + (sr % kRows) - 1;
    const int i = j - kHalo;
    T v = T(0);
    if (yy >= 0 && yy < NY && i >= 0 && i < NX2)
      v = u[(s0 + s) * ndof + static_cast<size_t>(yy) * NX2 + i];
    us[k] = v;
  }
  for (int k = threadIdx.x; k < 2 * ns; k += blockDim.x) cs[k] = coeffs[2 * s0 + k];
  __syncthreads();

  const T* wy = w + static_cast<size_t>(y) * kPlanes * NX2;
  for (int i = threadIdx.x; i < NX2; i += blockDim.x) {
    T w0[kRows * kTaps], w1[kRows * kTaps];
    load_lane_planes(wy, NX2, i, w0, w1);
    for (int s = 0; s < ns; ++s)
      q[(s0 + s) * ndof + static_cast<size_t>(y) * NX2 + i] =
          lane_value(us + static_cast<size_t>(s) * kRows * L + i, L, w0, w1, cs[2 * s],
                     cs[2 * s + 1]);
  }
}

// One element global -> shared, asynchronously; `valid` false writes zero
// and reads nothing (src-size 0).
template <typename T>
__device__ __forceinline__ void cp_async_elem(T* dst, const T* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d), "l"(src),
               "n"(sizeof(T)), "r"(valid ? static_cast<int>(sizeof(T)) : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }

__device__ __forceinline__ void cp_async_wait_all_but_newest() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Stage staged row r (grid row y0 + r - 1) of the tile's ns samples into
// us (TS, R, L), zero outside the grid and in the halo lanes.
template <typename T>
__device__ __forceinline__ void stage_row(T* us, const T* __restrict__ u, int r, int R, int L,
                                          int y0, int s0, int ns, int NY, int NX2) {
  const size_t ndof = static_cast<size_t>(NY) * NX2;
  const int yy = y0 + r - 1;
  const bool row_in = yy >= 0 && yy < NY;
  for (int k = threadIdx.x; k < ns * L; k += blockDim.x) {
    const int s = k / L;
    const int j = k % L;
    const int i = j - kHalo;
    const bool valid = row_in && i >= 0 && i < NX2;
    const T* src = valid ? u + (s0 + s) * ndof + static_cast<size_t>(yy) * NX2 + i : u;
    cp_async_elem(us + (static_cast<size_t>(s) * R + r) * L + j, src, valid);
  }
}

template <typename T>
__global__ void stencil_affine_rows_kernel(const T* __restrict__ w, const T* __restrict__ coeffs,
                                           const T* __restrict__ u, T* __restrict__ q, int B,
                                           int NY, int NX2, int TS, int RPP) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int L = NX2 + 2 * kHalo;
  const int R = RPP + 2;  // staged rows
  T* us = reinterpret_cast<T*>(smem_raw);  // (TS, R, L)
  T* cs = us + static_cast<size_t>(TS) * R * L;  // (TS, 2)

  const int y0 = blockIdx.x * RPP;
  const int nrows = min(RPP, NY - y0);
  const int s0 = blockIdx.y * TS;
  const int ns = min(TS, B - s0);
  const size_t ndof = static_cast<size_t>(NY) * NX2;

  for (int r = 0; r < 3; ++r) stage_row(us, u, r, R, L, y0, s0, ns, NY, NX2);
  cp_async_commit();
  for (int k = threadIdx.x; k < 2 * ns; k += blockDim.x) cs[k] = coeffs[2 * s0 + k];

  for (int r = 0; r < nrows; ++r) {
    if (r + 3 < nrows + 2) stage_row(us, u, r + 3, R, L, y0, s0, ns, NY, NX2);
    cp_async_commit();  // an empty group past the last row keeps the count
    cp_async_wait_all_but_newest();  // rows 0 .. r + 2 have landed
    __syncthreads();
    const int y = y0 + r;
    const T* wy = w + static_cast<size_t>(y) * kPlanes * NX2;
    for (int i = threadIdx.x; i < NX2; i += blockDim.x) {
      T w0[kRows * kTaps], w1[kRows * kTaps];
      load_lane_planes(wy, NX2, i, w0, w1);
      for (int s = 0; s < ns; ++s)
        q[(s0 + s) * ndof + static_cast<size_t>(y) * NX2 + i] =
            lane_value(us + (static_cast<size_t>(s) * R + r) * L + i, L, w0, w1, cs[2 * s],
                       cs[2 * s + 1]);
    }
  }
}

template <typename T>
int launch(const void* w, const void* coeffs, const void* u, void* q, int B, int NY, int NX2,
           int TS, int threads, void* stream) {
  if (B <= 0 || NY <= 0 || NX2 <= 0 || TS <= 0 || threads <= 0 || threads > 1024 ||
      threads % 32 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem =
      (static_cast<size_t>(TS) * kRows * (NX2 + 2 * kHalo) + 2 * static_cast<size_t>(TS)) *
      sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(stencil_affine_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(NY, (B + TS - 1) / TS);
  stencil_affine_kernel<T><<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(w), static_cast<const T*>(coeffs), static_cast<const T*>(u),
      static_cast<T*>(q), B, NY, NX2, TS);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_rows(const void* w, const void* coeffs, const void* u, void* q, int B, int NY, int NX2,
                int TS, int RPP, int threads, void* stream) {
  if (B <= 0 || NY <= 0 || NX2 <= 0 || TS <= 0 || RPP <= 0 || threads <= 0 || threads > 1024 ||
      threads % 32 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem =
      (static_cast<size_t>(TS) * (RPP + 2) * (NX2 + 2 * kHalo) + 2 * static_cast<size_t>(TS)) *
      sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(stencil_affine_rows_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((NY + RPP - 1) / RPP, (B + TS - 1) / TS);
  stencil_affine_rows_kernel<T><<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(w), static_cast<const T*>(coeffs), static_cast<const T*>(u),
      static_cast<T*>(q), B, NY, NX2, TS, RPP);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points, bound with ctypes. All arrays are dense row-major on
// the current device: w (NY, 42, NX2); coeffs (B, 2); u, q (B, NY * NX2).
// TS samples per block, `threads` threads per block (a multiple of 32).
// Returns the CUDA error code of the launch (0 = success).
extern "C" int vbicm_stencil_affine_f32(const void* w, const void* coeffs, const void* u, void* q,
                                        int B, int NY, int NX2, int TS, int threads,
                                        void* stream) {
  return launch<float>(w, coeffs, u, q, B, NY, NX2, TS, threads, stream);
}

extern "C" int vbicm_stencil_affine_f64(const void* w, const void* coeffs, const void* u, void* q,
                                        int B, int NY, int NX2, int TS, int threads,
                                        void* stream) {
  return launch<double>(w, coeffs, u, q, B, NY, NX2, TS, threads, stream);
}

// The rows-per-block option: RPP grid rows a block (the last block takes the
// rest), otherwise as above.
extern "C" int vbicm_stencil_affine_rows_f32(const void* w, const void* coeffs, const void* u,
                                             void* q, int B, int NY, int NX2, int TS, int RPP,
                                             int threads, void* stream) {
  return launch_rows<float>(w, coeffs, u, q, B, NY, NX2, TS, RPP, threads, stream);
}

extern "C" int vbicm_stencil_affine_rows_f64(const void* w, const void* coeffs, const void* u,
                                             void* q, int B, int NY, int NX2, int TS, int RPP,
                                             int threads, void* stream) {
  return launch_rows<double>(w, coeffs, u, q, B, NY, NX2, TS, RPP, threads, stream);
}

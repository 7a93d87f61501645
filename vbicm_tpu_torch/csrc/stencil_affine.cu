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
// Not yet done (later work): several rows per block so that a u row is read
// once and not three times (TPU kernel #3's idea), TMA, tensor cores.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kTaps = 7;
constexpr int kRows = 3;
constexpr int kPlanes = 2 * kRows * kTaps;  // 42
constexpr int kHalo = 3;

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
#pragma unroll
    for (int k = 0; k < kRows * kTaps; ++k) {
      w0[k] = __ldg(wy + static_cast<size_t>(k) * NX2 + i);
      w1[k] = __ldg(wy + static_cast<size_t>(kRows * kTaps + k) * NX2 + i);
    }
    for (int s = 0; s < ns; ++s) {
      const T* ur = us + static_cast<size_t>(s) * kRows * L + i;  // lane i - 3 of row dy = 0
      T a0 = T(0), a1 = T(0);
#pragma unroll
      for (int dy = 0; dy < kRows; ++dy) {
#pragma unroll
        for (int d = 0; d < kTaps; ++d) {
          const T v = ur[dy * L + d];
          a0 += w0[dy * kTaps + d] * v;
          a1 += w1[dy * kTaps + d] * v;
        }
      }
      q[(s0 + s) * ndof + static_cast<size_t>(y) * NX2 + i] = cs[2 * s] * a0 + cs[2 * s + 1] * a1;
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

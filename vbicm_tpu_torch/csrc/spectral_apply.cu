// Batched spectral solve-apply for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel vbicm_tpu/ops/spectral_pallas.py,
// spectral_apply_batched (body _apply_kernel). For every sample s of a batch
//
//     t[s] = (b[s] V) / d[s],   d[s] = c0[s] * g + c1[s]      (eigen-coordinates)
//     x[s] = t[s] V^T                                          (= K(c_s)^-1 b[s])
//
// with V (n x n) the generalized eigenvectors of the stiffness pencil
// (K_lam, K_mu) and g its eigenvalues. The training step runs this for every
// forward solve, refinement and adjoint solve.
//
// What bounds it on an H100: per sample 2 n^2 multiply-adds against n^2
// matrix entries shared by every sample. At n = 440 the matrix is 0.77 MB
// (f32) / 1.5 MB (f64), so V and V^T stay in the 50 MB L2 and the work is
// arithmetic plus L2 and shared-memory traffic, not device-memory traffic;
// the (B, n) intermediate t is the only thing a two-GEMM form would send
// through device memory.
//
// Design: one block owns a tile of TS samples and all n columns.
//   1. stage the tile's rows of b in shared memory (ragged last tile: rows
//      beyond B are zero, their d is set to 1 and nothing is stored);
//   2. t = b V: each thread owns kColsPerThread columns, reads V rows
//      coalesced through L2 and keeps TS x kColsPerThread sums in registers,
//      so one load of V feeds TS samples and one shared-memory read of b
//      feeds kColsPerThread columns; d is computed in the kernel from g and
//      the sample's (c0, c1), t is scaled in registers, written to shared
//      memory and, when asked, stored as the eigen-coordinates a;
//   3. __syncthreads();
//   4. x = t V^T, the same loop over a transposed copy of V made once on the
//      host, so the second product reads contiguous rows too.
// Columns beyond n are masked, never padded. The intermediate t never goes
// to device memory unless the caller asks for it. The tile TS is chosen by
// the caller from n so that 2 * TS * n values fit in shared memory.
//
// Not yet done (later work): tensor cores (wgmma / DMMA), TMA, and enough
// blocks to fill 132 SMs at B = 256 (B / TS blocks today).

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 128;
constexpr int kColsPerThread = 4;
constexpr int kColsPerPass = kThreads * kColsPerThread;

// acc[s][c] = sum_i src[s * n + i] * M[i * n + col(c)],  col(c) = j0 + tid + c * kThreads
template <typename T, int TS>
__device__ __forceinline__ void rows_times_matrix(const T* __restrict__ src,
                                                  const T* __restrict__ M, int n, int j0,
                                                  T (&acc)[TS][kColsPerThread]) {
  bool in_range[kColsPerThread];
#pragma unroll
  for (int c = 0; c < kColsPerThread; ++c) {
    in_range[c] = j0 + static_cast<int>(threadIdx.x) + c * kThreads < n;
#pragma unroll
    for (int s = 0; s < TS; ++s) acc[s][c] = T(0);
  }
  const T* col = M + j0 + threadIdx.x;
  for (int i = 0; i < n; ++i) {
    const T* row = col + static_cast<size_t>(i) * n;
    T m[kColsPerThread];
#pragma unroll
    for (int c = 0; c < kColsPerThread; ++c) m[c] = in_range[c] ? __ldg(row + c * kThreads) : T(0);
#pragma unroll
    for (int s = 0; s < TS; ++s) {
      const T bv = src[s * n + i];
#pragma unroll
      for (int c = 0; c < kColsPerThread; ++c) acc[s][c] += bv * m[c];
    }
  }
}

template <typename T, int TS>
__global__ void __launch_bounds__(kThreads)
    spectral_apply_kernel(const T* __restrict__ V, const T* __restrict__ Vt,
                          const T* __restrict__ g, const T* __restrict__ coeffs,
                          const T* __restrict__ b, T* __restrict__ x, T* __restrict__ a,
                          int B, int n) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* bs = reinterpret_cast<T*>(smem_raw);  // (TS, n) rows of b
  T* ts = bs + TS * n;                     // (TS, n) scaled eigen-coordinates
  const int s0 = blockIdx.x * TS;
  const int tid = threadIdx.x;

  for (int k = tid; k < TS * n; k += kThreads) {
    const int s = k / n;
    bs[k] = s0 + s < B ? b[static_cast<size_t>(s0) * n + k] : T(0);
  }
  T c0[TS], c1[TS];
#pragma unroll
  for (int s = 0; s < TS; ++s) {
    const bool valid = s0 + s < B;
    c0[s] = valid ? coeffs[2 * (s0 + s)] : T(0);
    c1[s] = valid ? coeffs[2 * (s0 + s) + 1] : T(1);
  }
  __syncthreads();

  T acc[TS][kColsPerThread];
  for (int j0 = 0; j0 < n; j0 += kColsPerPass) {
    rows_times_matrix<T, TS>(bs, V, n, j0, acc);
#pragma unroll
    for (int c = 0; c < kColsPerThread; ++c) {
      const int j = j0 + tid + c * kThreads;
      if (j >= n) continue;
      const T gj = g[j];
#pragma unroll
      for (int s = 0; s < TS; ++s) {
        const T t = acc[s][c] / (c0[s] * gj + c1[s]);
        ts[s * n + j] = t;
        if (a != nullptr && s0 + s < B) a[static_cast<size_t>(s0 + s) * n + j] = t;
      }
    }
  }
  __syncthreads();

  for (int j0 = 0; j0 < n; j0 += kColsPerPass) {
    rows_times_matrix<T, TS>(ts, Vt, n, j0, acc);
#pragma unroll
    for (int c = 0; c < kColsPerThread; ++c) {
      const int j = j0 + tid + c * kThreads;
      if (j >= n) continue;
#pragma unroll
      for (int s = 0; s < TS; ++s)
        if (s0 + s < B) x[static_cast<size_t>(s0 + s) * n + j] = acc[s][c];
    }
  }
}

template <typename T, int TS>
int launch_tile(const T* V, const T* Vt, const T* g, const T* coeffs, const T* b, T* x, T* a,
                int B, int n, cudaStream_t stream) {
  const size_t smem = 2 * static_cast<size_t>(TS) * n * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(spectral_apply_kernel<T, TS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((B + TS - 1) / TS);
  spectral_apply_kernel<T, TS><<<grid, kThreads, smem, stream>>>(V, Vt, g, coeffs, b, x, a, B, n);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* V, const void* Vt, const void* g, const void* coeffs, const void* b,
           void* x, void* a, int B, int n, int tile, void* stream) {
  if (B <= 0 || n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const T* pV = static_cast<const T*>(V);
  const T* pVt = static_cast<const T*>(Vt);
  const T* pg = static_cast<const T*>(g);
  const T* pc = static_cast<const T*>(coeffs);
  const T* pb = static_cast<const T*>(b);
  T* px = static_cast<T*>(x);
  T* pa = static_cast<T*>(a);
  switch (tile) {
    case 1: return launch_tile<T, 1>(pV, pVt, pg, pc, pb, px, pa, B, n, s);
    case 2: return launch_tile<T, 2>(pV, pVt, pg, pc, pb, px, pa, B, n, s);
    case 4: return launch_tile<T, 4>(pV, pVt, pg, pc, pb, px, pa, B, n, s);
    case 8: return launch_tile<T, 8>(pV, pVt, pg, pc, pb, px, pa, B, n, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Plain C entry points, bound with ctypes. All arrays are dense row-major on
// the current device: V, Vt (n, n); g (n,); coeffs (B, 2); b, x, a (B, n).
// a may be null. Returns the CUDA error code of the launch (0 = success).
extern "C" int vbicm_spectral_apply_f32(const void* V, const void* Vt, const void* g,
                                        const void* coeffs, const void* b, void* x, void* a,
                                        int B, int n, int tile, void* stream) {
  return launch<float>(V, Vt, g, coeffs, b, x, a, B, n, tile, stream);
}

extern "C" int vbicm_spectral_apply_f64(const void* V, const void* Vt, const void* g,
                                        const void* coeffs, const void* b, void* x, void* a,
                                        int B, int n, int tile, void* stream) {
  return launch<double>(V, Vt, g, coeffs, b, x, a, B, n, tile, stream);
}

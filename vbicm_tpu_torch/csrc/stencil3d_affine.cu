// Batched hex8-box affine stencil matvec for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel vbicm_tpu/ops/stencil3d_pallas.py,
// stencil_affine_matvec_pallas_3d (body _row_kernel). On the structured hex8
// box the assembled stiffness couples a node only to its 26 neighbours; with
// the dofs interleaved along a grid row (lane l = 3x + a) the 3x3 block
// stencil is an 11-tap stencil along the row for each of the nine rows
// (z+dz-1, y+dy-1). For every sample s, grid row (z, y) and lane l
//
//     q[s, z, y, l] = sum_p c_p[s] * sum_{dz, dy, d} W[z, y, (p*9 + dz*3 + dy)*11 + d, l]
//                                                  * u[s, z+dz-1, y+dy-1, l+d-5]
//
// with p in 0..1, dz, dy in 0..2, d in 0..10: 198 coefficient planes, stored
// (NZ*NY, 198, NX3) with NX3 = 3*NX. Rows and lanes outside the grid
// contribute zero. The conjugate-gradient loop of the box two-level solver
// runs this for every iteration, and the refinement residual and the
// adjoint's coefficient cotangents run the float64 instance.
//
// What bounds it on an H100: per sample and lane 198 multiply-adds fed by 99
// shared-memory reads of u. At 64x16x16 (NZ = NY = 17, NX3 = 195) and
// B = 256 that is 5.7 GFLOP and ~5.7 GB of shared-memory reads in float32,
// against ~160 MB of HBM traffic (u, q and the 44.6 MB of planes once):
// shared-memory bandwidth, not HBM, bounds this design.
//
// Design: one block per (tile of kTile = 4 samples, grid row (z, y)), the
// sample tile the fastest block index, so the blocks of one row run together
// and all but the first read the row's planes (154 KB f32) from L2, not HBM.
// Tiles of 8 samples were slower on the H100 in both precisions: twice the
// staged rows, so fewer blocks fit on an SM to hide the loads' latency. A
// batch that is not a multiple of kTile leaves the last tile's extra samples
// zero and unstored.
//   1. the tile's nine u rows (dz, dy), with five zero halo lanes on each
//      side, zero rows outside the grid and zero samples beyond B, are
//      staged in shared memory (kTile * 9 * (NX3 + 10) values);
//   2. each thread owns lanes l = tid, tid + blockDim, ...; the 198
//      coefficients of a lane do not fit in registers (the 2-D kernel keeps
//      its 42), so each (part-0, part-1) pair is read once, per tap, and
//      applied to the tile's kTile samples, whose 2*kTile sums stay in registers;
//   3. c0, c1 are applied in registers at the store.
// Neighbouring threads read neighbouring lanes of u, W and q, so global
// loads and stores coalesce and shared-memory reads are free of conflicts.
//
// Not yet done (later work): register windows along x so that a u value
// read from shared memory feeds several lanes, several rows per block (a
// u row is staged by nine blocks), TMA, DMMA.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kRows = 9;                   // (dz, dy) neighbour rows
constexpr int kTaps = 11;                  // lane offsets -5..5
constexpr int kPartPlanes = kRows * kTaps;  // 99
constexpr int kPlanes = 2 * kPartPlanes;   // 198
constexpr int kHalo = 5;
constexpr int kMaxThreads = 256;
constexpr int kTile = 4;  // samples a block

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
    stencil3d_affine_kernel(const T* __restrict__ w, const T* __restrict__ coeffs,
                            const T* __restrict__ u, T* __restrict__ q, int B, int NZ, int NY,
                            int NX3) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int L = NX3 + 2 * kHalo;  // staged row length
  T* us = reinterpret_cast<T*>(smem_raw);  // (kTile, 9, L)

  const int s0 = blockIdx.x * kTile;
  const int row = blockIdx.y;  // z * NY + y
  const int z = row / NY;
  const int y = row - z * NY;
  const int ns = min(kTile, B - s0);
  const size_t ndof = static_cast<size_t>(NZ) * NY * NX3;

  for (int k = threadIdx.x; k < kTile * kRows * L; k += blockDim.x) {
    const int j = k % L;
    const int sv = k / L;  // s * 9 + v
    const int s = sv / kRows;
    const int v = sv - s * kRows;  // dz * 3 + dy
    const int zz = z + v / 3 - 1;
    const int yy = y + v % 3 - 1;
    const int i = j - kHalo;
    T val = T(0);
    if (s < ns && zz >= 0 && zz < NZ && yy >= 0 && yy < NY && i >= 0 && i < NX3)
      val = u[(s0 + s) * ndof + (static_cast<size_t>(zz) * NY + yy) * NX3 + i];
    us[k] = val;
  }
  __syncthreads();

  const T* wr = w + static_cast<size_t>(row) * kPlanes * NX3;
  const size_t stride_s = static_cast<size_t>(kRows) * L;
  for (int i = threadIdx.x; i < NX3; i += blockDim.x) {
    T a0[kTile], a1[kTile];
#pragma unroll
    for (int s = 0; s < kTile; ++s) {
      a0[s] = T(0);
      a1[s] = T(0);
    }
    for (int v = 0; v < kRows; ++v) {
      const T* uv = us + v * L + i;  // lane i - 5 of row v
      const T* w0 = wr + static_cast<size_t>(v * kTaps) * NX3 + i;
      const T* w1 = w0 + static_cast<size_t>(kPartPlanes) * NX3;
#pragma unroll
      for (int d = 0; d < kTaps; ++d) {
        const T c0 = __ldg(w0 + static_cast<size_t>(d) * NX3);
        const T c1 = __ldg(w1 + static_cast<size_t>(d) * NX3);
#pragma unroll
        for (int s = 0; s < kTile; ++s) {
          const T x = uv[s * stride_s + d];
          a0[s] += c0 * x;
          a1[s] += c1 * x;
        }
      }
    }
#pragma unroll
    for (int s = 0; s < kTile; ++s) {
      if (s < ns) {
        const T* c = coeffs + 2 * static_cast<size_t>(s0 + s);
        q[(s0 + s) * ndof + static_cast<size_t>(row) * NX3 + i] =
            __ldg(c) * a0[s] + __ldg(c + 1) * a1[s];
      }
    }
  }
}

template <typename T>
int launch(const void* w, const void* coeffs, const void* u, void* q, int B, int NZ, int NY,
           int NX3, void* stream) {
  if (B <= 0 || NZ <= 0 || NY <= 0 || NX3 <= 0 || NX3 % 3 != 0 || NZ * NY > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(kTile) * kRows * (NX3 + 2 * kHalo) * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(stencil3d_affine_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  // one thread a lane, in whole warps, at most kMaxThreads (then lanes loop)
  const int threads = min(kMaxThreads, (NX3 + 31) / 32 * 32);
  const dim3 grid((B + kTile - 1) / kTile, NZ * NY);
  stencil3d_affine_kernel<T><<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(w), static_cast<const T*>(coeffs), static_cast<const T*>(u),
      static_cast<T*>(q), B, NZ, NY, NX3);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points, bound with ctypes. All arrays are dense row-major on
// the current device: w (NZ * NY, 198, NX3); coeffs (B, 2); u, q
// (B, NZ * NY * NX3). Returns the CUDA error code of the launch (0 =
// success).
extern "C" int vbicm_stencil3d_affine_f32(const void* w, const void* coeffs, const void* u,
                                          void* q, int B, int NZ, int NY, int NX3,
                                          void* stream) {
  return launch<float>(w, coeffs, u, q, B, NZ, NY, NX3, stream);
}

extern "C" int vbicm_stencil3d_affine_f64(const void* w, const void* coeffs, const void* u,
                                          void* q, int B, int NZ, int NY, int NX3,
                                          void* stream) {
  return launch<double>(w, coeffs, u, q, B, NZ, NY, NX3, stream);
}

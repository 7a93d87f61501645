// Batched affine element matvec for Hopper (sm_90a): gather, element-block
// multiply-adds and scatter fused in one kernel.
//
// Replaces the Pallas TPU kernel vbicm_tpu/ops/element_matvec_pallas.py,
// element_matvec_fused (body _matvec_kernel), together with the gather
// u[:, lm] and the sorted segment-sum scatter that ran outside it there. For
// every sample s and dof d of an unstructured mesh
//
//     q[s, d] = sum_{(e, i) in inc(d)} sum_j (c0[s] ke0[e, i, j] + c1[s] ke1[e, i, j])
//                                            * u[s, lm[e, j]]
//
// where inc(d) is the list of element entries (e, i) with lm[e, i] = d. The
// element blocks are (2, nele, EDOF, EDOF) contiguous rows; inc(d) is read
// from the host-built incidence tables row_ptr (ndof + 1) and ent (nele *
// EDOF, entry e * EDOF + i, sorted by dof, ops/assembly.py::dof_incidence).
// The matrix-free CG of the element-path solvers (Jacobi-PCG and the
// two-level solver) runs this in every iteration in float32, and the
// refinement residual and the adjoint's coefficient cotangents run the
// float64 instance.
//
// Pull form, not atomics: each q[s, d] is owned by one thread and summed in
// the fixed sorted-incidence order, so two launches on the same inputs give
// the same bits. That keeps the CG's per-lane iteration counts repeatable,
// which a scatter with atomicAdd (whose order changes from run to run) would
// not. The (B, nele, EDOF) element products of the TPU form never reach
// device memory.
//
// What bounds it on an H100: at (B = 256, Cook's 160x80, 26,082 dofs) in
// float32 the function moves u (26.7 MB) and q (26.7 MB) once and the
// element blocks (6.6 MB) once, ~60 MB, 18 us at 3.35 TB/s; it does 0.84
// GFLOP, 13 us at 67 TFLOP/s. So HBM bounds it (float64: ~36 us).
//
// Design: one block per (tile of kThreads dofs, tile of kTile samples), the
// dof tile the fastest block index.
//   1. each thread owns one dof d and walks its incidence list; for each
//      entry it reads the two element-block rows ke0[e, i, :] and
//      ke1[e, i, :] once (2 EDOF values) and the element's EDOF dof ids, and
//      applies them to the tile's samples, whose 2 kTile sums stay in
//      registers;
//   2. u is gathered through L1/L2 (26.7 MB at the size above fits the 50 MB
//      L2); neighbouring dofs share elements, so a warp's gathers touch few
//      cache lines;
//   3. c0, c1 are applied in registers at the store, which coalesces along d.
// Not yet done (later work): staging a dof tile's elements and u values in
// shared memory, element colouring, a sample-major u layout.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 128;  // dofs a block
constexpr int kTile = 8;       // samples a block

template <typename T, int EDOF>
__global__ void __launch_bounds__(kThreads)
    element_affine_kernel(const T* __restrict__ ke, const int* __restrict__ lm,
                          const int* __restrict__ row_ptr, const int* __restrict__ ent,
                          const T* __restrict__ coeffs, const T* __restrict__ u,
                          T* __restrict__ q, int B, int ndof, int nele) {
  const int d = blockIdx.x * kThreads + threadIdx.x;
  if (d >= ndof) return;
  const int s0 = blockIdx.y * kTile;
  const int ns = min(kTile, B - s0);
  const size_t part = static_cast<size_t>(nele) * EDOF * EDOF;
  const T* us = u + static_cast<size_t>(s0) * ndof;

  T a0[kTile], a1[kTile];
#pragma unroll
  for (int s = 0; s < kTile; ++s) {
    a0[s] = T(0);
    a1[s] = T(0);
  }
  const int k_end = __ldg(row_ptr + d + 1);
  for (int k = __ldg(row_ptr + d); k < k_end; ++k) {
    const int ei = __ldg(ent + k);  // e * EDOF + i
    const T* k0 = ke + static_cast<size_t>(ei) * EDOF;
    const T* k1 = k0 + part;
    const int* lme = lm + static_cast<size_t>(ei / EDOF) * EDOF;
#pragma unroll
    for (int j = 0; j < EDOF; ++j) {
      const size_t col = static_cast<size_t>(__ldg(lme + j));
      const T w0 = __ldg(k0 + j);
      const T w1 = __ldg(k1 + j);
#pragma unroll
      for (int s = 0; s < kTile; ++s) {
        if (s < ns) {  // uniform across the block
          const T x = __ldg(us + static_cast<size_t>(s) * ndof + col);
          a0[s] += w0 * x;
          a1[s] += w1 * x;
        }
      }
    }
  }
#pragma unroll
  for (int s = 0; s < kTile; ++s) {
    if (s < ns) {
      const T* c = coeffs + 2 * static_cast<size_t>(s0 + s);
      q[static_cast<size_t>(s0 + s) * ndof + d] = __ldg(c) * a0[s] + __ldg(c + 1) * a1[s];
    }
  }
}

template <typename T, int EDOF>
int launch_edof(const void* ke, const void* lm, const void* row_ptr, const void* ent,
                const void* coeffs, const void* u, void* q, int B, int ndof, int nele,
                void* stream) {
  const dim3 grid((ndof + kThreads - 1) / kThreads, (B + kTile - 1) / kTile);
  element_affine_kernel<T, EDOF><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(ke), static_cast<const int*>(lm), static_cast<const int*>(row_ptr),
      static_cast<const int*>(ent), static_cast<const T*>(coeffs), static_cast<const T*>(u),
      static_cast<T*>(q), B, ndof, nele);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* ke, const void* lm, const void* row_ptr, const void* ent,
           const void* coeffs, const void* u, void* q, int B, int ndof, int nele, int edof,
           void* stream) {
  if (B <= 0 || ndof <= 0 || nele <= 0 || (B + kTile - 1) / kTile > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (edof) {
    case 8:  // quad4, 2 dofs a node
      return launch_edof<T, 8>(ke, lm, row_ptr, ent, coeffs, u, q, B, ndof, nele, stream);
    case 24:  // hex8, 3 dofs a node
      return launch_edof<T, 24>(ke, lm, row_ptr, ent, coeffs, u, q, B, ndof, nele, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Plain C entry points, bound with ctypes. All arrays are dense row-major on
// the current device: ke (2, nele, edof, edof); lm (nele, edof) int32;
// row_ptr (ndof + 1) int32; ent (nele * edof) int32; coeffs (B, 2); u, q
// (B, ndof). edof is 8 or 24. Returns the CUDA error code of the launch
// (0 = success).
extern "C" int vbicm_element_affine_f32(const void* ke, const void* lm, const void* row_ptr,
                                        const void* ent, const void* coeffs, const void* u,
                                        void* q, int B, int ndof, int nele, int edof,
                                        void* stream) {
  return launch<float>(ke, lm, row_ptr, ent, coeffs, u, q, B, ndof, nele, edof, stream);
}

extern "C" int vbicm_element_affine_f64(const void* ke, const void* lm, const void* row_ptr,
                                        const void* ent, const void* coeffs, const void* u,
                                        void* q, int B, int ndof, int nele, int edof,
                                        void* stream) {
  return launch<double>(ke, lm, row_ptr, ent, coeffs, u, q, B, ndof, nele, edof, stream);
}

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
// GFLOP, 13 us at 67 TFLOP/s. So HBM bounds the function (float64: ~36 us).
// A pull kernel is held back by its gathers instead: each (dof, sample)
// takes 32 scattered reads of u (u itself fits the 50 MB L2), and the first
// form of this kernel (the hex8 body below) also read a dof's element rows
// again for every 8 samples, ~16 cache lines a warp request. It took 0.173
// ms there (PERF.md).
//
// Design of the quad4 body (EDOF 8), float32 and float64: one block per
// (tile of kThreads dofs, run of samples), the dof tile the fastest block
// index, so a warp's u reads stay on 1-2 lines on a structured numbering.
//   1. Every dof of a quad4 mesh whose nodes are in at most 4 elements has
//      at most kMaxE = 4 incidence entries (Cook's meshes, structured or
//      renumbered). At entry a thread loads the rows of its first kMaxE
//      entries into registers: ke0[e, i, :], ke1[e, i, :] and lm[e, :],
//      each row as 16-byte loads (so ke and lm must be 16-byte aligned), 96
//      values a thread, kept for the block's whole run of samples. An entry
//      the dof does not have gets zero weights on its own node's columns:
//      for finite u that adds +0 to a sum that is never -0, so no bit
//      changes, and every thread runs the same unrolled loads.
//   2. Where an element node's two dofs are adjacent and aligned in u (a
//      dof map numbered node by node, as the port's models are), the pair is
//      read as one 8-byte (float64: 16-byte) load, half the requests;
//      a thread with any other pair reads u one value at a time.
//   3. The samples of the run are walked kStep = 4 at a time, each with its
//      own pair of sums (part 0 and part 1): 64 independent loads a step
//      keep the gathers' latency covered with two blocks an SM (255
//      registers a thread); one and two samples a step were 20-60 % slower.
//      Each sum is one chain of FMAs over the entries and then the columns,
//      in the order of the hex8 body below, and c0 a0 + c1 a1 is written as
//      that body writes it: the bits are that body's, whatever the run.
//   4. A dof with more than kMaxE entries (a node in 5 or more elements of
//      an unstructured mesh) takes its entries kMaxE.. inside the sample
//      loop, after its register entries and in the same order, reading
//      their rows from global memory: one kernel and one order, exact on
//      every mesh.
//   5. The launcher picks the number of runs G a dof tile on the card: the
//      runs whose blocks fill one wave (blocks an SM holds, from the
//      occupancy of the built kernel, times the SMs), or B / kRun if that is
//      more (at 160x80 one wave is a single run of all B samples, and runs
//      of 32 over several waves balance the SMs better in float64), in runs
//      of at least kStep samples; cached per device. The runs are balanced
//      (their lengths differ by at most one).
// hex8 (EDOF 24) keeps the first form: one block per (dof tile, tile of
// kTile samples), the rows read per tile. Its rows (up to 8 entries x 48
// coefficients a dof) do not fit in registers, and no timed path runs it:
// the 3-D paths run the stencil kernel.
//
// Not yet done (later work): one thread a node (both dofs of a node share
// each u read, and half the address arithmetic goes), a sample-major u
// layout.

#include <cuda_runtime.h>

#include <algorithm>
#include <atomic>
#include <cstddef>

namespace {

constexpr int kThreads = 128;  // dofs a block
constexpr int kTile = 8;       // samples a block of the hex8 body
constexpr int kQuad = 8;       // EDOF of quad4
constexpr int kMaxE = 4;       // incidence entries a quad4 thread holds in registers
constexpr int kStep = 4;       // samples a quad4 thread takes at a time
constexpr int kQuad4Blocks = 2;  // quad4 blocks an SM holds: 255 registers a thread
constexpr int kRun = 32;       // samples of a run at large B (several waves balance the SMs)
constexpr int kMaxDevices = 64;

// the 8 values of a 32-byte (int, float) or 64-byte (double) row as 16-byte loads
__device__ __forceinline__ void load_row(const float* p, float (&r)[kQuad]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  r[0] = a.x, r[1] = a.y, r[2] = a.z, r[3] = a.w;
  r[4] = b.x, r[5] = b.y, r[6] = b.z, r[7] = b.w;
}

__device__ __forceinline__ void load_row(const int* p, int (&r)[kQuad]) {
  const int4 a = __ldg(reinterpret_cast<const int4*>(p));
  const int4 b = __ldg(reinterpret_cast<const int4*>(p) + 1);
  r[0] = a.x, r[1] = a.y, r[2] = a.z, r[3] = a.w;
  r[4] = b.x, r[5] = b.y, r[6] = b.z, r[7] = b.w;
}

__device__ __forceinline__ void load_row(const double* p, double (&r)[kQuad]) {
#pragma unroll
  for (int h = 0; h < kQuad / 2; ++h) {
    const double2 a = __ldg(reinterpret_cast<const double2*>(p) + h);
    r[2 * h] = a.x, r[2 * h + 1] = a.y;
  }
}

template <typename T>
struct Pair;  // a node's two values of u, one aligned vector
template <>
struct Pair<float> {
  using type = float2;
};
template <>
struct Pair<double> {
  using type = double2;
};

// The register entries' part of kStep samples' sums, entry by entry and
// column by column; kPaired reads columns 2a and 2a + 1 (an element node's
// two dofs, adjacent in u) as one vector.
template <typename T, bool kPaired>
__device__ __forceinline__ void pull_registers(const T* const (&us)[kStep],
                                               const T (&w0)[kMaxE][kQuad],
                                               const T (&w1)[kMaxE][kQuad],
                                               const int (&col)[kMaxE][kQuad], T (&a0)[kStep],
                                               T (&a1)[kStep]) {
#pragma unroll
  for (int k = 0; k < kMaxE; ++k) {
#pragma unroll
    for (int a = 0; a < kQuad / 2; ++a) {
      T x[kStep][2];
#pragma unroll
      for (int t = 0; t < kStep; ++t) {
        if (kPaired) {
          const auto v = __ldg(reinterpret_cast<const typename Pair<T>::type*>(
              us[t] + col[k][2 * a]));
          x[t][0] = v.x;
          x[t][1] = v.y;
        } else {
          x[t][0] = __ldg(us[t] + col[k][2 * a]);
          x[t][1] = __ldg(us[t] + col[k][2 * a + 1]);
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int t = 0; t < kStep; ++t) {
          a0[t] = fma(w0[k][2 * a + h], x[t][h], a0[t]);
          a1[t] = fma(w1[k][2 * a + h], x[t][h], a1[t]);
        }
      }
    }
  }
}

// pairs: ndof is even and u aligned to two values, so that a dof pair
// (2m, 2m + 1) of u is one aligned vector in every row
template <typename T>
__global__ void __launch_bounds__(kThreads, kQuad4Blocks)
    element_affine_quad4_kernel(const T* __restrict__ ke, const int* __restrict__ lm,
                                const int* __restrict__ row_ptr, const int* __restrict__ ent,
                                const T* __restrict__ coeffs, const T* __restrict__ u,
                                T* __restrict__ q, int B, int ndof, int nele, bool pairs) {
  const int d = blockIdx.x * kThreads + threadIdx.x;
  if (d >= ndof) return;
  const int G = gridDim.y;
  const int s_begin = static_cast<int>(static_cast<long long>(blockIdx.y) * B / G);
  const int s_end = static_cast<int>(static_cast<long long>(blockIdx.y + 1) * B / G);
  const size_t part = static_cast<size_t>(nele) * kQuad * kQuad;
  const int k_begin = __ldg(row_ptr + d);
  const int k_end = __ldg(row_ptr + d + 1);

  // 1. the register entries' rows, once for the run; an entry the dof does
  //    not have gets zero weights on columns of its own node (for finite u
  //    it adds +0 to a sum that is never -0: no bit changes)
  T w0[kMaxE][kQuad], w1[kMaxE][kQuad];
  int col[kMaxE][kQuad];
  bool paired = pairs;
#pragma unroll
  for (int k = 0; k < kMaxE; ++k) {
    if (k < k_end - k_begin) {
      const int ei = __ldg(ent + k_begin + k);  // e * 8 + i
      load_row(ke + static_cast<size_t>(ei) * kQuad, w0[k]);
      load_row(ke + part + static_cast<size_t>(ei) * kQuad, w1[k]);
      load_row(lm + static_cast<size_t>(ei / kQuad) * kQuad, col[k]);
    } else {
#pragma unroll
      for (int j = 0; j < kQuad; ++j) {
        w0[k][j] = w1[k][j] = T(0);
        col[k][j] = pairs ? (d & ~1) + (j & 1) : d;
      }
    }
#pragma unroll
    for (int a = 0; a < kQuad / 2; ++a)
      paired &= (col[k][2 * a] & 1) == 0 && col[k][2 * a + 1] == col[k][2 * a] + 1;
  }

  // 2. the run's samples, kStep at a time (past the run's end a slot
  //    repeats its last sample and is not stored)
  for (int s = s_begin; s < s_end; s += kStep) {
    const T* us[kStep];
    T a0[kStep], a1[kStep];
#pragma unroll
    for (int t = 0; t < kStep; ++t) {
      us[t] = u + static_cast<size_t>(min(s + t, s_end - 1)) * ndof;
      a0[t] = a1[t] = T(0);
    }
    if (paired)
      pull_registers<T, true>(us, w0, w1, col, a0, a1);
    else
      pull_registers<T, false>(us, w0, w1, col, a0, a1);
    // 3. entries beyond the registers, rows from global memory
    for (int k = k_begin + kMaxE; k < k_end; ++k) {
      const int ei = __ldg(ent + k);
      const T* k0 = ke + static_cast<size_t>(ei) * kQuad;
      const T* k1 = k0 + part;
      const int* lme = lm + static_cast<size_t>(ei / kQuad) * kQuad;
#pragma unroll
      for (int j = 0; j < kQuad; ++j) {
        const int c = __ldg(lme + j);
        const T v0 = __ldg(k0 + j);
        const T v1 = __ldg(k1 + j);
#pragma unroll
        for (int t = 0; t < kStep; ++t) {
          const T x = __ldg(us[t] + c);
          a0[t] = fma(v0, x, a0[t]);
          a1[t] = fma(v1, x, a1[t]);
        }
      }
    }
#pragma unroll
    for (int t = 0; t < kStep; ++t) {
      if (s + t < s_end) {
        const T* c = coeffs + 2 * static_cast<size_t>(s + t);
        q[static_cast<size_t>(s + t) * ndof + d] = __ldg(c) * a0[t] + __ldg(c + 1) * a1[t];
      }
    }
  }
}

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

// Blocks of the quad4 body an SM of the current device holds, and the
// device's SMs; cached per device (a race only writes the same values twice).
template <typename T>
cudaError_t quad4_slots(int* blocks_per_sm, int* sms) {
  static std::atomic<int> cache[kMaxDevices][2];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && cache[dev][0].load() > 0) {
    *blocks_per_sm = cache[dev][0].load();
    *sms = cache[dev][1].load();
    return cudaSuccess;
  }
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, element_affine_quad4_kernel<T>,
                                                      kThreads, 0);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices) {
    cache[dev][1].store(*sms);
    cache[dev][0].store(*blocks_per_sm);
  }
  return cudaSuccess;
}

// The quad4 body's runs a dof tile: the runs that fill one wave of blocks
// (per_sm blocks on each of sms SMs), or B / kRun if more, in runs of at
// least kStep samples.
int quad4_groups(int B, int ndof, int per_sm, int sms) {
  const long long tiles = (ndof + kThreads - 1) / kThreads;
  const long long wave = static_cast<long long>(per_sm) * sms / tiles;
  const long long groups = std::min(std::max(wave, static_cast<long long>(B / kRun)),
                                    static_cast<long long>(B / kStep));
  return static_cast<int>(std::max(1LL, groups));
}

// out[3] = (sample groups, blocks an SM holds, register entries a thread) of
// a launch at (B, ndof, edof) on the current device: for quad4 the runs of
// the design above, for hex8 the tiles of kTile samples (no register
// entries).
template <typename T>
int plan(int B, int ndof, int edof, int* out) {
  if (B <= 0 || ndof <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaErrorInvalidValue;
  if (edof == kQuad) {
    int sms = 0;
    err = quad4_slots<T>(&out[1], &sms);
    out[0] = quad4_groups(B, ndof, out[1], sms);
    out[2] = kMaxE;
  } else if (edof == 24) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[1], element_affine_kernel<T, 24>,
                                                        kThreads, 0);
    out[0] = (B + kTile - 1) / kTile;
    out[2] = 0;
  }
  return static_cast<int>(err);
}

template <typename T>
int launch(const void* ke, const void* lm, const void* row_ptr, const void* ent,
           const void* coeffs, const void* u, void* q, int B, int ndof, int nele, int edof,
           void* stream) {
  if (B <= 0 || ndof <= 0 || nele <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned tiles = (ndof + kThreads - 1) / kThreads;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const T* ke_ = static_cast<const T*>(ke);
  const int* lm_ = static_cast<const int*>(lm);
  const int* row_ptr_ = static_cast<const int*>(row_ptr);
  const int* ent_ = static_cast<const int*>(ent);
  const T* coeffs_ = static_cast<const T*>(coeffs);
  const T* u_ = static_cast<const T*>(u);
  if (edof == kQuad) {
    // the rows are read as 16-byte vectors
    if (reinterpret_cast<size_t>(ke) % 16 || reinterpret_cast<size_t>(lm) % 16)
      return static_cast<int>(cudaErrorInvalidValue);
    int per_sm = 0, sms = 0;
    const cudaError_t err = quad4_slots<T>(&per_sm, &sms);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid(tiles, quad4_groups(B, ndof, per_sm, sms));
    const bool pairs = ndof % 2 == 0 && reinterpret_cast<size_t>(u) % (2 * sizeof(T)) == 0;
    element_affine_quad4_kernel<T><<<grid, kThreads, 0, st>>>(
        ke_, lm_, row_ptr_, ent_, coeffs_, u_, static_cast<T*>(q), B, ndof, nele, pairs);
  } else if (edof == 24 && (B + kTile - 1) / kTile <= 65535) {  // hex8, 3 dofs a node
    const dim3 grid(tiles, (B + kTile - 1) / kTile);
    element_affine_kernel<T, 24><<<grid, kThreads, 0, st>>>(
        ke_, lm_, row_ptr_, ent_, coeffs_, u_, static_cast<T*>(q), B, ndof, nele);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points, bound with ctypes. All arrays are dense row-major on
// the current device: ke (2, nele, edof, edof); lm (nele, edof) int32;
// row_ptr (ndof + 1) int32; ent (nele * edof) int32; coeffs (B, 2); u, q
// (B, ndof). edof is 8 (ke and lm 16-byte aligned) or 24. Returns the CUDA
// error code of the launch (0 = success).
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

// The launch the entry points above make at (B, ndof, edof) on the current
// device: out[3] = (sample groups, blocks an SM holds, register entries a
// thread). Returns a CUDA error code (cudaErrorInvalidValue where the kernel
// takes no such launch).
extern "C" int vbicm_element_affine_plan_f32(int B, int ndof, int edof, int* out) {
  return plan<float>(B, ndof, edof, out);
}

extern "C" int vbicm_element_affine_plan_f64(int B, int ndof, int edof, int* out) {
  return plan<double>(B, ndof, edof, out);
}

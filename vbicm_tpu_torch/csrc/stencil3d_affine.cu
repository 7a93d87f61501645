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
// What bounds it on an H100: operations on the CUDA cores. A lane has 81
// nonzero coefficients a part (nine rows x the 3 nodes x 3 dofs its node
// touches), so at 64x16x16 (NZ = NY = 17, NX3 = 195) and B = 256 the
// function is 2.3 G multiply-adds (0.064 ms at 67 TFLOP/s) against 160 MB
// of HBM traffic (0.048 ms). The kernel this design replaced (a block a row
// and 4 samples, the 198 planes read with __ldg) fed each pair of FMAs with one
// shared-memory read and re-read a row's 154 KB of planes from L2 for every
// 4 samples: ~2.9 GB of L2 traffic and ~5.7 GB of shared reads a call. This
// design takes 0.30 ms there in float32 (a fifth of the bound; the replaced
// kernel 0.78 ms) and 0.064 ms at 32x8x8 (0.12 ms) on the H100
// (tools/stencil_tiles.py). What holds it back is measured in PERF.md: the
// staging and the arithmetic each take about half of the time and barely
// overlap, and the arithmetic runs at 38 % of the FMA rate, its loop
// half FMAs and the rest shared-memory reads and addressing.
//
// Design: one block per (grid row (z, y), tile of G*S samples).
//   1. A thread owns one node x (its 3 lanes) of the row and S = kSamples
//      samples, whose 6 S sums (3 lanes x 2 parts) stay in registers for the
//      whole call; the block's G thread groups take G*S samples. Eight
//      samples a thread are the fastest on the H100 (tools/stencil_tiles.py
//      builds and times 4 and 16; two rows a block, each staged row serving
//      both, were slower too: 0.3440 against 0.3360 ms at 64x16x16).
//   2. The nine neighbour rows (z+dz-1, y+dy-1) are staged one row at a time
//      for all the block's samples (one zero halo node each side) through a
//      ring of kStages rows filled with cp.async: the next rows' copies are
//      in flight while one is computed, and shared memory holds kStages rows
//      whatever S is. Rows outside the grid are skipped.
//   3. Beside each staged row the coefficients it meets are staged too, in
//      the node-major layout of ops/stencil3d_kernel.py::pack_w_nodes_3d:
//      per (output row, neighbour row, node) the 54 the node uses, grouped
//      by neighbour node (2 parts x 3 lanes x 3 dofs, padded to 20) at a
//      pitch of 60 (62 for float64) values, so the copy is 16-byte cp.async
//      and a thread reads a group as 16-byte loads at fixed offsets, free of
//      bank conflicts. (With a plane of nodes per coefficient, every load
//      needed its own address: a third of the loop was integer work.)
//   4. For each of the three neighbour nodes x+dx-1 a thread reads its 18
//      coefficients (3 lanes x 3 dofs x 2 parts) once and applies them to
//      its S samples, reading each sample's 3 neighbour values: 6 FMAs per
//      u value read, and the coefficients read from L2 once per G*S
//      samples.
// Every sum runs in one fixed order (staged rows by (dz, dy), then dx, then
// the dof b), with explicit FMAs, and the store is c0 a0 + c1 a1 as one FMA
// on a rounded product, so the result is bitwise equal for every S and G.
// That is the replaced kernel's order too (its taps d = 3 dx + b - a + 2
// ascending, the other two of a row's 11 zero), and on the H100 the two
// gave the same bits at every shape of tools/stencil_tiles.py --parity; it
// is not guaranteed, as the replaced kernel left its contractions and its
// store's order to the compiler.
//
// The launch geometry (threads, shared memory) is worked out here only
// (geometry); ops/stencil3d_kernel.py plans a launch from what
// vbicm_stencil3d_affine_fit_* reports for this build on this card.
//
// Not yet done (later work): TMA for u (no global stride of u is a multiple
// of 16 bytes), DMMA.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kGroup = 20;  // a neighbour node's 18 coefficients (2 parts x 3 x 3), padded
constexpr int kHalo = 3;    // one zero node each side of a staged row
constexpr int kStages = 3;  // staged rows in flight
constexpr int kSamples = 8;  // samples a thread

// Values a node's coefficients a neighbour row take: three groups of
// kGroup, padded so that the 16-byte reads of 8 neighbouring threads fall
// in distinct banks (a pitch of 28 words modulo 32).
template <typename T>
struct Pitch {
  static constexpr int value = sizeof(T) == 4 ? 60 : 62;
};

template <typename T>
struct Vec16;  // 16 bytes of T
template <>
struct Vec16<float> {
  using type = float4;
};
template <>
struct Vec16<double> {
  using type = double2;
};

__device__ __forceinline__ void unpack(const float4& v, float* c) {
  c[0] = v.x;
  c[1] = v.y;
  c[2] = v.z;
  c[3] = v.w;
}
__device__ __forceinline__ void unpack(const double2& v, double* c) {
  c[0] = v.x;
  c[1] = v.y;
}

// Threads a block may have: the register cap this gives (65536 / threads)
// holds each instance's sums unspilled.
template <typename T>
struct MaxThreads {
  static constexpr int value = sizeof(T) == 4 && kSamples <= 8 ? 512 : 256;
};

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float fma_rn(float a, float b, float c) { return __fmaf_rn(a, b, c); }
__device__ __forceinline__ double fma_rn(double a, double b, double c) { return __fma_rn(a, b, c); }

// One value global -> shared, asynchronously.
template <typename T>
__device__ __forceinline__ void cp_async_value(T* dst, const T* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d), "l"(src),
               "n"(sizeof(T)));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// 16 bytes global -> shared, asynchronously.
__device__ __forceinline__ void cp_async_16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}

template <typename T>
__global__ void __launch_bounds__(MaxThreads<T>::value)
    stencil3d_affine_kernel(const T* __restrict__ w, const T* __restrict__ coeffs,
                            const T* __restrict__ u, T* __restrict__ q, int B, int NZ, int NY,
                            int NXn, int G) {
  constexpr int S = kSamples;
  constexpr int kVec = 16 / sizeof(T);  // values a 16-byte copy
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int kPitch = Pitch<T>::value;
  // kStages of: (NXn, kPitch) coefficients, then (G*S, Ls) u
  T* buf = reinterpret_cast<T*>(smem_raw);
  const int NX3 = 3 * NXn;
  const int cplane = NXn * kPitch;  // coefficients of one (output row, neighbour row)
  const int Ls = NX3 + 2 * kHalo;  // staged row length
  const int SB = G * S;            // samples a block
  const int stage = (cplane + SB * Ls + kVec - 1) / kVec * kVec;
  const size_t ndof = static_cast<size_t>(NZ) * NY * NX3;

  const int z = blockIdx.y / NY;
  const int y = blockIdx.y - z * NY;
  const int s0 = blockIdx.x * SB;
  const int ns = min(SB, B - s0);
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int g = tid / NXn;  // this thread's sample group
  const int x = tid - g * NXn;  // and its node
  const bool active = g < G;

  for (int k = tid; k < kStages * stage; k += nthreads) buf[k] = T(0);

  // the staged rows in the grid: dz in [dz_lo, dz_hi) x dy in [dy_lo, dy_hi),
  // grid row (z + dz - 1, y + dy - 1)
  const int dz_lo = z == 0 ? 1 : 0;
  const int dz_hi = min(3, NZ - z + 1);
  const int dy_lo = y == 0 ? 1 : 0;
  const int dy_hi = min(3, NY - y + 1);
  const int ny = dy_hi - dy_lo;
  const int nst = (dz_hi - dz_lo) * ny;

  // a warp copies a sample's u row at a time, a value a lane
  const int warp = tid >> 5, lane = tid & 31, nwarps = nthreads >> 5;
  auto issue = [&](int k) {
    const int dz = dz_lo + k / ny;
    const int dy = dy_lo + k - (k / ny) * ny;
    T* st = buf + (k % kStages) * stage;
    const T* wsrc = w + (static_cast<size_t>(z * NY + y) * 9 + dz * 3 + dy) * cplane;
    for (int c = tid; c < cplane / kVec; c += nthreads)
      cp_async_16(st + c * kVec, wsrc + c * kVec);
    const T* src = u + static_cast<size_t>(s0 + warp) * ndof +
                   (static_cast<size_t>(z + dz - 1) * NY + (y + dy - 1)) * NX3;
    T* dst = st + cplane + warp * Ls + kHalo;
    for (int s = warp; s < ns; s += nwarps) {
      for (int i = lane; i < NX3; i += 32) cp_async_value(dst + i, src + i);
      src += nwarps * ndof;
      dst += nwarps * Ls;
    }
  };

  T acc0[3][S], acc1[3][S];
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int s = 0; s < S; ++s) acc0[a][s] = acc1[a][s] = T(0);

  __syncthreads();  // the zeros are written before any copy lands
#pragma unroll
  for (int k = 0; k < kStages - 1; ++k) {
    if (k < nst) issue(k);
    cp_async_commit();
  }
  for (int k = 0; k < nst; ++k) {
    cp_async_wait<kStages - 2>();  // this thread's copies of staged row k have landed
    __syncthreads();                // everyone's have; everyone is done with row k - 1
    if (k + kStages - 1 < nst) issue(k + kStages - 1);
    cp_async_commit();  // an empty group past the last row keeps the count
    if (!active) continue;
    const T* st = buf + (k % kStages) * stage;
    // this node's coefficients: group dx holds (p*3 + a)*3 + b
    const auto* cw = reinterpret_cast<const typename Vec16<T>::type*>(st + x * kPitch);
    const T* us = st + cplane + g * S * Ls + 3 * x;  // node x - 1 of sample g*S
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) {
      constexpr int kPer = 16 / sizeof(T);
      T c[kGroup];
#pragma unroll
      for (int j = 0; j < kGroup / kPer; ++j) unpack(cw[dx * kGroup / kPer + j], c + j * kPer);
      T c0[3][3], c1[3][3];  // (lane a, dof b of node x + dx - 1)
#pragma unroll
      for (int a = 0; a < 3; ++a)
#pragma unroll
        for (int b = 0; b < 3; ++b) {
          c0[a][b] = c[a * 3 + b];
          c1[a][b] = c[9 + a * 3 + b];
        }
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const T* v = us + s * Ls + 3 * dx;
        const T v0 = v[0], v1 = v[1], v2 = v[2];
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          acc0[a][s] = fma_rn(c0[a][0], v0, acc0[a][s]);
          acc1[a][s] = fma_rn(c1[a][0], v0, acc1[a][s]);
          acc0[a][s] = fma_rn(c0[a][1], v1, acc0[a][s]);
          acc1[a][s] = fma_rn(c1[a][1], v1, acc1[a][s]);
          acc0[a][s] = fma_rn(c0[a][2], v2, acc0[a][s]);
          acc1[a][s] = fma_rn(c1[a][2], v2, acc1[a][s]);
        }
      }
    }
  }
  if (!active) return;
  T* qrow = q + static_cast<size_t>(z * NY + y) * NX3 + 3 * x;
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int sl = g * S + s;
    if (sl < ns) {
      const T c0 = __ldg(coeffs + 2 * static_cast<size_t>(s0 + sl));
      const T c1 = __ldg(coeffs + 2 * static_cast<size_t>(s0 + sl) + 1);
      T* qs = qrow + static_cast<size_t>(s0 + sl) * ndof;
#pragma unroll
      for (int a = 0; a < 3; ++a) qs[a] = fma_rn(c0, acc0[a][s], mul_rn(c1, acc1[a][s]));
    }
  }
}

// The launch geometry of G sample groups on rows of NX3 lanes: threads a
// block and bytes of shared memory (a ring of kStages staged rows, each the
// row's node-major coefficients of one neighbour row, then that row of u
// for the block's G*S samples with a zero halo node each side, in whole
// 16-byte copies).
template <typename T>
void geometry(int NX3, int G, int* threads, size_t* smem) {
  constexpr int kVec = 16 / sizeof(T);
  *threads = (G * (NX3 / 3) + 31) / 32 * 32;
  const size_t stage = (static_cast<size_t>(NX3 / 3) * Pitch<T>::value +
                        static_cast<size_t>(G) * kSamples * (NX3 + 2 * kHalo) + kVec - 1) /
                       kVec * kVec;
  *smem = kStages * stage * sizeof(T);
}

// out = (threads, shared-memory bytes, blocks an SM holds at once, samples
// a thread, values a node's coefficients take a neighbour row) of G groups;
// cudaErrorInvalidValue if the kernel cannot take them.
template <typename T>
int fit(int NX3, int G, int* out) {
  int threads;
  size_t smem;
  if (NX3 <= 0 || NX3 % 3 != 0 || G <= 0) return static_cast<int>(cudaErrorInvalidValue);
  geometry<T>(NX3, G, &threads, &smem);
  out[0] = threads;
  out[1] = static_cast<int>(smem);
  out[2] = 0;
  out[3] = kSamples;
  out[4] = Pitch<T>::value;
  int dev, optin;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (threads > MaxThreads<T>::value || smem > static_cast<size_t>(optin))
    return static_cast<int>(cudaErrorInvalidValue);
  auto* kernel = stencil3d_affine_kernel<T>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[2], kernel, threads, smem);
  return static_cast<int>(err);
}

template <typename T>
int launch(const void* w, const void* coeffs, const void* u, void* q, int B, int NZ, int NY,
           int NX3, int G, void* stream) {
  if (B <= 0 || NZ <= 0 || NY <= 0 || NX3 <= 0 || NX3 % 3 != 0 || G <= 0 ||
      static_cast<long long>(NZ) * NY > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  int threads;
  size_t smem;
  geometry<T>(NX3, G, &threads, &smem);
  if (threads > MaxThreads<T>::value) return static_cast<int>(cudaErrorInvalidValue);
  auto* kernel = stencil3d_affine_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((B + G * kSamples - 1) / (G * kSamples), NZ * NY);
  kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(w), static_cast<const T*>(coeffs), static_cast<const T*>(u),
      static_cast<T*>(q), B, NZ, NY, NX3 / 3, G);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points, bound with ctypes. All arrays are dense row-major on
// the current device: w (NZ * NY, 9, NX, 60 for float32 or 62 for float64),
// the node-major coefficients of ops/stencil3d_kernel.py::pack_w_nodes_3d,
// 16-byte aligned; coeffs (B, 2); u, q (B, NZ * NY * NX3). A block takes one
// grid row and G groups of kSamples samples. Returns the CUDA error code of
// the launch (0 = success).
extern "C" int vbicm_stencil3d_affine_f32(const void* w, const void* coeffs, const void* u,
                                          void* q, int B, int NZ, int NY, int NX3, int G,
                                          void* stream) {
  return launch<float>(w, coeffs, u, q, B, NZ, NY, NX3, G, stream);
}

extern "C" int vbicm_stencil3d_affine_f64(const void* w, const void* coeffs, const void* u,
                                          void* q, int B, int NZ, int NY, int NX3, int G,
                                          void* stream) {
  return launch<double>(w, coeffs, u, q, B, NZ, NY, NX3, G, stream);
}

// What a launch of G sample groups on rows of NX3 lanes takes on the current
// device: out = (threads a block, shared-memory bytes a block, blocks an SM
// holds at once, samples a thread, the coefficients' pitch). Returns 0, cudaErrorInvalidValue where
// the kernel cannot take G groups of rows that long (more threads than its
// launch bound, more shared memory than a block may have), or another CUDA
// error code.
extern "C" int vbicm_stencil3d_affine_fit_f32(int NX3, int G, int* out) {
  return fit<float>(NX3, G, out);
}

extern "C" int vbicm_stencil3d_affine_fit_f64(int NX3, int G, int* out) {
  return fit<double>(NX3, G, out);
}

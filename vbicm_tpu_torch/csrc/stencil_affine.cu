// Batched structured-grid affine stencil matvec for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels vbicm_tpu/ops/stencil_pallas.py,
// stencil_affine_matvec_pallas (body _row_kernel) and, as the forced
// rows-per-block form of the same body, stencil_affine_matvec_pallas_mr
// (body _mr_kernel). On the structured quad4 grid of Cook's membrane the
// assembled stiffness couples a node only to its 8 neighbours; with the dofs
// interleaved along a grid row (lane i = 2x + a) the 2x2 block stencil is a
// 7-tap stencil along the row for each of the three rows y-1, y, y+1. For
// every sample s, grid row y and lane i
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
// What bounds it on an H100: bytes. At 160x80 (NY = 81, 2NX = 322) and
// B = 256 the function moves 27 MB of u and 27 MB of q and 3.8 MB of
// nonzero coefficients in float32 (0.0171 ms at 3.35 TB/s), against 0.24 G
// multiply-adds (7 us on the CUDA cores). This design takes 0.035 ms there
// in float32 (half the bound; the one-row kernel it replaced 0.22 ms) and
// 0.077 ms in float64 (0.25 ms) on the H100 (tools/stencil_tiles.py). What holds it
// back is the sample loop, not the copies (PERF.md): its shared-memory
// reads, about as many bytes as its FMAs, come in bursts behind the
// block-wide barrier of each sample.
//
// Design: the (band of R grid rows, sample) pairs, band-major, are split
// into equal contiguous runs of W, one a block, so every block has the same
// work whatever R and B are (a run may end in one band and go on in the
// next); within a band the samples are a loop.
//   1. Each thread owns one row of the band and kNpt adjacent nodes (2 kNpt
//      lanes) and keeps their nonzero coefficients in registers for the
//      whole sample loop: the planes are read once per run of samples, not
//      once per 8. A lane has 36 nonzero coefficients of its 42 (an even
//      lane's tap d = 0 and an odd lane's d = 6 reach no node of the 3x3
//      block and are zero in every packed plane).
//   2. Per sample, the band's R + 2 u rows are staged once in shared memory
//      (one zero halo node each side; rows outside the grid zero), copied
//      node by node with cp.async into a ring of kStages samples, so the
//      copies of the next kStages - 1 samples are in flight while this one
//      is computed: a sample's arithmetic takes far less than the copy's
//      latency. The copy addresses are set once per thread: the rows in the
//      grid are one contiguous run of u.
//   3. A thread reads its window, nodes x-1 .. x+kNpt of each of the three
//      rows, as 2-value vector loads (3 (kNpt + 2) of them) and feeds
//      24 kNpt multiply-adds from it: 4 FMAs per value read (the one-row
//      kernel read one value per 2 FMAs). One node a thread is the
//      fastest on the H100 (tools/stencil_tiles.py builds and times two).
//   4. Bands wider than the block's RT thread rows are taken in sub-bands.
// Every output is computed by one thread with the FMAs of lane_value of the
// one-row kernel in their order (dy, then d; each part's sum its own chain,
// then c0 a0 + c1 a1 as one FMA on a rounded product); a skipped tap has a
// zero coefficient and a sum that is never -0, so for finite u the result
// is bitwise equal to that kernel's, and to itself for every R, W and kNpt.
//
// The launch geometry (threads, shared memory) is worked out here only
// (geometry); ops/stencil_kernel.py plans a launch from what
// vbicm_stencil_affine_fit_* reports for this build on this card.
//
// Not yet done (later work): TMA (no global stride of this layout is a
// multiple of 16 bytes), tensor cores (see stencil_mxu.cu for the banded
// tensor-core form of the same function).

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kRows = 3;    // neighbour rows y-1, y, y+1
constexpr int kTaps = 7;    // lane offsets -3..3
constexpr int kPlanes = 2 * kRows * kTaps;  // 42
constexpr int kLaneTaps = kRows * 6;        // nonzero taps of a lane, one part
constexpr int kStages = 8;  // staged samples in flight
constexpr int kNpt = 1;     // nodes a thread

template <typename T>
struct Vec2;
template <>
struct Vec2<float> {
  using type = float2;
};
template <>
struct Vec2<double> {
  using type = double2;
};

// Threads a block may have: the register cap this gives (65536 / threads)
// holds each instance's coefficients unspilled.
template <typename T>
struct MaxThreads {
  static constexpr int value = sizeof(T) == 4 && kNpt == 1 ? 512 : 256;
};

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float fma_rn(float a, float b, float c) { return __fmaf_rn(a, b, c); }
__device__ __forceinline__ double fma_rn(double a, double b, double c) { return __fma_rn(a, b, c); }

// One node (two values) global -> shared, asynchronously.
template <typename V2>
__device__ __forceinline__ void cp_async_node(V2* dst, const V2* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d), "l"(src),
               "n"(sizeof(V2)));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <typename T>
__global__ void __launch_bounds__(MaxThreads<T>::value)
    stencil_affine_kernel(const T* __restrict__ w, const T* __restrict__ coeffs,
                          const T* __restrict__ u, T* __restrict__ q, int B, int NY, int NXn,
                          int R, int RT, int W) {
  using V2 = typename Vec2<T>::type;
  constexpr int kChunks = 3 * kNpt;  // node copies a thread issues a staged sample, at most
  extern __shared__ __align__(16) unsigned char smem_raw[];
  V2* buf = reinterpret_cast<V2*>(smem_raw);  // (kStages, stage)
  const int NX2 = 2 * NXn;
  const int NXt = (NXn + kNpt - 1) / kNpt;  // node groups a row
  const int slots = NXt * kNpt + 2;        // nodes a staged row, with the zero halo nodes
  const int stage = (RT + 2) * slots + 1;  // a staged sample: RT + 2 rows, then (c0, c1)
  const size_t ndof = static_cast<size_t>(NY) * NX2;

  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int rt = tid / NXt;  // this thread's row of a sub-band
  const int xg = tid - rt * NXt;  // and its node group: nodes xg*kNpt ..
  const V2 zero = {T(0), T(0)};

  for (int k = tid; k < kStages * stage; k += nthreads) buf[k] = zero;

  // this block's run of (band, sample) pairs, band-major
  const long long total = static_cast<long long>((NY + R - 1) / R) * B;
  const long long wend = min(total, static_cast<long long>(blockIdx.x + 1) * W);
  for (long long wk = static_cast<long long>(blockIdx.x) * W; wk < wend;) {
    const int band = static_cast<int>(wk / B);
    const int s0 = static_cast<int>(wk - static_cast<long long>(band) * B);
    const int ns = static_cast<int>(min(static_cast<long long>(B - s0), wend - wk));
    wk += ns;
    const int yb0 = band * R;
    const int yend = min(yb0 + R, NY);
    for (int yb = yb0; yb < yend; yb += RT) {
      const int rows = min(RT, yend - yb);
      // staged row r holds grid row yb - 1 + r; rows r_lo .. r_hi - 1 are in
      // the grid, one contiguous run of each sample's u
      const int r_lo = yb == 0 ? 1 : 0;
      const int r_hi = min(rows + 2, NY - yb + 1);
      const int nchunk = (r_hi - r_lo) * NXn;
      const V2* u_run = reinterpret_cast<const V2*>(u + static_cast<size_t>(s0) * ndof +
                                                    static_cast<size_t>(yb - 1 + r_lo) * NX2);
      int dst[kChunks];
#pragma unroll
      for (int j = 0; j < kChunks; ++j) {
        const int k = tid + j * nthreads;
        const int r = k / NXn;
        dst[j] = k < nchunk ? (r_lo + r) * slots + (k - r * NXn) + 1 : -1;
      }
      __syncthreads();  // the previous sub-band has read its last stage
      // the staged rows outside the grid are zero in every stage
      const int zrows = rows + 2;
      for (int k = tid; k < kStages * zrows * slots; k += nthreads) {
        const int st = k / (zrows * slots);
        const int e = k - st * zrows * slots;
        const int r = e / slots;
        if (r < r_lo || r >= r_hi) buf[st * stage + e] = zero;
      }

      // the samples are staged in order; the source and the ring slot
      // advance a sample a call
      const V2* src = u_run + tid;
      const V2* csrc = reinterpret_cast<const V2*>(coeffs) + s0;
      int slot = 0;
      auto issue = [&]() {
        V2* b = buf + slot * stage;
#pragma unroll
        for (int j = 0; j < kChunks; ++j)
          if (dst[j] >= 0) cp_async_node(b + dst[j], src + j * nthreads);
        if (tid == 0) cp_async_node(b + (RT + 2) * slots, csrc);
        src += ndof / 2;
        ++csrc;
        slot = slot + 1 == kStages ? 0 : slot + 1;
      };

      // this thread's coefficients: even lane taps d = 1..6, odd lane d = 0..5
      const bool active = rt < rows;
      const int y = yb + rt;
      T we0[kNpt][kLaneTaps], we1[kNpt][kLaneTaps], wo0[kNpt][kLaneTaps], wo1[kNpt][kLaneTaps];
      const V2* wy = reinterpret_cast<const V2*>(w) + static_cast<size_t>(active ? y : 0) *
                                                          kPlanes * NXn;
#pragma unroll
      for (int n = 0; n < kNpt; ++n) {
        const int x = xg * kNpt + n;
        const bool live = active && x < NXn;
#pragma unroll
        for (int dy = 0; dy < kRows; ++dy) {
#pragma unroll
          for (int d = 0; d < kTaps; ++d) {
            const V2* wp = wy + static_cast<size_t>(dy * kTaps + d) * NXn + x;
            const V2 c0 = live ? __ldg(wp) : zero;
            const V2 c1 = live ? __ldg(wp + static_cast<size_t>(kRows * kTaps) * NXn) : zero;
            if (d >= 1) {
              we0[n][dy * 6 + d - 1] = c0.x;
              we1[n][dy * 6 + d - 1] = c1.x;
            }
            if (d <= 5) {
              wo0[n][dy * 6 + d] = c0.y;
              wo1[n][dy * 6 + d] = c1.y;
            }
          }
        }
      }

#pragma unroll
      for (int st = 0; st < kStages - 1; ++st) {
        if (st < ns) issue();
        cp_async_commit();
      }
      V2* qs = reinterpret_cast<V2*>(q + static_cast<size_t>(s0) * ndof +
                                     static_cast<size_t>(active ? y : 0) * NX2) + xg * kNpt;
      for (int s = 0, cur = 0; s < ns;
           ++s, qs += ndof / 2, cur = cur + 1 == kStages ? 0 : cur + 1) {
        cp_async_wait<kStages - 2>();  // this thread's copies of sample s have landed
        __syncthreads();                // everyone's have; everyone is done with s - 1
        if (s + kStages - 1 < ns) issue();
        cp_async_commit();  // an empty group past the last sample keeps the count
        if (!active) continue;
        const V2* b = buf + cur * stage;
        const V2 c = b[(RT + 2) * slots];
        T ae0[kNpt], ae1[kNpt], ao0[kNpt], ao1[kNpt];
#pragma unroll
        for (int n = 0; n < kNpt; ++n) ae0[n] = ae1[n] = ao0[n] = ao1[n] = T(0);
#pragma unroll
        for (int dy = 0; dy < kRows; ++dy) {
          const V2* row = b + (rt + dy) * slots + xg * kNpt;  // node xg*kNpt - 1
          V2 v[kNpt + 2];
#pragma unroll
          for (int j = 0; j < kNpt + 2; ++j) v[j] = row[j];
#pragma unroll
          for (int n = 0; n < kNpt; ++n) {
            // u[2x - 2 .. 2x + 3]: nodes x-1, x, x+1
            const T win[6] = {v[n].x, v[n].y, v[n + 1].x, v[n + 1].y, v[n + 2].x, v[n + 2].y};
#pragma unroll
            for (int d = 0; d < kTaps; ++d) {
              if (d >= 1) {  // even lane 2x: u[2x - 3 + d]
                ae0[n] = fma_rn(we0[n][dy * 6 + d - 1], win[d - 1], ae0[n]);
                ae1[n] = fma_rn(we1[n][dy * 6 + d - 1], win[d - 1], ae1[n]);
              }
              if (d <= 5) {  // odd lane 2x + 1: u[2x - 2 + d]
                ao0[n] = fma_rn(wo0[n][dy * 6 + d], win[d], ao0[n]);
                ao1[n] = fma_rn(wo1[n][dy * 6 + d], win[d], ao1[n]);
              }
            }
          }
        }
#pragma unroll
        for (int n = 0; n < kNpt; ++n) {
          if (xg * kNpt + n < NXn)
            qs[n] = V2{fma_rn(c.x, ae0[n], mul_rn(c.y, ae1[n])),
                       fma_rn(c.x, ao0[n], mul_rn(c.y, ao1[n]))};
        }
      }
    }
  }
}

// The launch geometry of RT rows at once on rows of NX2 lanes: threads a
// block and bytes of shared memory (a ring of kStages samples, each RT + 2
// staged rows of whole node groups with a zero halo node each side, then
// its (c0, c1)).
template <typename T>
void geometry(int NX2, int RT, int* threads, size_t* smem) {
  const int NXt = (NX2 / 2 + kNpt - 1) / kNpt;
  *threads = (RT * NXt + 31) / 32 * 32;
  *smem = static_cast<size_t>(kStages) * ((RT + 2) * (NXt * kNpt + 2) + 1) * 2 * sizeof(T);
}

// out = (threads, shared-memory bytes, blocks an SM holds at once) of RT
// rows at once; cudaErrorInvalidValue if the kernel cannot take them.
template <typename T>
int fit(int NX2, int RT, int* out) {
  int threads;
  size_t smem;
  if (NX2 <= 0 || NX2 % 2 != 0 || RT <= 0) return static_cast<int>(cudaErrorInvalidValue);
  geometry<T>(NX2, RT, &threads, &smem);
  out[0] = threads;
  out[1] = static_cast<int>(smem);
  out[2] = 0;
  int dev, optin;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (threads > MaxThreads<T>::value || smem > static_cast<size_t>(optin))
    return static_cast<int>(cudaErrorInvalidValue);
  auto* kernel = stencil_affine_kernel<T>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[2], kernel, threads, smem);
  return static_cast<int>(err);
}

template <typename T>
int launch(const void* w, const void* coeffs, const void* u, void* q, int B, int NY, int NX2,
           int R, int RT, int W, void* stream) {
  if (B <= 0 || NY <= 0 || NX2 <= 0 || NX2 % 2 != 0 || R <= 0 || RT <= 0 || RT > R || W <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  int threads;
  size_t smem;
  geometry<T>(NX2, RT, &threads, &smem);
  if (threads > MaxThreads<T>::value) return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = (static_cast<long long>((NY + R - 1) / R) * B + W - 1) / W;
  if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  auto* kernel = stencil_affine_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<unsigned>(blocks), threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(w), static_cast<const T*>(coeffs), static_cast<const T*>(u),
      static_cast<T*>(q), B, NY, NX2 / 2, R, RT, W);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points, bound with ctypes. All arrays are dense row-major on
// the current device, each aligned to two of its values: w (NY, 42, NX2);
// coeffs (B, 2); u, q (B, NY * NX2). Bands of R grid rows (the last band
// the rest), RT of them at a time (RT <= R); each block takes W consecutive
// (band, sample) pairs, band-major. Returns the CUDA error code of the
// launch (0 = success).
extern "C" int vbicm_stencil_affine_f32(const void* w, const void* coeffs, const void* u, void* q,
                                        int B, int NY, int NX2, int R, int RT, int W,
                                        void* stream) {
  return launch<float>(w, coeffs, u, q, B, NY, NX2, R, RT, W, stream);
}

extern "C" int vbicm_stencil_affine_f64(const void* w, const void* coeffs, const void* u, void* q,
                                        int B, int NY, int NX2, int R, int RT, int W,
                                        void* stream) {
  return launch<double>(w, coeffs, u, q, B, NY, NX2, R, RT, W, stream);
}

// What a launch of RT rows at once on rows of NX2 lanes takes on the
// current device: out = (threads a block, shared-memory bytes a block,
// blocks an SM holds at once). Returns 0, cudaErrorInvalidValue where the
// kernel cannot take RT rows of that length at once (more threads than
// its launch bound, more shared memory than a block may have), or another
// CUDA error code.
extern "C" int vbicm_stencil_affine_fit_f32(int NX2, int RT, int* out) {
  return fit<float>(NX2, RT, out);
}

extern "C" int vbicm_stencil_affine_fit_f64(int NX2, int RT, int* out) {
  return fit<double>(NX2, RT, out);
}

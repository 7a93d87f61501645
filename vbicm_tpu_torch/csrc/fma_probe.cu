// FMA-ceiling probe for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel in examples/stencil_kernel_study.py,
// vpu_peak_kernel (its run): for a (B, NY * XLP) and b (B, XLP),
//
//     out[s, y * XLP + x] = f^nfma(a[s, y * XLP + x]),  f(v) = v * b[s, x] + b[s, x],
//
// one chain of nfma dependent multiply-adds an element, b shared by every
// block y. The TPU kernel measured the vector unit's ceiling with the
// stencil's block structure; here it measures the CUDA cores' FMA rate.
//
// What bounds it on an H100: each element reads a once and writes out once
// (b is small and stays in L2) and does 2 * nfma flops. At the stencil
// study's shape (B = 256, NY = 81, XLP = 384, float32) that is 63.8 MB
// against 0.67 GFLOP at nfma = 42: bound by bytes (19 us of HBM against
// 10 us of FMA). At nfma = 4096 the FMAs bound it (65 GFLOP, about 1 ms at
// 67 TFLOP/s), so that run reads the FMA ceiling.
//
// Design: each step of a chain is an explicit round-to-nearest FMA (one
// rounding a step; the plain PyTorch version rounds the product and the sum
// apart). The FP32 pipe takes one warp instruction a cycle on each SM
// sub-partition, so every instruction in the loop that is not an FMA costs
// an FMA's issue slot. A thread therefore carries kChains elements (chains
// independent of each other, kThreads apart so that loads and stores stay
// coalesced), and a loop trip does kUnroll steps of each: kChains * kUnroll
// = 64 FMAs to the trip's counter, compare and branch. The kChains chains
// also cover the FMA latency within a thread. Each element's result is the
// same as with one chain a thread: nfma FMAs in order. float32 and float64
// instances.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 256;
constexpr int kChains = 4;   // elements (independent chains) a thread
constexpr int kUnroll = 16;  // steps of every chain a loop trip

__device__ __forceinline__ float fma_rn(float a, float b, float c) { return __fmaf_rn(a, b, c); }
__device__ __forceinline__ double fma_rn(double a, double b, double c) { return __fma_rn(a, b, c); }

template <typename T>
__global__ void __launch_bounds__(kThreads)
fma_probe_kernel(const T* __restrict__ a, const T* __restrict__ b, T* __restrict__ out,
                 long long n, int row, int XLP, int nfma) {
  const long long base = static_cast<long long>(blockIdx.x) * (kThreads * kChains) + threadIdx.x;
  T acc[kChains], bb[kChains];
#pragma unroll
  for (int c = 0; c < kChains; ++c) {
    const long long e = base + static_cast<long long>(c) * kThreads;
    acc[c] = T(0);
    bb[c] = T(0);
    if (e < n) {
      const long long s = e / row;
      const int x = static_cast<int>(e % row) % XLP;
      bb[c] = b[s * XLP + x];
      acc[c] = a[e];
    }
  }
  int k = 0;
#pragma unroll 1
  for (; k + kUnroll <= nfma; k += kUnroll) {
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
#pragma unroll
      for (int c = 0; c < kChains; ++c) acc[c] = fma_rn(acc[c], bb[c], bb[c]);
    }
  }
#pragma unroll 1
  for (; k < nfma; ++k) {
#pragma unroll
    for (int c = 0; c < kChains; ++c) acc[c] = fma_rn(acc[c], bb[c], bb[c]);
  }
#pragma unroll
  for (int c = 0; c < kChains; ++c) {
    const long long e = base + static_cast<long long>(c) * kThreads;
    if (e < n) out[e] = acc[c];
  }
}

template <typename T>
int launch(const void* a, const void* b, void* out, int B, int NY, int XLP, int nfma,
           void* stream) {
  if (B <= 0 || NY <= 0 || XLP <= 0 || nfma < 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long n = static_cast<long long>(B) * NY * XLP;
  const long long per_block = static_cast<long long>(kThreads) * kChains;
  const long long blocks = (n + per_block - 1) / per_block;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  fma_probe_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<T*>(out), n, NY * XLP, XLP,
      nfma);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points, bound with ctypes. All arrays are dense row-major on
// the current device: a, out (B, NY * XLP); b (B, XLP). Returns the CUDA
// error code of the launch (0 = success).
extern "C" int vbicm_fma_probe_f32(const void* a, const void* b, void* out, int B, int NY,
                                   int XLP, int nfma, void* stream) {
  return launch<float>(a, b, out, B, NY, XLP, nfma, stream);
}

extern "C" int vbicm_fma_probe_f64(const void* a, const void* b, void* out, int B, int NY,
                                   int XLP, int nfma, void* stream) {
  return launch<double>(a, b, out, B, NY, XLP, nfma, stream);
}

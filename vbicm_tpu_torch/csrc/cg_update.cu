// CG's vector updates for Hopper (sm_90a): the two launches a loop step of
// the batched preconditioned CG (ops/solve.py::pcg), one after the matvec
// (cg_alpha_step_kernel) and one after the preconditioner
// (cg_beta_step_kernel).
//
// Replaces no TPU kernel: the JAX package's CG updates are XLA ops
// (vbicm_tpu/ops/solve.py, pcg under jax.vmap), and the port's plain version
// (ops/cg_update_kernel.py, cg_update_reference_alpha and _beta) is the
// loop's PyTorch ops, ~37 launches a loop step. On the H100 those were 58 %
// of a 160x80 train step's device time and most of the host's launches
// (PERF.md). This pair computes the same per-lane function.
//
// Per lane (one right-hand side of the batch), for the lanes the previous
// step left active (active = !(rr <= thresh) && !dead, so a NaN residual
// stays active); the other lanes read their flag and leave their state as
// it is:
//   alpha step, after kp = K p:
//     denom = p.kp;  bad = !(denom > 0);  alpha = bad ? 0 : rz / (denom == 0 ? 1 : denom)
//     x = x + alpha p;  r = r - alpha kp  (in place);  the new r.r as the
//     blocks' partial sums
//   beta step, after z = M^-1 r:
//     rz_n = r.z;  dead_n = dead | bad | !(rz_n > 0);
//     beta = dead_n ? 0 : rz_n / (rz == 0 ? 1 : rz)
//     p = z + beta p;  rz = dead_n ? rz : rz_n;  rr = the partials' sum;
//     it += 1;  dead = dead_n;  active = !(rr <= thresh) && !dead_n
// A breakdown step still computes x + 0 p, r - 0 kp and z + 0 p, so a NaN or
// an infinity in p or kp spreads as it does in the plain version.
//
// What bounds it on an H100: bytes. At (256, 26,082) in float32 the alpha
// step reads p, kp, x, r and writes x, r (160 MB, 0.048 ms at 3.35 TB/s);
// the beta step reads r, z, p and writes p (107 MB, 0.032 ms); a few flops a
// value.
//
// Design: a lane's dot must be whole before its update, and a lane of
// 26,082 values is too long for one block's registers. So a lane is split
// over a thread-block cluster of `cluster` blocks (one block for a short
// lane), each block holding a contiguous slice in registers, kPairs pairs
// of values a thread; the blocks' partial dots meet through distributed
// shared memory, so each input is read from device memory once and the
// update follows with no second read. A slice longer than the registers
// hold is read twice, the second time mostly from L2 (the plan's tiles >
// 1). The plan (ops/cg_update_kernel.py::launch_plan) picks the cluster: on
// the card held slices beat streamed ones and a block a lane reading twice,
// and 8 pairs a thread beat 2, 4 and 16 (PERF.md).
//
// Order of operations, fixed by the plan alone: a thread's chain of FMAs
// over its pairs (tile, pair, value), a shuffle tree over each warp, a
// shuffle tree over the block's warps, then the cluster's block sums in rank
// order. No atomics, so two launches give the same bits. Plain FMA
// arithmetic in the input's type (float32 or float64), no tensor cores.
//
// Loads: a pair of values is one 8-byte (float32) or 16-byte (float64) load
// where every lane's row is aligned to it (n even, the pointers aligned: the
// launch's `vec`), else two loads; the order of the sums does not depend on
// it.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

namespace cgrp = cooperative_groups;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPairs = 8;  // pairs of values a thread holds
constexpr int kMaxCluster = 16;  // above 8 a non-portable cluster size

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

template <typename T>
struct Pair {
  T a, b;
};

// A loop's state as the host holds it (ops/cg_update_kernel.py, _CgHost).
struct CgHost {
  void* x;
  void* r;
  void* p;
  void* rz;
  void* rr;
  const void* thresh;
  void* it;
  void* dead;
  void* active;
  void* bad;
  void* part;
  int lanes, n, cluster, slice;
};

template <typename T>
struct CgArgs {
  T* x;
  T* r;
  T* p;
  const T* v;  // kp (alpha step) or z (beta step)
  T* rz;
  T* rr;
  const T* thresh;
  long long* it;
  unsigned char* dead;
  unsigned char* active;
  unsigned char* bad;
  T* part;  // (lanes, cluster): the blocks' partial r.r of the alpha step
  int n, slice, vec;
};

template <typename T, bool kNc>
__device__ __forceinline__ T ld1(const T* q) {
  if constexpr (kNc) {
    return __ldg(q);
  } else {
    return *q;
  }
}

// Values i and i + 1 of a row whose slice ends at hi, zeros past it; kNc
// reads through the read-only cache (inputs the launch does not write).
template <typename T, bool kNc>
__device__ __forceinline__ Pair<T> ld_pair(const T* row, int i, int hi, bool vec) {
  Pair<T> v{T(0), T(0)};
  if (i + 1 < hi) {
    if (vec) {
      using V2 = typename Vec2<T>::type;
      const V2* q = reinterpret_cast<const V2*>(row + i);
      V2 w;
      if constexpr (kNc) {
        w = __ldg(q);
      } else {
        w = *q;
      }
      v.a = w.x;
      v.b = w.y;
    } else {
      v.a = ld1<T, kNc>(row + i);
      v.b = ld1<T, kNc>(row + i + 1);
    }
  } else if (i < hi) {
    v.a = ld1<T, kNc>(row + i);
  }
  return v;
}

template <typename T>
__device__ __forceinline__ void st_pair(T* row, int i, int hi, bool vec, Pair<T> v) {
  if (i + 1 < hi) {
    if (vec) {
      typename Vec2<T>::type w;
      w.x = v.a;
      w.y = v.b;
      *reinterpret_cast<typename Vec2<T>::type*>(row + i) = w;
    } else {
      row[i] = v.a;
      row[i + 1] = v.b;
    }
  } else if (i < hi) {
    row[i] = v.a;
  }
}

// The block's sum in a fixed tree, in thread 0.
template <typename T>
__device__ __forceinline__ T block_sum(T v, T* warp_sums) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int w = threadIdx.x >> 5, l = threadIdx.x & 31;
  if (l == 0) warp_sums[w] = v;
  __syncthreads();
  if (w == 0) {
    v = l < kWarps ? warp_sums[l] : T(0);
#pragma unroll
    for (int o = kWarps / 2; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  }
  return v;
}

// The sum of `values[0 .. count)`, read by warp 0's lanes at once and added
// in index order; in thread 0. `at(i)` reads value i.
template <typename T, typename At>
__device__ __forceinline__ T ordered_sum(unsigned count, At at) {
  T t = T(0);
  if (threadIdx.x < 32) {
    const T v = threadIdx.x < count ? at(threadIdx.x) : T(0);
    for (unsigned c = 0; c < count; ++c) t += __shfl_sync(0xffffffffu, v, c);
  }
  return t;
}

// The cluster's sum of its blocks' sums (thread 0's `s`), in rank order,
// in every thread of every block. It leaves this thread arrived at the
// cluster barrier: the kernel waits on it (cluster_wait) before it exits,
// so no block's shared memory goes away while another reads it.
template <typename T>
__device__ __forceinline__ T cluster_sum(T s, T* mine, T* total) {
  cgrp::cluster_group cluster = cgrp::this_cluster();
  if (threadIdx.x == 0) *mine = s;
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n\t"
      "barrier.cluster.wait.acquire.aligned;" ::: "memory");
  const T t = ordered_sum<T>(cluster.num_blocks(),
                             [&](unsigned c) { return *cluster.map_shared_rank(mine, c); });
  if (threadIdx.x == 0) *total = t;
  __syncthreads();
  const T out = *total;
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
  return out;
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
}

// Register tiles of a block's slice [lo, hi): ceil(pairs / (threads * kPairs)).
__device__ __forceinline__ int slice_tiles(int lo, int hi) {
  constexpr int kTile = 2 * kThreads * kPairs;
  return hi > lo ? (hi - lo + kTile - 1) / kTile : 0;
}

// Value index of pair j of tile t in this thread.
__device__ __forceinline__ int pair_at(int lo, int t, int j) {
  return lo + 2 * ((t * kPairs + j) * kThreads + static_cast<int>(threadIdx.x));
}

template <typename T>
__global__ void __launch_bounds__(kThreads) cg_alpha_step_kernel(CgArgs<T> a) {
  __shared__ T warp_sums[kWarps];
  __shared__ T mine, total;
  cgrp::cluster_group cluster = cgrp::this_cluster();
  const unsigned C = cluster.num_blocks(), rank = cluster.block_rank();
  const int lane = blockIdx.x / C;
  if (!a.active[lane]) return;  // every block of the cluster leaves
  const int lo = static_cast<int>(rank) * a.slice;
  const int hi = min(a.n, lo + a.slice);
  const int tiles = slice_tiles(lo, hi);
  const size_t off = static_cast<size_t>(lane) * a.n;
  const T* p = a.p + off;
  const T* kp = a.v + off;
  T* x = a.x + off;
  T* r = a.r + off;
  const bool vec = a.vec;
  const T rz = a.rz[lane];

  Pair<T> pv[kPairs], kv[kPairs], xv[kPairs], rv[kPairs];
  T dot = T(0);
  for (int t = 0; t < tiles; ++t) {
#pragma unroll
    for (int j = 0; j < kPairs; ++j) {
      const int i = pair_at(lo, t, j);
      pv[j] = ld_pair<T, true>(p, i, hi, vec);
      kv[j] = ld_pair<T, true>(kp, i, hi, vec);
      if (tiles == 1) {  // held: x and r arrive while the dot is summed
        xv[j] = ld_pair<T, false>(x, i, hi, vec);
        rv[j] = ld_pair<T, false>(r, i, hi, vec);
      }
    }
#pragma unroll
    for (int j = 0; j < kPairs; ++j) {
      dot = fma(pv[j].a, kv[j].a, dot);
      dot = fma(pv[j].b, kv[j].b, dot);
    }
  }
  const T denom = cluster_sum(block_sum(dot, warp_sums), &mine, &total);
  const bool bad = !(denom > T(0));  // <= 0 and NaN
  const T alpha = bad ? T(0) : rz / (denom == T(0) ? T(1) : denom);

  T rr = T(0);
  for (int t = 0; t < tiles; ++t) {
#pragma unroll
    for (int j = 0; j < kPairs; ++j) {
      const int i = pair_at(lo, t, j);
      if (tiles > 1) {
        pv[j] = ld_pair<T, true>(p, i, hi, vec);
        kv[j] = ld_pair<T, true>(kp, i, hi, vec);
        xv[j] = ld_pair<T, false>(x, i, hi, vec);
        rv[j] = ld_pair<T, false>(r, i, hi, vec);
      }
      xv[j].a = fma(alpha, pv[j].a, xv[j].a);
      xv[j].b = fma(alpha, pv[j].b, xv[j].b);
      rv[j].a = fma(-alpha, kv[j].a, rv[j].a);
      rv[j].b = fma(-alpha, kv[j].b, rv[j].b);
      st_pair(x, i, hi, vec, xv[j]);
      st_pair(r, i, hi, vec, rv[j]);
      if (i < hi) rr = fma(rv[j].a, rv[j].a, rr);
      if (i + 1 < hi) rr = fma(rv[j].b, rv[j].b, rr);
    }
  }
  const T s = block_sum(rr, warp_sums);
  if (threadIdx.x == 0) {
    a.part[static_cast<size_t>(lane) * C + rank] = s;
    if (rank == 0) a.bad[lane] = bad;
  }
  cluster_wait();
}

template <typename T>
__global__ void __launch_bounds__(kThreads) cg_beta_step_kernel(CgArgs<T> a) {
  __shared__ T warp_sums[kWarps];
  __shared__ T mine, total;
  cgrp::cluster_group cluster = cgrp::this_cluster();
  const unsigned C = cluster.num_blocks(), rank = cluster.block_rank();
  const int lane = blockIdx.x / C;
  if (!a.active[lane]) return;  // every block of the cluster leaves
  const int lo = static_cast<int>(rank) * a.slice;
  const int hi = min(a.n, lo + a.slice);
  const int tiles = slice_tiles(lo, hi);
  const size_t off = static_cast<size_t>(lane) * a.n;
  const T* r = a.r + off;
  const T* z = a.v + off;
  T* p = a.p + off;
  const bool vec = a.vec;
  // every block reads the lane's scalars before the cluster barrier, and
  // rank 0 writes them after it
  const T rz = a.rz[lane];
  const bool dead = a.dead[lane], bad = a.bad[lane];

  Pair<T> rv[kPairs], zv[kPairs], pv[kPairs];
  T dot = T(0);
  for (int t = 0; t < tiles; ++t) {
#pragma unroll
    for (int j = 0; j < kPairs; ++j) {
      const int i = pair_at(lo, t, j);
      rv[j] = ld_pair<T, true>(r, i, hi, vec);
      zv[j] = ld_pair<T, true>(z, i, hi, vec);
      if (tiles == 1) pv[j] = ld_pair<T, false>(p, i, hi, vec);
    }
#pragma unroll
    for (int j = 0; j < kPairs; ++j) {
      dot = fma(rv[j].a, zv[j].a, dot);
      dot = fma(rv[j].b, zv[j].b, dot);
    }
  }
  const T rz_n = cluster_sum(block_sum(dot, warp_sums), &mine, &total);
  const bool dead_n = dead || bad || !(rz_n > T(0));
  const T beta = dead_n ? T(0) : rz_n / (rz == T(0) ? T(1) : rz);

  for (int t = 0; t < tiles; ++t) {
#pragma unroll
    for (int j = 0; j < kPairs; ++j) {
      const int i = pair_at(lo, t, j);
      if (tiles > 1) {
        zv[j] = ld_pair<T, true>(z, i, hi, vec);
        pv[j] = ld_pair<T, false>(p, i, hi, vec);
      }
      pv[j].a = fma(beta, pv[j].a, zv[j].a);
      pv[j].b = fma(beta, pv[j].b, zv[j].b);
      st_pair(p, i, hi, vec, pv[j]);
    }
  }
  if (rank == 0) {
    const T* part = a.part + static_cast<size_t>(lane) * C;
    const T rr = ordered_sum<T>(C, [&](unsigned c) { return part[c]; });
    if (threadIdx.x == 0) {
      a.rr[lane] = rr;
      if (!dead_n) a.rz[lane] = rz_n;
      a.it[lane] += 1;
      a.dead[lane] = dead_n;
      a.active[lane] = !(rr <= a.thresh[lane]) && !dead_n;
    }
  }
  cluster_wait();
}

template <typename T>
using Kernel = void (*)(CgArgs<T>);

template <typename T>
Kernel<T> kernel_of(bool beta) {
  return beta ? &cg_beta_step_kernel<T> : &cg_alpha_step_kernel<T>;
}

cudaLaunchConfig_t cluster_config(unsigned blocks, int cluster, cudaStream_t stream,
                                  cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// A cluster above 8 blocks (non-portable) needs the kernel's leave.
template <typename T>
cudaError_t allow_cluster(Kernel<T> kern, int cluster) {
  if (cluster <= 8) return cudaSuccess;
  return cudaFuncSetAttribute(kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
}

template <typename T>
int step(bool beta, const CgHost* h, const void* v, int vec, void* stream) {
  if (h == nullptr || v == nullptr || h->lanes < 0 || h->n < 1 || h->cluster < 1 ||
      h->cluster > kMaxCluster || h->slice < 2 || (h->slice & 1) ||
      static_cast<long long>(h->slice) * h->cluster < h->n ||
      static_cast<long long>(h->slice) * h->cluster + 2LL * kThreads * kPairs > 0x7fffffffLL ||
      static_cast<long long>(h->lanes) * h->cluster > 0x7fffffffLL) {
    return cudaErrorInvalidValue;
  }
  if (h->lanes == 0) return cudaSuccess;
  CgArgs<T> a;
  a.x = static_cast<T*>(h->x);
  a.r = static_cast<T*>(h->r);
  a.p = static_cast<T*>(h->p);
  a.v = static_cast<const T*>(v);
  a.rz = static_cast<T*>(h->rz);
  a.rr = static_cast<T*>(h->rr);
  a.thresh = static_cast<const T*>(h->thresh);
  a.it = static_cast<long long*>(h->it);
  a.dead = static_cast<unsigned char*>(h->dead);
  a.active = static_cast<unsigned char*>(h->active);
  a.bad = static_cast<unsigned char*>(h->bad);
  a.part = static_cast<T*>(h->part);
  a.n = h->n;
  a.slice = h->slice;
  a.vec = vec != 0;
  const Kernel<T> kern = kernel_of<T>(beta);
  cudaError_t err = allow_cluster<T>(kern, h->cluster);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      cluster_config(static_cast<unsigned>(h->lanes) * h->cluster, h->cluster,
                     static_cast<cudaStream_t>(stream), &attr);
  err = cudaLaunchKernelEx(&cfg, kern, a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// (clusters resident at once on the device, registers a thread, local
// memory bytes a thread) of a kernel at a cluster size.
template <typename T>
int fit(bool beta, int cluster, int* out) {
  if (out == nullptr || cluster < 1 || cluster > kMaxCluster) return cudaErrorInvalidValue;
  const Kernel<T> kern = kernel_of<T>(beta);
  cudaFuncAttributes fa;
  cudaError_t err = cudaFuncGetAttributes(&fa, kern);
  if (err != cudaSuccess) return err;
  err = allow_cluster<T>(kern, cluster);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(cluster, cluster, nullptr, &attr);
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, reinterpret_cast<const void*>(kern), &cfg);
  if (err != cudaSuccess) return err;
  out[0] = clusters;
  out[1] = fa.numRegs;
  out[2] = static_cast<int>(fa.localSizeBytes);
  return cudaGetLastError();
}

}  // namespace

extern "C" int vbicm_cg_alpha_step_f32(const void* host, const void* kp, int vec, void* stream) {
  return step<float>(false, static_cast<const CgHost*>(host), kp, vec, stream);
}

extern "C" int vbicm_cg_alpha_step_f64(const void* host, const void* kp, int vec, void* stream) {
  return step<double>(false, static_cast<const CgHost*>(host), kp, vec, stream);
}

extern "C" int vbicm_cg_beta_step_f32(const void* host, const void* z, int vec, void* stream) {
  return step<float>(true, static_cast<const CgHost*>(host), z, vec, stream);
}

extern "C" int vbicm_cg_beta_step_f64(const void* host, const void* z, int vec, void* stream) {
  return step<double>(true, static_cast<const CgHost*>(host), z, vec, stream);
}

extern "C" int vbicm_cg_fit_f32(int beta, int cluster, int* out) {
  return fit<float>(beta != 0, cluster, out);
}

extern "C" int vbicm_cg_fit_f64(int beta, int cluster, int* out) {
  return fit<double>(beta != 0, cluster, out);
}

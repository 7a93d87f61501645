// Hat transfers of the two-level preconditioner for Hopper (sm_90a): the
// restriction R = P^T and the prolongation P between a structured grid and
// the grid refined r times an axis, on 2-D and 3-D grids.
//
// Replaces no TPU kernel: the JAX package's transfers are XLA convolutions
// (vbicm_tpu/ops/multigrid.py, make_grid_transfer_conv) and the port's plain
// version (ops/hat_transfer_kernel.py) applies each axis's 1-D hat matrix
// as a dense batched matrix product. On the H100 those products were cuBLAS
// GEMMs with two columns padded into 64x32 tiles against matrices with two
// nonzeros a row, 0.40 ms a call at (256, 160x80) and 46 % of a two-level
// CG step's device time (PERF.md). This kernel computes the same function.
//
// Layout: a sample is (nz, ny, nx, D) fine or (cz, cy, cx, D) coarse nodes,
// the slowest axis first and the D dofs of a node adjacent (nz = cz = 1 on
// a 2-D grid); fine node f and coarse node c of an axis carry the weight
// w = 1 - |f - r c| / r where that is positive, computed here from the
// indices in double precision and rounded to the working type, as the plain
// version's matrices are. A fine node takes at most two coarse taps an
// axis; a coarse node at most 2r - 1 fine taps.
//
// Order of operations, that of the plain version's products: prolongation
// the slowest axis first, restriction the fastest first, each axis's sum a
// chain of multiply-adds over the taps in increasing index (the first tap a
// product), every intermediate rounded to the working type. No atomics: each
// output is one thread's chain, so two launches give the same bits. Plain
// FMA arithmetic in the input's type (float32 or float64), no tensor cores.
//
// What bounds it on an H100: bytes. At (256, 160x80) in float32 one call
// moves 26.7 MB of fine and 1.8 MB of coarse values, 0.0085 ms at 3.35
// TB/s, against 4r multiply-adds a fine value, about 2 flops a byte.
//
// Design:
//   restriction (hat_restrict_kernel): a block takes one sample's tile of
//     tz coarse z-planes x ty coarse y-rows x every coarse x node. It
//     copies the tile's window of whole fine x lines, halo lines included,
//     into shared memory once, by cp.async a node (2 dofs) or a value (3)
//     at a time, a warp a line, so a warp reads consecutive addresses. Then
//     along x (a thread a (line, coarse node), consecutive threads on
//     consecutive lines: the lines take an odd number of 4- or 8-byte
//     slots, so those reads hit distinct banks), along y and along z (a
//     thread a coarse node, consecutive threads on consecutive nodes), the
//     last pass writing the coarse nodes out in order. Neighbouring tiles of
//     a sample are neighbouring blocks, so their shared halo lines are read
//     from the L2 the second time.
//   prolongation (hat_prolong_kernel): a block takes `lines` consecutive fine
//     x lines of one sample. Along z and y (a thread a (line, coarse x
//     node), the coarse values read through the cache: a sample's coarse
//     vector is a few KB) into shared memory, then along x, a thread a fine
//     node, written out in order.
//   ops/hat_transfer_kernel.py::launch_plan picks tz, ty and lines.
//
// The preconditioner's pair (hat_restrict_prec_kernel, hat_prolong_prec_kernel)
// is the same two bodies with the rest of the additive two-level cycle
// z = omega D^-1 (r m) + P K_c^-1 R (r m) m (ops/multigrid.py, m the fine free
// mask) folded in, so that a preconditioner call is these two launches around
// the coarse solve. They absorb what the composition ran as separate passes
// over the (B, n) fine vectors: r m and z_f m, omega D^-1, its product with
// r m and the sum, and on the coarse side the gather of the free dofs before
// the coarse solve and the embed (zeros at the supports) after it.
//   restriction: stages r m (plain loads of r and m in place of the
//     copies: a pass over the staged values after the copies took 13-18 %
//     longer on the 3-D grids on an H100), then the passes as above; the last
//     pass writes each coarse dof to its slot among the free ones (`slots`,
//     -1 at a support), a (B, nfree) vector in the coarse solve's order.
//   prolongation: reads that compact vector through the same slots (0 at a
//     support), and its epilogue reads r, D^-1 and m at each fine dof and
//     writes z = (omega D^-1) (r m) + z_f m.
// Bound: bytes. The pair reads r twice and D^-1 once and writes z once: at
// (256, 160x80) in float32 107 MB, 0.032 ms at 3.35 TB/s (the mask, the slot
// table and the compact coarse vectors are under 2 MB).
// Every product and the sum of the epilogue are rounded alone (__fmul_rn,
// __fadd_rn), in the composition's order: an FMA contraction would round
// once where PyTorch's separate kernels round twice, and the pair has to
// give the composition's bits. omega arrives as PyTorch multiplies by it:
// rounded to the working type.

#include <cuda_runtime.h>

#include <algorithm>
#include <cstddef>

namespace {

constexpr int kThreads = 256;

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

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float fma_rn(float a, float b, float c) { return __fmaf_rn(a, b, c); }
__device__ __forceinline__ double fma_rn(double a, double b, double c) { return __fma_rn(a, b, c); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }

// n / d by one multiply, exact for n * d < 2^32: m = ceil(2^32 / d), set on
// the host (launch checks the bound).
struct Div {
  unsigned d, m;
};

Div make_div(unsigned d) {
  return Div{d, d > 1 ? static_cast<unsigned>((0x100000000ull + d - 1) / d) : 0u};
}

__device__ __forceinline__ unsigned quo(unsigned n, Div v) {
  return v.d > 1 ? __umulhi(n, v.m) : n;
}

// Values a row of `nodes` nodes takes in shared memory: an odd number of
// slots, a slot being a node (two values) for D = 2 and a value for D = 3,
// so that threads on consecutive rows read distinct banks.
template <int D>
__host__ __device__ __forceinline__ int row_words(int nodes) {
  return D == 2 ? 2 * (nodes | 1) : ((D * nodes) | 1);
}

template <typename T, int D>
struct Node {
  T v[D];
};

// A node's D values at p (a node-aligned vector load for D = 2).
template <typename T, int D>
__device__ __forceinline__ Node<T, D> ld_node(const T* p) {
  Node<T, D> n;
  if constexpr (D == 2) {
    using V2 = typename Vec2<T>::type;
    const V2 v = *reinterpret_cast<const V2*>(p);
    n.v[0] = v.x;
    n.v[1] = v.y;
  } else {
#pragma unroll
    for (int d = 0; d < D; ++d) n.v[d] = p[d];
  }
  return n;
}

// The same through the read-only cache, for device memory.
template <typename T, int D>
__device__ __forceinline__ Node<T, D> ldg_node(const T* p) {
  Node<T, D> n;
  if constexpr (D == 2) {
    using V2 = typename Vec2<T>::type;
    const V2 v = __ldg(reinterpret_cast<const V2*>(p));
    n.v[0] = v.x;
    n.v[1] = v.y;
  } else {
#pragma unroll
    for (int d = 0; d < D; ++d) n.v[d] = __ldg(p + d);
  }
  return n;
}

template <typename T, int D>
__device__ __forceinline__ void st_node(T* p, const Node<T, D>& n) {
  if constexpr (D == 2) {
    using V2 = typename Vec2<T>::type;
    *reinterpret_cast<V2*>(p) = V2{n.v[0], n.v[1]};
  } else {
#pragma unroll
    for (int d = 0; d < D; ++d) p[d] = n.v[d];
  }
}

// acc = w * v (the chain's first tap) and acc = fma(w, v, acc), a dof each.
template <typename T, int D>
__device__ __forceinline__ Node<T, D> tap_first(T w, const Node<T, D>& v) {
  Node<T, D> out;
#pragma unroll
  for (int d = 0; d < D; ++d) out.v[d] = mul_rn(w, v.v[d]);
  return out;
}

template <typename T, int D>
__device__ __forceinline__ void tap(Node<T, D>& acc, T w, const Node<T, D>& v) {
#pragma unroll
  for (int d = 0; d < D; ++d) acc.v[d] = fma_rn(w, v.v[d], acc.v[d]);
}

// The chain over the fine taps f0 .. f1 of coarse node c along one axis:
// tap f's node at p0 + (f - f0) * stride.
template <typename T, int D>
__device__ __forceinline__ Node<T, D> restrict_chain(const T* p0, int stride, int f0, int f1,
                                                     int c, int r, const T* wtab) {
  Node<T, D> acc = tap_first<T, D>(wtab[abs(f0 - r * c)], ld_node<T, D>(p0));
  for (int f = f0 + 1; f <= f1; ++f)
    tap<T, D>(acc, wtab[abs(f - r * c)], ld_node<T, D>(p0 + (f - f0) * stride));
  return acc;
}

template <int kBytes>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (kBytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d), "l"(src),
                 "n"(kBytes));
  }
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The grid of one launch. nz = cz = 1 on a 2-D grid.
struct Grid {
  int r;           // ratio an axis
  int nz, ny, nx;  // fine nodes an axis, slowest first
  int cz, cy, cx;  // coarse nodes an axis
  int tz, ty;      // restriction: coarse z-planes and y-rows a block
  int lines;       // prolongation: fine x lines a block
  Div r_d, ny_d, nx_d, cx_d, ty_d, nl_d;  // nl: the restriction's window lines, at most
};

// What the preconditioner's pair adds to a launch (unused by the plain pair).
template <typename T>
struct Prec {
  const T* mask;     // (n_f,) the fine free mask, 0 or 1
  const int* slots;  // (n_c,) a coarse dof's index among the free ones, -1 at a support
  int nfree;         // free coarse dofs: the compact vectors' row
  const T* r;        // prolongation: (B, n_f) the residual and
  const T* dinv;     //   the Jacobi inverse diagonal
  T omega;
};

// Coarse node `node`'s D values of one sample: from the dense vector at
// `in`, or, for the preconditioner's pair, from the compact one through the
// slots (0 at a support).
template <typename T, int D, bool PREC>
__device__ __forceinline__ Node<T, D> ld_coarse(const T* in, size_t node, const Prec<T>& p) {
  if constexpr (PREC) {
    Node<T, D> n;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      const int k = __ldg(p.slots + node * D + d);
      n.v[d] = k >= 0 ? __ldg(in + k) : T(0);
    }
    return n;
  } else {
    return ldg_node<T, D>(in + node * D);
  }
}

// The same for a store: the preconditioner's pair keeps the free dofs only.
template <typename T, int D, bool PREC>
__device__ __forceinline__ void st_coarse(T* out, size_t node, const Node<T, D>& v,
                                          const Prec<T>& p) {
  if constexpr (PREC) {
#pragma unroll
    for (int d = 0; d < D; ++d) {
      const int k = __ldg(p.slots + node * D + d);
      if (k >= 0) out[k] = v.v[d];
    }
  } else {
    st_node<T, D>(out + node * D, v);
  }
}

// The restriction's window of fine lines a block, at most (whole tiles).
__host__ __device__ __forceinline__ int window(int fine, int r, int tiles) {
  const int w = r * tiles + r - 1;
  return fine < w ? fine : w;
}

// The restriction of one block; PREC: the preconditioner's (coarse: the
// compact free-dof vectors).
template <typename T, int NAX, int D, bool PREC>
__device__ __forceinline__ void restrict_body(const T* __restrict__ fine, T* __restrict__ coarse,
                                              const Grid& g, const Prec<T>& p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int r = g.r;
  const int tid = threadIdx.x;
  const int nby = (g.cy + g.ty - 1) / g.ty;
  const int nbz = (g.cz + g.tz - 1) / g.tz;
  const int by = blockIdx.x % nby;
  const int bz = (blockIdx.x / nby) % nbz;
  const int s = blockIdx.x / (nby * nbz);
  // this block's coarse tile and the window of fine lines it reads
  const int cz0 = bz * g.tz, cz1 = min(cz0 + g.tz, g.cz);
  const int cy0 = by * g.ty, cy1 = min(cy0 + g.ty, g.cy);
  const int fz0 = max(0, r * cz0 - r + 1), fz1 = min(g.nz - 1, r * (cz1 - 1) + r - 1);
  const int fy0 = max(0, r * cy0 - r + 1), fy1 = min(g.ny - 1, r * (cy1 - 1) + r - 1);
  const int wy = fy1 - fy0 + 1;
  const int nl = (fz1 - fz0 + 1) * wy;
  const int nlmax = window(g.nz, r, g.tz) * window(g.ny, r, g.ty);
  const int LF = row_words<D>(g.nx), LC = row_words<D>(g.cx);
  T* stage = reinterpret_cast<T*>(smem_raw);  // (nlmax, LF): line iz * wy + iy
  T* tx = stage + static_cast<size_t>(nlmax) * LF;  // (nlmax, LC)
  T* txy = tx + static_cast<size_t>(nlmax) * LC;    // three axes: (wz, ty, LC)
  T* wtab = txy + (NAX == 3 ? static_cast<size_t>(window(g.nz, r, g.tz)) * g.ty * LC : 0);
  const size_t nfine = static_cast<size_t>(g.nz) * g.ny * g.nx * D;
  const size_t ncoarse = PREC ? static_cast<size_t>(p.nfree)
                              : static_cast<size_t>(g.cz) * g.cy * g.cx * D;

  // 1. the window's fine lines, a warp a line
  {
    const int warp = tid >> 5, lane = tid & 31;
    for (int l = warp; l < nl; l += kThreads / 32) {
      const int iz = l / wy, iy = l - iz * wy;
      const size_t at = (static_cast<size_t>(fz0 + iz) * g.ny + fy0 + iy) * g.nx * D;
      const T* src = fine + s * nfine + at;
      T* dst = stage + static_cast<size_t>(l) * LF;
      if constexpr (PREC) {
        // r m as it is staged, the composition's one multiply: plain loads
        // of r and the mask, independent from one step to the next
        const T* m = p.mask + at;
        if constexpr (D == 2) {
#pragma unroll 4
          for (int n = lane; n < g.nx; n += 32) {
            const Node<T, D> a = ldg_node<T, D>(src + 2 * n), b = ldg_node<T, D>(m + 2 * n);
            st_node<T, D>(dst + 2 * n,
                          Node<T, D>{{mul_rn(a.v[0], b.v[0]), mul_rn(a.v[1], b.v[1])}});
          }
        } else {
#pragma unroll 4
          for (int k = lane; k < D * g.nx; k += 32) dst[k] = mul_rn(__ldg(src + k), __ldg(m + k));
        }
      } else if constexpr (D == 2) {
        for (int n = lane; n < g.nx; n += 32) cp_async<2 * sizeof(T)>(dst + 2 * n, src + 2 * n);
      } else {
        for (int k = lane; k < D * g.nx; k += 32) cp_async<sizeof(T)>(dst + k, src + k);
      }
    }
  }
  if (tid <= r) wtab[tid] = static_cast<T>(1.0 - static_cast<double>(tid) / r);
  cp_async_wait_all();
  __syncthreads();

  // 2. along x: tx[l][xc], consecutive threads on consecutive lines
  for (unsigned it = tid; it < static_cast<unsigned>(nlmax * g.cx); it += kThreads) {
    const int xc = static_cast<int>(quo(it, g.nl_d));
    const int l = static_cast<int>(it) - xc * nlmax;
    if (l >= nl) continue;
    const int x0 = max(0, r * xc - r + 1), x1 = min(g.nx - 1, r * xc + r - 1);
    st_node<T, D>(tx + static_cast<size_t>(l) * LC + D * xc,
                  restrict_chain<T, D>(stage + static_cast<size_t>(l) * LF + D * x0, D, x0, x1,
                                       xc, r, wtab));
  }
  __syncthreads();

  // 3. along y: a (z line, coarse row, coarse node) a thread; on a 2-D grid
  //    the coarse nodes themselves
  const int tyc = cy1 - cy0;
  const int wz = fz1 - fz0 + 1;
  for (unsigned it = tid; it < static_cast<unsigned>(wz * g.ty * g.cx); it += kThreads) {
    const unsigned q = quo(it, g.cx_d);
    const int xc = static_cast<int>(it - q * g.cx);
    const int iz = static_cast<int>(quo(q, g.ty_d));
    const int yl = static_cast<int>(q) - iz * g.ty;
    if (yl >= tyc) continue;
    const int yc = cy0 + yl;
    const int y0 = max(0, r * yc - r + 1), y1 = min(g.ny - 1, r * yc + r - 1);
    const Node<T, D> v = restrict_chain<T, D>(
        tx + static_cast<size_t>(iz * wy + y0 - fy0) * LC + D * xc, LC, y0, y1, yc, r, wtab);
    if constexpr (NAX == 2) {
      st_coarse<T, D, PREC>(coarse + s * ncoarse, static_cast<size_t>(yc) * g.cx + xc, v, p);
    } else {
      st_node<T, D>(txy + static_cast<size_t>(iz * g.ty + yl) * LC + D * xc, v);
    }
  }

  // 4. along z (three axes): a coarse node a thread
  if constexpr (NAX == 3) {
    __syncthreads();
    const int tzc = cz1 - cz0;
    for (unsigned it = tid; it < static_cast<unsigned>(g.tz * g.ty * g.cx); it += kThreads) {
      const unsigned q = quo(it, g.cx_d);
      const int xc = static_cast<int>(it - q * g.cx);
      const int zl = static_cast<int>(quo(q, g.ty_d));
      const int yl = static_cast<int>(q) - zl * g.ty;
      if (zl >= tzc || yl >= tyc) continue;
      const int zc = cz0 + zl, yc = cy0 + yl;
      const int z0 = max(0, r * zc - r + 1), z1 = min(g.nz - 1, r * zc + r - 1);
      const Node<T, D> v = restrict_chain<T, D>(
          txy + static_cast<size_t>((z0 - fz0) * g.ty + yl) * LC + D * xc, g.ty * LC, z0, z1, zc,
          r, wtab);
      st_coarse<T, D, PREC>(coarse + s * ncoarse,
                            (static_cast<size_t>(zc) * g.cy + yc) * g.cx + xc, v, p);
    }
  }
}

// The prolongation of one block; PREC: the preconditioner's (coarse: the
// compact free-dof vectors; fine: z = (omega D^-1) (r m) + (P z_c) m).
template <typename T, int NAX, int D, bool PREC>
__device__ __forceinline__ void prolong_body(const T* __restrict__ coarse, T* __restrict__ fine,
                                             const Grid& g, const Prec<T>& p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int r = g.r;
  const int tid = threadIdx.x;
  const int nlines = g.nz * g.ny;
  const int nb = (nlines + g.lines - 1) / g.lines;
  const int s = blockIdx.x / nb;
  const int L0 = (blockIdx.x - s * nb) * g.lines;
  const int nlb = min(g.lines, nlines - L0);
  const int LC = row_words<D>(g.cx);
  T* t = reinterpret_cast<T*>(smem_raw);  // (lines, LC)
  T* wtab = t + static_cast<size_t>(g.lines) * LC;
  const size_t nfine = static_cast<size_t>(g.nz) * g.ny * g.nx * D;
  const size_t ncoarse = PREC ? static_cast<size_t>(p.nfree)
                              : static_cast<size_t>(g.cz) * g.cy * g.cx * D;
  if (tid <= r) wtab[tid] = static_cast<T>(1.0 - static_cast<double>(tid) / r);
  __syncthreads();

  // 1. along z (three axes), then y: t[l][xc], a (line, coarse node) a thread
  const T* src = coarse + s * ncoarse;
  for (unsigned it = tid; it < static_cast<unsigned>(nlb * g.cx); it += kThreads) {
    const unsigned l = quo(it, g.cx_d);
    const int xc = static_cast<int>(it - l * g.cx);
    const unsigned L = L0 + l;
    const unsigned z = quo(L, g.ny_d);
    const int y = static_cast<int>(L - z * g.ny);
    const int yc = static_cast<int>(quo(y, g.r_d)), ry = y - yc * r;
    // the coarse node (zc, ycc, xc), along z first on three axes
    auto slow = [&](int ycc) {
      if constexpr (NAX == 2) {
        return ld_coarse<T, D, PREC>(src, static_cast<size_t>(ycc) * g.cx + xc, p);
      } else {
        const int zc = static_cast<int>(quo(z, g.r_d)), rz = static_cast<int>(z) - zc * r;
        const size_t node = (static_cast<size_t>(zc) * g.cy + ycc) * g.cx + xc;
        Node<T, D> a = tap_first<T, D>(wtab[rz], ld_coarse<T, D, PREC>(src, node, p));
        if (rz)
          tap<T, D>(a, wtab[r - rz],
                    ld_coarse<T, D, PREC>(src, node + static_cast<size_t>(g.cy) * g.cx, p));
        return a;
      }
    };
    Node<T, D> a = tap_first<T, D>(wtab[ry], slow(yc));
    if (ry) tap<T, D>(a, wtab[r - ry], slow(yc + 1));
    st_node<T, D>(t + static_cast<size_t>(l) * LC + D * xc, a);
  }
  __syncthreads();

  // 2. along x: a fine node a thread, written out in order
  const size_t at0 = static_cast<size_t>(L0) * g.nx * D;  // the block's first value in a sample
  T* dst = fine + s * nfine + at0;
  for (unsigned it = tid; it < static_cast<unsigned>(nlb * g.nx); it += kThreads) {
    const unsigned l = quo(it, g.nx_d);
    const int x = static_cast<int>(it - l * g.nx);
    const int xc = static_cast<int>(quo(x, g.r_d)), rx = x - xc * r;
    const T* row = t + static_cast<size_t>(l) * LC + D * xc;
    Node<T, D> a = tap_first<T, D>(wtab[rx], ld_node<T, D>(row));
    if (rx) tap<T, D>(a, wtab[r - rx], ld_node<T, D>(row + D));
    if constexpr (PREC) {
      // z = (omega D^-1) (r m) + z_f m, each product and the sum rounded
      const size_t at = at0 + static_cast<size_t>(it) * D;
      const Node<T, D> rv = ldg_node<T, D>(p.r + s * nfine + at);
      const Node<T, D> dv = ldg_node<T, D>(p.dinv + s * nfine + at);
      const Node<T, D> mv = ldg_node<T, D>(p.mask + at);
#pragma unroll
      for (int d = 0; d < D; ++d)
        a.v[d] = add_rn(mul_rn(mul_rn(p.omega, dv.v[d]), mul_rn(rv.v[d], mv.v[d])),
                        mul_rn(a.v[d], mv.v[d]));
    }
    st_node<T, D>(dst + static_cast<size_t>(it) * D, a);
  }
}

template <typename T, int NAX, int D>
__global__ void __launch_bounds__(kThreads)
    hat_restrict_kernel(const T* __restrict__ fine, T* __restrict__ coarse, Grid g) {
  restrict_body<T, NAX, D, false>(fine, coarse, g, Prec<T>{});
}

template <typename T, int NAX, int D>
__global__ void __launch_bounds__(kThreads)
    hat_prolong_kernel(const T* __restrict__ coarse, T* __restrict__ fine, Grid g) {
  prolong_body<T, NAX, D, false>(coarse, fine, g, Prec<T>{});
}

template <typename T, int NAX, int D>
__global__ void __launch_bounds__(kThreads)
    hat_restrict_prec_kernel(const T* __restrict__ fine, T* __restrict__ coarse, Grid g,
                             Prec<T> p) {
  restrict_body<T, NAX, D, true>(fine, coarse, g, p);
}

template <typename T, int NAX, int D>
__global__ void __launch_bounds__(kThreads)
    hat_prolong_prec_kernel(const T* __restrict__ coarse, T* __restrict__ fine, Grid g,
                            Prec<T> p) {
  prolong_body<T, NAX, D, true>(coarse, fine, g, p);
}

// Shared-memory values of a restriction block and of a prolongation block
// (ops/hat_transfer_kernel.py::smem_bytes repeats these).
template <int NAX, int D>
size_t restrict_words(const Grid& g) {
  const size_t wz = window(g.nz, g.r, g.tz), wy = window(g.ny, g.r, g.ty);
  return wz * wy * (row_words<D>(g.nx) + row_words<D>(g.cx)) +
         (NAX == 3 ? wz * g.ty * row_words<D>(g.cx) : 0) + g.r + 1;
}

template <int D>
size_t prolong_words(const Grid& g) {
  return static_cast<size_t>(g.lines) * row_words<D>(g.cx) + g.r + 1;
}

// cells: coarse cells an axis, slowest first (cz = 0 on a 2-D grid).
bool make_grid(int naxes, int r, int cz, int cy, int cx, int tz, int ty, int lines, Grid* g) {
  if ((naxes != 2 && naxes != 3) || r < 2 || cy < 1 || cx < 1 || tz < 1 || ty < 1 ||
      lines < 1 || (naxes == 2 ? (cz != 0 || tz != 1) : cz < 1))
    return false;
  g->r = r;
  g->cz = naxes == 3 ? cz + 1 : 1;
  g->cy = cy + 1;
  g->cx = cx + 1;
  g->nz = naxes == 3 ? cz * r + 1 : 1;
  g->ny = cy * r + 1;
  g->nx = cx * r + 1;
  g->tz = tz;
  g->ty = ty;
  g->lines = lines;
  // every quo() keeps n * d < 2^32: the largest numerator times the largest
  // divisor under 2^31
  const long long wz = window(g->nz, r, tz), nlmax = wz * window(g->ny, r, ty);
  const long long n = std::max({static_cast<long long>(g->nz) * g->ny,
                                static_cast<long long>(lines) * g->nx, nlmax * g->cx,
                                wz * ty * g->cx, static_cast<long long>(tz) * ty * g->cx});
  const long long d = std::max({static_cast<long long>(r), nlmax, static_cast<long long>(ty),
                                static_cast<long long>(g->nx), static_cast<long long>(g->ny),
                                static_cast<long long>(g->cx)});
  if (n * d >= (1LL << 31)) return false;
  g->r_d = make_div(r);
  g->ny_d = make_div(g->ny);
  g->nx_d = make_div(g->nx);
  g->cx_d = make_div(g->cx);
  g->ty_d = make_div(ty);
  g->nl_d = make_div(static_cast<unsigned>(nlmax));
  return true;
}

// Readies `kernel` for `smem` bytes of dynamic shared memory on the current
// device: above the default 48 KB it raises the kernel's limit, once a
// device (`raised` keeps the bytes set on each of the first kMaxDevices);
// cudaErrorInvalidValue where a block cannot have them or the grid is empty
// or too long.
constexpr int kMaxDevices = 64;

template <typename K>
int prepare(K kernel, long long blocks, size_t smem, size_t* raised) {
  if (blocks <= 0 || blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  if (smem <= 48 * 1024) return 0;
  int dev, optin;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < kMaxDevices && raised[dev] >= smem) return 0;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (smem > static_cast<size_t>(optin)) return static_cast<int>(cudaErrorInvalidValue);
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err == cudaSuccess && dev < kMaxDevices) raised[dev] = smem;
  return static_cast<int>(err);
}

template <typename T, int NAX, int D, bool PREC>
int restrict_launch(const void* fine, void* coarse, int B, int r, int cz, int cy, int cx, int tz,
                    int ty, const Prec<T>& p, void* stream) {
  Grid g;
  if (B <= 0 || !make_grid(NAX, r, cz, cy, cx, tz, ty, 1, &g))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = static_cast<long long>(B) * ((g.cz + tz - 1) / tz) *
                           ((g.cy + ty - 1) / ty);
  const size_t smem = restrict_words<NAX, D>(g) * sizeof(T);
  static size_t raised[kMaxDevices] = {};
  const auto in = static_cast<const T*>(fine);
  const auto out = static_cast<T*>(coarse);
  const auto st = static_cast<cudaStream_t>(stream);
  if constexpr (PREC) {
    auto* kernel = hat_restrict_prec_kernel<T, NAX, D>;
    const int err = prepare(kernel, blocks, smem, raised);
    if (err != 0) return err;
    kernel<<<static_cast<unsigned>(blocks), kThreads, smem, st>>>(in, out, g, p);
  } else {
    auto* kernel = hat_restrict_kernel<T, NAX, D>;
    const int err = prepare(kernel, blocks, smem, raised);
    if (err != 0) return err;
    kernel<<<static_cast<unsigned>(blocks), kThreads, smem, st>>>(in, out, g);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int NAX, int D, bool PREC>
int prolong_launch(const void* coarse, void* fine, int B, int r, int cz, int cy, int cx,
                   int lines, const Prec<T>& p, void* stream) {
  Grid g;
  if (B <= 0 || !make_grid(NAX, r, cz, cy, cx, 1, 1, lines, &g))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks =
      static_cast<long long>(B) * ((static_cast<long long>(g.nz) * g.ny + lines - 1) / lines);
  const size_t smem = prolong_words<D>(g) * sizeof(T);
  static size_t raised[kMaxDevices] = {};
  const auto in = static_cast<const T*>(coarse);
  const auto out = static_cast<T*>(fine);
  const auto st = static_cast<cudaStream_t>(stream);
  if constexpr (PREC) {
    auto* kernel = hat_prolong_prec_kernel<T, NAX, D>;
    const int err = prepare(kernel, blocks, smem, raised);
    if (err != 0) return err;
    kernel<<<static_cast<unsigned>(blocks), kThreads, smem, st>>>(in, out, g, p);
  } else {
    auto* kernel = hat_prolong_kernel<T, NAX, D>;
    const int err = prepare(kernel, blocks, smem, raised);
    if (err != 0) return err;
    kernel<<<static_cast<unsigned>(blocks), kThreads, smem, st>>>(in, out, g);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool PREC>
int restrict_dispatch(const void* fine, void* coarse, int B, int naxes, int ndof, int r, int cz,
                      int cy, int cx, int tz, int ty, const Prec<T>& p, void* stream) {
  if (naxes == 2 && ndof == 2)
    return restrict_launch<T, 2, 2, PREC>(fine, coarse, B, r, cz, cy, cx, tz, ty, p, stream);
  if (naxes == 2 && ndof == 3)
    return restrict_launch<T, 2, 3, PREC>(fine, coarse, B, r, cz, cy, cx, tz, ty, p, stream);
  if (naxes == 3 && ndof == 2)
    return restrict_launch<T, 3, 2, PREC>(fine, coarse, B, r, cz, cy, cx, tz, ty, p, stream);
  if (naxes == 3 && ndof == 3)
    return restrict_launch<T, 3, 3, PREC>(fine, coarse, B, r, cz, cy, cx, tz, ty, p, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T, bool PREC>
int prolong_dispatch(const void* coarse, void* fine, int B, int naxes, int ndof, int r, int cz,
                     int cy, int cx, int lines, const Prec<T>& p, void* stream) {
  if (naxes == 2 && ndof == 2)
    return prolong_launch<T, 2, 2, PREC>(coarse, fine, B, r, cz, cy, cx, lines, p, stream);
  if (naxes == 2 && ndof == 3)
    return prolong_launch<T, 2, 3, PREC>(coarse, fine, B, r, cz, cy, cx, lines, p, stream);
  if (naxes == 3 && ndof == 2)
    return prolong_launch<T, 3, 2, PREC>(coarse, fine, B, r, cz, cy, cx, lines, p, stream);
  if (naxes == 3 && ndof == 3)
    return prolong_launch<T, 3, 3, PREC>(coarse, fine, B, r, cz, cy, cx, lines, p, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The preconditioner's pair: a coarse vector of nfree free dofs a sample.
template <typename T>
Prec<T> make_prec(const void* mask, const void* slots, int nfree, const void* res,
                  const void* dinv, double omega) {
  return Prec<T>{static_cast<const T*>(mask), static_cast<const int*>(slots), nfree,
                 static_cast<const T*>(res), static_cast<const T*>(dinv),
                 static_cast<T>(omega)};
}

}  // namespace

// Plain C entry points, bound with ctypes. fine (B, ndof * prod(c * r + 1))
// and coarse (B, ndof * prod(c + 1)) are dense row-major on the current
// device, aligned to two values for ndof 2; (cz, cy, cx) are the coarse
// cells an axis, slowest first, cz = 0 on a 2-D grid (naxes 2). The
// restriction's blocks take tz coarse z-planes (1 on a 2-D grid) x ty
// coarse y-rows of one sample, the prolongation's `lines` fine x lines.
// Returns the CUDA error code of the launch (0 = success;
// cudaErrorInvalidValue for arguments the kernels do not take).
extern "C" int vbicm_hat_restrict_f32(const void* fine, void* coarse, int B, int naxes, int ndof,
                                      int r, int cz, int cy, int cx, int tz, int ty,
                                      void* stream) {
  return restrict_dispatch<float, false>(fine, coarse, B, naxes, ndof, r, cz, cy, cx, tz, ty, {},
                                         stream);
}

extern "C" int vbicm_hat_restrict_f64(const void* fine, void* coarse, int B, int naxes, int ndof,
                                      int r, int cz, int cy, int cx, int tz, int ty,
                                      void* stream) {
  return restrict_dispatch<double, false>(fine, coarse, B, naxes, ndof, r, cz, cy, cx, tz, ty, {},
                                          stream);
}

extern "C" int vbicm_hat_prolong_f32(const void* coarse, void* fine, int B, int naxes, int ndof,
                                     int r, int cz, int cy, int cx, int lines, void* stream) {
  return prolong_dispatch<float, false>(coarse, fine, B, naxes, ndof, r, cz, cy, cx, lines, {},
                                        stream);
}

extern "C" int vbicm_hat_prolong_f64(const void* coarse, void* fine, int B, int naxes, int ndof,
                                     int r, int cz, int cy, int cx, int lines, void* stream) {
  return prolong_dispatch<double, false>(coarse, fine, B, naxes, ndof, r, cz, cy, cx, lines, {},
                                         stream);
}

// The preconditioner's pair. mask (ndof * prod(c * r + 1)) is the fine free
// mask in the working type; slots (ndof * prod(c + 1)) int32 gives each
// coarse dof's index among the nfree free ones or -1; the coarse vectors are
// (B, nfree). The restriction writes R (fine mask) there; the prolongation
// reads them and writes z = (omega D^-1) (res mask) + (P coarse) mask, res
// and dinv (B, ndof * prod(c * r + 1)) like z, each aligned to two values
// for ndof 2.
extern "C" int vbicm_hat_restrict_prec_f32(const void* fine, const void* mask, const void* slots,
                                           void* coarse, int nfree, int B, int naxes, int ndof,
                                           int r, int cz, int cy, int cx, int tz, int ty,
                                           void* stream) {
  return restrict_dispatch<float, true>(fine, coarse, B, naxes, ndof, r, cz, cy, cx, tz, ty,
                                        make_prec<float>(mask, slots, nfree, nullptr, nullptr, 0),
                                        stream);
}

extern "C" int vbicm_hat_restrict_prec_f64(const void* fine, const void* mask, const void* slots,
                                           void* coarse, int nfree, int B, int naxes, int ndof,
                                           int r, int cz, int cy, int cx, int tz, int ty,
                                           void* stream) {
  return restrict_dispatch<double, true>(
      fine, coarse, B, naxes, ndof, r, cz, cy, cx, tz, ty,
      make_prec<double>(mask, slots, nfree, nullptr, nullptr, 0), stream);
}

extern "C" int vbicm_hat_prolong_prec_f32(const void* coarse, const void* slots, const void* res,
                                          const void* dinv, const void* mask, double omega,
                                          void* z, int nfree, int B, int naxes, int ndof, int r,
                                          int cz, int cy, int cx, int lines, void* stream) {
  return prolong_dispatch<float, true>(coarse, z, B, naxes, ndof, r, cz, cy, cx, lines,
                                       make_prec<float>(mask, slots, nfree, res, dinv, omega),
                                       stream);
}

extern "C" int vbicm_hat_prolong_prec_f64(const void* coarse, const void* slots, const void* res,
                                          const void* dinv, const void* mask, double omega,
                                          void* z, int nfree, int B, int naxes, int ndof, int r,
                                          int cz, int cy, int cx, int lines, void* stream) {
  return prolong_dispatch<double, true>(coarse, z, B, naxes, ndof, r, cz, cy, cx, lines,
                                        make_prec<double>(mask, slots, nfree, res, dinv, omega),
                                        stream);
}

// 3xTF32 building blocks for Hopper (sm_90a), shared by the kernels that run
// float32 products on the tensor cores at float32 accuracy
// (stencil_mxu.cu, spectral_apply.cu).
//
// Each float32 operand x is split into TF32 big and small parts,
// big = tf32(x), small = tf32(x - big) (round to nearest, ties away), and
// a product is accumulated in float32 as As Bb + Ab Bs + Ab Bb by the TF32
// m16n8k8 MMA: about 2e-7 of the result's scale from the exact product,
// where one TF32 pass gives 1e-3.

#pragma once

#include <cstdint>

namespace {

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// x -> TF32, as cvt.rna.tf32.f32 rounds it (to nearest at bit 13, ties away
// from zero; the same bits for every finite x), on the integer pipe: the
// conversion instruction measured slower in the spectral kernel.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// x -> (big, small) TF32 parts: big = tf32(x), small = tf32(x - big)
__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  big = to_tf32(x);
  small = to_tf32(x - __uint_as_float(big));
}

// d += a b on one m16n8k8 tile. Fragments (g = lane / 4, t4 = lane % 4):
// a0 (g, t4), a1 (g+8, t4), a2 (g, t4+4), a3 (g+8, t4+4); b0 (k t4, col g),
// b1 (k t4+4, col g); d0-d1 (g, 2t4..2t4+1), d2-d3 (g+8, 2t4..2t4+1).
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

}  // namespace

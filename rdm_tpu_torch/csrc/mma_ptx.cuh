// PTX helpers of the tensor-core kernels: shared-memory addresses and bf16
// packing (attn_mma.cuh, tma.cuh, micro_cf.cu), ldmatrix fragment loads and
// stmatrix fragment stores (micro_cf.cu's transpose),
// mma.sync.m16n8k16 in bfloat16 with a float32 sum (attn_mma.cuh,
// fused_resblock.cu, fused_attn_block.cu) and the wgmma descriptor of a
// 128-byte-swizzled operand (micro_cf.cu, fused_resblock.cu).  Everything
// sits in an unnamed namespace, so each translation unit gets its own copy.
#pragma once

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8 x 8 bf16 matrices from shared memory into the fragment layout of
// mma.m16n8k16 (lane l gives the address of row l % 8 of matrix l / 8);
// .trans hands each lane a column pair instead of a row pair.
__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

// The other way: four 8 x 8 bf16 matrices from the fragment layout (lane l
// holds row l / 4, columns 2 (l % 4) + {0, 1} of each) into shared memory,
// lane l giving the address of row l % 8 of matrix l / 8.  After
// ldmatrix_x4_trans it writes each matrix transposed.
__device__ __forceinline__ void stmatrix_x4(const unsigned (&r)[4], void* p) {
  asm volatile("stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};\n"
               ::"r"(smem_u32(p)), "r"(r[0]), "r"(r[1]), "r"(r[2]), "r"(r[3])
               : "memory");
}

// d (16 x 8 float) += a (16 x 16 bf16, row-major) b (16 x 8 bf16, column-major).
// Lane l holds d[0..1] at row l / 4, columns 2 (l % 4) + {0, 1}, and d[2..3]
// eight rows below.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// wgmma shared-memory descriptor of a 128-byte-swizzled operand: start
// address, leading and stride byte offsets (16-byte units), layout 1 (128B).
__device__ __forceinline__ uint64_t sw128_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// Two floats rounded to bfloat16 (nearest even), packed with lo in the low
// half: the order of a fragment register.
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&p);
}

}  // namespace

// Warp-level building blocks shared by the tensor-core kernels for Hopper
// (sm_90a): 16-byte asynchronous copies into shared memory, `ldmatrix`
// and `mma.sync.aligned.m16n8k16` with bf16 inputs and float32 sums.
//
// Fragment layout of m16n8k16 (PTX ISA), lane = 4·gid + tid:
//   A (16×16, row): a0 = A[gid][2tid..+1],   a1 = A[gid+8][2tid..+1],
//                   a2 = A[gid][2tid+8..+9], a3 = A[gid+8][2tid+8..+9];
//   B (16×8, col):  b0 = B[2tid..+1][gid],   b1 = B[2tid+8..+9][gid];
//   C (16×8):       c0, c1 = C[gid][2tid..+1], c2, c3 = C[gid+8][2tid..+1];
// each 32-bit register holds two bf16, the lower index in the low half.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace sm90 {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global → shared, asynchronously; src_bytes = 0 writes zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes = 16) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's copy groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// d += A(16×16, row) · B(16×8, col), bf16 in, float32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Four 8×8 bf16 matrices from shared memory, transposed: lane l gives the
// row address of matrix l/8, row l%8, and receives element pairs of
// column l/4 of each matrix (rows 2(l%4), 2(l%4)+1).
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t& r0, uint32_t& r1,
                                                  uint32_t& r2, uint32_t& r3,
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(smem_u32(p))
      : "memory");
}

__device__ __forceinline__ uint32_t lds_u32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

}  // namespace sm90

// Plain quantized GEMM for Hopper (sm_90a): x (M, K) bf16 times one packed
// lo-tier weight (K/epb, N) uint8 with bf16 scales (K/g, N) → (M, N) bf16.
//
// Replaces the Pallas kernel `_qmm_kernel` of `quant_matmul` in
// src/repro/kernels/quant_matmul.py (the entry point `ops.quant_matmul_op`).
// The reference dequantizes first (code · scale rounded to float32), then
// dots in float32. This kernel uses the group-blocked rule of the MoE
// kernels instead: Σ_g s_g · (x_g · q_g), a float32 partial dot of exact
// products per scale group, scaled by `fmaf` into a float32 accumulator,
// one bf16 rounding at the end. The two differ only at float32 rounding.
//
// What bounds it on this card. At the reference's case (M = 128, K = 2048,
// N = 768) the bytes (activations 0.5 MB, int4 codes 0.8 MB, output 0.2 MB)
// and the operations (0.4 GFLOP) both take under a microsecond at the data
// sheet's rates: what it can reach is set by the length of the serial
// chain of k16 steps one warp walks, and by how many SMs have work.
//
// Design: the grouped GEMM's kernel (`qmma::gemm_kernel`, `quant_gemm.cuh`,
// the ragged FFN's swap-AB main loop) at E = 1 and C = M, with K cut into
// S ranges of whole scale groups across grid.y so that about one wave of
// CTAs covers the SMs (M = 128 without a split is 6 × 16/NT CTAs). With
// S > 1 each CTA writes float32 partials to a scratch (S, M, N) that the
// wrapper allocates, and a second small kernel adds the S partials in
// order and rounds once: no atomics, the result is deterministic. The
// caller picks NT and S by shape alone: `ops.gemm_plan`.
#include <cuda_runtime.h>

#include "quant_gemm.cuh"

extern "C" {

// out (M, N) = x (M, K) · dequant(packed, scales) by the group-blocked
// rule, in NT·8-row passes and n_split K ranges of gps scale groups
// (scratch: float32 (n_split, M, N) when n_split > 1), each walked in
// pieces of gpc groups; the limits of `grouped_quant_matmul`.
int quant_matmul(const void* x, const void* packed, const void* scales,
                 void* out, void* scratch, int M, int K, int N, int bits,
                 int group, int nt, int n_split, int gps, int gpc,
                 void* stream) {
  return qmma::gemm(bits, nt, x, packed, scales, out, scratch, 1, M, K, N,
                    group, n_split, gps, gpc,
                    static_cast<cudaStream_t>(stream));
}

}  // extern "C"

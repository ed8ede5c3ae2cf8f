// Grouped quantized GEMM of the padded MoE dispatch for Hopper (sm_90a).
//
// Replaces the Pallas kernel `_gqmm_kernel` of `grouped_quant_matmul` in
// src/repro/kernels/quant_matmul.py: xg (E, C, K) bf16 times each expert's
// packed lo codes (E, K/epb, N) uint8 with bf16 scales (E, K/g, N), giving
// (E, C, N) bf16 — the expert GEMM of the padded (E, C, d) layout, three
// calls per MoE layer. Arithmetic is the reference's group-blocked rule: per
// scale group a float32 partial dot of bf16 activations and integer codes
// (exact products), multiplied by the group's scale into a float32
// accumulator; one bf16 rounding at the end.
//
// What bounds it on this card. The padded layout computes every expert,
// whether or not a token reached it. At decode (C = 8) each code byte serves
// 8 rows, about 2·8·(8/bits) operations per byte, far below the ~295
// operations per byte where the H100's tensor cores overtake its 3.35 TB/s
// of HBM: the kernel is bound by the bytes of ALL E experts' codes and
// scales (int4, K = 2048, N = 768, E = 128: ~112 MB per call, ~34 µs). At a
// prefill capacity (C = 136) it does 17× the operations on the same bytes
// and sits near the crossover.
//
// Design: the ragged FFN's swap-AB main loop (`qmma::tile_product`,
// `quant_mma.cuh`) run by `qmma::gemm_kernel` (`quant_gemm.cuh`) with the
// implicit tile map "tile t is expert t". One CTA per (expert, NT·8 rows,
// 128 columns), 4 warps of 32 columns (two m16 blocks that share each B
// fragment), column blocks fastest; each warp streams its columns' codes
// through a private 4-stage `cp.async` ring, decodes them in registers and
// multiplies each decoded A fragment with NT chunks of 8 rows on
// `mma.sync.m16n8k16` (the weight's 16 columns are the mma's M, 8 rows its
// N). The activation rows sit in shared memory, walked along K in pieces so
// that several CTAs share an SM; no reduction across warps. Rows at or
// past C are zero-filled in shared memory and never stored, so any C
// works. The caller picks NT, the pieces (and a split of K across CTAs,
// used when few CTAs would run) by shape alone: `ops.gemm_plan`.
#include <cuda_runtime.h>

#include "quant_gemm.cuh"

extern "C" {

// out (E, C, N) = xg (E, C, K) · dequant(packed, scales) per expert, by the
// group-blocked rule, in NT·8-row passes and n_split K ranges of gps scale
// groups (scratch: float32 (n_split, E, C, N) when n_split > 1), each
// walked in pieces of gpc groups. bits in {2, 4, 8}, nt in {1, 2, 4}, N a
// multiple of 64, group a multiple of 16, K a multiple of group; xg,
// packed and scales 16-byte aligned.
int grouped_quant_matmul(const void* xg, const void* packed,
                         const void* scales, void* out, void* scratch, int E,
                         int C, int K, int N, int bits, int group, int nt,
                         int n_split, int gps, int gpc, void* stream) {
  return qmma::gemm(bits, nt, xg, packed, scales, out, scratch, E, C, K, N,
                    group, n_split, gps, gpc,
                    static_cast<cudaStream_t>(stream));
}

}  // extern "C"

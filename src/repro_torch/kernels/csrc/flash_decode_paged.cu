// Paged one-query GQA flash decode for Hopper (sm_90a): split-KV
// flash-decoding through a block table.
//
// Replaces the Pallas kernel `_fd_paged_kernel` of `flash_decode_paged` in
// src/repro/kernels/flash_decode.py: attention of one query token per row
// over the (N, Hkv, bt, hd) physical KV block pool through a (B, nb) block
// table. Entries of -1 read block 0 and are masked out through `valid`
// (B, nb·bt); a row with no valid slot writes zeros.
//
// What bounds it on this card. Each K/V element is used by the rep = H/Hkv
// query heads of its group only, about 2·rep operations per 2-byte element:
// far below the ~295 operations per byte where the tensor cores take over,
// so the kernel is bound by the bytes of the K/V blocks it must read. At
// decode sizes that is a few MB, a couple of microseconds at 3.35 TB/s, so
// what decides its time is how many loads are in flight at once and how
// little sits between them. The design (device code in
// flash_decode_common.cuh):
//
// 1. Split-KV across CTAs. The grid is (B·Hkv, n_split): CTA (b, g, s)
//    takes tiles [s·tps, (s+1)·tps) of the row's nb blocks (a tile is one
//    bt-token block) for all rep query heads of KV head g, so each K/V
//    byte still leaves device memory once, and writes float32 partials
//    (m, l, acc[rep][hd]) to scratch that the wrapper allocates. A second
//    kernel merges the splits; with one split the first kernel writes the
//    bf16 output and the merge is not launched. n_split is a function of
//    the shapes only (`ops.decode_splits`: about one CTA per SM over the
//    B·Hkv groups, at least two tiles per split, a whole number of tiles
//    per warp past four; more splits cost more in the merge than they gain
//    on the H100), so results do not depend on
//    data or timing.
// 2. Only masked tiles are skipped: a block whose `valid` slots are all
//    false is not copied, dotted or folded into the softmax. The table
//    alone skips nothing: a vacant decode row has a table of -1 and
//    valid[0] true, and attends block 0 as the plain version does.
// 3. Asynchronous copies: each warp of the CTA takes every 4th tile of the
//    split, and its K/V blocks arrive bf16 by 16-byte `cp.async` copies into
//    a per-warp ring of up to 3 stages, waited on with
//    `cp.async.wait_group` and `__syncwarp` instead of block-wide barriers.
// 4. Tensor-core dots: `mma.sync.aligned.m16n8k16` bf16 with float32
//    accumulation, the group's query heads as the M rows (`wgmma` needs 64
//    rows; a decode group has at most 16). The warps merge (m, l, acc)
//    through shared memory once at the end.
//
// Shapes taken: hd ∈ {64, 128, 256} (register tiles sized at compile
// time), rep ≤ 16, bt a multiple of 16 with bt·hd ≤ 8192 (one block of K
// and V per warp stage in shared memory; `valid` is read 32 slots per warp
// ballot, so a block of up to 128 slots is masked slot by slot).
#include "flash_decode_common.cuh"

namespace {

// Tiles of one (row, KV head): block t of the row's table.
struct PagedSrc {
  const int32_t* table;                   // the row's nb entries
  const bool* valid;                      // the row's nb·bt slots
  long long head_off;                     // g · bt · hd
  long long block_elems;                  // Hkv · bt · hd
  int rows;                               // bt
  long long step;                         // hd
  __device__ int len(int) const { return rows; }
  __device__ bool ok(int t, int j) const {
    return valid[(size_t)t * rows + j];
  }
  __device__ long long base(int t) const {
    const int blk = table[t];
    return (long long)(blk < 0 ? 0 : blk) * block_elems + head_off;
  }
};

template <int HD>
__global__ void __launch_bounds__(fd::THREADS)
    fd_paged_split_kernel(const __nv_bfloat16* __restrict__ q,
                          const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v,
                          const int32_t* __restrict__ table,
                          const bool* __restrict__ valid,
                          __nv_bfloat16* __restrict__ out,
                          float* __restrict__ part_acc,
                          float* __restrict__ part_ml, int H, int Hkv,
                          int bt, int nb, int n_split, int tps, int stages,
                          float scale_log2) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int bg = blockIdx.x, s = blockIdx.y;
  const int b = bg / Hkv, g = bg % Hkv, rep = H / Hkv;
  PagedSrc src{table + (size_t)b * nb, valid + (size_t)b * nb * bt,
               (long long)g * bt * HD, (long long)Hkv * bt * HD, bt, HD};
  const int t0 = s * tps, t1 = min(nb, t0 + tps);
  const size_t head = ((size_t)b * H + (size_t)g * rep) * HD;
  const size_t part = ((size_t)bg * n_split + s) * rep;
  fd::split_attend<HD>(
      src, q + head, k, v, rep, t0, t1, stages, scale_log2,
      n_split == 1 ? out + head : nullptr,
      n_split == 1 ? nullptr : part_acc + part * HD,
      n_split == 1 ? nullptr : part_ml + part * 2, smem);
}

template <int HD>
int launch(const void* q, const void* k, const void* v, const void* table,
           const void* valid, void* out, void* part_acc, void* part_ml,
           int B, int H, int Hkv, int bt, int nb, int n_split, int tps,
           float scale, cudaStream_t stream) {
  static bool attr_set = false;           // once per instantiation
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(
        fd_paged_split_kernel<HD>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)fd::SMEM_MAX);
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  const int stages = fd::ring_stages(bt, HD, tps);
  if (stages < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = fd::WARPS * stages * fd::stage_bytes(bt, HD);
  dim3 grid(B * Hkv, n_split);
  fd_paged_split_kernel<HD><<<grid, fd::THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<const int32_t*>(table), static_cast<const bool*>(valid),
      static_cast<__nv_bfloat16*>(out), static_cast<float*>(part_acc),
      static_cast<float*>(part_ml), H, Hkv, bt, nb, n_split, tps, stages,
      scale * fd::LOG2E);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)fd::launch_merge(static_cast<const float*>(part_acc),
                               static_cast<const float*>(part_ml),
                               static_cast<__nv_bfloat16*>(out), B, H, Hkv,
                               HD, n_split, stream);
}

}  // namespace

extern "C" {

// out (B, H, hd) = softmax(q·kᵀ/√hd masked by valid) · v over the blocks
// named by table; q (B, H, hd), k/v (N, Hkv, bt, hd) bf16, table (B, nb)
// int32, valid (B, nb·bt) bool; scale = hd^-1/2 as the caller rounds it.
// dims = {B, H, Hkv, bt, hd, nb, n_split, tps}: n_split CTAs per (row, KV
// head) of tps blocks each (the last may hold fewer). With n_split > 1,
// scratch holds the float32 partials, acc (B·Hkv, n_split, rep, hd) then
// (m, l) (B·Hkv, n_split, rep, 2), and a second kernel merges them.
int flash_decode_paged(const void* q, const void* k, const void* v,
                       const void* table, const void* valid, void* out,
                       void* scratch, const long long* dims, float scale,
                       void* stream) {
  const int B = (int)dims[0], H = (int)dims[1], Hkv = (int)dims[2],
            bt = (int)dims[3], hd = (int)dims[4], nb = (int)dims[5],
            n_split = (int)dims[6], tps = (int)dims[7];
  if (B == 0) return 0;
  if (Hkv < 1 || H % Hkv != 0 || H / Hkv > 16 || bt % 16 != 0 || bt < 16 ||
      bt * hd > 8192 || n_split < 1 || tps < 1 ||
      (n_split > 1 && scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  float* part_acc = static_cast<float*>(scratch);
  float* part_ml = n_split > 1
      ? part_acc + (size_t)B * Hkv * n_split * (H / Hkv) * hd : nullptr;
  auto s = static_cast<cudaStream_t>(stream);
#define FD_CASE(HD)                                                        \
  case HD:                                                                 \
    return launch<HD>(q, k, v, table, valid, out, part_acc, part_ml, B,    \
                      H, Hkv, bt, nb, n_split, tps, scale, s);
  switch (hd) {
    FD_CASE(64)
    FD_CASE(128)
    FD_CASE(256)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef FD_CASE
}

}  // extern "C"

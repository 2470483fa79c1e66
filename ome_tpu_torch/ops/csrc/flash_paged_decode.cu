// Paged decode attention for Hopper: one query token per sequence, GQA,
// over a block pool of KV rows [N, bs, K, D] addressed through a per-
// sequence block table [B, M], restricted to the sequence rows [lo, hi).
// The pool may hold bf16, fp32 or int8 rows; int8 pools carry f32
// per-(row, head) scales in the S-minor layout [N, K, bs].
//
// Replaces two TPU kernels that share one body (_decode_kernel):
//   * B3 ome_tpu/ops/paged.py::paged_flash_decode, whose BlockSpec index
//     maps fetch sequence block j from pool block table[b, j];
//   * B5 ome_tpu/ops/flash.py::flash_decode_quantized (_flash_decode with
//     quantized=True): a dense int8 cache [B, S, K, D] with scales
//     [B, K, S] is this kernel's pool of B blocks of S rows, with
//     table[b, 0] = b.
//
// Bound on an H100: the bytes of the K/V rows in [lo, hi), 1 byte per
// element for int8 plus 2 x 4 bytes of scales per row and head, read once
// per KV head (0.0144 ms for the bf16 pool's main case, 0.0074 for int8).
// The kernel is the decode core (decode_core.cuh), which says what the
// design does about that bound, with the paged row address: sequence row
// r of sequence b is pool row table[b, r / bs] * bs + r % bs. A bf16 query
// over a bf16 or int8 pool runs decode_tc (TMA ring, wgmma, a tile of 64
// rows loaded as one 64-row box per pool block when bs % 64 == 0, else as
// two 32-row boxes, so a box never straddles two pool blocks); fp32 runs
// decode_scalar. hi is clamped to M * bs, so the table is never read out
// of bounds; a free engine slot whose length outgrew its (all trash-block)
// table row reads the trash block and stays finite.
//
// Built with nvcc into a shared library with a plain C interface (see
// ome_tpu_torch/ops/_build.py) and called through ctypes.

#include "decode_core.cuh"

namespace {

template <int D>
cudaError_t dispatch_d(const DecodeArgs& a, bool q_bf16, bool kv_int8) {
  if (q_bf16)
    return kv_int8 ? dispatch_tc<D, true, true>(a)
                   : dispatch_tc<D, false, true>(a);
  return kv_int8 ? dispatch_scalar<int8_t, D, true>(a)
                 : dispatch_scalar<float, D, true>(a);
}

}  // namespace

// q [B, H, D] (bf16 or fp32; D 64, 96, 128 or 256); k_pool, v_pool
// [N, bs, K, D] in q's dtype, or int8 with k_scale, v_scale [N, K, bs]
// fp32 (NULL otherwise);
// table [B, M] int32 pool block ids; lo, hi [B] int32 sequence rows
// [lo, hi) to attend (lo NULL: 0); out [B, H, D] in q's dtype. part:
// fp32 workspace of G (D + 4) floats per unit, for every unit the
// windows can have (B K ceil(M bs / unit_rows)); cnt [B K] int32, all 0
// (each launch leaves it so). unit_rows and grid are ops/flash.py::
// decode_plan's. softcap <= 0 disables the softcap. Returns the CUDA
// error code of the launch.
extern "C" int ome_flash_paged_decode(
    const void* q, const void* k_pool, const void* v_pool,
    const float* k_scale, const float* v_scale, const int* table,
    const int* lo, const int* hi, void* out, float* part, int* cnt, int B,
    int N, int bs, int M, int H, int K, int D, int unit_rows, int grid,
    float scale, float softcap, int is_bf16, int kv_int8, void* stream) {
  if (K <= 0 || H % K != 0 || M < 1 || N < 1 || bs <= 0 || bs % 32 != 0 ||
      (kv_int8 && (k_scale == nullptr || v_scale == nullptr)) ||
      part == nullptr || cnt == nullptr)
    return cudaErrorInvalidValue;
  Geo g{};
  g.B = B;
  g.H = H;
  g.K = K;
  g.G = H / K;
  g.limit = M * bs;
  g.unit_rows = unit_rows;
  g.bs = bs;
  g.M = M;
  g.box_rows = bs % kTileRows == 0 ? kTileRows : 32;
  if (!decode_geo_ok(g, D, grid)) return cudaErrorInvalidValue;
  // no sinks: paged KV is refused for gpt-oss, as in the reference
  const DecodeArgs a{q,    k_pool, v_pool, k_scale, v_scale, table,
                     lo,   hi,     out,    part,    cnt,     nullptr,
                     (long)N * bs, g,      grid,    scale,   softcap,
                     static_cast<cudaStream_t>(stream)};
  switch (D) {
    case 64: return dispatch_d<64>(a, is_bf16, kv_int8);
    case 96: return dispatch_d<96>(a, is_bf16, kv_int8);
    case 128: return dispatch_d<128>(a, is_bf16, kv_int8);
    default: return dispatch_d<256>(a, is_bf16, kv_int8);
  }
}

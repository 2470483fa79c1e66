// Decode attention for Hopper: one query token per sequence, GQA, over a
// dense KV cache [B, S, K, D], restricted to the rows [lo, hi) of each
// sequence.
//
// Replaces ome_tpu/ops/flash.py::_flash_decode (kernel body
// _decode_kernel). Bound on an H100: the bytes of the K/V rows in
// [lo, hi), read once per KV head (0.0093 ms for the main case: 8
// sequences of up to 4095 rows at the Llama-3-8B widths). The kernel is
// the decode core (decode_core.cuh), which says what the design does
// about that bound, with the dense row address: sequence row r of
// sequence b is cache row b * S + r. bf16 runs decode_tc (TMA ring of
// 64-row tiles, wgmma); any S is taken: a tile that runs past S reads the
// next sequence's rows, or TMA's zero fill past the last one, and masks
// them. fp32 runs decode_scalar, whose copies read only rows in [lo, hi).
//
// Built with nvcc into a shared library with a plain C interface (see
// ome_tpu_torch/ops/_build.py) and called through ctypes.

#include "decode_core.cuh"

namespace {

template <int D>
cudaError_t dispatch_d(const DecodeArgs& a, bool q_bf16) {
  return q_bf16 ? dispatch_tc<D, false, false>(a)
                : dispatch_scalar<float, D, false>(a);
}

}  // namespace

// q [B, H, D]; k, v [B, S, K, D] (contiguous, same dtype, bf16 or fp32;
// D 64, 96, 128 or 256); lo, hi [B] int32; out [B, H, D]. part: fp32
// workspace of G (D + 4) floats per unit, for every unit the windows can
// have (B K ceil(S / unit_rows)); cnt [B K] int32, all 0 (each launch
// leaves it so).
// unit_rows and grid are ops/flash.py::decode_plan's. softcap <= 0
// disables the softcap. sinks: [H] fp32 per-head sink logits (gpt-oss),
// or NULL. Returns the CUDA error code of the launch.
extern "C" int ome_flash_decode(const void* q, const void* k, const void* v,
                                const int* lo, const int* hi, void* out,
                                float* part, int* cnt, const float* sinks,
                                int B, int S, int H, int K, int D,
                                int unit_rows, int grid, float scale,
                                float softcap, int is_bf16, void* stream) {
  if (K <= 0 || H % K != 0 || S < 1 || part == nullptr || cnt == nullptr)
    return cudaErrorInvalidValue;
  Geo g{};
  g.B = B;
  g.H = H;
  g.K = K;
  g.G = H / K;
  g.limit = S;
  g.unit_rows = unit_rows;
  g.S = S;
  g.box_rows = kTileRows;
  if (!decode_geo_ok(g, D, grid)) return cudaErrorInvalidValue;
  const DecodeArgs a{q,    k,     v,       nullptr, nullptr,
                     nullptr, lo, hi,   out,     part,
                     cnt,  sinks, (long)B * S, g,   grid,
                     scale, softcap, static_cast<cudaStream_t>(stream)};
  switch (D) {
    case 64: return dispatch_d<64>(a, is_bf16);
    case 96: return dispatch_d<96>(a, is_bf16);
    case 128: return dispatch_d<128>(a, is_bf16);
    default: return dispatch_d<256>(a, is_bf16);
  }
}

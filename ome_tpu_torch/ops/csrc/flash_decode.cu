// Decode attention for Hopper: one query token per sequence, GQA, over a
// dense KV cache [B, S, K, D], restricted to the rows [lo, hi) of each
// sequence.
//
// Replaces ome_tpu/ops/flash.py::_flash_decode (kernel body
// _decode_kernel). Same function: the G = H/K query heads of one KV head
// share every K/V row the block reads, the optional tanh softcap is
// applied to the scaled logits, and the softmax state (m, l, acc) is fp32
// with the finite M_INIT = -1e30 start and the l >= 1e-30 clamp, so an
// empty or one-row window gives a finite result.
//
// What bounds it on an H100: the bytes of the K/V rows in [lo, hi) read
// from device memory (decode does ~2*G flops per K/V byte, far below the
// ~295 flops/byte at which the tensor cores become the limit). The design
// answers that bound in four ways:
//   * only rows inside [lo, hi) are ever loaded (the counterpart of the
//     TPU kernel's clamped block index maps, which skip the DMA);
//   * each row is read once per KV head, staged in shared memory, and
//     used there by all G query heads of that head;
//   * split-KV (flash-decoding): each (sequence, KV head) window is cut
//     into n_split pieces of whole 32-row tiles walked by separate
//     blocks, and a second small kernel merges the partial (m, l, acc)
//     triples, so a batch of 8 sequences x 8 KV heads still puts many
//     blocks on every SM and a long sequence is not walked by one block;
//   * tiles are copied with cp.async, double-buffered in bf16, so the
//     next tile is in flight while the current one is scored; the online
//     softmax takes one max and one sum per 32-row tile, not per row.
//
// Built with nvcc into a shared library with a plain C interface (see
// ome_tpu_torch/ops/_build.py) and called through ctypes.

#include "common.cuh"

namespace {

// Pass 1: one block per (split, kv head, sequence), one warp per query
// head of the KV head (G warps). The block walks its rows in tiles of 32:
// the whole block stages each K/V tile in shared memory with cp.async
// (two stages for bf16, so the next tile loads while this one is used),
// then in warp g lane r scores row r for head g, one max and one sum per
// tile update the online softmax, and lane r accumulates dims
// [r * D/32, (r + 1) * D/32) of P V. Writes the block's (m, l, acc) per
// query head to the workspace.
template <typename T, int D, int G>
__global__ void __launch_bounds__(G * 32)
decode_partial(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const int* __restrict__ lo_arr,
               const int* __restrict__ hi_arr, float* __restrict__ part_m,
               float* __restrict__ part_l, float* __restrict__ part_acc,
               int S, int H, int K, int n_split, float scale,
               float softcap) {
  constexpr int TR = 32;                     // rows per tile
  constexpr int NT = G * 32;                 // threads
  constexpr int EPC = 16 / sizeof(T);        // elements per 16-byte chunk
  constexpr int CPR = D / EPC;               // chunks per row
  constexpr int RS = D + EPC;                // padded smem row (elements)
  constexpr int STAGES = sizeof(T) == 2 ? 2 : 1;
  constexpr int VEC = D / 32;                // output dims per lane
  __shared__ __align__(16) T Ks[STAGES][TR][RS];
  __shared__ __align__(16) T Vs[STAGES][TR][RS];
  __shared__ __align__(16) float qs[G][D];
  __shared__ float ps[G][TR];

  const int split = blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
  const int g = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int lo = max(lo_arr[b], 0);
  const int hi = min(hi_arr[b], S);
  const int len = max(hi - lo, 0);
  // whole tiles per split, so only the last tile of a window is ragged
  const int chunk = ((len + n_split - 1) / n_split + TR - 1) / TR * TR;
  const int r0 = lo + split * chunk;
  const int r1 = min(r0 + chunk, hi);
  const int ntiles = r1 > r0 ? (r1 - r0 + TR - 1) / TR : 0;

  for (int i = threadIdx.x; i < G * D; i += NT)
    qs[i / D][i % D] =
        to_float(q[((size_t)b * H + kh * G + i / D) * D + i % D]) * scale;

  const size_t head_off = ((size_t)b * S * K + kh) * D;
  auto load_tile = [&](int t, int buf) {
    const int row0 = r0 + t * TR;
    for (int idx = threadIdx.x; idx < TR * CPR; idx += NT) {
      const int r = idx / CPR, c = (idx % CPR) * EPC;
      const int row = row0 + r;
      const bool ok = row < r1;
      const size_t off = head_off + (size_t)(ok ? row : 0) * K * D + c;
      cp_async16(&Ks[buf][r][c], k + off, ok ? 16 : 0);
      cp_async16(&Vs[buf][r][c], v + off, ok ? 16 : 0);
    }
    cp_async_commit();
  };

  float m = kMInit, l = 0.f, acc[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) acc[i] = 0.f;

  if (ntiles > 0) load_tile(0, 0);
  for (int t = 0; t < ntiles; ++t) {
    const int buf = STAGES == 2 ? (t & 1) : 0;
    if (STAGES == 2 && t + 1 < ntiles) {
      load_tile(t + 1, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile t (and qs) visible to every thread

    const int row = r0 + t * TR + lane;
    const bool valid = row < r1;
    float s = 0.f;
#pragma unroll
    for (int c = 0; c < D; c += EPC) {
      float kf[EPC];
      load_chunk(&Ks[buf][lane][c], kf);
#pragma unroll
      for (int e = 0; e < EPC; ++e) s = fmaf(qs[g][c + e], kf[e], s);
    }
    if (softcap > 0.f) s = tanhf(s / softcap) * softcap;
    const float m_new = fmaxf(m, warp_max(valid ? s : kMInit));
    const float alpha = expf(m - m_new);
    const float p = valid ? expf(s - m_new) : 0.f;
    l = l * alpha + warp_sum(p);
    m = m_new;
    ps[g][lane] = p;
    __syncwarp();
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[i] *= alpha;
#pragma unroll 8
    for (int r = 0; r < TR; ++r) {
      const float pr = ps[g][r];
      float vf[VEC];
      load_row<VEC>(&Vs[buf][r][lane * VEC], vf);
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[i] = fmaf(pr, vf[i], acc[i]);
    }
    __syncthreads();  // tile t consumed before its buffer is refilled
    if (STAGES == 1 && t + 1 < ntiles) load_tile(t + 1, 0);
  }

  const size_t slot = ((size_t)b * H + kh * G + g) * n_split + split;
#pragma unroll
  for (int i = 0; i < VEC; ++i) part_acc[slot * D + lane * VEC + i] = acc[i];
  if (lane == 0) {
    part_m[slot] = m;
    part_l[slot] = l;
  }
}

// Pass 2 is split_kv_combine (common.cuh).

template <typename T, int D, int G>
cudaError_t launch(const void* q, const void* k, const void* v, const int* lo,
                   const int* hi, void* out, float* part_m, float* part_l,
                   float* part_acc, int B, int S, int H, int K, int n_split,
                   float scale, float softcap, cudaStream_t stream) {
  decode_partial<T, D, G><<<dim3(n_split, K, B), G * 32, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), lo, hi, part_m, part_l, part_acc, S, H, K,
      n_split, scale, softcap);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  split_kv_combine<T, D><<<dim3(H, B), D, 0, stream>>>(
      part_m, part_l, part_acc, static_cast<T*>(out), H, n_split);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t dispatch_g(int G, const void* q, const void* k, const void* v,
                       const int* lo, const int* hi, void* out, float* pm,
                       float* pl, float* pa, int B, int S, int H, int K,
                       int n_split, float scale, float softcap,
                       cudaStream_t st) {
  switch (G) {
    case 1: return launch<T, D, 1>(q, k, v, lo, hi, out, pm, pl, pa, B, S, H, K, n_split, scale, softcap, st);
    case 2: return launch<T, D, 2>(q, k, v, lo, hi, out, pm, pl, pa, B, S, H, K, n_split, scale, softcap, st);
    case 4: return launch<T, D, 4>(q, k, v, lo, hi, out, pm, pl, pa, B, S, H, K, n_split, scale, softcap, st);
    case 8: return launch<T, D, 8>(q, k, v, lo, hi, out, pm, pl, pa, B, S, H, K, n_split, scale, softcap, st);
    case 16: return launch<T, D, 16>(q, k, v, lo, hi, out, pm, pl, pa, B, S, H, K, n_split, scale, softcap, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q [B, H, D]; k, v [B, S, K, D] (contiguous, same dtype); lo, hi [B] int32;
// out [B, H, D]; part_m, part_l [B, H, n_split] and part_acc
// [B, H, n_split, D] fp32 scratch. softcap <= 0 disables the softcap.
// Returns the CUDA error code of the launches (0 on success).
extern "C" int ome_flash_decode(const void* q, const void* k, const void* v,
                                const int* lo, const int* hi, void* out,
                                float* part_m, float* part_l, float* part_acc,
                                int B, int S, int H, int K, int D, int n_split,
                                float scale, float softcap, int is_bf16,
                                void* stream) {
  if (K <= 0 || H % K != 0 || n_split < 1) return cudaErrorInvalidValue;
  const int G = H / K;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    if (D == 128) return dispatch_g<uint16_t, 128>(G, q, k, v, lo, hi, out, part_m, part_l, part_acc, B, S, H, K, n_split, scale, softcap, st);
    if (D == 64) return dispatch_g<uint16_t, 64>(G, q, k, v, lo, hi, out, part_m, part_l, part_acc, B, S, H, K, n_split, scale, softcap, st);
  } else {
    if (D == 128) return dispatch_g<float, 128>(G, q, k, v, lo, hi, out, part_m, part_l, part_acc, B, S, H, K, n_split, scale, softcap, st);
    if (D == 64) return dispatch_g<float, 64>(G, q, k, v, lo, hi, out, part_m, part_l, part_acc, B, S, H, K, n_split, scale, softcap, st);
  }
  return cudaErrorInvalidValue;
}

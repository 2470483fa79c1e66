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
// Same function as the reference: the G = H/K query heads of one KV head
// share every row the block reads, the optional tanh softcap applies to
// the scaled logits, the softmax state (m, l, acc) is fp32 with the
// finite M_INIT = -1e30 start and the l >= 1e-30 clamp (an empty window
// gives 0), and the window [lo, hi) is in SEQUENCE space. For int8 the
// raw values convert to fp32 unscaled (every integer in +-127 is exact),
// the k-scale multiplies the row's logit and the v-scale multiplies the
// row's probability before the PV product, as _decode_kernel folds them.
//
// Address of sequence row r: pool[table[b, min(r / bs, M - 1)], r % bs].
// bs % 32 == 0 and tiles are aligned to 32 rows in sequence space, so a
// tile never straddles two pool blocks: each tile costs one table read,
// and its 32 scales per KV head are one contiguous 128-byte run. hi is
// clamped to M * bs, so the table is never read out of bounds; a free
// engine slot whose length outgrew its (all trash-block) table row reads
// the trash block and stays finite.
//
// What bounds it on an H100: the bytes of the K/V rows in [lo, hi) (1
// byte per element for int8, plus 2 x 4 bytes of scales per row and
// head), read from device memory once per KV head. Decode does ~2*G
// flops per K/V element, far below the tensor cores' ~295 flops/byte.
// The design follows the dense decode kernel (flash_decode.cu): each
// (sequence, KV head) window is split into up to n_split runs of whole
// tiles walked by separate blocks (flash-decoding) with a merge pass;
// K/V tiles (and int8 scale runs) are staged in shared memory with
// double-buffered cp.async, where all G query heads use them; rows
// outside [lo, hi) are zero-filled, never read.
//
// Built with nvcc into a shared library with a plain C interface (see
// ome_tpu_torch/ops/_build.py) and called through ctypes.

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kTile = 32;  // rows per tile; divides the pool block size

// Signed byte i of a word -> float, exactly and without the quarter-rate
// I2F convert: `flipped` is the word XOR 0x80808080, so each byte holds
// b + 128; placed in the low mantissa of 2^23 (0x4B000000) it reads
// 8388608 + b + 128, and one FADD leaves b.
__device__ __forceinline__ float int8_at(uint32_t flipped, int i) {
  return __uint_as_float(__byte_perm(flipped, 0x4B000000u, 0x7440 | i)) -
         8388736.f;
}

// -- int8 overloads of the common.cuh row loaders -------------------------

__device__ __forceinline__ void load_chunk(const int8_t* p, float (&o)[16]) {
  const uint4 t = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {t.x ^ 0x80808080u, t.y ^ 0x80808080u,
                         t.z ^ 0x80808080u, t.w ^ 0x80808080u};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) o[4 * i + j] = int8_at(w[i], j);
}

template <int VEC>
__device__ __forceinline__ void load_row(const int8_t* p, float (&o)[VEC]) {
  if constexpr (VEC == 4) {
    const uint32_t w = *reinterpret_cast<const uint32_t*>(p) ^ 0x80808080u;
#pragma unroll
    for (int i = 0; i < 4; ++i) o[i] = int8_at(w, i);
  } else {
    const uint32_t w = *reinterpret_cast<const uint16_t*>(p) ^ 0x8080u;
    o[0] = int8_at(w, 0); o[1] = int8_at(w, 1);
  }
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const float* k_scale;
  const float* v_scale;
  const int* table;
  const int* lo;
  const int* hi;
  void* out;
  float* part_m;
  float* part_l;
  float* part_acc;
  int B, bs, M, H, K, n_split;
  float scale, softcap;
  cudaStream_t stream;
};

// Pass 1: one block per (split, kv head, sequence), one warp per query
// head of the KV head (G warps). The sequence's tiles from the aligned
// start floor(lo / 32) * 32 up to hi are dealt to the n_split blocks in
// contiguous runs. For each tile the whole block copies the K/V rows
// (and, for int8, the tile's k and v scale runs) from the pool block
// table[b, row0 / bs] into shared memory with cp.async, two stages deep
// for 1- and 2-byte elements; then in warp g lane r scores row r for
// head g, one max and one sum per tile update the online softmax, and
// lane r accumulates dims [r * D/32, (r + 1) * D/32) of P V. Writes the
// block's (m, l, acc) per query head to the workspace.
template <typename TQ, typename TKV, int D, int G>
__global__ void __launch_bounds__(G * 32)
paged_partial(const TQ* __restrict__ q, const TKV* __restrict__ kpool,
              const TKV* __restrict__ vpool,
              const float* __restrict__ kscale,
              const float* __restrict__ vscale,
              const int* __restrict__ table, const int* __restrict__ lo_arr,
              const int* __restrict__ hi_arr, float* __restrict__ part_m,
              float* __restrict__ part_l, float* __restrict__ part_acc,
              int bs, int M, int H, int K, int n_split, float scale,
              float softcap) {
  constexpr bool QUANT = std::is_same<TKV, int8_t>::value;
  constexpr int NT = G * 32;                  // threads
  constexpr int EPC = 16 / sizeof(TKV);       // elements per 16-byte chunk
  constexpr int CPR = D / EPC;                // chunks per row
  constexpr int RS = D + EPC;                 // padded smem row (elements)
  constexpr int STAGES = sizeof(TKV) <= 2 ? 2 : 1;
  constexpr int VEC = D / 32;                 // output dims per lane
  __shared__ __align__(16) TKV Ks[STAGES][kTile][RS];
  __shared__ __align__(16) TKV Vs[STAGES][kTile][RS];
  // int8 only: [stage][k or v][row] scales of the tile and KV head
  __shared__ __align__(16) float Ss[STAGES][2][QUANT ? kTile : 4];
  __shared__ __align__(16) float qs[G][D];
  __shared__ float ps[G][kTile];

  const int split = blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
  const int g = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int lo = max(lo_arr[b], 0);
  const int hi = min(hi_arr[b], M * bs);
  const int alo = lo & ~(kTile - 1);
  const int ntot = hi > lo ? (hi - alo + kTile - 1) / kTile : 0;
  const int per = (ntot + n_split - 1) / n_split;
  const int first = split * per;
  const int ntiles = max(min(per, ntot - first), 0);
  const int* trow = table + (size_t)b * M;

  for (int i = threadIdx.x; i < G * D; i += NT)
    qs[i / D][i % D] =
        to_float(q[((size_t)b * H + kh * G + i / D) * D + i % D]) * scale;

  auto load_tile = [&](int t, int buf) {
    // row0 < hi <= M * bs, so row0 / bs < M; the min only guards the
    // table read
    const int row0 = alo + (first + t) * kTile;
    const int blk = trow[min(row0 / bs, M - 1)];
    const int off0 = row0 % bs;
    const size_t prow = (size_t)blk * bs + off0;  // pool row of tile row 0
    for (int idx = threadIdx.x; idx < kTile * CPR; idx += NT) {
      const int r = idx / CPR, c = (idx % CPR) * EPC;
      const int row = row0 + r;
      const bool ok = row >= lo && row < hi;
      const size_t off = ((prow + r) * K + kh) * D + c;
      cp_async16(&Ks[buf][r][c], kpool + off, ok ? 16 : 0);
      cp_async16(&Vs[buf][r][c], vpool + off, ok ? 16 : 0);
    }
    if constexpr (QUANT) {
      // 2 x 128 contiguous bytes: threads 0-7 the k run, 8-15 the v run
      if (threadIdx.x < 16) {
        const int which = threadIdx.x >> 3, c = (threadIdx.x & 7) * 4;
        const float* plane = which ? vscale : kscale;
        cp_async16(&Ss[buf][which][c],
                   plane + ((size_t)blk * K + kh) * bs + off0 + c, 16);
      }
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

    const int row = alo + (first + t) * kTile + lane;
    const bool valid = row >= lo && row < hi;
    float s = 0.f;
#pragma unroll
    for (int c = 0; c < D; c += EPC) {
      float kf[EPC];
      load_chunk(&Ks[buf][lane][c], kf);
#pragma unroll
      for (int e = 0; e < EPC; ++e) s = fmaf(qs[g][c + e], kf[e], s);
    }
    if constexpr (QUANT) s *= Ss[buf][0][lane];
    if (softcap > 0.f) s = tanhf(s / softcap) * softcap;
    const float m_new = fmaxf(m, warp_max(valid ? s : kMInit));
    const float alpha = expf(m - m_new);
    const float p = valid ? expf(s - m_new) : 0.f;
    l = l * alpha + warp_sum(p);
    m = m_new;
    if constexpr (QUANT) {
      ps[g][lane] = p * Ss[buf][1][lane];
    } else {
      ps[g][lane] = p;
    }
    __syncwarp();
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[i] *= alpha;
#pragma unroll 8
    for (int r = 0; r < kTile; ++r) {
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

template <typename TQ, typename TKV, int D, int G>
cudaError_t launch(const Args& a) {
  paged_partial<TQ, TKV, D, G>
      <<<dim3(a.n_split, a.K, a.B), G * 32, 0, a.stream>>>(
          static_cast<const TQ*>(a.q), static_cast<const TKV*>(a.k),
          static_cast<const TKV*>(a.v), a.k_scale, a.v_scale, a.table, a.lo,
          a.hi, a.part_m, a.part_l, a.part_acc, a.bs, a.M, a.H, a.K,
          a.n_split, a.scale, a.softcap);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  split_kv_combine<TQ, D><<<dim3(a.H, a.B), D, 0, a.stream>>>(
      a.part_m, a.part_l, a.part_acc, static_cast<TQ*>(a.out), a.H,
      a.n_split);
  return cudaGetLastError();
}

template <typename TQ, typename TKV, int D>
cudaError_t dispatch_g(int G, const Args& a) {
  switch (G) {
    case 1: return launch<TQ, TKV, D, 1>(a);
    case 2: return launch<TQ, TKV, D, 2>(a);
    case 4: return launch<TQ, TKV, D, 4>(a);
    case 8: return launch<TQ, TKV, D, 8>(a);
    case 16: return launch<TQ, TKV, D, 16>(a);
    default: return cudaErrorInvalidValue;
  }
}

template <typename TQ, typename TKV>
cudaError_t dispatch_d(int D, int G, const Args& a) {
  if (D == 128) return dispatch_g<TQ, TKV, 128>(G, a);
  if (D == 64) return dispatch_g<TQ, TKV, 64>(G, a);
  return cudaErrorInvalidValue;
}

}  // namespace

// q [B, H, D] (bf16 or fp32); k_pool, v_pool [N, bs, K, D] in q's dtype,
// or int8 with k_scale, v_scale [N, K, bs] fp32 (NULL otherwise);
// table [B, M] int32 pool block ids; lo, hi [B] int32 sequence rows
// [lo, hi) to attend; out [B, H, D] in q's dtype; part_m, part_l
// [B, H, n_split] and part_acc [B, H, n_split, D] fp32 scratch.
// softcap <= 0 disables the softcap. Returns the CUDA error code of the
// launches (0 on success).
extern "C" int ome_flash_paged_decode(
    const void* q, const void* k_pool, const void* v_pool,
    const float* k_scale, const float* v_scale, const int* table,
    const int* lo, const int* hi, void* out, float* part_m, float* part_l,
    float* part_acc, int B, int bs, int M, int H, int K, int D, int n_split,
    float scale, float softcap, int is_bf16, int kv_int8, void* stream) {
  if (B < 1 || K <= 0 || H % K != 0 || n_split < 1 || M < 1 || bs <= 0 ||
      bs % kTile != 0 || (kv_int8 && (k_scale == nullptr || v_scale == nullptr)))
    return cudaErrorInvalidValue;
  const Args a{q,      k_pool, v_pool,   k_scale, v_scale, table, lo,
               hi,     out,    part_m,   part_l,  part_acc, B,    bs,
               M,      H,      K,        n_split, scale,   softcap,
               static_cast<cudaStream_t>(stream)};
  const int G = H / K;
  if (is_bf16) {
    return kv_int8 ? dispatch_d<uint16_t, int8_t>(D, G, a)
                   : dispatch_d<uint16_t, uint16_t>(D, G, a);
  }
  return kv_int8 ? dispatch_d<float, int8_t>(D, G, a)
                 : dispatch_d<float, float>(D, G, a);
}

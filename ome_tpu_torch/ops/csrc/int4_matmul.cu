// Int4 weight-only matmul (W4A16) for Hopper:
//   y[m, N] = x[m, K] @ W[K, N],  m <= 256,
// with W half-packed: byte (j, n) of qp [K/2, N] holds W[j, n] in its low
// nibble and W[K/2 + j, n] in its high nibble, both two's-complement in
// [-7, 7], and f32 scales s [K/G, N] per (group of G rows, column).
//
// Replaces ome_tpu/ops/int4_matmul.py::_mm4 (kernel body _kernel). Same
// function: x in bf16; each weight as (f32 nibble x f32 scale) rounded to
// bf16; bf16 x bf16 products accumulated in fp32; the sum written in the
// output type (bf16 or fp32). Each packed tile feeds two products, as
// _kernel does with xl/xh: its low nibbles against x[:, j0 : j0+64] with
// scale rows j/G, its high nibbles against x[:, K/2+j0 : K/2+j0+64] with
// scale rows j/G + K/(2G).
//
// What bounds it on an H100. Decode (m <= 16): the packed bytes and
// scales read from device memory, 29.4 MB + 1.8 MB for the Llama-3-8B
// gate projection, 0.0094 ms at 3.35 TB/s; the unpack (about four and a
// half instructions per weight, every weight once) needs nearly as long
// at the SMs' full issue rate, so the copies must cost the math threads
// nothing and the math must never wait on an empty pipeline. Short
// prefills (m 256): tensor-core operations, 30.1 GFLOP, 0.0304 ms.
//
// The design, against what held the cp.async kernel it replaces back:
//   * Copies by TMA (the threads copied, computing every address, and a
//     __syncthreads gated every step). Each stage of a ring in shared
//     memory holds one K step of a work unit: 64 packed rows x 128
//     columns, the x columns of both halves and the scale rows of both
//     halves, five boxes completing one `full` mbarrier; the consumers
//     release it on an `empty` mbarrier. The packed tile and x land with
//     the 128-byte swizzle, which spreads the fragment reads over all 32
//     banks.
//   * A persistent grid (short blocks, a pipeline that drained in every
//     block, a ragged last wave): int4_plan in ops/int4_matmul.py deals
//     (split, column tile) units round-robin to at most two blocks per
//     SM, split-major, so that blocks side by side read the same packed
//     rows; a block's ring runs on from one unit into the next.
//   * Split-K inside the launch (a second kernel summed the splits). Each
//     split writes its fp32 partial; the last to finish (a per-tile
//     counter, atomicAdd after __threadfence) adds all of them in split
//     order 0, 1, ... and writes the result, then resets the counter for
//     the next launch. The sum's order is fixed, so the same inputs give
//     the same bits, and no second kernel runs.
//   * Decode (int4_decode): a producer warp issues the TMA; two consumer
//     warpgroups take turns at the stages (each owns half the ring). The
//     products run on wgmma in swap-AB form: the unpacked W^T is the
//     64-row A operand, from registers; x^T, m padded to 8 or 16, is B,
//     from the stage. A word of packed bytes gives four columns: bytes 0
//     and 1 are rows g of A tiles 0 and 1, bytes 2 and 3 their rows g + 8,
//     so one 32-bit load feeds both tiles, and the epilogue writes each
//     accumulator to its true column.
//   * The unpack keeps the reference's rounding: each byte gives a low
//     and a high value, turned into exact floats by a PRMT into the
//     mantissa of 2^23 and one FADD (no I2F), scaled by an fp32 FMUL,
//     rounded to bf16.
//   * m 17..256 (int4_mm_wide; the old kernel unpacked each weight once
//     per 64 rows, on mma.sync): one unit is every row of x, padded to 64,
//     128 or 256, against a 128-column tile. At each K step the consumer
//     warpgroups together unpack the packed tile once into a bf16 tile in
//     shared memory (MN-major, 128-byte swizzled), then each runs wgmma
//     SS over its 64 rows of x. The unpacked tile is double-buffered, so
//     one step's products run while the next step is unpacked.
//
// Built with nvcc into a shared library with a plain C interface (see
// ome_tpu_torch/ops/_build.py) and called through ctypes.

#include <mutex>

#include "common.cuh"

namespace {

constexpr int kBN = 128;        // columns of a work unit (TILE_N)
constexpr int kBKP = 64;        // packed rows of a K step (TILE_KP)
constexpr int kMaxStages = 6;   // ring depth (MAX_STAGES)
constexpr int kWG = 128;        // threads of a warpgroup
constexpr int kDecodeM = 16;    // rows of x a decode stage holds
// shared bytes the decode kernel's second warpgroup hands its sums over in
constexpr int kXchg = kDecodeM * kWG * 4;
// the wide kernel's unpacked weight tile: 128 k rows x 128 bf16 columns,
// as two 64-column boxes
constexpr int kWideWu = 2 * kBKP * kBN * 2;

// scale rows a step of kBKP packed rows touches in each half (its start
// is a multiple of kBKP; G is even): one when groups are whole steps
__host__ __device__ __forceinline__ int scale_rows(int G) {
  return G % kBKP == 0 ? 1 : (kBKP - 1) / G + 2;
}

// one ring stage: packed tile (8 KB), x of both halves (BM rows of 128
// bytes each), scale rows of both halves; every part 1024-byte aligned
__host__ __device__ __forceinline__ int stage_bytes(int BM, int srows) {
  return kBKP * kBN + 2 * BM * 128 + 2 * srows * kBN * 4;
}

// The plan's walk (Int4Plan.unit): unit u is split u / tiles of column
// tile u % tiles; split sp of a tile takes steps [sp * steps / splits,
// (sp + 1) * steps / splits).
struct Walk {
  int tiles, steps, splits;
  __device__ __forceinline__ int lo(int sp) const {
    return sp * steps / splits;
  }
};

// Step gi of a block (its steps counted over all its units) is consumed
// by warpgroup gi % nc, which owns the ring's stages [q * half, (q + 1) *
// half), half = stages / nc, and walks them in order: every use of a stage
// belongs to one warpgroup, so a parity wait never skips a phase.
struct RingSlot {
  int s, ph, q, lap;
  __device__ __forceinline__ RingSlot(int gi, int nc, int half) {
    q = gi % nc;
    const int h = gi / nc;
    s = q * half + h % half;
    lap = h / half;
    ph = lap & 1;
  }
};

// The producer of both kernels: walks the block's units in the plan's
// order and loads one K step per ring stage: the packed tile (kBKP rows x
// kBN columns), x's columns of both halves (BM rows) and the scale rows
// of both halves, five boxes completing `full`. Step gi goes to stage
// RingSlot(gi, nc, stages / nc), once that stage's previous use is
// released on `empty`.
template <int BM>
struct Producer {
  const CUtensorMap *tm_w, *tm_x, *tm_s;
  uint8_t* ring;
  uint64_t *full, *empty;
  Walk walk;
  int n_units, KP, G, srows, sbytes, stages, nc;
  int u, k, gi;  // the next step to load

  __device__ __forceinline__ void start() {
    u = blockIdx.x;
    k = u < n_units ? walk.lo(u / walk.tiles) : 0;
    gi = 0;
  }
  __device__ __forceinline__ bool more() const { return u < n_units; }
  __device__ __forceinline__ void issue() {
    constexpr int kXBytes = BM * 128;
    const int sp = u / walk.tiles, n0 = (u - sp * walk.tiles) * kBN;
    const RingSlot r(gi, nc, stages / nc);
    const int s = r.s;
    if (r.lap > 0) mbar_wait(&empty[s], r.ph ^ 1);
    const int j0 = k * kBKP, glo = j0 / G;
    uint8_t* st = ring + s * sbytes;
    mbar_arrive_expect_tx(&full[s], sbytes);
    tma_load_2d(st, tm_w, &full[s], n0, j0);
    tma_load_2d(st + kBKP * kBN, tm_x, &full[s], j0, 0);
    tma_load_2d(st + kBKP * kBN + kXBytes, tm_x, &full[s], KP + j0, 0);
    tma_load_2d(st + kBKP * kBN + 2 * kXBytes, tm_s, &full[s], n0, glo);
    // the high half's scale rows start K/(2G) rows down
    tma_load_2d(st + kBKP * kBN + 2 * kXBytes + srows * kBN * 4, tm_s,
                &full[s], n0, KP / G + glo);
    ++gi;
    if (++k == walk.lo(sp + 1)) {
      u += gridDim.x;
      if (u < n_units) k = walk.lo(u / walk.tiles);
    }
  }
};

// The split-K handshake of both kernels is last_split (common.cuh).

// Byte c of a word of biased nibbles (each byte v + 8 in 0..15, made from
// a raw two's-complement nibble by `raw ^ 8`) -> the exact float v: one
// PRMT places the byte in the low mantissa of 2^23, one FADD removes
// 2^23 + 8 (no quarter-rate I2F).
__device__ __forceinline__ float biased(uint32_t w, int c) {
  return __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7440 | c)) -
         8388616.f;
}

// two weights of byte c, rows r and r + 1 of v, as bf16(f32 nibble x f32
// scale), the lower row in the low half
__device__ __forceinline__ uint32_t wpair(const uint32_t (&v)[4], int r,
                                          int c, float sc) {
  return pack_bf16(biased(v[r], c) * sc, biased(v[r + 1], c) * sc);
}

// The decode variant (m <= XN, XN 8 or 16). Grid `grid` (persistent),
// 288 threads: two consumer warpgroups, then the producer warp. kOneGroup:
// G is a multiple of kBKP, so a step lies in one scale group. XN 8 (every
// decode step of up to 8 sequences) keeps two blocks on each SM, whose
// registers fit only without spills if the split sum keeps 4 splits'
// loads in flight; XN 16 takes the registers of one block per SM and 8.
template <int XN>
__host__ __device__ constexpr int decode_blocks_per_sm() {
  return XN == 8 ? 2 : 1;
}

template <int XN, bool kOneGroup>
__global__ void __launch_bounds__(2 * kWG + 32, decode_blocks_per_sm<XN>())
int4_decode(const __grid_constant__ CUtensorMap tm_w,
            const __grid_constant__ CUtensorMap tm_x,
            const __grid_constant__ CUtensorMap tm_s, void* __restrict__ out,
            float* __restrict__ part, int* __restrict__ cnt, int m, int K,
            int N, int G, int steps, int splits, int stages, int out_bf16) {
  constexpr int kXBytes = kDecodeM * 128;  // one half of x
  constexpr int kNA = XN;  // accumulators per thread: 2 tiles x XN / 2
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[2 * kMaxStages];
  __shared__ int is_last;
  uint64_t* const full = bars;                // TMA landed in stage s
  uint64_t* const empty = bars + kMaxStages;  // its warpgroup done with s
  uint8_t* const ring =
      smem_raw + ((1024u - (smem_addr(smem_raw) & 1023u)) & 1023u);

  const int KP = K / 2;
  const int srows = kOneGroup ? 1 : scale_rows(G);
  const int sbytes = stage_bytes(kDecodeM, srows);
  const int tiles = N / kBN;
  const int n_units = tiles * splits;
  const Walk walk{tiles, steps, splits};

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kWG / 32);  // one warpgroup consumes a stage
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= 2 * kWG) {
    // ---- producer: one thread keeps the ring full across units --------
    if (threadIdx.x == 2 * kWG) {
      Producer<kDecodeM> prod{&tm_w, &tm_x, &tm_s, ring,   full, empty, walk,
                              n_units, KP,    G,     srows, sbytes, stages, 2};
      for (prod.start(); prod.more();) prod.issue();
    }
    return;
  }

  // ---- consumers -----------------------------------------------------------
  const int wg = threadIdx.x / kWG, tid = threadIdx.x % kWG;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int c0 = warp * 32 + g * 4;  // this lane's 4 columns (one word)
  const int wchunk = c0 >> 4, wbyte = c0 & 15;
  // acc[c*(XN/2) + i*4 + e] is accumulator i*4 + e of A tile c: x row
  // 8i + 2t + e%2, unit column c0 + 2(e/2) + c
  float acc[kNA];
  int gi = 0;
  for (int u = blockIdx.x; u < n_units; u += gridDim.x) {
    const int sp = u / tiles, tile = u - sp * tiles;
#pragma unroll
    for (int i = 0; i < kNA; ++i) acc[i] = 0.f;
    for (int k = walk.lo(sp); k < walk.lo(sp + 1); ++k, ++gi) {
      const RingSlot r(gi, 2, stages / 2);
      if (r.q != wg) continue;  // the other warpgroup's step
      const int s = r.s;
      mbar_wait(&full[s], r.ph);
      const uint8_t* W = ring + s * sbytes;
      const uint8_t* X = W + kBKP * kBN;
      const float* S = reinterpret_cast<const float*>(X + 2 * kXBytes);
      const int j0 = k * kBKP, glo = j0 / G;
      float sl0[4], sl1[4], sh0[4], sh1[4];
      if constexpr (kOneGroup) {
        load_chunk(S + c0, sl0);
        load_chunk(S + kBN + c0, sh0);
      }
      uint32_t aprev[2][2][4];  // the A registers of the products in flight
#pragma unroll
      for (int kk = 0; kk < kBKP; kk += 16) {
        if constexpr (!kOneGroup) {
          // rows kk+2t, +1 share a group (G even), as do kk+2t+8, +9
          const int sr0 = (j0 + kk + 2 * t) / G - glo;
          const int sr1 = (j0 + kk + 2 * t + 8) / G - glo;
          load_chunk(S + sr0 * kBN + c0, sl0);
          load_chunk(S + sr1 * kBN + c0, sl1);
          load_chunk(S + (srows + sr0) * kBN + c0, sh0);
          load_chunk(S + (srows + sr1) * kBN + c0, sh1);
        }
        // packed rows kk+2t, +1, +8, +9 at this lane's 4 columns: one
        // word each. Row r's 16-byte chunk sits at chunk ^ (r & 7) (the
        // 128-byte swizzle), and r & 7 = 2t + (r & 1) here.
        uint32_t lo[4], hi[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int row = kk + 2 * t + (r & 1) + 8 * (r >> 1);
          const uint32_t w = *reinterpret_cast<const uint32_t*>(
              W + row * 128 + ((wchunk ^ (2 * t + (r & 1))) << 4) + wbyte);
          lo[r] = (w & 0x0F0F0F0Fu) ^ 0x08080808u;
          hi[r] = ((w >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u;
        }
        // A fragments (rows g, g + 8; k 2t.. and 2t+8..) of tile c: bytes
        // c (row g) and c + 2 (row g + 8) of the words
        auto frag = [&](uint32_t(&o)[4], const uint32_t(&v)[4], int c,
                        const float(&s0)[4], const float(&s1)[4]) {
          o[0] = wpair(v, 0, c, s0[c]);
          o[1] = wpair(v, 0, c + 2, s0[c + 2]);
          o[2] = wpair(v, 2, c, s1[c]);
          o[3] = wpair(v, 2, c + 2, s1[c + 2]);
        };
        uint32_t a[2][2][4];  // [tile][low/high half][fragment]
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          frag(a[c][0], lo, c, sl0, kOneGroup ? sl0 : sl1);
          frag(a[c][1], hi, c, sh0, kOneGroup ? sh0 : sh1);
        }
        // x^T is B: x's rows of 64 k values, K-major, 128-byte swizzled
        const uint32_t xa = smem_addr(X) + kk * 2;
        wgmma_fence();
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float(&d)[XN / 2] =
              *reinterpret_cast<float(*)[XN / 2]>(acc + c * (XN / 2));
          wgmma_rs_k<XN>(d, a[c][0], sw128_desc(xa, 16, 1024));
          wgmma_rs_k<XN>(d, a[c][1], sw128_desc(xa + kXBytes, 16, 1024));
        }
        wgmma_commit();
        if (kk > 0) {
          // the previous k16 step's products are done: its A registers
          // may be reused from here on
          wgmma_wait<1>();
#pragma unroll
          for (int c = 0; c < 2; ++c)
#pragma unroll
            for (int h = 0; h < 2; ++h) reg_fence(aprev[c][h]);
        }
#pragma unroll
        for (int c = 0; c < 2; ++c)
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int i = 0; i < 4; ++i) aprev[c][h][i] = a[c][h][i];
      }
      // the stage's x is read by the products: retire them first
      wgmma_wait<0>();
#pragma unroll
      for (int c = 0; c < 2; ++c)
#pragma unroll
        for (int h = 0; h < 2; ++h) reg_fence(aprev[c][h]);
      reg_fence(acc);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }

    // the second warpgroup's sums join the first's, in that order
    float2* xc = reinterpret_cast<float2*>(ring + stages * sbytes);
    if (wg == 1) {
#pragma unroll
      for (int p = 0; p < kNA / 2; ++p)
        xc[p * kWG + tid] = make_float2(acc[2 * p], acc[2 * p + 1]);
      named_bar_sync(2, 2 * kWG);
      named_bar_sync(3, 2 * kWG);  // read before the next unit's write
      continue;
    }
    named_bar_sync(2, 2 * kWG);
#pragma unroll
    for (int p = 0; p < kNA / 2; ++p) {
      const float2 v = xc[p * kWG + tid];
      acc[2 * p] += v.x;
      acc[2 * p + 1] += v.y;
    }
    named_bar_sync(3, 2 * kWG);

    // ---- epilogue of the unit (the first warpgroup) -----------------------
    // x row 8i + 2t + q holds unit columns c0 .. c0 + 3 as (c, h) =
    // (0,0), (1,0), (0,1), (1,1): acc[c*(XN/2) + i*4 + 2h + q]
    const int n0 = tile * kBN;
    auto store4 = [&](size_t off, float4 v) {
      if (out_bf16)
        *reinterpret_cast<uint2*>(static_cast<uint16_t*>(out) + off) =
            make_uint2(pack_bf16(v.x, v.y), pack_bf16(v.z, v.w));
      else
        *reinterpret_cast<float4*>(static_cast<float*>(out) + off) = v;
    };
    float* const rows =
        splits > 1 ? part + (size_t)u * kDecodeM * kBN : nullptr;
#pragma unroll
    for (int i = 0; i < XN / 8; ++i)
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int row = 8 * i + 2 * t + q;
        if (row >= m) continue;
        const float4 v =
            make_float4(acc[i * 4 + q], acc[XN / 2 + i * 4 + q],
                        acc[i * 4 + 2 + q], acc[XN / 2 + i * 4 + 2 + q]);
        if (rows)  // this split's rows of the partial, row-major
          __stcg(reinterpret_cast<float4*>(rows + row * kBN + c0), v);
        else
          store4((size_t)row * N + n0 + c0, v);
      }
    if (!rows || !last_split(cnt, tile, splits, kWG, tid, 1, is_last))
      continue;
    // the last split adds every split's rows in split order, a float4 of
    // four columns per thread and pass, QB splits' loads in flight
    constexpr int QB = decode_blocks_per_sm<XN>() == 2 ? 4 : 8;
    const size_t qstride = (size_t)tiles * kDecodeM * kBN / 4;  // float4
    for (int idx = tid; idx < m * (kBN / 4); idx += kWG) {
      const int row = idx / (kBN / 4), col = (idx % (kBN / 4)) * 4;
      const float4* src = reinterpret_cast<const float4*>(
          part + (size_t)tile * kDecodeM * kBN + row * kBN + col);
      float4 sum = __ldcg(src);
      for (int q0 = 1; q0 < splits; q0 += QB) {
        float4 v[QB];
#pragma unroll
        for (int j = 0; j < QB; ++j)
          if (q0 + j < splits) v[j] = __ldcg(src + (q0 + j) * qstride);
#pragma unroll
        for (int j = 0; j < QB; ++j)
          if (q0 + j < splits) {
            sum.x += v[j].x;
            sum.y += v[j].y;
            sum.z += v[j].z;
            sum.w += v[j].w;
          }
      }
      store4((size_t)row * N + n0 + col, sum);
    }
  }
}

// The wide variant (17 <= m <= 256): one unit is all MP = 64 NCW rows of x
// (m padded) against a 128-column tile, so each weight is unpacked once.
// Grid `grid` (persistent): NCW consumer warpgroups, one m64 tile each,
// and a producer warp; at NCW 4 thread 0 issues the loads instead, since
// a 17th warp would cut every thread's registers to 96 (a block's warps
// are spread over the SM's four partitions) and the consumers would
// spill. At each K step the consumers together unpack the stage's packed
// tile into a bf16 tile in shared memory (128 k rows x 128 columns,
// MN-major, 128-byte swizzled: two boxes of 64 columns), then each runs
// wgmma SS over it, its m64 rows of x (K-major) as A. The unpacked tile
// is double-buffered: step i's products run while step i + 1 is
// unpacked.
template <int NCW>
__host__ __device__ constexpr bool wide_producer_warp() {
  return NCW < 4;
}

template <int NCW, bool kOneGroup>
__global__ void
__launch_bounds__(kWG * NCW + (wide_producer_warp<NCW>() ? 32 : 0), 1)
int4_mm_wide(const __grid_constant__ CUtensorMap tm_w,
             const __grid_constant__ CUtensorMap tm_x,
             const __grid_constant__ CUtensorMap tm_s, void* __restrict__ out,
             float* __restrict__ part, int* __restrict__ cnt, int m, int K,
             int N, int G, int steps, int splits, int stages, int out_bf16) {
  constexpr int MP = 64 * NCW;
  constexpr int kXBytes = MP * 128;
  constexpr int kCons = kWG * NCW;       // consumer threads
  constexpr int kNA = 64;                // accumulators per thread
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[2 * kMaxStages];
  __shared__ int is_last;
  uint64_t* const full = bars;
  uint64_t* const empty = bars + kMaxStages;  // every consumer warp done
  uint8_t* const ring =
      smem_raw + ((1024u - (smem_addr(smem_raw) & 1023u)) & 1023u);

  const int KP = K / 2;
  const int srows = kOneGroup ? 1 : scale_rows(G);
  const int sbytes = stage_bytes(MP, srows);
  uint8_t* const wu = ring + stages * sbytes;  // 2 x kWideWu bytes
  const int tiles = N / kBN;
  const int n_units = tiles * splits;
  const Walk walk{tiles, steps, splits};

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kCons / 32);
    }
    mbar_fence_init();
  }
  __syncthreads();

  constexpr bool kWarp = wide_producer_warp<NCW>();
  Producer<MP> prod{&tm_w, &tm_x, &tm_s, ring,   full, empty, walk,
                    n_units, KP,    G,     srows, sbytes, stages, 1};
  if constexpr (kWarp) {
    if (threadIdx.x >= kCons) {
      if (threadIdx.x == kCons)
        for (prod.start(); prod.more();) prod.issue();
      return;
    }
  } else if (threadIdx.x == 0) {
    // thread 0 produces: the first `stages` steps now, then one step each
    // time the consumers release a stage
    prod.start();
    for (int i = 0; i < stages && prod.more(); ++i) prod.issue();
  }

  const int wg = threadIdx.x / kWG, ctid = threadIdx.x;
  const int warp = (threadIdx.x % kWG) >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const uint32_t wu_addr = smem_addr(wu);
  // a thread's packed words all sit at columns 4 wc .. + 3, wc = lane;
  // in the unpacked tile, column 4 wc is in box wc / 16, 16-byte chunk
  // (wc % 16) / 2, at byte 8 (wc % 2)
  const int wc = lane;
  const int box = wc >> 4, ch = (wc & 15) >> 1, half8 = (wc & 1) * 8;
  // accumulator 4i + e of warp w is row wg*64 + 16w + g + 8(e/2), column
  // 8i + 2t + e%2; as pairs p = 2i + e/2:
  auto pair_row = [&](int p) { return wg * 64 + warp * 16 + g + 8 * (p & 1); };

  float acc[kNA];
  int gi = 0, pend = -1;  // pend: the stage whose products are in flight
  for (int u = blockIdx.x; u < n_units; u += gridDim.x) {
    const int sp = u / tiles, tile = u - sp * tiles;
#pragma unroll
    for (int i = 0; i < kNA; ++i) acc[i] = 0.f;
    for (int k = walk.lo(sp); k < walk.lo(sp + 1); ++k, ++gi) {
      const RingSlot r(gi, 1, stages);
      const int s = r.s;
      mbar_wait(&full[s], r.ph);
      const uint8_t* W = ring + s * sbytes;
      const uint8_t* X = W + kBKP * kBN;
      const float* S = reinterpret_cast<const float*>(X + 2 * kXBytes);
      const int j0 = k * kBKP, glo = j0 / G;
      uint8_t* Wb = wu + (gi & 1) * kWideWu;
      float sl[4], sh[4];
      if constexpr (kOneGroup) {
        load_chunk(S + 4 * wc, sl);
        load_chunk(S + kBN + 4 * wc, sh);
      }
      // unpack: packed row `row`'s word wc (thread ctid takes rows
      // ctid / 32, + kCons / 32, ...: a warp one row). Weights (row, n)
      // go to k row `row` (low nibbles) and 64 + row (high nibbles) of
      // the unpacked tile, as bf16(f32 nibble x f32 scale)
      auto unpack = [&](int i) {
        const int row = (ctid + i * kCons) >> 5;
        const uint32_t w = *reinterpret_cast<const uint32_t*>(
            W + row * 128 + (((wc >> 2) ^ (row & 7)) << 4) + (wc & 3) * 4);
        const uint32_t lo = (w & 0x0F0F0F0Fu) ^ 0x08080808u;
        const uint32_t hi = ((w >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u;
        if constexpr (!kOneGroup) {
          const int sr = (j0 + row) / G - glo;
          load_chunk(S + sr * kBN + 4 * wc, sl);
          load_chunk(S + (srows + sr) * kBN + 4 * wc, sh);
        }
        auto put = [&](int kr, uint32_t v, const float(&sc)[4]) {
          *reinterpret_cast<uint2*>(
              Wb + box * (kWideWu / 2) + kr * 128 + ((ch ^ (kr & 7)) << 4) +
              half8) =
              make_uint2(pack_bf16(biased(v, 0) * sc[0], biased(v, 1) * sc[1]),
                         pack_bf16(biased(v, 2) * sc[2], biased(v, 3) * sc[3]));
        };
        put(row, lo, sl);
        put(64 + row, hi, sh);
      };
      if constexpr (NCW == 1) {
#pragma unroll
        for (int i = 0; i < 16; ++i) unpack(i);
      } else {
        // rolled: unrolled, its loads ahead raise the registers past what
        // a thread may have beside 8 or 16 other warps, and they spill
#pragma unroll 1
        for (int i = 0; i < 16 / NCW; ++i) unpack(i);
      }
      fence_proxy_async();       // the tile, visible to wgmma
      named_bar_sync(1, kCons);  // ... and complete
      // products: this warpgroup's m64 rows, k 0..63 of each half
      wgmma_fence();
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int kc = 0; kc < 4; ++kc)
          wgmma_ss_mn<128>(
              acc,
              sw128_desc(smem_addr(X) + h * kXBytes + wg * 64 * 128 + kc * 32,
                         16, 1024),
              sw128_desc(wu_addr + (gi & 1) * kWideWu +
                             (h * 64 + kc * 16) * 128,
                         kWideWu / 2, 1024));
      wgmma_commit();
      wgmma_wait<1>();  // the previous step's products are done
      if (pend >= 0) {
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[pend]);
      }
      named_bar_sync(2, kCons);  // every warpgroup: the other buffer is free
      if (!kWarp && pend >= 0 && ctid == 0 && prod.more()) prod.issue();
      pend = s;
    }
    wgmma_wait<0>();
    reg_fence(acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[pend]);
    if (!kWarp && ctid == 0 && prod.more()) prod.issue();
    pend = -1;

    // ---- epilogue ---------------------------------------------------------
    if (splits > 1) {
      // this split's partial, pair p of thread ctid at [p][ctid]
      // (coalesced; pairs of rows past m neither written nor read)
      float2* mine =
          reinterpret_cast<float2*>(part + (size_t)u * kNA * kCons) + ctid;
#pragma unroll
      for (int p = 0; p < kNA / 2; ++p)
        if (pair_row(p) < m)
          __stcg(mine + p * kCons, make_float2(acc[2 * p], acc[2 * p + 1]));
      if (!last_split(cnt, tile, splits, kCons, ctid, 3, is_last)) continue;
      // the last split adds every split's partial in split order, eight
      // pairs' loads in flight
      for (int q = 0; q < splits; ++q) {
        const float2* src =
            reinterpret_cast<const float2*>(
                part + (size_t)(q * tiles + tile) * kNA * kCons) + ctid;
#pragma unroll
        for (int p0 = 0; p0 < kNA / 2; p0 += 8) {
          float2 v[8];
#pragma unroll
          for (int j = 0; j < 8; ++j)
            if (pair_row(p0 + j) < m) v[j] = __ldcg(src + (p0 + j) * kCons);
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int p = p0 + j;
            if (pair_row(p) >= m) continue;
            acc[2 * p] = q ? acc[2 * p] + v[j].x : v[j].x;
            acc[2 * p + 1] = q ? acc[2 * p + 1] + v[j].y : v[j].y;
          }
        }
      }
    }
    const int n0 = tile * kBN;
#pragma unroll
    for (int p = 0; p < kNA / 2; ++p) {
      const int row = pair_row(p);
      if (row >= m) continue;
      const size_t off = (size_t)row * N + n0 + 8 * (p >> 1) + 2 * t;
      if (out_bf16)
        *reinterpret_cast<uint32_t*>(static_cast<uint16_t*>(out) + off) =
            pack_bf16(acc[2 * p], acc[2 * p + 1]);
      else
        *reinterpret_cast<float2*>(static_cast<float*>(out) + off) =
            make_float2(acc[2 * p], acc[2 * p + 1]);
    }
  }
}

// -- host ---------------------------------------------------------------------

// The weight and scale maps depend only on a leaf's pointer and shape, and
// x's on its pointer and shape, so encoded maps are kept, keyed by every
// argument of the encoding (a hit is the same map, whatever tensor now
// lives there): a decode step does not re-encode its 160 leaves' maps.
struct MapKey {
  const void* base;
  cuuint64_t d0, d1;
  cuuint32_t b0, b1;
  int type;
  bool operator==(const MapKey& o) const {
    return base == o.base && d0 == o.d0 && d1 == o.d1 && b0 == o.b0 &&
           b1 == o.b1 && type == o.type;
  }
};

constexpr int kMapCache = 1024;  // direct-mapped by a hash of the key
std::mutex map_mu;
MapKey map_keys[kMapCache];
CUtensorMap map_vals[kMapCache];
bool map_set[kMapCache];

// A row-major [d1, d0] tensor of `esize`-byte elements as a 2D map with
// box (b0, b1): the 128-byte swizzle for the int8 and bf16 tiles the
// consumers read as fragments, none for the fp32 scale rows.
bool map_2d(CUtensorMap* map, CUtensorMapDataType type, int esize,
            const void* base, int d0, int d1, int b0, int b1) {
  const MapKey key{base, (cuuint64_t)d0, (cuuint64_t)d1, (cuuint32_t)b0,
                   (cuuint32_t)b1, (int)type};
  uint64_t h = (uint64_t)(uintptr_t)base * 0x9E3779B97F4A7C15ull;
  h ^= ((uint64_t)d0 << 32 | (uint64_t)d1) * 0xC2B2AE3D27D4EB4Full;
  h ^= ((uint64_t)b0 << 40 | (uint64_t)b1 << 8 | (uint64_t)type) *
       0x165667B19E3779F9ull;
  const int i = (int)((h ^ (h >> 29)) % kMapCache);
  std::lock_guard<std::mutex> lock(map_mu);
  if (map_set[i] && map_keys[i] == key) {
    *map = map_vals[i];
    return true;
  }
  const cuuint64_t dims[2] = {(cuuint64_t)d0, (cuuint64_t)d1};
  const cuuint64_t strides[1] = {(cuuint64_t)d0 * esize};
  const cuuint32_t box[2] = {(cuuint32_t)b0, (cuuint32_t)b1};
  if (!encode_map(map, type, 2, base, dims, strides, box,
                  esize == 4 ? CU_TENSOR_MAP_SWIZZLE_NONE
                             : CU_TENSOR_MAP_SWIZZLE_128B))
    return false;
  map_keys[i] = key;
  map_vals[i] = *map;
  map_set[i] = true;
  return true;
}

// One instantiation of either kernel: its maps (x in boxes of BM rows),
// its shared memory (raised once per instantiation), its launch.
template <typename Kern>
cudaError_t launch(Kern kern, int BM, int threads, int extra, const void* x,
                   const void* qp, const float* sc, void* out, float* part,
                   int* cnt, int m, int K, int Kx, int N, int G, int steps,
                   int splits, int grid, int stages, int out_bf16,
                   int& smem_allowed, cudaStream_t st) {
  const int srows = G % kBKP == 0 ? 1 : scale_rows(G);
  const int smem = 1024 + stages * stage_bytes(BM, srows) + extra;
  CUtensorMap tm_w, tm_x, tm_s;
  if (!map_2d(&tm_w, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, qp, N, K / 2, kBN,
              kBKP) ||
      !map_2d(&tm_x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, Kx, m, 64, BM) ||
      !map_2d(&tm_s, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, sc, N, K / G, kBN,
              srows))
    return cudaErrorInvalidValue;
  if (smem > smem_allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    smem_allowed = smem;
  }
  kern<<<grid, threads, smem, st>>>(tm_w, tm_x, tm_s, out, part, cnt, m, K,
                                    N, G, steps, splits, stages, out_bf16);
  return cudaGetLastError();
}

template <int XN, bool kOneGroup>
cudaError_t launch_decode(const void* x, const void* qp, const float* sc,
                          void* out, float* part, int* cnt, int m, int K,
                          int Kx, int N, int G, int steps, int splits,
                          int grid, int stages, int out_bf16,
                          cudaStream_t st) {
  static int smem_allowed = 48 * 1024;
  return launch(int4_decode<XN, kOneGroup>, kDecodeM, 2 * kWG + 32, kXchg, x,
                qp, sc, out, part, cnt, m, K, Kx, N, G, steps, splits, grid,
                stages, out_bf16, smem_allowed, st);
}

template <int NCW, bool kOneGroup>
cudaError_t launch_wide(const void* x, const void* qp, const float* sc,
                        void* out, float* part, int* cnt, int m, int K, int Kx,
                        int N, int G, int steps, int splits, int grid,
                        int stages, int out_bf16, cudaStream_t st) {
  static int smem_allowed = 48 * 1024;
  return launch(int4_mm_wide<NCW, kOneGroup>, 64 * NCW,
                kWG * NCW + (wide_producer_warp<NCW>() ? 32 : 0), 2 * kWideWu,
                x, qp, sc, out, part, cnt, m, K, Kx, N, G, steps, splits,
                grid, stages, out_bf16, smem_allowed, st);
}

}  // namespace

// x [m, Kx] bf16 (Kx >= K, Kx % 8 == 0, columns past K zero); qp [K/2, N]
// int8 half-packed; sc [K/G, N] fp32; out [m, N] bf16 (out_bf16) or fp32;
// with T = N / 128 column tiles, part [T * splits, block_m * 128] fp32
// (used when splits > 1) and cnt [T] int32 scratch, cnt all 0 (each
// launch leaves it so). block_m is 16 (decode, m <= 16) or 64, 128 or 256
// (wide, m <= block_m); splits, grid and stages are int4_plan's. Returns
// the CUDA error code of the launch.
extern "C" int ome_int4_matmul(const void* x, const void* qp, const float* sc,
                               void* out, float* part, int* cnt, int m, int K,
                               int Kx, int N, int G, int block_m, int splits,
                               int grid, int stages, int out_bf16,
                               void* stream) {
  const int KP = K / 2;
  const int steps = (KP + kBKP - 1) / kBKP;
  const bool decode = block_m == kDecodeM;
  if (m < 1 || m > block_m || K < 4 || K % 4 || Kx < K || Kx % 8 ||
      N < kBN || N % kBN || G < 2 || G % 2 || KP % G ||
      !(decode || block_m == 64 || block_m == 128 || block_m == 256) ||
      splits < 1 || splits > steps || grid < 1 ||
      grid > (N / kBN) * splits || stages < 2 || stages > kMaxStages ||
      (decode && stages % 2) || part == nullptr || cnt == nullptr ||
      ((uintptr_t)x | (uintptr_t)qp | (uintptr_t)sc) % 16)
    return cudaErrorInvalidValue;
  const int srows = G % kBKP == 0 ? 1 : scale_rows(G);
  if (1024 + stages * stage_bytes(block_m, srows) +
          (decode ? kXchg : 2 * kWideWu) >
      227 * 1024)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool one = G % kBKP == 0;
#define OME_INT4_DECODE(XN, ONE)                                             \
  launch_decode<XN, ONE>(x, qp, sc, out, part, cnt, m, K, Kx, N, G, steps,   \
                         splits, grid, stages, out_bf16, st)
#define OME_INT4_WIDE(NCW, ONE)                                              \
  launch_wide<NCW, ONE>(x, qp, sc, out, part, cnt, m, K, Kx, N, G, steps,   \
                        splits, grid, stages, out_bf16, st)
  if (decode && m <= 8)
    return one ? OME_INT4_DECODE(8, true) : OME_INT4_DECODE(8, false);
  if (decode)
    return one ? OME_INT4_DECODE(16, true) : OME_INT4_DECODE(16, false);
  if (block_m == 64)
    return one ? OME_INT4_WIDE(1, true) : OME_INT4_WIDE(1, false);
  if (block_m == 128)
    return one ? OME_INT4_WIDE(2, true) : OME_INT4_WIDE(2, false);
  return one ? OME_INT4_WIDE(4, true) : OME_INT4_WIDE(4, false);
#undef OME_INT4_DECODE
#undef OME_INT4_WIDE
}

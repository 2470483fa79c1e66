// The decode-attention core for Hopper, shared by the dense decode kernel
// (flash_decode.cu, B1) and the paged one (flash_paged_decode.cu, B3 and
// B5): one query token per sequence, GQA, the rows [lo, hi) of each
// sequence, read through a row address that is b * S + r for the dense
// cache [B, S, K, D] and table[b, r / bs] * bs + r % bs for a block pool
// [N, bs, K, D].
//
// Same function as the reference's _decode_kernel (ome_tpu/ops/flash.py):
// the G = H/K query heads of one KV head share every row; the window
// [lo, hi) is in sequence space; the tanh softcap applies to the scaled
// logits; the softmax state (m, l, acc) is fp32 with the finite M_INIT =
// -1e30 start and the l >= 1e-30 clamp, so an empty window gives 0; for
// int8 rows the raw values convert unscaled, the k-scale multiplies the
// row's logit and the v-scale the row's probability; the probabilities
// are rounded to the KV compute dtype (bf16) before the PV product.
// With attention sinks (gpt-oss; the reference's XLA path,
// ome_tpu/ops/attention.py:69-75) each query head's sink logit is one
// more column of its softmax whose probability is dropped: it enters
// where a window's output is normalized (`sink_norm`), once per head.
//
// What bounds it on an H100: the bytes of the K/V rows in [lo, hi) (and
// int8 scales), read once per KV head; decode does ~2G flops per K/V
// element, far below the ~295 flops/byte where the tensor cores would
// become the limit. The split-KV kernels this core replaces reached under
// half that bound: two launches per call (a merge pass of its own), splits
// sized by the cache's capacity rather than by each window's length, and
// every product on the CUDA cores, one dependent FMA chain per row and
// query head. The core's answers:
//   * Work units sized by each window's own length. Window (b, kh) is its
//     rows from the 64-row-aligned start floor(lo / 64) * 64 up to hi, cut
//     into units of `unit_rows` rows (the last one shorter); an empty
//     window is one unit with no rows. Every block builds the flat unit
//     list itself, from lo and hi, as a prefix sum over the batch in shared
//     memory (no host sync), and a persistent grid deals the units round
//     robin: unit u = prefix[b] + j * K + kh is unit j of window (b, kh).
//     A window's units depend only on its own [lo, hi), and the merge below
//     adds them in unit order, so a sequence's output bits depend neither on
//     the rest of the batch nor on the grid.
//   * The merge inside the launch. A window of one unit writes its output
//     directly; otherwise each unit stores its (m, l, acc) in a per-unit
//     workspace and the last unit of the window to finish (last_split on a
//     per-window counter, common.cuh) merges them in unit order.
//   * bf16 queries (decode_tc): a producer warp loads 64-row tiles by TMA
//     into an mbarrier ring (3-4 stages), each tile as 64 / box_rows
//     boxes (a box never straddles a pool block: box_rows divides bs),
//     reading the block table itself before it waits for a free stage.
//     One consumer warpgroup runs both products on the tensor cores
//     (wgmma): S^T = K_tile Q^T with the tile's rows as the 64-row M side
//     and the G query heads, padded to N = 8 or 16, as B (the swap-AB form
//     of B4's decode); then O^T += V^T P^T with D as M (64-row halves) and
//     the tile's rows as the k depth, P^T written to shared memory in
//     bf16. bf16 rows land 128-byte swizzled and both products read them
//     from shared memory (SS; V^T through the transpose bit). int8 rows
//     land as plain bytes and each thread converts its share once into A
//     fragments in registers (RS; exact, by PRMT into the mantissa of 2^23
//     and one FADD), so a byte is converted once per block, not once per
//     query head; the k and M orders of both products are permuted
//     (kpos, odim, the Q^T layout) so that every thread reads its bytes in
//     whole words, and the scales fold into the logits and probabilities.
//     The online softmax runs per query head across the warpgroup: one
//     named barrier per tile for the column max, row sums kept per thread
//     and reduced once per unit. wgmma was chosen over mma.sync for the
//     single warpgroup-wide product per tile (no per-warp fragment loads
//     of K or V for bf16); no mma.sync build was timed against it.
//   * TMA reads whole boxes, so the partial tiles at lo and hi, the dense
//     tail past S, the next sequence's rows and a free slot's trash block
//     are all loaded. Their logits are selected to M_INIT (never
//     multiplied by a mask), and a partial bf16 tile's V rows outside
//     [lo, hi) are zeroed in shared memory before the PV product (0 x NaN
//     is NaN in a tensor-core product too); an int8 row's values are
//     finite, and its probability times its v-scale is selected to 0.
//   * fp32 (an fp32 cache or pool, or an fp32 query over an int8 pool)
//     stays on the CUDA cores in fp32 (decode_scalar: tensor-core TF32
//     would not hold the fp32 tolerance): the split-KV kernels' per-warp
//     body, whose cp.async loads never read a row outside [lo, hi), on the
//     same units, persistent walk and in-launch merge. Dense and paged fp32
//     run the same code on the same units, so they give the same bits.
//   * Any group size G = H / K from 1 to kMaxGroup (16), as the reference
//     kernel takes any G: decode_tc pads the G query heads with zero rows
//     to NG = 8 or 16 and stores only the G real ones; decode_scalar runs
//     one warp per query head with G read at run time. Nothing assumes
//     that G divides NG or is a power of two (the merge, the partials and
//     the column reductions all index heads by c < G).
//   * head_dim D 64, 96, 128 or 256, as the reference's XLA path takes any
//     D. bf16 rows land as ceil(D / 64) boxes of 64 dims from a 3D tensor
//     map (D, K, rows) whose inner extent is D, so the last box of D 96
//     holds dims 64..95 and TMA's zero fill past D: no byte past the
//     head's own D is read. S^T runs exactly D / 16 k steps; O^T runs
//     ceil(D / 64) 64-row products and the rows past D are never stored
//     (at D 96 a quarter of the second product is that padding). int8
//     rows land as D bytes (boxes of 96 and 256 bytes are legal without a
//     swizzle), each thread's K bytes read in 8- or 16-byte words and its
//     V bytes in 2, 4 or 8 (2 ceil(D / 64) dims of a row). D 256 runs one
//     block per SM so that its 64 KB bf16 stages still make a ring of
//     three; decode_scalar keeps its tiles in dynamic shared memory (87 KB
//     at D 256 fp32, past the 48 KB static limit).

#pragma once

#include <cstring>
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kTileRows = 64;   // rows of a tile (TILE_ROWS in ops/flash.py)
constexpr int kMaxBatch = 1024; // sequences a launch takes (MAX_BATCH)
constexpr int kMaxGroup = 16;   // query heads per KV head (MAX_GROUP)
constexpr int kMaxStages = 4;   // ring depth of decode_tc
constexpr int kCons = 128;      // decode_tc's consumer threads (a warpgroup)
constexpr int kTcThreads = kCons + 32;  // and its producer warp
// decode_tc blocks on an SM (flash.decode_blocks_per_sm): two, or one at
// D 256, whose bf16 stages are 64 KB
template <int D>
constexpr int tc_blocks_per_sm() { return D > 128 ? 1 : 2; }
// dynamic shared bytes a decode_tc block may take, so that its blocks
// (with their static shared memory and the 1 KB reserved per block)
// fit an SM
template <int D>
constexpr int tc_smem_budget() { return D > 128 ? 216 * 1024 : 104 * 1024; }

// Where a launch's rows live and how its windows are cut.
struct Geo {
  int B, H, K, G;
  int limit;      // rows a sequence can hold: S (dense) or M * bs (paged)
  int unit_rows;  // rows of a full work unit, a multiple of kTileRows
  int S;          // dense: rows per sequence
  int bs, M;      // paged: rows per pool block, table columns
  int box_rows;   // rows of one TMA box: 64, or 32 where bs % 64 != 0
};

// Window (b, *): the rows [lo, hi) inside [0, limit), its tile-aligned
// start and its number of units (at least one).
struct Window {
  int lo, hi, alo, n;
};

__device__ __forceinline__ Window window_of(const int* lo_arr,
                                            const int* hi_arr, int b,
                                            const Geo& g) {
  Window w;
  w.lo = lo_arr != nullptr ? max(lo_arr[b], 0) : 0;
  w.hi = min(hi_arr[b], g.limit);
  if (w.hi <= w.lo) {
    w.lo = w.hi = w.alo = 0;
    w.n = 1;
    return w;
  }
  w.alo = w.lo & ~(kTileRows - 1);
  w.n = (w.hi - w.alo + g.unit_rows - 1) / g.unit_rows;
  return w;
}

// prefix[b] = the units of sequences 0 .. b-1 (K windows each); prefix[B]
// is the launch's unit count. Warp 0 scans; the caller syncs the block.
__device__ __forceinline__ void build_prefix(int* prefix, const int* lo_arr,
                                             const int* hi_arr,
                                             const Geo& g) {
  if (threadIdx.x >= 32) return;
  const int lane = threadIdx.x;
  int carry = 0;
  for (int base = 0; base < g.B; base += 32) {
    const int b = base + lane;
    int n = b < g.B ? window_of(lo_arr, hi_arr, b, g).n * g.K : 0;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int t = __shfl_up_sync(0xffffffffu, n, off);
      if (lane >= off) n += t;
    }
    if (b < g.B) prefix[b + 1] = carry + n;
    carry += __shfl_sync(0xffffffffu, n, 31);
  }
  if (lane == 0) prefix[0] = 0;
}

// Unit u: unit j of window (b, kh), rows [r0, r1) of [lo, hi) (r0 tile
// aligned; r1 = r0 for the unit of an empty window), of n units.
struct Unit {
  int b, kh, j, n, lo, hi, r0, r1;
};

__device__ __forceinline__ Unit unit_of(int u, const int* prefix,
                                        const int* lo_arr, const int* hi_arr,
                                        const Geo& g) {
  int a = 0, z = g.B - 1;  // the last b with prefix[b] <= u
  while (a < z) {
    const int mid = (a + z + 1) >> 1;
    if (prefix[mid] <= u) a = mid;
    else z = mid - 1;
  }
  const Window w = window_of(lo_arr, hi_arr, a, g);
  Unit un;
  un.b = a;
  const int local = u - prefix[a];
  un.j = local / g.K;
  un.kh = local - un.j * g.K;
  un.n = w.n;
  un.lo = w.lo;
  un.hi = w.hi;
  un.r0 = w.alo + un.j * g.unit_rows;
  un.r1 = max(min(un.r0 + g.unit_rows, w.hi), un.r0);
  return un;
}

// Row of the cache or pool that holds sequence row r of sequence b, with
// its pool block and offset (paged). A row past the table reads its last
// block: such rows lie past hi and are masked.
template <bool PAGED>
__device__ __forceinline__ int pool_row(const int* table, int b, int r,
                                        const Geo& g, int& blk, int& off) {
  if constexpr (PAGED) {
    blk = table[(size_t)b * g.M + min(r / g.bs, g.M - 1)];
    off = r % g.bs;
    return blk * g.bs + off;
  } else {
    blk = off = 0;
    return b * g.S + r;
  }
}

// The workspace of unit u: acc[G][D], then m[G] and l[G] (fp32), G (D +
// 4) floats in all, so every acc row is 16-byte aligned.
__device__ __forceinline__ float* unit_part(float* part, int u, int G,
                                            int D) {
  return part + (size_t)u * G * (D + 4);
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(uint16_t* p, float4 v) {
  *reinterpret_cast<uint2*>(p) =
      make_uint2(pack_bf16(v.x, v.y), pack_bf16(v.z, v.w));
}

// The normalization of a head's output from its softmax state (m, l):
// out = acc f / den. Without a sink f = 1 and den = max(l, 1e-30). With
// the head's sink logit s, the sink is one more column: the max becomes
// m' = max(m, s), f = exp(m - m') rescales acc and l, and den = max(l f
// + exp(s - m'), 1e-30). An empty window (m = M_INIT, l = 0) gives 0.
__device__ __forceinline__ void sink_norm(float m, float l,
                                          const float* sinks, int head,
                                          float& f, float& den) {
  f = 1.f;
  den = fmaxf(l, 1e-30f);
  if (sinks != nullptr) {
    const float s = sinks[head];
    const float mn = fmaxf(m, s);
    f = expf(m - mn);
    den = fmaxf(l * f + expf(s - mn), 1e-30f);
  }
}

// The last unit of a window merges the window's n partials, units u0,
// u0 + stride, ..., in that order, into out (the window's G x D outputs;
// sinks, if any, the window's G sink logits):
// one thread per 4 dims of a query head, reading kMergeBatch units'
// partials at a time so that their loads are in flight together (the
// partials were written by other SMs: read through L2).
constexpr int kMergeBatch = 8;

template <typename TO>
__device__ __forceinline__ void merge_window(const float* part, int u0,
                                             int stride, int n, int G, int D,
                                             TO* out, const float* sinks,
                                             int tid, int nthr) {
  const size_t per = (size_t)G * (D + 4);
  for (int idx = tid; idx < G * D / 4; idx += nthr) {
    const int g = idx / (D / 4), d = (idx - g * (D / 4)) * 4;
    const float* base = part + (size_t)u0 * per;
    const size_t step = (size_t)stride * per;
    float mx = kMInit;
    for (int j0 = 0; j0 < n; j0 += kMergeBatch) {
      float mm[kMergeBatch];
#pragma unroll
      for (int i = 0; i < kMergeBatch; ++i)
        mm[i] = j0 + i < n ? __ldcg(base + (j0 + i) * step + G * D + g)
                           : kMInit;
#pragma unroll
      for (int i = 0; i < kMergeBatch; ++i) mx = fmaxf(mx, mm[i]);
    }
    float lsum = 0.f;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int j0 = 0; j0 < n; j0 += kMergeBatch) {
      float mm[kMergeBatch], ll[kMergeBatch];
      float4 aa[kMergeBatch];
#pragma unroll
      for (int i = 0; i < kMergeBatch; ++i) {
        if (j0 + i < n) {
          const float* p = base + (j0 + i) * step;
          mm[i] = __ldcg(p + G * D + g);
          ll[i] = __ldcg(p + G * D + G + g);
          aa[i] = __ldcg(reinterpret_cast<const float4*>(p + g * D + d));
        }
      }
#pragma unroll
      for (int i = 0; i < kMergeBatch; ++i) {
        if (j0 + i < n) {
          const float f = expf(mm[i] - mx);
          lsum += ll[i] * f;
          a.x += aa[i].x * f;
          a.y += aa[i].y * f;
          a.z += aa[i].z * f;
          a.w += aa[i].w * f;
        }
      }
    }
    float f, den;
    sink_norm(mx, lsum, sinks, g, f, den);
    const float inv = f / den;
    store4(out + (size_t)g * D + d,
           make_float4(a.x * inv, a.y * inv, a.z * inv, a.w * inv));
  }
}

// -- int8 rows -> floats -------------------------------------------------------

// Signed byte i of a word -> float, exactly and without the quarter-rate
// I2F convert: `flipped` is the word XOR 0x80808080, so each byte holds
// b + 128; placed in the low mantissa of 2^23 (0x4B000000) it reads
// 8388608 + b + 128, and one FADD leaves b.
__device__ __forceinline__ float int8_at(uint32_t flipped, int i) {
  return __uint_as_float(__byte_perm(flipped, 0x4B000000u, 0x7440 | i)) -
         8388736.f;
}

__device__ __forceinline__ void load_chunk(const int8_t* p, float (&o)[16]) {
  const uint4 t = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {t.x ^ 0x80808080u, t.y ^ 0x80808080u,
                         t.z ^ 0x80808080u, t.w ^ 0x80808080u};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) o[4 * i + j] = int8_at(w[i], j);
}

// one lane's VEC = D/32 bytes of a row (VEC 2, 3, 4 or 8; p is aligned
// to the widest load that divides VEC)
template <int VEC>
__device__ __forceinline__ void load_row(const int8_t* p, float (&o)[VEC]) {
  if constexpr (VEC % 4 == 0) {
#pragma unroll
    for (int i = 0; i < VEC; i += 4) {
      const uint32_t w =
          *reinterpret_cast<const uint32_t*>(p + i) ^ 0x80808080u;
#pragma unroll
      for (int j = 0; j < 4; ++j) o[i + j] = int8_at(w, j);
    }
  } else if constexpr (VEC == 2) {
    const uint32_t w = *reinterpret_cast<const uint16_t*>(p) ^ 0x8080u;
    o[0] = int8_at(w, 0); o[1] = int8_at(w, 1);
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) o[i] = static_cast<float>(p[i]);
  }
}

// NB bytes of an int8 row (2, 4 or 8; p NB-aligned), XOR 0x80 per byte,
// as words: byte e is int8_at(w[e / 4], e % 4)
template <int NB>
__device__ __forceinline__ void load_flipped(const uint8_t* p,
                                             uint32_t (&w)[NB > 4 ? 2 : 1]) {
  if constexpr (NB == 8) {
    const uint2 t = *reinterpret_cast<const uint2*>(p);
    w[0] = t.x ^ 0x80808080u;
    w[1] = t.y ^ 0x80808080u;
  } else if constexpr (NB == 4) {
    w[0] = *reinterpret_cast<const uint32_t*>(p) ^ 0x80808080u;
  } else {
    w[0] = (uint32_t)*reinterpret_cast<const uint16_t*>(p) ^ 0x8080u;
  }
}

// -- decode_tc: bf16 queries over bf16 or int8 rows -----------------------------

// Shared memory of a decode_tc block (dynamic part, 1024-byte aligned):
// `stages` ring stages, then Q^T (kBoxes boxes of up to 16 rows x 128
// bytes) and P^T (16 rows x 128 bytes). A bf16 stage holds the K tile
// then the V tile, each kBoxes boxes of 64 rows x 128 bytes (128-byte
// swizzle; the last box zero past D); an int8 stage holds K and V as 64
// rows x D bytes (no swizzle), then the tile's 64 k-scales and 64
// v-scales.
template <int D, bool INT8>
struct TcLayout {
  // 64-dim boxes of a bf16 row (the last one zero-filled past D)
  static constexpr int kBoxes = (D + 63) / 64;
  static constexpr int kKv =
      INT8 ? kTileRows * D : kBoxes * kTileRows * 128;
  static constexpr int kTx = 2 * kKv + (INT8 ? 2 * kTileRows * 4 : 0);
  static constexpr int kStage = (kTx + 1023) / 1024 * 1024;
  static constexpr int kQBox = 16 * 128;
  static constexpr int kFixed = kBoxes * kQBox + 16 * 128;
  static int stages() {
    const int s = (tc_smem_budget<D>() - 1024 - kFixed) / kStage;
    return s < kMaxStages ? s : kMaxStages;
  }
  static int smem(int stages) { return 1024 + stages * kStage + kFixed; }
};

// Grid `grid` (persistent), kTcThreads threads: one consumer warpgroup,
// then the producer warp. NG: the G query heads padded to 8 or 16.
template <int D, int NG, bool INT8, bool PAGED>
__global__ void __launch_bounds__(kTcThreads, tc_blocks_per_sm<D>())
decode_tc(const __grid_constant__ CUtensorMap tmk,
          const __grid_constant__ CUtensorMap tmv,
          const __grid_constant__ CUtensorMap tmks,
          const __grid_constant__ CUtensorMap tmvs,
          const uint16_t* __restrict__ q, const int* __restrict__ table,
          const int* __restrict__ lo_arr, const int* __restrict__ hi_arr,
          uint16_t* __restrict__ out, float* __restrict__ part,
          int* __restrict__ cnt, const float* __restrict__ sinks,
          const Geo g, int stages, float scale, float softcap) {
  using L = TcLayout<D, INT8>;
  constexpr int NCOL = NG / 4;  // query-head columns a thread holds
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[2 * kMaxStages];
  __shared__ int prefix[kMaxBatch + 1];
  __shared__ float red[2][4][NG];  // per-warp column max, by tile parity
  __shared__ float redl[4][NG];    // per-warp row sums of a unit
  __shared__ int is_last;
  uint64_t* const full = bars;                // TMA landed in stage s
  uint64_t* const empty = bars + kMaxStages;  // the consumers done with s
  uint8_t* const ring =
      smem_raw + ((1024u - (smem_addr(smem_raw) & 1023u)) & 1023u);
  uint8_t* const Qs = ring + stages * L::kStage;
  uint8_t* const Ps = Qs + L::kBoxes * L::kQBox;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kCons / 32);
    }
    mbar_fence_init();
  }
  build_prefix(prefix, lo_arr, hi_arr, g);
  __syncthreads();
  const int total = prefix[g.B];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (warp == kCons / 32) {
    // ---- producer: one thread keeps the ring full across units ----------
    if (lane == 0) {
      const int nbox = kTileRows / g.box_rows;
      int gi = 0;
      for (int u = blockIdx.x; u < total; u += gridDim.x) {
        const Unit un = unit_of(u, prefix, lo_arr, hi_arr, g);
        for (int r0 = un.r0; r0 < un.r1; r0 += kTileRows, ++gi) {
          const int s = gi % stages, lap = gi / stages;
          // the boxes' rows (table reads) before the wait, so that their
          // latency overlaps it
          int prows[2], blks[2], offs[2];
          for (int x = 0; x < nbox; ++x)
            prows[x] = pool_row<PAGED>(table, un.b, r0 + x * g.box_rows, g,
                                       blks[x], offs[x]);
          if (lap > 0) mbar_wait(&empty[s], (lap - 1) & 1);
          uint8_t* st = ring + s * L::kStage;
          mbar_arrive_expect_tx(&full[s], L::kTx);
          for (int x = 0; x < nbox; ++x) {
            const int prow = prows[x], blk = blks[x], off = offs[x];
            if constexpr (INT8) {
              const int rb = x * g.box_rows;
              tma_load_2d(st + rb * D, &tmk, &full[s], un.kh * D, prow);
              tma_load_2d(st + L::kKv + rb * D, &tmv, &full[s], un.kh * D,
                          prow);
              const int srow = blk * g.K + un.kh;
              tma_load_2d(st + 2 * L::kKv + rb * 4, &tmks, &full[s], off,
                          srow);
              tma_load_2d(st + 2 * L::kKv + kTileRows * 4 + rb * 4, &tmvs,
                          &full[s], off, srow);
            } else {
              const int rb = x * g.box_rows * 128;
#pragma unroll
              for (int db = 0; db < L::kBoxes; ++db) {
                tma_load_3d(st + db * 8192 + rb, &tmk, &full[s], db * 64,
                            un.kh, prow);
                tma_load_3d(st + L::kKv + db * 8192 + rb, &tmv, &full[s],
                            db * 64, un.kh, prow);
              }
            }
          }
        }
      }
    }
    return;
  }

  // ---- consumers: one warpgroup ---------------------------------------------
  // Accumulator element i of S^T (m64nNG) and of each O^T half: row
  // 16 warp + lane / 4 + 8 ((i >> 1) & 1), column 8 (i >> 2) + 2 (lane % 4)
  // + (i & 1); the thread's column k = 2 (i >> 2) + (i & 1).
  const int tid = threadIdx.x;
  const int ra = 16 * warp + (lane >> 2);
  const int c0 = 2 * (lane & 3);
  const uint32_t q_addr = smem_addr(Qs), p_addr = smem_addr(Ps);
  auto col_of = [&](int k) { return 8 * (k >> 1) + c0 + (k & 1); };
  // int8 rows run both products with A from registers, in permuted k and
  // M orders that let each thread read its bytes in whole words:
  //   S^T: logical k 2t, 2t+1 | 2t+8, 2t+9 of step kc are dims
  //     kdim(t, kc) = t D/4 + 4 kc, + 1 | + 2, + 3 (Q^T is written so);
  //   O^T: logical k 2t, 2t+1 | 2t+8, 2t+9 of step kc are tile rows
  //     16 kc + 4t, + 1 | + 2, + 3 (kpos: where P^T holds tile row R),
  //     and accumulator row 16 warp + lane / 4 + 8 j of half h is dim
  //     odim(h, j) = kVB (8 warp + lane / 4) + 2h + j, kVB = 2 kBoxes
  //     (2, 4, 4, 8 at D 64, 96, 128, 256), so a thread's dims are
  //     adjacent bytes (at D 96 those from 96 on are padding, never
  //     stored).
  auto kpos = [](int R) {
    if constexpr (!INT8) return R;
    const int r = R & 15;
    return (R & ~15) + 2 * (r >> 2) + (r & 1) + 8 * ((r >> 1) & 1);
  };
  constexpr int kVB = 2 * L::kBoxes;  // int8 V bytes of a row per thread
  auto odim = [&](int h, int i) {
    const int j = (i >> 1) & 1;
    if constexpr (INT8) return kVB * (8 * warp + (lane >> 2)) + 2 * h + j;
    return 64 * h + ra + 8 * j;
  };
  const int G = g.G;
  // Q^T as B: G rows of D (raw bf16, zero rows to NG), swizzled; this
  // thread's 16-byte chunks of a unit's Q are loaded one unit ahead
  constexpr int QCH = (NG * (D / 8) + kCons - 1) / kCons;
  uint4 qn[QCH];
  auto load_q = [&](int u) {
    if (u >= total) return;
    const Unit un = unit_of(u, prefix, lo_arr, hi_arr, g);
    const uint16_t* qrow = q + ((size_t)un.b * g.H + un.kh * G) * D;
#pragma unroll
    for (int i = 0; i < QCH; ++i) {
      const int idx = tid + i * kCons, r = idx / (D / 8);
      qn[i] = make_uint4(0u, 0u, 0u, 0u);
      if (r >= G) continue;
      if constexpr (INT8) {
        // logical chunk c: k step c / 2, positions 8 (c % 2) .. + 7, i.e.
        // dim pairs kdim(t, c / 2) + 2 (c % 2) of t = 0 .. 3
        const int c = idx - r * (D / 8);
        const uint32_t* q32 =
            reinterpret_cast<const uint32_t*>(qrow + (size_t)r * D);
        const int w0 = (4 * (c >> 1) + 2 * (c & 1)) >> 1;
        qn[i] = make_uint4(q32[w0], q32[w0 + D / 8], q32[w0 + D / 4],
                           q32[w0 + 3 * D / 8]);
      } else {
        qn[i] = *reinterpret_cast<const uint4*>(qrow + (size_t)idx * 8);
      }
    }
  };
  load_q(blockIdx.x);
  int gi = 0;
  for (int u = blockIdx.x; u < total; u += gridDim.x) {
    const Unit un = unit_of(u, prefix, lo_arr, hi_arr, g);
#pragma unroll
    for (int i = 0; i < QCH; ++i) {
      const int idx = tid + i * kCons;
      const int r = idx / (D / 8), c = idx - r * (D / 8);
      if (r < NG)
        *reinterpret_cast<uint4*>(Qs + (c >> 3) * L::kQBox + r * 128 +
                                  (((c & 7) ^ (r & 7)) << 4)) = qn[i];
    }
    load_q(u + gridDim.x);
    fence_proxy_async();
    named_bar_sync(1, kCons);

    float m[NCOL], lp[NCOL], o[L::kBoxes][NG / 2];
#pragma unroll
    for (int k = 0; k < NCOL; ++k) {
      m[k] = kMInit;
      lp[k] = 0.f;
    }
#pragma unroll
    for (int h = 0; h < L::kBoxes; ++h)
#pragma unroll
      for (int i = 0; i < NG / 2; ++i) o[h][i] = 0.f;

    for (int r0 = un.r0; r0 < un.r1; r0 += kTileRows, ++gi) {
      const int s = gi % stages;
      uint8_t* st = ring + s * L::kStage;
      mbar_wait(&full[s], (gi / stages) & 1);
      const int rowa = r0 + ra, rowb = rowa + 8;
      const bool va = rowa >= un.lo && rowa < un.hi;
      const bool vb = rowb >= un.lo && rowb < un.hi;
      uint32_t k_addr, v_addr;
      float ksa = 1.f, ksb = 1.f, vsa = 0.f, vsb = 0.f;
      if constexpr (INT8) {
        const float* sc = reinterpret_cast<const float*>(st + 2 * L::kKv);
        ksa = sc[ra];
        ksb = sc[ra + 8];
        vsa = sc[kTileRows + ra];
        vsb = sc[kTileRows + ra + 8];
        k_addr = v_addr = 0;
      } else {
        k_addr = smem_addr(st);
        v_addr = k_addr + L::kKv;
        if (r0 < un.lo || r0 + kTileRows > un.hi) {
          // a partial tile: zero its V rows outside [lo, hi) (made
          // visible to the PV product by the fence and barrier below)
          uint4* vt = reinterpret_cast<uint4*>(st + L::kKv);
          for (int idx = tid; idx < L::kBoxes * kTileRows * 8;
               idx += kCons) {
            const int row = r0 + ((idx >> 3) & (kTileRows - 1));
            if (row < un.lo || row >= un.hi)
              vt[idx] = make_uint4(0u, 0u, 0u, 0u);
          }
        }
      }

      // S^T = K_tile Q^T: D / 16 k16 steps, +32 bytes inside a 64-dim
      // box, the next box every 4 steps
      float sacc[NG / 2];
#pragma unroll
      for (int i = 0; i < NG / 2; ++i) sacc[i] = 0.f;
      if constexpr (INT8) {
        // A = the K rows ra, ra + 8 from registers, converted here once:
        // k step kc of lane t takes dims kdim(t, kc) .. + 3 (see Q above),
        // the thread's D / 4 bytes read KW words at a time (16-byte loads,
        // 8-byte ones at D 96, where D / 4 = 24)
        constexpr int KW = (D / 4) % 16 == 0 ? 4 : 2;
        uint32_t ka[D / 16][4];
        const uint8_t* kra = st + ra * D + (lane & 3) * (D / 4);
#pragma unroll
        for (int c = 0; c < D / 16; c += KW) {
          uint32_t xa[KW], xb[KW];
          if constexpr (KW == 4) {
            const uint4 wa = *reinterpret_cast<const uint4*>(kra + 4 * c);
            const uint4 wb =
                *reinterpret_cast<const uint4*>(kra + 8 * D + 4 * c);
            xa[0] = wa.x; xa[1] = wa.y; xa[2] = wa.z; xa[3] = wa.w;
            xb[0] = wb.x; xb[1] = wb.y; xb[2] = wb.z; xb[3] = wb.w;
          } else {
            const uint2 wa = *reinterpret_cast<const uint2*>(kra + 4 * c);
            const uint2 wb =
                *reinterpret_cast<const uint2*>(kra + 8 * D + 4 * c);
            xa[0] = wa.x; xa[1] = wa.y;
            xb[0] = wb.x; xb[1] = wb.y;
          }
#pragma unroll
          for (int e = 0; e < KW; ++e) {
            const uint32_t fa = xa[e] ^ 0x80808080u, fb = xb[e] ^ 0x80808080u;
            uint32_t(&a)[4] = ka[c + e];
            a[0] = pack_bf16(int8_at(fa, 0), int8_at(fa, 1));
            a[1] = pack_bf16(int8_at(fb, 0), int8_at(fb, 1));
            a[2] = pack_bf16(int8_at(fa, 2), int8_at(fa, 3));
            a[3] = pack_bf16(int8_at(fb, 2), int8_at(fb, 3));
          }
        }
        wgmma_fence();
#pragma unroll
        for (int kc = 0; kc < D / 16; ++kc)
          wgmma_rs_k<NG>(sacc, ka[kc],
                         sw128_desc(q_addr + (kc >> 2) * L::kQBox +
                                        (kc & 3) * 32, 16, 1024));
        wgmma_commit();
        wgmma_wait<0>();
#pragma unroll
        for (int kc = 0; kc < D / 16; ++kc) reg_fence(ka[kc]);
      } else {
        wgmma_fence();
#pragma unroll
        for (int kc = 0; kc < D / 16; ++kc)
          wgmma_ss_n<NG, 0>(
              sacc,
              sw128_desc(k_addr + (kc >> 2) * 8192 + (kc & 3) * 32, 16, 1024),
              sw128_desc(q_addr + (kc >> 2) * L::kQBox + (kc & 3) * 32, 16,
                         1024),
              kc > 0);
        wgmma_commit();
        wgmma_wait<0>();
      }

      // logits: (int8: x k-scale) x scale, softcap, rows outside [lo, hi)
      // selected to M_INIT; the tile's max per query head
      float tmax[NCOL];
#pragma unroll
      for (int k = 0; k < NCOL; ++k) tmax[k] = kMInit;
#pragma unroll
      for (int i = 0; i < NG / 2; ++i) {
        const bool rb = (i >> 1) & 1;
        const int k = 2 * (i >> 2) + (i & 1);
        float x = sacc[i];
        if constexpr (INT8) x *= rb ? ksb : ksa;
        x *= scale;
        if (softcap > 0.f) x = tanhf(x / softcap) * softcap;
        x = (rb ? vb : va) ? x : kMInit;
        sacc[i] = x;
        tmax[k] = fmaxf(tmax[k], x);
      }
      const int par = gi & 1;
#pragma unroll
      for (int k = 0; k < NCOL; ++k) {
        tmax[k] = fmaxf(tmax[k], __shfl_xor_sync(0xffffffffu, tmax[k], 4));
        tmax[k] = fmaxf(tmax[k], __shfl_xor_sync(0xffffffffu, tmax[k], 8));
        tmax[k] = fmaxf(tmax[k], __shfl_xor_sync(0xffffffffu, tmax[k], 16));
        if (lane < 4) red[par][warp][col_of(k)] = tmax[k];
      }
      named_bar_sync(1, kCons);
      float alpha[NCOL];
#pragma unroll
      for (int k = 0; k < NCOL; ++k) {
        const int c = col_of(k);
        const float t = fmaxf(fmaxf(red[par][0][c], red[par][1][c]),
                              fmaxf(red[par][2][c], red[par][3][c]));
        const float mn = fmaxf(m[k], t);
        alpha[k] = expf(m[k] - mn);
        m[k] = mn;
        lp[k] *= alpha[k];
      }
      // probabilities; P^T (bf16, rows = query heads, k = tile rows) as
      // the B operand of the PV product, 128-byte swizzled
#pragma unroll
      for (int i = 0; i < NG / 2; ++i) {
        const bool rb = (i >> 1) & 1;
        const int k = 2 * (i >> 2) + (i & 1);
        const bool valid = rb ? vb : va;
        const float p = valid ? expf(sacc[i] - m[k]) : 0.f;
        lp[k] += p;
        float pv = p;
        if constexpr (INT8) pv = valid ? p * (rb ? vsb : vsa) : 0.f;
        const int row = kpos(ra + 8 * rb), c = col_of(k);
        *reinterpret_cast<uint16_t*>(Ps + c * 128 +
                                     (((row >> 3) ^ (c & 7)) << 4) +
                                     (row & 7) * 2) = to_bf16(pv);
      }
#pragma unroll
      for (int h = 0; h < L::kBoxes; ++h)
#pragma unroll
        for (int i = 0; i < NG / 2; ++i)
          o[h][i] *= alpha[2 * (i >> 2) + (i & 1)];
      fence_proxy_async();
      named_bar_sync(1, kCons);

      // O^T += V^T P^T: per 64-dim half, 4 k16 steps of 16 V rows (2 KB);
      // V^T is the MN-major A operand (the transpose bit)
      if constexpr (INT8) {
        // A = V^T from registers: this thread's dims odim(h, j) of rows
        // 16 kc + 4t .. + 3, the k order of P^T (kpos)
        // (at D 96 the dims from 96 on read the next row's bytes: finite,
        // and only padding rows of O^T take them)
        uint32_t vfr[L::kBoxes][kTileRows / 16][4];
        const uint8_t* vt = st + L::kKv + (lane & 3) * 4 * D +
                            kVB * (8 * warp + (lane >> 2));
#pragma unroll
        for (int kc = 0; kc < kTileRows / 16; ++kc) {
          uint32_t w[4][kVB > 4 ? 2 : 1];
#pragma unroll
          for (int x = 0; x < 4; ++x)
            load_flipped<kVB>(vt + (16 * kc + x) * D, w[x]);
          auto at = [&](int x, int e) { return int8_at(w[x][e >> 2], e & 3); };
#pragma unroll
          for (int h = 0; h < L::kBoxes; ++h) {
            const int e0 = 2 * h, e1 = 2 * h + 1;
            vfr[h][kc][0] = pack_bf16(at(0, e0), at(1, e0));
            vfr[h][kc][1] = pack_bf16(at(0, e1), at(1, e1));
            vfr[h][kc][2] = pack_bf16(at(2, e0), at(3, e0));
            vfr[h][kc][3] = pack_bf16(at(2, e1), at(3, e1));
          }
        }
        wgmma_fence();
#pragma unroll
        for (int h = 0; h < L::kBoxes; ++h)
#pragma unroll
          for (int kc = 0; kc < kTileRows / 16; ++kc)
            wgmma_rs_k<NG>(o[h], vfr[h][kc],
                           sw128_desc(p_addr + kc * 32, 16, 1024));
        wgmma_commit();
        wgmma_wait<0>();
#pragma unroll
        for (int h = 0; h < L::kBoxes; ++h)
#pragma unroll
          for (int kc = 0; kc < kTileRows / 16; ++kc) reg_fence(vfr[h][kc]);
      } else {
        wgmma_fence();
#pragma unroll
        for (int h = 0; h < L::kBoxes; ++h)
#pragma unroll
          for (int kc = 0; kc < kTileRows / 16; ++kc)
            wgmma_ss_n<NG, 1>(
                o[h], sw128_desc(v_addr + h * 8192 + kc * 2048, 8192, 1024),
                sw128_desc(p_addr + kc * 32, 16, 1024), 1);
        wgmma_commit();
        wgmma_wait<0>();
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);  // this warp is done with s
    }

    // ---- the unit's end: row sums, then the output or the partial --------
    float l[NCOL];
#pragma unroll
    for (int k = 0; k < NCOL; ++k) {
      lp[k] += __shfl_xor_sync(0xffffffffu, lp[k], 4);
      lp[k] += __shfl_xor_sync(0xffffffffu, lp[k], 8);
      lp[k] += __shfl_xor_sync(0xffffffffu, lp[k], 16);
      if (lane < 4) redl[warp][col_of(k)] = lp[k];
    }
    named_bar_sync(1, kCons);
#pragma unroll
    for (int k = 0; k < NCOL; ++k) {
      const int c = col_of(k);
      l[k] = ((redl[0][c] + redl[1][c]) + redl[2][c]) + redl[3][c];
    }
    uint16_t* const obase = out + ((size_t)un.b * g.H + un.kh * G) * D;
    const float* const wsinks = sinks != nullptr ? sinks + un.kh * G : nullptr;
    if (un.n == 1) {
      float f[NCOL], den[NCOL];
#pragma unroll
      for (int k = 0; k < NCOL; ++k)
        sink_norm(m[k], l[k], wsinks, min(col_of(k), G - 1), f[k], den[k]);
#pragma unroll
      for (int h = 0; h < L::kBoxes; ++h)
#pragma unroll
        for (int i = 0; i < NG / 2; ++i) {
          const int k = 2 * (i >> 2) + (i & 1), c = col_of(k);
          const int d = odim(h, i);
          if (c < G && d < D)
            obase[c * D + d] = to_bf16(o[h][i] * f[k] / den[k]);
        }
      continue;
    }
    float* const pp = unit_part(part, u, G, D);
#pragma unroll
    for (int h = 0; h < L::kBoxes; ++h)
#pragma unroll
      for (int i = 0; i < NG / 2; ++i) {
        const int c = col_of(2 * (i >> 2) + (i & 1));
        const int d = odim(h, i);
        if (c < G && d < D) __stcg(pp + c * D + d, o[h][i]);
      }
    if (warp == 0 && lane < 4) {
#pragma unroll
      for (int k = 0; k < NCOL; ++k) {
        const int c = col_of(k);
        if (c < G) {
          __stcg(pp + G * D + c, m[k]);
          __stcg(pp + G * D + G + c, l[k]);
        }
      }
    }
    if (last_split(cnt, un.b * g.K + un.kh, un.n, kCons, tid, 2, is_last))
      merge_window(part, prefix[un.b] + un.kh, g.K, un.n, G, D, obase,
                   wsinks, tid, kCons);
  }
}

// -- decode_scalar: fp32, on the CUDA cores -------------------------------------

// Grid `grid` (persistent), G = g.G warps (G * 32 threads, G at most
// kMaxGroup): warp g is query head g of the unit's KV head. The unit's
// rows in 32-row tiles: the whole block copies the K/V rows inside
// [lo, hi) (and, int8, the tile's scale runs) into shared memory with
// cp.async (rows outside are zero-filled, never read), two stages deep for
// int8; lane r of warp g scores row r for head g, one max and one sum per
// tile update the online softmax, and lane r accumulates dims
// [r D/32, (r + 1) D/32) of P V. The tiles, scales, queries and
// probabilities live in dynamic shared memory (ScalarLayout).
template <typename TKV, int D>
struct ScalarLayout {
  static constexpr bool QUANT = std::is_same<TKV, int8_t>::value;
  static constexpr int kT = 32;                    // rows per tile
  static constexpr int EPC = 16 / sizeof(TKV);     // elements per 16 bytes
  static constexpr int RS = D + EPC;               // padded row (elements)
  static constexpr int STAGES = sizeof(TKV) <= 2 ? 2 : 1;
  static constexpr int kTile = STAGES * kT * RS * (int)sizeof(TKV);
  static constexpr int kScales = STAGES * 2 * (QUANT ? kT : 4) * 4;
  static constexpr int kQ = kMaxGroup * D * 4;
  // Ks, Vs, Ss, qs, ps (every part a multiple of 16 bytes)
  static constexpr int kSmem = 2 * kTile + kScales + kQ + kMaxGroup * kT * 4;
};

template <typename TKV, int D, bool PAGED>
__global__ void __launch_bounds__(kMaxGroup * 32)
decode_scalar(const float* __restrict__ q, const TKV* __restrict__ kpool,
              const TKV* __restrict__ vpool,
              const float* __restrict__ kscale,
              const float* __restrict__ vscale,
              const int* __restrict__ table, const int* __restrict__ lo_arr,
              const int* __restrict__ hi_arr, float* __restrict__ out,
              float* __restrict__ part, int* __restrict__ cnt,
              const float* __restrict__ sinks, const Geo g, float scale,
              float softcap) {
  using L = ScalarLayout<TKV, D>;
  constexpr bool QUANT = L::QUANT;
  constexpr int kT = L::kT;
  const int G = g.G;
  const int NT = G * 32;                      // threads
  constexpr int EPC = L::EPC;
  constexpr int CPR = D / EPC;                // chunks per row
  constexpr int RS = L::RS;
  constexpr int STAGES = L::STAGES;
  constexpr int VEC = D / 32;                 // output dims per lane
  extern __shared__ __align__(16) uint8_t scalar_smem[];
  auto Ks = reinterpret_cast<TKV(*)[kT][RS]>(scalar_smem);
  auto Vs = reinterpret_cast<TKV(*)[kT][RS]>(scalar_smem + L::kTile);
  // int8 only: [stage][k or v][row] scales of the tile and KV head
  auto Ss = reinterpret_cast<float(*)[2][QUANT ? kT : 4]>(
      scalar_smem + 2 * L::kTile);
  auto qs = reinterpret_cast<float(*)[D]>(scalar_smem + 2 * L::kTile +
                                          L::kScales);
  auto ps = reinterpret_cast<float(*)[kT]>(
      scalar_smem + 2 * L::kTile + L::kScales + L::kQ);
  __shared__ int prefix[kMaxBatch + 1];
  __shared__ int is_last;

  build_prefix(prefix, lo_arr, hi_arr, g);
  __syncthreads();
  const int total = prefix[g.B];
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int K = g.K;

  for (int u = blockIdx.x; u < total; u += gridDim.x) {
    const Unit un = unit_of(u, prefix, lo_arr, hi_arr, g);
    const int b = un.b, kh = un.kh;
    const int ntiles = (un.r1 - un.r0 + kT - 1) / kT;
    __syncthreads();  // the last unit is done with qs and the tiles
    for (int i = threadIdx.x; i < G * D; i += NT)
      qs[i / D][i % D] = q[((size_t)b * g.H + kh * G + i / D) * D + i % D] *
                         scale;

    auto load_tile = [&](int t, int buf) {
      const int row0 = un.r0 + t * kT;
      int blk, off0;
      const size_t prow = pool_row<PAGED>(table, b, row0, g, blk, off0);
      for (int idx = threadIdx.x; idx < kT * CPR; idx += NT) {
        const int r = idx / CPR, c = (idx % CPR) * EPC;
        const int row = row0 + r;
        const bool ok = row >= un.lo && row < un.hi;
        const size_t src = ((prow + (ok ? r : 0)) * K + kh) * D + c;
        cp_async16(&Ks[buf][r][c], kpool + src, ok ? 16 : 0);
        cp_async16(&Vs[buf][r][c], vpool + src, ok ? 16 : 0);
      }
      if constexpr (QUANT) {
        // 2 x 128 contiguous bytes: threads 0-7 the k run, 8-15 the v run
        if (threadIdx.x < 16) {
          const int which = threadIdx.x >> 3, c = (threadIdx.x & 7) * 4;
          const float* plane = which ? vscale : kscale;
          cp_async16(&Ss[buf][which][c],
                     plane + ((size_t)blk * K + kh) * g.bs + off0 + c, 16);
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

      const int row = un.r0 + t * kT + lane;
      const bool valid = row >= un.lo && row < un.hi;
      float s = 0.f;
#pragma unroll
      for (int c = 0; c < D; c += EPC) {
        float kf[EPC];
        load_chunk(&Ks[buf][lane][c], kf);
#pragma unroll
        for (int e = 0; e < EPC; ++e) s = fmaf(qs[w][c + e], kf[e], s);
      }
      if constexpr (QUANT) s *= Ss[buf][0][lane];
      if (softcap > 0.f) s = tanhf(s / softcap) * softcap;
      const float m_new = fmaxf(m, warp_max(valid ? s : kMInit));
      const float alpha = expf(m - m_new);
      const float p = valid ? expf(s - m_new) : 0.f;
      l = l * alpha + warp_sum(p);
      m = m_new;
      if constexpr (QUANT) {
        ps[w][lane] = valid ? p * Ss[buf][1][lane] : 0.f;
      } else {
        ps[w][lane] = p;
      }
      __syncwarp();
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[i] *= alpha;
#pragma unroll 8
      for (int r = 0; r < kT; ++r) {
        const float pr = ps[w][r];
        float vf[VEC];
        load_row<VEC>(&Vs[buf][r][lane * VEC], vf);
#pragma unroll
        for (int i = 0; i < VEC; ++i) acc[i] = fmaf(pr, vf[i], acc[i]);
      }
      __syncthreads();  // tile t consumed before its buffer is refilled
      if (STAGES == 1 && t + 1 < ntiles) load_tile(t + 1, 0);
    }

    float* const obase = out + ((size_t)b * g.H + kh * G) * D;
    const float* const wsinks = sinks != nullptr ? sinks + kh * G : nullptr;
    if (un.n == 1) {
      float f, den;
      sink_norm(m, l, wsinks, w, f, den);
      const float inv = f / den;
#pragma unroll
      for (int i = 0; i < VEC; ++i)
        obase[w * D + lane * VEC + i] = acc[i] * inv;
      continue;
    }
    float* const pp = unit_part(part, u, G, D);
#pragma unroll
    for (int i = 0; i < VEC; ++i)
      __stcg(pp + w * D + lane * VEC + i, acc[i]);
    if (lane == 0) {
      __stcg(pp + G * D + w, m);
      __stcg(pp + G * D + G + w, l);
    }
    if (last_split(cnt, b * K + kh, un.n, NT, threadIdx.x, 1, is_last))
      merge_window(part, prefix[b] + kh, K, un.n, G, D, obase, wsinks,
                   threadIdx.x, NT);
  }
}

// -- host ------------------------------------------------------------------------

// The bf16 rows [rows, K, D] as the 3D tensor map (D, K, rows) with box
// (64, 1, box_rows) and the 128-byte swizzle (the layout the wgmma
// descriptors read): a box at dim 64 of D 96 reads dims 64..95 and is
// zero past them.
inline bool kv_map_bf16(CUtensorMap* map, const void* base, int D, int K,
                        long rows, int box_rows) {
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)K,
                              (cuuint64_t)rows};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)K * D * 2};
  const cuuint32_t box[3] = {64, 1, (cuuint32_t)box_rows};
  return encode_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, base, dims,
                    strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
}

// A row-major [d1, d0] tensor of `esize`-byte elements as a 2D tensor map
// with box (b0, b1), no swizzle: int8 rows and fp32 scales.
inline bool decode_map(CUtensorMap* map, CUtensorMapDataType type, int esize,
                       const void* base, long d0, long d1, int b0,
                       int b1) {
  const cuuint64_t dims[2] = {(cuuint64_t)d0, (cuuint64_t)d1};
  const cuuint64_t strides[1] = {(cuuint64_t)d0 * esize};
  const cuuint32_t box[2] = {(cuuint32_t)b0, (cuuint32_t)b1};
  return encode_map(map, type, 2, base, dims, strides, box,
                    CU_TENSOR_MAP_SWIZZLE_NONE);
}

// The arguments of one launch of either kernel.
struct DecodeArgs {
  const void* q;
  const void* k;
  const void* v;
  const float* k_scale;
  const float* v_scale;
  const int* table;  // paged only
  const int* lo;
  const int* hi;
  void* out;
  float* part;
  int* cnt;
  const float* sinks;  // [H] fp32 sink logits, or null (no sinks)
  long rows;  // rows of the cache or pool: B * S, or N * bs
  Geo geo;
  int grid;
  float scale, softcap;
  cudaStream_t stream;
};

template <int D, int NG, bool INT8, bool PAGED>
cudaError_t launch_tc(const DecodeArgs& a) {
  using L = TcLayout<D, INT8>;
  CUtensorMap tmk, tmv, tmks, tmvs;
  memset(&tmks, 0, sizeof(tmks));
  memset(&tmvs, 0, sizeof(tmvs));
  bool ok;
  if constexpr (INT8) {
    const int KD = a.geo.K * D;
    const long srows = a.rows / a.geo.bs * a.geo.K;  // scale runs [N K, bs]
    ok = decode_map(&tmk, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, a.k, KD, a.rows,
                    D, a.geo.box_rows) &&
         decode_map(&tmv, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, a.v, KD, a.rows,
                    D, a.geo.box_rows) &&
         decode_map(&tmks, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, a.k_scale,
                    a.geo.bs, srows, a.geo.box_rows, 1) &&
         decode_map(&tmvs, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, a.v_scale,
                    a.geo.bs, srows, a.geo.box_rows, 1);
  } else {
    ok = kv_map_bf16(&tmk, a.k, D, a.geo.K, a.rows, a.geo.box_rows) &&
         kv_map_bf16(&tmv, a.v, D, a.geo.K, a.rows, a.geo.box_rows);
  }
  if (!ok) return cudaErrorInvalidValue;
  auto kern = decode_tc<D, NG, INT8, PAGED>;
  const int stages = L::stages();
  const int smem = L::smem(stages);
  static int smem_allowed = 48 * 1024;
  if (smem > smem_allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    smem_allowed = smem;
  }
  kern<<<a.grid, kTcThreads, smem, a.stream>>>(
      tmk, tmv, tmks, tmvs, static_cast<const uint16_t*>(a.q), a.table, a.lo,
      a.hi, static_cast<uint16_t*>(a.out), a.part, a.cnt, a.sinks, a.geo,
      stages, a.scale, a.softcap);
  return cudaGetLastError();
}

template <int D, bool INT8, bool PAGED>
cudaError_t dispatch_tc(const DecodeArgs& a) {
  return a.geo.G <= 8 ? launch_tc<D, 8, INT8, PAGED>(a)
                      : launch_tc<D, 16, INT8, PAGED>(a);
}

template <typename TKV, int D, bool PAGED>
cudaError_t dispatch_scalar(const DecodeArgs& a) {
  auto kern = decode_scalar<TKV, D, PAGED>;
  constexpr int smem = ScalarLayout<TKV, D>::kSmem;
  static bool smem_set = false;
  if (!smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    smem_set = true;
  }
  kern<<<a.grid, a.geo.G * 32, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const TKV*>(a.k),
      static_cast<const TKV*>(a.v), a.k_scale, a.v_scale, a.table, a.lo,
      a.hi, static_cast<float*>(a.out), a.part, a.cnt, a.sinks, a.geo,
      a.scale, a.softcap);
  return cudaGetLastError();
}

// The checks every launch shares: batch, heads, groups, head_dim, units,
// grid.
inline bool decode_geo_ok(const Geo& g, int D, int grid) {
  const int G = g.G;
  return g.B >= 1 && g.B <= kMaxBatch && g.K >= 1 && g.H == g.K * G &&
         G >= 1 && G <= kMaxGroup &&
         (D == 64 || D == 96 || D == 128 || D == 256) &&
         g.unit_rows >= kTileRows &&
         g.unit_rows % kTileRows == 0 && grid >= 1 && g.limit >= 0;
}

}  // namespace

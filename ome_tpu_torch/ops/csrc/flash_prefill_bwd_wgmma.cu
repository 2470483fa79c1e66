// The backward of the causal GQA prefill attention (B2, flash_prefill.cu)
// on its bf16 training path, for Hopper: wgmma, TMA, and the logsumexp
// the forward saved.
//
// Replaces no Pallas kernel: the reference's train step differentiates
// its XLA attention with jax.grad (ome_tpu/ops/attention.py:48-81; none
// of its Pallas kernels has a backward). ops/flash.py::FlashPrefill runs
// B2 forward with `lse=` and this kernel backward for bf16 inputs; fp32
// inputs keep the scalar kernel of flash_prefill_bwd.cu.
//
// The function (flash_prefill_bwd.cu's contract): q, dO [B, S, H, D], k,
// v [B, S, K, D] bf16 (G = H / K query heads per KV head, any G), query
// row i attends key rows j <= i and, with a sliding window W, j > i - W
// (B2 at base 0 with kv_hi = S). With s = scale q.k (s = c tanh(s / c)
// under a softcap c) and lse [B, H, S] the forward's natural-log
// logsumexp of each row (its sink included, where gpt-oss has one):
//   P = exp(s - lse),  dP = dO V^T,  Delta = rowsum(P dP),
//   dS = P (dP - Delta) (1 - (s / c)^2),
//   dV = P^T dO,  dK = scale dS^T Q,  dQ = scale dS K,
// every sum in fp32, the gradients written in fp32 (FlashPrefill casts
// them), and Delta [B, H, S] written for the sink's gradient
// (flash.sink_grad). A sink needs nothing else here: its column enters P
// only through lse.
//
// What bounds it on an H100: the operations of the five products, 10 D
// per (row, key) pair and head: 0.1738 ms for the 8B's heads at causal
// 2048, B 2, at the 989 TFLOP/s bf16 peak. The design:
//   * Every product runs on wgmma. S = Q K^T and dP = dO V^T take the
//     bf16 inputs as they are (both operands in shared memory, the SS
//     form): exact products summed in fp32. P and dS are fp32 and feed
//     the three output products from registers (the RS form) as two
//     bf16 terms each, hi = bf16(x) and lo = bf16(x - hi), in two wgmmas
//     into the same fp32 accumulator: a single bf16 term moves dq, dk,
//     dv by 1.7e-2 to 1.3e-1 of their rms at causal 2048 (what SDPA's
//     and FlashAttention's backward do), two by less than 1e-4
//     (tests/test_torch_attention_bwd_plan.py emulates it).
//   * P comes from the saved lse: nothing recomputes a running max.
//     Delta is rowsum(P dP), not rowsum(dO o): the forward's bf16 output
//     moved dq by 0.14 of its rms (flash_prefill_bwd.cu's note).
//   * Two launches (three with a head split) and no atomics, so a
//     second launch gives the same bits. bwd_dq: one block per (query tile, head, column chunk) walks
//     the key tiles its rows see twice, first for Delta (written for the
//     next launch), then for dQ. bwd_dkdv: one block per (key tile, KV
//     head, head split, column chunk) walks the query tiles of its
//     heads that see its keys, and holds dK and dV in registers. Where
//     B K ceil(S / 64) key tiles would leave SMs idle (G 32 has 32
//     blocks per column chunk), each key tile's G heads are split over
//     blocks that write fp32 partials, summed in split order by a third
//     launch (sum_splits). flash.py::bwd_tile_plan states the walks and
//     the split.
//   * TMA copies (128-byte swizzle, the layout the wgmma descriptors
//     read) into a ring of two stages under mbarriers; the fixed
//     operand of a block (K and V for dK/dV, Q and dO for dQ) lands
//     once, and rows past S are zero-filled by the copy and masked.
//     bwd_dq has a producer warp (full/empty mbarriers); bwd_dkdv has
//     none: its thread 0 refills a stage once the warpgroup has passed
//     a named barrier after the stage's products, so that its four
//     warps keep 255 registers with two blocks on an SM (bwd_dkdv's
//     note). Neither uses setmaxnreg: ptxas allocates from the launch
//     bounds whatever setmaxnreg grants later (prefill_wgmma's consumers
//     report 168 at two consumers and spill at D 256).
//   * The walks cover only the tiles between the causal frontier and
//     the window, and mask only tiles not found full.
//   * dK and dV sum each query tile's products in fresh wgmma
//     accumulators and add them to fp32 totals in registers: one
//     accumulator carried through a key tile's whole walk (G S / 64
//     query tiles of a causal 2048 at G 4: 1024 wgmmas into it) put dv
//     1.4e-3 of its rms off the plain version on an H100, a tile's
//     products then one fp32 add per tile well under that.
//   * Registers: the dK and dV totals of 64 keys over a chunk of 64
//     columns, their two tile accumulators, the S and dP accumulators
//     and the A fragments (213-216 a thread, no spills), so that D
//     64-128 keep two blocks on an SM (one block's softmax runs while
//     the other's products do; at D 256 shared memory allows one). The
//     column chunks recompute S and dP.
// Work per (row, key) pair and head: S and dP in bwd_dq's two walks (8
// D), in bwd_dkdv once per 64-column chunk (4 D each: 8 D at D 96 and
// 128), and three output products of two bf16 terms (12 D): 28 D at D
// 128 against the bound's 10 D.
//
// head_dim 64, 96, 128, 256: 64-dim TMA boxes, the last zero past D (at
// D 96 the output products carry 32 padding columns, never stored).
//
// Built with nvcc into a shared library with a plain C interface (see
// ome_tpu_torch/ops/_build.py) and called through ctypes.

#include "common.cuh"

namespace {

constexpr int kT = 64;          // rows of a query tile and of a key tile
constexpr int kBox = kT * 128;  // one TMA box: 64 rows x 64 bf16 dims
constexpr int kStages = 2;      // tiles in flight
constexpr int kThreads = 160;   // bwd_dq: a consumer warpgroup, a producer warp
constexpr int kDkdvThreads = 128;  // bwd_dkdv: one warpgroup
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct Geo {
  static constexpr int kDB = (D + 63) / 64;  // 64-dim boxes of a row
  static constexpr int kTile = kDB * kBox;   // a 64-row tile, all of D
  // dynamic shared memory: the block's two fixed tiles and kStages
  // stages of two tiles, 1024-byte aligned
  static constexpr int kSmem = 1024 + 2 * (1 + kStages) * kTile;
  // columns of a dK/dV chunk and of a dQ chunk, and the chunks of D
  static constexpr int kKvCols = 64;
  static constexpr int kQCols = D > 64 ? 128 : 64;
  static constexpr int kKvChunks = kDB * 64 / kKvCols;
  static constexpr int kQChunks = kDB * 64 / kQCols;
  static constexpr int kMinBlocks = D > 128 ? 1 : 2;  // resident per SM
};

// 2^x on the MUFU, flushing denormals (probabilities below 2^-126 are 0)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ bool pair_ok(int i, int j, int S, int window) {
  return i < S && j <= i && (window <= 0 || j > i - window);
}

// every pair of query rows q0 .. q0 + 63 and key rows k0 .. k0 + 63 valid
__device__ __forceinline__ bool tile_full(int q0, int k0, int S,
                                          int window) {
  return k0 + kT - 1 <= q0 && q0 + kT <= S &&
         (window <= 0 || k0 > q0 + kT - 1 - window);
}

// acc = A B^T over D for two 64-row tiles held K-major in shared memory
// (64-dim boxes kBox apart): D / 16 k16 steps (started, not waited for)
template <int D>
__device__ __forceinline__ void mm_ss(float (&acc)[32], uint32_t a_addr,
                                      uint32_t b_addr) {
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc)
    wgmma_ss<64>(acc,
                 sw128_desc(a_addr + (kc / 4) * kBox + (kc % 4) * 32, 16,
                            1024),
                 sw128_desc(b_addr + (kc / 4) * kBox + (kc % 4) * 32, 16,
                            1024),
                 kc > 0);
}

// acc += A B for A (64 x 64) in registers and B the NW columns of a
// 64-row tile from its box at b_addr on (MN-major: the transpose bit), in
// four k16 steps of 16 rows (started, not waited for)
template <int NW>
__device__ __forceinline__ void mm_rs(float (&acc)[NW / 2],
                                      const uint32_t (&a)[4][4],
                                      uint32_t b_addr) {
#pragma unroll
  for (int kc = 0; kc < 4; ++kc)
    wgmma_rs_mn<NW>(acc, a[kc], sw128_desc(b_addr + kc * 2048, kBox, 1024));
}

// fp32 accumulators of a 64 x 64 tile -> the bf16 A fragments of two
// terms, hi = bf16(x) and lo = bf16(x - hi) (registers 8kc + 2r, +1 are
// k step kc's a[r]: flash_prefill.cu's to_a_frags)
__device__ __forceinline__ void split_frags(const float (&x)[32],
                                            uint32_t (&hi)[4][4],
                                            uint32_t (&lo)[4][4]) {
#pragma unroll
  for (int kc = 0; kc < 4; ++kc)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float a = x[8 * kc + 2 * r], b = x[8 * kc + 2 * r + 1];
      const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
      const float2 hf = __bfloat1622float2(h);
      hi[kc][r] = *reinterpret_cast<const uint32_t*>(&h);
      lo[kc][r] = pack_bf16(a - hf.x, b - hf.y);
    }
}

// keeps A fragments read by an in-flight wgmma live (and unmoved) up to
// this point: place after the wgmma_wait that retires it
__device__ __forceinline__ void frag_fence(uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kc = 0; kc < 4; ++kc) reg_fence(a[kc]);
}

// A raw dot product -> its logit in log2 units (x) and the softcap's
// derivative (d; 1 without a softcap)
__device__ __forceinline__ float logit2(float dot, float scale_log2,
                                        float cap_in, float cap_out,
                                        float& d) {
  if (cap_in > 0.f) {
    const float th = tanhf(dot * cap_in);
    d = 1.f - th * th;
    return th * cap_out;
  }
  d = 1.f;
  return dot * scale_log2;
}

// Accumulator element j of a 64 x 64 tile: row 16 warp + gid + 8 (j / 2
// % 2) of the tile, column 8 (j / 4) + 2 tig + j % 2
__device__ __forceinline__ int acc_col(int j, int tig) {
  return 8 * (j >> 2) + 2 * tig + (j & 1);
}

// -- dQ and Delta ---------------------------------------------------------
//
// Grid (H kQChunks, B, ceil(S / 64)), the query tile the slowest
// dimension, reversed (its last tiles see the most keys). Walk 1:
// Delta of the block's 64 rows; walk 2: dQ over its column chunk.

template <int D>
__global__ void __launch_bounds__(kThreads, Geo<D>::kMinBlocks)
bwd_dq(const __grid_constant__ CUtensorMap tmq,
       const __grid_constant__ CUtensorMap tmo,
       const __grid_constant__ CUtensorMap tmk,
       const __grid_constant__ CUtensorMap tmv,
       const float* __restrict__ lse, float* __restrict__ delta,
       float* __restrict__ dq, int S, int H, int K, float scale,
       float softcap, int window) {
  using P = Geo<D>;
  constexpr int NW = P::kQCols;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[2 * kStages + 1];
  uint64_t* const full = bars;
  uint64_t* const empty = bars + kStages;
  uint64_t* const qbar = bars + 2 * kStages;
  uint8_t* const Qs =
      smem_raw + ((1024u - (smem_addr(smem_raw) & 1023u)) & 1023u);
  uint8_t* const Os = Qs + P::kTile;
  uint8_t* const Ks = Os + P::kTile;             // kStages tiles
  uint8_t* const Vs = Ks + kStages * P::kTile;   // kStages tiles

  const int h = blockIdx.x / P::kQChunks, chunk = blockIdx.x % P::kQChunks;
  const int b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kT;
  const int kh = h / (H / K);
  // the key tiles the rows q0 .. q0 + 63 see (bwd_tile_plan's q_walk)
  const int first = window > 0 ? max(q0 - window + 1, 0) : 0;
  const int kt0 = first / kT;
  const int nt = min(q0 + kT, S) - 1 >= first
                     ? (min(q0 + kT, S) - 1) / kT - kt0 + 1 : 0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4);
    }
    mbar_init(qbar, 1);
    mbar_fence_init();
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp == 4) {
    // ---- producer: Q and dO once, then K and V tiles, twice -------------
    if (lane == 0) {
      mbar_arrive_expect_tx(qbar, 2 * P::kTile);
      for (int j = 0; j < P::kDB; ++j) {
        tma_load_4d(Qs + j * kBox, &tmq, qbar, j * 64, h, q0, b);
        tma_load_4d(Os + j * kBox, &tmo, qbar, j * 64, h, q0, b);
      }
      for (int i = 0; i < 2 * nt; ++i) {
        const int s = i % kStages;
        if (i >= kStages) mbar_wait(&empty[s], ((i / kStages) - 1) & 1);
        mbar_arrive_expect_tx(&full[s], 2 * P::kTile);
        const int k0 = (kt0 + i % nt) * kT;
        for (int j = 0; j < P::kDB; ++j) {
          tma_load_4d(Ks + s * P::kTile + j * kBox, &tmk, &full[s], j * 64,
                      kh, k0, b);
          tma_load_4d(Vs + s * P::kTile + j * kBox, &tmv, &full[s], j * 64,
                      kh, k0, b);
        }
      }
    }
    return;
  }

  // ---- consumer warpgroup: rows la and lb of the tile ----------------------
  const int gid = lane >> 2, tig = lane & 3;
  const int la = warp * 16 + gid, lb = la + 8;
  const int ia = q0 + la, ib = q0 + lb;
  const size_t row0 = ((size_t)b * H + h) * S;
  const float lse_a = ia < S ? lse[row0 + ia] * kLog2e : 0.f;
  const float lse_b = ib < S ? lse[row0 + ib] * kLog2e : 0.f;
  const float scale_log2 = scale * kLog2e;
  const float cap_in = softcap > 0.f ? scale / softcap : 0.f;
  const float cap_out = softcap * kLog2e;
  const uint32_t q_addr = smem_addr(Qs), o_addr = smem_addr(Os);

  mbar_wait(qbar, 0);
  // walk 1: Delta = rowsum(P dP)
  float dl_a = 0.f, dl_b = 0.f;
  for (int i = 0; i < nt; ++i) {
    const int s = i % kStages;
    const int k0 = (kt0 + i) * kT;
    mbar_wait(&full[s], (i / kStages) & 1);
    float sacc[32], dpacc[32];
    wgmma_fence();
    mm_ss<D>(sacc, q_addr, smem_addr(Ks + s * P::kTile));
    mm_ss<D>(dpacc, o_addr, smem_addr(Vs + s * P::kTile));
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(sacc);
    reg_fence(dpacc);
    if (lane == 0) mbar_arrive(&empty[s]);
    const bool full_t = tile_full(q0, k0, S, window);
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      float d;
      const float x = logit2(sacc[j], scale_log2, cap_in, cap_out, d);
      const bool hb = j & 2;
      float p = fast_exp2(x - (hb ? lse_b : lse_a));
      if (!full_t && !pair_ok(hb ? ib : ia, k0 + acc_col(j, tig), S, window))
        p = 0.f;
      if (hb) dl_b = fmaf(p, dpacc[j], dl_b);
      else dl_a = fmaf(p, dpacc[j], dl_a);
    }
  }
  dl_a += __shfl_xor_sync(0xffffffffu, dl_a, 1);
  dl_a += __shfl_xor_sync(0xffffffffu, dl_a, 2);
  dl_b += __shfl_xor_sync(0xffffffffu, dl_b, 1);
  dl_b += __shfl_xor_sync(0xffffffffu, dl_b, 2);
  if (chunk == 0 && tig == 0) {
    if (ia < S) delta[row0 + ia] = dl_a;
    if (ib < S) delta[row0 + ib] = dl_b;
  }

  // walk 2: dQ += dS K over this chunk's columns
  float acc[NW / 2];
#pragma unroll
  for (int j = 0; j < NW / 2; ++j) acc[j] = 0.f;
  for (int i = nt; i < 2 * nt; ++i) {
    const int s = i % kStages;
    const int k0 = (kt0 + i - nt) * kT;
    mbar_wait(&full[s], (i / kStages) & 1);
    float sacc[32], dpacc[32];
    wgmma_fence();
    mm_ss<D>(sacc, q_addr, smem_addr(Ks + s * P::kTile));
    mm_ss<D>(dpacc, o_addr, smem_addr(Vs + s * P::kTile));
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(sacc);
    reg_fence(dpacc);
    const bool full_t = tile_full(q0, k0, S, window);
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      float d;
      const float x = logit2(sacc[j], scale_log2, cap_in, cap_out, d);
      const bool hb = j & 2;
      float p = fast_exp2(x - (hb ? lse_b : lse_a));
      if (!full_t && !pair_ok(hb ? ib : ia, k0 + acc_col(j, tig), S, window))
        p = 0.f;
      dpacc[j] = p * (dpacc[j] - (hb ? dl_b : dl_a)) * d;
    }
    uint32_t hi[4][4], lo[4][4];
    split_frags(dpacc, hi, lo);
    const uint32_t k_addr =
        smem_addr(Ks + s * P::kTile) + chunk * (NW / 64) * kBox;
    wgmma_fence();
    mm_rs<NW>(acc, hi, k_addr);
    mm_rs<NW>(acc, lo, k_addr);
    wgmma_commit();
    wgmma_wait<0>();
    frag_fence(hi);
    frag_fence(lo);
    reg_fence(acc);
    if (lane == 0) mbar_arrive(&empty[s]);
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int i = half ? ib : ia;
    if (i >= S) continue;
    float* dst = dq + (((size_t)b * S + i) * H + h) * D;
#pragma unroll
    for (int g = 0; g < NW / 8; ++g) {
      const int col = chunk * NW + 8 * g + 2 * tig;
      if (col < D)  // the padding columns past D
        *reinterpret_cast<float2*>(dst + col) =
            make_float2(acc[4 * g + 2 * half] * scale,
                        acc[4 * g + 2 * half + 1] * scale);
    }
  }
}

// -- dK and dV ------------------------------------------------------------
//
// Grid (K splits kKvChunks, B, ceil(S / 64)), the key tile the slowest
// dimension (its first tiles are seen by the most rows), 128 threads: one
// warpgroup, whose thread 0 also issues the TMA copies. Block x = (kh
// splits + split) kKvChunks + chunk walks heads kh G + g for g in [split
// G / splits, (split + 1) G / splits) and, for each, the query tiles that
// see its keys. With one split it writes dk and dv; with more, its
// partials at part[split] and part[splits + split] ([B, S, K, D] each).
// No producer warp: the SM's register file is four partitions of 16384,
// so two blocks of five warps cap a thread at 168 registers, where the
// dK and dV totals, two tile accumulators and the S and dP accumulators
// spill; two blocks of four warps allow 255.

template <int D>
__global__ void __launch_bounds__(kDkdvThreads, 2)
bwd_dkdv(const __grid_constant__ CUtensorMap tmq,
         const __grid_constant__ CUtensorMap tmo,
         const __grid_constant__ CUtensorMap tmk,
         const __grid_constant__ CUtensorMap tmv,
         const float* __restrict__ lse, const float* __restrict__ delta,
         float* __restrict__ dk, float* __restrict__ dv,
         float* __restrict__ part, int B, int S, int H, int K, int splits,
         float scale, float softcap, int window) {
  using P = Geo<D>;
  constexpr int NW = P::kKvCols;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[kStages + 1];
  uint64_t* const full = bars;
  uint64_t* const kvbar = bars + kStages;
  uint8_t* const Ks =
      smem_raw + ((1024u - (smem_addr(smem_raw) & 1023u)) & 1023u);
  uint8_t* const Vs = Ks + P::kTile;
  uint8_t* const Qs = Vs + P::kTile;             // kStages tiles
  uint8_t* const Os = Qs + kStages * P::kTile;   // kStages tiles

  const int G = H / K;
  const int chunk = blockIdx.x % P::kKvChunks;
  const int split = (blockIdx.x / P::kKvChunks) % splits;
  const int kh = blockIdx.x / (P::kKvChunks * splits);
  const int b = blockIdx.y, k0 = blockIdx.z * kT;
  const int g_lo = split * G / splits, g_hi = (split + 1) * G / splits;
  // the query tiles that see keys k0 .. k0 + 63 (bwd_tile_plan's kv_walk)
  const int last = window > 0 ? min(S - 1, k0 + kT - 2 + window) : S - 1;
  const int qt0 = k0 / kT;
  const int nq = last / kT - qt0 + 1;
  const int steps = (g_hi - g_lo) * nq;
  const int tid = threadIdx.x;

  // step i: head kh G + g_lo + i / nq, query tile qt0 + i % nq, into
  // stage i % kStages
  auto load_step = [&](int i) {
    const int s = i % kStages;
    const int h = kh * G + g_lo + i / nq, q0 = (qt0 + i % nq) * kT;
    mbar_arrive_expect_tx(&full[s], 2 * P::kTile);
    for (int j = 0; j < P::kDB; ++j) {
      tma_load_4d(Qs + s * P::kTile + j * kBox, &tmq, &full[s], j * 64, h,
                  q0, b);
      tma_load_4d(Os + s * P::kTile + j * kBox, &tmo, &full[s], j * 64, h,
                  q0, b);
    }
  };
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(&full[s], 1);
    mbar_init(kvbar, 1);
    mbar_fence_init();
    mbar_arrive_expect_tx(kvbar, 2 * P::kTile);
    for (int j = 0; j < P::kDB; ++j) {
      tma_load_4d(Ks + j * kBox, &tmk, kvbar, j * 64, kh, k0, b);
      tma_load_4d(Vs + j * kBox, &tmv, kvbar, j * 64, kh, k0, b);
    }
    for (int i = 0; i < min(kStages, steps); ++i) load_step(i);
  }
  __syncthreads();

  // this thread's keys la and lb of the tile, and its 16 query columns
  // of each tile, 8 c + 2 tig + e (acc_col)
  const int warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int la = warp * 16 + gid, lb = la + 8;
  const int ja = k0 + la, jb = k0 + lb;
  const float scale_log2 = scale * kLog2e;
  const float cap_in = softcap > 0.f ? scale / softcap : 0.f;
  const float cap_out = softcap * kLog2e;
  const uint32_t k_addr = smem_addr(Ks), v_addr = smem_addr(Vs);

  // dK and dV: each query tile's products summed in fresh wgmma
  // accumulators (tk, tv), then added to these fp32 totals
  float acc_k[NW / 2], acc_v[NW / 2];
#pragma unroll
  for (int j = 0; j < NW / 2; ++j) acc_k[j] = acc_v[j] = 0.f;

  mbar_wait(kvbar, 0);
  for (int i = 0; i < steps; ++i) {
    const int s = i % kStages;
    const int h = kh * G + g_lo + i / nq, q0 = (qt0 + i % nq) * kT;
    // the rows' lse (log2 units) and Delta, read while the products run
    float lse_c[16], dl_c[16];
    const size_t row0 = ((size_t)b * H + h) * S;
#pragma unroll
    for (int c = 0; c < 16; ++c) {
      const int iq = q0 + acc_col(2 * (c & ~1) + (c & 1), tig);
      lse_c[c] = iq < S ? lse[row0 + iq] * kLog2e : 0.f;
      dl_c[c] = iq < S ? delta[row0 + iq] : 0.f;
    }
    mbar_wait(&full[s], (i / kStages) & 1);
    const uint32_t q_addr = smem_addr(Qs + s * P::kTile);
    const uint32_t o_addr = smem_addr(Os + s * P::kTile);
    // S^T = K Q^T and dP^T = V dO^T: keys are the rows
    float sacc[32], dpacc[32];
    wgmma_fence();
    mm_ss<D>(sacc, k_addr, q_addr);
    mm_ss<D>(dpacc, v_addr, o_addr);
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(sacc);
    reg_fence(dpacc);
    const bool full_t = tile_full(q0, k0, S, window);
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int c = (j >> 2) * 2 + (j & 1);  // this thread's column c
      float d;
      const float x = logit2(sacc[j], scale_log2, cap_in, cap_out, d);
      float p = fast_exp2(x - lse_c[c]);
      if (!full_t &&
          !pair_ok(q0 + acc_col(j, tig), (j & 2) ? jb : ja, S, window))
        p = 0.f;
      sacc[j] = p;
      dpacc[j] = p * (dpacc[j] - dl_c[c]) * d;
    }
    uint32_t ph[4][4], pl[4][4], sh[4][4], sl[4][4];
    split_frags(sacc, ph, pl);
    split_frags(dpacc, sh, sl);
    const uint32_t col_off = chunk * (NW / 64) * kBox;
    // dV = P^T dO and dK = dS^T Q of this tile over this chunk's columns
    float tv[NW / 2], tk[NW / 2];
#pragma unroll
    for (int j = 0; j < NW / 2; ++j) tv[j] = tk[j] = 0.f;
    wgmma_fence();
    mm_rs<NW>(tv, ph, o_addr + col_off);
    mm_rs<NW>(tv, pl, o_addr + col_off);
    mm_rs<NW>(tk, sh, q_addr + col_off);
    mm_rs<NW>(tk, sl, q_addr + col_off);
    wgmma_commit();
    wgmma_wait<0>();
    frag_fence(ph);
    frag_fence(pl);
    frag_fence(sh);
    frag_fence(sl);
    reg_fence(tv);
    reg_fence(tk);
#pragma unroll
    for (int j = 0; j < NW / 2; ++j) {
      acc_v[j] += tv[j];
      acc_k[j] += tk[j];
    }
    // every warp is done with stage s: thread 0 refills it
    named_bar_sync(1, kDkdvThreads);
    if (tid == 0 && i + kStages < steps) load_step(i + kStages);
  }

  const size_t n = (size_t)B * S * K * D;
  float* const out_k = splits > 1 ? part + split * n : dk;
  float* const out_v = splits > 1 ? part + (splits + split) * n : dv;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int j = half ? jb : ja;
    if (j >= S) continue;
    const size_t off = (((size_t)b * S + j) * K + kh) * D;
#pragma unroll
    for (int g = 0; g < NW / 8; ++g) {
      const int col = chunk * NW + 8 * g + 2 * tig;
      if (col < D) {  // the padding columns past D
        *reinterpret_cast<float2*>(out_k + off + col) =
            make_float2(acc_k[4 * g + 2 * half] * scale,
                        acc_k[4 * g + 2 * half + 1] * scale);
        *reinterpret_cast<float2*>(out_v + off + col) =
            make_float2(acc_v[4 * g + 2 * half], acc_v[4 * g + 2 * half + 1]);
      }
    }
  }
}

// dk = sum of part[0 .. splits), dv = sum of part[splits .. 2 splits), in
// split order (n4 float4s each)
__global__ void sum_splits(const float4* __restrict__ part,
                           float4* __restrict__ dk, float4* __restrict__ dv,
                           size_t n4, int splits) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n4;
       i += (size_t)gridDim.x * blockDim.x) {
    float4 a = part[i], c = part[(size_t)splits * n4 + i];
    for (int s = 1; s < splits; ++s) {
      const float4 x = part[(size_t)s * n4 + i];
      const float4 y = part[(size_t)(splits + s) * n4 + i];
      a.x += x.x; a.y += x.y; a.z += x.z; a.w += x.w;
      c.x += y.x; c.y += y.y; c.z += y.z; c.w += y.w;
    }
    dk[i] = a;
    dv[i] = c;
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const float* lse, float* delta, float* dq, float* dk, float* dv,
           float* part, int B, int S, int H, int K, int splits, float scale,
           float softcap, int window, void* const* events, cudaStream_t st) {
  using P = Geo<D>;
  CUtensorMap tmq, tmo, tmk, tmv;
  if (!encode_bf16_4d(&tmq, q, B, S, H, D, 1, kT) ||
      !encode_bf16_4d(&tmo, dout, B, S, H, D, 1, kT) ||
      !encode_bf16_4d(&tmk, k, B, S, K, D, 1, kT) ||
      !encode_bf16_4d(&tmv, v, B, S, K, D, 1, kT))
    return cudaErrorInvalidValue;
  cudaError_t err;
  if ((err = cudaFuncSetAttribute(bwd_dq<D>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  P::kSmem)) != cudaSuccess ||
      (err = cudaFuncSetAttribute(bwd_dkdv<D>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  P::kSmem)) != cudaSuccess)
    return err;
  const int nt = (S + kT - 1) / kT;
  if ((err = mark(events, 0, st)) != cudaSuccess) return err;
  bwd_dq<D><<<dim3(H * P::kQChunks, B, nt), kThreads, P::kSmem, st>>>(
      tmq, tmo, tmk, tmv, lse, delta, dq, S, H, K, scale, softcap, window);
  if ((err = cudaGetLastError()) != cudaSuccess ||
      (err = mark(events, 1, st)) != cudaSuccess)
    return err;
  bwd_dkdv<D><<<dim3(K * splits * P::kKvChunks, B, nt), kDkdvThreads,
                 P::kSmem, st>>>(tmq, tmo, tmk, tmv, lse, delta, dk, dv, part, B, S, H,
                       K, splits, scale, softcap, window);
  if ((err = cudaGetLastError()) != cudaSuccess ||
      (err = mark(events, 2, st)) != cudaSuccess)
    return err;
  if (splits > 1) {
    const size_t n4 = (size_t)B * S * K * D / 4;
    const size_t want = (n4 + 255) / 256, cap = 4 * (size_t)sm_count();
    const int blocks = (int)(want < cap ? want : cap);
    sum_splits<<<blocks, 256, 0, st>>>(
        reinterpret_cast<const float4*>(part), reinterpret_cast<float4*>(dk),
        reinterpret_cast<float4*>(dv), n4, splits);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    return mark(events, 3, st);
  }
  return cudaSuccess;
}

}  // namespace

// q, dout [B, S, H, D], k, v [B, S, K, D]: contiguous bf16; lse [B, H, S]
// fp32 from the forward; delta [B, H, S] fp32, written; dq, dk, dv fp32
// of q's, k's and v's shapes, every element written; part: 2 splits
// B S K D fp32 scratch when splits > 1 (else unused); splits: 1 to G
// (flash.bwd_tile_plan). D 64, 96, 128 or 256. events: null, or 4
// cudaEvent_t recorded on the stream before bwd_dq, before bwd_dkdv,
// after it, and after sum_splits where it runs (`mark`). Returns the
// CUDA error code of the launches (0 on success).
extern "C" int ome_flash_prefill_bwd_wgmma(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, float* delta, void* dq, void* dk, void* dv,
    float* part, int B, int S, int H, int K, int D, float scale,
    float softcap, int window, int splits, void** events, void* stream) {
  if (K <= 0 || H % K != 0) return cudaErrorInvalidValue;
  if (splits < 1 || splits > H / K || (splits > 1 && part == nullptr))
    return cudaErrorInvalidValue;
  if (B == 0 || S == 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* dqf = static_cast<float*>(dq);
  float* dkf = static_cast<float*>(dk);
  float* dvf = static_cast<float*>(dv);
  if (D == 128) return launch<128>(q, k, v, dout, lse, delta, dqf, dkf, dvf, part, B, S, H, K, splits, scale, softcap, window, events, st);
  if (D == 64) return launch<64>(q, k, v, dout, lse, delta, dqf, dkf, dvf, part, B, S, H, K, splits, scale, softcap, window, events, st);
  if (D == 96) return launch<96>(q, k, v, dout, lse, delta, dqf, dkf, dvf, part, B, S, H, K, splits, scale, softcap, window, events, st);
  if (D == 256) return launch<256>(q, k, v, dout, lse, delta, dqf, dkf, dvf, part, B, S, H, K, splits, scale, softcap, window, events, st);
  return cudaErrorInvalidValue;
}

// Causal GQA prefill attention for Hopper, with a per-sequence position
// base so that a chunk of queries can attend into a filled cache.
//
// Replaces ome_tpu/ops/flash.py::_flash_prefill (kernel body
// _prefill_kernel, KV range _prefill_block_range). Same function: query
// row i of sequence b sits at position base[b] + i and attends the KV
// columns c with c <= base[b] + i, c < kv_hi[b] and, with a sliding
// window W, c > base[b] + i - W; the optional tanh softcap applies to the
// scaled logits; the softmax state is fp32 with the finite M_INIT = -1e30
// start and the l >= 1e-30 clamp; P is rounded to bf16 before the PV
// product, which accumulates in fp32; the output is bf16. With attention
// sinks (gpt-oss; the reference's XLA path, ome_tpu/ops/attention.py:
// 69-75) each query head's sink logit is one more column of its softmax
// whose probability is dropped: it enters once per row, where the output
// is normalized (sink_norm below), and no tile sees it. prefill_wgmma
// takes it as a template flag, so that its sinkless instances run the
// epilogue they ran before (a run-time test there cost the causal
// 2048-token case ~4% on an H100); the fp32 kernel, off the served path,
// tests at run time.
//
// What bounds it on an H100: tensor-core operations. A causal 2048-token
// prompt at 32 heads of 128 does 34.4 GFLOP of QK^T and PV against 25 MB
// of Q, K, V and O: 0.035 ms at the 989 TFLOP/s bf16 peak. The bf16
// kernel, prefill_wgmma, is built for that bound:
//   * Both products run on wgmma, Hopper's warpgroup tensor-core
//     instruction: S = Q K^T with Q and K both read from shared memory
//     (the SS form), O += P V with P in registers (the RS form). Each
//     consumer warpgroup owns one 64-row M tile; the fp32 S accumulators
//     are turned into the bf16 A fragments of the PV product in place
//     (the m64nN accumulator layout of two adjacent 8-column groups is
//     the A layout of one k16 step), and O stays in registers for the
//     whole KV walk. One wgmma reads each K/V tile once per warpgroup
//     from shared memory, not once per warp.
//   * The G query heads of a KV head are folded into the rows (PG =
//     floor(64 / G) positions x G heads per warpgroup, as _prefill_kernel
//     folds them into the MXU rows), and a block runs two consumer
//     warpgroups: up to 128 folded rows share every staged K/V tile, so
//     K/V are staged half as often as with one 64-row tile. When that grid
//     would not fill the SMs (the short buckets), a one-consumer instance
//     of the same template runs instead. Any G from 1 to 16 folds, as the
//     reference takes any G: where G does not divide 64 (G 3, 5, 6, 7, 9
//     ...), the last 64 - PG G rows of each warpgroup are idle (G 7: 9
//     positions, 63 rows, row 63 idle). The Q copy fills only the PG G
//     real rows, the idle rows are zeroed once, so their logits are 0 and
//     finite, and they are never stored; a row's softmax and its O row
//     read no other row, so an idle row changes no real one.
//   * Loads are off the math threads: a producer warpgroup (its
//     registers cut to 24 by setmaxnreg, the consumers' raised to 240)
//     has one thread start TMA copies into a ring of shared-memory
//     stages. Each stage has a full mbarrier (the producer's
//     arrive.expect_tx, completed by the TMA bytes) and an empty
//     mbarrier (one arrival per consumer warp once its wgmma has read
//     the stage), so no __syncthreads sits in the KV loop. Q arrives
//     once per block by TMA, in the [position][G][D] folded order, with
//     rows past Sq zero-filled by the copy. The 128-byte swizzle TMA
//     writes is the layout the wgmma descriptors read.
//   * The walk covers only the KV tiles between the window's first tile
//     and min(causal frontier, kv_hi) (prefill_tile_plan in
//     ops/flash.py states the rule), and masks only the tiles it does
//     not find full.
//   * Blocks are launched heaviest first: the q tile is the grid's
//     slowest dimension, reversed, so the long causal rows start in the
//     first wave and the short ones fill the tail.
//   * TMA copies whole boxes, so a tile that straddles kv_hi holds cache
//     rows past it, which may be anything (NaN included). Their logits
//     are masked by a select, and their V rows are zeroed in shared
//     memory before the PV product, since 0 x NaN is NaN.
//   * The softmax keeps its arithmetic off the per-element path where it
//     can: the scale folds into the exponent's FFMA, exp2 runs on the
//     MUFU (ex2.approx.ftz), the softcap and the mask are whole-tile
//     branches (a tanh selected per element would run on every tile),
//     and the row sums are reduced across the quad once, at the end.
// Within a warpgroup the tile's softmax still runs between its two
// products; the tensor cores keep busy only as far as the other
// consumer warpgroup is in a product meanwhile. That serial softmax is
// what holds the kernel above its bound.
// head_dim D 64, 96, 128 or 256, as the reference's XLA path takes any D:
// Q, K and V land as ceil(D / 64) boxes of 64 dims from 4D tensor maps
// whose inner extent is D, so the last box at D 96 holds dims 64..95 and
// TMA's zero fill (no byte past D is read). QK^T runs exactly D / 16 k
// steps; PV runs N = 64 ceil(D / 64) columns in products of at most 128
// (two at D 256), the columns past D zero and never stored: at D 96 a
// quarter of the PV product is that padding. At D 256 a KV tile is 64
// rows (BN), so that two stages of K and V (128 KB) and the Q boxes of
// two consumers (64 KB) fit the 227 KB of shared memory; O is then 128
// fp32 registers a consumer thread.
// fp32 inputs take a plain kernel with scalar FMA in fp32 (tensor-core
// TF32 would not hold fp32 tolerances); fp32 is not on the bf16 serving
// path.
//
// Built with nvcc into a shared library with a plain C interface (see
// ome_tpu_torch/ops/_build.py) and called through ctypes. The tensor maps
// are encoded on the host per launch (encode_map in common.cuh).

#include "common.cuh"

namespace {

constexpr int kBM = 64;  // folded query rows per warpgroup / fp32 block

// ---------------------------------------------------------------- bf16 ---

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kStages = 2;  // K/V tiles in flight

// KV rows per tile: 128, or 64 at D 256 (two stages of 128-row K and V
// tiles beside two consumers' Q boxes would not fit in shared memory)
template <int D>
constexpr int tile_rows() { return D > 128 ? 64 : 128; }

// 2^x on the MUFU, flushing denormals (probabilities below 2^-126 are 0)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Shared memory of one block: Q as NC x kDB boxes of 64 folded rows x 64
// dims (128-byte rows, 8 KB each, of which the first PG G rows are
// copied), then STAGES K tiles and STAGES V tiles of kDB boxes of BN rows
// x 64 dims; every box 1024-byte aligned for the 128-byte swizzle. kDB =
// ceil(D / 64): the last box is zero past D. O is kNP products of kNW
// columns.
template <int D, int BN, int NC, int STAGES>
struct Prefill {
  static constexpr int kDB = (D + 63) / 64;
  static constexpr int kNW = kDB * 64 > 128 ? 128 : kDB * 64;
  static constexpr int kNP = kDB * 64 / kNW;
  static constexpr int kBoxQ = 64 * 128;
  static constexpr int kBoxKV = BN * 128;
  static constexpr int kStage = kDB * kBoxKV;
  static constexpr int kQBytes = NC * kDB * kBoxQ;
  static constexpr int kSmem = 1024 + kQBytes + 2 * STAGES * kStage;
  static constexpr int kThreads = 128 * (NC + 1);
};

// S = Q K^T for one warpgroup's 64 rows and one BN-row K tile: D/16 k16
// steps, +32 bytes inside a 64-dim box, the next box every 4 steps
// (started, not waited for)
template <int D, int BN, int kBoxQ, int kBoxKV>
__device__ __forceinline__ void qk_async(float (&sacc)[BN / 2],
                                         uint32_t q_addr, uint32_t k_addr) {
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc)
    wgmma_ss<BN>(sacc,
                 sw128_desc(q_addr + (kc / 4) * kBoxQ + (kc % 4) * 32, 16,
                            1024),
                 sw128_desc(k_addr + (kc / 4) * kBoxKV + (kc % 4) * 32, 16,
                            1024),
                 kc > 0);
}

// O += P V: for each of the NP products of NW columns, BN/16 k16 steps of
// 16 V rows (2 KB) each; V is MN-major, its 64-dim boxes kBoxKV apart
// (started, not waited for)
template <int NP, int NW, int BN, int kBoxKV>
__device__ __forceinline__ void pv_async(float (&o)[NP][NW / 2],
                                         const uint32_t (&pf)[BN / 16][4],
                                         uint32_t v_addr) {
#pragma unroll
  for (int n = 0; n < NP; ++n)
#pragma unroll
    for (int kc = 0; kc < BN / 16; ++kc)
      wgmma_rs_mn<NW>(o[n], pf[kc],
                      sw128_desc(v_addr + n * (NW / 64) * kBoxKV + kc * 2048,
                                 kBoxKV, 1024));
}

// The fp32 probabilities in S's registers -> the bf16 A fragments of the
// PV product: registers 8kc + 2r, +1 are row a (r even) or b (r odd),
// columns 16kc + 8(r/2) + 2(t%4), +1: k step kc's a[r]
template <int BN>
__device__ __forceinline__ void to_a_frags(const float (&p)[BN / 2],
                                           uint32_t (&pf)[BN / 16][4]) {
#pragma unroll
  for (int kc = 0; kc < BN / 16; ++kc)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      pf[kc][r] = pack_bf16(p[8 * kc + 2 * r], p[8 * kc + 2 * r + 1]);
}

// The normalization of a row from its softmax state: out = acc f / den.
// m and l are in the units of the exponent (log2 for prefill_wgmma, whose
// m is multiplied by its `mult` first; natural for prefill_f32), s_unit
// turns a sink logit into them. Without a sink f = 1 and den = max(l,
// 1e-30); with one, the sink is one more column: m' = max(m, s), f =
// 2^(m - m') (or e^), den = max(l f + 2^(s - m'), 1e-30). An empty row
// (m at M_INIT, l = 0) gives 0.
template <bool LOG2>
__device__ __forceinline__ void sink_norm(float m, float l,
                                          const float* sinks, int head,
                                          float s_unit, float& f,
                                          float& den) {
  f = 1.f;
  den = fmaxf(l, 1e-30f);
  if (sinks != nullptr) {
    const float s = sinks[head] * s_unit;
    const float mn = fmaxf(m, s);
    f = LOG2 ? exp2f(m - mn) : expf(m - mn);
    den = fmaxf(l * f + (LOG2 ? exp2f(s - mn) : expf(s - mn)), 1e-30f);
  }
}

// One tile's online softmax, in place: S (raw) -> fp32 probabilities.
// S stays in raw units and the scale folds into the exponent's FFMA
// (mult = scale log2 e); with a softcap the logits are capped and turned
// into log2 units first (mult = 1). Masked pairs become -inf, whose
// probability is exactly 0, as the reference's where(valid, p, 0); a
// tile every row attends in full skips the mask. Updates the running
// max m and this thread's partial sums l of its rows a and b, and
// returns the factors al that rescale O.
template <int BN>
__device__ __forceinline__ void softmax_tile(
    float (&s)[BN / 2], float& m_a, float& m_b, float& l_a, float& l_b,
    float& al_a, float& al_b, bool tile_full, int c0, int tig, int pa,
    int pb, int kv_hi, int window, float softcap, float scale,
    float scale_log2) {
  float mult = scale_log2;
  if (softcap > 0.f) {
    const float in = scale / softcap, outm = softcap * kLog2e;
#pragma unroll
    for (int j = 0; j < BN / 2; ++j) s[j] = tanhf(s[j] * in) * outm;
    mult = 1.f;
  }
  if (!tile_full) {
#pragma unroll
    for (int j = 0; j < BN / 2; ++j) {
      const int col = c0 + (j / 4) * 8 + tig * 2 + (j & 1);
      const int p = (j & 2) ? pb : pa;
      const bool ok =
          col <= p && col < kv_hi && (window <= 0 || col > p - window);
      s[j] = ok ? s[j] : __int_as_float(0xff800000u);  // -inf
    }
  }
  float tmax_a = kMInit, tmax_b = kMInit;
#pragma unroll
  for (int j = 0; j < BN / 2; ++j) {
    if (j & 2) tmax_b = fmaxf(tmax_b, s[j]);
    else tmax_a = fmaxf(tmax_a, s[j]);
  }
  tmax_a = fmaxf(tmax_a, __shfl_xor_sync(0xffffffffu, tmax_a, 1));
  tmax_a = fmaxf(tmax_a, __shfl_xor_sync(0xffffffffu, tmax_a, 2));
  tmax_b = fmaxf(tmax_b, __shfl_xor_sync(0xffffffffu, tmax_b, 1));
  tmax_b = fmaxf(tmax_b, __shfl_xor_sync(0xffffffffu, tmax_b, 2));
  const float mn_a = fmaxf(m_a, tmax_a), mn_b = fmaxf(m_b, tmax_b);
  al_a = fast_exp2((m_a - mn_a) * mult);
  al_b = fast_exp2((m_b - mn_b) * mult);
  m_a = mn_a;
  m_b = mn_b;
  const float ms_a = mn_a * mult, ms_b = mn_b * mult;
  float rs_a = 0.f, rs_b = 0.f;
#pragma unroll
  for (int j = 0; j < BN / 2; ++j) {
    const float p = fast_exp2(fmaf(s[j], mult, (j & 2) ? -ms_b : -ms_a));
    s[j] = p;
    if (j & 2) rs_b += p;
    else rs_a += p;
  }
  l_a = l_a * al_a + rs_a;
  l_b = l_b * al_b + rs_b;
}

// Grid (K, B, ceil(Sq / (NC floor(64 / G)))), 128 (NC + 1) threads: NC
// consumer warpgroups of 64 folded rows each (the first floor(64 / G) G
// of them real), then one producer warpgroup. SINKS: sinks is non-null.
template <int D, int BN, int NC, int STAGES, bool SINKS>
__global__ void __launch_bounds__(128 * (NC + 1), 1)
prefill_wgmma(const __grid_constant__ CUtensorMap tmq,
              const __grid_constant__ CUtensorMap tmk,
              const __grid_constant__ CUtensorMap tmv,
              const int* __restrict__ base_arr,
              const int* __restrict__ kvhi_arr, uint16_t* __restrict__ out,
              const float* __restrict__ sinks, int Sq, int S, int H, int G,
              float scale, float softcap, int window) {
  using P = Prefill<D, BN, NC, STAGES>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[2 * STAGES + 1];
  uint64_t* const full = bars;            // TMA landed in stage s
  uint64_t* const empty = bars + STAGES;  // every consumer warp done with s
  uint64_t* const qbar = bars + 2 * STAGES;
  uint8_t* const Qs =
      smem_raw + ((1024u - (smem_addr(smem_raw) & 1023u)) & 1023u);
  uint8_t* const Ks = Qs + P::kQBytes;
  uint8_t* const Vs = Ks + STAGES * P::kStage;

  const int kh = blockIdx.x, b = blockIdx.y;
  const int qt = gridDim.z - 1 - blockIdx.z;  // heaviest q tiles first
  const int PG = 64 / G;                      // positions per warpgroup
  const int BQ = NC * PG;                     // positions per block
  const int base = base_arr[b];
  const int kv_hi = min(kvhi_arr[b], S);
  const int q0 = qt * BQ;
  const int nq = min(BQ, Sq - q0);
  // the KV tiles any row of the block can attend (prefill_tile_plan)
  const int first = window > 0 ? max(base + q0 - window + 1, 0) : 0;
  const int last = min(base + q0 + nq - 1, kv_hi - 1);
  const int t0 = first / BN;
  const int ntiles = last >= first ? last / BN - t0 + 1 : 0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * NC);
    }
    mbar_init(qbar, 1);
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == NC) {
    // ---- producer: one thread keeps the ring full -----------------------
    if constexpr (NC > 1) setmaxnreg_dec<24>();
    if (threadIdx.x == NC * 128) {
      // PG positions x G heads = PG G rows of 128 bytes per box (the box
      // counts in full, rows past Sq included: TMA zero-fills them)
      mbar_arrive_expect_tx(qbar, NC * P::kDB * PG * G * 128);
      for (int c = 0; c < NC; ++c)
        for (int j = 0; j < P::kDB; ++j)
          tma_load_4d(Qs + (c * P::kDB + j) * P::kBoxQ, &tmq, qbar, j * 64,
                      kh * G, q0 + c * PG, b);
      for (int i = 0; i < ntiles; ++i) {
        const int s = i % STAGES;
        if (i >= STAGES) mbar_wait(&empty[s], ((i / STAGES) - 1) & 1);
        mbar_arrive_expect_tx(&full[s], 2 * P::kStage);
        const int c0 = (t0 + i) * BN;
        for (int j = 0; j < P::kDB; ++j) {
          tma_load_4d(Ks + s * P::kStage + j * P::kBoxKV, &tmk, &full[s],
                      j * 64, kh, c0, b);
          tma_load_4d(Vs + s * P::kStage + j * P::kBoxKV, &tmv, &full[s],
                      j * 64, kh, c0, b);
        }
      }
    }
    return;
  }

  // ---- consumers: 64 folded rows each ------------------------------------
  if constexpr (NC > 1) setmaxnreg_inc<240>();
  const int tid = threadIdx.x % 128;
  const int warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  // this thread's two folded rows of its warpgroup: la and la + 8, row
  // l holding position wg PG + l / G of the block and query head l % G;
  // rows from PG G on are idle (their position is past the warpgroup's)
  const int la = warp * 16 + gid, lb = la + 8;
  const int pa = base + q0 + wg * PG + la / G;
  const int pb = base + q0 + wg * PG + lb / G;
  if (PG * G < 64) {
    // zero the idle rows of this warpgroup's Q boxes (the TMA copy never
    // writes them), for the async proxy that wgmma reads through
    for (int idx = tid; idx < P::kDB * (64 - PG * G) * 8; idx += 128) {
      const int j = idx / ((64 - PG * G) * 8);
      const int rem = idx - j * (64 - PG * G) * 8;
      reinterpret_cast<uint4*>(Qs + (wg * P::kDB + j) * P::kBoxQ +
                               (PG * G + rem / 8) * 128)[rem % 8] =
          make_uint4(0u, 0u, 0u, 0u);
    }
    fence_proxy_async();
    named_bar_sync(1, 128 * NC);  // every consumer takes this branch
  }

  float o[P::kNP][P::kNW / 2];
#pragma unroll
  for (int n = 0; n < P::kNP; ++n)
#pragma unroll
    for (int i = 0; i < P::kNW / 2; ++i) o[n][i] = 0.f;
  // running max in the units of S (raw, or log2 with a softcap: see
  // softmax_tile); l is this thread's partial row sum, reduced over the
  // quad at the end
  float m_a = kMInit, m_b = kMInit, l_a = 0.f, l_b = 0.f;
  const float scale_log2 = scale * kLog2e;
  const uint32_t q_addr = smem_addr(Qs + wg * P::kDB * P::kBoxQ);

  mbar_wait(qbar, 0);
  for (int i = 0; i < ntiles; ++i) {
    const int s = i % STAGES;
    const int c0 = (t0 + i) * BN;
    mbar_wait(&full[s], (i / STAGES) & 1);

    float sacc[BN / 2];
    wgmma_fence();
    qk_async<D, BN, P::kBoxQ, P::kBoxKV>(sacc, q_addr,
                                         smem_addr(Ks + s * P::kStage));
    wgmma_commit();
    wgmma_wait<0>();

    // a tile every row attends in full (below the causal diagonal,
    // inside kv_hi and the window) skips the mask
    const bool tile_full =
        c0 + BN - 1 <= base + q0 && c0 + BN <= kv_hi &&
        (window <= 0 || c0 > base + q0 + nq - 1 - window);
    float al_a, al_b;
    softmax_tile<BN>(sacc, m_a, m_b, l_a, l_b, al_a, al_b, tile_full, c0,
                     tig, pa, pb, kv_hi, window, softcap, scale,
                     scale_log2);
#pragma unroll
    for (int n = 0; n < P::kNP; ++n)
#pragma unroll
      for (int j = 0; j < P::kNW / 2; ++j) o[n][j] *= (j & 2) ? al_b : al_a;
    uint32_t pf[BN / 16][4];
    to_a_frags<BN>(sacc, pf);

    if (c0 + BN > kv_hi) {
      // the tile straddles kv_hi: zero its V rows past kv_hi (all the
      // consumers together, then a barrier among them)
      const int rz = max(kv_hi - c0, 0);
      uint4* vt = reinterpret_cast<uint4*>(Vs + s * P::kStage);
      for (int idx = threadIdx.x; idx < P::kDB * BN * 8; idx += 128 * NC)
        if ((idx / 8) % BN >= rz) vt[idx] = make_uint4(0u, 0u, 0u, 0u);
      fence_proxy_async();
      named_bar_sync(1, 128 * NC);
    }

    wgmma_fence();
    pv_async<P::kNP, P::kNW, BN, P::kBoxKV>(o, pf,
                                            smem_addr(Vs + s * P::kStage));
    wgmma_commit();
    wgmma_wait<0>();
    if (lane == 0) mbar_arrive(&empty[s]);  // this warp is done with s
  }

  l_a += __shfl_xor_sync(0xffffffffu, l_a, 1);
  l_a += __shfl_xor_sync(0xffffffffu, l_a, 2);
  l_b += __shfl_xor_sync(0xffffffffu, l_b, 1);
  l_b += __shfl_xor_sync(0xffffffffu, l_b, 2);
  float inv_a, inv_b;
  if constexpr (SINKS) {
    // m in log2 units: softmax_tile's exponent is (s - m) mult
    const float mult = softcap > 0.f ? 1.f : scale_log2;
    float f_a, den_a, f_b, den_b;
    sink_norm<true>(m_a * mult, l_a, sinks, kh * G + la % G, kLog2e, f_a,
                    den_a);
    sink_norm<true>(m_b * mult, l_b, sinks, kh * G + lb % G, kLog2e, f_b,
                    den_b);
    inv_a = f_a / den_a;
    inv_b = f_b / den_b;
  } else {
    inv_a = 1.f / fmaxf(l_a, 1e-30f);
    inv_b = 1.f / fmaxf(l_b, 1e-30f);
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int l = half ? lb : la;
    const int qi = wg * PG + l / G;  // position in the block
    if (l >= PG * G || qi >= nq) continue;
    const float inv = half ? inv_b : inv_a;
    uint16_t* dst =
        out + (((size_t)b * Sq + q0 + qi) * H + kh * G + l % G) * D +
        tig * 2;
#pragma unroll
    for (int n = 0; n < P::kNP; ++n)
#pragma unroll
      for (int i = 0; i < P::kNW / 8; ++i)
        if (n * P::kNW + i * 8 < D)  // the padding columns past D
          *reinterpret_cast<uint32_t*>(dst + n * P::kNW + i * 8) =
              pack_bf16(o[n][4 * i + 2 * half] * inv,
                        o[n][4 * i + 2 * half + 1] * inv);
  }
}

// ---------------------------------------------------------------- fp32 ---

constexpr int kBNf = 32;  // KV rows per tile
constexpr int kThreadsF = 256;  // 4 threads per folded row

// Grid (ceil(Sq / floor(64 / G)), K, B), 256 threads. Thread t owns folded
// row t / 4, KV columns (t % 4) + 4j of each tile and output dims
// (t % 4) + 4j; rows from floor(64 / G) G on are idle.
template <int D>
__global__ void __launch_bounds__(kThreadsF)
prefill_f32(const float* __restrict__ q, const float* __restrict__ k,
            const float* __restrict__ v, const int* __restrict__ base_arr,
            const int* __restrict__ kvhi_arr, float* __restrict__ out,
            const float* __restrict__ sinks, int Sq, int S, int H, int K,
            int G, float scale, float softcap, int window) {
  extern __shared__ float smem[];
  float* Qs = smem;                       // [kBM][D + 1]
  float* Ks = Qs + kBM * (D + 1);         // [kBNf][D + 1]
  float* Vs = Ks + kBNf * (D + 1);        // [kBNf][D]

  const int qt = blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
  const int t = threadIdx.x, r = t >> 2, sub = t & 3;
  const int BQ = kBM / G;
  const int base = base_arr[b];
  const int kv_hi = min(kvhi_arr[b], S);
  const int q0 = qt * BQ;
  const int nq = min(BQ, Sq - q0);
  const bool vr = r / G < nq;
  const int qi = q0 + r / G;
  const int pos = base + qi;
  const size_t qrow = (((size_t)b * Sq + (vr ? qi : 0)) * H + kh * G + r % G) * D;

  for (int idx = t; idx < kBM * D; idx += kThreadsF) {
    const int rr = idx / D, d = idx % D;
    const bool ok = rr / G < nq;
    const size_t g = (((size_t)b * Sq + (ok ? q0 + rr / G : 0)) * H + kh * G + rr % G) * D + d;
    Qs[rr * (D + 1) + d] = ok ? q[g] : 0.f;
  }

  constexpr int DJ = D / 4;
  float acc[DJ];
#pragma unroll
  for (int j = 0; j < DJ; ++j) acc[j] = 0.f;
  float m = kMInit, l = 0.f;

  const int last = min(base + q0 + nq - 1, kv_hi - 1);
  const int first = window > 0 ? max(base + q0 - window + 1, 0) : 0;
  if (nq > 0 && last >= first) {
    for (int tile = first / kBNf; tile <= last / kBNf; ++tile) {
      const int c0 = tile * kBNf;
      __syncthreads();
      for (int idx = t; idx < kBNf * D; idx += kThreadsF) {
        const int rr = idx / D, d = idx % D;
        const int row = c0 + rr;
        float kx = 0.f, vx = 0.f;
        if (row < kv_hi) {
          const size_t g = (((size_t)b * S + row) * K + kh) * D + d;
          kx = k[g];
          vx = v[g];
        }
        Ks[rr * (D + 1) + d] = kx;
        Vs[rr * D + d] = vx;
      }
      __syncthreads();

      float s[kBNf / 4];
      uint32_t valid = 0u;
      float tmax = kMInit;
#pragma unroll
      for (int j = 0; j < kBNf / 4; ++j) {
        const int c = sub + 4 * j;
        float d = 0.f;
        for (int e = 0; e < D; ++e)
          d = fmaf(Qs[r * (D + 1) + e], Ks[c * (D + 1) + e], d);
        const int col = c0 + c;
        bool ok = vr && col <= pos && col < kv_hi;
        if (window > 0) ok = ok && col > pos - window;
        float x = d * scale;
        if (softcap > 0.f) x = tanhf(x / softcap) * softcap;
        x = ok ? x : kMInit;
        s[j] = x;
        valid |= (ok ? 1u : 0u) << j;
        tmax = fmaxf(tmax, x);
      }
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
      const float mn = fmaxf(m, tmax);
      const float alpha = expf(m - mn);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < kBNf / 4; ++j) {
        s[j] = ((valid >> j) & 1u) ? expf(s[j] - mn) : 0.f;
        rs += s[j];
      }
      rs += __shfl_xor_sync(0xffffffffu, rs, 1);
      rs += __shfl_xor_sync(0xffffffffu, rs, 2);
      l = l * alpha + rs;
      m = mn;
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[j] *= alpha;
      // each of the 4 threads of a row holds 8 of its 32 probabilities;
      // broadcast them across the quad with shuffles
#pragma unroll
      for (int src = 0; src < 4; ++src) {
#pragma unroll
        for (int j = 0; j < kBNf / 4; ++j) {
          const float p = __shfl_sync(0xffffffffu, s[j], (t & 31 & ~3) | src);
          const int c = src + 4 * j;
#pragma unroll
          for (int jd = 0; jd < DJ; ++jd)
            acc[jd] = fmaf(p, Vs[c * D + sub + 4 * jd], acc[jd]);
        }
      }
    }
  }

  if (vr) {
    float f, den;
    sink_norm<false>(m, l, sinks, kh * G + r % G, 1.f, f, den);
    const float inv = f / den;
#pragma unroll
    for (int jd = 0; jd < DJ; ++jd) out[qrow + sub + 4 * jd] = acc[jd] * inv;
  }
}

template <int D>
cudaError_t launch_f32(const float* q, const float* k, const float* v,
                       const int* base, const int* kvhi, float* out,
                       const float* sinks, int B, int Sq, int S, int H,
                       int K, int G, float scale, float softcap, int window,
                       cudaStream_t st) {
  const size_t smem = sizeof(float) *
      ((size_t)kBM * (D + 1) + (size_t)kBNf * (D + 1) + (size_t)kBNf * D);
  cudaError_t err = cudaFuncSetAttribute(
      prefill_f32<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int BQ = kBM / G;
  prefill_f32<D><<<dim3((Sq + BQ - 1) / BQ, K, B), kThreadsF, smem, st>>>(
      q, k, v, base, kvhi, out, sinks, Sq, S, H, K, G, scale, softcap,
      window);
  return cudaGetLastError();
}

// bf16 x [B, L, X, D] as the 4D map (D, X, L, B), box (64, bx, bl, 1),
// 128-byte swizzle; coordinates past L, and past D, read as zeros
bool encode_bf16_4d(CUtensorMap* map, const void* x, int B, int L, int X,
                    int D, int bx, int bl) {
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)X, (cuuint64_t)L,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)X * D * 2,
                                 (cuuint64_t)L * X * D * 2};
  const cuuint32_t box[4] = {64, (cuuint32_t)bx, (cuuint32_t)bl, 1};
  return encode_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, x, dims,
                    strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
}

template <int D, int NC, bool SINKS>
cudaError_t launch_wgmma(const uint16_t* q, const uint16_t* k,
                         const uint16_t* v, const int* base,
                         const int* kvhi, uint16_t* out, const float* sinks,
                         int B, int Sq, int S, int H, int K, int G,
                         float scale, float softcap, int window,
                         cudaStream_t st) {
  constexpr int BN = tile_rows<D>();
  using P = Prefill<D, BN, NC, kStages>;
  CUtensorMap tmq, tmk, tmv;
  if (!encode_bf16_4d(&tmq, q, B, Sq, H, D, G, 64 / G) ||
      !encode_bf16_4d(&tmk, k, B, S, K, D, 1, BN) ||
      !encode_bf16_4d(&tmv, v, B, S, K, D, 1, BN))
    return cudaErrorInvalidValue;
  auto kern = prefill_wgmma<D, BN, NC, kStages, SINKS>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, P::kSmem);
  if (err != cudaSuccess) return err;
  const int bq = NC * (64 / G);
  kern<<<dim3(K, B, (Sq + bq - 1) / bq), P::kThreads, P::kSmem, st>>>(
      tmq, tmk, tmv, base, kvhi, out, sinks, Sq, S, H, G, scale, softcap,
      window);
  return cudaGetLastError();
}

// Two consumer warpgroups per block unless that grid would leave SMs
// idle (the short prompts), then one; the sink instance with sinks.
template <int D>
cudaError_t launch_bf16(const uint16_t* q, const uint16_t* k,
                        const uint16_t* v, const int* base, const int* kvhi,
                        uint16_t* out, const float* sinks, int B, int Sq,
                        int S, int H, int K, int G, float scale,
                        float softcap, int window, cudaStream_t st) {
  const int bq2 = 2 * (64 / G);  // positions of a two-consumer block
  const long blocks2 = (long)K * B * ((Sq + bq2 - 1) / bq2);
  const bool two = blocks2 >= sm_count();
  if (sinks != nullptr)
    return two ? launch_wgmma<D, 2, true>(q, k, v, base, kvhi, out, sinks, B,
                                          Sq, S, H, K, G, scale, softcap,
                                          window, st)
               : launch_wgmma<D, 1, true>(q, k, v, base, kvhi, out, sinks, B,
                                          Sq, S, H, K, G, scale, softcap,
                                          window, st);
  return two ? launch_wgmma<D, 2, false>(q, k, v, base, kvhi, out, nullptr, B,
                                         Sq, S, H, K, G, scale, softcap,
                                         window, st)
             : launch_wgmma<D, 1, false>(q, k, v, base, kvhi, out, nullptr, B,
                                         Sq, S, H, K, G, scale, softcap,
                                         window, st);
}

}  // namespace

// q [B, Sq, H, D]; k, v [B, S, K, D] (contiguous, same dtype); base, kv_hi
// [B] int32; out [B, Sq, H, D]; D 64, 96, 128 or 256. window <= 0
// disables the sliding window, softcap <= 0 the softcap. sinks: [H] fp32
// per-head sink logits (gpt-oss), or NULL. G = H / K must be 1 to 16.
// Returns the CUDA error code of the launch (0 on success).
extern "C" int ome_flash_prefill(const void* q, const void* k, const void* v,
                                 const int* base, const int* kv_hi, void* out,
                                 const float* sinks, int B, int Sq, int S,
                                 int H, int K, int D,
                                 float scale, float softcap, int window,
                                 int is_bf16, void* stream) {
  if (K <= 0 || H % K != 0) return cudaErrorInvalidValue;
  const int G = H / K;
  if (G < 1 || G > 16) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B == 0 || Sq == 0) return cudaSuccess;
  if (S == 0)  // nothing to attend: every row is 0 (a sink takes it all)
    return cudaMemsetAsync(out, 0, (size_t)B * Sq * H * D * (is_bf16 ? 2 : 4),
                           st);
  if (is_bf16) {
    const uint16_t* q16 = static_cast<const uint16_t*>(q);
    const uint16_t* k16 = static_cast<const uint16_t*>(k);
    const uint16_t* v16 = static_cast<const uint16_t*>(v);
    uint16_t* o16 = static_cast<uint16_t*>(out);
    if (D == 128) return launch_bf16<128>(q16, k16, v16, base, kv_hi, o16, sinks, B, Sq, S, H, K, G, scale, softcap, window, st);
    if (D == 64) return launch_bf16<64>(q16, k16, v16, base, kv_hi, o16, sinks, B, Sq, S, H, K, G, scale, softcap, window, st);
    if (D == 96) return launch_bf16<96>(q16, k16, v16, base, kv_hi, o16, sinks, B, Sq, S, H, K, G, scale, softcap, window, st);
    if (D == 256) return launch_bf16<256>(q16, k16, v16, base, kv_hi, o16, sinks, B, Sq, S, H, K, G, scale, softcap, window, st);
  } else {
    const float* qf = static_cast<const float*>(q);
    const float* kf = static_cast<const float*>(k);
    const float* vf = static_cast<const float*>(v);
    float* of = static_cast<float*>(out);
    if (D == 128) return launch_f32<128>(qf, kf, vf, base, kv_hi, of, sinks, B, Sq, S, H, K, G, scale, softcap, window, st);
    if (D == 64) return launch_f32<64>(qf, kf, vf, base, kv_hi, of, sinks, B, Sq, S, H, K, G, scale, softcap, window, st);
    if (D == 96) return launch_f32<96>(qf, kf, vf, base, kv_hi, of, sinks, B, Sq, S, H, K, G, scale, softcap, window, st);
    if (D == 256) return launch_f32<256>(qf, kf, vf, base, kv_hi, of, sinks, B, Sq, S, H, K, G, scale, softcap, window, st);
  }
  return cudaErrorInvalidValue;
}

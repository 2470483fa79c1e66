// Causal GQA prefill attention for Hopper, with a per-sequence position
// base so that a chunk of queries can attend into a filled cache.
//
// Replaces ome_tpu/ops/flash.py::_flash_prefill (kernel body
// _prefill_kernel, KV range _prefill_block_range). Same function: query
// row i of sequence b sits at position base[b] + i and attends the KV
// columns c with c <= base[b] + i, c < kv_hi[b] and, with a sliding
// window W, c > base[b] + i - W; the optional tanh softcap applies to the
// scaled logits; the softmax state is fp32 with the finite M_INIT = -1e30
// start and the l >= 1e-30 clamp.
//
// What bounds it on an H100: tensor-core operations (a 2048-token prompt
// does ~16 flops per byte of Q/K/V per head, and the causal QK^T and PV
// products dominate). The design answers that bound as follows:
//   * bf16 inputs run both products on the tensor cores with
//     mma.sync.m16n8k16 (bf16 in, fp32 accumulate), FlashAttention-2
//     style: each warp owns 16 query rows, keeps its Q fragments and its
//     O accumulator in registers for the whole KV walk, and re-packs the
//     fp32 probabilities straight from the QK^T accumulators into the A
//     operand of the PV product, so S and P never touch shared memory;
//     K and V tiles arrive by cp.async into two stages of shared memory
//     (the next tile loads while this one is multiplied) and leave it by
//     ldmatrix, transposed on the fly for V;
//   * the G query heads of one KV head are folded into the rows of the
//     block's 64-row tile (as _prefill_kernel folds them into the MXU
//     rows), so each K/V tile staged in shared memory serves all G heads;
//   * a block walks only the KV tiles between the window's first tile and
//     min(causal frontier, kv_hi), the bounds _prefill_block_range
//     computes: the upper triangle, the cache tail and the pre-window head
//     are neither loaded nor computed.
// fp32 inputs take a plain kernel with the same tiling and scalar FMA in
// fp32 (tensor-core TF32 would not hold fp32 tolerances); fp32 is not on
// the bf16 serving path. Neither kernel yet uses wgmma or TMA.
//
// Built with nvcc into a shared library with a plain C interface (see
// ome_tpu_torch/ops/_build.py) and called through ctypes.

#include "common.cuh"

namespace {

constexpr int kBM = 64;  // folded query rows per block (positions x G)

// ---------------------------------------------------------------- bf16 ---

constexpr int kBN = 64;  // KV rows per tile
constexpr int kPad = 8;  // bf16 elements of row padding (bank spread)
constexpr float kLog2e = 1.4426950408889634f;

// four 8x8 b16 matrices; lanes 8i..8i+7 give the row addresses of
// matrix i, and lane t receives row t/4, columns 2(t%4), 2(t%4)+1 of each
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// the same, each matrix transposed: lane t receives rows 2(t%4) and
// 2(t%4)+1 of column t/4
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// Grid (ceil(Sq / (64 / G)), K, B), 128 threads (4 warps x 16 rows),
// dynamic shared memory for two stages of K and V tiles.
template <int D>
constexpr int mma_smem_bytes() {
  return 2 * 2 * kBN * (D + kPad) * 2;
}

template <int D>
__global__ void __launch_bounds__(128)
prefill_mma(const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
            const uint16_t* __restrict__ v, const int* __restrict__ base_arr,
            const int* __restrict__ kvhi_arr, uint16_t* __restrict__ out,
            int Sq, int S, int H, int K, int G, float scale, float softcap,
            int window) {
  constexpr int RS = D + kPad;  // smem row stride (elements)
  extern __shared__ __align__(16) uint16_t smem16[];
  // [stage][row][RS] each
  uint16_t* const Ks = smem16;
  uint16_t* const Vs = smem16 + 2 * kBN * RS;

  const int qt = blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int BQ = kBM / G;
  const int base = base_arr[b];
  const int kv_hi = min(kvhi_arr[b], S);
  const int q0 = qt * BQ;
  const int nq = min(BQ, Sq - q0);

  // this thread's two rows of the warp's 16: folded rows ra and ra + 8
  const int ra = warp * 16 + gid, rb = ra + 8;
  const bool va = ra / G < nq, vb = rb / G < nq;
  const int qa = q0 + ra / G, qb = q0 + rb / G;
  const int pa = base + qa, pb = base + qb;  // absolute positions
  const size_t rowa = (((size_t)b * Sq + (va ? qa : 0)) * H + kh * G + ra % G) * D;
  const size_t rowb = (((size_t)b * Sq + (vb ? qb : 0)) * H + kh * G + rb % G) * D;

  uint32_t qf[D / 16][4];
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc) {
    const int c = kc * 16 + tig * 2;
    qf[kc][0] = va ? ld32(q + rowa + c) : 0u;
    qf[kc][1] = vb ? ld32(q + rowb + c) : 0u;
    qf[kc][2] = va ? ld32(q + rowa + c + 8) : 0u;
    qf[kc][3] = vb ? ld32(q + rowb + c + 8) : 0u;
  }

  float o[D / 8][4];
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd)
    o[nd][0] = o[nd][1] = o[nd][2] = o[nd][3] = 0.f;
  // running max in log2 units: exp(x - m) = exp2(x log2(e) - m log2(e))
  float m_a = kMInit, m_b = kMInit, l_a = 0.f, l_b = 0.f;
  const float scale_log2 = scale * kLog2e;

  // KV columns any row of this tile can attend (_prefill_block_range)
  const int last = min(base + q0 + nq - 1, kv_hi - 1);
  const int first = window > 0 ? max(base + q0 - window + 1, 0) : 0;
  const int t0 = first / kBN;
  const int ntiles = (nq > 0 && last >= first) ? last / kBN - t0 + 1 : 0;

  // rows past kv_hi are zero-filled, never read
  auto load_tile = [&](int i, int buf) {
    const int c0 = (t0 + i) * kBN;
    for (int idx = threadIdx.x; idx < kBN * (D / 8); idx += 128) {
      const int r = idx / (D / 8), ch = (idx % (D / 8)) * 8;
      const int row = c0 + r;
      const bool ok = row < kv_hi;
      const size_t g = (((size_t)b * S + (ok ? row : 0)) * K + kh) * D + ch;
      const int dst = (buf * kBN + r) * RS + ch;
      cp_async16(Ks + dst, k + g, ok ? 16 : 0);
      cp_async16(Vs + dst, v + g, ok ? 16 : 0);
    }
    cp_async_commit();
  };

  // ldmatrix row addresses: lane l feeds row l % 8 of matrix l / 8
  const int lm_row = lane & 7, lm_mat = lane >> 3;

  if (ntiles > 0) load_tile(0, 0);
  for (int i = 0; i < ntiles; ++i) {
    const int buf = i & 1;
    const int c0 = (t0 + i) * kBN;
    if (i + 1 < ntiles) {
      load_tile(i + 1, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile i landed for every thread
    const uint16_t* Kt = Ks + buf * kBN * RS;
    const uint16_t* Vt = Vs + buf * kBN * RS;

    // S = Q K^T over this tile: kBN / 8 column groups of 8; one
    // ldmatrix.x4 gives the B fragments of two groups for one k step
    float s[kBN / 8][4];
#pragma unroll
    for (int nt = 0; nt < kBN / 8; ++nt)
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
    for (int nt = 0; nt < kBN / 8; nt += 2) {
#pragma unroll
      for (int kc = 0; kc < D / 16; ++kc) {
        uint32_t bf[4];
        // matrices: (group nt, k lo), (nt, k hi), (nt+1, k lo), (nt+1, k hi)
        ldmatrix_x4(bf, Kt + ((nt + (lm_mat >> 1)) * 8 + lm_row) * RS +
                            kc * 16 + (lm_mat & 1) * 8);
        mma16816(s[nt], qf[kc], bf[0], bf[1]);
        mma16816(s[nt + 1], qf[kc], bf[2], bf[3]);
      }
    }

    // logits in log2 units (exp2 below), softcap, mask (bit nt*4+e set
    // = valid) and the row max; a tile every row attends in full (below
    // the causal diagonal, inside kv_hi and the window) skips the masks
    const bool full = c0 + kBN - 1 <= base + q0 && c0 + kBN <= kv_hi &&
                      (window <= 0 || c0 > base + q0 + nq - 1 - window);
    uint32_t valid = full ? 0xffffffffu : 0u;
    float tmax_a = kMInit, tmax_b = kMInit;
#pragma unroll
    for (int nt = 0; nt < kBN / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool lower = e >= 2;
        float x = softcap > 0.f
                      ? tanhf(s[nt][e] * scale / softcap) * softcap * kLog2e
                      : s[nt][e] * scale_log2;
        if (!full) {
          const int col = c0 + nt * 8 + tig * 2 + (e & 1);
          const int p = lower ? pb : pa;
          bool ok = (lower ? vb : va) && col <= p && col < kv_hi;
          if (window > 0) ok = ok && col > p - window;
          x = ok ? x : kMInit;
          valid |= (ok ? 1u : 0u) << (nt * 4 + e);
        }
        s[nt][e] = x;
        if (lower) tmax_b = fmaxf(tmax_b, x);
        else tmax_a = fmaxf(tmax_a, x);
      }
    }
    tmax_a = fmaxf(tmax_a, __shfl_xor_sync(0xffffffffu, tmax_a, 1));
    tmax_a = fmaxf(tmax_a, __shfl_xor_sync(0xffffffffu, tmax_a, 2));
    tmax_b = fmaxf(tmax_b, __shfl_xor_sync(0xffffffffu, tmax_b, 1));
    tmax_b = fmaxf(tmax_b, __shfl_xor_sync(0xffffffffu, tmax_b, 2));
    const float mn_a = fmaxf(m_a, tmax_a), mn_b = fmaxf(m_b, tmax_b);
    const float al_a = exp2f(m_a - mn_a), al_b = exp2f(m_b - mn_b);
    float rs_a = 0.f, rs_b = 0.f;
#pragma unroll
    for (int nt = 0; nt < kBN / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool lower = e >= 2;
        const float p = ((valid >> (nt * 4 + e)) & 1u)
                            ? exp2f(s[nt][e] - (lower ? mn_b : mn_a))
                            : 0.f;
        s[nt][e] = p;
        if (lower) rs_b += p;
        else rs_a += p;
      }
    }
    rs_a += __shfl_xor_sync(0xffffffffu, rs_a, 1);
    rs_a += __shfl_xor_sync(0xffffffffu, rs_a, 2);
    rs_b += __shfl_xor_sync(0xffffffffu, rs_b, 1);
    rs_b += __shfl_xor_sync(0xffffffffu, rs_b, 2);
    l_a = l_a * al_a + rs_a;
    l_b = l_b * al_b + rs_b;
    m_a = mn_a;
    m_b = mn_b;
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd) {
      o[nd][0] *= al_a; o[nd][1] *= al_a;
      o[nd][2] *= al_b; o[nd][3] *= al_b;
    }

    // O += P V: the QK^T accumulator layout of two adjacent column
    // groups is exactly the A-operand layout of one 16-deep k step; the
    // V fragments come transposed out of shared memory by ldmatrix
#pragma unroll
    for (int kc = 0; kc < kBN / 16; ++kc) {
      uint32_t a[4];
      a[0] = pack_bf16(s[2 * kc][0], s[2 * kc][1]);
      a[1] = pack_bf16(s[2 * kc][2], s[2 * kc][3]);
      a[2] = pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]);
      a[3] = pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3]);
#pragma unroll
      for (int nd = 0; nd < D / 8; nd += 2) {
        uint32_t bf[4];
        // matrices: (k lo, dims nd), (k hi, nd), (k lo, nd+1), (k hi, nd+1)
        ldmatrix_x4_trans(bf, Vt + (kc * 16 + (lm_mat & 1) * 8 + lm_row) *
                                       RS + (nd + (lm_mat >> 1)) * 8);
        mma16816(o[nd], a, bf[0], bf[1]);
        mma16816(o[nd + 1], a, bf[2], bf[3]);
      }
    }
    __syncthreads();  // tile i consumed before its buffer is refilled
  }

  const float inv_a = 1.f / fmaxf(l_a, 1e-30f);
  const float inv_b = 1.f / fmaxf(l_b, 1e-30f);
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd) {
    const int c = nd * 8 + tig * 2;
    if (va) {
      const uint32_t w = (uint32_t)to_bf16(o[nd][0] * inv_a) |
                         ((uint32_t)to_bf16(o[nd][1] * inv_a) << 16);
      *reinterpret_cast<uint32_t*>(out + rowa + c) = w;
    }
    if (vb) {
      const uint32_t w = (uint32_t)to_bf16(o[nd][2] * inv_b) |
                         ((uint32_t)to_bf16(o[nd][3] * inv_b) << 16);
      *reinterpret_cast<uint32_t*>(out + rowb + c) = w;
    }
  }
}

// ---------------------------------------------------------------- fp32 ---

constexpr int kBNf = 32;  // KV rows per tile
constexpr int kThreadsF = 256;  // 4 threads per folded row

// Grid (ceil(Sq / (64 / G)), K, B), 256 threads. Thread t owns folded row
// t / 4, KV columns (t % 4) + 4j of each tile and output dims (t % 4) + 4j.
template <int D>
__global__ void __launch_bounds__(kThreadsF)
prefill_f32(const float* __restrict__ q, const float* __restrict__ k,
            const float* __restrict__ v, const int* __restrict__ base_arr,
            const int* __restrict__ kvhi_arr, float* __restrict__ out, int Sq,
            int S, int H, int K, int G, float scale, float softcap,
            int window) {
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
    const float inv = 1.f / fmaxf(l, 1e-30f);
#pragma unroll
    for (int jd = 0; jd < DJ; ++jd) out[qrow + sub + 4 * jd] = acc[jd] * inv;
  }
}

template <int D>
cudaError_t launch_f32(const float* q, const float* k, const float* v,
                       const int* base, const int* kvhi, float* out, int B,
                       int Sq, int S, int H, int K, int G, float scale,
                       float softcap, int window, cudaStream_t st) {
  const size_t smem = sizeof(float) *
      ((size_t)kBM * (D + 1) + (size_t)kBNf * (D + 1) + (size_t)kBNf * D);
  cudaError_t err = cudaFuncSetAttribute(
      prefill_f32<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int BQ = kBM / G;
  prefill_f32<D><<<dim3((Sq + BQ - 1) / BQ, K, B), kThreadsF, smem, st>>>(
      q, k, v, base, kvhi, out, Sq, S, H, K, G, scale, softcap, window);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_bf16(const uint16_t* q, const uint16_t* k,
                        const uint16_t* v, const int* base, const int* kvhi,
                        uint16_t* out, int B, int Sq, int S, int H, int K,
                        int G, float scale, float softcap, int window,
                        cudaStream_t st) {
  constexpr int smem = mma_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      prefill_mma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int BQ = kBM / G;
  prefill_mma<D><<<dim3((Sq + BQ - 1) / BQ, K, B), 128, smem, st>>>(
      q, k, v, base, kvhi, out, Sq, S, H, K, G, scale, softcap, window);
  return cudaGetLastError();
}

}  // namespace

// q [B, Sq, H, D]; k, v [B, S, K, D] (contiguous, same dtype); base, kv_hi
// [B] int32; out [B, Sq, H, D]. window <= 0 disables the sliding window,
// softcap <= 0 the softcap. G = H / K must divide 64. Returns the CUDA
// error code of the launch (0 on success).
extern "C" int ome_flash_prefill(const void* q, const void* k, const void* v,
                                 const int* base, const int* kv_hi, void* out,
                                 int B, int Sq, int S, int H, int K, int D,
                                 float scale, float softcap, int window,
                                 int is_bf16, void* stream) {
  if (K <= 0 || H % K != 0) return cudaErrorInvalidValue;
  const int G = H / K;
  if (G > kBM || kBM % G != 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    const uint16_t* q16 = static_cast<const uint16_t*>(q);
    const uint16_t* k16 = static_cast<const uint16_t*>(k);
    const uint16_t* v16 = static_cast<const uint16_t*>(v);
    uint16_t* o16 = static_cast<uint16_t*>(out);
    if (D == 128) return launch_bf16<128>(q16, k16, v16, base, kv_hi, o16, B, Sq, S, H, K, G, scale, softcap, window, st);
    if (D == 64) return launch_bf16<64>(q16, k16, v16, base, kv_hi, o16, B, Sq, S, H, K, G, scale, softcap, window, st);
  } else {
    const float* qf = static_cast<const float*>(q);
    const float* kf = static_cast<const float*>(k);
    const float* vf = static_cast<const float*>(v);
    float* of = static_cast<float*>(out);
    if (D == 128) return launch_f32<128>(qf, kf, vf, base, kv_hi, of, B, Sq, S, H, K, G, scale, softcap, window, st);
    if (D == 64) return launch_f32<64>(qf, kf, vf, base, kv_hi, of, B, Sq, S, H, K, G, scale, softcap, window, st);
  }
  return cudaErrorInvalidValue;
}

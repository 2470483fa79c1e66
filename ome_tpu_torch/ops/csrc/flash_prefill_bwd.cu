// The backward of the causal GQA prefill attention (B2, flash_prefill.cu)
// on its fp32 training path, for Hopper. bf16 inputs, the training
// step's, go to the wgmma kernel of flash_prefill_bwd_wgmma.cu, which
// takes the logsumexp the forward saved; this scalar kernel serves fp32
// alone (the identity checks' fp32 steps), where tensor-core TF32 would
// not hold fp32 tolerances.
//
// Replaces no Pallas kernel: the reference's train step differentiates
// its XLA attention with jax.grad (ome_tpu/ops/attention.py:48-81; none
// of its Pallas kernels has a backward). The port's training forward
// runs B2 on the card, so its gradient is this kernel (fp32) or the
// wgmma one (bf16), behind ops/flash.py::FlashPrefill.
//
// The function: q [B, S, H, D], k, v [B, S, K, D] (G = H / K query heads
// per KV head, any G) and the gradient dO [B, S, H, D] of the output, all
// fp32. Query row i attends key rows j <= i and, with a sliding window
// W, j > i - W: B2's contract at base 0 with kv_hi = S, the only shape a
// training forward gives it. With s = scale q.k (then s = c tanh(s / c)
// under a softcap c), P = exp(s - lse) and
//   dV = P^T dO,  dP = dO V^T,  dS = P (dP - Delta),  Delta = rowsum(P dP),
//   dQ = scale dS' K,  dK = scale dS'^T Q,  dS' = dS (1 - (s / c)^2).
// Every product and sum in fp32. No sinks: the row pass recomputes a
// logsumexp without them (check_prefill_grad refuses fp32 sinks).
//
// What bounds it on an H100: the operations of its five products, 10 D
// per (row, key) pair and head (QK^T and dO V^T recomputed, P^T dO,
// dS^T Q, dS K): 2.5654 ms for the 8B's heads at causal 2048, B 2, at
// the 67 TFLOP/s fp32 peak. This kernel is built to be right and simple:
//   * three launches, no atomics, so a second launch gives the same
//     bits: a row pass (one block per sequence, head and 64-row query
//     tile) recomputes each row's logsumexp over its valid keys and
//     Delta (from P and dP, not the forward's output: pass 1's note);
//     a dK/dV pass (one block per sequence, KV head and KV tile) loops
//     over the G heads and the query tiles that see its keys and
//     holds dK and dV in registers; a dQ pass (one block per sequence,
//     head and query tile) walks the key tiles its rows see;
//   * every product runs on the CUDA cores in fp32 from shared-memory
//     tiles (rows padded by one float, so a warp reads its 16 columns
//     from 16 banks), each thread owning a 4 x 4 (at D 256, 32-row
//     tiles: 2 x 2) block of a 64 x 64 score tile and a (tile / 16) x
//     (D / 16) block of its outputs;
//   * the walks cover only the tiles that hold a valid pair (the causal
//     frontier and the window), heaviest blocks first.
//
// Built with nvcc into a shared library with a plain C interface (see
// ome_tpu_torch/ops/_build.py) and called through ctypes.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

// rows of a query or key tile: 64, and 32 at head_dim 256 (shared memory)
template <int D>
__host__ __device__ constexpr int tile_rows() { return D > 128 ? 32 : 64; }

__device__ __forceinline__ bool pair_valid(int i, int j, int S, int window) {
  return i < S && j <= i && (window <= 0 || j > i - window);
}

// rows r0 .. r0 + rows - 1 of head h of x [B, S, NH, D] -> dst [rows][D + 1];
// rows at or past S are zero
template <int D>
__device__ __forceinline__ void load_tile(float* dst, const float* x, int b,
                                          int r0, int rows, int S, int NH,
                                          int h) {
  for (int e = threadIdx.x; e < rows * D; e += kThreads) {
    const int r = e / D, d = e - r * D;
    const int i = r0 + r;
    float val = 0.f;
    if (i < S) val = x[(((size_t)b * S + i) * NH + h) * D + d];
    dst[r * (D + 1) + d] = val;
  }
}

// rows r0 .. of a [B, H, S] fp32 plane -> dst[rows]
__device__ __forceinline__ void load_rows(float* dst, const float* x, int b,
                                          int h, int H, int r0, int rows,
                                          int S) {
  for (int r = threadIdx.x; r < rows; r += kThreads) {
    const int i = r0 + r;
    dst[r] = i < S ? x[((size_t)b * H + h) * S + i] : 0.f;
  }
}

// s[rm][cn] = A[rg RM + rm] . Bm[cg + 16 cn] over D (and, with TWO,
// t[rm][cn] = A2[..] . B2[..] in the same walk)
template <int D, int RM, int CN, bool TWO>
__device__ __forceinline__ void tile_dot(const float* A, const float* Bm,
                                         const float* A2, const float* B2,
                                         int rg, int cg, float (&s)[RM][CN],
                                         float (&t)[RM][CN]) {
  constexpr int LD = D + 1;
#pragma unroll
  for (int rm = 0; rm < RM; ++rm)
#pragma unroll
    for (int cn = 0; cn < CN; ++cn) s[rm][cn] = t[rm][cn] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float a[RM], bb[CN];
#pragma unroll
    for (int rm = 0; rm < RM; ++rm) a[rm] = A[(rg * RM + rm) * LD + d];
#pragma unroll
    for (int cn = 0; cn < CN; ++cn) bb[cn] = Bm[(cg + 16 * cn) * LD + d];
#pragma unroll
    for (int rm = 0; rm < RM; ++rm)
#pragma unroll
      for (int cn = 0; cn < CN; ++cn) s[rm][cn] = fmaf(a[rm], bb[cn], s[rm][cn]);
    if constexpr (TWO) {
#pragma unroll
      for (int rm = 0; rm < RM; ++rm) a[rm] = A2[(rg * RM + rm) * LD + d];
#pragma unroll
      for (int cn = 0; cn < CN; ++cn) bb[cn] = B2[(cg + 16 * cn) * LD + d];
#pragma unroll
      for (int rm = 0; rm < RM; ++rm)
#pragma unroll
        for (int cn = 0; cn < CN; ++cn)
          t[rm][cn] = fmaf(a[rm], bb[cn], t[rm][cn]);
    }
  }
}

// the logit of a raw dot product: scaled, then softcapped; `th` is the
// tanh (0 without a softcap) for the softcap's derivative
__device__ __forceinline__ float logit(float dot, float scale, float softcap,
                                       float& th) {
  const float x = dot * scale;
  if (softcap > 0.f) {
    th = tanhf(x / softcap);
    return softcap * th;
  }
  th = 0.f;
  return x;
}

// the half-warp of 16 threads that share a row group
__device__ __forceinline__ float half_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float half_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// key tiles [kt0, kt1] that the query rows q0 .. q0 + BQ - 1 see
template <int BQ, int BK>
__device__ __forceinline__ void key_tiles(int q0, int S, int window, int& kt0,
                                          int& kt1) {
  const int last = min(q0 + BQ, S) - 1;
  const int first = window > 0 ? max(q0 - window + 1, 0) : 0;
  kt0 = first / BK;
  kt1 = last / BK;
}

// -- pass 1: logsumexp and Delta of every query row -----------------------
//
// Delta_i = sum_j P_ij dP_ij, accumulated beside the softmax sum with the
// same running-max rescale: the gradient of the exact attention of these
// inputs. (rowsum(dO o) over the forward's bf16 output moved dq by 0.14
// of its rms at the 8B's causal 2048 on an H100: the output's rounding
// enters every dS of its row.)

template <int D>
__global__ void __launch_bounds__(kThreads)
    bwd_rows(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, const float* __restrict__ dout,
             float* __restrict__ lse, float* __restrict__ delta, int S, int H,
             int K, float scale, float softcap, int window) {
  constexpr int BQ = tile_rows<D>(), BK = BQ, RM = BQ / 16, CN = BK / 16;
  constexpr int LD = D + 1;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + BQ * LD;
  float* Ks = dOs + BQ * LD;
  float* Vs = Ks + BK * LD;
  const int b = blockIdx.z, h = blockIdx.y, kh = h / (H / K);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // longest rows first
  const int tid = threadIdx.x, rg = tid >> 4, cg = tid & 15;
  load_tile<D>(Qs, q, b, q0, BQ, S, H, h);
  load_tile<D>(dOs, dout, b, q0, BQ, S, H, h);
  float m[RM], l[RM], dacc[RM];
#pragma unroll
  for (int rm = 0; rm < RM; ++rm) { m[rm] = kMInit; l[rm] = dacc[rm] = 0.f; }
  int kt0, kt1;
  key_tiles<BQ, BK>(q0, S, window, kt0, kt1);
  for (int kt = kt0; kt <= kt1; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile is read (and Q, dO are in)
    load_tile<D>(Ks, k, b, k0, BK, S, K, kh);
    load_tile<D>(Vs, v, b, k0, BK, S, K, kh);
    __syncthreads();
    float s[RM][CN], dp[RM][CN];
    tile_dot<D, RM, CN, true>(Qs, Ks, dOs, Vs, rg, cg, s, dp);
#pragma unroll
    for (int rm = 0; rm < RM; ++rm) {
      const int i = q0 + rg * RM + rm;
      float tmax = kMInit;
#pragma unroll
      for (int cn = 0; cn < CN; ++cn) {
        float th;
        const float x = logit(s[rm][cn], scale, softcap, th);
        s[rm][cn] = pair_valid(i, k0 + cg + 16 * cn, S, window) ? x : kMInit;
        tmax = fmaxf(tmax, s[rm][cn]);
      }
      tmax = half_max(tmax);
      const float mn = fmaxf(m[rm], tmax);
      float sum = 0.f, dsum = 0.f;
#pragma unroll
      for (int cn = 0; cn < CN; ++cn) {
        const float p = pair_valid(i, k0 + cg + 16 * cn, S, window)
                            ? expf(s[rm][cn] - mn) : 0.f;
        sum += p;
        dsum = fmaf(p, dp[rm][cn], dsum);
      }
      sum = half_sum(sum);
      dsum = half_sum(dsum);
      const float alpha = expf(m[rm] - mn);
      l[rm] = l[rm] * alpha + sum;
      dacc[rm] = dacc[rm] * alpha + dsum;
      m[rm] = mn;
    }
  }
  if (cg == 0) {
#pragma unroll
    for (int rm = 0; rm < RM; ++rm) {
      const int i = q0 + rg * RM + rm;
      if (i >= S) continue;
      lse[((size_t)b * H + h) * S + i] = m[rm] + logf(l[rm]);
      delta[((size_t)b * H + h) * S + i] = dacc[rm] / l[rm];
    }
  }
}

// P and dS of one (query tile, key tile) pair into shared memory:
// rows rg RM + rm (queries), columns cg + 16 cn (keys)
template <int D, int RM, int CN>
__device__ __forceinline__ void p_ds(const float* Qs, const float* Ks,
                                     const float* dOs, const float* Vs,
                                     const float* lse_s, const float* dl_s,
                                     float* Ps, float* dSs, int q0, int k0,
                                     int S, float scale, float softcap,
                                     int window, int rg, int cg) {
  constexpr int LP = CN * 16 + 1;
  float s[RM][CN], dp[RM][CN];
  tile_dot<D, RM, CN, true>(Qs, Ks, dOs, Vs, rg, cg, s, dp);
#pragma unroll
  for (int rm = 0; rm < RM; ++rm) {
    const int r = rg * RM + rm, i = q0 + r;
#pragma unroll
    for (int cn = 0; cn < CN; ++cn) {
      const int c = cg + 16 * cn;
      float th;
      const float x = logit(s[rm][cn], scale, softcap, th);
      const bool ok = pair_valid(i, k0 + c, S, window);
      const float p = ok ? expf(x - lse_s[r]) : 0.f;
      float ds = p * (dp[rm][cn] - dl_s[r]);
      if (softcap > 0.f) ds *= 1.f - th * th;
      if (Ps) Ps[r * LP + c] = p;
      dSs[r * LP + c] = ds;
    }
  }
}

// -- pass 2: dK and dV of one KV tile --------------------------------------

template <int D>
__global__ void __launch_bounds__(kThreads)
    bwd_dkdv(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, const float* __restrict__ dout,
             const float* __restrict__ lse, const float* __restrict__ delta,
             float* __restrict__ dk, float* __restrict__ dv, int S, int H, int K,
             float scale, float softcap, int window) {
  constexpr int BQ = tile_rows<D>(), BK = BQ, RM = BQ / 16, CN = BK / 16;
  constexpr int LD = D + 1, LP = BK + 1, KM = BK / 16, DN = D / 16;
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + BK * LD;
  float* Qs = Vs + BK * LD;
  float* dOs = Qs + BQ * LD;
  float* Ps = dOs + BQ * LD;
  float* dSs = Ps + BQ * LP;
  float* lse_s = dSs + BQ * LP;
  float* dl_s = lse_s + BQ;
  const int b = blockIdx.z, kh = blockIdx.y, G = H / K;
  const int k0 = blockIdx.x * BK;  // the first key tiles see the most rows
  const int tid = threadIdx.x, rg = tid >> 4, cg = tid & 15;
  load_tile<D>(Ks, k, b, k0, BK, S, K, kh);
  load_tile<D>(Vs, v, b, k0, BK, S, K, kh);
  float acc_k[KM][DN], acc_v[KM][DN];
#pragma unroll
  for (int km = 0; km < KM; ++km)
#pragma unroll
    for (int dn = 0; dn < DN; ++dn) acc_k[km][dn] = acc_v[km][dn] = 0.f;
  // query rows that see keys k0 .. k0 + BK - 1
  const int last_row = window > 0 ? min(S - 1, k0 + BK - 2 + window) : S - 1;
  const int qt0 = k0 / BQ, qt1 = last_row / BQ;
  for (int g = 0; g < G; ++g) {
    const int h = kh * G + g;
    for (int qt = qt0; qt <= qt1; ++qt) {
      const int q0 = qt * BQ;
      __syncthreads();  // the previous tile's P, dS, Q, dO are read
      load_tile<D>(Qs, q, b, q0, BQ, S, H, h);
      load_tile<D>(dOs, dout, b, q0, BQ, S, H, h);
      load_rows(lse_s, lse, b, h, H, q0, BQ, S);
      load_rows(dl_s, delta, b, h, H, q0, BQ, S);
      __syncthreads();
      p_ds<D, RM, CN>(Qs, Ks, dOs, Vs, lse_s, dl_s, Ps, dSs, q0, k0, S, scale,
                      softcap, window, rg, cg);
      __syncthreads();
      // dV[key][d] += P[r][key] dO[r][d]; dK[key][d] += dS[r][key] Q[r][d]:
      // summed over the tile's rows first, then into the totals (a key
      // of an early tile sums G S rows; one running sum over all of them
      // lost ~4e-4 of dv's rms in fp32 at causal 2048)
      float tv[KM][DN], tk[KM][DN];
#pragma unroll
      for (int km = 0; km < KM; ++km)
#pragma unroll
        for (int dn = 0; dn < DN; ++dn) tv[km][dn] = tk[km][dn] = 0.f;
#pragma unroll 2
      for (int r = 0; r < BQ; ++r) {
        float pk[KM], sk[KM], od[DN], qd[DN];
#pragma unroll
        for (int km = 0; km < KM; ++km) {
          pk[km] = Ps[r * LP + rg * KM + km];
          sk[km] = dSs[r * LP + rg * KM + km];
        }
#pragma unroll
        for (int dn = 0; dn < DN; ++dn) {
          od[dn] = dOs[r * LD + cg + 16 * dn];
          qd[dn] = Qs[r * LD + cg + 16 * dn];
        }
#pragma unroll
        for (int km = 0; km < KM; ++km)
#pragma unroll
          for (int dn = 0; dn < DN; ++dn) {
            tv[km][dn] = fmaf(pk[km], od[dn], tv[km][dn]);
            tk[km][dn] = fmaf(sk[km], qd[dn], tk[km][dn]);
          }
      }
#pragma unroll
      for (int km = 0; km < KM; ++km)
#pragma unroll
        for (int dn = 0; dn < DN; ++dn) {
          acc_v[km][dn] += tv[km][dn];
          acc_k[km][dn] += tk[km][dn];
        }
    }
  }
#pragma unroll
  for (int km = 0; km < KM; ++km) {
    const int j = k0 + rg * KM + km;
    if (j >= S) continue;
    const size_t off = (((size_t)b * S + j) * K + kh) * D;
#pragma unroll
    for (int dn = 0; dn < DN; ++dn) {
      store_out(dk + off + cg + 16 * dn, acc_k[km][dn] * scale);
      store_out(dv + off + cg + 16 * dn, acc_v[km][dn]);
    }
  }
}

// -- pass 3: dQ of one query tile ------------------------------------------

template <int D>
__global__ void __launch_bounds__(kThreads)
    bwd_dq(const float* __restrict__ q, const float* __restrict__ k,
           const float* __restrict__ v, const float* __restrict__ dout,
           const float* __restrict__ lse, const float* __restrict__ delta,
           float* __restrict__ dq, int S, int H, int K, float scale,
           float softcap, int window) {
  constexpr int BQ = tile_rows<D>(), BK = BQ, RM = BQ / 16, CN = BK / 16;
  constexpr int LD = D + 1, LP = BK + 1, DN = D / 16;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + BQ * LD;
  float* Ks = dOs + BQ * LD;
  float* Vs = Ks + BK * LD;
  float* dSs = Vs + BK * LD;
  float* lse_s = dSs + BQ * LP;
  float* dl_s = lse_s + BQ;
  const int b = blockIdx.z, h = blockIdx.y, kh = h / (H / K);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // longest rows first
  const int tid = threadIdx.x, rg = tid >> 4, cg = tid & 15;
  load_tile<D>(Qs, q, b, q0, BQ, S, H, h);
  load_tile<D>(dOs, dout, b, q0, BQ, S, H, h);
  load_rows(lse_s, lse, b, h, H, q0, BQ, S);
  load_rows(dl_s, delta, b, h, H, q0, BQ, S);
  float acc[RM][DN];
#pragma unroll
  for (int rm = 0; rm < RM; ++rm)
#pragma unroll
    for (int dn = 0; dn < DN; ++dn) acc[rm][dn] = 0.f;
  int kt0, kt1;
  key_tiles<BQ, BK>(q0, S, window, kt0, kt1);
  for (int kt = kt0; kt <= kt1; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's K and dS are read
    load_tile<D>(Ks, k, b, k0, BK, S, K, kh);
    load_tile<D>(Vs, v, b, k0, BK, S, K, kh);
    __syncthreads();
    p_ds<D, RM, CN>(Qs, Ks, dOs, Vs, lse_s, dl_s, nullptr, dSs, q0, k0, S,
                    scale, softcap, window, rg, cg);
    __syncthreads();
    // dQ[row][d] += dS[row][key] K[key][d]
#pragma unroll 2
    for (int c = 0; c < BK; ++c) {
      float sr[RM], kd[DN];
#pragma unroll
      for (int rm = 0; rm < RM; ++rm) sr[rm] = dSs[(rg * RM + rm) * LP + c];
#pragma unroll
      for (int dn = 0; dn < DN; ++dn) kd[dn] = Ks[c * LD + cg + 16 * dn];
#pragma unroll
      for (int rm = 0; rm < RM; ++rm)
#pragma unroll
        for (int dn = 0; dn < DN; ++dn)
          acc[rm][dn] = fmaf(sr[rm], kd[dn], acc[rm][dn]);
    }
  }
#pragma unroll
  for (int rm = 0; rm < RM; ++rm) {
    const int i = q0 + rg * RM + rm;
    if (i >= S) continue;
    const size_t off = (((size_t)b * S + i) * H + h) * D;
#pragma unroll
    for (int dn = 0; dn < DN; ++dn)
      store_out(dq + off + cg + 16 * dn, acc[rm][dn] * scale);
  }
}

template <int D>
int launch(const float* q, const float* k, const float* v, const float* dout,
           float* dq, float* dk, float* dv, float* lse, float* delta, int B, int S, int H,
           int K, float scale, float softcap, int window, void* const* events,
           cudaStream_t st) {
  constexpr int BQ = tile_rows<D>(), BK = BQ, LD = D + 1, LP = BK + 1;
  const int nq = (S + BQ - 1) / BQ, nk = (S + BK - 1) / BK;
  const size_t smem_rows = (size_t)2 * (BQ + BK) * LD * sizeof(float);
  const size_t smem_dkdv =
      ((size_t)2 * (BQ + BK) * LD + 2 * BQ * LP + 2 * BQ) * sizeof(float);
  const size_t smem_dq =
      ((size_t)2 * (BQ + BK) * LD + BQ * LP + 2 * BQ) * sizeof(float);
  cudaError_t err;
  if ((err = cudaFuncSetAttribute(bwd_rows<D>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)smem_rows)) != cudaSuccess)
    return err;
  if ((err = cudaFuncSetAttribute(bwd_dkdv<D>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)smem_dkdv)) != cudaSuccess)
    return err;
  if ((err = cudaFuncSetAttribute(bwd_dq<D>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)smem_dq)) != cudaSuccess)
    return err;
  if ((err = mark(events, 0, st)) != cudaSuccess) return err;
  bwd_rows<D><<<dim3(nq, H, B), kThreads, smem_rows, st>>>(
      q, k, v, dout, lse, delta, S, H, K, scale, softcap, window);
  if ((err = cudaGetLastError()) != cudaSuccess ||
      (err = mark(events, 1, st)) != cudaSuccess)
    return err;
  bwd_dkdv<D><<<dim3(nk, K, B), kThreads, smem_dkdv, st>>>(
      q, k, v, dout, lse, delta, dk, dv, S, H, K, scale, softcap, window);
  if ((err = cudaGetLastError()) != cudaSuccess ||
      (err = mark(events, 2, st)) != cudaSuccess)
    return err;
  bwd_dq<D><<<dim3(nq, H, B), kThreads, smem_dq, st>>>(
      q, k, v, dout, lse, delta, dq, S, H, K, scale, softcap, window);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  return mark(events, 3, st);
}

int dispatch(const float* q, const float* k, const float* v,
             const float* dout, float* dq, float* dk, float* dv, float* lse,
             float* delta, int B, int S, int H, int K, int D, float scale,
             float softcap, int window, void* const* events,
             cudaStream_t st) {
  if (D == 128) return launch<128>(q, k, v, dout, dq, dk, dv, lse, delta, B, S, H, K, scale, softcap, window, events, st);
  if (D == 64) return launch<64>(q, k, v, dout, dq, dk, dv, lse, delta, B, S, H, K, scale, softcap, window, events, st);
  if (D == 96) return launch<96>(q, k, v, dout, dq, dk, dv, lse, delta, B, S, H, K, scale, softcap, window, events, st);
  if (D == 256) return launch<256>(q, k, v, dout, dq, dk, dv, lse, delta, B, S, H, K, scale, softcap, window, events, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// q, dout [B, S, H, D], k, v [B, S, K, D]: contiguous fp32; lse and
// delta: [B, H, S] fp32 scratch the wrapper allocates; dq, dk, dv: fp32
// outputs of q's, k's and v's shapes, every element written; events:
// null, or 4 cudaEvent_t recorded on the stream before bwd_rows, before
// bwd_dkdv, before bwd_dq and after it (`mark`)
extern "C" int ome_flash_prefill_bwd(const float* q, const float* k,
                                     const float* v, const float* dout,
                                     float* dq, float* dk, float* dv,
                                     float* lse, float* delta, int B, int S,
                                     int H, int K, int D, float scale,
                                     float softcap, int window,
                                     void** events, void* stream) {
  if (K <= 0 || H % K != 0) return cudaErrorInvalidValue;
  if (B == 0 || S == 0) return cudaSuccess;
  return dispatch(q, k, v, dout, dq, dk, dv, lse, delta, B, S, H, K, D,
                  scale, softcap, window, events,
                  static_cast<cudaStream_t>(stream));
}

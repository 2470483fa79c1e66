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
// _kernel does with xl/xh: its low nibbles against x[:, j0 : j0+32] with
// scale rows j/G, its high nibbles against x[:, K/2+j0 : K/2+j0+32] with
// scale rows j/G + K/(2G) (K/2 % G == 0, so both halves start a group at
// the same packed row).
//
// Its bound on an H100 is the packed bytes and scales read from device
// memory (29.4 MB + 1.8 MB for the Llama-3-8B gate projection) — a decode
// batch of m rows does 4m flops per packed byte, far below the ~295
// flops/byte at which the tensor cores become the limit — but what limits
// it at decode sizes is the instruction rate of the unpack (a few
// instructions per weight, every weight once). The design:
//   * a block owns 128 columns and a run of whole 32-packed-row steps; the
//     steps' packed bytes, their scale rows and the matching x columns are
//     staged in shared memory with cp.async, four stages deep, so three
//     steps' bytes are in flight while one is multiplied;
//   * each warp owns 32 columns and builds its mma.sync.m16n8k16 B
//     fragments straight from the staged bytes: its four n8 tiles take
//     interleaved columns (tile c, fragment column g = block column
//     warp*32 + 4g + c), so a thread reads one word per packed row for all
//     four tiles and one float4 of scales; each byte gives a low and a
//     high value, turned into exact floats by a PRMT into the mantissa of
//     2^23 and one FADD (no I2F), scaled in fp32, rounded to bf16; every
//     weight is converted once per block;
//   * rows of x beyond m (m < 16, or a ragged last tile) are zero-filled in
//     shared memory, never copied on the host;
//   * the K axis is split across blocks (split-K) so that a small N (the
//     1024 columns of wk/wv: 8 column tiles for 132 SMs) still fills the
//     card; the fp32 partial sums [splits, m, N] are added in split order
//     by a second pass, never by atomics, so the result does not change
//     from run to run.
// It does not yet use wgmma, TMA or a load-time repack of the bytes.
//
// Built with nvcc into a shared library with a plain C interface (see
// ome_tpu_torch/ops/_build.py) and called through ctypes.

#include "common.cuh"

namespace {

constexpr int kBN = 128;         // columns per block
constexpr int kBKP = 32;         // packed rows per pipeline step
constexpr int kStages = 4;       // pipeline depth: kStages - 1 loads ahead
constexpr int kThreads = 128;    // 4 warps x 32 columns
constexpr int kWRow = kBN + 16;  // smem bytes per packed row (bank spread)
constexpr int kXRow = kBKP + 8;  // smem bf16 per x row (bank spread)

// scale rows a step of kBKP packed rows can touch (its start is a
// multiple of kBKP; G is even): one when groups are whole steps (G a
// multiple of kBKP, as the served G = 128 is)
__host__ __device__ __forceinline__ int scale_rows(int G) {
  return G % kBKP == 0 ? 1 : (kBKP - 1) / G + 2;
}

__host__ __device__ __forceinline__ int stage_bytes(int BM, int srows) {
  return kBKP * kWRow + 2 * srows * kBN * 4 + 2 * BM * kXRow * 2;
}

// Byte c of a word of biased nibbles (each byte v + 8 in 0..15, made from
// a raw two's-complement nibble by `raw ^ 8`) -> the exact float v: one
// PRMT places the byte in the low mantissa of 2^23, one FADD removes
// 2^23 + 8 (no quarter-rate I2F).
__device__ __forceinline__ float biased(uint32_t w, int c) {
  return __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7440 | c)) -
         8388616.f;
}

// Grid (N / 128, splits, ceil(m / BM)), 128 threads, dynamic shared
// memory of kStages stages. Block (nb, split, mb) computes rows
// [mb*BM, mb*BM + BM) x columns [nb*128, nb*128 + 128) over the packed
// rows of steps [split*per, split*per + per), and writes fp32 partials
// to part[split] (split_k) or the finished rows to out. kWide: G is a
// multiple of kBKP, so a step lies in one group and needs no division
// by G in the inner loop.
template <int BM, bool kWide>
__global__ void __launch_bounds__(kThreads)
int4_mm(const uint16_t* __restrict__ x, const int8_t* __restrict__ qp,
        const float* __restrict__ sc, void* __restrict__ out,
        float* __restrict__ part, int m, int K, int N, int G, int per,
        int split_k, int out_bf16) {
  constexpr int MT = BM / 16;  // m16 tiles
  extern __shared__ __align__(16) unsigned char smem[];
  const int KP = K / 2;
  const int half_groups = KP / G;  // scale-row offset of the high half
  const int nsteps = (KP + kBKP - 1) / kBKP;
  const int srows = scale_rows(G);
  const int sbytes = stage_bytes(BM, srows);
  const int n0 = blockIdx.x * kBN;
  const int split = blockIdx.y;
  const int m0 = blockIdx.z * BM;
  const int step0 = split * per;
  const int nloc = max(min(step0 + per, nsteps) - step0, 0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;

  auto W_at = [&](int buf) {
    return reinterpret_cast<int8_t*>(smem + buf * sbytes);
  };
  auto S_at = [&](int buf) {
    return reinterpret_cast<float*>(smem + buf * sbytes + kBKP * kWRow);
  };
  auto X_at = [&](int buf) {
    return reinterpret_cast<uint16_t*>(smem + buf * sbytes + kBKP * kWRow +
                                       2 * srows * kBN * 4);
  };

  auto load_step = [&](int step, int buf) {
    const int j0 = step * kBKP;
    // packed rows [j0, j0 + 32) x 128 columns, 16 bytes a copy; rows past
    // K/2 are zero (their nibbles then add nothing)
    int8_t* W = W_at(buf);
    for (int i = threadIdx.x; i < kBKP * (kBN / 16); i += kThreads) {
      const int r = i / (kBN / 16), c = (i % (kBN / 16)) * 16;
      const bool ok = j0 + r < KP;
      cp_async16(W + r * kWRow + c,
                 qp + (size_t)(ok ? j0 + r : 0) * N + n0 + c, ok ? 16 : 0);
    }
    // scale rows: low half j0/G + i, high half K/(2G) + j0/G + i
    float* S = S_at(buf);
    const int glo = j0 / G;
    const int per_half = srows * (kBN / 4);
    for (int i = threadIdx.x; i < 2 * per_half; i += kThreads) {
      const int h = i / per_half, rem = i % per_half;
      const int r = rem / (kBN / 4), c = (rem % (kBN / 4)) * 4;
      const bool ok = glo + r < half_groups;
      const int grp = ok ? glo + r + h * half_groups : 0;
      cp_async16(S + (h * srows + r) * kBN + c,
                 sc + (size_t)grp * N + n0 + c, ok ? 16 : 0);
    }
    // x columns [j0, j0 + 32) (low half) and K/2 + the same (high half)
    // of rows [m0, m0 + BM), 4 bytes a copy; rows past m are zero
    uint16_t* X = X_at(buf);
    const int per_x = BM * (kBKP / 2);
    for (int i = threadIdx.x; i < 2 * per_x; i += kThreads) {
      const int h = i / per_x, rem = i % per_x;
      const int r = rem / (kBKP / 2), c = (rem % (kBKP / 2)) * 2;
      const bool ok = m0 + r < m && j0 + c < KP;
      cp_async4(X + (h * BM + r) * kXRow + c,
                x + (ok ? (size_t)(m0 + r) * K + h * KP + j0 + c : 0),
                ok ? 4 : 0);
    }
    cp_async_commit();
  };

  float acc[MT][4][4];
#pragma unroll
  for (int a = 0; a < MT; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[a][b][c] = 0.f;

  // prologue: the first kStages - 1 steps in flight (an empty group
  // where the split has fewer steps keeps the group count uniform)
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nloc) load_step(step0 + s, s);
    else cp_async_commit();
  }
  for (int it = 0; it < nloc; ++it) {
    const int buf = it % kStages;
    cp_async_wait<kStages - 2>();
    // step `it` visible to every thread, and every thread done with step
    // it - 1, whose buffer the next load refills
    __syncthreads();
    if (it + kStages - 1 < nloc)
      load_step(step0 + it + kStages - 1, (it + kStages - 1) % kStages);
    else
      cp_async_commit();

    const int j0 = (step0 + it) * kBKP;
    const int glo = j0 / G;
    const int8_t* W = W_at(buf);
    const float* S = S_at(buf);
    const uint16_t* X = X_at(buf);
#pragma unroll
    for (int kk = 0; kk < kBKP; kk += 16) {
      // this thread's B rows kk+2t, +1 share a group (G even), as do
      // kk+2t+8, +9
      const int sr0 = kWide ? 0 : (j0 + kk + 2 * t) / G - glo;
      const int sr1 = kWide ? 0 : (j0 + kk + 2 * t + 8) / G - glo;
      uint32_t alo[MT][4], ahi[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const uint16_t* xl = X + (mt * 16 + g) * kXRow + kk + 2 * t;
        const uint16_t* xh = xl + BM * kXRow;
        alo[mt][0] = ld32(xl);
        alo[mt][1] = ld32(xl + 8 * kXRow);
        alo[mt][2] = ld32(xl + 8);
        alo[mt][3] = ld32(xl + 8 * kXRow + 8);
        ahi[mt][0] = ld32(xh);
        ahi[mt][1] = ld32(xh + 8 * kXRow);
        ahi[mt][2] = ld32(xh + 8);
        ahi[mt][3] = ld32(xh + 8 * kXRow + 8);
      }
      // B fragment of n8 tile c: k rows kk+2t, +1 (b0) and kk+2t+8, +9
      // (b1) of column g, which is block column c0 + c: the four tiles'
      // bytes of one row are one word, and their scales one float4
      const int c0 = warp * 32 + g * 4;
      const unsigned char* wp =
          reinterpret_cast<const unsigned char*>(W) + (kk + 2 * t) * kWRow +
          c0;
      uint32_t lo[4], hi[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const uint32_t w = *reinterpret_cast<const uint32_t*>(
            wp + (r & 1) * kWRow + (r >> 1) * 8 * kWRow);
        lo[r] = (w & 0x0F0F0F0Fu) ^ 0x08080808u;
        hi[r] = ((w >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u;
      }
      float sl0[4], sl1[4], sh0[4], sh1[4];
      load_chunk(S + sr0 * kBN + c0, sl0);
      load_chunk(S + sr1 * kBN + c0, sl1);
      load_chunk(S + (srows + sr0) * kBN + c0, sh0);
      load_chunk(S + (srows + sr1) * kBN + c0, sh1);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const uint32_t b0 =
            pack_bf16(biased(lo[0], c) * sl0[c], biased(lo[1], c) * sl0[c]);
        const uint32_t b1 =
            pack_bf16(biased(lo[2], c) * sl1[c], biased(lo[3], c) * sl1[c]);
        const uint32_t h0 =
            pack_bf16(biased(hi[0], c) * sh0[c], biased(hi[1], c) * sh0[c]);
        const uint32_t h1 =
            pack_bf16(biased(hi[2], c) * sh1[c], biased(hi[3], c) * sh1[c]);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma16816(acc[mt][c], alo[mt], b0, b1);
          mma16816(acc[mt][c], ahi[mt], h0, h1);
        }
      }
    }
  }

  // C fragment of tile c: acc[..][c][0..1] at row g, tile columns 2t and
  // 2t+1, i.e. block columns c0' + c and c0' + 4 + c with c0' = warp*32 +
  // 8t; [2..3] at row g + 8. So a lane holds 8 adjacent columns of a row.
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int row = m0 + mt * 16 + g + 8 * hf;
      if (row >= m) continue;
      float v[8];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        v[c] = acc[mt][c][2 * hf];
        v[4 + c] = acc[mt][c][2 * hf + 1];
      }
      const size_t off = (size_t)row * N + n0 + warp * 32 + 8 * t;
      if (out_bf16 && !split_k) {
        *reinterpret_cast<uint4*>(static_cast<uint16_t*>(out) + off) =
            make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]),
                       pack_bf16(v[4], v[5]), pack_bf16(v[6], v[7]));
      } else {
        float* dst = split_k ? part + (size_t)split * m * N + off
                             : static_cast<float*>(out) + off;
        reinterpret_cast<float4*>(dst)[0] =
            make_float4(v[0], v[1], v[2], v[3]);
        reinterpret_cast<float4*>(dst)[1] =
            make_float4(v[4], v[5], v[6], v[7]);
      }
    }
  }
}

// Pass 2 of split-K: out[i] = sum over splits s = 0, 1, ... of part[s][i],
// in that order.
template <typename T>
__global__ void __launch_bounds__(256)
split_k_combine(const float* __restrict__ part, T* __restrict__ out,
                int splits, size_t mn) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= mn) return;
  float a = 0.f;
  for (int s = 0; s < splits; ++s) a += part[(size_t)s * mn + i];
  store_out(out + i, a);
}

template <int BM, bool kWide>
cudaError_t launch(const void* x, const void* qp, const float* sc, void* out,
                   float* part, int m, int K, int N, int G, int splits,
                   int per, int out_bf16, cudaStream_t st) {
  const int smem = kStages * stage_bytes(BM, scale_rows(G));
  static int smem_allowed = 48 * 1024;  // per instantiation
  if (smem > smem_allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        int4_mm<BM, kWide>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return err;
    smem_allowed = smem;
  }
  const dim3 grid(N / kBN, splits, (m + BM - 1) / BM);
  int4_mm<BM, kWide><<<grid, kThreads, smem, st>>>(
      static_cast<const uint16_t*>(x), static_cast<const int8_t*>(qp), sc,
      out, part, m, K, N, G, per, splits > 1, out_bf16);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const size_t mn = (size_t)m * N;
  const unsigned blocks = static_cast<unsigned>((mn + 255) / 256);
  if (out_bf16) {
    split_k_combine<uint16_t><<<blocks, 256, 0, st>>>(
        part, static_cast<uint16_t*>(out), splits, mn);
  } else {
    split_k_combine<float><<<blocks, 256, 0, st>>>(
        part, static_cast<float*>(out), splits, mn);
  }
  return cudaGetLastError();
}

}  // namespace

// x [m, K] bf16; qp [K/2, N] int8 half-packed; sc [K/G, N] fp32; out
// [m, N] bf16 (out_bf16) or fp32; part [splits, m, N] fp32 scratch when
// splits > 1. The K/2 packed rows are walked in steps of 32; split s
// takes steps [s*per, s*per + per). block_m is 16 (m <= 16) or 64.
// Returns the CUDA error code of the launches (0 on success).
extern "C" int ome_int4_matmul(const void* x, const void* qp, const float* sc,
                               void* out, float* part, int m, int K, int N,
                               int G, int splits, int per, int block_m,
                               int out_bf16, void* stream) {
  const int KP = K / 2;
  const int nsteps = (KP + kBKP - 1) / kBKP;
  if (m < 1 || K < 4 || K % 4 || N < kBN || N % kBN || G < 2 || G % 2 ||
      KP % G || splits < 1 || per < 1 || (long)splits * per < nsteps ||
      (long)(splits - 1) * per >= nsteps || (splits > 1 && part == nullptr))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool wide = G % kBKP == 0;
  if (block_m == 16)
    return wide ? launch<16, true>(x, qp, sc, out, part, m, K, N, G, splits,
                                   per, out_bf16, st)
                : launch<16, false>(x, qp, sc, out, part, m, K, N, G, splits,
                                    per, out_bf16, st);
  if (block_m == 64)
    return wide ? launch<64, true>(x, qp, sc, out, part, m, K, N, G, splits,
                                   per, out_bf16, st)
                : launch<64, false>(x, qp, sc, out, part, m, K, N, G, splits,
                                    per, out_bf16, st);
  return cudaErrorInvalidValue;
}

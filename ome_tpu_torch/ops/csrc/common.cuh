// Device helpers shared by the port's hand-written Hopper kernels:
// flash_decode.cu (B1), flash_prefill.cu (B2), flash_paged_decode.cu
// (B3, B5) and int4_matmul.cu (B4). Everything sits in an anonymous
// namespace, so each kernel library keeps its own copy and exports only
// its extern "C" entry point.
//
// ome_tpu_torch/ops/_build.py hashes every header under csrc/ into each
// library's build key, so an edit here rebuilds every kernel.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kMInit = -1.0e30f;  // finite lowest running max

// -- conversions -------------------------------------------------------------

__device__ __forceinline__ float2 bf16x2_to_float2(uint32_t u) {
  // element 0 sits in the low half (little-endian memory order)
  return make_float2(__uint_as_float(u << 16),
                     __uint_as_float(u & 0xffff0000u));
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(uint16_t x) {
  return __uint_as_float(static_cast<uint32_t>(x) << 16);
}

__device__ __forceinline__ uint16_t to_bf16(float x) {
  const __nv_bfloat16 h = __float2bfloat16_rn(x);
  return *reinterpret_cast<const uint16_t*>(&h);
}

// two floats -> one bf16x2 register, round to nearest even; `lo` lands
// in the low half (the lower k or column index of an mma fragment)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 t = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&t);
}

// two adjacent bf16 (4-byte aligned) as one register
__device__ __forceinline__ uint32_t ld32(const uint16_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void store_out(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_out(uint16_t* p, float x) {
  *p = to_bf16(x);
}

// -- one 16-byte chunk of a row -> floats -------------------------------------

__device__ __forceinline__ void load_chunk(const float* p, float (&o)[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  o[0] = t.x; o[1] = t.y; o[2] = t.z; o[3] = t.w;
}

__device__ __forceinline__ void load_chunk(const uint16_t* p, float (&o)[8]) {
  const uint4 t = *reinterpret_cast<const uint4*>(p);
  const float2 a = bf16x2_to_float2(t.x), b = bf16x2_to_float2(t.y);
  const float2 c = bf16x2_to_float2(t.z), d = bf16x2_to_float2(t.w);
  o[0] = a.x; o[1] = a.y; o[2] = b.x; o[3] = b.y;
  o[4] = c.x; o[5] = c.y; o[6] = d.x; o[7] = d.y;
}

// -- one lane's VEC = D/32 consecutive elements of a row -> floats ------------

template <int VEC>
__device__ __forceinline__ void load_row(const float* p, float (&o)[VEC]) {
  if constexpr (VEC == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    o[0] = t.x; o[1] = t.y; o[2] = t.z; o[3] = t.w;
  } else {
    const float2 t = *reinterpret_cast<const float2*>(p);
    o[0] = t.x; o[1] = t.y;
  }
}

template <int VEC>
__device__ __forceinline__ void load_row(const uint16_t* p, float (&o)[VEC]) {
  if constexpr (VEC == 4) {
    const uint2 t = *reinterpret_cast<const uint2*>(p);
    const float2 a = bf16x2_to_float2(t.x), b = bf16x2_to_float2(t.y);
    o[0] = a.x; o[1] = a.y; o[2] = b.x; o[3] = b.y;
  } else {
    const float2 a = bf16x2_to_float2(*reinterpret_cast<const uint32_t*>(p));
    o[0] = a.x; o[1] = a.y;
  }
}

// -- asynchronous copies to shared memory ------------------------------------

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
  // src_bytes 0 zero-fills the 16 destination bytes without reading
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(smem)),
               "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          int src_bytes) {
  // 4-byte copy through L1 (cp.async.cg takes 16 bytes only); src_bytes
  // 0 zero-fills
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(smem)),
               "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// -- warp reductions ----------------------------------------------------------

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// -- tensor cores -------------------------------------------------------------

// D(16x8, f32) += A(16x16, bf16, row) * B(16x8, bf16, col)
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// -- split-KV merge (decode kernels, pass 2) ---------------------------------

// One block per (query head, sequence), one thread per dim: merges the
// n_split partial softmax triples (m, l, acc) of pass 1 in split order.
template <typename T, int D>
__global__ void __launch_bounds__(D)
split_kv_combine(const float* __restrict__ part_m,
                 const float* __restrict__ part_l,
                 const float* __restrict__ part_acc, T* __restrict__ out,
                 int H, int n_split) {
  const int h = blockIdx.x, b = blockIdx.y, d = threadIdx.x;
  const size_t base = ((size_t)b * H + h) * n_split;
  float mx = kMInit;
  for (int s = 0; s < n_split; ++s) mx = fmaxf(mx, part_m[base + s]);
  float lsum = 0.f, a = 0.f;
  for (int s = 0; s < n_split; ++s) {
    const float f = expf(part_m[base + s] - mx);
    lsum += part_l[base + s] * f;
    a += part_acc[(base + s) * D + d] * f;
  }
  store_out(out + ((size_t)b * H + h) * D + d, a / fmaxf(lsum, 1e-30f));
}

}  // namespace

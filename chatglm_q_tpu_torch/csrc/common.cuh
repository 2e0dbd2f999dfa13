// Shared helpers for the kernels in this directory.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// Masked attention score: the JAX package's MASK_VALUE, -0.7 * f32 max.
#define CHATGLM_MASK_VALUE (-0.7f * 3.4028234663852886e38f)

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Round to T and back: the "probabilities are cast to v's dtype before the
// PV product" step of the attention kernels.
template <typename T>
__device__ __forceinline__ float round_to(float v) { return to_f32(from_f32<T>(v)); }

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// ---------------------------------------------------------------------------
// Matmul helpers shared by int4_matmul.cu, int8_matmul.cu and dyn_matmul.cu
// ---------------------------------------------------------------------------

// Split-K CUDA-core kernels (the small-M "gemv" forms): a block is
// GEMV_LANES lanes along N, each owning GEMV_COLS neighbouring columns (one
// 8-byte load per weight row), times GEMV_KW warps along K.  The wrappers'
// gemv_plan (ops/quant_matmul.py) mirrors these numbers.
constexpr int GEMV_COLS = 8;
constexpr int GEMV_LANES = 32;
constexpr int GEMV_KW = 4;
constexpr int GEMV_BN = GEMV_LANES * GEMV_COLS;

// Two neighbouring K elements of one activation row, as floats.
__device__ __forceinline__ float2 load_pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load_pair(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// d += a @ b, bf16 in, f32 accumulate; the m16n8k16 fragment layout.
__device__ __forceinline__ void mma_bf16_16816(float* d, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a @ b, s8 in, s32 accumulate (exact); the m16n8k32 fragment layout:
// a0/a2 hold row gid, a1/a3 row gid+8, four K bytes each at tig*4 (a0, a1)
// and 16 + tig*4 (a2, a3); b0/b1 hold column gid at K bytes tig*4 and
// 16 + tig*4; d0/d1 row gid, d2/d3 row gid+8, columns tig*2 and tig*2+1.
__device__ __forceinline__ void mma_s8_16832(int* d, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Transpose a 4x4 byte block: on entry byte j of r[i] is (row i, column j);
// on exit byte i of r[j] is.  Turns four N-contiguous weight rows into one
// K-ordered word per column, the form __dp4a and the s8 mma B fragment take.
__device__ __forceinline__ void transpose4x4_bytes(uint32_t* r) {
  const uint32_t t0 = __byte_perm(r[0], r[1], 0x5140);  // r0.b0 r1.b0 r0.b1 r1.b1
  const uint32_t t1 = __byte_perm(r[0], r[1], 0x7362);  // r0.b2 r1.b2 r0.b3 r1.b3
  const uint32_t t2 = __byte_perm(r[2], r[3], 0x5140);
  const uint32_t t3 = __byte_perm(r[2], r[3], 0x7362);
  r[0] = __byte_perm(t0, t2, 0x5410);  // r0.b0 r1.b0 r2.b0 r3.b0
  r[1] = __byte_perm(t0, t2, 0x7632);
  r[2] = __byte_perm(t1, t3, 0x5410);
  r[3] = __byte_perm(t1, t3, 0x7632);
}

// The low / high nibbles of four packed tpu-order bytes, each sign-extended
// from two's-complement int4 to s8 ((v ^ 8) - 8 per byte, no carries).
__device__ __forceinline__ uint32_t nibbles_lo_s8(uint32_t w) {
  return __vsub4((w & 0x0F0F0F0Fu) ^ 0x08080808u, 0x08080808u);
}
__device__ __forceinline__ uint32_t nibbles_hi_s8(uint32_t w) {
  return __vsub4(((w >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u, 0x08080808u);
}

// The second pass of every split-K kernel: y[i] = T(float(the nsplit
// partials summed in order) * row_scale[m] * col_scale[n]), in that order;
// a null scale is skipped.  Acc is float (f32 partials) or int (int32
// partials, summed exactly).  Deterministic, no atomics.
namespace {

template <typename Acc, typename T>
__global__ void splitk_reduce_kernel(const Acc* __restrict__ ws, const float* __restrict__ row_scale,
                                     const float* __restrict__ col_scale, T* __restrict__ y,
                                     int nsplit, int N, size_t MN) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= MN) return;
  Acc s = 0;
  for (int p = 0; p < nsplit; ++p) s += ws[(size_t)p * MN + i];
  float v = (float)s;
  if (row_scale) v *= row_scale[i / N];
  if (col_scale) v *= col_scale[i % N];
  y[i] = from_f32<T>(v);
}

template <typename Acc, typename T>
void splitk_reduce(const Acc* ws, const float* row_scale, const float* col_scale, T* y, int nsplit,
                   int M, int N, cudaStream_t stream) {
  const size_t MN = (size_t)M * N;
  splitk_reduce_kernel<Acc, T><<<(unsigned)((MN + 255) / 256), 256, 0, stream>>>(
      ws, row_scale, col_scale, y, nsplit, N, MN);
}

}  // namespace

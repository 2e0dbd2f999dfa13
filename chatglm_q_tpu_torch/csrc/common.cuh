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

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Opt Kernel into `bytes` of dynamic shared memory (past 48 KB) on the current
// device.  The attribute holds per device and per process, so each
// instantiation makes it once for each device it launches on, not on every
// launch.
constexpr int SMEM_OPT_IN_DEVICES = 64;
template <auto Kernel>
inline cudaError_t smem_opt_in(int bytes) {
  static bool done[SMEM_OPT_IN_DEVICES] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess || (dev < SMEM_OPT_IN_DEVICES && done[dev])) return e;
  e = cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess && dev < SMEM_OPT_IN_DEVICES) done[dev] = true;
  return e;
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

// m16n8k16 fragments of the attention kernels.  A (16 x 16, row-major in
// shared memory) and B (16 x 8) come from ldmatrix: x4 loads four 8 x 8
// bf16 matrices, lanes 8i..8i+7 giving the row addresses of matrix i;
// .trans hands each lane the transposed elements (B from a k-major tile).
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

// 16-byte global -> shared copy in flight (cp.async, L2 only); with fill
// false nothing is read and the 16 bytes are zeroed.  src must be a valid
// address either way.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool fill) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(fill ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most N committed groups of this thread are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ---------------------------------------------------------------------------
// Hopper (sm_90a): mbarriers, TMA tile loads, warpgroup MMAs
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
// make the initialised barriers visible to the async proxy (TMA) as well
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
// one arrival that also expects `bytes` of TMA traffic before the phase ends
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
// wait until the phase of parity `parity` has completed (a fresh barrier
// counts its phase before the first, of parity 1, as completed)
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  }
}

// TMA: the box at (c0 innermost, c1) of the tensor map `map` (a
// __grid_constant__ kernel parameter) into shared memory at dst; completion
// is counted in bytes on bar.  Out-of-bounds elements arrive as zeros.
__device__ __forceinline__ void tma_load_2d(void* dst, const void* map, int c0, int c1,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(smem_u32(bar))
      : "memory");
}

// bar.sync on named barrier `id` (1-15; 0 is __syncthreads) for `threads`
__device__ __forceinline__ void named_bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// wgmma's shared-memory matrix descriptor of a K-major tile written by TMA
// with the 128-byte swizzle: rows of 64 bf16, 8-row atoms 1024 bytes apart
// (stride byte offset), tile base 1024-byte aligned.  The k16 step s of a
// row starts 32·s bytes in: add 2·s to the descriptor.
__device__ __forceinline__ uint64_t sw128_desc(const void* tile) {
  return (uint64_t)((smem_u32(tile) & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Pin a register at this point of the program: an asynchronous wgmma reads
// or writes registers the compiler sees as touched only at its issue, so
// after wgmma_wait each operand it used is pinned, lest a read of the
// result move above the wait or another value take an operand's register
// while the tensor cores still read it.
__device__ __forceinline__ void pin(float& r) { asm volatile("" : "+f"(r) : : "memory"); }
__device__ __forceinline__ void pin(uint32_t& r) { asm volatile("" : "+r"(r) : : "memory"); }

// d (64 x N, f32) = a (64 x 16, bf16, registers: the m16n8k16 A fragment of
// each warp's 16 rows) · b (16 x N, bf16, K-major in shared memory, desc)
// + (scale_d ? d : 0); asynchronous: wgmma_commit, then wgmma_wait.  The
// accumulator of warp w: rows 16w + gid (d[4j], d[4j+1]) and 16w + gid + 8
// (d[4j+2], d[4j+3]), columns 8j + 2t and 8j + 2t + 1.
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t desc,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                              uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
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

// Byte p (0..3) of w, two tpu-order int4 nibbles, as the bf16x2 pair of an
// mma fragment (low nibble, the lower K row, in bits 0-15) without an
// int-to-float conversion: one PRMT puts the low nibble of byte p of w at
// bits 0-3 and that of w >> 4 (the byte's high nibble) at bits 16-19; one
// LOP3 keeps them and writes them over the mantissa of bf16 128 with the
// nibble's sign bit flipped, (v & 0x000F000F) ^ 0x43084308, which is the
// bf16 value 136 + q for the two's-complement nibble q; one bf16x2 FMA
// subtracts 136.  Exact for all 16 values.  w_shr4 is w >> 4, shared by the
// word's four bytes.
__device__ __forceinline__ uint32_t int4_pair_bf16x2(uint32_t w, uint32_t w_shr4, int p) {
  const uint32_t sel = p | (p << 4) | ((4 + p) << 8) | ((4 + p) << 12);
  uint32_t v, r;
  // (a & b) ^ c as one LOP3 (LUT 0x6a): written out, ptxas splits it in two
  asm("lop3.b32 %0, %1, %2, %3, 0x6a;\n"
      : "=r"(v)
      : "r"(__byte_perm(w, w_shr4, sel)), "r"(0x000F000Fu), "r"(0x43084308u));
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(r) : "r"(v), "r"(0x3F803F80u), "r"(0xC308C308u));
  return r;
}

// Eight neighbouring elements of a row (16 bytes of bf16, 32 of f32) as
// floats; p is 16-byte aligned.
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* dst) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __bfloat1622float2(h[j]);
    dst[2 * j] = f.x;
    dst[2 * j + 1] = f.y;
  }
}
__device__ __forceinline__ void load8(const float* p, float* dst) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  dst[0] = a.x; dst[1] = a.y; dst[2] = a.z; dst[3] = a.w;
  dst[4] = b.x; dst[5] = b.y; dst[6] = b.z; dst[7] = b.w;
}

__device__ __forceinline__ uint32_t bf16x2_bits(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ---------------------------------------------------------------------------
// The transposed (grad_x) tensor-core kernels of int8_matmul.cu and
// int4_matmul.cu: out (M, K) = A (M, N) · W (K, N)ᵀ, the contraction over N.
// A block holds a 64 x 128 output tile (8 warps: 2 along M, 4 along K); each
// stage puts 64 contraction columns of A and of the block's 128 weight rows
// into shared memory as bf16, both N-contiguous.  The m16n8k16 B fragment is
// two neighbouring contraction elements of one output column: one 32-bit
// word of a weight row, so W needs no transpose.
// ---------------------------------------------------------------------------
constexpr int TMM_BM = 64;               // rows of g / out per block
constexpr int TMM_BK = 128;              // output columns (weight rows) per block
constexpr int TMM_BN = 64;               // contraction columns per stage
constexpr int TMM_STRIDE = TMM_BN + 8;   // bf16 per smem row (pad: no bank conflicts)
constexpr int TMM_THREADS = 256;         // 8 warps; a compile-time stride lets staging loops unroll

// Stage A rows m_base..+63, columns n0..+63 into as.  With fold, each
// element is g * fold[n] in bf16, the scale rounded to bf16 first (the
// plain version's ``g * scale.to(g.dtype)``); without, g as it is.  Needs
// N % 16 == 0 and 16-byte aligned rows.
__device__ __forceinline__ void tmm_stage_a(const __nv_bfloat16* __restrict__ g,
                                            const float* __restrict__ fold,
                                            __nv_bfloat16* as, int m_base, int n0, int M, int N) {
  for (int i = threadIdx.x; i < TMM_BM * (TMM_BN / 8); i += blockDim.x) {
    const int r = i / (TMM_BN / 8), c = (i % (TMM_BN / 8)) * 8;
    const int row = m_base + r, n = n0 + c;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (row < M && n < N) {
      v = *reinterpret_cast<const uint4*>(g + (size_t)row * N + n);
      if (fold) {
        float gv[8], s[8];
        load8(g + (size_t)row * N + n, gv);
        load8(fold + n, s);
        uint32_t o[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          o[j] = bf16x2_bits(gv[2 * j] * round_to<__nv_bfloat16>(s[2 * j]),
                             gv[2 * j + 1] * round_to<__nv_bfloat16>(s[2 * j + 1]));
        v = make_uint4(o[0], o[1], o[2], o[3]);
      }
    }
    *reinterpret_cast<uint4*>(as + r * TMM_STRIDE + c) = v;
  }
}

// acc (this warp's 2 x 4 m16n8 tiles) += as (64 x 64) · bs (128 x 64)ᵀ.
__device__ __forceinline__ void tmm_product(const __nv_bfloat16* as, const __nv_bfloat16* bs,
                                            float (&acc)[2][4][4]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int wm = (warp >> 2) * 32, wn = (warp & 3) * 32;
#pragma unroll
  for (int kk = 0; kk < TMM_BN; kk += 16) {
    uint32_t a[2][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      const __nv_bfloat16* base = as + (wm + mi * 16 + gid) * TMM_STRIDE + kk + tig * 2;
      a[mi][0] = *reinterpret_cast<const uint32_t*>(base);
      a[mi][1] = *reinterpret_cast<const uint32_t*>(base + 8 * TMM_STRIDE);
      a[mi][2] = *reinterpret_cast<const uint32_t*>(base + 8);
      a[mi][3] = *reinterpret_cast<const uint32_t*>(base + 8 * TMM_STRIDE + 8);
    }
    uint32_t b[4][2];
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const __nv_bfloat16* pb = bs + (wn + ni * 8 + gid) * TMM_STRIDE + kk + tig * 2;
      b[ni][0] = *reinterpret_cast<const uint32_t*>(pb);
      b[ni][1] = *reinterpret_cast<const uint32_t*>(pb + 8);
    }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) mma_bf16_16816(acc[mi][ni], a[mi], b[ni]);
  }
}

// Write the block's output tile (bf16); K is even, so a column pair is
// either inside K or past it.
__device__ __forceinline__ void tmm_store(const float (&acc)[2][4][4], __nv_bfloat16* out,
                                          int m_base, int k_base, int M, int K) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int wm = (warp >> 2) * 32, wn = (warp & 3) * 32;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int row = m_base + wm + mi * 16 + gid;
      const int col = k_base + wn + ni * 8 + tig * 2;
      if (col >= K) continue;
      if (row < M)
        *reinterpret_cast<__nv_bfloat162*>(out + (size_t)row * K + col) =
            __floats2bfloat162_rn(acc[mi][ni][0], acc[mi][ni][1]);
      if (row + 8 < M)
        *reinterpret_cast<__nv_bfloat162*>(out + (size_t)(row + 8) * K + col) =
            __floats2bfloat162_rn(acc[mi][ni][2], acc[mi][ni][3]);
    }
}

// The transposed kernels' bodies, one for B13 (int8) and B14 (int4g32).  A
// weight view W (int8_matmul.cu's Int8TView, int4_matmul.cu's Int4TView)
// says how its rows become numbers:
//   W::kCols                  output columns (weight rows) one warp of
//                             t_gemv_kernel owns, inside one scale group
//   W::kFoldG                 the scale folds into g (B13) or into the
//                             weights (B14)
//   w.fold<T>(n, s)           (kFoldG) the 8 scales at n, rounded to T
//   w.cols<T>(k0, n, N, wq)   the weights of columns k0..k0+kCols-1 at
//                             n..n+7, as floats (with the scale rounded to T
//                             under !kFoldG)
//   w.fold_ptr()              the f32 scale tmm_stage_a folds into g, or null
//   w.stage_b(bs, k_base, n0, K, N)  the bf16 TMM_BK x TMM_BN weight tile
namespace {

// CUDA-core form (f32 g, or M <= 16): one warp per kCols output columns.
// Weight row k is N-contiguous, so the lanes read 8 neighbouring elements of
// each of the warp's rows (8-byte loads along N), every g load serves all
// kCols columns, and the sums over N run in registers and then across lanes
// in a fixed order.  Bound by the weight bytes.
template <typename W, typename T, int MT>
__global__ void __launch_bounds__(256)
t_gemv_kernel(const T* __restrict__ g, const W w, T* __restrict__ out, int M, int K, int N) {
  constexpr int R = W::kCols;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int k0 = (blockIdx.x * 8 + warp) * R;  // K % 32 == 0: all R columns exist
  const int m0 = blockIdx.y * MT;
  if (k0 >= K) return;
  const T* gr[MT];
#pragma unroll
  for (int m = 0; m < MT; ++m) gr[m] = g + (size_t)min(m0 + m, M - 1) * N;
  float acc[R][MT];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int m = 0; m < MT; ++m) acc[r][m] = 0.f;
  for (int n = lane * 8; n < N; n += 256) {
    float wq[R][8], s[8];
    w.template cols<T>(k0, n, N, wq);
    if constexpr (W::kFoldG) w.template fold<T>(n, s);
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      float gv[8];
      load8(gr[m] + n, gv);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float gs = gv[j];
        if constexpr (W::kFoldG) gs = round_to<T>(gv[j] * s[j]);  // g * scale in g's dtype
#pragma unroll
        for (int r = 0; r < R; ++r) acc[r][m] = fmaf(gs, wq[r][j], acc[r][m]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      const float v = warp_sum(acc[r][m]);
      if (lane == 0 && m0 + m < M) out[(size_t)(m0 + m) * K + k0 + r] = from_f32<T>(v);
    }
}

template <typename W, typename T, int MT>
void launch_t_gemv(const T* g, const W& w, T* out, int M, int K, int N, cudaStream_t stream) {
  const dim3 grid((K / W::kCols + 7) / 8, (M + MT - 1) / MT);
  t_gemv_kernel<W, T, MT><<<grid, 256, 0, stream>>>(g, w, out, M, K, N);
}

template <typename W, typename T>
void t_gemv(const T* g, const W& w, T* out, int M, int K, int N, cudaStream_t stream) {
  if (M == 1)
    launch_t_gemv<W, T, 1>(g, w, out, M, K, N, stream);
  else if (M == 2)
    launch_t_gemv<W, T, 2>(g, w, out, M, K, N, stream);
  else if (M <= 4)
    launch_t_gemv<W, T, 4>(g, w, out, M, K, N, stream);
  else
    launch_t_gemv<W, T, 8>(g, w, out, M, K, N, stream);
}

// Tensor-core form (bf16 g, M > 16): the TMM tiles above.  The scale (B13)
// folds into the g tile as it is staged; the weight view stages its rows as
// bf16 (B13: exact int8 converts; B14: bf16(q * s)).
template <typename W>
__global__ void __launch_bounds__(TMM_THREADS)
t_mma_kernel(const __nv_bfloat16* __restrict__ g, const W w, __nv_bfloat16* __restrict__ out,
             int M, int K, int N) {
  __shared__ __align__(16) __nv_bfloat16 as[TMM_BM * TMM_STRIDE];
  __shared__ __align__(16) __nv_bfloat16 bs[TMM_BK * TMM_STRIDE];
  const int m_base = blockIdx.y * TMM_BM, k_base = blockIdx.x * TMM_BK;
  float acc[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

  for (int n0 = 0; n0 < N; n0 += TMM_BN) {
    tmm_stage_a(g, w.fold_ptr(), as, m_base, n0, M, N);
    w.stage_b(bs, k_base, n0, K, N);
    __syncthreads();
    tmm_product(as, bs, acc);
    __syncthreads();
  }
  tmm_store(acc, out, m_base, k_base, M, K);
}

template <typename W>
void t_mma(const __nv_bfloat16* g, const W& w, __nv_bfloat16* out, int M, int K, int N,
           cudaStream_t stream) {
  const dim3 grid((K + TMM_BK - 1) / TMM_BK, (M + TMM_BM - 1) / TMM_BM);
  t_mma_kernel<W><<<grid, TMM_THREADS, 0, stream>>>(g, w, out, M, K, N);
}

}  // namespace

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

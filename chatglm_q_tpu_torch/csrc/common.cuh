// Shared helpers for the kernels in this directory.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <cudaTypedefs.h>  // CUtensorMap, PFN_cuTensorMapEncodeTiled
#include <math.h>
#include <stdint.h>

#include <type_traits>

// Masked attention score: the JAX package's MASK_VALUE, -0.7 * f32 max.
#define CHATGLM_MASK_VALUE (-0.7f * 3.4028234663852886e38f)

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <>
__device__ __forceinline__ __half from_f32<__half>(float v) {
  return __float2half_rn(v);
}

// The 16-bit activation types the tensor-core kernels take: E is
// __nv_bfloat16 or __half (the main path's bf16, or a float16 checkpoint's
// activations).  Both go through the tensor cores at one rate.
template <typename E>
constexpr bool kIsF16 = std::is_same_v<E, __half>;

// The activation dtype codes of the matmul C entry points (ops/_build.py:
// dtype_code): fn(T{}) with T the activations' element type, or
// cudaErrorInvalidValue for another code.
constexpr int DT_F32 = 0, DT_BF16 = 1, DT_F16 = 2;
template <class Fn>
int with_act_type(int code, Fn&& fn) {
  if (code == DT_F32) return fn(float{});
  if (code == DT_BF16) return fn(__nv_bfloat16{});
  if (code == DT_F16) return fn(__half{});
  return (int)cudaErrorInvalidValue;
}

// Two floats as the E x2 pair of a register (lo in bits 0-15), each
// rounded to nearest even; and back.
template <typename E>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  if constexpr (kIsF16<E>) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  } else {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
}
template <typename E>
__device__ __forceinline__ float2 unpack2(uint32_t v) {
  if constexpr (kIsF16<E>)
    return __half22float2(*reinterpret_cast<const __half2*>(&v));
  else
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
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
__device__ __forceinline__ float2 load_pair(const __half* p) {
  return __half22float2(*reinterpret_cast<const __half2*>(p));
}

// d += a @ b, E (bf16 or f16) in, f32 accumulate; the m16n8k16 fragment
// layout.
#define CHATGLM_MMA_16816(TY)                                                          \
  asm volatile("mma.sync.aligned.m16n8k16.row.col.f32." TY "." TY ".f32 "            \
               "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"              \
               : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])                         \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]))
template <typename E>
__device__ __forceinline__ void mma_16816(float* d, const uint32_t* a, const uint32_t* b) {
  if constexpr (kIsF16<E>)
    CHATGLM_MMA_16816("f16");
  else
    CHATGLM_MMA_16816("bf16");
}
#undef CHATGLM_MMA_16816

// d += a @ b, s8 in, s32 accumulate (exact); the m16n8k32 fragment layout:
// a0 / a1 rows gid / gid + 8 at K 4t..4t+3, a2 / a3 the same at K 16 + 4t..,
// b0 K 4t..4t+3 and b1 K 16 + 4t.. of column gid, four bytes a register
// (the lower K in the lower byte); d as m16n8k16's.
__device__ __forceinline__ void mma_s8_16832(int* d, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
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
// two matrices, their row addresses from lanes 0-15
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
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

// d (64 x N, f32) = a (64 x 16, E = bf16 or f16, registers: the m16n8k16
// A fragment of each warp's 16 rows) · b (16 x N, E, K-major in shared
// memory, desc) + (scale_d ? d : 0); asynchronous: wgmma_commit, then
// wgmma_wait.  The accumulator of warp w: rows 16w + gid (d[4j], d[4j+1])
// and 16w + gid + 8 (d[4j+2], d[4j+3]), columns 8j + 2t and 8j + 2t + 1.
#define CHATGLM_WGMMA_RS_N64(TY)                                                           \
  asm volatile(                                                                            \
      "{\n.reg .pred p;\n"                                                                 \
      "setp.ne.b32 p, %37, 0;\n"                                                           \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " "                          \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "           \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, " \
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"                                        \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), \
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),          \
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),       \
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),       \
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),       \
        "+f"(d[31])                                                                        \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d))
template <typename E = __nv_bfloat16>
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t desc,
                                             int scale_d) {
  if constexpr (kIsF16<E>)
    CHATGLM_WGMMA_RS_N64("f16");
  else
    CHATGLM_WGMMA_RS_N64("bf16");
}
#undef CHATGLM_WGMMA_RS_N64
#define CHATGLM_WGMMA_RS_N128(TY)                                                          \
  asm volatile(                                                                            \
      "{\n.reg .pred p;\n"                                                                 \
      "setp.ne.b32 p, %69, 0;\n"                                                           \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " "                         \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "           \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "  \
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "   \
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, " \
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"                                        \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), \
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),          \
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),       \
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),       \
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),       \
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),       \
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),       \
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),       \
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),       \
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),       \
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])                                              \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d))
template <typename E = __nv_bfloat16>
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                              uint64_t desc, int scale_d) {
  if constexpr (kIsF16<E>)
    CHATGLM_WGMMA_RS_N128("f16");
  else
    CHATGLM_WGMMA_RS_N128("bf16");
}
#undef CHATGLM_WGMMA_RS_N128

// d (64 x N, s32, exact) = a (64 x 32, s8, registers) · b (32 x N, s8,
// K-major in shared memory, desc) + (scale_d ? d : 0); asynchronous, as the
// bf16 forms.  The A fragment of warp w: four K bytes in a register, a0
// row 16w + gid at K 4t..4t+3, a1 row 16w + gid + 8 there, a2 / a3 the same
// at K 16 + 4t (the m16n8k32 layout); d as wgmma_rs_n64's.  A k32 step
// spans 32 bytes of a 128B-swizzled row, as a bf16 k16 step does: add 2
// to the descriptor per step.
__device__ __forceinline__ void wgmma_s8_n64(int (&d)[32], const uint32_t (&a)[4], uint64_t desc,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
        "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]),
        "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}
__device__ __forceinline__ void wgmma_s8_n128(int (&d)[64], const uint32_t (&a)[4], uint64_t desc,
                                              int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
        "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]),
        "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]),
        "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]),
        "+r"(d[62]), "+r"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}
__device__ __forceinline__ void pin(int& r) { asm volatile("" : "+r"(r) : : "memory"); }

// Transpose a 4x4 byte block: on entry byte j of r[i] is (row i, column j);
// on exit byte i of r[j] is.  Turns four N-contiguous weight rows into one
// K-ordered word per column, the form the s8 mma A fragment takes.
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

// Bits 0-3 and 16-19 of v, two tpu-order (two's-complement) int4 nibbles,
// as a bf16x2 pair without an int-to-float conversion: one LOP3 keeps them
// and writes them over the mantissa of bf16 128 with the nibble's sign bit
// flipped, (v & 0x000F000F) ^ 0x43084308, which is the bf16 value 136 + q
// for the nibble q; one bf16x2 FMA subtracts 136.  Exact for all 16 values.
// The f16 form (nibble_pair<__half>) writes them over f16 1024, whose ulp
// is 1: (v & 0x000F000F) ^ 0x64086408 is 1032 + q, and one f16x2 FMA
// subtracts 1032.
template <typename E = __nv_bfloat16>
__device__ __forceinline__ uint32_t nibble_pair(uint32_t v) {
  constexpr uint32_t kBias = kIsF16<E> ? 0x64086408u : 0x43084308u;  // 1032 / 136 + the nibble
  uint32_t m, r;
  // (a & b) ^ c as one LOP3 (LUT 0x6a): written out, ptxas splits it in two
  asm("lop3.b32 %0, %1, %2, %3, 0x6a;\n" : "=r"(m) : "r"(v), "r"(0x000F000Fu), "r"(kBias));
  if constexpr (kIsF16<E>)
    asm("fma.rn.f16x2 %0, %1, %2, %3;\n" : "=r"(r) : "r"(m), "r"(0x3C003C00u), "r"(0xE408E408u));
  else
    asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(r) : "r"(m), "r"(0x3F803F80u), "r"(0xC308C308u));
  return r;
}

// Byte p (0..3) of w, two tpu-order int4 nibbles, as the E x2 pair of an
// mma fragment (low nibble, the lower K row, in bits 0-15): one PRMT puts
// the low nibble of byte p of w at bits 0-3 and that of w >> 4 (the byte's
// high nibble) at bits 16-19.  w_shr4 is w >> 4, shared by the word's four
// bytes.
template <typename E = __nv_bfloat16>
__device__ __forceinline__ uint32_t int4_pair(uint32_t w, uint32_t w_shr4, int p) {
  const uint32_t sel = p | (p << 4) | ((4 + p) << 8) | ((4 + p) << 12);
  return nibble_pair<E>(__byte_perm(w, w_shr4, sel));
}

// Two packed bytes b0 (bits 0-7 of v) and b1 (bits 8-15), neighbours along
// a byte row, as two E x2 pairs (bf16 or f16, exact): lo = (low nibble of
// b0, of b1), hi = (high nibble of b0, of b1).  The transposed kernel's A
// fragment: a byte row holds two output rows (its low and high nibbles),
// its neighbouring bytes two neighbouring contraction elements.
template <typename E = __nv_bfloat16>
__device__ __forceinline__ void int4_rows_pair(uint32_t v, uint32_t& lo, uint32_t& hi) {
  const uint32_t v4 = v >> 4;
  lo = nibble_pair<E>(__byte_perm(v, v4, 0x4140));  // b0 -> bits 0-7, b1 -> bits 16-23
  hi = nibble_pair<E>(__byte_perm(v, v4, 0x0504));  // b0 >> 4, b1 >> 4 likewise
}

// Four int8 bytes of w as two exact bf16x2 pairs (lo: bytes 0, 1; hi:
// bytes 2, 3; the lower byte in bits 0-15).  bf16 holds 8 significant bits,
// too few for a magic-bias trick of its own, so each byte goes through f32:
// PRMT writes the biased byte b + 128 under the exponent of 2^23, an FADD
// subtracts 2^23 + 128, and since the result has at most 8 significant
// bits, its high half is its bf16 value (one PRMT packs two).
__device__ __forceinline__ void s8x4_bf16x2(uint32_t w, uint32_t& lo, uint32_t& hi) {
  const uint32_t x = w ^ 0x80808080u;
  uint32_t f[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    f[i] = __float_as_uint(__uint_as_float(__byte_perm(x, 0x4B000000u, 0x7540 + i)) -
                           8388736.f);
  lo = __byte_perm(f[0], f[1], 0x7632);
  hi = __byte_perm(f[2], f[3], 0x7632);
}

// The same as two exact f16x2 pairs: f16's 11 significant bits take the
// bias trick directly.  One PRMT per pair writes the biased bytes b + 128
// under the high byte 0x64 of f16 1024 (ulp 1), which is 1024 + 128 + b,
// and one f16x2 FMA subtracts 1152.
__device__ __forceinline__ void s8x4_f16x2(uint32_t w, uint32_t& lo, uint32_t& hi) {
  const uint32_t x = w ^ 0x80808080u;
  const uint32_t l = __byte_perm(x, 0x64646464u, 0x4140), h = __byte_perm(x, 0x64646464u, 0x4342);
  asm("fma.rn.f16x2 %0, %1, %2, %3;\n" : "=r"(lo) : "r"(l), "r"(0x3C003C00u), "r"(0xE480E480u));
  asm("fma.rn.f16x2 %0, %1, %2, %3;\n" : "=r"(hi) : "r"(h), "r"(0x3C003C00u), "r"(0xE480E480u));
}
template <typename E>
__device__ __forceinline__ void s8x4_pair(uint32_t w, uint32_t& lo, uint32_t& hi) {
  if constexpr (kIsF16<E>)
    s8x4_f16x2(w, lo, hi);
  else
    s8x4_bf16x2(w, lo, hi);
}

// a * b for two E x2 pairs (bf16 or f16), each product rounded once to E
// (f16: subnormal products kept, no flush)
template <typename E = __nv_bfloat16>
__device__ __forceinline__ uint32_t mul2(uint32_t a, uint32_t b) {
  uint32_t r;
  if constexpr (kIsF16<E>)
    asm("mul.rn.f16x2 %0, %1, %2;\n" : "=r"(r) : "r"(a), "r"(b));
  else
    asm("mul.rn.bf16x2 %0, %1, %2;\n" : "=r"(r) : "r"(a), "r"(b));
  return r;
}

// A bf16x2 pair (an int4g32 scale pair as stored) as an E x2 pair: itself
// for bf16; for f16 each value rounded once to f16 (the JAX kernels'
// s.astype(g.dtype): exact in f16's normal range, else a subnormal, 0 or
// inf).
template <typename E = __nv_bfloat16>
__device__ __forceinline__ uint32_t bf16x2_as(uint32_t s) {
  if constexpr (kIsF16<E>)
    return pack2<E>(__uint_as_float(s << 16), __uint_as_float(s & 0xFFFF0000u));
  else
    return s;
}

// The three bf16 pieces of an f32 x, hi = bf16(x), mid = bf16(x - hi), lo =
// bf16(x - hi - mid), each residual exact in f32: three 8-bit pieces hold
// f32's 24 significant bits and bf16 has f32's exponent range, so hi + mid
// + lo == x for |x| >= 2^-110 (below it lo falls among bf16's subnormals:
// |x - (hi + mid + lo)| <= 2^-134).  Each piece times a small integer weight
// is exact in an f32 accumulator, so three bf16 products a term give the
// f32 product (the f32 forms of B1 and B6).  Above bf16's largest finite
// value, where bf16(x) is inf, hi is x truncated toward zero; a non-finite
// x gives hi = x and mid = lo = 0, so inf · q and NaN propagate as the f32
// product does.  ops/quant.py::split_bf16x3 is the plain version.
__device__ __forceinline__ void split_bf16x3(float x, __nv_bfloat16& hi, __nv_bfloat16& mid,
                                             __nv_bfloat16& lo) {
  hi = __float2bfloat16_rn(x);
  if (!isfinite(x)) {
    mid = lo = __float2bfloat16_rn(0.f);
    return;
  }
  if (isinf(__bfloat162float(hi))) hi = __float2bfloat16_rz(x);
  const float r = x - __bfloat162float(hi);
  mid = __float2bfloat16_rn(r);
  lo = __float2bfloat16_rn(r - __bfloat162float(mid));
}

// Eight neighbouring f32 (a, b) as their pieces, eight bf16 a piece:
// pc[0] hi, pc[1] mid, pc[2] lo.
__device__ __forceinline__ void split8_bf16x3(const float4& a, const float4& b, uint4 (&pc)[3]) {
  const float v[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
  uint32_t w[3][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    __nv_bfloat16 h0, m0, l0, h1, m1, l1;
    split_bf16x3(v[2 * i], h0, m0, l0);
    split_bf16x3(v[2 * i + 1], h1, m1, l1);
    const __nv_bfloat162 ph(h0, h1), pm(m0, m1), pl(l0, l1);
    w[0][i] = *reinterpret_cast<const uint32_t*>(&ph);
    w[1][i] = *reinterpret_cast<const uint32_t*>(&pm);
    w[2][i] = *reinterpret_cast<const uint32_t*>(&pl);
  }
#pragma unroll
  for (int p = 0; p < 3; ++p) pc[p] = make_uint4(w[p][0], w[p][1], w[p][2], w[p][3]);
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

// ---------------------------------------------------------------------------
// Split-K tensor-core kernels (decode and the verify step): B1 at bf16 M <=
// 64 (int4_matmul.cu), B6 at bf16 M <= 16 (int8_matmul.cu), B1 and B6 on
// f32 x at M <= their f32 limits (the f32 views below), B7 and B8 at M <=
// 16 on s8 activations (dyn_matmul.cu).  Bound by the weight bytes.
//
// One body, sk_body, over a weight view V:
//   V::X, V::Acc        x's element (bf16 or f16, s8 for B7/B8, or f32,
//                       staged as its three bf16 pieces) and the
//                       accumulator (f32, or B7's exact int32)
//   V::Group<COLS>      one 32-row K group's weights (and scales) of a
//                       lane's COLS columns, in registers
//   V::Lane, v.lane(n)  the lane's column pointers at column n
//   v.load(d, ln, g, t, N, ok)   group g's loads for lane quad t (zeros
//                       where !ok: columns past N)
//   v.group<MT>(d, xs, xs_stride, kl, M, acc)   the group's products with
//                       x's staged rows (K offset kl in the chunk) into acc
//   v.out<T>(sum, m, n) y[m, n] from the merged sum (the epilogue: scales)
// The mma's A is the weights (16 columns x one K step: tile j of a lane
// group holds its columns 2j and 2j + 1 as rows gid and gid + 8), B is x (8
// rows an m-tile, zero past M), so M pads to 8 per m-tile and each weight
// converts once whatever M is.  Lane quad t takes K rows 8t..8t+7 of each
// group (any K order serves while A and B agree), which makes its x
// fragment one contiguous 16-byte (bf16) or 8-byte (s8) read.
// The accumulator (mt, j, e) is x row mt*8 + 2t + (e & 1), column gid*COLS +
// 2j + (e >> 1).  Each kernel takes its pointers as __restrict__ parameters
// and builds its view inside: through a struct parameter they lose
// __restrict__, and ptxas scheduled B1's two-tile form 2-5% slower (H100).
// ---------------------------------------------------------------------------

constexpr int SK_KW = 4;                 // warps per block, all along K
constexpr int SK_THREADS = 32 * SK_KW;
constexpr int SK_SMEM_MAX = 72 * 1024;   // opted in once per instantiation

// The block's shared memory: x's M rows over a chunk of cg groups (rows
// padded by 32 elements, so that the lanes' fragment reads hit distinct
// banks); after the loop, the same bytes hold each warp's (M, 8 * cols + 1)
// 4-byte sum.  xbytes: 2 (bf16, f16, and the f32 views' staged pieces), 1
// (s8).
// ops/quant_matmul.py::splitk_smem mirrors it.
__host__ __device__ constexpr int sk_xs_stride(int cg) { return cg * 32 + 32; }
__host__ __device__ constexpr int sk_smem_bytes(int M, int cg, int cols, int xbytes) {
  return M * sk_xs_stride(cg) * xbytes > SK_KW * M * (8 * cols + 1) * 4
             ? M * sk_xs_stride(cg) * xbytes
             : SK_KW * M * (8 * cols + 1) * 4;
}

// One int4g32 group (B1, B8) for this lane, by ld.global.nc (which streams
// this pattern ~1.7x faster than cp.async on an H100): byte rows 4t..4t+3
// (K rows 8t..8t+7; byte row i holds K rows 2i, 2i + 1 in its low / high
// nibble) at its COLS columns, and the group's COLS scales (s[j]: columns
// 2j, 2j+1 as bf16x2).  Zeros past N.
template <int COLS>
struct SkGroup {
  uint32_t w[4][COLS / 4];
  uint32_t s[COLS / 2];
};

template <int COLS>
__device__ __forceinline__ void sk_load(SkGroup<COLS>& d, const uint8_t* __restrict__ pcol,
                                        const __nv_bfloat16* __restrict__ scol, int g, int t,
                                        int N, bool ok) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const uint8_t* p = pcol + (size_t)(g * 16 + 4 * t + r) * N;
    if constexpr (COLS == 16) {
      const uint4 v = ok ? __ldg(reinterpret_cast<const uint4*>(p)) : make_uint4(0u, 0u, 0u, 0u);
      d.w[r][0] = v.x; d.w[r][1] = v.y; d.w[r][2] = v.z; d.w[r][3] = v.w;
    } else {
      const uint2 v = ok ? __ldg(reinterpret_cast<const uint2*>(p)) : make_uint2(0u, 0u);
      d.w[r][0] = v.x; d.w[r][1] = v.y;
    }
  }
  const uint4* sp = reinterpret_cast<const uint4*>(scol + (size_t)g * N);
#pragma unroll
  for (int q = 0; q < COLS / 8; ++q) {
    const uint4 v = ok ? __ldg(sp + q) : make_uint4(0u, 0u, 0u, 0u);
    d.s[4 * q] = v.x; d.s[4 * q + 1] = v.y; d.s[4 * q + 2] = v.z; d.s[4 * q + 3] = v.w;
  }
}

// One int8 group (B6, B7) for this lane: K rows 8t..8t+7 at its COLS
// columns (w[r][q]: row 8t + r, columns 4q..4q+3), 16-byte loads where COLS
// is 16.  Zeros past N.
template <int COLS>
struct Int8SkGroup {
  uint32_t w[8][COLS / 4];
};

template <int COLS>
__device__ __forceinline__ void int8_sk_load(Int8SkGroup<COLS>& d,
                                             const int8_t* __restrict__ wcol, int g, int t,
                                             int N, bool ok) {
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int8_t* p = wcol + (size_t)(g * 32 + 8 * t + r) * N;
    if constexpr (COLS == 16) {
      const uint4 v = ok ? __ldg(reinterpret_cast<const uint4*>(p)) : make_uint4(0u, 0u, 0u, 0u);
      d.w[r][0] = v.x; d.w[r][1] = v.y; d.w[r][2] = v.z; d.w[r][3] = v.w;
    } else {
      const uint2 v = ok ? __ldg(reinterpret_cast<const uint2*>(p)) : make_uint2(0u, 0u);
      d.w[r][0] = v.x; d.w[r][1] = v.y;
    }
  }
}

// The f32 views (int4_matmul.cu's Int4SkF32View, int8_matmul.cu's
// Int8SkF32View: V::X float) stage x's three bf16 pieces (split_bf16x3)
// instead of x: x row m as staged rows 3m (hi), 3m + 1 (mid) and 3m + 2
// (lo), 3M rows through the bf16 view's group (free while 3M fits the two
// m-tiles of the f32 split-K limit), each staged row summed over K on its
// own and the three summed lo, mid, hi in the epilogue.
template <typename V>
constexpr bool kSkF32 = std::is_same_v<typename V::X, float>;
template <typename V>
using SkStaged = std::conditional_t<kSkF32<V>, __nv_bfloat16, typename V::X>;

// Grid (N / (8 COLS) column tiles, nsplit K splits of gps groups); a
// block's 4 warps take its groups in turn (warp w: groups g0 + w, g0 + w +
// 4, ...), through two register sets, so that two groups' loads are in
// flight while one is computed (the sets alternate: a copy from one to the
// other would wait for the loads).  x's rows are staged cg groups at a time
// (cg a multiple of 8, so a chunk gives each warp an even number of groups;
// one chunk unless M is large).  The warps' sums meet in shared memory in
// warp order; one split writes y, more write partials, and the last block
// of a tile to arrive (__threadfence, then atomicAdd on its counter) sums
// them in split order, writes y and resets the counter: deterministic, and
// nothing to reset between launches, so a CUDA graph can replay it.
template <typename V, typename T, int MT, int COLS>
__device__ __forceinline__ void sk_body(const V& v, const typename V::X* __restrict__ x,
                                        T* __restrict__ y, typename V::Acc* __restrict__ ws,
                                        int* __restrict__ arrivals, int M, int K, int N, int gps,
                                        int cg, unsigned char* smem) {
  using X = typename V::X;
  using XS = SkStaged<V>;
  using Acc = typename V::Acc;
  constexpr int BN = 8 * COLS, RS = BN + 1;
  constexpr int EPC = 16 / (int)sizeof(X);  // x elements a 16-byte chunk
  constexpr int P = kSkF32<V> ? 3 : 1;      // staged rows an x row
  __shared__ bool merge_here;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, t = lane & 3;
  const int tile = blockIdx.x, split = blockIdx.y, nsplit = gridDim.y;
  const int n0 = tile * BN;
  const int g0 = split * gps, g1 = min(K / 32, g0 + gps);
  const int xs_stride = sk_xs_stride(cg);
  const int MS = P * M;  // staged rows
  XS* xs = reinterpret_cast<XS*>(smem);
  Acc* red = reinterpret_cast<Acc*>(smem);  // after the loop: 4 warps' (MS, BN + 1)

  const int n = n0 + gid * COLS;  // N % COLS == 0: all COLS columns or none
  const bool ok = n < N;
  const typename V::Lane ln = v.lane(ok ? n : 0);
  Acc acc[MT][COLS / 2][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < COLS / 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0;

  typename V::template Group<COLS> ga, gb;  // groups g and g + 4: both in flight from the start
  int g = g0 + warp;
  if (g < g1) v.load(ga, ln, g, t, N, ok);
  if (g + SK_KW < g1) v.load(gb, ln, g + SK_KW, t, N, ok);
  for (int c0 = g0; c0 < g1; c0 += cg) {
    const int c1 = min(g1, c0 + cg);
    if constexpr (kSkF32<V>) {  // 8 elements (32 bytes) a step, as their three pieces
      const int kw8 = (c1 - c0) * 4;
      for (int i = tid; i < M * kw8; i += SK_THREADS) {
        const int r = i / kw8, c = (i % kw8) * 8;
        const float4* src = reinterpret_cast<const float4*>(x + (size_t)r * K + c0 * 32 + c);
        uint4 pc[3];
        split8_bf16x3(src[0], src[1], pc);
#pragma unroll
        for (int p = 0; p < 3; ++p)  // staged row 3r + p
          *reinterpret_cast<uint4*>(xs + (3 * r + p) * xs_stride + c) = pc[p];
      }
    } else {
      const int kwc = (c1 - c0) * 32 / EPC;  // 16-byte chunks of a staged x row
      for (int i = tid; i < M * kwc; i += SK_THREADS) {
        const int r = i / kwc, c = (i % kwc) * EPC;
        *reinterpret_cast<uint4*>(xs + r * xs_stride + c) =
            *reinterpret_cast<const uint4*>(x + (size_t)r * K + c0 * 32 + c);
      }
    }
    __syncthreads();
    for (; g < c1; g += 2 * SK_KW) {  // ga holds group g, gb group g + 4
      v.template group<MT>(ga, xs, xs_stride, (g - c0) * 32, MS, acc);
      if (g + 2 * SK_KW < g1) v.load(ga, ln, g + 2 * SK_KW, t, N, ok);
      if (g + SK_KW >= c1) break;  // the last chunk's odd group
      v.template group<MT>(gb, xs, xs_stride, (g + SK_KW - c0) * 32, MS, acc);
      if (g + 3 * SK_KW < g1) v.load(gb, ln, g + 3 * SK_KW, t, N, ok);
    }
    __syncthreads();
  }

  // each warp's sum into a slab of its own (x's rows are dead: every warp
  // is past the chunk loop's last barrier), then the four in warp order
  Acc* slab = red + warp * MS * RS;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < COLS / 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = mt * 8 + 2 * t + (e & 1);
        if (m < MS) slab[m * RS + gid * COLS + 2 * j + (e >> 1)] = acc[mt][j][e];
      }
  __syncthreads();
  auto block_sum = [&](int i) {  // element i of the block's (MS, BN) tile
    const int o = (i / BN) * RS + i % BN;
    return ((red[o] + red[MS * RS + o]) + red[2 * MS * RS + o]) + red[3 * MS * RS + o];
  };
  // output element (m, c) from the sums s(i) of staged element i: one row,
  // or x row m's three piece rows, lo + mid, then + hi
  auto combine = [&](const auto& s, int m, int c) {
    if constexpr (P == 3)
      return (s((3 * m + 2) * BN + c) + s((3 * m + 1) * BN + c)) + s(3 * m * BN + c);
    else
      return s(m * BN + c);
  };

  if (nsplit == 1) {
    for (int i = tid; i < M * BN; i += SK_THREADS) {
      const int m = i / BN, c = i % BN;
      if (n0 + c < N)
        y[(size_t)m * N + n0 + c] = v.template out<T>(combine(block_sum, m, c), m, n0 + c);
    }
    return;
  }
  Acc* part = ws + ((size_t)tile * nsplit + split) * MS * BN;
  for (int i = tid; i < MS * BN; i += SK_THREADS) part[i] = block_sum(i);
  // the block that finishes this tile last sums its splits, in split order
  __threadfence();
  __syncthreads();
  if (tid == 0) merge_here = atomicAdd(&arrivals[tile], 1) == nsplit - 1;
  __syncthreads();
  if (!merge_here) return;
  __threadfence();
  const Acc* tp = ws + (size_t)tile * nsplit * MS * BN;
  const size_t stride = (size_t)MS * BN;
  auto split_sum = [&](int i) {  // staged element i over the splits, in order
    Acc s = 0;
    int p = 0;
    for (; p + 8 <= nsplit; p += 8) {  // eight loads in flight, then their sum in order
      Acc u[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) u[k] = __ldcg(tp + (p + k) * stride + i);
#pragma unroll
      for (int k = 0; k < 8; ++k) s += u[k];
    }
    for (; p < nsplit; ++p) s += __ldcg(tp + p * stride + i);
    return s;
  };
  for (int i = tid; i < M * BN; i += SK_THREADS) {
    const int m = i / BN, c = i % BN;
    if (n0 + c < N)
      y[(size_t)m * N + n0 + c] = v.template out<T>(combine(split_sum, m, c), m, n0 + c);
  }
  if (tid == 0) arrivals[tile] = 0;  // ready for the next launch (and a graph replay)
}

// One launch of Kernel, a __global__ over sk_body: the (column tiles,
// nsplit) grid, smem bytes of dynamic shared memory.
template <auto Kernel, typename... Args>
int sk_launch(int N, int cols, int nsplit, int smem, cudaStream_t stream, Args... args) {
  const cudaError_t opt_in = smem_opt_in<Kernel>(SK_SMEM_MAX);  // past 48 KB (large M)
  if (opt_in != cudaSuccess) return (int)opt_in;
  Kernel<<<dim3((N + 8 * cols - 1) / (8 * cols), nsplit), SK_THREADS, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

// launch(integral_constant MT, integral_constant COLS) for the plan's mt
// (1-6 or 8 tiles of 8 rows, at most MAX_MT) and cols (8, or 16 at mt 1)
// after the checks every split-K entry shares; cudaErrorInvalidValue for a
// plan no kernel takes.
template <int MAX_MT, typename F>
int sk_dispatch(int M, int N, int mt, int cols, int nsplit, int gps, int cg, int xbytes,
                F&& launch) {
  using std::integral_constant;
  if (M < 1 || M > 8 * mt || nsplit < 1 || gps < 1 || cg < 8 || cg % 8 ||
      (cols == 16 && (N % 16 || mt != 1)) || sk_smem_bytes(M, cg, cols, xbytes) > SK_SMEM_MAX)
    return (int)cudaErrorInvalidValue;
  if (cols == 16) return launch(integral_constant<int, 1>{}, integral_constant<int, 16>{});
  if (cols != 8) return (int)cudaErrorInvalidValue;
  using C8 = integral_constant<int, 8>;
  switch (mt) {
    case 1: return launch(integral_constant<int, 1>{}, C8{});
    case 2: return launch(integral_constant<int, 2>{}, C8{});
  }
  if constexpr (MAX_MT == 8) {
    switch (mt) {
      case 3: return launch(integral_constant<int, 3>{}, C8{});
      case 4: return launch(integral_constant<int, 4>{}, C8{});
      case 5: return launch(integral_constant<int, 5>{}, C8{});
      case 6: return launch(integral_constant<int, 6>{}, C8{});
      case 8: return launch(integral_constant<int, 8>{}, C8{});
    }
  }
  return (int)cudaErrorInvalidValue;
}

// The transposed kernels' bodies, one for B13 (int8) and B14 (int4g32).  A
// weight view W (int8_matmul.cu's Int8TView, int4_matmul.cu's Int4TView)
// says how its rows become numbers; for t_gemv_kernel:
//   W::kCols                  output columns (weight rows) one warp of
//                             t_gemv_kernel owns, inside one scale group
//   W::kFoldG, w.scale        the f32 scale folds into g (B13), or into
//                             the weights (B14)
//   w.cols(k0, n, N, wq)      the weights of columns k0..k0+kCols-1 at
//                             n..n+7, as floats (times the scale under
//                             !kFoldG)
// for t_splitk_mma_kernel:
//   W::TskChunk               a lane's registers of one 64-element chunk of
//                             the contraction for its warp's 32 output rows
//   w.tsk_load<WIDE>(d, k0, n, N, valid)   those loads (lane quad t: the
//                             16 elements n = 64c + 16t.., `valid` of them
//                             below N, the rest zeros)
//   w.tsk_frag(d, s, rt, a)   the m16n8k16 A registers of k16 step s of
//                             16-row tile rt
//   W::tsk_row(rt, gid, hi)   the warp's output row of D row gid + 8 hi
//   w.tsk_scales(n, s)        (kFoldG) the 8 scales at n as W::E x2 pairs
//   W::E                      g's and the output's element (bf16 or f16)
// and for t_wgmma_kernel the Hopper view of wg_consume below.

// The transposed split-K tensor-core kernel (bf16 or f16 g, W::E, at M <=
// 16, and at any M where N % 16 != 0; the backward of a training step of
// <= 16 tokens).
// Replaces chatglm_q_tpu/ops/pallas_matmul.py:_int8_t_kernel (:653, its
// pallas_call :708) and :_int4_t_kernel (:671, :745) at <= 16 rows, where
// the CUDA-core t_gemv_kernel below took them.  Bound by the weight bytes:
// at M <= 16 a weight serves at most 16 products, so the card has ~60
// operations a byte to spare and the kernel is built to read each byte once
// and convert each weight once.  out (M, K) = g (M, N) · Ŵᵀ: the mma's A is 16
// weight rows (output columns k) by 16 contraction elements, straight from
// the N-contiguous rows; its B is g's rows (8 an m-tile, zero past M) from
// shared memory, so each weight converts once whatever M is.  The order of
// the contraction is free while A and B agree: lane quad t reads 16
// neighbouring bytes of a row at 64c + 16t (one 16-byte load a row, the
// quads of a warp on 64 contiguous bytes), and k16 step s of chunk c takes
// elements 64c + 16t + 4s .. + 3 (A registers 0 / 2: pairs 4s and 4s + 2),
// so one load feeds the lane's A registers for all four steps of a chunk
// and its B fragment of a step is 8 contiguous bytes of a staged g row.
// A block is TSK_RW warps along the output rows (32 each: two A tiles)
// times TSK_CW along the contraction (chunks c0 + h, c0 + h + 2, ... of
// its split), TSK_ROWS output rows; g's rows over the split are staged cs
// chunks at a time (B13's scale folded in while staging: bf16(g ·
// bf16(s)), the function's own rounding) and serve all its warps.  Each
// warp keeps two chunks' loads in flight (two register sets that
// alternate).  Every two k16 steps (32 contraction elements) go into a
// fresh f32 partial, added to the accumulator on the CUDA cores: one mma
// chain over a whole split would drift from round-to-nearest.  The two
// contraction warps' sums meet in shared memory in order; one split writes
// out, more write f32 partials, and the last block of a tile to arrive sums
// them in split order, writes out and resets its counter (sk_body's
// protocol: deterministic, graph-safe).  grid.z takes 16-row blocks of g.
// The f16 form (a float16 checkpoint's fine-tuning) is the same body over
// f16 tiles: B13's fold f16(g · f16(s)), B14's weights f16(f16(q) · f16(s))
// by one f16x2 multiply, the JAX kernels' roundings in g's dtype.
// ops/quant_matmul.py::t_splitk_plan and t_splitk_smem mirror the constants.
constexpr int TSK_RW = 4;                      // warps along the output rows
constexpr int TSK_CW = 2;                      // warps along the contraction
constexpr int TSK_THREADS = 32 * TSK_RW * TSK_CW;
constexpr int TSK_ROWS = 32 * TSK_RW;          // output rows a block
constexpr int TSK_CHUNK = 64;                  // contraction elements a chunk (4 k16 steps)
constexpr int TSK_MROWS = 16;                  // g rows a block (grid.z: more)
constexpr int TSK_SMEM_MAX = 46 * 1024;        // under the 48 KB that need no opt-in
constexpr int TSK_RS = TSK_ROWS + 1;           // a row of the warps' sums (banks)

// g's staged rows (8 mt of them, padded by 8 elements: the quads' 16-byte
// reads of two rows then hit distinct banks), then the same bytes as the
// TSK_CW warps' (8 mt, TSK_RS) f32 sums.
__host__ __device__ constexpr int tsk_xs_stride(int cs) { return cs * TSK_CHUNK + 8; }
__host__ __device__ constexpr int tsk_smem_bytes(int mt, int cs) {
  return 8 * mt * tsk_xs_stride(cs) * 2 > TSK_CW * 8 * mt * TSK_RS * 4
             ? 8 * mt * tsk_xs_stride(cs) * 2
             : TSK_CW * 8 * mt * TSK_RS * 4;
}

// 16 bytes at p of which `valid` (16, 8 or 0) lie below N, zeros past: one
// 16-byte load where rows are 16-byte aligned (WIDE: N % 16 == 0), else two
// of 8 bytes.
template <bool WIDE>
__device__ __forceinline__ uint4 tsk_ld16(const void* p, int valid) {
  if constexpr (WIDE) {
    return valid > 0 ? __ldg(reinterpret_cast<const uint4*>(p)) : make_uint4(0u, 0u, 0u, 0u);
  } else {
    const uint2* q = reinterpret_cast<const uint2*>(p);
    const uint2 a = valid > 0 ? __ldg(q) : make_uint2(0u, 0u);
    const uint2 b = valid > 8 ? __ldg(q + 1) : make_uint2(0u, 0u);
    return make_uint4(a.x, a.y, b.x, b.y);
  }
}

// Word i (bytes 4i..4i+3) of v; i a constant once the loops unroll.
__device__ __forceinline__ uint32_t word_at(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

namespace {

static_assert(TSK_CW == 2, "t_splitk_mma_kernel sums two contraction halves");

template <typename W, int MT, bool WIDE>
__global__ void __launch_bounds__(TSK_THREADS, 2)
t_splitk_mma_kernel(const typename W::E* __restrict__ g, const W w,
                    typename W::E* __restrict__ out, float* __restrict__ ws,
                    int* __restrict__ arrivals, int M, int K, int N, int cps, int cs) {
  using E = typename W::E;
  extern __shared__ __align__(16) unsigned char tsk_smem[];
  __shared__ bool merge_here;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, t = lane & 3;
  const int rw = warp % TSK_RW, h = warp / TSK_RW;
  const int tile = blockIdx.x, split = blockIdx.y, nsplit = gridDim.y;
  const int tiles = gridDim.x;
  const int m0 = blockIdx.z * TSK_MROWS, Mb = min(TSK_MROWS, M - m0);
  const int r0 = tile * TSK_ROWS, k0 = r0 + 32 * rw;  // K % 32 == 0: all 32 rows or none
  const bool ok = k0 < K;
  const int C = (N + TSK_CHUNK - 1) / TSK_CHUNK;
  const int c_begin = split * cps, c_end = min(C, c_begin + cps);
  const int xs_stride = tsk_xs_stride(cs);
  E* xs = reinterpret_cast<E*>(tsk_smem);
  float* red = reinterpret_cast<float*>(tsk_smem);  // after the loop: TSK_CW x (8 MT, TSK_RS)

  float acc[2][MT][4];
#pragma unroll
  for (int rt = 0; rt < 2; ++rt)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[rt][mt][e] = 0.f;

  auto load = [&](typename W::TskChunk& d, int c) {
    const int n = c * TSK_CHUNK + 16 * t;
    w.template tsk_load<WIDE>(d, k0, n, N, ok ? max(0, min(16, N - n)) : 0);
  };
  // chunk c's products with the staged rows (chunk lc of the stage)
  auto chunk = [&](const typename W::TskChunk& d, int lc) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {  // k16 steps 2 hf, 2 hf + 1: one fresh partial
      uint4 b[MT];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        b[mt] = *reinterpret_cast<const uint4*>(xs + (mt * 8 + gid) * xs_stride +
                                                lc * TSK_CHUNK + 16 * t + 8 * hf);
      float part[2][MT][4];
#pragma unroll
      for (int rt = 0; rt < 2; ++rt)
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int e = 0; e < 4; ++e) part[rt][mt][e] = 0.f;
#pragma unroll
      for (int ss = 0; ss < 2; ++ss) {
#pragma unroll
        for (int rt = 0; rt < 2; ++rt) {
          uint32_t a[4];
          w.tsk_frag(d, 2 * hf + ss, rt, a);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            const uint32_t bb[2] = {ss ? b[mt].z : b[mt].x, ss ? b[mt].w : b[mt].y};
            mma_16816<E>(part[rt][mt], a, bb);
          }
        }
      }
#pragma unroll
      for (int rt = 0; rt < 2; ++rt)
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[rt][mt][e] += part[rt][mt][e];
    }
  };

  typename W::TskChunk ga, gb;  // this warp's chunks c and c + 2: both in flight from the start
  int c = c_begin + h;
  if (c < c_end) load(ga, c);
  if (c + TSK_CW < c_end) load(gb, c + TSK_CW);
  for (int w0 = c_begin; w0 < c_end; w0 += cs) {
    const int w1 = min(c_end, w0 + cs);
    const int n0 = w0 * TSK_CHUNK;
    const int kw = (w1 - w0) * (TSK_CHUNK / 8);  // 16-byte pieces of a staged row
    for (int i = tid; i < 8 * MT * kw; i += TSK_THREADS) {
      const int r = i / kw, col = (i % kw) * 8, n = n0 + col;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (r < Mb && n < N) {
        v = *reinterpret_cast<const uint4*>(g + (size_t)(m0 + r) * N + n);
        if constexpr (W::kFoldG) {  // E(g * E(s)), each product rounded once
          uint32_t s[4];
          w.tsk_scales(n, s);
          v.x = mul2<E>(v.x, s[0]);
          v.y = mul2<E>(v.y, s[1]);
          v.z = mul2<E>(v.z, s[2]);
          v.w = mul2<E>(v.w, s[3]);
        }
      }
      *reinterpret_cast<uint4*>(xs + r * xs_stride + col) = v;
    }
    __syncthreads();
    for (; c < w1; c += 2 * TSK_CW) {  // ga holds chunk c, gb chunk c + 2
      chunk(ga, c - w0);
      if (c + 2 * TSK_CW < c_end) load(ga, c + 2 * TSK_CW);
      if (c + TSK_CW >= w1) break;  // the last stage's odd chunk
      chunk(gb, c + TSK_CW - w0);
      if (c + 3 * TSK_CW < c_end) load(gb, c + 3 * TSK_CW);
    }
    __syncthreads();
  }

  // each warp's sums into its contraction half's slab (g's rows are dead),
  // then the halves in order
  float* slab = red + h * 8 * MT * TSK_RS;
#pragma unroll
  for (int rt = 0; rt < 2; ++rt)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = mt * 8 + 2 * t + (e & 1);
        slab[m * TSK_RS + 32 * rw + W::tsk_row(rt, gid, e >> 1)] = acc[rt][mt][e];
      }
  __syncthreads();
  auto block_sum = [&](int i) {  // element i of the block's (Mb, TSK_ROWS) tile
    const int o = (i / TSK_ROWS) * TSK_RS + i % TSK_ROWS;
    return red[o] + red[8 * MT * TSK_RS + o];
  };
  const int R = min(TSK_ROWS, K - r0);
  if (nsplit == 1) {
    for (int i = tid; i < Mb * TSK_ROWS; i += TSK_THREADS) {
      const int m = i / TSK_ROWS, r = i % TSK_ROWS;
      if (r < R) out[(size_t)(m0 + m) * K + r0 + r] = from_f32<E>(block_sum(i));
    }
    return;
  }
  // (z, tile, split) slabs of min(M, 16) x TSK_ROWS partials
  const int slab_m = min(M, TSK_MROWS);
  const int ztile = blockIdx.z * tiles + tile;
  float* part = ws + ((size_t)ztile * nsplit + split) * slab_m * TSK_ROWS;
  for (int i = tid; i < Mb * TSK_ROWS; i += TSK_THREADS) part[i] = block_sum(i);
  // the block that finishes this tile last sums its splits, in split order
  __threadfence();
  __syncthreads();
  if (tid == 0) merge_here = atomicAdd(&arrivals[ztile], 1) == nsplit - 1;
  __syncthreads();
  if (!merge_here) return;
  __threadfence();
  const float* tp = ws + (size_t)ztile * nsplit * slab_m * TSK_ROWS;
  const size_t stride = (size_t)slab_m * TSK_ROWS;
  for (int i = tid; i < Mb * TSK_ROWS; i += TSK_THREADS) {
    float s = 0.f;
    int p = 0;
    for (; p + 8 <= nsplit; p += 8) {  // eight loads in flight, then their sum in order
      float u[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) u[k] = __ldcg(tp + (p + k) * stride + i);
#pragma unroll
      for (int k = 0; k < 8; ++k) s += u[k];
    }
    for (; p < nsplit; ++p) s += __ldcg(tp + p * stride + i);
    const int m = i / TSK_ROWS, r = i % TSK_ROWS;
    if (r < R) out[(size_t)(m0 + m) * K + r0 + r] = from_f32<E>(s);
  }
  if (tid == 0) arrivals[ztile] = 0;  // ready for the next launch (and a graph replay)
}

template <typename W, int MT, bool WIDE>
int launch_t_splitk_mt(const W& w, const void* g, void* out, void* ws, void* arrivals, int M,
                       int K, int N, int nsplit, int cps, int cs, cudaStream_t stream) {
  const dim3 grid((K + TSK_ROWS - 1) / TSK_ROWS, nsplit, (M + TSK_MROWS - 1) / TSK_MROWS);
  t_splitk_mma_kernel<W, MT, WIDE><<<grid, TSK_THREADS, tsk_smem_bytes(MT, cs), stream>>>(
      static_cast<const typename W::E*>(g), w, static_cast<typename W::E*>(out),
      static_cast<float*>(ws), static_cast<int*>(arrivals), M, K, N, cps, cs);
  return (int)cudaGetLastError();
}

// g (M, N) and out (M, K) in the view's element W::E (bf16 or f16), view
// w; the plan of
// ops/quant_matmul.py::t_splitk_plan: mt m-tiles of 8 rows (2 above 8 rows),
// nsplit splits of cps 64-element chunks, g staged cs chunks at a time (cs
// % 4 == 0: a stage gives each warp an even number of chunks); ws holds
// ceil(M / 16) * ceil(K / 128) * nsplit * min(M, 16) * 128 floats (unused at
// nsplit 1), arrivals ceil(M / 16) * ceil(K / 128) zeroed ints that every
// launch leaves at 0; K % 32 == 0, N % 8 == 0, 16-byte aligned pointers.
template <typename W>
int launch_t_splitk(const W& w, const void* g, void* out, void* ws, void* arrivals, int M, int K,
                    int N, int mt, int nsplit, int cps, int cs, cudaStream_t stream) {
  const int C = (N + TSK_CHUNK - 1) / TSK_CHUNK;
  if (M < 1 || K < 32 || K % 32 || N < 8 || N % 8 || (mt != 1 && mt != 2) ||
      (M < TSK_MROWS ? M : TSK_MROWS) > 8 * mt || nsplit < 1 || cps < 1 || (nsplit - 1) * cps >= C ||
      nsplit * cps < C || cs < 4 || cs % 4 || tsk_smem_bytes(mt, cs) > TSK_SMEM_MAX ||
      (nsplit > 1 && ws == nullptr) || arrivals == nullptr)
    return (int)cudaErrorInvalidValue;
  const bool wide = N % 16 == 0;
  if (mt == 1)
    return wide ? launch_t_splitk_mt<W, 1, true>(w, g, out, ws, arrivals, M, K, N, nsplit, cps,
                                                 cs, stream)
                : launch_t_splitk_mt<W, 1, false>(w, g, out, ws, arrivals, M, K, N, nsplit, cps,
                                                  cs, stream);
  return wide ? launch_t_splitk_mt<W, 2, true>(w, g, out, ws, arrivals, M, K, N, nsplit, cps, cs,
                                               stream)
              : launch_t_splitk_mt<W, 2, false>(w, g, out, ws, arrivals, M, K, N, nsplit, cps,
                                                cs, stream);
}

// CUDA-core form (f32 g): one warp per kCols output columns.
// Weight row k is N-contiguous, so the lanes read 8 neighbouring elements of
// each of the warp's rows (8-byte loads along N), every g load serves all
// kCols columns, and the sums over N run in registers and then across lanes
// in a fixed order, in IEEE f32.  Bound by the weight bytes.
template <typename W, int MT>
__global__ void __launch_bounds__(256)
t_gemv_kernel(const float* __restrict__ g, const W w, float* __restrict__ out, int M, int K,
              int N) {
  constexpr int R = W::kCols;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int k0 = (blockIdx.x * 8 + warp) * R;  // K % 32 == 0: all R columns exist
  const int m0 = blockIdx.y * MT;
  if (k0 >= K) return;
  const float* gr[MT];
#pragma unroll
  for (int m = 0; m < MT; ++m) gr[m] = g + (size_t)min(m0 + m, M - 1) * N;
  float acc[R][MT];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int m = 0; m < MT; ++m) acc[r][m] = 0.f;
  for (int n = lane * 8; n < N; n += 256) {
    float wq[R][8], s[8];
    w.cols(k0, n, N, wq);
    if constexpr (W::kFoldG) load8(w.scale + n, s);
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      float gv[8];
      load8(gr[m] + n, gv);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float gs = gv[j];
        if constexpr (W::kFoldG) gs = gv[j] * s[j];  // g * scale, as the plain version
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
      if (lane == 0 && m0 + m < M) out[(size_t)(m0 + m) * K + k0 + r] = v;
    }
}

template <typename W, int MT>
void launch_t_gemv(const float* g, const W& w, float* out, int M, int K, int N,
                   cudaStream_t stream) {
  const dim3 grid((K / W::kCols + 7) / 8, (M + MT - 1) / MT);
  t_gemv_kernel<W, MT><<<grid, 256, 0, stream>>>(g, w, out, M, K, N);
}

template <typename W>
void t_gemv(const float* g, const W& w, float* out, int M, int K, int N, cudaStream_t stream) {
  if (M == 1)
    launch_t_gemv<W, 1>(g, w, out, M, K, N, stream);
  else if (M == 2)
    launch_t_gemv<W, 2>(g, w, out, M, K, N, stream);
  else if (M <= 4)
    launch_t_gemv<W, 4>(g, w, out, M, K, N, stream);
  else
    launch_t_gemv<W, 8>(g, w, out, M, K, N, stream);
}

}  // namespace

// ---------------------------------------------------------------------------
// The Hopper kernels (sm_90a): int4_matmul.cu's int4_wgmma_kernel (B1
// above 64 rows), int8_matmul.cu's int8_wgmma_kernel (B6), t_wgmma_kernel
// below (B13, B14) and dyn_matmul.cu's s8 dyn_wgmma_kernel (B7, B8) share
// the ring, the producer, the plan checks and the split merge; B6, B13 and
// B14 share the mainloop and the bf16 epilogue too.
//
// Each computes D (WG_N weight-side rows x BM activation rows) = W · Aᵀ per
// output tile, the contraction in stages of WG_STEP elements (DYN_STEP
// for the s8 kernels; either way 128 bytes of an activation row): D's rows are
// the output columns (N of B1 and B6, K of B13 and B14), its columns the
// rows of x or g.  The weights are wgmma's A from registers (each consumer
// thread turns its share of the stage's weight tile into bf16 or s8 fragments,
// once per block and stage), the activations its B straight from the
// 128B-swizzled TMA tile.  A persistent block takes work units b, b + grid,
// ...: unit u is activation tile u % mtiles, then contraction split, then
// weight tile, so that the blocks at work together share a weight tile and
// the activation rows through L2.  Warpgroup 2 is the producer: lane 0 of
// its first warp keeps WG_STAGES stages of TMA loads in flight (the
// activation tile, the weight tile, the scale tile), each stage's `full`
// barrier counting the bytes, its `empty` barrier the 8 consumer warps'
// release.  Warpgroups 0 and 1 each own 64 of the tile's weight rows.  With
// more than one contraction split the last unit of a tile to arrive sums
// the splits' f32 partials in split order and resets its arrival counter
// (deterministic; nothing to reset between launches, so a CUDA graph can
// replay it).  The producer gives its registers up (setmaxnreg) to the
// consumers.  ops/quant_matmul.py's wg_plan (and mma_plan, t_mma_plan over
// it) and mma_smem mirror the constants below.
// ---------------------------------------------------------------------------

constexpr int WG_N = 128;                  // weight rows (output columns) a tile
constexpr int WG_STEP = 64;                // contraction elements a stage
constexpr int WG_STAGES = 8;
constexpr int WG_THREADS = 3 * 128;        // two consumer warpgroups, then the producer's
constexpr int WG_CONSUMER_WARPS = 8;
constexpr int WG_PRODUCER_REGS = 24;       // setmaxnreg: the producer's registers go to the
constexpr int WG_CONSUMER_REGS = 240;      // consumers (3 x 128 x 168 >= 2 x 128 x 240 + 128 x 24)
constexpr int WG_FOLD_BAR = 3;             // named barrier of B13's fold (1 + wg: the merge)

// The ring: per stage the activation tile (BM rows x 128 bytes: 64 bf16,
// or 128 s8 for the dynamic kernels; 128B swizzle; PIECES of them, one a
// bf16 piece of f32 x, for the f32 forms), WB bytes of weights and SB of
// scales; then a full and an empty barrier per stage and two merge flags.
// The base is aligned to 1024 bytes (the swizzle's period) in the dynamic
// shared memory.  STAGES stages: WG_STAGES, or as many as fit (wg_stages:
// the f32 forms' three tiles; dyn_matmul.cu's 32 KB stages at BM = 128).
constexpr int WG_SMEM_MAX = 232448;  // the H100's opt-in limit a block
template <int BM, int WB, int SB, int STAGES = WG_STAGES, int PIECES = 1>
struct WgRing {
  static constexpr int kStages = STAGES;
  static constexpr int kPieces = PIECES;
  static constexpr int XT = BM * 128;  // one activation tile (a piece's)
  static constexpr int XS = PIECES * XT;
  static constexpr int W_OFF = STAGES * XS;
  static constexpr int S_OFF = W_OFF + STAGES * WB;
  static constexpr int BAR_OFF = S_OFF + STAGES * SB;
  static constexpr int FLAG_OFF = BAR_OFF + 2 * STAGES * 8;
  static constexpr int BYTES = FLAG_OFF + 16 + 1024;  // + slack to align the base
  static_assert(BYTES <= WG_SMEM_MAX, "the ring exceeds a block's shared memory");
};

// The persistent schedule: unit u is activation tile u % mtiles, split
// (u / mtiles) % nsplit, weight tile u / (mtiles * nsplit); a split takes
// contraction stages [sp * sps, min(steps, (sp + 1) * sps)).  plane: the
// rows between two pieces' planes of the f32 forms' activations (the
// (3, M, K) pieces of f32 x: M), 0 for the others.
struct WgSchedule {
  int mtiles, nsplit, sps, steps, units;
  int plane = 0;
  __device__ __forceinline__ void unit(int u, int& mt, int& sp, int& nt, int& s0,
                                       int& s1) const {
    mt = u % mtiles;
    const int rest = u / mtiles;
    sp = rest % nsplit;
    nt = rest / nsplit;
    s0 = sp * sps;
    s1 = min(steps, s0 + sps);
  }
};

// A plan the kernels take: every split non-empty, the splits covering all
// `steps` stages, bm a tile they have, a workspace where splits merge.
inline bool wg_plan_ok(int steps, int bm, int nsplit, int sps, int ctas, const void* ws) {
  return steps >= 1 && (bm == 64 || bm == 128) && nsplit >= 1 && sps >= 1 && ctas >= 1 &&
         (nsplit - 1) * sps < steps && nsplit * sps >= steps && (nsplit == 1 || ws != nullptr);
}

inline WgSchedule wg_schedule(int M, int bm, int n_out, int steps, int nsplit, int sps) {
  const int mtiles = (M + bm - 1) / bm, ntiles = (n_out + WG_N - 1) / WG_N;
  return {mtiles, nsplit, sps, steps, mtiles * ntiles * nsplit};
}

// cuTensorMapEncodeTiled from the driver, found at run time (the library
// links no -lcuda); null where the driver has none.
inline PFN_cuTensorMapEncodeTiled_v12000 tensor_map_encoder() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                           cudaEnableDefault, &found);
#else
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
  }
  return fn;
}

// A row-major (rows, cols) tensor of `type` with rows `row_bytes` apart, in
// boxes of box_rows x box_cols.
inline bool tensor_map_2d(PFN_cuTensorMapEncodeTiled_v12000 encode, CUtensorMap* map,
                          CUtensorMapDataType type, const void* base, int rows, int cols,
                          size_t row_bytes, int box_rows, int box_cols,
                          CUtensorMapSwizzle swizzle) {
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)row_bytes};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, type, 2, const_cast<void*>(base), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The activation tiles: E (bf16 or f16) (rows, cols) in boxes of bm rows x 64.
template <typename E = __nv_bfloat16>
inline bool act_map(PFN_cuTensorMapEncodeTiled_v12000 encode, CUtensorMap* map, const void* base,
                    int rows, int cols, int bm) {
  const CUtensorMapDataType type =
      kIsF16<E> ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  return tensor_map_2d(encode, map, type, base, rows, cols, (size_t)cols * 2, bm, WG_STEP,
                       CU_TENSOR_MAP_SWIZZLE_128B);
}

// What the Hopper kernels read of a view V: its pieces (V::kPieces: 3 for
// the f32 forms, whose activations are f32 x's three bf16 pieces, else 1),
// its output element (V::Y: f32 for the f32 forms, else V::E) and the
// stages of its ring (as many as fit, at most WG_STAGES).
template <typename V, typename = void>
struct WgForm {
  static constexpr int kPieces = 1;
  using Y = typename V::E;
};
template <typename V>
struct WgForm<V, std::void_t<decltype(V::kPieces)>> {
  static constexpr int kPieces = V::kPieces;
  using Y = typename V::Y;
};
__host__ __device__ constexpr int wg_stages(int bm, int wb, int sb, int pieces) {
  return (WG_SMEM_MAX - 1024 - 16) / (pieces * bm * 128 + wb + sb + 16) < WG_STAGES
             ? (WG_SMEM_MAX - 1024 - 16) / (pieces * bm * 128 + wb + sb + 16)
             : WG_STAGES;
}
template <int BM, typename V>
using WgRingOf = WgRing<BM, V::kWBytes, V::kSBytes,
                        wg_stages(BM, V::kWBytes, V::kSBytes, WgForm<V>::kPieces),
                        WgForm<V>::kPieces>;

// Align the ring, initialise its barriers; every thread returns the base.
template <typename R>
__device__ __forceinline__ uint8_t* wg_setup(uint8_t* raw, uint64_t*& full, uint64_t*& empty,
                                             int*& flags) {
  const uint32_t a = smem_u32(raw);
  uint8_t* smem = raw + (((a + 1023u) & ~1023u) - a);
  full = reinterpret_cast<uint64_t*>(smem + R::BAR_OFF);
  empty = full + R::kStages;
  flags = reinterpret_cast<int*>(smem + R::FLAG_OFF);
  if (threadIdx.x == 0) {
    for (int s = 0; s < R::kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], WG_CONSUMER_WARPS);
    }
    mbar_init_fence();
  }
  __syncthreads();
  return smem;
}

// The producer warpgroup (threads 256-383): lane 0 of its first warp loads
// every stage of every unit of this block, STEP activation columns a stage
// (WG_STEP bf16; dyn_matmul.cu: DYN_STEP s8) into a ring of STAGES, one
// activation tile a piece (the f32 forms: hi, mid, lo, sc.plane rows
// apart).  V::tma issues the weight and scale tiles of weight tile nt,
// stage s.
template <int BM, typename V, int STEP = WG_STEP, int STAGES = WG_STAGES, int PIECES = 1>
__device__ __forceinline__ void wg_produce(const CUtensorMap* amap, const CUtensorMap* wmap,
                                           const CUtensorMap* smap, uint8_t* smem,
                                           uint64_t* full, uint64_t* empty,
                                           const WgSchedule& sc) {
  using R = WgRing<BM, V::kWBytes, V::kSBytes, STAGES, PIECES>;
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(WG_PRODUCER_REGS));
  if (threadIdx.x != WG_CONSUMER_WARPS * 32) return;
  int st = 0;
  uint32_t ph = 0;
  for (int u = blockIdx.x; u < sc.units; u += gridDim.x) {
    int mt, sp, nt, s0, s1;
    sc.unit(u, mt, sp, nt, s0, s1);
    for (int s = s0; s < s1; ++s) {
      mbar_wait(&empty[st], ph ^ 1);
      mbar_arrive_expect_tx(&full[st], R::XS + V::kWBytes + V::kSBytes);
#pragma unroll
      for (int p = 0; p < PIECES; ++p)
        tma_load_2d(smem + st * R::XS + p * R::XT, amap, s * STEP, p * sc.plane + mt * BM,
                    &full[st]);
      V::tma(wmap, smap, smem + R::W_OFF + st * V::kWBytes, smem + R::S_OFF + st * V::kSBytes,
             nt, s, &full[st]);
      if (++st == STAGES) {
        st = 0;
        ph ^= 1;
      }
    }
  }
}

// Accumulator 4j + e of a consumer thread (the m64nBMk16 layout) is D row
// gid for e < 2, gid + 8 for e >= 2, and activation row 8j + 2t + (e & 1).
// D row gid is output column c, D row gid + 8 column c + STEP: STEP 1 (the
// two columns of a bf16x2 store) or 8.  With SCALE, column n's output is
// multiplied by col_scale[n] first (B6's per-column scale).  E: the output's
// element, bf16, f16 or (the f32 forms) f32.
template <int BM, int STEP, bool SCALE, typename E>
__device__ __forceinline__ void wg_store(const float (&acc)[BM / 2], E* __restrict__ y,
                                         int m0, int c, int M, int N, const float* col_scale) {
  if (c >= N) return;  // N % 16 == 0: a 16-column slab is all in or all out
  const int t = threadIdx.x & 3;
  float s0 = 1.f, s1 = 1.f;
  if constexpr (SCALE) {
    s0 = __ldg(col_scale + c);
    s1 = __ldg(col_scale + c + STEP);
  }
  const auto v = [&](int i, float s) { return SCALE ? acc[i] * s : acc[i]; };
#pragma unroll
  for (int j = 0; j < BM / 8; ++j) {
    const int m = m0 + 8 * j + 2 * t;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      if (m + e >= M) continue;
      E* row = y + (size_t)(m + e) * N + c;
      if constexpr (STEP == 1 && std::is_same_v<E, float>) {
        *reinterpret_cast<float2*>(row) = make_float2(v(4 * j + e, s0), v(4 * j + 2 + e, s1));
      } else if constexpr (STEP == 1) {
        *reinterpret_cast<uint32_t*>(row) = pack2<E>(v(4 * j + e, s0), v(4 * j + 2 + e, s1));
      } else {
        row[0] = from_f32<E>(v(4 * j + e, s0));
        row[STEP] = from_f32<E>(v(4 * j + 2 + e, s1));
      }
    }
  }
}

// The end of a unit, split or not: store(acc, m0) writes this thread's
// outputs of the tile's rows m0.. (wg_store, or dyn_matmul.cu's).  Without
// splits it stores at once; with splits each warpgroup writes its partial
// in register order, and the last of the tile's splits to arrive sums them
// in split order, stores and resets its counter.  Acc is float (f32
// partials) or int (B7's exact int32 sums, merged exactly).
template <int BM, typename Acc, typename Store>
__device__ __forceinline__ void wg_merge(Acc (&acc)[BM / 2], Acc* __restrict__ ws,
                                         int* __restrict__ arrivals, int* merge_flag,
                                         const WgSchedule& sc, int mt, int sp, int nt,
                                         const Store& store) {
  const int wg = threadIdx.x >> 7, tid = threadIdx.x & 127;
  const int m0 = mt * BM;
  if (sc.nsplit == 1) {
    store(acc, m0);
    return;
  }
  const int tile = nt * sc.mtiles + mt;
  const size_t slab = (size_t)(BM / 2) * 128;
  Acc* mine = ws + ((size_t)(tile * sc.nsplit + sp) * 2 + wg) * slab;
#pragma unroll
  for (int i = 0; i < BM / 2; ++i) mine[i * 128 + tid] = acc[i];
  __threadfence();
  named_bar_sync(1 + wg, 128);
  if (tid == 0) merge_flag[wg] = atomicAdd(&arrivals[2 * tile + wg], 1) == sc.nsplit - 1;
  named_bar_sync(1 + wg, 128);
  if (!merge_flag[wg]) return;
  __threadfence();
#pragma unroll
  for (int i = 0; i < BM / 2; ++i) acc[i] = 0;
  for (int p = 0; p < sc.nsplit; ++p) {
    const Acc* src = ws + ((size_t)(tile * sc.nsplit + p) * 2 + wg) * slab + tid;
#pragma unroll
    for (int i = 0; i < BM / 2; ++i) acc[i] += __ldcg(src + i * 128);
  }
  store(acc, m0);
  if (tid == 0) arrivals[2 * tile + wg] = 0;
}

// The end of a unit of B1, B6, B13, B14: the output tile's columns c (and c
// + STEP) of this thread, in the output's element E (bf16, f16 or f32).
template <int BM, typename V, typename E>
__device__ __forceinline__ void wg_finish_unit(float (&acc)[BM / 2], const V& v,
                                               E* __restrict__ y,
                                               float* __restrict__ ws, int* __restrict__ arrivals,
                                               int* merge_flag, const WgSchedule& sc, int mt,
                                               int sp, int nt, int c, int M, int N) {
  wg_merge<BM>(acc, ws, arrivals, merge_flag, sc, mt, sp, nt,
               [&](const float (&a)[BM / 2], int m0) {
                 wg_store<BM, V::kRowStep, V::kColScale>(a, y, m0, nt * WG_N + c, M, N,
                                                         v.col_scale());
               });
}

template <int BM, typename E = __nv_bfloat16>
__device__ __forceinline__ void wg_mma(float (&d)[BM / 2], const uint32_t (&a)[4], uint64_t desc,
                                       int scale_d) {
  if constexpr (BM == 128)
    wgmma_rs_n128<E>(d, a, desc, scale_d);
  else
    wgmma_rs_n64<E>(d, a, desc, scale_d);
}

// Half a stage (two k16 steps, fragments f) into the stage's partial P, the
// first half with scale-d = 0 (nothing carried over); asynchronous.  With
// PIECES 3 (the f32 forms) both steps take the three pieces' tiles, lo,
// then mid, then hi (a tile is BM rows of 128 bytes, BM * 8 in the
// descriptor's 16-byte units).  The smallest pieces go first because the
// tensor cores align each product to the largest addend of a wgmma and cut
// what falls below f32's 24 bits: lo's products (2^-16 of their terms)
// added after hi's would lose their low bits.  A stage's second half still
// meets the first half's sum in the partial; on an H100 that read within
// the f32 forms' limit as a fresh partial a half did (PERF.md §6, PR 24).
template <int BM, typename E, int PIECES = 1>
__device__ __forceinline__ void wg_issue_half(float (&P)[BM / 2], const uint32_t (&f)[2][4],
                                              uint64_t desc, int first) {
  wgmma_fence();
#pragma unroll
  for (int p = PIECES - 1; p >= 0; --p)
#pragma unroll
    for (int k = 0; k < 2; ++k)
      wg_mma<BM, E>(P, f[k], desc + 2 * k + p * (BM * 8),
                    first && k == 0 && p == PIECES - 1 ? 0 : 1);
  wgmma_commit();
}

// Wait until at most PENDING halves are in flight, then pin the fragments
// of the half that finished (their registers stay untouched until then).
template <int PENDING>
__device__ __forceinline__ void wg_release_half(uint32_t (&f)[2][4]) {
  wgmma_wait<PENDING>();
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int r = 0; r < 4; ++r) pin(f[h][r]);
}

// acc += P, one rounding each, once P's wgmmas are done
template <int BM>
__device__ __forceinline__ void wg_fold(float (&acc)[BM / 2], float (&P)[BM / 2]) {
#pragma unroll
  for (int i = 0; i < BM / 2; ++i) {
    pin(P[i]);
    acc[i] += P[i];
  }
}

// The state a consumer thread carries from stage to stage.
template <int BM, typename V>
struct WgConsumer {
  using R = WgRingOf<BM, V>;
  using E = typename V::E;
  static constexpr int kPieces = R::kPieces;
  const V& v;
  const typename V::Lane ln;
  uint8_t* smem;
  uint64_t *full, *empty;
  int st;       // the ring slot of the stage last issued
  uint32_t ph;  // its phase
  uint32_t fa[2][4], fb[2][4];

  __device__ __forceinline__ const uint8_t* wt(int s) const {
    return smem + R::W_OFF + s * V::kWBytes;
  }
  __device__ __forceinline__ uint8_t* stile(int s) const {
    return smem + R::S_OFF + s * V::kSBytes;
  }
  __device__ __forceinline__ uint64_t desc(int s) const { return sw128_desc(smem + s * R::XS); }
  __device__ __forceinline__ void ready(int s, uint32_t p) {
    mbar_wait(&full[s], p);
    if constexpr (V::kFoldG) v.template fold_tile<BM>(smem + s * R::XS, stile(s));
  }
  // the unit's first stage into P; then half 1 of it is in flight
  __device__ __forceinline__ void first(float (&P)[BM / 2]) {
    ready(st, ph);
    v.template load<0>(fa, wt(st), stile(st), ln);
    wg_issue_half<BM, E, kPieces>(P, fa, desc(st), 1);
    v.template load<1>(fb, wt(st), stile(st), ln);
    wg_issue_half<BM, E, kPieces>(P, fb, desc(st) + 4, 0);  // the stage's k16 steps 2, 3
    wg_release_half<1>(fa);
  }
  // the next stage into P while the previous one's partial Q (its half 1
  // still in flight) is finished and folded into acc
  __device__ __forceinline__ void next(float (&acc)[BM / 2], float (&P)[BM / 2],
                                       float (&Q)[BM / 2]) {
    const int nst = st + 1 == R::kStages ? 0 : st + 1;
    const uint32_t nph = nst == 0 ? ph ^ 1 : ph;
    ready(nst, nph);
    v.template load<0>(fa, wt(nst), stile(nst), ln);
    wg_issue_half<BM, E, kPieces>(P, fa, desc(nst), 1);
    wg_release_half<1>(fb);  // the previous stage is done
    wg_fold<BM>(acc, Q);     // on the CUDA cores, while this stage's half 0 runs
    if ((threadIdx.x & 31) == 0) mbar_arrive(&empty[st]);
    v.template load<1>(fb, wt(nst), stile(nst), ln);
    wg_issue_half<BM, E, kPieces>(P, fb, desc(nst) + 4, 0);
    wg_release_half<1>(fa);
    st = nst;
    ph = nph;
  }
  // the unit's last stage, of partial P, done and folded; its slot released
  __device__ __forceinline__ void last(float (&acc)[BM / 2], float (&P)[BM / 2]) {
    wg_release_half<0>(fb);
    wg_fold<BM>(acc, P);
    if ((threadIdx.x & 31) == 0) mbar_arrive(&empty[st]);
    if (++st == R::kStages) {
      st = 0;
      ph ^= 1;
    }
  }
};

// The consumers of B6, B13 and B14.  A weight view V gives, besides its
// tiles (kWBytes, kSBytes, tma):
//   V::Lane, V::lane(tid)      this thread's output column c (D row gid) and
//                              its offsets into the stage's tiles
//   kRowStep                   D row gid + 8 is column c + kRowStep
//   v.load<H>(f, wt, st, ln)   the A fragments of half H of the stage (k16
//                              steps 2H, 2H + 1) from its weight and scale tiles
//   kFoldG, v.fold_tile<BM>(xs, st)  (B13) fold the scale into the
//                              activation tile before any wgmma reads it
//   kColScale, v.col_scale()   (B6) the per-column scale of the epilogue
//   V::E                       the activations' and the output's element
//                              (bf16 or f16); the f32 forms: the pieces'
//                              element bf16, with V::kPieces 3 and V::Y
//                              float (WgForm)
// No scale changes inside these contractions, so the f32 sum needs no
// per-group fold; but the tensor cores' accumulation over one long wgmma
// chain drifts from round-to-nearest (on an H100 the error grew with the
// chain, to ~17x 2^-23 of sum|terms| over 4096 k16 steps), so each stage's
// 64 products go into a fresh partial (p0 and p1 in turn), added to the f32
// accumulator by the CUDA cores while the next stage's wgmmas run: the sums
// B1's per-group fold gives.  The loop body takes two stages (p1, then p0)
// and has no branch, so ptxas sees one half in flight on every path into
// and out of it and keeps the wgmmas asynchronous.
template <int BM, typename V>
__device__ __forceinline__ void wg_consume(const V& v, uint8_t* smem, uint64_t* full,
                                           uint64_t* empty, int* merge_flag, const WgSchedule& sc,
                                           typename WgForm<V>::Y* __restrict__ y,
                                           float* __restrict__ ws,
                                           int* __restrict__ arrivals, int M, int N) {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(WG_CONSUMER_REGS));
  WgConsumer<BM, V> cs{v, V::lane(threadIdx.x), smem, full, empty, 0, 0, {}, {}};
  float acc[BM / 2], p0[BM / 2], p1[BM / 2];
  for (int u = blockIdx.x; u < sc.units; u += gridDim.x) {
    int mt, sp, nt, s0, s1;
    sc.unit(u, mt, sp, nt, s0, s1);
    const int rest = s1 - s0 - 1;  // stages after the first
#pragma unroll
    for (int i = 0; i < BM / 2; ++i) acc[i] = 0.f;
    cs.first(p0);
    for (int i = 0; i + 1 < rest; i += 2) {
      cs.next(acc, p1, p0);
      cs.next(acc, p0, p1);
    }
    if (rest & 1) {
      cs.next(acc, p1, p0);
      cs.last(acc, p1);
    } else {
      cs.last(acc, p0);
    }
    wg_finish_unit<BM, V>(acc, v, y, ws, arrivals, merge_flag, sc, mt, sp, nt, cs.ln.c, M, N);
  }
}

// The body of the kernels on wg_consume's mainloop; raw is the kernel's
// dynamic shared memory.
template <int BM, typename V>
__device__ __forceinline__ void wg_body(uint8_t* raw, const CUtensorMap* amap,
                                        const CUtensorMap* wmap, const CUtensorMap* smap,
                                        const V& v, typename WgForm<V>::Y* __restrict__ y,
                                        float* __restrict__ ws, int* __restrict__ arrivals, int M,
                                        int N, const WgSchedule& sc) {
  using R = WgRingOf<BM, V>;
  uint64_t *full, *empty;
  int* merge_flag;
  uint8_t* smem = wg_setup<R>(raw, full, empty, merge_flag);
  if (threadIdx.x >= WG_CONSUMER_WARPS * 32)
    wg_produce<BM, V, WG_STEP, R::kStages, R::kPieces>(amap, wmap, smap, smem, full, empty, sc);
  else
    wg_consume<BM, V>(v, smem, full, empty, merge_flag, sc, y, ws, arrivals, M, N);
}

namespace {

// The transposed tensor-core kernel (bf16 or f16 g, W::E, M > 16;
// training's M = B*S): out (M, K) = g (M, N) · Ŵᵀ, the contraction over N,
// on wg_consume's mainloop.  D's rows are output columns k (weight rows),
// its columns g's rows; the weight view turns a stage's weight rows into E
// fragments (B14: E(E(q) * E(s)), B13: the exact int8 values, with the
// scale folded into the g tile).
template <typename W, int BM>
__global__ void __launch_bounds__(WG_THREADS, 1)
t_wgmma_kernel(const __grid_constant__ CUtensorMap gmap, const __grid_constant__ CUtensorMap wmap,
               const __grid_constant__ CUtensorMap smap, const W w,
               typename W::E* __restrict__ out, float* __restrict__ ws,
               int* __restrict__ arrivals, int M, int K, const WgSchedule sc) {
  extern __shared__ uint8_t wg_smem_raw[];
  wg_body<BM, W>(wg_smem_raw, &gmap, &wmap, &smap, w, out, ws, arrivals, M, K, sc);
}

template <typename W, int BM>
int launch_t_wgmma_bm(const CUtensorMap& gmap, const CUtensorMap& wmap, const CUtensorMap& smap,
                      const W& w, void* out, void* ws, void* arrivals, int M, int K,
                      const WgSchedule& sc, int ctas, cudaStream_t stream) {
  constexpr int bytes = WgRingOf<BM, W>::BYTES;
  const cudaError_t opt_in = smem_opt_in<t_wgmma_kernel<W, BM>>(bytes);
  if (opt_in != cudaSuccess) return (int)opt_in;
  t_wgmma_kernel<W, BM><<<ctas, WG_THREADS, bytes, stream>>>(
      gmap, wmap, smap, w, static_cast<typename W::E*>(out), static_cast<float*>(ws),
      static_cast<int*>(arrivals), M, K, sc);
  return (int)cudaGetLastError();
}

// g (M, N) and out (M, K) in W::E (bf16 or f16), the weights and scales of
// view w (their tensor maps from W::maps); the plan of
// ops/quant_matmul.py::t_mma_plan.
template <typename W>
int launch_t_wgmma(const W& w, const void* g, const void* weights, const void* scale, void* out,
                   void* ws, void* arrivals, int M, int K, int N, int bm, int nsplit, int sps,
                   int ctas, cudaStream_t stream) {
  const int steps = (N + WG_STEP - 1) / WG_STEP;
  if (M < 1 || K < 32 || K % 32 || N < 16 || N % 16 ||
      !wg_plan_ok(steps, bm, nsplit, sps, ctas, ws))
    return (int)cudaErrorInvalidValue;
  PFN_cuTensorMapEncodeTiled_v12000 encode = tensor_map_encoder();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap gmap, wmap, smap;
  if (!act_map<typename W::E>(encode, &gmap, g, M, N, bm) ||
      !W::maps(encode, &wmap, &smap, weights, scale, K, N))
    return (int)cudaErrorInvalidValue;
  const WgSchedule sc = wg_schedule(M, bm, K, steps, nsplit, sps);
  if (bm == 128)
    return launch_t_wgmma_bm<W, 128>(gmap, wmap, smap, w, out, ws, arrivals, M, K, sc, ctas,
                                      stream);
  return launch_t_wgmma_bm<W, 64>(gmap, wmap, smap, w, out, ws, arrivals, M, K, sc, ctas,
                                   stream);
}

}  // namespace

// The second pass of the CUDA-core split-K kernels (B1's and B6's gemv):
// y[i] = T(float(the nsplit f32 partials summed in order) * col_scale[n]);
// a null scale is skipped.  Deterministic, no atomics.
namespace {

template <typename T>
__global__ void splitk_reduce_kernel(const float* __restrict__ ws,
                                     const float* __restrict__ col_scale, T* __restrict__ y,
                                     int nsplit, int N, size_t MN) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= MN) return;
  float v = 0.f;
  for (int p = 0; p < nsplit; ++p) v += ws[(size_t)p * MN + i];
  if (col_scale) v *= col_scale[i % N];
  y[i] = from_f32<T>(v);
}

template <typename T>
void splitk_reduce(const float* ws, const float* col_scale, T* y, int nsplit, int M, int N,
                   cudaStream_t stream) {
  const size_t MN = (size_t)M * N;
  splitk_reduce_kernel<T><<<(unsigned)((MN + 255) / 256), 256, 0, stream>>>(ws, col_scale, y,
                                                                            nsplit, N, MN);
}

}  // namespace

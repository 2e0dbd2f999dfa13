// int4g32 weight-only matmul: y (M,N) = x (M,K) @ dequant(packed (K/2,N), scale (K/32,N)).
//
// Replaces the TPU kernels chatglm_q_tpu/ops/pallas_matmul.py:_int4_fwd_kernel
// (grid form, every per-layer linear) and :_int4_pipelined_kernel (decode-M
// form, the lm_head).  Both compute the same function; here it is one wrapper
// (ops/quant_matmul.py::int4g32_matmul) over two kernels chosen by M.
//
// Numerics: packed bytes are "tpu order" — byte row i holds K-row 2i in the
// low nibble and 2i+1 in the high nibble, as two's-complement int4.  The
// nibbles are sign-extended in registers, each 32-row group's partial sum is
// taken in f32 on the unscaled integers, and the group scale multiplies that
// f32 partial (the "grouped" scheme, pallas_matmul.py:316-323).  Integer
// weights and bf16 activations are exact in the products, so the kernels
// differ from the plain version only in summation order.
//
// * int4_gemv_kernel (small M, decode): bound by bytes — every weight byte is
//   read once per call and there are only ~2 operations per byte.  Each lane
//   reads 8 neighbouring N bytes of a byte row (one 8-byte load; a warp reads
//   256 contiguous bytes), so loads coalesce along the N-contiguous layout.
//   At decode N is as small as 4096 while K reaches 13824, which would leave
//   a few hundred column threads and most of the card idle; the kernel
//   therefore splits K across blocks (grid.y) and across the 4 warps of a
//   block.  Warps reduce in shared memory in a fixed order, blocks write f32
//   partials to a workspace, and splitk_reduce_kernel (common.cuh) sums the
//   splits in a fixed order and casts: deterministic, no atomics.
// * int4_mma_kernel (bf16, large M, prefill): bound by operations.  A
//   64x128 output tile per block; each stage copies 128 K-columns of x and
//   64 packed byte rows into shared memory, and eight warps run
//   mma.sync.m16n8k16 (bf16 in, f32 out).  The B fragment of m16n8k16 holds
//   K-rows (2t, 2t+1) of one column — exactly the two nibbles of one packed
//   byte — so each lane dequantizes its fragment straight from the packed
//   tile, with no dequantized copy in shared memory.  The accumulator layout
//   of mma.sync is known per lane, so the per-column group scale multiplies
//   the f32 group partial in registers.  No TMA, wgmma or multi-stage
//   pipeline yet: that is later work.
//
// The backward kernels (B14) replace pallas_matmul.py:_int4_t_kernel
// (int4_matmul_t_pallas): grad_x (M,K) = g (M,N) @ dequant(packed, scale)ᵀ,
// the contraction over N.  The scale changes along both K/32 and N, so it
// folds into neither g nor the output: each weight is dequantized to g's
// dtype, bf16(q * s) under bf16, before the dot, as both JAX forms round it.
// Byte row i of packed holds output columns 2i (low nibble) and 2i+1 (high).
// Both are common.cuh's transposed bodies over Int4TView:
// * t_gemv_kernel<Int4TView> (f32 g, or M <= 16): bound by the packed bytes;
//   one warp per two byte rows (four output columns), 8-byte loads along N.
// * t_mma_kernel<Int4TView> (bf16, M > 16): bound by operations; the TMM
//   tiles, the nibbles dequantized to bf16 as they are staged into shared
//   memory (one multiply per weight per block).
#include "common.cuh"

namespace {

// GEMV_COLS / GEMV_LANES / GEMV_KW (common.cuh): 8 columns per lane, one
// 8-byte load per byte row; 32 lanes cover 256 columns; 4 warps along K.

__device__ __forceinline__ float nib_lo(uint32_t b) {
  return (float)((int)((b & 0xFu) ^ 0x8u) - 8);
}
__device__ __forceinline__ float nib_hi(uint32_t b) {
  return (float)((int)(((b >> 4) & 0xFu) ^ 0x8u) - 8);
}

template <typename T, int MT>
__global__ void __launch_bounds__(GEMV_LANES* GEMV_KW)
int4_gemv_kernel(const T* __restrict__ x, const uint8_t* __restrict__ packed,
                 const __nv_bfloat16* __restrict__ scale, float* __restrict__ ws,
                 int M, int K, int N, int groups_per_split) {
  const int lane = threadIdx.x;
  const int wy = threadIdx.y;
  const int n0 = (blockIdx.x * GEMV_LANES + lane) * GEMV_COLS;
  const int split = blockIdx.y;
  const int m0 = blockIdx.z * MT;
  const int G = K / 32;
  const int g_begin = split * groups_per_split;
  const int g_end = min(G, g_begin + groups_per_split);

  // rows past M read row M-1 (valid memory) and are never stored
  const T* xr[MT];
#pragma unroll
  for (int m = 0; m < MT; ++m) xr[m] = x + (size_t)min(m0 + m, M - 1) * K;

  float acc[MT][GEMV_COLS];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < GEMV_COLS; ++j) acc[m][j] = 0.f;

  if (n0 < N) {
    for (int g = g_begin + wy; g < g_end; g += GEMV_KW) {
      float part[MT][GEMV_COLS];
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int j = 0; j < GEMV_COLS; ++j) part[m][j] = 0.f;

      const uint8_t* prow = packed + (size_t)g * 16 * N + n0;
#pragma unroll 4
      for (int r = 0; r < 16; ++r) {
        const uint2 w = __ldg(reinterpret_cast<const uint2*>(prow + (size_t)r * N));
        float lo[GEMV_COLS], hi[GEMV_COLS];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const uint32_t b0 = (w.x >> (8 * j)) & 0xFFu;
          const uint32_t b1 = (w.y >> (8 * j)) & 0xFFu;
          lo[j] = nib_lo(b0);
          hi[j] = nib_hi(b0);
          lo[4 + j] = nib_lo(b1);
          hi[4 + j] = nib_hi(b1);
        }
        const int k = g * 32 + 2 * r;
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          const float2 xv = load_pair(xr[m] + k);
#pragma unroll
          for (int j = 0; j < GEMV_COLS; ++j) {
            part[m][j] = fmaf(xv.x, lo[j], part[m][j]);
            part[m][j] = fmaf(xv.y, hi[j], part[m][j]);
          }
        }
      }
      const uint4 sv = __ldg(reinterpret_cast<const uint4*>(scale + (size_t)g * N + n0));
      const __nv_bfloat162* s2 = reinterpret_cast<const __nv_bfloat162*>(&sv);
      float s[GEMV_COLS];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 f = __bfloat1622float2(s2[j]);
        s[2 * j] = f.x;
        s[2 * j + 1] = f.y;
      }
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int j = 0; j < GEMV_COLS; ++j) acc[m][j] = fmaf(part[m][j], s[j], acc[m][j]);
    }
  }

  // fixed-order reduction over the K warps
  __shared__ float red[MT][GEMV_BN];
  for (int w = GEMV_KW - 1; w >= 0; --w) {
    if (wy == w) {
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int j = 0; j < GEMV_COLS; ++j) {
          const int c = lane * GEMV_COLS + j;
          red[m][c] = (w == GEMV_KW - 1) ? acc[m][j] : red[m][c] + acc[m][j];
        }
    }
    __syncthreads();
  }
  for (int i = wy * GEMV_LANES + lane; i < MT * GEMV_BN; i += GEMV_LANES * GEMV_KW) {
    const int m = i / GEMV_BN, c = i % GEMV_BN;
    const int row = m0 + m, n = blockIdx.x * GEMV_BN + c;
    if (row < M && n < N) ws[((size_t)split * M + row) * N + n] = red[m][c];
  }
}

template <typename T, int MT>
void launch_gemv(const T* x, const uint8_t* packed, const __nv_bfloat16* scale, float* ws,
                 int M, int K, int N, int nsplit, int gps, cudaStream_t stream) {
  const dim3 block(GEMV_LANES, GEMV_KW);
  const dim3 grid((N + GEMV_BN - 1) / GEMV_BN, nsplit, (M + MT - 1) / MT);
  int4_gemv_kernel<T, MT><<<grid, block, 0, stream>>>(x, packed, scale, ws, M, K, N, gps);
}

template <typename T>
void gemv(const T* x, const uint8_t* packed, const __nv_bfloat16* scale, T* y, float* ws,
          int M, int K, int N, int nsplit, int gps, cudaStream_t stream) {
  if (M == 1)
    launch_gemv<T, 1>(x, packed, scale, ws, M, K, N, nsplit, gps, stream);
  else if (M == 2)
    launch_gemv<T, 2>(x, packed, scale, ws, M, K, N, nsplit, gps, stream);
  else if (M <= 4)
    launch_gemv<T, 4>(x, packed, scale, ws, M, K, N, nsplit, gps, stream);
  else
    launch_gemv<T, 8>(x, packed, scale, ws, M, K, N, nsplit, gps, stream);
  splitk_reduce<float, T>(ws, nullptr, nullptr, y, nsplit, M, N, stream);
}

// ---------------------------------------------------------------------------
// Tensor-core kernel (bf16 activations, large M)
// ---------------------------------------------------------------------------

constexpr int MMA_BM = 64;
constexpr int MMA_BN = 128;
constexpr int MMA_BKG = 4;                 // 32-row groups per stage
constexpr int MMA_BK = MMA_BKG * 32;       // 128 K-columns per stage
constexpr int XS_STRIDE = MMA_BK + 8;      // bf16 per x row in smem (pad: no bank conflicts)
constexpr int PS_STRIDE = MMA_BN + 16;     // bytes per packed row in smem (16-aligned pad)

// one packed byte -> the bf16x2 B-fragment register (low nibble = lower K row)
__device__ __forceinline__ uint32_t nib_pair_bf16(uint32_t b) {
  __nv_bfloat162 v = __floats2bfloat162_rn(nib_lo(b), nib_hi(b));
  return *reinterpret_cast<uint32_t*>(&v);
}

__global__ void __launch_bounds__(256)
int4_mma_kernel(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ packed,
                const __nv_bfloat16* __restrict__ scale, __nv_bfloat16* __restrict__ y,
                int M, int K, int N) {
  __shared__ __align__(16) __nv_bfloat16 xs[MMA_BM * XS_STRIDE];
  __shared__ __align__(16) uint8_t ps[(MMA_BK / 2) * PS_STRIDE];
  __shared__ float ss[MMA_BKG * MMA_BN];

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int wm = (warp >> 2) * 32;  // 2 warps along M, 32 rows each
  const int wn = (warp & 3) * 32;   // 4 warps along N, 32 columns each
  const int m_base = blockIdx.y * MMA_BM;
  const int n_base = blockIdx.x * MMA_BN;
  const int G = K / 32;

  float acc[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

  for (int g0 = 0; g0 < G; g0 += MMA_BKG) {
    const int ng = min(MMA_BKG, G - g0);
    const int k0 = g0 * 32;
    for (int i = tid; i < MMA_BM * (MMA_BK / 8); i += 256) {
      const int r = i / (MMA_BK / 8), c = (i % (MMA_BK / 8)) * 8;
      const int row = m_base + r, k = k0 + c;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (row < M && k < K) v = *reinterpret_cast<const uint4*>(x + (size_t)row * K + k);
      *reinterpret_cast<uint4*>(xs + r * XS_STRIDE + c) = v;
    }
    for (int i = tid; i < (MMA_BK / 2) * (MMA_BN / 16); i += 256) {
      const int r = i / (MMA_BN / 16), c = (i % (MMA_BN / 16)) * 16;
      const int kr = k0 / 2 + r, n = n_base + c;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (kr < K / 2 && n < N) v = *reinterpret_cast<const uint4*>(packed + (size_t)kr * N + n);
      *reinterpret_cast<uint4*>(ps + r * PS_STRIDE + c) = v;
    }
    for (int i = tid; i < MMA_BKG * MMA_BN; i += 256) {
      const int gi = i / MMA_BN, c = i % MMA_BN;
      const int g = g0 + gi, n = n_base + c;
      ss[i] = (g < G && n < N) ? __bfloat162float(scale[(size_t)g * N + n]) : 0.f;
    }
    __syncthreads();

    for (int gi = 0; gi < ng; ++gi) {
      float part[2][4][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
#pragma unroll
          for (int e = 0; e < 4; ++e) part[mi][ni][e] = 0.f;

#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
        const int kk = gi * 32 + ks * 16;
        uint32_t a[2][4];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          const __nv_bfloat16* base = xs + (wm + mi * 16 + gid) * XS_STRIDE + kk + tig * 2;
          a[mi][0] = *reinterpret_cast<const uint32_t*>(base);
          a[mi][1] = *reinterpret_cast<const uint32_t*>(base + 8 * XS_STRIDE);
          a[mi][2] = *reinterpret_cast<const uint32_t*>(base + 8);
          a[mi][3] = *reinterpret_cast<const uint32_t*>(base + 8 * XS_STRIDE + 8);
        }
        uint32_t b[4][2];
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          const uint8_t* pb = ps + (kk / 2 + tig) * PS_STRIDE + wn + ni * 8 + gid;
          b[ni][0] = nib_pair_bf16(pb[0]);
          b[ni][1] = nib_pair_bf16(pb[4 * PS_STRIDE]);
        }
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int ni = 0; ni < 4; ++ni) mma_bf16_16816(part[mi][ni], a[mi], b[ni]);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int c = wn + ni * 8 + tig * 2;
        const float s0 = ss[gi * MMA_BN + c], s1 = ss[gi * MMA_BN + c + 1];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          acc[mi][ni][0] = fmaf(part[mi][ni][0], s0, acc[mi][ni][0]);
          acc[mi][ni][1] = fmaf(part[mi][ni][1], s1, acc[mi][ni][1]);
          acc[mi][ni][2] = fmaf(part[mi][ni][2], s0, acc[mi][ni][2]);
          acc[mi][ni][3] = fmaf(part[mi][ni][3], s1, acc[mi][ni][3]);
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int row = m_base + wm + mi * 16 + gid;
      const int col = n_base + wn + ni * 8 + tig * 2;
      if (col >= N) continue;  // N % 16 == 0, so col + 1 < N as well
      if (row < M)
        *reinterpret_cast<__nv_bfloat162*>(y + (size_t)row * N + col) =
            __floats2bfloat162_rn(acc[mi][ni][0], acc[mi][ni][1]);
      if (row + 8 < M)
        *reinterpret_cast<__nv_bfloat162*>(y + (size_t)(row + 8) * N + col) =
            __floats2bfloat162_rn(acc[mi][ni][2], acc[mi][ni][3]);
    }
}

// ---------------------------------------------------------------------------
// Transposed kernels (B14): grad_x (M, K) = g (M, N) @ dequant(packed, scale)ᵀ
// ---------------------------------------------------------------------------

// The int4g32 weight view of common.cuh's transposed kernels: the scale
// changes along K/32 and N, so each weight is dequantized, bf16(q * s) in g's
// dtype, before the dot.  Output columns 2i and 2i+1 are the low and high
// nibbles of byte row i.
struct Int4TView {
  const uint8_t* packed;
  const __nv_bfloat16* scale;
  static constexpr int kCols = 4;  // two byte rows, inside one 32-row group
  static constexpr bool kFoldG = false;

  template <typename T>
  __device__ __forceinline__ void cols(int k0, int n, int N, float (&wq)[kCols][8]) const {
    float s[8];
    load8(scale + (size_t)(k0 / 32) * N + n, s);
#pragma unroll
    for (int br = 0; br < kCols / 2; ++br) {
      const uint2 pv =
          __ldg(reinterpret_cast<const uint2*>(packed + (size_t)(k0 / 2 + br) * N + n));
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const uint32_t b = ((j < 4 ? pv.x : pv.y) >> (8 * (j & 3))) & 0xFFu;
        wq[2 * br][j] = round_to<T>(nib_lo(b) * s[j]);  // the weight in g's dtype
        wq[2 * br + 1][j] = round_to<T>(nib_hi(b) * s[j]);
      }
    }
  }
  __device__ __forceinline__ const float* fold_ptr() const { return nullptr; }
  // 64 byte rows (128 output columns) x 64 columns: one 16-byte chunk a thread
  __device__ __forceinline__ void stage_b(__nv_bfloat16* bs, int k_base, int n0, int K,
                                          int N) const {
    const uint8_t* __restrict__ pk = packed;
    for (int i = threadIdx.x; i < (TMM_BK / 2) * (TMM_BN / 16); i += TMM_THREADS) {
      const int pr = i / (TMM_BN / 16), c = (i % (TMM_BN / 16)) * 16;
      const int kr = k_base / 2 + pr, n = n0 + c;
      uint32_t lo[8], hi[8];
      if (kr < K / 2 && n < N) {
        const uint4 v = *reinterpret_cast<const uint4*>(pk + (size_t)kr * N + n);
        const __nv_bfloat16* sp = scale + (size_t)(2 * kr / 32) * N + n;
        float s[16];
        load8(sp, s);
        load8(sp + 8, s + 8);
        const uint8_t* p = reinterpret_cast<const uint8_t*>(&v);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          lo[j] = bf16x2_bits(nib_lo(p[2 * j]) * s[2 * j], nib_lo(p[2 * j + 1]) * s[2 * j + 1]);
          hi[j] = bf16x2_bits(nib_hi(p[2 * j]) * s[2 * j], nib_hi(p[2 * j + 1]) * s[2 * j + 1]);
        }
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) lo[j] = hi[j] = 0u;
      }
      __nv_bfloat16* even = bs + (2 * pr) * TMM_STRIDE + c;
      __nv_bfloat16* odd = even + TMM_STRIDE;
      *reinterpret_cast<uint4*>(even) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
      *reinterpret_cast<uint4*>(even + 8) = make_uint4(lo[4], lo[5], lo[6], lo[7]);
      *reinterpret_cast<uint4*>(odd) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
      *reinterpret_cast<uint4*>(odd + 8) = make_uint4(hi[4], hi[5], hi[6], hi[7]);
    }
  }
};

}  // namespace

extern "C" {

// Split-K CUDA-core kernel.  x is bf16 (x_is_bf16) or f32, y the same type;
// ws holds nsplit * M * N floats; K % 32 == 0, N % 8 == 0, 16-byte aligned
// pointers (checked by the wrapper).
int chatglm_int4_gemv(const void* x, const void* packed, const void* scale, void* y, void* ws,
                      int M, int K, int N, int x_is_bf16, int nsplit, int groups_per_split,
                      void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const uint8_t* p = static_cast<const uint8_t*>(packed);
  const __nv_bfloat16* sc = static_cast<const __nv_bfloat16*>(scale);
  float* w = static_cast<float*>(ws);
  if (x_is_bf16)
    gemv<__nv_bfloat16>(static_cast<const __nv_bfloat16*>(x), p, sc,
                        static_cast<__nv_bfloat16*>(y), w, M, K, N, nsplit, groups_per_split, s);
  else
    gemv<float>(static_cast<const float*>(x), p, sc, static_cast<float*>(y), w, M, K, N, nsplit,
                groups_per_split, s);
  return (int)cudaGetLastError();
}

// Tensor-core kernel, bf16 only; K % 32 == 0, N % 16 == 0, aligned pointers.
int chatglm_int4_mma(const void* x, const void* packed, const void* scale, void* y, int M, int K,
                     int N, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const dim3 grid((N + MMA_BN - 1) / MMA_BN, (M + MMA_BM - 1) / MMA_BM);
  int4_mma_kernel<<<grid, 256, 0, s>>>(static_cast<const __nv_bfloat16*>(x),
                                       static_cast<const uint8_t*>(packed),
                                       static_cast<const __nv_bfloat16*>(scale),
                                       static_cast<__nv_bfloat16*>(y), M, K, N);
  return (int)cudaGetLastError();
}

// B14, CUDA-core form: out (M, K) = g (M, N) @ dequant(packed (K/2, N),
// scale (K/32, N))ᵀ.  g bf16 (g_is_bf16) or f32, out the same; K % 32 == 0,
// N % 8 == 0, aligned pointers.
int chatglm_int4_t_gemv(const void* g, const void* packed, const void* scale, void* out, int M,
                        int K, int N, int g_is_bf16, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const Int4TView wv{static_cast<const uint8_t*>(packed),
                     static_cast<const __nv_bfloat16*>(scale)};
  if (g_is_bf16)
    t_gemv(static_cast<const __nv_bfloat16*>(g), wv, static_cast<__nv_bfloat16*>(out), M, K, N,
           s);
  else
    t_gemv(static_cast<const float*>(g), wv, static_cast<float*>(out), M, K, N, s);
  return (int)cudaGetLastError();
}

// B14, tensor-core form, bf16 only; K % 32 == 0, N % 16 == 0, aligned pointers.
int chatglm_int4_t_mma(const void* g, const void* packed, const void* scale, void* out, int M,
                       int K, int N, void* stream) {
  const Int4TView wv{static_cast<const uint8_t*>(packed),
                     static_cast<const __nv_bfloat16*>(scale)};
  t_mma(static_cast<const __nv_bfloat16*>(g), wv, static_cast<__nv_bfloat16*>(out), M, K, N,
        reinterpret_cast<cudaStream_t>(stream));
  return (int)cudaGetLastError();
}

const char* chatglm_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"

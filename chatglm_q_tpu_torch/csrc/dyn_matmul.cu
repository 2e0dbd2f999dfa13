// Dynamic-activation int8 matmuls: s8 activations x s8 weights, int32 dots.
//
// The activations come quantized per row by the wrapper
// (ops/dyn_matmul.py::dyn_quantize_rows): xq (M,K) s8 and sx (M,1) f32.
//
// * B7 replaces chatglm_q_tpu/ops/pallas_matmul.py:_int8_dyn_kernel
//   (int8_dyn_matmul_pallas, int8_dyn_matmul_pallas_idx):
//     acc = xq @ w (K,N) s8 in int32;  y = (float(acc) * sx) * scale (N,).
//   int32 sums are exact in any order (|acc| <= 127*127*13824 < 2^31) and
//   the epilogue does the plain version's f32 operations in its order, so
//   both kernels equal the plain version bit for bit.
// * B8 replaces :_int4_dyn_kernel (int4_dyn_matmul_pallas,
//   int4_dyn_matmul_pallas_idx): the tpu-order nibbles (two's complement,
//   K rows 2i / 2i+1 in the low / high nibble of byte row i) widen to s8,
//     y = (sum_g float(xq_g @ w8_g) * scale[g, n]) * sx,
//   g over groups of 32 along K.  Each group dot is an exact int32; the f32
//   sum over groups differs from the plain version only in its order.
//   Padded K rows (nibble 0, scale 1, zero activations) add exactly 0.
//
// Kernels, two per function:
// * *_dyn_gemv_kernel (M <= 16, decode): bound by the weight bytes.  The
//   split-K layout of int4_matmul.cu's gemv (8 columns per lane from one
//   8-byte load per weight row, K split over blocks and 4 warps in groups
//   of 32 rows), with __dp4a doing four s8 products per instruction.  The
//   weights are N-contiguous, so a lane loads four rows of its 8 columns
//   and transposes each 4x4 byte block with __byte_perm into one K-ordered
//   word per column.  B7 keeps int32 partials (the second pass sums them
//   exactly), B8 f32 partials of the scaled group dots (summed in a fixed
//   order).
// * *_dyn_mma_kernel (M > 16): mma.sync.m16n8k32 s8 x s8 -> s32 tiles of
//   64x128 per block, 128 K per stage, eight warps of 32x32.  The s8 B
//   fragment wants four consecutive K bytes of one column, which the
//   N-contiguous tile does not hold: so within a warp's 32 columns the mma
//   column gid of n-tile ni stands for column gid*4 + ni.  A lane then loads
//   one 4-byte word (its 4 columns) from each of 4 K rows and one byte
//   transpose yields its B words for all four n-tiles.  For B8 one k32 step
//   is exactly one quantization group: after it the s32 fragment is
//   converted and FMA'd with the group scale into an f32 accumulator.
// No TMA, wgmma or multi-stage pipeline yet.
#include "common.cuh"

namespace {

// ---------------------------------------------------------------------------
// Split-K CUDA-core kernels (__dp4a)
// ---------------------------------------------------------------------------

// The K-ordered s8 words of a lane's 8 columns at K rows k..k+3 (B7: four
// int8 weight rows).
__device__ __forceinline__ void int8_quads(const int8_t* wrow, int N, uint32_t* q) {
  uint32_t lo[4], hi[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(wrow + (size_t)i * N));
    lo[i] = v.x;
    hi[i] = v.y;
  }
  transpose4x4_bytes(lo);
  transpose4x4_bytes(hi);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    q[j] = lo[j];
    q[4 + j] = hi[j];
  }
}

// The same from two packed int4 byte rows (B8: K rows 2i, 2i+1, 2i+2, 2i+3).
__device__ __forceinline__ void int4_quads(const uint8_t* prow, int N, uint32_t* q) {
  const uint2 a = __ldg(reinterpret_cast<const uint2*>(prow));
  const uint2 b = __ldg(reinterpret_cast<const uint2*>(prow + N));
  uint32_t lo[4] = {nibbles_lo_s8(a.x), nibbles_hi_s8(a.x), nibbles_lo_s8(b.x), nibbles_hi_s8(b.x)};
  uint32_t hi[4] = {nibbles_lo_s8(a.y), nibbles_hi_s8(a.y), nibbles_lo_s8(b.y), nibbles_hi_s8(b.y)};
  transpose4x4_bytes(lo);
  transpose4x4_bytes(hi);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    q[j] = lo[j];
    q[4 + j] = hi[j];
  }
}

// INT4: the packed (K/2, N) int4 weights with (K/32, N) bf16 scales (B8);
// else the (K, N) int8 weights (B7).  Acc is int (B7) or float (B8).
template <bool INT4, int MT, typename Acc>
__global__ void __launch_bounds__(GEMV_LANES* GEMV_KW)
dyn_gemv_kernel(const int8_t* __restrict__ xq, const void* __restrict__ wv,
                const __nv_bfloat16* __restrict__ gscale, Acc* __restrict__ ws, int M, int K,
                int N, int groups_per_split) {
  const int lane = threadIdx.x;
  const int wy = threadIdx.y;
  const int n0 = (blockIdx.x * GEMV_LANES + lane) * GEMV_COLS;
  const int split = blockIdx.y;
  const int m0 = blockIdx.z * MT;
  const int G = K / 32;
  const int g_begin = split * groups_per_split;
  const int g_end = min(G, g_begin + groups_per_split);

  const int8_t* xr[MT];
#pragma unroll
  for (int m = 0; m < MT; ++m) xr[m] = xq + (size_t)min(m0 + m, M - 1) * K;

  Acc acc[MT][GEMV_COLS];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < GEMV_COLS; ++j) acc[m][j] = 0;

  if (n0 < N) {
    for (int g = g_begin + wy; g < g_end; g += GEMV_KW) {
      int dot[MT][GEMV_COLS];
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int j = 0; j < GEMV_COLS; ++j) dot[m][j] = 0;
#pragma unroll 2
      for (int r = 0; r < 8; ++r) {  // K rows g*32 + 4r .. + 3
        uint32_t q[GEMV_COLS];
        if constexpr (INT4)
          int4_quads(static_cast<const uint8_t*>(wv) + (size_t)(g * 16 + 2 * r) * N + n0, N, q);
        else
          int8_quads(static_cast<const int8_t*>(wv) + (size_t)(g * 32 + 4 * r) * N + n0, N, q);
        const int k = g * 32 + 4 * r;
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          const int xw = *reinterpret_cast<const int*>(xr[m] + k);
#pragma unroll
          for (int j = 0; j < GEMV_COLS; ++j) dot[m][j] = __dp4a(xw, (int)q[j], dot[m][j]);
        }
      }
      if constexpr (INT4) {
        const uint4 sv = __ldg(reinterpret_cast<const uint4*>(gscale + (size_t)g * N + n0));
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
          for (int j = 0; j < GEMV_COLS; ++j)
            acc[m][j] = fmaf((float)dot[m][j], s[j], acc[m][j]);
      } else {
#pragma unroll
        for (int m = 0; m < MT; ++m)
#pragma unroll
          for (int j = 0; j < GEMV_COLS; ++j) acc[m][j] += dot[m][j];
      }
    }
  }

  // fixed-order reduction over the K warps
  __shared__ Acc red[MT][GEMV_BN];
  for (int v = GEMV_KW - 1; v >= 0; --v) {
    if (wy == v) {
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int j = 0; j < GEMV_COLS; ++j) {
          const int col = lane * GEMV_COLS + j;
          red[m][col] = (v == GEMV_KW - 1) ? acc[m][j] : red[m][col] + acc[m][j];
        }
    }
    __syncthreads();
  }
  for (int i = wy * GEMV_LANES + lane; i < MT * GEMV_BN; i += GEMV_LANES * GEMV_KW) {
    const int m = i / GEMV_BN, col = i % GEMV_BN;
    const int row = m0 + m, n = blockIdx.x * GEMV_BN + col;
    if (row < M && n < N) ws[((size_t)split * M + row) * N + n] = red[m][col];
  }
}

template <bool INT4, typename Acc>
void launch_dyn_gemv(const int8_t* xq, const void* w, const __nv_bfloat16* gscale, Acc* ws,
                     int M, int K, int N, int nsplit, int gps, cudaStream_t stream) {
  const dim3 block(GEMV_LANES, GEMV_KW);
  const int nb = (N + GEMV_BN - 1) / GEMV_BN;
  if (M == 1)
    dyn_gemv_kernel<INT4, 1, Acc><<<dim3(nb, nsplit, M), block, 0, stream>>>(
        xq, w, gscale, ws, M, K, N, gps);
  else if (M == 2)
    dyn_gemv_kernel<INT4, 2, Acc><<<dim3(nb, nsplit, 1), block, 0, stream>>>(
        xq, w, gscale, ws, M, K, N, gps);
  else if (M <= 4)
    dyn_gemv_kernel<INT4, 4, Acc><<<dim3(nb, nsplit, 1), block, 0, stream>>>(
        xq, w, gscale, ws, M, K, N, gps);
  else
    dyn_gemv_kernel<INT4, 8, Acc><<<dim3(nb, nsplit, (M + 7) / 8), block, 0, stream>>>(
        xq, w, gscale, ws, M, K, N, gps);
}

// ---------------------------------------------------------------------------
// Tensor-core kernels (mma.sync m16n8k32 s8)
// ---------------------------------------------------------------------------

constexpr int MMA_BM = 64;
constexpr int MMA_BN = 128;
constexpr int MMA_BK = 128;              // K per stage: 4 quantization groups
constexpr int TS_STRIDE = MMA_BK + 16;   // bytes per smem row (16-aligned pad)

// INT4: wv is packed (K/2, N) with (K/32, N) bf16 group scales; else int8
// (K, N) with an (N,) f32 scale.
template <bool INT4, typename T>
__global__ void __launch_bounds__(256)
dyn_mma_kernel(const int8_t* __restrict__ xq, const float* __restrict__ sx,
               const void* __restrict__ wv, const void* __restrict__ scale_v,
               T* __restrict__ y, int M, int K, int N) {
  constexpr int W_ROWS = INT4 ? MMA_BK / 2 : MMA_BK;  // weight byte rows per stage
  __shared__ __align__(16) int8_t xs[MMA_BM * TS_STRIDE];
  __shared__ __align__(16) uint8_t wsm[W_ROWS * TS_STRIDE];
  __shared__ float ss[INT4 ? (MMA_BK / 32) * MMA_BN : 1];

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int wm = (warp >> 2) * 32;  // 2 warps along M, 32 rows each
  const int wn = (warp & 3) * 32;   // 4 warps along N, 32 columns each
  const int m_base = blockIdx.y * MMA_BM;
  const int n_base = blockIdx.x * MMA_BN;
  const int G = K / 32;
  const uint8_t* w = static_cast<const uint8_t*>(wv);
  const int w_rows_total = INT4 ? K / 2 : K;

  int iacc[2][4][4];    // B7: the int32 accumulator
  float facc[2][4][4];  // B8: the f32 sum of scaled group dots
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        iacc[mi][ni][e] = 0;
        facc[mi][ni][e] = 0.f;
      }

  for (int k0 = 0; k0 < K; k0 += MMA_BK) {
    for (int i = tid; i < MMA_BM * (MMA_BK / 16); i += 256) {
      const int r = i / (MMA_BK / 16), c = (i % (MMA_BK / 16)) * 16;
      const int row = m_base + r, k = k0 + c;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (row < M && k < K) v = *reinterpret_cast<const uint4*>(xq + (size_t)row * K + k);
      *reinterpret_cast<uint4*>(xs + r * TS_STRIDE + c) = v;
    }
    const int wr0 = INT4 ? k0 / 2 : k0;
    for (int i = tid; i < W_ROWS * (MMA_BN / 16); i += 256) {
      const int r = i / (MMA_BN / 16), c = (i % (MMA_BN / 16)) * 16;
      const int kr = wr0 + r, n = n_base + c;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (kr < w_rows_total && n < N) v = *reinterpret_cast<const uint4*>(w + (size_t)kr * N + n);
      *reinterpret_cast<uint4*>(wsm + r * TS_STRIDE + c) = v;
    }
    if constexpr (INT4) {
      const __nv_bfloat16* gs = static_cast<const __nv_bfloat16*>(scale_v);
      for (int i = tid; i < (MMA_BK / 32) * MMA_BN; i += 256) {
        const int gi = i / MMA_BN, c = i % MMA_BN;
        const int g = k0 / 32 + gi, n = n_base + c;
        ss[i] = (g < G && n < N) ? __bfloat162float(gs[(size_t)g * N + n]) : 0.f;
      }
    }
    __syncthreads();

#pragma unroll
    for (int ks = 0; ks < MMA_BK / 32; ++ks) {
      const int kk = ks * 32;
      uint32_t a[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int8_t* base = xs + (wm + mi * 16 + gid) * TS_STRIDE + kk + tig * 4;
        a[mi][0] = *reinterpret_cast<const uint32_t*>(base);
        a[mi][1] = *reinterpret_cast<const uint32_t*>(base + 8 * TS_STRIDE);
        a[mi][2] = *reinterpret_cast<const uint32_t*>(base + 16);
        a[mi][3] = *reinterpret_cast<const uint32_t*>(base + 8 * TS_STRIDE + 16);
      }
      // b[ni][h]: mma column gid of n-tile ni = warp column gid*4 + ni, at K
      // bytes kk + 16h + tig*4 .. + 3
      uint32_t b[4][2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint32_t q[4];
        if constexpr (INT4) {
          const uint8_t* p = wsm + ((kk + 16 * h) / 2 + tig * 2) * TS_STRIDE + wn + gid * 4;
          const uint32_t w0 = *reinterpret_cast<const uint32_t*>(p);
          const uint32_t w1 = *reinterpret_cast<const uint32_t*>(p + TS_STRIDE);
          q[0] = nibbles_lo_s8(w0);
          q[1] = nibbles_hi_s8(w0);
          q[2] = nibbles_lo_s8(w1);
          q[3] = nibbles_hi_s8(w1);
        } else {
          const uint8_t* p = wsm + (kk + 16 * h + tig * 4) * TS_STRIDE + wn + gid * 4;
#pragma unroll
          for (int i = 0; i < 4; ++i) q[i] = *reinterpret_cast<const uint32_t*>(p + i * TS_STRIDE);
        }
        transpose4x4_bytes(q);
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) b[ni][h] = q[ni];
      }
      if constexpr (INT4) {
        int part[2][4][4];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
            for (int e = 0; e < 4; ++e) part[mi][ni][e] = 0;
            mma_s8_16832(part[mi][ni], a[mi], b[ni]);
          }
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          const float s0 = ss[ks * MMA_BN + wn + (tig * 2) * 4 + ni];
          const float s1 = ss[ks * MMA_BN + wn + (tig * 2 + 1) * 4 + ni];
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) {
            facc[mi][ni][0] = fmaf((float)part[mi][ni][0], s0, facc[mi][ni][0]);
            facc[mi][ni][1] = fmaf((float)part[mi][ni][1], s1, facc[mi][ni][1]);
            facc[mi][ni][2] = fmaf((float)part[mi][ni][2], s0, facc[mi][ni][2]);
            facc[mi][ni][3] = fmaf((float)part[mi][ni][3], s1, facc[mi][ni][3]);
          }
        }
      } else {
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int ni = 0; ni < 4; ++ni) mma_s8_16832(iacc[mi][ni], a[mi], b[ni]);
      }
    }
    __syncthreads();
  }

  // d0/d1: row gid, mma columns tig*2 and tig*2+1; d2/d3: row gid+8
#pragma unroll
  for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = n_base + wn + (tig * 2 + e) * 4 + ni;
      if (col >= N) continue;
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int row = m_base + wm + mi * 16 + gid + 8 * half;
          if (row >= M) continue;
          float v;
          if constexpr (INT4) {
            v = facc[mi][ni][2 * half + e] * sx[row];
          } else {
            const float* sc = static_cast<const float*>(scale_v);
            v = ((float)iacc[mi][ni][2 * half + e] * sx[row]) * sc[col];
          }
          y[(size_t)row * N + col] = from_f32<T>(v);
        }
      }
    }
  }
}

template <bool INT4, typename T>
void launch_dyn_mma(const int8_t* xq, const float* sx, const void* w, const void* scale, T* y,
                    int M, int K, int N, cudaStream_t stream) {
  const dim3 grid((N + MMA_BN - 1) / MMA_BN, (M + MMA_BM - 1) / MMA_BM);
  dyn_mma_kernel<INT4, T><<<grid, 256, 0, stream>>>(xq, sx, w, scale, y, M, K, N);
}

}  // namespace

extern "C" {

// B7, split-K __dp4a kernel.  xq (M,K) s8, sx (M,) f32, w (K,N) s8, scale (N,)
// f32, y (M,N) bf16 (y_is_bf16) or f32; ws holds nsplit * M * N int32;
// K % 32 == 0, N % 8 == 0, 16-byte aligned pointers (checked by the wrapper).
int chatglm_int8_dyn_gemv(const void* xq, const void* sx, const void* w, const void* scale,
                          void* y, void* ws, int M, int K, int N, int y_is_bf16, int nsplit,
                          int groups_per_split, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  int* part = static_cast<int*>(ws);
  launch_dyn_gemv<false, int>(static_cast<const int8_t*>(xq), w, nullptr, part, M, K, N, nsplit,
                              groups_per_split, s);
  // y = (float(acc) * sx[m]) * scale[n]: the plain version's order
  const float* sxf = static_cast<const float*>(sx);
  const float* sc = static_cast<const float*>(scale);
  if (y_is_bf16)
    splitk_reduce<int, __nv_bfloat16>(part, sxf, sc, static_cast<__nv_bfloat16*>(y), nsplit, M, N,
                                      s);
  else
    splitk_reduce<int, float>(part, sxf, sc, static_cast<float*>(y), nsplit, M, N, s);
  return (int)cudaGetLastError();
}

// B7, tensor-core kernel; K % 32 == 0, N % 16 == 0, aligned pointers.
int chatglm_int8_dyn_mma(const void* xq, const void* sx, const void* w, const void* scale,
                         void* y, int M, int K, int N, int y_is_bf16, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int8_t* x8 = static_cast<const int8_t*>(xq);
  const float* sxf = static_cast<const float*>(sx);
  if (y_is_bf16)
    launch_dyn_mma<false>(x8, sxf, w, scale, static_cast<__nv_bfloat16*>(y), M, K, N, s);
  else
    launch_dyn_mma<false>(x8, sxf, w, scale, static_cast<float*>(y), M, K, N, s);
  return (int)cudaGetLastError();
}

// B8, split-K __dp4a kernel.  packed (K/2,N) u8 tpu order, scale (K/32,N)
// bf16; ws holds nsplit * M * N floats; K % 32 == 0, N % 8 == 0.
int chatglm_int4_dyn_gemv(const void* xq, const void* sx, const void* packed, const void* scale,
                          void* y, void* ws, int M, int K, int N, int y_is_bf16, int nsplit,
                          int groups_per_split, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  float* part = static_cast<float*>(ws);
  launch_dyn_gemv<true, float>(static_cast<const int8_t*>(xq), packed,
                               static_cast<const __nv_bfloat16*>(scale), part, M, K, N, nsplit,
                               groups_per_split, s);
  // y = (sum of the scaled group dots) * sx[m]
  const float* sxf = static_cast<const float*>(sx);
  if (y_is_bf16)
    splitk_reduce<float, __nv_bfloat16>(part, sxf, nullptr, static_cast<__nv_bfloat16*>(y),
                                        nsplit, M, N, s);
  else
    splitk_reduce<float, float>(part, sxf, nullptr, static_cast<float*>(y), nsplit, M, N, s);
  return (int)cudaGetLastError();
}

// B8, tensor-core kernel; K % 32 == 0, N % 16 == 0, aligned pointers.
int chatglm_int4_dyn_mma(const void* xq, const void* sx, const void* packed, const void* scale,
                         void* y, int M, int K, int N, int y_is_bf16, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int8_t* x8 = static_cast<const int8_t*>(xq);
  const float* sxf = static_cast<const float*>(sx);
  if (y_is_bf16)
    launch_dyn_mma<true>(x8, sxf, packed, scale, static_cast<__nv_bfloat16*>(y), M, K, N, s);
  else
    launch_dyn_mma<true>(x8, sxf, packed, scale, static_cast<float*>(y), M, K, N, s);
  return (int)cudaGetLastError();
}

}  // extern "C"

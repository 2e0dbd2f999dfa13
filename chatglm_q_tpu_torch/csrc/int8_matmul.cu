// int8 weight-only matmul: y (M,N) = (x (M,K) @ w (K,N) int8) * scale (N,).
//
// Replaces the TPU kernel chatglm_q_tpu/ops/pallas_matmul.py:_int8_fwd_kernel
// (its wrappers int8_matmul_pallas and int8_matmul_pallas_idx).  The per-N
// scale commutes with the K reduction, so, as there, it multiplies the f32
// accumulator once in the epilogue; the only per-weight work is the int8 to
// float convert, which is exact (|q| <= 128).  With bf16 activations the
// products are exact, so the kernels differ from the plain version
// (ops/int8_matmul.py::int8_matmul_plain) only in the order of the f32 sums.
// The TPU's "bt" scheme (a workaround for the TPU's int-to-float convert) is
// not carried: the card converts natively.
//
// * int8_gemv_kernel (small M, decode): bound by bytes — every weight byte is
//   read once and there are two operations per byte.  The split-K design of
//   int4_matmul.cu's gemv: each lane reads 8 neighbouring N bytes of a weight
//   row (one 8-byte load; a warp reads 256 contiguous bytes), K is split
//   across blocks (grid.y) and the 4 warps of a block in chunks of 32 rows,
//   warps reduce in shared memory in a fixed order, and splitk_reduce_kernel
//   (common.cuh) sums the f32 partials of the splits in a fixed order,
//   applies the scale and casts.  Deterministic, no atomics.
// * int8_mma_kernel (bf16, large M, prefill): bound by operations.  A 64x128
//   output tile per block; each stage copies 128 K-columns of x and 128 int8
//   weight rows into shared memory, and eight warps run mma.sync.m16n8k16
//   (bf16 in, f32 out).  The B fragment holds K rows (2t, 2t+1) and
//   (2t+8, 2t+9) of one column: each lane converts those four bytes to bf16
//   in registers.  No TMA, wgmma or multi-stage pipeline yet.
//
// The backward kernels (B13) replace pallas_matmul.py:_int8_t_kernel
// (int8_matmul_t_pallas): grad_x (M,K) = (g (M,N) * scale) @ w (K,N)ᵀ, the
// contraction over N.  As on the TPU, the per-N scale folds into g in g's
// dtype (rounded to bf16 under bf16) before the dot, so the kernels differ
// from the plain version (ops/int8_matmul.py::int8_matmul_t_plain) only in
// the order of the f32 sums.  Output column k reads weight row k, which is
// N-contiguous: no second weight layout is kept.
// Both are common.cuh's transposed bodies over Int8TView:
// * t_gemv_kernel<Int8TView> (f32 g, or M <= 16): bound by the weight bytes;
//   one warp per 4 output columns, 8-byte loads along N.
// * t_mma_kernel<Int8TView> (bf16, M > 16, training's M = B*S): bound by
//   operations; 64x128 output tiles of mma.sync.m16n8k16 over 64-column
//   stages of N, the int8 rows converted to bf16 in shared memory.
#include "common.cuh"

namespace {

__device__ __forceinline__ float s8_at(uint32_t w, int j) {
  return (float)(int8_t)((w >> (8 * j)) & 0xFFu);
}

template <typename T, int MT>
__global__ void __launch_bounds__(GEMV_LANES* GEMV_KW)
int8_gemv_kernel(const T* __restrict__ x, const int8_t* __restrict__ w, float* __restrict__ ws,
                 int M, int K, int N, int chunks_per_split) {
  const int lane = threadIdx.x;
  const int wy = threadIdx.y;
  const int n0 = (blockIdx.x * GEMV_LANES + lane) * GEMV_COLS;
  const int split = blockIdx.y;
  const int m0 = blockIdx.z * MT;
  const int C = K / 32;  // 32-row chunks of K
  const int c_begin = split * chunks_per_split;
  const int c_end = min(C, c_begin + chunks_per_split);

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
    for (int c = c_begin + wy; c < c_end; c += GEMV_KW) {
      const int8_t* wrow = w + (size_t)c * 32 * N + n0;
#pragma unroll 4
      for (int r = 0; r < 16; ++r) {
        const uint2 a = __ldg(reinterpret_cast<const uint2*>(wrow + (size_t)(2 * r) * N));
        const uint2 b = __ldg(reinterpret_cast<const uint2*>(wrow + (size_t)(2 * r + 1) * N));
        float wa[GEMV_COLS], wb[GEMV_COLS];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          wa[j] = s8_at(a.x, j);
          wa[4 + j] = s8_at(a.y, j);
          wb[j] = s8_at(b.x, j);
          wb[4 + j] = s8_at(b.y, j);
        }
        const int k = c * 32 + 2 * r;
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          const float2 xv = load_pair(xr[m] + k);
#pragma unroll
          for (int j = 0; j < GEMV_COLS; ++j) {
            acc[m][j] = fmaf(xv.x, wa[j], acc[m][j]);
            acc[m][j] = fmaf(xv.y, wb[j], acc[m][j]);
          }
        }
      }
    }
  }

  // fixed-order reduction over the K warps
  __shared__ float red[MT][GEMV_BN];
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

template <typename T, int MT>
void launch_gemv(const T* x, const int8_t* w, float* ws, int M, int K, int N, int nsplit,
                 int cps, cudaStream_t stream) {
  const dim3 block(GEMV_LANES, GEMV_KW);
  const dim3 grid((N + GEMV_BN - 1) / GEMV_BN, nsplit, (M + MT - 1) / MT);
  int8_gemv_kernel<T, MT><<<grid, block, 0, stream>>>(x, w, ws, M, K, N, cps);
}

template <typename T>
void gemv(const T* x, const int8_t* w, const float* scale, T* y, float* ws, int M, int K, int N,
          int nsplit, int cps, cudaStream_t stream) {
  if (M == 1)
    launch_gemv<T, 1>(x, w, ws, M, K, N, nsplit, cps, stream);
  else if (M == 2)
    launch_gemv<T, 2>(x, w, ws, M, K, N, nsplit, cps, stream);
  else if (M <= 4)
    launch_gemv<T, 4>(x, w, ws, M, K, N, nsplit, cps, stream);
  else
    launch_gemv<T, 8>(x, w, ws, M, K, N, nsplit, cps, stream);
  splitk_reduce<float, T>(ws, nullptr, scale, y, nsplit, M, N, stream);
}

// ---------------------------------------------------------------------------
// Tensor-core kernel (bf16 activations, large M)
// ---------------------------------------------------------------------------

constexpr int MMA_BM = 64;
constexpr int MMA_BN = 128;
constexpr int MMA_BK = 128;
constexpr int XS_STRIDE = MMA_BK + 8;   // bf16 per x row in smem (pad: no bank conflicts)
constexpr int WS_STRIDE = MMA_BN + 16;  // bytes per weight row in smem (16-aligned pad)

__device__ __forceinline__ uint32_t s8_pair_bf16(int8_t lo, int8_t hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn((float)lo, (float)hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__global__ void __launch_bounds__(256)
int8_mma_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ w,
                const float* __restrict__ scale, __nv_bfloat16* __restrict__ y, int M, int K,
                int N) {
  __shared__ __align__(16) __nv_bfloat16 xs[MMA_BM * XS_STRIDE];
  __shared__ __align__(16) int8_t wsm[MMA_BK * WS_STRIDE];

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int wm = (warp >> 2) * 32;  // 2 warps along M, 32 rows each
  const int wn = (warp & 3) * 32;   // 4 warps along N, 32 columns each
  const int m_base = blockIdx.y * MMA_BM;
  const int n_base = blockIdx.x * MMA_BN;

  float acc[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

  for (int k0 = 0; k0 < K; k0 += MMA_BK) {
    for (int i = tid; i < MMA_BM * (MMA_BK / 8); i += 256) {
      const int r = i / (MMA_BK / 8), c = (i % (MMA_BK / 8)) * 8;
      const int row = m_base + r, k = k0 + c;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (row < M && k < K) v = *reinterpret_cast<const uint4*>(x + (size_t)row * K + k);
      *reinterpret_cast<uint4*>(xs + r * XS_STRIDE + c) = v;
    }
    for (int i = tid; i < MMA_BK * (MMA_BN / 16); i += 256) {
      const int r = i / (MMA_BN / 16), c = (i % (MMA_BN / 16)) * 16;
      const int k = k0 + r, n = n_base + c;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (k < K && n < N) v = *reinterpret_cast<const uint4*>(w + (size_t)k * N + n);
      *reinterpret_cast<uint4*>(wsm + r * WS_STRIDE + c) = v;
    }
    __syncthreads();

#pragma unroll 2
    for (int kk = 0; kk < MMA_BK; kk += 16) {
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
        const int8_t* pb = wsm + (kk + tig * 2) * WS_STRIDE + wn + ni * 8 + gid;
        b[ni][0] = s8_pair_bf16(pb[0], pb[WS_STRIDE]);
        b[ni][1] = s8_pair_bf16(pb[8 * WS_STRIDE], pb[9 * WS_STRIDE]);
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_bf16_16816(acc[mi][ni], a[mi], b[ni]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int ni = 0; ni < 4; ++ni) {
    const int col = n_base + wn + ni * 8 + tig * 2;
    if (col >= N) continue;  // N % 16 == 0, so col + 1 < N as well
    const float s0 = scale[col], s1 = scale[col + 1];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      const int row = m_base + wm + mi * 16 + gid;
      if (row < M)
        *reinterpret_cast<__nv_bfloat162*>(y + (size_t)row * N + col) =
            __floats2bfloat162_rn(acc[mi][ni][0] * s0, acc[mi][ni][1] * s1);
      if (row + 8 < M)
        *reinterpret_cast<__nv_bfloat162*>(y + (size_t)(row + 8) * N + col) =
            __floats2bfloat162_rn(acc[mi][ni][2] * s0, acc[mi][ni][3] * s1);
    }
  }
}

// ---------------------------------------------------------------------------
// Transposed kernels (B13): grad_x (M, K) = (g (M, N) * scale) @ w (K, N)ᵀ
// ---------------------------------------------------------------------------

// The int8 weight view of common.cuh's transposed kernels: the scale folds
// into g; the int8 rows convert to floats / bf16 exactly.
struct Int8TView {
  const int8_t* w;
  const float* scale;
  static constexpr int kCols = 4;
  static constexpr bool kFoldG = true;

  template <typename T>
  __device__ __forceinline__ void fold(int n, float* s) const {
    load8(scale + n, s);
#pragma unroll
    for (int j = 0; j < 8; ++j) s[j] = round_to<T>(s[j]);  // the scale in g's dtype
  }
  template <typename T>
  __device__ __forceinline__ void cols(int k0, int n, int N, float (&wq)[kCols][8]) const {
#pragma unroll
    for (int r = 0; r < kCols; ++r) {
      const uint2 wv = __ldg(reinterpret_cast<const uint2*>(w + (size_t)(k0 + r) * N + n));
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        wq[r][j] = s8_at(wv.x, j);
        wq[r][4 + j] = s8_at(wv.y, j);
      }
    }
  }
  __device__ __forceinline__ const float* fold_ptr() const { return scale; }
  __device__ __forceinline__ void stage_b(__nv_bfloat16* bs, int k_base, int n0, int K,
                                          int N) const {
    const int8_t* __restrict__ wr = w;
    for (int i = threadIdx.x; i < TMM_BK * (TMM_BN / 16); i += TMM_THREADS) {
      const int r = i / (TMM_BN / 16), c = (i % (TMM_BN / 16)) * 16;
      const int k = k_base + r, n = n0 + c;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (k < K && n < N) v = *reinterpret_cast<const uint4*>(wr + (size_t)k * N + n);
      const int8_t* q = reinterpret_cast<const int8_t*>(&v);
      uint32_t o[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) o[j] = s8_pair_bf16(q[2 * j], q[2 * j + 1]);
      *reinterpret_cast<uint4*>(bs + r * TMM_STRIDE + c) = make_uint4(o[0], o[1], o[2], o[3]);
      *reinterpret_cast<uint4*>(bs + r * TMM_STRIDE + c + 8) = make_uint4(o[4], o[5], o[6], o[7]);
    }
  }
};

}  // namespace

extern "C" {

// Split-K CUDA-core kernel.  x is bf16 (x_is_bf16) or f32, y the same type;
// scale f32; ws holds nsplit * M * N floats; K % 32 == 0, N % 8 == 0,
// 16-byte aligned pointers (checked by the wrapper).
int chatglm_int8_gemv(const void* x, const void* w, const void* scale, void* y, void* ws, int M,
                      int K, int N, int x_is_bf16, int nsplit, int chunks_per_split,
                      void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int8_t* wq = static_cast<const int8_t*>(w);
  const float* sc = static_cast<const float*>(scale);
  float* part = static_cast<float*>(ws);
  if (x_is_bf16)
    gemv<__nv_bfloat16>(static_cast<const __nv_bfloat16*>(x), wq, sc,
                        static_cast<__nv_bfloat16*>(y), part, M, K, N, nsplit, chunks_per_split, s);
  else
    gemv<float>(static_cast<const float*>(x), wq, sc, static_cast<float*>(y), part, M, K, N,
                nsplit, chunks_per_split, s);
  return (int)cudaGetLastError();
}

// Tensor-core kernel, bf16 only; K % 32 == 0, N % 16 == 0, aligned pointers.
int chatglm_int8_mma(const void* x, const void* w, const void* scale, void* y, int M, int K,
                     int N, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const dim3 grid((N + MMA_BN - 1) / MMA_BN, (M + MMA_BM - 1) / MMA_BM);
  int8_mma_kernel<<<grid, 256, 0, s>>>(static_cast<const __nv_bfloat16*>(x),
                                       static_cast<const int8_t*>(w),
                                       static_cast<const float*>(scale),
                                       static_cast<__nv_bfloat16*>(y), M, K, N);
  return (int)cudaGetLastError();
}

// B13, CUDA-core form: out (M, K) = (g (M, N) * scale (N,)) @ w (K, N)ᵀ.  g
// bf16 (g_is_bf16) or f32, out the same; N % 8 == 0, aligned pointers.
int chatglm_int8_t_gemv(const void* g, const void* w, const void* scale, void* out, int M, int K,
                        int N, int g_is_bf16, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const Int8TView wv{static_cast<const int8_t*>(w), static_cast<const float*>(scale)};
  if (g_is_bf16)
    t_gemv(static_cast<const __nv_bfloat16*>(g), wv, static_cast<__nv_bfloat16*>(out), M, K, N,
           s);
  else
    t_gemv(static_cast<const float*>(g), wv, static_cast<float*>(out), M, K, N, s);
  return (int)cudaGetLastError();
}

// B13, tensor-core form, bf16 only; K % 32 == 0, N % 16 == 0, aligned pointers.
int chatglm_int8_t_mma(const void* g, const void* w, const void* scale, void* out, int M, int K,
                       int N, void* stream) {
  const Int8TView wv{static_cast<const int8_t*>(w), static_cast<const float*>(scale)};
  t_mma(static_cast<const __nv_bfloat16*>(g), wv, static_cast<__nv_bfloat16*>(out), M, K, N,
        reinterpret_cast<cudaStream_t>(stream));
  return (int)cudaGetLastError();
}

}  // extern "C"

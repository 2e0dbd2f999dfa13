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
// The activations (and the output) are bf16, f16 or f32; the C entries take
// common.cuh's dtype code.  The tensor-core kernels are templates over the
// 16-bit element E: their f16 forms (a float16 checkpoint's activations)
// run mma.sync / wgmma .f32.f16.f16, each weight byte converted exactly to
// f16 by the bias trick f16's 11 significant bits allow (common.cuh:
// s8x4_f16x2), the f32 scale on the f32 sum as in bf16.  This is the
// Pallas kernel's function in f16 (pallas_matmul.py:_int8_fwd_kernel's
// convert scheme: q cast to x's dtype, the f32 scale on the f32
// accumulator); the JAX package's jnp fallback (linear.py:65-67) rounds
// the scale and w·s to x's dtype instead: the same function, rounded
// elsewhere.
//
// * int8_splitk_mma_kernel (bf16 / f16, M <= MMA_MIN_M = 16: decode at batch
//   1-16):
//   bound by the weight bytes (one byte a weight, two operations a byte per
//   row of x).  common.cuh's split-K body, B1's decode design, over
//   Int8SkView: mma.sync m16n8k16 bf16 with the weights as A and x's rows as
//   B (8 rows an m-tile, zero past M), so each weight converts once whatever
//   M is, and the conversion, not the products, is the CUDA cores' work.  A
//   CUDA-core loop would convert each byte by I2F, which issues at 16 a
//   clock on an SM while the card streams ~14.5 bytes a clock an SM: here
//   one PRMT pairs two K rows' bytes of a column pair and s8x4_bf16x2 turns
//   four bytes into two exact bf16x2 registers by PRMT, FADD and PRMT (bf16
//   holds 8 significant bits, too few for a bias trick of its own).  Each
//   lane reads 16 contiguous bytes (8 where N is narrow, where 16 would
//   leave a warp fewer than four groups, or where M > 8: splitk_plan) of
//   eight K rows a group by ld.global.nc into two alternating register sets; K
//   splits fill the card at a narrow N and merge in the same launch (the
//   last block of a column tile to arrive sums them in split order, applies
//   the scale, writes y and resets its counter: deterministic, graph-safe).
//   One f32 mma accumulator over a split's whole K would drift from
//   round-to-nearest (~17 x 2^-23 of sum|terms| over 4096 k16 steps), so
//   each 32-row group's products go to a fresh partial, added to the f32
//   sum.
// * The f32 forms (f32 x and y) run both tensor-core kernels exactly on x's
//   three bf16 pieces (common.cuh: split_bf16x3; each piece times an int8
//   weight is exact in the f32 accumulator): int8_splitk_f32_kernel, sk_body
//   over Int8SkF32View (the pieces staged as three rows an x row: see
//   int4_matmul.cu), and int8_wgmma_kernel over Int8FwdF32View, which reads
//   the (3, M, K) pieces that chatglm_split_bf16x3 writes, three tiles a
//   stage into the stage's fresh partial, lo's wgmmas first; the scale on
//   the f32 sum as in bf16.
// * int8_gemv_kernel (bf16 / f16 / f32 above the split-K limits where N %
//   16 != 0; callable by name for the f32 forms' comparison): the CUDA-core
//   split-K form, each
//   lane reading 8 neighbouring N bytes of a weight row (one 8-byte load; a
//   warp reads 256 contiguous bytes), K split across blocks (grid.y) and the
//   4 warps of a block in chunks of 32 rows, warps reduced in shared memory
//   in a fixed order, and splitk_reduce_kernel (common.cuh) summing the f32
//   partials of the splits in a fixed order, applying the scale and
//   casting.  Deterministic, no atomics.
// * int8_wgmma_kernel (bf16 / f16, M > MMA_MIN_M: prefill, engine chunks,
//   training): bound by operations.  common.cuh's Hopper mainloop (B1's
//   persistent TMA + mbarrier ring and producer warpgroup, wgmma with the
//   weights as A from registers and x's rows as B from the swizzled tile,
//   contraction splits merged in the launch; wg_plan picks the tile and
//   splits, so kv_proj's 4 column tiles still fill the card), the scale on
//   the f32 sum in the epilogue.  A K pair of one column
//   is two bytes N apart: D rows gid and gid + 8 are columns c and c + 1,
//   so two u16 loads (K rows k and k + 1 at c, c + 1) interleaved by one
//   PRMT hold both rows' pairs, converted exactly through f32
//   (s8x4_bf16x2: bf16 holds 8 significant bits, too few for a bias trick).
//
// The backward kernels (B13) replace pallas_matmul.py:_int8_t_kernel
// (int8_matmul_t_pallas): grad_x (M,K) = (g (M,N) * scale) @ w (K,N)ᵀ, the
// contraction over N.  As on the TPU, the per-N scale folds into g in g's
// dtype (rounded to bf16 under bf16) before the dot, so the kernels differ
// from the plain version (ops/int8_matmul.py::int8_matmul_t_plain) only in
// the order of the f32 sums.  Output column k reads weight row k, which is
// N-contiguous: no second weight layout is kept.  g may be bf16 or f16 (a
// float16 checkpoint's fine-tuning): the tensor-core kernels take Int8TView<E>
// over g's element E, f16(g · f16(s)) and the int8 weights exactly in f16.
// All three are common.cuh's transposed bodies over Int8TView:
// * t_splitk_mma_kernel<Int8TView> (bf16 / f16 g, M <= MMA_MIN_M = 16: a
//   training step of <= 16 tokens; and at any M where N % 16 != 0): bound by the
//   weight bytes (one byte a weight, two operations a byte per row of g).
//   mma.sync m16n8k16 with 16 weight rows as A straight from the
//   N-contiguous rows (each u16 of two neighbouring bytes one exact bf16x2
//   register, four of them from one 16-byte load a row) and g's rows as B
//   from shared memory, so each weight converts once whatever M is; the
//   contraction split over blocks so that every linear fills the card, the
//   splits merged in the launch; the scale folded into g as it is staged.
// * t_gemv_kernel<Int8TView> (f32 g): bound by the weight bytes; one warp
//   per 4 output columns, 8-byte loads along N, IEEE f32 sums (no TF32).
// * t_wgmma_kernel<Int8TView> (bf16 / f16, M > 16, training's M = B*S): bound by
//   operations; the Hopper mainloop above with the weight rows as A (each
//   u16 load one exact bf16x2 register) and the scale folded into each g
//   stage in shared memory before its wgmmas (Int8TView::fold_tile).
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
  splitk_reduce<T>(ws, scale, y, nsplit, M, N, stream);
}

// ---------------------------------------------------------------------------
// Split-K tensor-core kernel (bf16 / f16 activations, M <= MMA_MIN_M: decode)
// ---------------------------------------------------------------------------

// B6's view of common.cuh's split-K body.  A group is Int8SkGroup: K rows
// 8t..8t+7 of the lane's columns.  K half h (the mma's k16 step) takes rows
// 4h, 4h + 1 (A regs 0/1 with x's elements 8t + 4h, + 1 as B reg 0) and 4h
// + 2, 4h + 3 (A regs 2/3, B reg 1).  Tile j's columns 2j, 2j + 1 are bytes
// p, p + 1 (p = 2 (j & 1)) of word j / 2 of each row: one PRMT interleaves
// two rows' pairs, (r0.c, r1.c, r0.c1, r1.c1), and s8x4_bf16x2 makes them A
// registers 0 and 1 (or 2 and 3).  Each group's products go to a fresh f32
// partial (two k16 steps), added to the accumulator; the scale multiplies
// the merged sum.  E: x's element, bf16 or f16.
template <typename E>
struct Int8SkView {
  using X = E;
  using Acc = float;
  template <int COLS>
  using Group = Int8SkGroup<COLS>;
  using Lane = const int8_t*;
  const int8_t* w;
  const float* scale;

  __device__ __forceinline__ Lane lane(int n) const { return w + n; }
  template <int COLS>
  __device__ __forceinline__ void load(Int8SkGroup<COLS>& d, Lane wcol, int g, int t, int N,
                                       bool ok) const {
    int8_sk_load<COLS>(d, wcol, g, t, N, ok);
  }
  template <int MT, int COLS>
  __device__ __forceinline__ void group(const Int8SkGroup<COLS>& d, const E* xs,
                                        int xs_stride, int kl, int M,
                                        float (&acc)[MT][COLS / 2][4]) const {
    const int lane = threadIdx.x & 31, gid = lane >> 2, t = lane & 3;
    uint4 b[MT];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int row = mt * 8 + gid;
      b[mt] = row < M ? *reinterpret_cast<const uint4*>(xs + row * xs_stride + kl + 8 * t)
                      : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int j = 0; j < COLS / 2; ++j) {
      const int q = j >> 1;
      const uint32_t sel = (j & 1) ? 0x7362u : 0x5140u;
      float part[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[mt][e] = 0.f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint32_t a[4];
        s8x4_pair<E>(__byte_perm(d.w[4 * h][q], d.w[4 * h + 1][q], sel), a[0], a[1]);
        s8x4_pair<E>(__byte_perm(d.w[4 * h + 2][q], d.w[4 * h + 3][q], sel), a[2], a[3]);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const uint32_t bb[2] = {h ? b[mt].z : b[mt].x, h ? b[mt].w : b[mt].y};
          mma_16816<E>(part[mt], a, bb);
        }
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][j][e] += part[mt][e];
    }
  }
  template <typename T>
  __device__ __forceinline__ T out(float v, int, int n) const {
    return from_f32<T>(v * __ldg(scale + n));
  }
};

template <int MT, int COLS, typename E>
__global__ void __launch_bounds__(SK_THREADS, 4)
int8_splitk_mma_kernel(const E* __restrict__ x, const int8_t* __restrict__ w,
                       const float* __restrict__ scale, E* __restrict__ y,
                       float* __restrict__ ws, int* __restrict__ arrivals, int M, int K, int N,
                       int gps, int cg) {
  extern __shared__ __align__(16) unsigned char sk_smem[];
  sk_body<Int8SkView<E>, E, MT, COLS>(Int8SkView<E>{w, scale}, x, y, ws, arrivals, M, K, N, gps,
                                      cg, sk_smem);
}

// The f32 form's view (f32 x and y): sk_body stages x's three bf16 pieces
// as three rows an x row, which the bf16 view's group takes as 3M rows.
struct Int8SkF32View : Int8SkView<__nv_bfloat16> {
  using X = float;
};

template <int MT, int COLS>
__global__ void __launch_bounds__(SK_THREADS, 4)
int8_splitk_f32_kernel(const float* __restrict__ x, const int8_t* __restrict__ w,
                       const float* __restrict__ scale, float* __restrict__ y,
                       float* __restrict__ ws, int* __restrict__ arrivals, int M, int K, int N,
                       int gps, int cg) {
  extern __shared__ __align__(16) unsigned char sk_smem[];
  sk_body<Int8SkF32View, float, MT, COLS>(Int8SkF32View{{w, scale}}, x, y, ws, arrivals, M, K, N,
                                          gps, cg, sk_smem);
}

// ---------------------------------------------------------------------------
// Hopper tensor-core kernel (bf16 / f16 activations, M > MMA_MIN_M)
// ---------------------------------------------------------------------------

// B6's view of common.cuh's mainloop.  A stage: 64 K rows x 128 columns of w
// (128B swizzle: 16-byte chunk q of row r sits at chunk q ^ (r & 7)).  D
// rows gid and gid + 8 of a warp are columns c and c + 1, so the u16 loads
// of K rows k and k + 1 at columns c, c + 1 hold both rows' K pairs: one
// PRMT interleaves them and s8x4_bf16x2 converts them exactly.  No scale
// tile: the per-column scale multiplies the f32 sum in the epilogue.  E:
// x's and y's element, bf16 or f16.
template <typename E_>
struct Int8FwdView {
  using E = E_;
  const float* scale;
  static constexpr int kWBytes = WG_STEP * WG_N;
  static constexpr int kSBytes = 0;
  static constexpr int kRowStep = 1;
  static constexpr bool kColScale = true;
  static constexpr bool kFoldG = false;
  __device__ const float* col_scale() const { return scale; }

  __device__ static void tma(const CUtensorMap* wmap, const CUtensorMap*, uint8_t* wdst, uint8_t*,
                             int nt, int s, uint64_t* bar) {
    tma_load_2d(wdst, wmap, nt * WG_N, s * WG_STEP, bar);
  }

  // c: the output column of D row gid; o[i]: its bytes (c, c + 1) in K rows
  // 2t, 2t + 1, 2t + 8, 2t + 9 of k16 step 0 (step h: + 16h rows)
  struct Lane {
    int c, o[4];
  };
  __device__ static Lane lane(int tid) {
    const int wg = tid >> 7, w = (tid >> 5) & 3, gid = (tid >> 2) & 7, t = tid & 3;
    Lane ln;
    ln.c = wg * 64 + 16 * w + 2 * gid;
    const int q = ln.c >> 4;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = 2 * t + (i & 1) + 8 * (i >> 1);
      ln.o[i] = r * WG_N + ((q ^ (r & 7)) << 4) + (ln.c & 15);
    }
    return ln;
  }
  template <int H>
  __device__ __forceinline__ void load(uint32_t (&f)[2][4], const uint8_t* wt, const uint8_t*,
                                       const Lane& ln) const {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const uint8_t* p = wt + (2 * H + i) * 16 * WG_N;
      uint32_t r[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) r[e] = *reinterpret_cast<const uint16_t*>(p + ln.o[e]);
      // (k, c), (k + 1, c), (k, c + 1), (k + 1, c + 1): D row gid's pair, then gid + 8's
      s8x4_pair<E>(__byte_perm(r[0], r[1], 0x5140), f[i][0], f[i][1]);
      s8x4_pair<E>(__byte_perm(r[2], r[3], 0x5140), f[i][2], f[i][3]);
    }
  }
};

// The f32 form: x's three bf16 pieces (a (3, M, K) buffer that
// chatglm_split_bf16x3 writes) as three activation tiles a stage; each half
// stage's wgmmas, lo's, mid's, then hi's, into the stage's fresh partial
// (common.cuh: wg_issue_half); y f32.
struct Int8FwdF32View : Int8FwdView<__nv_bfloat16> {
  static constexpr int kPieces = 3;
  using Y = float;
};

template <int BM, typename V>
__global__ void __launch_bounds__(WG_THREADS, 1)
int8_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                  const __grid_constant__ CUtensorMap wmap, const V v,
                  typename WgForm<V>::Y* __restrict__ y, float* __restrict__ ws,
                  int* __restrict__ arrivals, int M, int N, const WgSchedule sc) {
  extern __shared__ uint8_t wg_smem_raw[];
  wg_body<BM, V>(wg_smem_raw, &xmap, &wmap, &wmap, v, y, ws, arrivals, M, N, sc);
}

template <int BM, typename V>
int launch_wgmma(const CUtensorMap& xmap, const CUtensorMap& wmap, const V& v, void* y, void* ws,
                 void* arrivals, int M, int N, const WgSchedule& sc, int ctas,
                 cudaStream_t stream) {
  constexpr int bytes = WgRingOf<BM, V>::BYTES;
  const cudaError_t opt_in = smem_opt_in<int8_wgmma_kernel<BM, V>>(bytes);
  if (opt_in != cudaSuccess) return (int)opt_in;
  int8_wgmma_kernel<BM, V><<<ctas, WG_THREADS, bytes, stream>>>(
      xmap, wmap, v, static_cast<typename WgForm<V>::Y*>(y), static_cast<float*>(ws),
      static_cast<int*>(arrivals), M, N, sc);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Transposed kernels (B13): grad_x (M, K) = (g (M, N) * scale) @ w (K, N)ᵀ
// ---------------------------------------------------------------------------

// The int8 weight view of common.cuh's transposed kernels: the scale folds
// into g; the int8 rows convert to floats / E (bf16 or f16, g's element)
// exactly.  t_gemv_kernel (f32 g) reads only its floats.
template <typename E_ = __nv_bfloat16>
struct Int8TView {
  using E = E_;
  const int8_t* w;
  const float* scale;
  static constexpr int kCols = 4;
  static constexpr bool kFoldG = true;

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

  // t_splitk_mma_kernel's view.  The warp's 32 rows are two A tiles, rows
  // k0 + 16 rt + gid (D row gid) and + 8 (gid + 8); r[i] holds row k0 + gid
  // + 8 i at the lane's 16 contraction bytes, word s of it (bytes 4s..4s+3)
  // k16 step s's two pairs: one s8x4_pair gives A registers 0 and 2 (or 1
  // and 3), exactly.  The scale, rounded to E, folds into g while it is
  // staged.
  struct TskChunk {
    uint4 r[4];
  };
  template <bool WIDE>
  __device__ __forceinline__ void tsk_load(TskChunk& d, int k0, int n, int N, int valid) const {
    const int gid = (threadIdx.x & 31) >> 2;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      d.r[i] = tsk_ld16<WIDE>(w + (size_t)(k0 + gid + 8 * i) * N + n, valid);
  }
  __device__ __forceinline__ void tsk_frag(const TskChunk& d, int s, int rt,
                                           uint32_t (&a)[4]) const {
    s8x4_pair<E>(word_at(d.r[2 * rt], s), a[0], a[2]);
    s8x4_pair<E>(word_at(d.r[2 * rt + 1], s), a[1], a[3]);
  }
  __device__ static int tsk_row(int rt, int gid, int hi) { return 16 * rt + gid + 8 * hi; }
  __device__ __forceinline__ void tsk_scales(int n, uint32_t (&s)[4]) const {
    const float4 a = __ldg(reinterpret_cast<const float4*>(scale + n));
    const float4 b = __ldg(reinterpret_cast<const float4*>(scale + n + 4));
    s[0] = pack2<E>(a.x, a.y);
    s[1] = pack2<E>(a.z, a.w);
    s[2] = pack2<E>(b.x, b.y);
    s[3] = pack2<E>(b.z, b.w);
  }

  // t_wgmma_kernel's view.  A stage: 128 weight rows (output columns) x 64
  // contraction bytes (64B swizzle: 16-byte chunk h of row r sits at chunk
  // h ^ ((r >> 1) & 3)) and the 64 f32 scales of those contraction columns.
  // D rows gid and gid + 8 are output columns c and c + 8 (neighbouring
  // rows would meet in one bank), each u16 load one A register.  The scale
  // folds into g: the consumers rewrite each g stage in place as E(g *
  // E(s)) before its wgmmas (fold_tile); a pre-pass kernel would cost a
  // launch and an M x N read and write, and g as A from registers an int8
  // -> bf16 B tile written back to shared memory.
  static constexpr int kWBytes = WG_N * WG_STEP;
  static constexpr int kSBytes = WG_STEP * 4;
  static constexpr int kRowStep = 8;
  static constexpr bool kColScale = false;
  __device__ const float* col_scale() const { return nullptr; }

  __device__ static void tma(const CUtensorMap* wmap, const CUtensorMap* smap, uint8_t* wdst,
                             uint8_t* sdst, int nt, int s, uint64_t* bar) {
    tma_load_2d(wdst, wmap, s * WG_STEP, nt * WG_N, bar);
    tma_load_2d(sdst, smap, s * WG_STEP, 0, bar);
  }
  static bool maps(PFN_cuTensorMapEncodeTiled_v12000 encode, CUtensorMap* wmap, CUtensorMap* smap,
                   const void* w, const void* scale, int K, int N) {
    return tensor_map_2d(encode, wmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, w, K, N, (size_t)N, WG_N,
                         WG_STEP, CU_TENSOR_MAP_SWIZZLE_64B) &&
           tensor_map_2d(encode, smap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, scale, 1, N,
                         (size_t)N * 4, 1, WG_STEP, CU_TENSOR_MAP_SWIZZLE_NONE);
  }

  // c: the output column of D row gid; o[h]: its bytes 16h + 2t, 2t + 1 (+ 8
  // for 16h + 2t + 8; row c + 8 is 8 rows on, with the same swizzle)
  struct Lane {
    int c, o[4];
  };
  __device__ static Lane lane(int tid) {
    const int wg = tid >> 7, w = (tid >> 5) & 3, gid = (tid >> 2) & 7, t = tid & 3;
    Lane ln;
    ln.c = wg * 64 + 16 * w + gid;
#pragma unroll
    for (int h = 0; h < 4; ++h)
      ln.o[h] = ln.c * WG_STEP + ((h ^ ((ln.c >> 1) & 3)) << 4) + 2 * t;
    return ln;
  }
  template <int H>
  __device__ __forceinline__ void load(uint32_t (&f)[2][4], const uint8_t* wt, const uint8_t*,
                                       const Lane& ln) const {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const uint8_t* p = wt + ln.o[2 * H + i];
      const uint32_t r0 = *reinterpret_cast<const uint16_t*>(p);  // row c
      const uint32_t r1 = *reinterpret_cast<const uint16_t*>(p + 8 * WG_STEP);  // row c + 8
      const uint32_t r2 = *reinterpret_cast<const uint16_t*>(p + 8);
      const uint32_t r3 = *reinterpret_cast<const uint16_t*>(p + 8 * WG_STEP + 8);
      s8x4_pair<E>(__byte_perm(r0, r1, 0x5410), f[i][0], f[i][1]);
      s8x4_pair<E>(__byte_perm(r2, r3, 0x5410), f[i][2], f[i][3]);
    }
  }
  // g's stage tile (BM rows x 64 E, 128B swizzle) times the stage's scales
  // rounded to E, each product rounded once to E (the plain version's g *
  // scale.to(g.dtype)), in place.  Thread i of the 256 consumers
  // takes 16-byte chunk i % 8 of rows i / 8 + 32j: the same logical columns
  // on each row (the swizzle repeats every 8 rows), so its 8 scales load
  // once.  Then the writes are made visible to the wgmmas' async proxy and
  // both consumer warpgroups meet.
  template <int BM>
  __device__ __forceinline__ void fold_tile(uint8_t* xs, const uint8_t* st) const {
    const int i = threadIdx.x, p = i & 7, r0 = i >> 3;
    const int q = p ^ (r0 & 7);  // columns 8q .. 8q + 7
    const float4 a = *reinterpret_cast<const float4*>(st + 32 * q);
    const float4 b = *reinterpret_cast<const float4*>(st + 32 * q + 16);
    const uint32_t s[4] = {pack2<E>(a.x, a.y), pack2<E>(a.z, a.w), pack2<E>(b.x, b.y),
                           pack2<E>(b.z, b.w)};
#pragma unroll
    for (int j = 0; j < BM / 32; ++j) {
      uint4* chunk = reinterpret_cast<uint4*>(xs + (r0 + 32 * j) * 128 + 16 * p);
      uint4 v = *chunk;
      v.x = mul2<E>(v.x, s[0]);
      v.y = mul2<E>(v.y, s[1]);
      v.z = mul2<E>(v.z, s[2]);
      v.w = mul2<E>(v.w, s[3]);
      *chunk = v;
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    named_bar_sync(WG_FOLD_BAR, WG_CONSUMER_WARPS * 32);
  }
};

}  // namespace

extern "C" {

// Split-K CUDA-core kernel.  x of dtype code x_dtype (DT_F32, DT_BF16 or
// DT_F16), y the same type; scale f32; ws holds nsplit * M * N floats;
// K % 32 == 0, N % 8 == 0, 16-byte aligned pointers (checked by the wrapper).
int chatglm_int8_gemv(const void* x, const void* w, const void* scale, void* y, void* ws, int M,
                      int K, int N, int x_dtype, int nsplit, int chunks_per_split,
                      void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int8_t* wq = static_cast<const int8_t*>(w);
  const float* sc = static_cast<const float*>(scale);
  float* part = static_cast<float*>(ws);
  return with_act_type(x_dtype, [&](auto t) {
    using T = decltype(t);
    gemv<T>(static_cast<const T*>(x), wq, sc, static_cast<T*>(y), part, M, K, N, nsplit,
            chunks_per_split, s);
    return (int)cudaGetLastError();
  });
}

// Split-K tensor-core kernel (int8_splitk_mma_kernel), bf16 or f16 (x_dtype
// DT_BF16 / DT_F16, y the same type), one launch: M <= 8 * mt (mt 1 or 2),
// cols 16 (mt 1, N % 16 == 0) or 8 columns a lane, nsplit splits of gps
// groups, x staged cg groups at a time (cg % 8 == 0); ws holds N/(8 cols)
// * nsplit * M * 8 cols floats (unused at nsplit 1), arrivals N/(8 cols)
// zeroed ints that every launch leaves at 0; K % 32 == 0, N % 8 == 0,
// 16-byte aligned pointers (checked by the wrapper).  f32 x and y (x_dtype
// DT_F32): x's pieces as 3M staged rows, 3M <= 8 mt, as
// chatglm_int4_splitk_mma's f32 form.
int chatglm_int8_splitk_mma(const void* x, const void* w, const void* scale, void* y, void* ws,
                            void* arrivals, int M, int K, int N, int x_dtype, int mt, int cols,
                            int nsplit, int gps, int cg, void* stream) {
  return with_act_type(x_dtype, [&](auto t) {
    using E = decltype(t);
    if constexpr (std::is_same_v<E, float>) {  // 3M staged rows
      return sk_dispatch<2>(3 * M, N, mt, cols, nsplit, gps, cg, 2, [&](auto MT, auto COLS) {
        return sk_launch<int8_splitk_f32_kernel<decltype(MT)::value, decltype(COLS)::value>>(
            N, cols, nsplit, sk_smem_bytes(3 * M, cg, cols, 2),
            reinterpret_cast<cudaStream_t>(stream), static_cast<const float*>(x),
            static_cast<const int8_t*>(w), static_cast<const float*>(scale),
            static_cast<float*>(y), static_cast<float*>(ws), static_cast<int*>(arrivals), M, K,
            N, gps, cg);
      });
    } else {
      return sk_dispatch<2>(M, N, mt, cols, nsplit, gps, cg, 2, [&](auto MT, auto COLS) {
        return sk_launch<int8_splitk_mma_kernel<decltype(MT)::value, decltype(COLS)::value, E>>(
            N, cols, nsplit, sk_smem_bytes(M, cg, cols, 2), reinterpret_cast<cudaStream_t>(stream),
            static_cast<const E*>(x), static_cast<const int8_t*>(w),
            static_cast<const float*>(scale), static_cast<E*>(y), static_cast<float*>(ws),
            static_cast<int*>(arrivals), M, K, N, gps, cg);
      });
    }
  });
}

// Hopper tensor-core kernel (int8_wgmma_kernel), bf16 or f16 (x_dtype
// DT_BF16 / DT_F16, y the same type), one launch: tiles of bm (64 or 128)
// rows x 128 columns, nsplit K splits of sps 64-row stages over ctas
// persistent blocks (ops/quant_matmul.py::wg_plan); ws holds tiles *
// nsplit * bm * 128 floats (unused at nsplit 1), arrivals 2 * tiles zeroed
// ints that every launch leaves at 0; K % 32 == 0, N % 16 == 0, 16-byte
// aligned pointers.  x_dtype DT_F32: the f32 form, x the (3, M, K) bf16
// pieces of f32 x (chatglm_split_bf16x3) and y f32.
int chatglm_int8_mma(const void* x, const void* w, const void* scale, void* y, void* ws,
                       void* arrivals, int M, int K, int N, int x_dtype, int bm, int nsplit,
                       int sps, int ctas, void* stream) {
  const int steps = (K + WG_STEP - 1) / WG_STEP;
  if (M < 1 || K < 32 || K % 32 || N < 16 || N % 16 ||
      !wg_plan_ok(steps, bm, nsplit, sps, ctas, ws))
    return (int)cudaErrorInvalidValue;
  PFN_cuTensorMapEncodeTiled_v12000 encode = tensor_map_encoder();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  WgSchedule sc = wg_schedule(M, bm, N, steps, nsplit, sps);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  return with_act_type(x_dtype, [&](auto t) {
    constexpr bool f32 = std::is_same_v<decltype(t), float>;
    using E = std::conditional_t<f32, __nv_bfloat16, decltype(t)>;  // the tiles' element
    using V = std::conditional_t<f32, Int8FwdF32View, Int8FwdView<E>>;
    CUtensorMap xmap, wmap;
    if (!act_map<E>(encode, &xmap, x, (f32 ? 3 : 1) * M, K, bm) ||
        !tensor_map_2d(encode, &wmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, w, K, N, (size_t)N,
                       WG_STEP, WG_N, CU_TENSOR_MAP_SWIZZLE_128B))
      return (int)cudaErrorInvalidValue;
    if (f32) sc.plane = M;
    V v{};
    v.scale = static_cast<const float*>(scale);
    if (bm == 128) return launch_wgmma<128, V>(xmap, wmap, v, y, ws, arrivals, M, N, sc, ctas, s);
    return launch_wgmma<64, V>(xmap, wmap, v, y, ws, arrivals, M, N, sc, ctas, s);
  });
}

// B13, CUDA-core form: out (M, K) = (g (M, N) * scale (N,)) @ w (K, N)ᵀ, g
// and out f32; N % 8 == 0, aligned pointers.
int chatglm_int8_t_gemv(const void* g, const void* w, const void* scale, void* out, int M, int K,
                        int N, int g_dtype, void* stream) {
  if (g_dtype != DT_F32) return (int)cudaErrorInvalidValue;
  const Int8TView<> wv{static_cast<const int8_t*>(w), static_cast<const float*>(scale)};
  t_gemv(static_cast<const float*>(g), wv, static_cast<float*>(out), M, K, N,
         reinterpret_cast<cudaStream_t>(stream));
  return (int)cudaGetLastError();
}

// B13, split-K tensor-core form (t_splitk_mma_kernel), g and out of dtype
// code g_dtype (DT_BF16 or DT_F16), one launch: the plan and buffers of
// common.cuh's launch_t_splitk (ops/quant_matmul.py::t_splitk_plan); K %
// 32 == 0, N % 8 == 0, 16-byte aligned pointers.
int chatglm_int8_t_splitk(const void* g, const void* w, const void* scale, void* out, void* ws,
                          void* arrivals, int M, int K, int N, int g_dtype, int mt, int nsplit,
                          int cps, int cs, void* stream) {
  return with_act_type(g_dtype, [&](auto t) {
    using E = decltype(t);
    if constexpr (std::is_same_v<E, float>) {
      return (int)cudaErrorInvalidValue;
    } else {
      const Int8TView<E> wv{static_cast<const int8_t*>(w), static_cast<const float*>(scale)};
      return launch_t_splitk(wv, g, out, ws, arrivals, M, K, N, mt, nsplit, cps, cs,
                             reinterpret_cast<cudaStream_t>(stream));
    }
  });
}

// B13, tensor-core form (t_wgmma_kernel), g and out of dtype code g_dtype
// (DT_BF16 or DT_F16), one launch: the plan and buffers of
// chatglm_int4_t_mma (ops/quant_matmul.py::t_mma_plan); K % 32 == 0, N %
// 16 == 0, 16-byte aligned pointers.
int chatglm_int8_t_mma(const void* g, const void* w, const void* scale, void* out, void* ws,
                         void* arrivals, int M, int K, int N, int g_dtype, int bm, int nsplit,
                         int sps, int ctas, void* stream) {
  return with_act_type(g_dtype, [&](auto t) {
    using E = decltype(t);
    if constexpr (std::is_same_v<E, float>) {
      return (int)cudaErrorInvalidValue;
    } else {
      const Int8TView<E> wv{static_cast<const int8_t*>(w), static_cast<const float*>(scale)};
      return launch_t_wgmma(wv, g, w, scale, out, ws, arrivals, M, K, N, bm, nsplit, sps, ctas,
                            reinterpret_cast<cudaStream_t>(stream));
    }
  });
}

}  // extern "C"

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
// Both outputs take x's dtype, f32, bf16 or f16 (the JAX kernels' astype,
// :1015, :1118): the s8 products and their sums are the same, and only the
// epilogue's store type differs, the f32 result rounded once.
//
// Kernels, two per function:
// * dyn_splitk_mma_kernel (M <= 16: decode), one for both over common.cuh's
//   split-K body (B1's decode design): bound by the weight bytes.  s8
//   mma.sync m16n8k32 with the weights as A (16 columns x 32 K) and xq's
//   rows as B (8 rows an m-tile, zero past M), so the products cost nothing
//   per row up to 8 rows and the CUDA cores only rearrange bytes.  Lane
//   quad t takes K rows 8t..8t+7 of a 32-row group, so its B registers are
//   8 contiguous bytes of a staged xq row and its A registers come from
//   4x4 __byte_perm transposes of the N-contiguous weight words (B8: each
//   nibble first moved to the high half of its byte, where it reads as the
//   exact s8 16 q).  Each lane streams 16 contiguous bytes (8 where N is
//   narrow or M > 8, and for B7 where 16 would leave a warp fewer than four
//   groups: splitk_plan) of a group's rows by ld.global.nc into two alternating
//   register sets; K splits fill the card at a narrow N and merge in the
//   same launch (last arrival, split order, counter reset: deterministic,
//   graph-safe).  B7 keeps one exact s32 accumulator and merges splits in
//   int32, then the plain version's f32 epilogue; B8 takes each group into
//   a fresh s32 partial and folds it into f32 with the group's scale / 16,
//   as the Hopper form does.
// * dyn_wgmma_kernel (M > 16: prefill, chunk and verify steps), one
//   persistent Hopper kernel for both on common.cuh's ring: TMA stages of
//   the s8 activations (BM rows x 128 K, 128B swizzle) and the weights in
//   an mbarrier ring filled by a producer warpgroup; s8 wgmma m64nBMk32
//   with the weights as A from registers (D = W^T xq^T: D rows are output
//   columns c / c + 1, its columns x's rows) and xq's rows as B straight
//   from the tile (s8 operands in shared memory must be K-major, which the
//   N-contiguous weights are not).  ldmatrix.trans hands each thread the
//   byte pairs of its two columns; PRMTs (B8: a shift and masks first) make
//   the A words.  At the prefill M (57-64 rows) it is bound by the weight
//   bytes: dyn_plan splits K so that ~128 blocks stream a narrow N, and the
//   splits merge in the launch (last arrival, split order, counter reset).
//   B7 keeps one exact s32 accumulator over the unit and merges splits in
//   int32; its epilogue is the plain version's f32 operations.  B8 takes
//   one k32 step per group into a fresh s32 partial and folds it into an
//   f32 accumulator with the group's scale: p converts exactly by a magic
//   bias (|p| < 2^22; cvt.rn.f32.s32 issues at 16 a clock per SM), then one
//   FMA.  The fold, on the CUDA cores, is what bounds B8 at M = 64
//   (PERF.md).
#include <type_traits>

#include "common.cuh"

namespace {

// int32 p as f32, exact for |p| < 2^22: p + 0x4B400000 is the bit pattern
// of 2^23 + 2^22 + p, less 2^23 + 2^22 in f32 (one IADD and one FADD where
// cvt.rn.f32.s32 issues at 16 a clock on an SM).
__device__ __forceinline__ float s32_to_f32_exact(int p) {
  return __int_as_float(p + 0x4B400000) - 12582912.f;
}

// ---------------------------------------------------------------------------
// Split-K tensor-core kernel (s8 mma.sync, M <= 16)
// ---------------------------------------------------------------------------

// xq's 8 s8 K-values of each m-tile's row gid at kl + 8t (zero past M): the
// B registers of one k32 step, K 8t..8t+3 then 8t+4..8t+7 (logical K 4t..
// and 16 + 4t..).
template <int MT>
__device__ __forceinline__ void sk_xq(uint2 (&b)[MT], const int8_t* xs, int xs_stride, int kl,
                                      int M) {
  const int lane = threadIdx.x & 31, gid = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const int row = mt * 8 + gid;
    b[mt] = row < M ? *reinterpret_cast<const uint2*>(xs + row * xs_stride + kl + 8 * t)
                    : make_uint2(0u, 0u);
  }
}

// B7's view: a group is Int8SkGroup (K rows 8t..8t+7 of the lane's
// columns).  Rows 0-3 and 4-7 of each 4-column word transpose into one
// K-ordered word per column: A registers 0 / 1 (columns 2j, 2j + 1 at K
// 8t..8t+3) and 2 / 3 (K 8t+4..).  One exact s32 accumulator.
struct Int8DynSkView {
  using X = int8_t;
  using Acc = int;
  using W = const int8_t*;
  using S = const float*;
  template <int COLS>
  using Group = Int8SkGroup<COLS>;
  using Lane = const int8_t*;
  const int8_t* w;
  const float* scale;
  const float* sx;

  __device__ __forceinline__ Lane lane(int n) const { return w + n; }
  template <int COLS>
  __device__ __forceinline__ void load(Int8SkGroup<COLS>& d, Lane wcol, int g, int t, int N,
                                       bool ok) const {
    int8_sk_load<COLS>(d, wcol, g, t, N, ok);
  }
  template <int MT, int COLS>
  __device__ __forceinline__ void group(const Int8SkGroup<COLS>& d, const int8_t* xs,
                                        int xs_stride, int kl, int M,
                                        int (&acc)[MT][COLS / 2][4]) const {
    uint2 b[MT];
    sk_xq<MT>(b, xs, xs_stride, kl, M);
#pragma unroll
    for (int q = 0; q < COLS / 4; ++q) {
      uint32_t lo[4] = {d.w[0][q], d.w[1][q], d.w[2][q], d.w[3][q]};
      uint32_t hi[4] = {d.w[4][q], d.w[5][q], d.w[6][q], d.w[7][q]};
      transpose4x4_bytes(lo);
      transpose4x4_bytes(hi);
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const uint32_t a[4] = {lo[2 * jj], lo[2 * jj + 1], hi[2 * jj], hi[2 * jj + 1]};
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) mma_s8_16832(acc[mt][2 * q + jj], a, b[mt].x, b[mt].y);
      }
    }
  }
  // the plain version's f32 operations in its order
  template <typename T>
  __device__ __forceinline__ T out(int v, int m, int n) const {
    return from_f32<T>((__int2float_rn(v) * __ldg(sx + m)) * __ldg(scale + n));
  }
};

// B8's view: a group is SkGroup (byte rows 4t..4t+3 of the packed weights,
// K rows 8t..8t+7, and the group's scales).  Each nibble goes to the high
// half of its byte (the low one by byte << 4, the high one by byte & 0xF0),
// where it reads as the s8 16 q, then the transposes of B7; the group's
// products go to a fresh s32 partial, exact in f32 (|p| < 2^22), folded with
// scale / 16 by one FMA: the plain version's float(dot) * scale, unrounded.
struct Int4DynSkView {
  using X = int8_t;
  using Acc = float;
  using W = const uint8_t*;
  using S = const __nv_bfloat16*;
  template <int COLS>
  using Group = SkGroup<COLS>;
  struct Lane {
    const uint8_t* pcol;
    const __nv_bfloat16* scol;
  };
  const uint8_t* packed;
  const __nv_bfloat16* scale;
  const float* sx;

  __device__ __forceinline__ Lane lane(int n) const { return {packed + n, scale + n}; }
  template <int COLS>
  __device__ __forceinline__ void load(SkGroup<COLS>& d, const Lane& ln, int g, int t, int N,
                                       bool ok) const {
    sk_load<COLS>(d, ln.pcol, ln.scol, g, t, N, ok);
  }
  template <int MT, int COLS>
  __device__ __forceinline__ void group(const SkGroup<COLS>& d, const int8_t* xs, int xs_stride,
                                        int kl, int M, float (&acc)[MT][COLS / 2][4]) const {
    uint2 b[MT];
    sk_xq<MT>(b, xs, xs_stride, kl, M);
#pragma unroll
    for (int q = 0; q < COLS / 4; ++q) {
      const uint32_t w0 = d.w[0][q], w1 = d.w[1][q], w2 = d.w[2][q], w3 = d.w[3][q];
      uint32_t lo[4] = {(w0 << 4) & 0xF0F0F0F0u, w0 & 0xF0F0F0F0u, (w1 << 4) & 0xF0F0F0F0u,
                        w1 & 0xF0F0F0F0u};
      uint32_t hi[4] = {(w2 << 4) & 0xF0F0F0F0u, w2 & 0xF0F0F0F0u, (w3 << 4) & 0xF0F0F0F0u,
                        w3 & 0xF0F0F0F0u};
      transpose4x4_bytes(lo);
      transpose4x4_bytes(hi);
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int j = 2 * q + jj;
        const uint32_t a[4] = {lo[2 * jj], lo[2 * jj + 1], hi[2 * jj], hi[2 * jj + 1]};
        const float s_lo = __uint_as_float(d.s[j] << 16) * 0.0625f;          // column 2j
        const float s_hi = __uint_as_float(d.s[j] & 0xFFFF0000u) * 0.0625f;  // column 2j + 1
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          int p[4] = {0, 0, 0, 0};
          mma_s8_16832(p, a, b[mt].x, b[mt].y);
          acc[mt][j][0] = fmaf(s32_to_f32_exact(p[0]), s_lo, acc[mt][j][0]);
          acc[mt][j][1] = fmaf(s32_to_f32_exact(p[1]), s_lo, acc[mt][j][1]);
          acc[mt][j][2] = fmaf(s32_to_f32_exact(p[2]), s_hi, acc[mt][j][2]);
          acc[mt][j][3] = fmaf(s32_to_f32_exact(p[3]), s_hi, acc[mt][j][3]);
        }
      }
    }
  }
  template <typename T>
  __device__ __forceinline__ T out(float v, int m, int) const {
    return from_f32<T>(v * __ldg(sx + m));
  }
};

template <typename V, typename T, int MT, int COLS>
__global__ void __launch_bounds__(SK_THREADS, 4)
dyn_splitk_mma_kernel(const int8_t* __restrict__ xq, const float* __restrict__ sx,
                      typename V::W __restrict__ w, typename V::S __restrict__ scale,
                      T* __restrict__ y, typename V::Acc* __restrict__ ws,
                      int* __restrict__ arrivals, int M, int K, int N, int gps, int cg) {
  extern __shared__ __align__(16) unsigned char sk_smem[];
  sk_body<V, T, MT, COLS>(V{w, scale, sx}, xq, y, ws, arrivals, M, K, N, gps, cg, sk_smem);
}

// xq (M, K) s8, sx (M,) f32, view V's weights and scale, y (M, N) of dtype
// code y_dtype (DT_F32, DT_BF16 or DT_F16: only the epilogue's store type
// differs); the plan of ops/quant_matmul.py::splitk_plan (mt 1 or 2) over
// s8 rows.
template <typename V>
int launch_dyn_splitk(const void* xq, const void* sx, const void* w, const void* scale, void* y,
                      void* ws, void* arrivals, int M, int K, int N, int y_dtype, int mt,
                      int cols, int nsplit, int gps, int cg, cudaStream_t stream) {
  using Acc = typename V::Acc;
  return with_act_type(y_dtype, [&](auto t) {
    using T = decltype(t);
    return sk_dispatch<2>(M, N, mt, cols, nsplit, gps, cg, 1, [&](auto MT, auto COLS) {
      return sk_launch<dyn_splitk_mma_kernel<V, T, decltype(MT)::value, decltype(COLS)::value>>(
          N, cols, nsplit, sk_smem_bytes(M, cg, cols, 1), stream, static_cast<const int8_t*>(xq),
          static_cast<const float*>(sx), static_cast<typename V::W>(w),
          static_cast<typename V::S>(scale), static_cast<T*>(y), static_cast<Acc*>(ws),
          static_cast<int*>(arrivals), M, K, N, gps, cg);
    });
  });
}

// ---------------------------------------------------------------------------
// Hopper tensor-core kernel (s8 wgmma, M > 16)
// ---------------------------------------------------------------------------

constexpr int DYN_STEP = 128;  // contraction elements a stage: 4 k32 steps (B8: 4 groups)

// B7's weights: a stage is 128 K rows x 128 columns of w (128B swizzle:
// 16-byte chunk q of row r at chunk q ^ (r & 7)).  D rows gid and gid + 8
// of a warp are columns c and c + 1, so a column pair is one b16 element
// and ldmatrix.trans hands thread (gid, t) the pair (c, c + 1) of two K
// rows in one register.  Lanes point it at the rows each thread needs:
// matrix 0 holds K rows 4t + sw, 4t + sw + 1 of thread t, matrix 1 rows 4t
// + 2 - sw, + 1 (matrices 2, 3 the same 16 rows on), where sw = t & 2 swaps
// the pairs of threads 2 and 3 so that each matrix's 8 rows lie in 8
// distinct swizzle positions (no bank conflict).  Two PRMTs with the
// thread's selectors then give the K-ordered words of c and c + 1.  The
// scale multiplies the exact int32 sum in the epilogue.
struct Int8DynView {
  using Acc = int;
  const float* scale;
  static constexpr int kWBytes = DYN_STEP * WG_N;
  static constexpr int kSBytes = 0;
  __device__ const float* col_scale() const { return scale; }

  __device__ static void tma(const CUtensorMap* wmap, const CUtensorMap*, uint8_t* wdst, uint8_t*,
                             int nt, int s, uint64_t* bar) {
    tma_load_2d(wdst, wmap, nt * WG_N, s * DYN_STEP, bar);
  }
  static bool maps(PFN_cuTensorMapEncodeTiled_v12000 encode, CUtensorMap* wmap, CUtensorMap* smap,
                   const void* w, const void*, int K, int N) {
    *smap = {};
    return tensor_map_2d(encode, wmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, w, K, N, (size_t)N,
                         DYN_STEP, WG_N, CU_TENSOR_MAP_SWIZZLE_128B);
  }

  // c: the column of D row gid; o: this lane's ldmatrix row in the stage
  // tile (k32 step h: + 32h rows); sel: the PRMTs of columns c and c + 1
  struct Lane {
    int c;
    uint32_t o, sel_c, sel_c1;
  };
  __device__ static Lane lane(int tid) {
    const int wg = tid >> 7, w = (tid >> 5) & 3, l = tid & 31, t = l & 3;
    const int q = 4 * wg + w;  // the warp's 16 columns: one 16-byte chunk
    const int i = l >> 3, tt = (l & 7) >> 1, sw = tt & 2;
    const int r = 16 * (i >> 1) + 4 * tt + ((i & 1) ? 2 - sw : sw) + (l & 1);
    Lane ln;
    ln.c = 16 * q + 2 * ((l >> 2) & 7);
    ln.o = r * WG_N + ((q ^ (r & 7)) << 4);
    ln.sel_c = (t & 2) ? 0x2064u : 0x6420u;
    ln.sel_c1 = (t & 2) ? 0x3175u : 0x7531u;
    return ln;
  }
  // the A fragment of k32 step h
  __device__ __forceinline__ void load(uint32_t (&f)[4], const uint8_t* wt, int h,
                                       const Lane& ln) const {
    uint32_t m[4];
    ldmatrix_x4_trans(m, wt + ln.o + h * 32 * WG_N);
    f[0] = __byte_perm(m[0], m[1], ln.sel_c);
    f[1] = __byte_perm(m[0], m[1], ln.sel_c1);
    f[2] = __byte_perm(m[2], m[3], ln.sel_c);
    f[3] = __byte_perm(m[2], m[3], ln.sel_c1);
  }
};

// B8's weights: a stage is 64 packed byte rows (K rows 2i, 2i + 1 in the
// low / high nibble of byte row i) x 128 columns (128B swizzle) and the 4 x
// 128 bf16 scales of its groups.  One k32 step is one group: ldmatrix.trans
// on its 16 byte rows hands thread (gid, t) byte rows 2t, 2t + 1 (K rows
// 4t..4t + 3) and 8 + 2t, 9 + 2t of columns c, c + 1 (each matrix's 8 rows
// consecutive: no bank conflict).  Each nibble goes to the high half of its
// byte, where it reads as the exact s8 16 q with no sign extension (the low
// nibble by byte << 4, the high one by byte & 0xF0), so the group's s32
// partial is 16 times the dot; the fold takes the scale / 16.
struct Int4DynView {
  using Acc = float;
  static constexpr int kWBytes = DYN_STEP / 2 * WG_N;
  static constexpr int kSBytes = DYN_STEP / 32 * WG_N * 2;
  __device__ const float* col_scale() const { return nullptr; }

  __device__ static void tma(const CUtensorMap* pmap, const CUtensorMap* smap, uint8_t* pdst,
                             uint8_t* sdst, int nt, int s, uint64_t* bar) {
    tma_load_2d(pdst, pmap, nt * WG_N, s * DYN_STEP / 2, bar);
    tma_load_2d(sdst, smap, nt * WG_N, s * DYN_STEP / 32, bar);
  }
  static bool maps(PFN_cuTensorMapEncodeTiled_v12000 encode, CUtensorMap* pmap, CUtensorMap* smap,
                   const void* packed, const void* scale, int K, int N) {
    return tensor_map_2d(encode, pmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, packed, K / 2, N,
                         (size_t)N, DYN_STEP / 2, WG_N, CU_TENSOR_MAP_SWIZZLE_128B) &&
           tensor_map_2d(encode, smap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, scale, K / 32, N,
                         (size_t)N * 2, DYN_STEP / 32, WG_N, CU_TENSOR_MAP_SWIZZLE_NONE);
  }

  // c: the column of D row gid; o: this lane's ldmatrix row (group g: + 16g rows)
  struct Lane {
    int c;
    uint32_t o;
  };
  __device__ static Lane lane(int tid) {
    const int l = tid & 31, q = 4 * (tid >> 7) + ((tid >> 5) & 3), r = l & 15;
    Lane ln;
    ln.c = 16 * q + 2 * ((l >> 2) & 7);
    ln.o = r * WG_N + ((q ^ (r & 7)) << 4);
    return ln;
  }
  // the A fragment of group g: 16 q of (K 4t..4t + 3, then 16 + 4t..) for c, c + 1
  __device__ __forceinline__ void load(uint32_t (&f)[4], const uint8_t* wt, int g,
                                       const Lane& ln) const {
    uint32_t m[2];
    ldmatrix_x2_trans(m, wt + ln.o + g * 16 * WG_N);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const uint32_t lo = (m[i] << 4) & 0xF0F0F0F0u, hi = m[i] & 0xF0F0F0F0u;
      f[2 * i] = __byte_perm(lo, hi, 0x6240);      // column c
      f[2 * i + 1] = __byte_perm(lo, hi, 0x7351);  // column c + 1
    }
  }
  // group g's scales of columns c, c + 1, over 16
  __device__ __forceinline__ static float2 scales(const uint8_t* st, int g, int c) {
    const uint32_t s = *reinterpret_cast<const uint32_t*>(st + 2 * (g * WG_N + c));
    return make_float2(__uint_as_float(s << 16) * 0.0625f,
                       __uint_as_float(s & 0xFFFF0000u) * 0.0625f);
  }
};

template <int BM>
__device__ __forceinline__ void wg_mma_s8(int (&d)[BM / 2], const uint32_t (&a)[4], uint64_t desc,
                                          int scale_d) {
  if constexpr (BM == 128)
    wgmma_s8_n128(d, a, desc, scale_d);
  else
    wgmma_s8_n64(d, a, desc, scale_d);
}

// Stages as the ring's shared memory allows, up to WG_STAGES (B7 at BM = 128: 7).
template <int BM, typename V>
constexpr int dyn_stages() {
  constexpr int fit = (WG_SMEM_MAX - 16 - 1024) / (BM * 128 + V::kWBytes + V::kSBytes + 16);
  return fit < WG_STAGES ? fit : WG_STAGES;
}
template <int BM, typename V>
using DynRing = WgRing<BM, V::kWBytes, V::kSBytes, dyn_stages<BM, V>()>;

// A consumer thread's ring position.
template <int BM, typename V>
struct DynSlot {
  using R = DynRing<BM, V>;
  uint8_t* smem;
  int st = 0;       // the ring slot of the current stage
  uint32_t ph = 0;  // its phase
  __device__ __forceinline__ const uint8_t* wt() const { return smem + R::W_OFF + st * V::kWBytes; }
  __device__ __forceinline__ const uint8_t* stile() const {
    return smem + R::S_OFF + st * V::kSBytes;
  }
  __device__ __forceinline__ uint64_t desc() const { return sw128_desc(smem + st * R::XS); }
  __device__ __forceinline__ void advance() {  // a select, no branch
    const bool wrap = st + 1 == R::kStages;
    st = wrap ? 0 : st + 1;
    ph ^= (uint32_t)wrap;
  }
};

// Steps 2H, 2H + 1 of a stage into acc; asynchronous.
template <int BM>
__device__ __forceinline__ void dyn_issue_half(int (&acc)[BM / 2], const uint32_t (&f)[2][4],
                                               uint64_t desc) {
  wgmma_fence();
  wg_mma_s8<BM>(acc, f[0], desc, 1);
  wg_mma_s8<BM>(acc, f[1], desc + 2, 1);
  wgmma_commit();
}

// B7's unit: one exact s32 accumulator over all its stages (scale-d = 1,
// acc zeroed first).  A stage's four k32 steps go out in two halves of
// fragments (fa, fb); a half's registers are reused once its wgmmas are done
// (wgmma.wait_group 1), a stage's slot released once its second half is.
// The loop body has no branch: one half is in flight on every path into and
// out of it, so ptxas keeps the wgmmas asynchronous.
template <int BM>
__device__ __forceinline__ void dyn_unit(int (&acc)[BM / 2], const Int8DynView& v,
                                         const Int8DynView::Lane& ln,
                                         DynSlot<BM, Int8DynView>& sl,
                                         uint64_t* full, uint64_t* empty, int nstages) {
  uint32_t fa[2][4], fb[2][4];
  const auto load = [&](uint32_t (&f)[2][4], int h) {
    v.load(f[0], sl.wt(), 2 * h, ln);
    v.load(f[1], sl.wt(), 2 * h + 1, ln);
  };
#pragma unroll
  for (int i = 0; i < BM / 2; ++i) acc[i] = 0;
  mbar_wait(&full[sl.st], sl.ph);
  load(fa, 0);
  dyn_issue_half<BM>(acc, fa, sl.desc());
  load(fb, 1);
  dyn_issue_half<BM>(acc, fb, sl.desc() + 4);
  wg_release_half<1>(fa);
  for (int i = 1; i < nstages; ++i) {
    const int prev = sl.st;
    sl.advance();
    mbar_wait(&full[sl.st], sl.ph);
    load(fa, 0);
    dyn_issue_half<BM>(acc, fa, sl.desc());
    wg_release_half<1>(fb);  // the previous stage is done
    if ((threadIdx.x & 31) == 0) mbar_arrive(&empty[prev]);
    load(fb, 1);
    dyn_issue_half<BM>(acc, fb, sl.desc() + 4);
    wg_release_half<1>(fa);
  }
  wg_release_half<0>(fb);
#pragma unroll
  for (int i = 0; i < BM / 2; ++i) pin(acc[i]);
  if ((threadIdx.x & 31) == 0) mbar_arrive(&empty[sl.st]);
  sl.advance();
}

// One group of B8 into a fresh s32 partial (scale-d = 0); asynchronous.
template <int BM>
__device__ __forceinline__ void dyn_issue_group(int (&part)[BM / 2], const uint32_t (&f)[4],
                                                uint64_t desc) {
  wgmma_fence();
  wg_mma_s8<BM>(part, f, desc, 0);
  wgmma_commit();
}

// Wait for the group's wgmma, then acc += float(part) * scale / 16 (D row
// gid: column c, gid + 8: c + 1), exact conversions, one rounding each: the
// plain version's float(dot) * scale.
template <int BM>
__device__ __forceinline__ void dyn_fold(float (&acc)[BM / 2], int (&part)[BM / 2],
                                         uint32_t (&f)[4], float2 s) {
  wgmma_wait<0>();
#pragma unroll
  for (int r = 0; r < 4; ++r) pin(f[r]);
#pragma unroll
  for (int i = 0; i < BM / 2; ++i) pin(part[i]);
#pragma unroll
  for (int j = 0; j < BM / 8; ++j) {
    acc[4 * j] = fmaf(s32_to_f32_exact(part[4 * j]), s.x, acc[4 * j]);
    acc[4 * j + 1] = fmaf(s32_to_f32_exact(part[4 * j + 1]), s.x, acc[4 * j + 1]);
    acc[4 * j + 2] = fmaf(s32_to_f32_exact(part[4 * j + 2]), s.y, acc[4 * j + 2]);
    acc[4 * j + 3] = fmaf(s32_to_f32_exact(part[4 * j + 3]), s.y, acc[4 * j + 3]);
  }
}

// B8's unit: each group (one k32 step) into a fresh s32 partial, waited
// for, then folded into the f32 accumulator with its scale; the next
// group's fragments load while the tensor cores run this one, and the other
// consumer warpgroup's fold fills the wait.  A second partial, folded while
// the next group runs (B1's pipeline), does not survive ptxas here: it
// serializes every IGMMA whose s32 partial is read while another is in
// flight (C7513 / C7514, in each arrangement tried; PERF.md), so the loop
// waits where ptxas would.
template <int BM>
__device__ __forceinline__ void dyn_unit(float (&acc)[BM / 2], const Int4DynView& v,
                                         const Int4DynView::Lane& ln,
                                         DynSlot<BM, Int4DynView>& sl,
                                         uint64_t* full, uint64_t* empty, int nstages) {
  int part[BM / 2];
  uint32_t fa[4], fb[4];
  float2 sa, sb;
  const auto group = [&](uint32_t (&f)[4], float2& s, int g) {
    v.load(f, sl.wt(), g, ln);
    s = Int4DynView::scales(sl.stile(), g, ln.c);
  };
#pragma unroll
  for (int i = 0; i < BM / 2; ++i) acc[i] = 0.f;
  for (int i = 0; i < nstages; ++i) {
    mbar_wait(&full[sl.st], sl.ph);
    group(fa, sa, 0);
    dyn_issue_group<BM>(part, fa, sl.desc());
    group(fb, sb, 1);
    dyn_fold<BM>(acc, part, fa, sa);
    dyn_issue_group<BM>(part, fb, sl.desc() + 2);
    group(fa, sa, 2);
    dyn_fold<BM>(acc, part, fb, sb);
    dyn_issue_group<BM>(part, fa, sl.desc() + 4);
    group(fb, sb, 3);
    dyn_fold<BM>(acc, part, fa, sa);
    dyn_issue_group<BM>(part, fb, sl.desc() + 6);
    dyn_fold<BM>(acc, part, fb, sb);
    if ((threadIdx.x & 31) == 0) mbar_arrive(&empty[sl.st]);  // its groups read and done
    sl.advance();
  }
}

// y (M, N) of this thread's columns n, n + 1, rows m0 + 8j + 2t + e: B7
// (float(acc) * sx[m]) * scale[n], B8 acc * sx[m] (the plain versions'
// operations in their order), rounded once to T (f32, bf16 or f16: past
// 65504 an f16 output is inf, as the JAX kernels' astype gives).
template <int BM, typename Acc, typename T>
__device__ __forceinline__ void dyn_store(const Acc (&acc)[BM / 2], T* __restrict__ y,
                                          const float* __restrict__ sx,
                                          const float* __restrict__ col_scale, int m0, int n,
                                          int M, int N) {
  if (n >= N) return;  // N % 16 == 0: a 16-column slab is all in or all out
  const int t = threadIdx.x & 3;
  float s0 = 1.f, s1 = 1.f;
  if constexpr (std::is_same_v<Acc, int>) {
    const float2 s = __ldg(reinterpret_cast<const float2*>(col_scale + n));
    s0 = s.x;
    s1 = s.y;
  }
#pragma unroll
  for (int j = 0; j < BM / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int m = m0 + 8 * j + 2 * t + e;
      if (m >= M) continue;
      const float r = __ldg(sx + m);
      float v0, v1;
      if constexpr (std::is_same_v<Acc, int>) {
        v0 = (__int2float_rn(acc[4 * j + e]) * r) * s0;
        v1 = (__int2float_rn(acc[4 * j + 2 + e]) * r) * s1;
      } else {
        v0 = acc[4 * j + e] * r;
        v1 = acc[4 * j + 2 + e] * r;
      }
      T* row = y + (size_t)m * N + n;
      if constexpr (std::is_same_v<T, float>)
        *reinterpret_cast<float2*>(row) = make_float2(v0, v1);
      else
        *reinterpret_cast<uint32_t*>(row) = pack2<T>(v0, v1);
    }
  }
}

// Persistent, on common.cuh's ring, producer (s8 activation tiles of BM x
// 128) and split merge; the consumers run dyn_unit per work unit.
template <int BM, typename V, typename T>
__global__ void __launch_bounds__(WG_THREADS, 1)
dyn_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                 const __grid_constant__ CUtensorMap wmap,
                 const __grid_constant__ CUtensorMap smap, const V v,
                 const float* __restrict__ sx, T* __restrict__ y,
                 typename V::Acc* __restrict__ ws, int* __restrict__ arrivals, int M, int N,
                 const WgSchedule sc) {
  using R = DynRing<BM, V>;
  extern __shared__ uint8_t wg_smem_raw[];
  uint64_t *full, *empty;
  int* merge_flag;
  uint8_t* smem = wg_setup<R>(wg_smem_raw, full, empty, merge_flag);
  if (threadIdx.x >= WG_CONSUMER_WARPS * 32) {
    wg_produce<BM, V, DYN_STEP, R::kStages>(&xmap, &wmap, &smap, smem, full, empty, sc);
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(WG_CONSUMER_REGS));
  const typename V::Lane ln = V::lane(threadIdx.x);
  DynSlot<BM, V> sl{smem};
  typename V::Acc acc[BM / 2];
  for (int u = blockIdx.x; u < sc.units; u += gridDim.x) {
    int mt, sp, nt, s0, s1;
    sc.unit(u, mt, sp, nt, s0, s1);
    dyn_unit<BM>(acc, v, ln, sl, full, empty, s1 - s0);
    wg_merge<BM>(acc, ws, arrivals, merge_flag, sc, mt, sp, nt,
                 [&](const typename V::Acc (&a)[BM / 2], int m0) {
                   dyn_store<BM>(a, y, sx, v.col_scale(), m0, nt * WG_N + ln.c, M, N);
                 });
  }
}

template <int BM, typename V, typename T>
int launch_dyn_bm(const CUtensorMap& xmap, const CUtensorMap& wmap, const CUtensorMap& smap,
                  const V& v, const void* sx, void* y, void* ws, void* arrivals, int M, int N,
                  const WgSchedule& sc, int ctas, cudaStream_t stream) {
  constexpr int bytes = DynRing<BM, V>::BYTES;
  const cudaError_t opt_in = smem_opt_in<dyn_wgmma_kernel<BM, V, T>>(bytes);
  if (opt_in != cudaSuccess) return (int)opt_in;
  dyn_wgmma_kernel<BM, V, T><<<ctas, WG_THREADS, bytes, stream>>>(
      xmap, wmap, smap, v, static_cast<const float*>(sx), static_cast<T*>(y),
      static_cast<typename V::Acc*>(ws), static_cast<int*>(arrivals), M, N, sc);
  return (int)cudaGetLastError();
}

// xq (M, K) s8 and sx (M,) f32, the weights and scale of view v, y (M, N)
// of dtype code y_dtype (DT_F32, DT_BF16 or DT_F16); the plan of
// ops/dyn_matmul.py::dyn_plan.
template <typename V>
int launch_dyn_wgmma(const V& v, const void* xq, const void* sx, const void* w,
                     const void* scale, void* y, void* ws, void* arrivals, int M, int K, int N,
                     int y_dtype, int bm, int nsplit, int sps, int ctas, cudaStream_t stream) {
  const int steps = (K + DYN_STEP - 1) / DYN_STEP;
  if (M < 1 || K < 32 || K % 32 || N < 16 || N % 16 ||
      !wg_plan_ok(steps, bm, nsplit, sps, ctas, ws))
    return (int)cudaErrorInvalidValue;
  PFN_cuTensorMapEncodeTiled_v12000 encode = tensor_map_encoder();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap xmap, wmap, smap;
  if (!tensor_map_2d(encode, &xmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, xq, M, K, (size_t)K, bm,
                     DYN_STEP, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !V::maps(encode, &wmap, &smap, w, scale, K, N))
    return (int)cudaErrorInvalidValue;
  const WgSchedule sc = wg_schedule(M, bm, N, steps, nsplit, sps);
  return with_act_type(y_dtype, [&](auto t) {
    using T = decltype(t);
    if (bm == 128)
      return launch_dyn_bm<128, V, T>(xmap, wmap, smap, v, sx, y, ws, arrivals, M, N, sc, ctas,
                                      stream);
    return launch_dyn_bm<64, V, T>(xmap, wmap, smap, v, sx, y, ws, arrivals, M, N, sc, ctas,
                                   stream);
  });
}

}  // namespace

extern "C" {

// B7, split-K tensor-core kernel (dyn_splitk_mma_kernel), one launch.  xq
// (M,K) s8, sx (M,) f32, w (K,N) s8, scale (N,) f32, y (M,N) of dtype code
// y_dtype (DT_F32, DT_BF16 or DT_F16); the plan and buffers of
// chatglm_int8_splitk_mma, ws as int32 partials; K % 32 == 0, N % 8 == 0,
// 16-byte aligned pointers.
int chatglm_int8_dyn_splitk(const void* xq, const void* sx, const void* w, const void* scale,
                            void* y, void* ws, void* arrivals, int M, int K, int N, int y_dtype,
                            int mt, int cols, int nsplit, int gps, int cg, void* stream) {
  return launch_dyn_splitk<Int8DynSkView>(xq, sx, w, scale, y, ws, arrivals, M, K, N, y_dtype,
                                          mt, cols, nsplit, gps, cg,
                                          reinterpret_cast<cudaStream_t>(stream));
}

// B7, Hopper tensor-core kernel (dyn_wgmma_kernel), one launch: tiles of bm
// (64 or 128) rows x 128 columns, nsplit K splits of sps 128-element stages
// over ctas persistent blocks (ops/dyn_matmul.py::dyn_plan); ws holds tiles
// * nsplit * bm * 128 int32 partials (unused at nsplit 1), arrivals 2 *
// tiles zeroed ints that every launch leaves at 0; K % 32 == 0, N % 16 == 0,
// 16-byte aligned pointers.
int chatglm_int8_dyn_mma(const void* xq, const void* sx, const void* w, const void* scale,
                         void* y, void* ws, void* arrivals, int M, int K, int N, int y_dtype,
                         int bm, int nsplit, int sps, int ctas, void* stream) {
  const Int8DynView v{static_cast<const float*>(scale)};
  return launch_dyn_wgmma(v, xq, sx, w, scale, y, ws, arrivals, M, K, N, y_dtype, bm, nsplit,
                          sps, ctas, reinterpret_cast<cudaStream_t>(stream));
}

// B8, split-K tensor-core kernel (dyn_splitk_mma_kernel), one launch:
// packed (K/2, N) u8 tpu order, scale (K/32, N) bf16; the plan and buffers
// of chatglm_int8_dyn_splitk, ws as f32 partials.
int chatglm_int4_dyn_splitk(const void* xq, const void* sx, const void* packed, const void* scale,
                            void* y, void* ws, void* arrivals, int M, int K, int N, int y_dtype,
                            int mt, int cols, int nsplit, int gps, int cg, void* stream) {
  return launch_dyn_splitk<Int4DynSkView>(xq, sx, packed, scale, y, ws, arrivals, M, K, N,
                                          y_dtype, mt, cols, nsplit, gps, cg,
                                          reinterpret_cast<cudaStream_t>(stream));
}

// B8, Hopper tensor-core kernel (dyn_wgmma_kernel), one launch: packed (K/2,
// N) u8 tpu order, scale (K/32, N) bf16; the plan and buffers of
// chatglm_int8_dyn_mma, ws as f32 partials.
int chatglm_int4_dyn_mma(const void* xq, const void* sx, const void* packed, const void* scale,
                         void* y, void* ws, void* arrivals, int M, int K, int N, int y_dtype,
                         int bm, int nsplit, int sps, int ctas, void* stream) {
  return launch_dyn_wgmma(Int4DynView{}, xq, sx, packed, scale, y, ws, arrivals, M, K, N,
                          y_dtype, bm, nsplit, sps, ctas, reinterpret_cast<cudaStream_t>(stream));
}

}  // extern "C"

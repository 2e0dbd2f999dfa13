// int4g32 weight-only matmul: y (M,N) = x (M,K) @ dequant(packed (K/2,N), scale (K/32,N)).
//
// Replaces the TPU kernels chatglm_q_tpu/ops/pallas_matmul.py:_int4_fwd_kernel
// (grid form, every per-layer linear) and :_int4_pipelined_kernel (decode-M
// form, the lm_head).  Both compute the same function; here it is one wrapper
// (ops/quant_matmul.py::int4g32_matmul) over three kernels chosen by M and
// x's dtype.
//
// Numerics: packed bytes are "tpu order" — byte row i holds K-row 2i in the
// low nibble and 2i+1 in the high nibble, as two's-complement int4.  The
// nibbles are sign-extended in registers, each 32-row group's partial sum is
// taken in f32 on the unscaled integers, and the group scale multiplies that
// f32 partial (the "grouped" scheme, pallas_matmul.py:316-323).  Integer
// weights and bf16 or f16 activations are exact in the products, so the
// kernels differ from the plain version only in summation order.
//
// The activations (and the output) are bf16, f16 or f32; the C entries take
// the dtype code of common.cuh (DT_F32 / DT_BF16 / DT_F16).  The two
// tensor-core kernels are templates over the 16-bit element E: their f16
// forms (a float16 checkpoint's activations) run mma.sync / wgmma
// .f32.f16.f16 at bf16's rate, each nibble turned into an f16x2 pair over
// f16 1024 (common.cuh: nibble_pair<__half>), the same f32 sums and scale
// folds.  The JAX package's Pallas kernel takes f16 x through the same
// function (pallas_matmul.py:278 casts q to x's dtype, :382 writes x's
// dtype).  The per-group scale stays f32 on the f32 partial, so at a scale
// whose q·s falls among f16's subnormals (below 2^-14) or past 65504 the
// kernels keep q·s exactly where the JAX package's jnp fallback
// (linear.py:119-121) rounds it to f16 first.
//
// * int4_splitk_mma_kernel (bf16 / f16, M <= SMALL_M_MAX = 64: decode at batch
//   1-4 and the speculative verify step; the TPU package's decode-M form,
//   _int4_pipelined_kernel, serves the same M <= 64).  Bound by the weight
//   bytes.  What keeps it near them:
//   - the tensor cores absorb M: mma.sync m16n8k16 with the weights as A
//     (16 columns x 16 K) and x as B (8 rows a tile, zero past M), so a
//     weight is dequantized once whatever M is; each packed byte is one A
//     register (its two nibbles are neighbouring K rows), and
//     int4_pair (common.cuh) turns it into bf16x2 (f16x2) with one PRMT,
//     one LOP3 and one bf16x2 (f16x2) FMA, no int-to-float conversion;
//   - each lane reads 16 contiguous bytes (8 where N is narrow or M > 8) of
//     four byte rows of a group by ld.global.nc, into two register sets
//     that alternate, so two groups' loads are in flight while one is
//     computed (cp.async into a shared-memory ring streamed this pattern
//     ~1.7x slower on an H100);
//   - one launch: the grid splits K so that a narrow N still fills the 132
//     SMs (fewer splits as N grows, none at the lm_head), the block stages
//     x's rows for its K range in shared memory, its 4 warps' sums meet
//     there behind one barrier, and the last block of a column tile to
//     arrive (__threadfence, then atomicAdd on its counter, which it then
//     resets to 0) sums the splits' f32 partials in split order and writes
//     y.  Deterministic, nothing to reset between launches, so a CUDA graph
//     can replay it.
//   The body is common.cuh's sk_body over Int4SkView, shared with B6's, B7's
//   and B8's decode kernels.
// * The f32 forms (f32 x and y; a float32 checkpoint's activations, the
//   loaders' default dtype) run the two tensor-core kernels above and below
//   exactly: an f32 x is the sum of three bf16 pieces (common.cuh:
//   split_bf16x3), each piece times an int4 weight is exact in the f32
//   accumulator, so three bf16 products a term give the f32 product, and
//   the sums differ from the plain version only in order, as in bf16.
//   int4_splitk_f32_kernel (M <= the f32 split-K limit: decode, verify) is
//   sk_body over Int4SkF32View, which stages the pieces as it stages x,
//   as three rows an x row (3M rows through the bf16 body's mma: free
//   while 3M fits the m-tiles M needs anyway); one launch, merged in the
//   launch as the bf16 form.
//   int4_wgmma_kernel<BM, bf16, 3> (above it: prefill, chunks) reads the
//   pieces from a (3, M, K) bf16 buffer that chatglm_split_bf16x3 writes
//   first (a second launch of 10 bytes an element), three tiles a stage,
//   six wgmmas a group into the group's partial.  TF32, with 10 bits,
//   could not give this.
// * int4_gemv_kernel (bf16 / f16 / f32 above the split-K limits where N %
//   16 != 0; callable by name for the f32 forms' comparison): bound by
//   bytes — every weight byte is read once per call
//   and there are only ~2 operations per byte.  Each lane
//   reads 8 neighbouring N bytes of a byte row (one 8-byte load; a warp reads
//   256 contiguous bytes), so loads coalesce along the N-contiguous layout.
//   At decode N is as small as 4096 while K reaches 13824, which would leave
//   a few hundred column threads and most of the card idle; the kernel
//   therefore splits K across blocks (grid.y) and across the 4 warps of a
//   block.  Warps reduce in shared memory in a fixed order, blocks write f32
//   partials to a workspace, and splitk_reduce_kernel (common.cuh) sums the
//   splits in a fixed order and casts: deterministic, no atomics.
// * int4_wgmma_kernel (bf16 / f16 above SMALL_M_MAX: prefill, engine chunks,
//   training): bound by operations (each weight serves every row of x).
//   A persistent Hopper kernel: a producer warpgroup keeps an 8-stage ring
//   of TMA tiles in flight (x's rows, the packed bytes, the scales),
//   ordered by mbarriers; two consumer warpgroups each take 64 of a tile's
//   128 columns and run wgmma with the weights as A from registers (the
//   split-K kernel's orientation: each packed byte one A register through
//   int4_pair, no int-to-float conversion; a thread's two columns
//   are neighbours, so a u16 load feeds two registers and a bf16x2 store
//   writes two outputs) and x's rows as B straight from the 128B-swizzled
//   TMA tile, so each weight is dequantized once per block and stage.  Numerics are the exact
//   per-group scheme above, as design (a): each group's partial comes from
//   its own wgmmas (the first with scale-d = 0) into one of two partial
//   accumulators, and the CUDA cores fold the previous group's partial
//   into the f32 accumulator with its scale while the tensor cores run the
//   next group (wgmma.wait_group 1).  The other exact design, bf16 hi + lo
//   halves of q·s, needs no per-group fold but twice the MMAs; the fold
//   costs one FMA per 32 MACs, which the pipeline hides.  mma_plan
//   (ops/quant_matmul.py) picks 128- or 64-row tiles and splits K where a
//   narrow N (kv_proj) or small M leaves the card idle; the splits merge in
//   the same launch as in the split-K kernel below (last block to arrive,
//   split order, counter reset: deterministic, graph-safe).  The producer
//   gives up its registers (setmaxnreg) for the consumers' three 64-row
//   accumulators.  The ring, the producer, the plan checks and the
//   epilogue are common.cuh's, shared with B6 and the transposed kernel.
//
// The backward kernels (B14) replace pallas_matmul.py:_int4_t_kernel
// (int4_matmul_t_pallas): grad_x (M,K) = g (M,N) @ dequant(packed, scale)ᵀ,
// the contraction over N.  The scale changes along both K/32 and N, so it
// folds into neither g nor the output: each weight is dequantized to g's
// dtype, bf16(q * s) under bf16, before the dot, as both JAX forms round it;
// f16(f16(q) * f16(s)) under f16 (a float16 checkpoint's fine-tuning: the
// bf16 scale rounded to f16 first, a subnormal, 0 or inf outside f16's
// normal range, as the JAX kernel's s.astype(g.dtype) gives; not B1's f32
// q * s).  The tensor-core kernels take Int4TView<E> over g's element E.
// Byte row i of packed holds output columns 2i (low nibble) and 2i+1 (high).
// All three are common.cuh's transposed bodies over Int4TView:
// * t_splitk_mma_kernel<Int4TView> (bf16 / f16 g, M <= MMA_MIN_M = 16, and
//   at any M where N % 16 != 0): bound by the packed bytes.  mma.sync with
//   a warp's 32 output rows (16 byte rows, one scale group) as two A tiles
//   built as t_wgmma_kernel's below, one 16-byte load a byte row feeding
//   four k16 steps, g's rows as B from shared memory; the contraction split
//   over blocks, merged in the launch (common.cuh).
// * t_gemv_kernel<Int4TView> (f32 g): bound by the packed bytes; one warp
//   per two byte rows (four output columns), 8-byte loads along N.
// * t_wgmma_kernel<Int4TView> (bf16 / f16, M > 16; training's M = B*S): bound by
//   operations.  common.cuh's Hopper mainloop (B1's ring, producer and
//   orientation: the weights as wgmma's A from registers, g's rows as B
//   from the swizzled TMA tile); no per-group fold, since each weight is
//   rounded before the dot, only the per-stage partials of wg_consume.  A
//   packed byte row
//   holds two output columns (its nibbles), so D rows gid and gid + 8 of a
//   warp are made those two columns: one u16 load of two neighbouring
//   bytes gives both rows' A registers for two contraction elements, each
//   weight E(q * s) by one E x2 multiply of the exact nibble value
//   (int4_rows_pair), one scale pair for both rows.
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
  splitk_reduce<T>(ws, nullptr, y, nsplit, M, N, stream);
}

// ---------------------------------------------------------------------------
// Hopper tensor-core kernel (bf16 / f16 activations, M > SMALL_M_MAX: prefill,
// training)
// ---------------------------------------------------------------------------

// A tile is BM rows of x by WG_N weight columns (common.cuh's ring and
// producer); a stage WG_STAGE_GROUPS groups (WG_STEP = 64 K).
// ops/quant_matmul.py::mma_plan and mma_smem mirror these.
constexpr int WG_STAGE_GROUPS = 2;

// B1's weight and scale tiles a stage, after x's: 32 packed byte rows x 128
// columns (128B swizzle) and 2 x 128 scales.
struct Int4FwdTiles {
  static constexpr int kWBytes = 16 * WG_STAGE_GROUPS * WG_N;
  static constexpr int kSBytes = WG_STAGE_GROUPS * WG_N * 2;
  static constexpr int kRowStep = 1;  // D rows gid, gid + 8: columns c, c + 1
  static constexpr bool kColScale = false;
  __device__ static void tma(const CUtensorMap* pmap, const CUtensorMap* smap, uint8_t* pdst,
                             uint8_t* sdst, int nt, int s, uint64_t* bar) {
    tma_load_2d(pdst, pmap, nt * WG_N, s * 16 * WG_STAGE_GROUPS, bar);
    tma_load_2d(sdst, smap, nt * WG_N, s * WG_STAGE_GROUPS, bar);
  }
  __device__ const float* col_scale() const { return nullptr; }
};
// The ring of the bf16 / f16 form (PIECES 1) or of the f32 form (PIECES 3:
// x's three bf16 pieces a stage, fewer stages).
template <int BM, int PIECES = 1>
using WgSmem = WgRing<BM, Int4FwdTiles::kWBytes, Int4FwdTiles::kSBytes,
                      wg_stages(BM, Int4FwdTiles::kWBytes, Int4FwdTiles::kSBytes, PIECES), PIECES>;

// One group's A fragments and scales for this thread: the weights of D rows
// gid and gid + 8 (tile columns c and c + 1), from the packed stage tile
// (TMA's 128B swizzle: 16-byte chunk q of byte row r sits at chunk q ^ (r &
// 7)).  k16 step h of the group reads byte rows 8h + t (A regs 0/1: K rows
// 2t, 2t + 1) and 8h + t + 4 (regs 2/3: K rows 2t + 8, 2t + 9); each byte is
// one register, turned into its bf16x2 pair with no int-to-float conversion.
struct WgGroup {
  uint32_t a[2][4];
  float s_lo, s_hi;
};

template <typename E>
__device__ __forceinline__ void wg_load(WgGroup& g, const uint8_t* ps, const __nv_bfloat16* ss,
                                        int o0, int o1, int c, int gi) {
  const uint8_t* p = ps + gi * 16 * WG_N;
  uint32_t v[4] = {*reinterpret_cast<const uint16_t*>(p + o0),
                   *reinterpret_cast<const uint16_t*>(p + o1),
                   *reinterpret_cast<const uint16_t*>(p + o0 + 8 * WG_N),
                   *reinterpret_cast<const uint16_t*>(p + o1 + 8 * WG_N)};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const uint32_t lo = v[2 * h], hi = v[2 * h + 1];
    const uint32_t lo4 = lo >> 4, hi4 = hi >> 4;
    g.a[h][0] = int4_pair<E>(lo, lo4, 0);  // column c
    g.a[h][1] = int4_pair<E>(lo, lo4, 1);  // column c + 1
    g.a[h][2] = int4_pair<E>(hi, hi4, 0);
    g.a[h][3] = int4_pair<E>(hi, hi4, 1);
  }
  const uint32_t s = *reinterpret_cast<const uint32_t*>(ss + gi * WG_N + c);
  g.s_lo = __uint_as_float(s << 16);
  g.s_hi = __uint_as_float(s & 0xFFFF0000u);
}

// The group's f32 partial (its first wgmma with scale-d = 0, so nothing is
// carried over) into part; asynchronous, waited for by wg_finish.  The f32
// form (PIECES 3) takes both k16 steps against the lo tile, then the mid
// tile, then the hi tile, into the same partial (the smallest pieces first:
// common.cuh, wg_issue_half).
template <int BM, typename E, int PIECES>
__device__ __forceinline__ void wg_issue(float (&part)[BM / 2], WgGroup& g, uint64_t desc) {
  wgmma_fence();
#pragma unroll
  for (int p = PIECES - 1; p >= 0; --p)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      wg_mma<BM, E>(part, g.a[h], desc + 2 * h + p * (BM * 8),
                    h == 0 && p == PIECES - 1 ? 0 : 1);
  wgmma_commit();
}
// Wait until at most PENDING groups are in flight (this one done), then acc
// += part * scale (row gid: column c, row gid + 8: column c + 1), one
// rounding each.
template <int BM, int PENDING>
__device__ __forceinline__ void wg_finish(float (&acc)[BM / 2], float (&part)[BM / 2], WgGroup& g) {
  wgmma_wait<PENDING>();
#pragma unroll
  for (int i = 0; i < BM / 2; ++i) pin(part[i]);
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int r = 0; r < 4; ++r) pin(g.a[h][r]);
#pragma unroll
  for (int j = 0; j < BM / 8; ++j) {
    acc[4 * j] = fmaf(part[4 * j], g.s_lo, acc[4 * j]);
    acc[4 * j + 1] = fmaf(part[4 * j + 1], g.s_lo, acc[4 * j + 1]);
    acc[4 * j + 2] = fmaf(part[4 * j + 2], g.s_hi, acc[4 * j + 2]);
    acc[4 * j + 3] = fmaf(part[4 * j + 3], g.s_hi, acc[4 * j + 3]);
  }
}

// Persistent, on common.cuh's ring, producer and epilogue (the producer's
// stage: x's BM x 64 tile, the 32 x 128 packed tile, the 2 x 128 scales).
// Warpgroups 0 and 1 each own 64 of the tile's columns: per group, 4 packed
// u16 loads become the A fragments of two wgmma m64n{BM}k16 (weights as A
// from registers, x's K-major rows as B from the swizzled tile) into one of
// two partial accumulators, and while they run the CUDA cores fold the
// other partial, the previous group's, into acc with that group's scale.
// E: x's and y's element, bf16 or f16; or (PIECES 3, the f32 form) E bf16,
// x f32 x's three bf16 pieces (a (3, M, K) buffer, sc.plane = M: each group
// six wgmmas into its partial, lo's, mid's, hi's) and y f32.
template <int BM, typename E, int PIECES>
__global__ void __launch_bounds__(WG_THREADS, 1)
int4_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                  const __grid_constant__ CUtensorMap pmap,
                  const __grid_constant__ CUtensorMap smap,
                  std::conditional_t<PIECES == 3, float, E>* __restrict__ y,
                  float* __restrict__ ws, int* __restrict__ arrivals, int M, int K, int N,
                  const WgSchedule sc) {
  using L = WgSmem<BM, PIECES>;
  extern __shared__ uint8_t wg_smem_raw[];
  uint64_t *full, *empty;
  int* merge_flag;
  uint8_t* smem = wg_setup<L>(wg_smem_raw, full, empty, merge_flag);
  if (threadIdx.x >= WG_CONSUMER_WARPS * 32) {
    wg_produce<BM, Int4FwdTiles, WG_STEP, L::kStages, PIECES>(&xmap, &pmap, &smap, smem, full,
                                                              empty, sc);
    return;
  }

  // the consumers
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(WG_CONSUMER_REGS));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int G = K / 32;
  const int wg = warp >> 2, w = warp & 3, gid = lane >> 2, t = lane & 3;
  const int c = wg * 64 + 16 * w + 2 * gid;  // tile columns of D rows gid (c) and gid + 8 (c + 1)
  const int q = c >> 4;                      // its 16-byte chunk of a packed row
  const int o0 = t * WG_N + ((q ^ t) << 4) + 2 * gid;              // byte row t
  const int o1 = (t + 4) * WG_N + ((q ^ (t + 4)) << 4) + 2 * gid;  // byte row t + 4
  const auto stage_p = [&](int s) { return smem + L::W_OFF + s * Int4FwdTiles::kWBytes; };
  const auto stage_s = [&](int s) {
    return reinterpret_cast<const __nv_bfloat16*>(smem + L::S_OFF + s * Int4FwdTiles::kSBytes);
  };
  // group 2i of a unit (a stage's first) goes through ga and p0, group 2i +
  // 1 through gb and p1; at most two groups' wgmmas in flight
  float acc[BM / 2], p0[BM / 2], p1[BM / 2];
  int st = 0;
  uint32_t ph = 0;
  for (int u = blockIdx.x; u < sc.units; u += gridDim.x) {
    int mt, sp, nt, s0, s1;
    sc.unit(u, mt, sp, nt, s0, s1);
    const int ng = min(G, s1 * WG_STAGE_GROUPS) - s0 * WG_STAGE_GROUPS;
    const int nstages = s1 - s0;
#pragma unroll
    for (int i = 0; i < BM / 2; ++i) acc[i] = 0.f;

    // Steady state: a stage of two groups with another stage after it; then
    // the unit's last stage, of one group or two.  The loop body has no
    // branch, so ptxas sees one group (p0's) in flight on every path into
    // and out of it and keeps the wgmmas asynchronous.
    WgGroup ga, gb;
    mbar_wait(&full[st], ph);
    wg_load<E>(ga, stage_p(st), stage_s(st), o0, o1, c, 0);
    wg_issue<BM, E, PIECES>(p0, ga, sw128_desc(smem + st * L::XS));
    for (int i = 0; i + 1 < nstages; ++i) {
      const int nst = st + 1 == L::kStages ? 0 : st + 1;
      const uint32_t nph = nst == 0 ? ph ^ 1 : ph;
      wg_load<E>(gb, stage_p(st), stage_s(st), o0, o1, c, 1);
      // the stage's k16 steps 2, 3
      wg_issue<BM, E, PIECES>(p1, gb, sw128_desc(smem + st * L::XS) + 4);
      wg_finish<BM, 1>(acc, p0, ga);
      mbar_wait(&full[nst], nph);
      wg_load<E>(ga, stage_p(nst), stage_s(nst), o0, o1, c, 0);
      wg_issue<BM, E, PIECES>(p0, ga, sw128_desc(smem + nst * L::XS));
      wg_finish<BM, 1>(acc, p1, gb);
      if (lane == 0) mbar_arrive(&empty[st]);  // this warp's wgmmas and loads of it are done
      st = nst;
      ph = nph;
    }
    if (ng % WG_STAGE_GROUPS == 0) {
      wg_load<E>(gb, stage_p(st), stage_s(st), o0, o1, c, 1);
      wg_issue<BM, E, PIECES>(p1, gb, sw128_desc(smem + st * L::XS) + 4);
      wg_finish<BM, 1>(acc, p0, ga);
      wg_finish<BM, 0>(acc, p1, gb);
    } else {
      wg_finish<BM, 0>(acc, p0, ga);
    }
    if (lane == 0) mbar_arrive(&empty[st]);
    if (++st == L::kStages) {
      st = 0;
      ph ^= 1;
    }
    wg_finish_unit<BM>(acc, Int4FwdTiles{}, y, ws, arrivals, merge_flag, sc, mt, sp, nt, c, M,
                       N);
  }
}

template <int BM, typename E, int PIECES>
int launch_wgmma(const void* x, const void* packed, const void* scale, void* y, void* ws,
                 void* arrivals, int M, int K, int N, const WgSchedule& sc, int ctas,
                 cudaStream_t stream) {
  PFN_cuTensorMapEncodeTiled_v12000 encode = tensor_map_encoder();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap xmap, pmap, smap;
  if (!act_map<E>(encode, &xmap, x, PIECES * M, K, BM) ||
      !tensor_map_2d(encode, &pmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, packed, K / 2, N, (size_t)N,
                     16 * WG_STAGE_GROUPS, WG_N, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !tensor_map_2d(encode, &smap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, scale, K / 32, N,
                     (size_t)N * 2, WG_STAGE_GROUPS, WG_N, CU_TENSOR_MAP_SWIZZLE_NONE))
    return (int)cudaErrorInvalidValue;
  using T = std::conditional_t<PIECES == 3, float, E>;
  constexpr int bytes = WgSmem<BM, PIECES>::BYTES;
  const cudaError_t opt_in = smem_opt_in<int4_wgmma_kernel<BM, E, PIECES>>(bytes);
  if (opt_in != cudaSuccess) return (int)opt_in;
  int4_wgmma_kernel<BM, E, PIECES><<<ctas, WG_THREADS, bytes, stream>>>(
      xmap, pmap, smap, static_cast<T*>(y), static_cast<float*>(ws),
      static_cast<int*>(arrivals), M, K, N, sc);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Split-K tensor-core kernel (bf16 / f16 activations, M <= 64: decode, verify)
// ---------------------------------------------------------------------------

// B1's view of common.cuh's split-K body.  A group is SkGroup: its packed
// bytes and scales.  Any order of a group's 16 K-row pairs serves, as long
// as A and B agree: lane quad t takes byte rows 4t..4t+3 (K rows 8t..8t+7),
// its x fragment the 16 contiguous bytes of a row there.  Its K half h (the
// mma's k16 step) takes byte rows 4t + 2h (A regs 0/1, B reg 0) and 4t + 2h
// + 1 (A regs 2/3, B reg 1); each packed byte is one A register (its two
// nibbles neighbouring K rows); each group's f32 partial is multiplied by
// its scale into the accumulator.  E: x's element, bf16 or f16.
template <typename E>
struct Int4SkView {
  using X = E;
  using Acc = float;
  template <int COLS>
  using Group = SkGroup<COLS>;
  struct Lane {
    const uint8_t* pcol;
    const __nv_bfloat16* scol;
  };
  const uint8_t* packed;
  const __nv_bfloat16* scale;

  __device__ __forceinline__ Lane lane(int n) const { return {packed + n, scale + n}; }
  template <int COLS>
  __device__ __forceinline__ void load(SkGroup<COLS>& d, const Lane& ln, int g, int t, int N,
                                       bool ok) const {
    sk_load<COLS>(d, ln.pcol, ln.scol, g, t, N, ok);
  }

  // acc += the group's products, its f32 partial of each column pair times
  // the pair's scales
  template <int MT, int COLS>
  __device__ __forceinline__ void group(const SkGroup<COLS>& d, const E* xs,
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
    uint32_t wsh[4][COLS / 4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int q = 0; q < COLS / 4; ++q) wsh[r][q] = d.w[r][q] >> 4;
#pragma unroll
    for (int j = 0; j < COLS / 2; ++j) {
      const int q = j >> 1, p = 2 * (j & 1);
      float part[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[mt][e] = 0.f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint32_t a[4] = {int4_pair<E>(d.w[2 * h][q], wsh[2 * h][q], p),
                               int4_pair<E>(d.w[2 * h][q], wsh[2 * h][q], p + 1),
                               int4_pair<E>(d.w[2 * h + 1][q], wsh[2 * h + 1][q], p),
                               int4_pair<E>(d.w[2 * h + 1][q], wsh[2 * h + 1][q], p + 1)};
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const uint32_t bb[2] = {h ? b[mt].z : b[mt].x, h ? b[mt].w : b[mt].y};
          mma_16816<E>(part[mt], a, bb);
        }
      }
      const float s_lo = __uint_as_float(d.s[j] << 16);          // column 2j
      const float s_hi = __uint_as_float(d.s[j] & 0xFFFF0000u);  // column 2j + 1
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        acc[mt][j][0] = fmaf(part[mt][0], s_lo, acc[mt][j][0]);
        acc[mt][j][1] = fmaf(part[mt][1], s_lo, acc[mt][j][1]);
        acc[mt][j][2] = fmaf(part[mt][2], s_hi, acc[mt][j][2]);
        acc[mt][j][3] = fmaf(part[mt][3], s_hi, acc[mt][j][3]);
      }
    }
  }
  template <typename T>
  __device__ __forceinline__ T out(float v, int, int) const {
    return from_f32<T>(v);
  }
};

template <int MT, int COLS, typename E>
__global__ void __launch_bounds__(SK_THREADS, MT <= 2 ? 4 : 2)
int4_splitk_mma_kernel(const E* __restrict__ x, const uint8_t* __restrict__ packed,
                       const __nv_bfloat16* __restrict__ scale, E* __restrict__ y,
                       float* __restrict__ ws, int* __restrict__ arrivals, int M, int K, int N,
                       int gps, int cg) {
  extern __shared__ __align__(16) unsigned char sk_smem[];
  sk_body<Int4SkView<E>, E, MT, COLS>(Int4SkView<E>{packed, scale}, x, y, ws, arrivals, M, K, N,
                                      gps, cg, sk_smem);
}

// The f32 form's view (f32 x and y): sk_body stages x's three bf16 pieces
// as three rows an x row, which the bf16 view's group takes as 3M rows.
struct Int4SkF32View : Int4SkView<__nv_bfloat16> {
  using X = float;
};

template <int MT, int COLS>
__global__ void __launch_bounds__(SK_THREADS, 4)
int4_splitk_f32_kernel(const float* __restrict__ x, const uint8_t* __restrict__ packed,
                       const __nv_bfloat16* __restrict__ scale, float* __restrict__ y,
                       float* __restrict__ ws, int* __restrict__ arrivals, int M, int K, int N,
                       int gps, int cg) {
  extern __shared__ __align__(16) unsigned char sk_smem[];
  sk_body<Int4SkF32View, float, MT, COLS>(Int4SkF32View{{packed, scale}}, x, y, ws, arrivals, M,
                                          K, N, gps, cg, sk_smem);
}

// ---------------------------------------------------------------------------
// Transposed kernels (B14): grad_x (M, K) = g (M, N) @ dequant(packed, scale)ᵀ
// ---------------------------------------------------------------------------

// The int4g32 weight view of common.cuh's transposed kernels: the scale
// changes along K/32 and N, so each weight is dequantized, E(E(q) * E(s))
// in g's element E (bf16 or f16), before the dot.  Output columns 2i and
// 2i+1 are the low and high nibbles of byte row i.  t_gemv_kernel (f32 g)
// reads only its floats.
template <typename E_ = __nv_bfloat16>
struct Int4TView {
  using E = E_;
  const uint8_t* packed;
  const __nv_bfloat16* scale;
  static constexpr int kCols = 4;  // two byte rows, inside one 32-row group
  static constexpr bool kFoldG = false;

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
        wq[2 * br][j] = nib_lo(b) * s[j];  // q * s, exact in f32
        wq[2 * br + 1][j] = nib_hi(b) * s[j];
      }
    }
  }

  // t_splitk_mma_kernel's view.  The warp's 32 rows (k0 % 32 == 0: one
  // scale group) are byte rows k0 / 2 + 8 rt + gid, rt 0 and 1; as in
  // t_wgmma_kernel, D rows gid and gid + 8 are a byte row's low and high
  // nibbles (output rows k0 + 16 rt + 2 gid and + 1), so each u16 of two
  // neighbouring bytes gives both rows' A registers for two contraction
  // elements (int4_rows_pair), each weight E(q * E(s)) by one E x2
  // multiply with the pair's scales.  p[rt]: the lane's 16 bytes of byte
  // row rt; s: the group's 16 scales at the same elements (32 bytes).
  struct TskChunk {
    uint4 p[2], s[2];
  };
  template <bool WIDE>
  __device__ __forceinline__ void tsk_load(TskChunk& d, int k0, int n, int N, int valid) const {
    const int gid = (threadIdx.x & 31) >> 2;
#pragma unroll
    for (int rt = 0; rt < 2; ++rt)
      d.p[rt] = tsk_ld16<WIDE>(packed + (size_t)(k0 / 2 + 8 * rt + gid) * N + n, valid);
    const uint4* sp = reinterpret_cast<const uint4*>(scale + (size_t)(k0 / 32) * N + n);
    d.s[0] = valid > 0 ? __ldg(sp) : make_uint4(0u, 0u, 0u, 0u);
    d.s[1] = valid > 8 ? __ldg(sp + 1) : make_uint4(0u, 0u, 0u, 0u);
  }
  __device__ __forceinline__ void tsk_frag(const TskChunk& d, int s, int rt,
                                           uint32_t (&a)[4]) const {
    const uint32_t v = word_at(d.p[rt], s);  // bytes 4s..4s+3: elements 4s..4s+3
    const uint32_t s01 = bf16x2_as<E>(word_at(d.s[s >> 1], 2 * (s & 1)));
    const uint32_t s23 = bf16x2_as<E>(word_at(d.s[s >> 1], 2 * (s & 1) + 1));
    uint32_t lo, hi;
    int4_rows_pair<E>(v, lo, hi);
    a[0] = mul2<E>(lo, s01);
    a[1] = mul2<E>(hi, s01);
    int4_rows_pair<E>(v >> 16, lo, hi);
    a[2] = mul2<E>(lo, s23);
    a[3] = mul2<E>(hi, s23);
  }
  __device__ static int tsk_row(int rt, int gid, int hi) { return 16 * rt + 2 * gid + hi; }

  // t_wgmma_kernel's view.  A stage: 64 byte rows (128 output columns) x 64
  // contraction bytes of packed (64B swizzle: 16-byte chunk h of byte row r
  // sits at chunk h ^ ((r >> 1) & 3)) and those rows' 4 x 64 scales.  D rows
  // gid and gid + 8 of a warp are the low and high nibbles of one byte row
  // (output columns c and c + 1): a u16 load of two neighbouring bytes gives
  // both rows' A registers for two contraction elements, each weight
  // E(q * E(s)) by one E x2 multiply of the exact q, one scale pair for
  // both rows (they share a group).
  static constexpr int kWBytes = (WG_N / 2) * WG_STEP;
  static constexpr int kSBytes = (WG_N / 32) * WG_STEP * 2;
  static constexpr int kRowStep = 1;
  static constexpr bool kColScale = false;
  __device__ const float* col_scale() const { return nullptr; }

  __device__ static void tma(const CUtensorMap* pmap, const CUtensorMap* smap, uint8_t* pdst,
                             uint8_t* sdst, int nt, int s, uint64_t* bar) {
    tma_load_2d(pdst, pmap, s * WG_STEP, nt * (WG_N / 2), bar);
    tma_load_2d(sdst, smap, s * WG_STEP, nt * (WG_N / 32), bar);
  }
  static bool maps(PFN_cuTensorMapEncodeTiled_v12000 encode, CUtensorMap* pmap, CUtensorMap* smap,
                   const void* packed, const void* scale, int K, int N) {
    return tensor_map_2d(encode, pmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, packed, K / 2, N,
                         (size_t)N, WG_N / 2, WG_STEP, CU_TENSOR_MAP_SWIZZLE_64B) &&
           tensor_map_2d(encode, smap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, scale, K / 32, N,
                         (size_t)N * 2, WG_N / 32, WG_STEP, CU_TENSOR_MAP_SWIZZLE_NONE);
  }

  // c: the output column of D row gid; o[h]: the bytes 16h + 2t, 2t + 1 of
  // its byte row (k16 step h; + 8 for 16h + 2t + 8); so: its scale row at
  // contraction 2t
  struct Lane {
    int c, so, o[4];
  };
  __device__ static Lane lane(int tid) {
    const int wg = tid >> 7, w = (tid >> 5) & 3, gid = (tid >> 2) & 7, t = tid & 3;
    Lane ln;
    ln.c = wg * 64 + 16 * w + 2 * gid;
    const int r = ln.c >> 1;
#pragma unroll
    for (int h = 0; h < 4; ++h) ln.o[h] = r * WG_STEP + ((h ^ ((r >> 1) & 3)) << 4) + 2 * t;
    ln.so = (ln.c >> 5) * WG_STEP * 2 + 4 * t;
    return ln;
  }
  template <int H>
  __device__ __forceinline__ void load(uint32_t (&f)[2][4], const uint8_t* wt, const uint8_t* st,
                                       const Lane& ln) const {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int h = 2 * H + i;
      const uint32_t v0 = *reinterpret_cast<const uint16_t*>(wt + ln.o[h]);
      const uint32_t v1 = *reinterpret_cast<const uint16_t*>(wt + ln.o[h] + 8);
      const uint32_t s0 = bf16x2_as<E>(*reinterpret_cast<const uint32_t*>(st + ln.so + 32 * h));
      const uint32_t s1 =
          bf16x2_as<E>(*reinterpret_cast<const uint32_t*>(st + ln.so + 32 * h + 16));
      uint32_t lo, hi;
      int4_rows_pair<E>(v0, lo, hi);
      f[i][0] = mul2<E>(lo, s0);
      f[i][1] = mul2<E>(hi, s0);
      int4_rows_pair<E>(v1, lo, hi);
      f[i][2] = mul2<E>(lo, s1);
      f[i][3] = mul2<E>(hi, s1);
    }
  }
};

// The split pass: each thread eight elements (two 16-byte reads, a 16-byte
// write a piece).
__global__ void split_bf16x3_kernel(const float* __restrict__ x, __nv_bfloat16* __restrict__ pieces,
                                    long long n) {
  const long long i = ((long long)blockIdx.x * blockDim.x + threadIdx.x) * 8;
  if (i >= n) return;
  const float4* src = reinterpret_cast<const float4*>(x + i);
  uint4 pc[3];
  split8_bf16x3(__ldg(src), __ldg(src + 1), pc);
#pragma unroll
  for (int p = 0; p < 3; ++p) *reinterpret_cast<uint4*>(pieces + p * n + i) = pc[p];
}

}  // namespace

extern "C" {

// Split-K CUDA-core kernel.  x of dtype code x_dtype (DT_F32, DT_BF16 or
// DT_F16), y the same type; ws holds nsplit * M * N floats; K % 32 == 0,
// N % 8 == 0, 16-byte aligned pointers (checked by the wrapper).
int chatglm_int4_gemv(const void* x, const void* packed, const void* scale, void* y, void* ws,
                      int M, int K, int N, int x_dtype, int nsplit, int groups_per_split,
                      void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const uint8_t* p = static_cast<const uint8_t*>(packed);
  const __nv_bfloat16* sc = static_cast<const __nv_bfloat16*>(scale);
  float* w = static_cast<float*>(ws);
  return with_act_type(x_dtype, [&](auto t) {
    using T = decltype(t);
    gemv<T>(static_cast<const T*>(x), p, sc, static_cast<T*>(y), w, M, K, N, nsplit,
            groups_per_split, s);
    return (int)cudaGetLastError();
  });
}

// Split-K tensor-core kernel, bf16 or f16 (x_dtype DT_BF16 / DT_F16, y the
// same type), one launch: M <= 8 * mt (mt 1-6 or 8), cols 16 (N % 16 == 0)
// or 8 columns a lane, nsplit splits of gps groups, x staged cg groups at a
// time (cg % 8 == 0); ws holds N/(8 cols) * nsplit * M * 8 cols floats
// (unused at nsplit 1), arrivals N/(8 cols) zeroed ints that every launch
// leaves at 0; K % 32 == 0, N % 8 == 0, 16-byte aligned pointers (checked
// by the wrapper).  f32 x and y (x_dtype DT_F32): x's pieces as 3M staged
// rows, 3M <= 8 mt, mt 1 or 2; ws holds the staged rows' partials.
int chatglm_int4_splitk_mma(const void* x, const void* packed, const void* scale, void* y,
                            void* ws, void* arrivals, int M, int K, int N, int x_dtype, int mt,
                            int cols, int nsplit, int gps, int cg, void* stream) {
  return with_act_type(x_dtype, [&](auto t) {
    using E = decltype(t);
    if constexpr (std::is_same_v<E, float>) {  // 3M staged rows, at most 2 m-tiles
      return sk_dispatch<2>(3 * M, N, mt, cols, nsplit, gps, cg, 2, [&](auto MT, auto COLS) {
        return sk_launch<int4_splitk_f32_kernel<decltype(MT)::value, decltype(COLS)::value>>(
            N, cols, nsplit, sk_smem_bytes(3 * M, cg, cols, 2),
            reinterpret_cast<cudaStream_t>(stream), static_cast<const float*>(x),
            static_cast<const uint8_t*>(packed), static_cast<const __nv_bfloat16*>(scale),
            static_cast<float*>(y), static_cast<float*>(ws), static_cast<int*>(arrivals), M, K,
            N, gps, cg);
      });
    } else {
      return sk_dispatch<8>(M, N, mt, cols, nsplit, gps, cg, 2, [&](auto MT, auto COLS) {
        return sk_launch<int4_splitk_mma_kernel<decltype(MT)::value, decltype(COLS)::value, E>>(
            N, cols, nsplit, sk_smem_bytes(M, cg, cols, 2), reinterpret_cast<cudaStream_t>(stream),
            static_cast<const E*>(x), static_cast<const uint8_t*>(packed),
            static_cast<const __nv_bfloat16*>(scale), static_cast<E*>(y),
            static_cast<float*>(ws), static_cast<int*>(arrivals), M, K, N, gps, cg);
      });
    }
  });
}

// Hopper tensor-core kernel, bf16 or f16 (x_dtype DT_BF16 / DT_F16, y the
// same type), one launch: tiles of bm (64 or 128) rows x 128 columns,
// nsplit K splits of gps groups (even where nsplit > 1: a split starts on a
// stage) over ctas persistent blocks (ops/quant_matmul.py::mma_plan); ws
// holds tiles * nsplit * bm * 128 floats (unused at nsplit 1), arrivals 2 *
// tiles zeroed ints that every launch leaves at 0; K % 32 == 0, N % 16 ==
// 0, 16-byte aligned pointers.  x_dtype DT_F32: the f32 form, x the (3, M,
// K) bf16 pieces of f32 x (chatglm_split_bf16x3) and y f32.
int chatglm_int4_wgmma(const void* x, const void* packed, const void* scale, void* y, void* ws,
                       void* arrivals, int M, int K, int N, int x_dtype, int bm, int nsplit,
                       int gps, int ctas, void* stream) {
  const int G = K / 32, steps = (G + WG_STAGE_GROUPS - 1) / WG_STAGE_GROUPS;
  if (M < 1 || K < 32 || K % 32 || N < 16 || N % 16 || gps < 1 || (nsplit > 1 && gps % 2) ||
      (nsplit - 1) * gps >= G || nsplit * gps < G)
    return (int)cudaErrorInvalidValue;
  const int sps = nsplit > 1 ? gps / WG_STAGE_GROUPS : steps;
  if (!wg_plan_ok(steps, bm, nsplit, sps, ctas, ws)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  WgSchedule sc = wg_schedule(M, bm, N, steps, nsplit, sps);
  return with_act_type(x_dtype, [&](auto t) {
    using E = decltype(t);
    if constexpr (std::is_same_v<E, float>) {
      sc.plane = M;
      using B = __nv_bfloat16;
      if (bm == 128)
        return launch_wgmma<128, B, 3>(x, packed, scale, y, ws, arrivals, M, K, N, sc, ctas, s);
      return launch_wgmma<64, B, 3>(x, packed, scale, y, ws, arrivals, M, K, N, sc, ctas, s);
    } else {
      if (bm == 128)
        return launch_wgmma<128, E, 1>(x, packed, scale, y, ws, arrivals, M, K, N, sc, ctas, s);
      return launch_wgmma<64, E, 1>(x, packed, scale, y, ws, arrivals, M, K, N, sc, ctas, s);
    }
  });
}

// B14, CUDA-core form: out (M, K) = g (M, N) @ dequant(packed (K/2, N),
// scale (K/32, N))ᵀ, g and out f32; K % 32 == 0, N % 8 == 0, aligned
// pointers.
int chatglm_int4_t_gemv(const void* g, const void* packed, const void* scale, void* out, int M,
                        int K, int N, int g_dtype, void* stream) {
  if (g_dtype != DT_F32) return (int)cudaErrorInvalidValue;
  const Int4TView<> wv{static_cast<const uint8_t*>(packed),
                       static_cast<const __nv_bfloat16*>(scale)};
  t_gemv(static_cast<const float*>(g), wv, static_cast<float*>(out), M, K, N,
         reinterpret_cast<cudaStream_t>(stream));
  return (int)cudaGetLastError();
}

// B14, split-K tensor-core form (t_splitk_mma_kernel), g and out of dtype
// code g_dtype (DT_BF16 or DT_F16), one launch: the plan and buffers of
// common.cuh's launch_t_splitk (ops/quant_matmul.py::t_splitk_plan); K %
// 32 == 0, N % 8 == 0, 16-byte aligned pointers.
int chatglm_int4_t_splitk(const void* g, const void* packed, const void* scale, void* out,
                          void* ws, void* arrivals, int M, int K, int N, int g_dtype, int mt,
                          int nsplit, int cps, int cs, void* stream) {
  return with_act_type(g_dtype, [&](auto t) {
    using E = decltype(t);
    if constexpr (std::is_same_v<E, float>) {
      return (int)cudaErrorInvalidValue;
    } else {
      const Int4TView<E> wv{static_cast<const uint8_t*>(packed),
                            static_cast<const __nv_bfloat16*>(scale)};
      return launch_t_splitk(wv, g, out, ws, arrivals, M, K, N, mt, nsplit, cps, cs,
                             reinterpret_cast<cudaStream_t>(stream));
    }
  });
}

// B14, tensor-core form (t_wgmma_kernel), g and out of dtype code g_dtype
// (DT_BF16 or DT_F16), one launch: tiles of bm (64 or 128) rows of g x 128
// output columns, nsplit splits of sps 64-column stages of N over ctas
// persistent blocks (ops/quant_matmul.py::t_mma_plan); ws holds tiles *
// nsplit * bm * 128 floats (unused at nsplit 1), arrivals 2 * tiles zeroed
// ints that every launch leaves at 0; K % 32 == 0, N % 16 == 0, 16-byte
// aligned pointers.
int chatglm_int4_t_mma(const void* g, const void* packed, const void* scale, void* out,
                         void* ws, void* arrivals, int M, int K, int N, int g_dtype, int bm,
                         int nsplit, int sps, int ctas, void* stream) {
  return with_act_type(g_dtype, [&](auto t) {
    using E = decltype(t);
    if constexpr (std::is_same_v<E, float>) {
      return (int)cudaErrorInvalidValue;
    } else {
      const Int4TView<E> wv{static_cast<const uint8_t*>(packed),
                            static_cast<const __nv_bfloat16*>(scale)};
      return launch_t_wgmma(wv, g, packed, scale, out, ws, arrivals, M, K, N, bm, nsplit, sps,
                            ctas, reinterpret_cast<cudaStream_t>(stream));
    }
  });
}

// The f32 forms' split pass (B1's and B6's Hopper kernels on f32 x): x (n
// f32, n % 8 == 0, 16-byte aligned) into pieces (3, n) bf16, hi, mid, lo
// (split_bf16x3), which the kernels' TMA then reads.  One read of x and
// one write of its pieces: bound by those 10 bytes an element.
int chatglm_split_bf16x3(const void* x, void* pieces, long long n, void* stream) {
  if (n < 8 || n % 8) return (int)cudaErrorInvalidValue;
  const long long chunks = n / 8;
  split_bf16x3_kernel<<<(unsigned)((chunks + 255) / 256), 256, 0,
                        reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<__nv_bfloat16*>(pieces), n);
  return (int)cudaGetLastError();
}

const char* chatglm_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"

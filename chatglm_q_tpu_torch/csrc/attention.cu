// Attention-side kernels of the serving path: the decode step's fused RoPE +
// KV append (dense cache and paged pool, and its write-only form), ragged
// decode attention (dense and paged), flash prefill attention (with its
// chunked-prefill form) and chunk attention over the paged pool.  The dense
// kernels read the cache in its (B, G, T, D) per-layer layout (a view of the
// (L, B, G, T, D) cache); the paged ones read one layer's (NP, G, P, D) view
// of the (L, NP, G, P, D) pool through a per-row page table.  All read
// lengths / starts / page tables from device tensors, so a decode step never
// syncs to the host.
//
// rope_kv_append_kernel<DenseKV> replaces
// chatglm_q_tpu/ops/pallas_attention.py:_kv_write_kernel (B3,
// kv_cache_write_idx) and rope_kv_append_kernel<PagedKV> replaces
// :_pool_write_kernel (B9, kv_pool_write_idx), each fused with the RoPE of
// q and k that XLA fuses around them on the TPU.  One launch per layer takes
// the decode token's q_proj row (B, H*D) and kv_proj row (B, 2*G*D, read
// through its row stride), rotates q and k by the step's freqs_cis row (B,
// D), writes the rotated q (B, G, Hg, D) for the decode attention and the
// rotated k and raw v into the slot: starts[b] clamped to [0, T - 1] in the
// dense cache (JAX's dynamic_update_slice clamp), min(starts[b], MP*P - 1)
// of page page_table[b, pos / P] at row pos % P in the pool.  Bound by
// bytes (~18.5 KB a row at 6B widths), which take nanoseconds: what bounds
// it is the launch.  So it replaces the 14 elementwise launches of the two
// plain RoPEs, the copy of the strided v and the two writes with one launch
// of one block per row, one 16-byte vector of q, k or v per thread.  Each
// pair is rotated as PyTorch's bf16 ops round it: every product and every
// sum in f32 (__fmul_rn / __fsub_rn / __fadd_rn: no contraction into an FMA)
// and rounded to bf16 at once, so the kernel is bit-equal to its plain
// version (an f32 rotation rounded once differs in ~14% of elements).  The
// table's bypass half (1, 0) goes through the same arithmetic.  kRope = false
// is the write-only form behind the bare B3 / B9 API: one (B, G, D) source
// into the slot, no rotation, no q.  On a sharded cache (K3) the view says
// whether it holds the clamped global position (DenseKV's T-shard, PagedKV's
// phase of a strided table); a row whose slot another rank holds only has
// its q rotated (q may hold a rank's heads only).
//
// Where K/V rows live (DenseKV, PagedKV below): the decode and prefill bodies,
// and the KV append, are each one template over the addressing of the rows
// they read (or write).  Dense:
// row pos of (row, g) at ((row*G + g)*T + pos)*D.  Paged: position pos of
// (row, g) in page page_table[row, pos / P] at row pos % P, resolved per
// 16-byte cp.async chunk, so any P works (a 64-row tile straddles pages when
// P % 64 != 0, and stays in one page when P % 64 == 0).  Reads stop at the
// table's capacity MP*P, so column MP of the table is never read (JAX's
// n_pages clamp).  The TPU kernels double-buffer whole pages; at P = 256,
// D = 128 that is 256 KB of staging, more than the 227 KB a block may use,
// so here pages go through the same 64-row tiles as the dense cache.
//
// decode_attn_kernel<false, DenseKV> replaces pallas_attention.py:_decode_kernel
// (B4: flash_attention_decode / _idx), decode_attn_kernel<true, DenseKV>
// replaces :_decode_v2_kernel (B12: flash_attention_decode_v2, the
// decode_attn_v2 option), decode_attn_kernel<true, PagedKV> replaces
// :_decode_paged_kernel (B10: flash_attention_decode_paged).  The forms
// tensor-parallel serving runs: kLse = true writes the merged (m, l) of
// each (b, g, head) beside the output (the block that writes the output
// writes them: block 0 of a one-span row, else the merging block), for K1
// (B4's return_lse form, the view a T-shard: DenseKV's offset) and K2
// (B10's stride / phase / return_lse form: PagedKV's strided table); the
// views' valid() turns lengths[b] + 1 into the rows of the view that hold
// slots 0..lengths[b], a prefix of the view, so the body is unchanged.
// Bound by bytes in principle (each valid K/V row read once, ~4
// operations per byte); at batch 1-4 those bytes take under a microsecond
// at the HBM rate, so what bounds it is latency: how many SMs share the
// reads and the chain of dependent steps in one block.  One (b, g) on the
// TPU is one sequential grid program; here the grid runs over (b*g, span of
// rows) for all three, with the span (a multiple of the 64-row tile) picked
// by the wrapper from the capacity (T, or MP*P) so that the grid covers the
// 132 SMs where the rows allow, and a span at or past lengths[b] + 1 exits
// before it reads anything (the O(length) property).  A (b, g) with few
// valid rows (at most DA_SOLO_ROWS, 256) is one span: at those sizes the
// cross-block merge costs more latency than reading a few tiles in one block.
//   A block is 4 warps over 64-row bf16 K/V tiles, staged by 16-byte
// cp.async into a 3-stage ring (the next two tiles in flight while one
// computes), rows padded to 272 bytes so ldmatrix reads them without bank
// conflicts.  The group's <= 16 query heads are the 16 rows of the mma A
// tile (the MQA sharing the TPU kernel exploits; rows >= Hg are zero and
// never stored), held in registers.  Each warp takes 16 rows of every tile:
// S = q K^T and O += P V by mma.sync m16n8k16 (bf16 in, f32 accumulate), K
// through ldmatrix and V through ldmatrix.trans, the online softmax in
// registers (quad shuffles), P turned into PV's A fragment without a trip
// through shared memory.  The warps' (m, l, acc) merge through shared memory
// at the end of the block; with one span the block writes the output,
// otherwise f32 partials, and the block that finishes a (b, g) last (an
// arrival counter: __threadfence, then atomicAdd) merges all spans in span
// order and resets the counter to 0, so the result is deterministic and one
// launch does the whole step (and a graph replay finds its counters at 0).
//   Numerics stay the TPU kernels': B4 scales the score by sm_scale in f32,
// sums l from f32 p and rounds p to bf16 for PV (what a bf16 mma consumes);
// B10 and B12 scale q by sm_scale and round it to bf16 first and keep p in
// f32 through PV, fed as two bf16 fragments, hi = bf16(p) and lo = bf16(p -
// hi) (~16 bits of p).  A row with no valid slot (lengths[b] == -1) outputs
// 0, as the TPU kernels' l == 0 guard gives.
//
// prefill_attn_kernel<DenseKV, false> replaces pallas_attention.py:_prefill_kernel
// (B5: flash_attention_prefill, and its q_starts / kv_row_map chunked form);
// prefill_attn_kernel<PagedKV, true> replaces :_chunk_paged_kernel (B11:
// flash_attention_chunk_paged, the speculative verify step and small prefill
// chunks).  B5 is bound by operations once it runs on the tensor cores (the
// chunked form does ~8.6 GFLOP over 4 x 256 rows on a 2048-slot cache).  The
// shape of FlashAttention-2: a block of 8 warps holds 128 folded (position,
// head) query rows (8 warps beat 4 on both of B5's forms on an H100, and
// halve the K/V re-reads), row r at position q0 + r / Hg and head r % Hg as
// on the TPU, so every head of the group shares each K/V tile; each warp owns
// 16 rows (one position at Hg = 16, so its causal bound is uniform) with
// their A fragments loaded once into registers.  64-row bf16 K/V tiles go
// through a 2-stage cp.async ring of the same padded rows as decode.  S = Q
// K^T by mma.sync, masked where pos > q_start + position or past the rows
// the block reads; the online softmax in registers; P as PV's A fragment, V
// by ldmatrix.trans, the f32 accumulators normalised at the end.  Query row
// r of batch b sits at absolute position q_starts[b] + r and reads K/V from
// cache (or table) row kv_row_map[b]; K/V tiles past the block's last causal
// position, past lengths[b] (B5) or past the capacity are not read, a warp
// skips a tile wholly above its rows' positions, rows of a length-0 row
// output 0, positions >= S are not stored.  Hg <= 64 folds (a block of one
// position at Hg = 64).
//   B11 is latency-bound like decode: at S = 9, Hg = 16, B = 4 the folded
// rows make only 16 blocks, each walking up to ~16 tiles.  So its K/V rows
// are split into spans as decode's are (the wrapper's chunk_span: whole
// tiles, at least 256 rows, halved while the grid leaves SMs idle), with
// the same in-launch merge per (b, g, query block): f32 partials, an arrival
// counter reset by the merging block, spans merged in order.  A span holding
// none of a row's causal positions leaves (m, l) = (-inf or MASK, ...) whose
// merge weight is 0.  B11's numerics are B10's: q pre-scaled in bf16, p f32
// through PV by hi/lo fragments (B5 rounds p to bf16, as it casts p to v's
// dtype).  B5 runs as one span.  wgmma / TMA tiles are later work.
//
// The fp8 cache (kv_dtype float8_e4m3fn; every kernel above also takes it:
// DenseKV / PagedKV over e4m3 bytes).  The TPU kernels cast K/V to the
// cache's dtype on the write (_kv_write_kernel :432, _pool_write_kernel
// :485) and upcast each tile after its DMA (_decode_kernel :239, the paged
// decode and chunk kernels :839, :992).  Here the append stores 8 bytes a
// vector of 8 where bf16 stores 16: each element rounded bf16 -> f32 ->
// e4m3 by cvt.rn.satfinite after a clamp to +-448, every NaN stored as 0x7F
// (ops/attention.py:kv_store_cast's bytes).  The readers copy 128-byte fp8
// rows by cp.async into a ring of fp8 stages (half the bytes of a bf16
// ring: the bytes are what bounds decode at long context), and once a stage
// lands the block converts it exactly to bf16 into one padded tile that the
// bf16 fragment code reads unchanged (e4m3 -> bf16 is exact: 4 exponent
// bits and 3 mantissa bits fit bf16's 8 and 7, subnormals m * 2^-9
// included): a pass through shared memory and a barrier a tile.  So an fp8
// form computes exactly its bf16 form on the upcast cache.  q is not
// quantized and no product runs in fp8 (an fp8 mma would compute another
// function than the TPU's).  Converting in registers without the pass is
// later work.
//
// float16 (a float16 checkpoint's activations, over a float16 cache or an
// fp8 one: every kernel above also takes both).  The TPU kernels are
// dtype-generic: K/V are read in q's dtype (pallas_attention.py:239-261,
// an fp8 cache upcast to it after the load) and p is cast to v's dtype.
// Here each kernel is a template over the activations' element A (bf16 or
// f16) and the cache's element T (A itself, or e4m3), the pair the entry's
// form code names (with_kv_type): the f16 forms stage f16 tiles as the
// bf16 forms stage theirs and run mma.sync .f32.f16.f16, at bf16's rate;
// over an fp8 cache each landed stage converts exactly to the f16 tile
// (e4m3x8_f16: every e4m3 value is an f16 value).  The rounding points
// stay the TPU's, now in f16: B4 and B5 round p to f16 for PV; B10, B11
// and B12 round the pre-scaled q to f16 and keep p in f32 through PV as hi
// = f16(p) and lo = f16(p - hi); the append rounds each RoPE product and
// sum to f16, and over an fp8 cache stores f16 -> f32 -> e4m3 as from
// bf16.
//
// float32 (a float32 checkpoint, GLMLoadConfig's default dtype: f32
// activations over an f32 cache, or over an fp8 one; forms 4 and 5).  The
// TPU kernels run f32 as they run any dtype, and the limit is f32's (1e-5
// of max|out|), which TF32 (10 mantissa bits) cannot meet, so the f32 forms
// take no tensor-core path: A = float instantiates CUDA-core bodies
// (kIsF32) inside the same kernels.  Each thread computes by FFMA exactly
// the elements the m16n8 mma tiles would hand it (qk_16keys: scores of rows
// gid, gid + 8 and keys 2 tig + {0, 1} of each 8-key tile; pv_16keys_f32:
// acc's columns n * 8 + 2 tig + {0, 1}, p shuffled across the quad), so
// the online softmax, the warps' merge, the span merges, the masks and the
// epilogues are the 16-bit forms' code; q stays in shared memory (QRows<
// float>) instead of fragments.  The rounding points are the TPU's in f32:
// B4 scales the f32 score by sm_scale, B10 / B11 / B12 round q * sm_scale to
// f32 first (decode while staging q, the chunk kernel in place in each
// warp's rows), p stays f32 through PV everywhere.  Staged rows are 528
// bytes (kRow<float>: one 16-byte chunk of padding, so a quarter-warp's
// float4 loads of 4 K rows or 2 q rows hit distinct banks).  Shared memory:
// f32 tiles are twice as large, and both rings still fit a block's 227 KB,
// so the 16-bit forms' depths stay: decode keeps its 3-stage ring (16 q
// rows + 3 x (K, V) x 64 rows = 211,200 bytes; over fp8 125,184), prefill
// its 2 stages beside its 128 q rows (202,752 bytes; over fp8 167,936); one
// block per SM either way.  Over an fp8 cache each landed stage converts
// exactly to the f32 tile (land8: e4m3 -> bf16 exactly, then widened).
// The append's vectors hold 4 floats (rope_vec rotates two pairs, each
// product and sum the f32 op PyTorch runs), and into an fp8 cache it
// rounds f32 -> e4m3 once (store_vec: the clamp, then cvt.rn.satfinite
// from f32), as JAX's new.astype(float8_e4m3fn) does.  3xTF32 or split
// bf16 on the tensor cores is later work.
#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;
using f16 = __half;
using e4m3 = uint8_t;  // a float8_e4m3fn cache element, as its byte

// ---------------------------------------------------------------------------
// Tensor-core tiles of the decode and prefill kernels
// ---------------------------------------------------------------------------

constexpr int ATT_D = 128;            // head dim the kernels are built for
template <class E>
constexpr bool kIsF32 = std::is_same_v<E, float>;
template <class E>
constexpr int kVec = 16 / sizeof(E);  // elements of E in a 16-byte vector
// Elements of E per staged row: the head dim and one 16-byte chunk of
// padding.  16-bit rows are 272 bytes, so the 8 rows of one ldmatrix phase
// fall in distinct banks; f32 rows 528 bytes, so the 4 K rows (2 q rows) of
// a quarter-warp's 16-byte loads do.
template <class E>
constexpr int kRow = ATT_D + kVec<E>;
constexpr int KV_TK = 64;             // K/V rows per tile
constexpr int DA_STAGES = 3;          // cp.async ring depth of decode (two tiles ahead)
constexpr int PF_STAGES = 2;          // and of prefill (one tile ahead)
constexpr int MMA_HEADS = 16;         // rows of decode's A tile: the KV group's heads
constexpr int DA_WARPS = KV_TK / 16;  // decode: 16 rows of each tile per warp
constexpr int DA_THREADS = DA_WARPS * 32;
constexpr int DA_SOLO_ROWS = 256;     // decode: a (b, g) with at most this many valid
                                      // rows is one span (no cross-block merge)
constexpr int PF_WARPS = 8;           // prefill: 16 folded query rows per warp
constexpr int PF_ROWS = PF_WARPS * 16, PF_THREADS = PF_WARPS * 32;

// The dense cache: the (Bk, G, T, D) layer view of elements T_ (bf16, f16,
// or e4m3 bytes).  A T-shard of a cache of `total` slots (kv_shard_t) holds
// global slots offset .. offset + T - 1; the whole cache is offset 0, total T.
template <class T_>
struct DenseKV {
  using elem = T_;
  const T_* k;
  const T_* v;
  int G, T, offset, total;
  struct Slab {  // the T rows of one (row, group)
    const T_* k;
    const T_* v;
    __device__ __forceinline__ size_t row(int pos) const { return (size_t)pos * ATT_D; }
  };
  __device__ __forceinline__ int capacity() const { return T; }
  // local rows holding the global slots 0 .. n - 1: a prefix of the view
  __device__ __forceinline__ int valid(int n) const { return min(max(n - offset, 0), T); }
  // the global write position's clamp (JAX's dynamic_update_slice), and the
  // local row of global slot pos where this view holds it
  __device__ __forceinline__ int clamp_pos(int pos) const { return min(max(pos, 0), total - 1); }
  __device__ __forceinline__ bool owns(int pos, int& t) const {
    t = pos - offset;
    return t >= 0 && t < T;
  }
  __device__ __forceinline__ Slab slab(int r, int g) const {
    const size_t base = ((size_t)r * G + g) * T * ATT_D;
    return {k + base, v + base};
  }
};

// The paged pool: the (NP, G, P, D) view of one layer, read through a
// (rows, MP) page table.  A model-sharded pool's strided view (stride tp,
// phase = the model rank) maps table column i to logical block i * stride +
// phase of a row of `total` logical positions; the whole pool is stride 1,
// phase 0, total MP * P.  Local positions (column i, row t % P at i * P +
// t % P) are what Slab::row reads.
template <class T_>
struct PagedKV {
  using elem = T_;
  const T_* k;
  const T_* v;
  const int* page_table;
  int G, P, MP, stride, phase, total;
  struct Slab {  // the MP * P positions of one (table row, group)
    const T_* k;
    const T_* v;
    const int* pages;  // the row's MP page ids
    int G, g, P;
    __device__ __forceinline__ size_t row(int pos) const {
      const int blk = pos / P;
      return (((size_t)__ldg(pages + blk) * G + g) * P + (pos - blk * P)) * ATT_D;
    }
  };
  __device__ __forceinline__ int capacity() const { return MP * P; }
  // local positions holding logical positions 0 .. n - 1, a prefix of the
  // view: the columns whose logical block starts below n (at most MP,
  // JAX's n_pages clamp), the last one up to n
  __device__ __forceinline__ int valid(int n) const {
    const int blocks = (n + P - 1) / P;  // logical blocks touched (n > 0)
    if (n <= 0 || blocks <= phase) return 0;
    const int cols = min((blocks - phase + stride - 1) / stride, MP);
    const int last = (cols - 1) * stride + phase;  // its logical block
    return (cols - 1) * P + min(P, n - last * P);
  }
  __device__ __forceinline__ int clamp_pos(int pos) const { return min(max(pos, 0), total - 1); }
  __device__ __forceinline__ bool owns(int pos, int& t) const {
    const int blk = pos / P, col = blk / stride;
    t = col * P + (pos - blk * P);
    return blk - col * stride == phase && col < MP;
  }
  __device__ __forceinline__ Slab slab(int r, int g) const {
    return {k, v, page_table + (size_t)r * MP, G, g, P};
  }
};

// ---------------------------------------------------------------------------
// Decode KV append (B3, B9), with the RoPE of q and k
// ---------------------------------------------------------------------------

// One 16-byte vector of (x0, x1) pairs of A rotated by their (f0, f1)
// table entries, rounded as the plain ops in A round them: o_r = A(A(x0*f0)
// - A(x1*f1)), o_i = A(A(x0*f1) + A(x1*f0)), each operation in f32 (four
// pairs of bf16 or f16, two of f32: there every product and sum is the f32
// op PyTorch runs, with no contraction into an FMA).
template <class A>
__device__ __forceinline__ uint4 rope_vec(uint4 x, uint4 f) {
  if constexpr (kIsF32<A>) {
    const float x0 = __uint_as_float(x.x), x1 = __uint_as_float(x.y);
    const float x2 = __uint_as_float(x.z), x3 = __uint_as_float(x.w);
    const float f0 = __uint_as_float(f.x), f1 = __uint_as_float(f.y);
    const float f2 = __uint_as_float(f.z), f3 = __uint_as_float(f.w);
    return make_uint4(__float_as_uint(__fsub_rn(__fmul_rn(x0, f0), __fmul_rn(x1, f1))),
                      __float_as_uint(__fadd_rn(__fmul_rn(x0, f1), __fmul_rn(x1, f0))),
                      __float_as_uint(__fsub_rn(__fmul_rn(x2, f2), __fmul_rn(x3, f3))),
                      __float_as_uint(__fadd_rn(__fmul_rn(x2, f3), __fmul_rn(x3, f2))));
  } else {
    const uint32_t xs[4] = {x.x, x.y, x.z, x.w}, fs[4] = {f.x, f.y, f.z, f.w};
    uint32_t o[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 xp = unpack2<A>(xs[j]);
      const float2 fp = unpack2<A>(fs[j]);
      const float rr = __fsub_rn(round_to<A>(__fmul_rn(xp.x, fp.x)),
                                 round_to<A>(__fmul_rn(xp.y, fp.y)));
      const float ri = __fadd_rn(round_to<A>(__fmul_rn(xp.x, fp.y)),
                                 round_to<A>(__fmul_rn(xp.y, fp.x)));
      o[j] = pack2<A>(rr, ri);
    }
    return make_uint4(o[0], o[1], o[2], o[3]);
  }
}

// The fp8 store: x (bf16 or f16, exact in f32; or f32 itself) clamped to
// +-448 and rounded to nearest even from f32 by the card's
// cvt.rn.satfinite, once, NaN stored as 0x7F (ops/attention.py:
// kv_store_cast).  Two elements, lo in the low byte.
constexpr float E4M3_MAX = 448.f;
constexpr uint32_t E4M3_NAN = 0x7Fu;
__device__ __forceinline__ uint32_t e4m3x2_store(float lo, float hi) {
  uint16_t r;
  asm("cvt.rn.satfinite.e4m3x2.f32 %0, %1, %2;"
      : "=h"(r)
      : "f"(fminf(fmaxf(hi, -E4M3_MAX), E4M3_MAX)), "f"(fminf(fmaxf(lo, -E4M3_MAX), E4M3_MAX)));
  uint32_t out = r;
  if (lo != lo) out = (out & 0xFF00u) | E4M3_NAN;
  if (hi != hi) out = (out & 0x00FFu) | (E4M3_NAN << 8);
  return out;
}

// One 16-byte vector of activations A stored as the cache's elements T: as
// they are (T = A), or as e4m3 bytes, 8 of them from bf16 or f16 (each
// element exact in f32 first), 4 from f32.
template <class A, class T>
__device__ __forceinline__ void store_vec(T* dst, uint4 x) {
  if constexpr (std::is_same_v<T, e4m3> && kIsF32<A>) {
    *reinterpret_cast<uint32_t*>(dst) =
        e4m3x2_store(__uint_as_float(x.x), __uint_as_float(x.y)) |
        (e4m3x2_store(__uint_as_float(x.z), __uint_as_float(x.w)) << 16);
  } else if constexpr (std::is_same_v<T, e4m3>) {
    const uint32_t xs[4] = {x.x, x.y, x.z, x.w};
    uint32_t b[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = unpack2<A>(xs[j]);
      b[j] = e4m3x2_store(f.x, f.y);
    }
    *reinterpret_cast<uint2*>(dst) = make_uint2(b[0] | (b[1] << 16), b[2] | (b[3] << 16));
  } else {
    static_assert(std::is_same_v<T, A>, "a cache that is not fp8 holds the activations' type");
    *reinterpret_cast<uint4*>(dst) = x;
  }
}

// The exact upcast: two e4m3 bytes, each the low byte of a 16-bit half of
// x, to bf16x2.  Their exponent and mantissa bits moved into bf16's places
// give the value times 2^-120 (a subnormal e = 0, m * 2^-9, lands on bf16's
// subnormal m * 2^-129), and one bf16 product by 2^120 rebiases it exactly
// (the card's bf16 fma keeps subnormal inputs); the sign is or-ed back.
// The NaN bytes 0x7F / 0xFF would come out as 480: the caller fixes them.
__device__ __forceinline__ uint32_t e4m3x2_bf16x2(uint32_t x) {
  const uint32_t mag = (x << 4) & 0x07F007F0u;
  uint32_t y;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;" : "=r"(y) : "r"(mag), "r"(0x7B807B80u), "r"(0x80008000u));
  return y | ((x << 8) & 0x80008000u);
}

// The same to f16x2: the exponent and mantissa bits moved into f16's
// places give the value times 2^-8 (a subnormal m * 2^-9 lands on f16's
// subnormal m * 2^-17), and one f16 product by 2^8 rebiases it exactly (the
// card's f16 arithmetic keeps subnormals); the sign is or-ed back.  The
// NaN bytes would come out as 480: the caller fixes them.
__device__ __forceinline__ uint32_t e4m3x2_f16x2(uint32_t x) {
  const uint32_t mag = (x << 7) & 0x3F803F80u;
  uint32_t y;
  asm("mul.rn.f16x2 %0, %1, %2;" : "=r"(y) : "r"(mag), "r"(0x5C005C00u));
  return y | ((x << 8) & 0x80008000u);
}

// 8 e4m3 bytes to 8 elements of A (bf16 or f16), exactly; a NaN byte to the
// quiet NaN of its sign (bf16 0x7FC0 / 0xFFC0, f16 0x7E00 / 0xFE00: JAX's
// upcast).
template <class A>
__device__ __forceinline__ uint4 e4m3x8_act(uint2 w) {
  const auto up = [](uint32_t x) {
    if constexpr (kIsF16<A>)
      return e4m3x2_f16x2(x);
    else
      return e4m3x2_bf16x2(x);
  };
  uint4 o = make_uint4(up(__byte_perm(w.x, 0u, 0x4140)), up(__byte_perm(w.x, 0u, 0x4342)),
                       up(__byte_perm(w.y, 0u, 0x4140)), up(__byte_perm(w.y, 0u, 0x4342)));
  // a byte with e = 15, m = 7 (NaN) carries into bit 7 when 1 is added to its low 7 bits
  if ((((w.x & 0x7F7F7F7Fu) + 0x01010101u) | ((w.y & 0x7F7F7F7Fu) + 0x01010101u)) &
      0x80808080u) {
    constexpr uint32_t kQuietNaN = kIsF16<A> ? 0x7E00u : 0x7FC0u;
    uint32_t h[4] = {o.x, o.y, o.z, o.w};
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const uint32_t byte = ((i < 4 ? w.x : w.y) >> ((i & 3) * 8)) & 0xFFu;
      if ((byte & 0x7Fu) == E4M3_NAN) {
        const uint32_t nan = kQuietNaN | ((byte & 0x80u) << 8);
        const int shift = (i & 1) * 16;
        h[i / 2] = (h[i / 2] & ~(0xFFFFu << shift)) | (nan << shift);
      }
    }
    o = make_uint4(h[0], h[1], h[2], h[3]);
  }
  return o;
}

// 8 e4m3 bytes landed as 8 elements of A at dst, exactly: bf16 or f16 as
// e4m3x8_act gives them, f32 as the bf16 values widened (a bf16 value is
// the high half of its f32; a NaN byte to the f32 quiet NaN of its sign).
template <class A>
__device__ __forceinline__ void land8(A* dst, uint2 w) {
  if constexpr (kIsF32<A>) {
    const uint4 h = e4m3x8_act<bf16>(w);
    reinterpret_cast<uint4*>(dst)[0] =
        make_uint4(h.x << 16, h.x & 0xFFFF0000u, h.y << 16, h.y & 0xFFFF0000u);
    reinterpret_cast<uint4*>(dst)[1] =
        make_uint4(h.z << 16, h.z & 0xFFFF0000u, h.w << 16, h.w & 0xFFFF0000u);
  } else {
    *reinterpret_cast<uint4*>(dst) = e4m3x8_act<A>(w);
  }
}

// One block per row b, one 16-byte vector a thread (a loop where the row
// has more vectors than a block has threads): first the row's G*Hg*D q
// elements (kRope only), then its kv row, k's G*D elements and (kRope only)
// v's.  The cache views are the attention kernels' read-only views; the
// slot this kernel writes is read by no other thread of the launch.  An
// fp8 cache stores each vector as its bytes (store_vec).  A: the
// activations' element (bf16, f16 or f32), V of them a vector.
template <class KV, bool kRope, class A>
__global__ void rope_kv_append_kernel(const A* __restrict__ q, A* __restrict__ q_out,
                                      const A* __restrict__ kv, int kv_stride,
                                      const A* __restrict__ freqs, const KV cache,
                                      const int* __restrict__ starts, int nq, int nkv) {
  const int b = blockIdx.x;
  const A* f_row = freqs + (size_t)b * ATT_D;
  // B3's / B9's clamp of the global position, then its row in this view:
  // a shard that does not hold the slot rotates q and writes nothing
  int pos;
  const bool own = cache.owns(cache.clamp_pos(starts[b]), pos);
  constexpr int V = kVec<A>;
  for (int i = threadIdx.x; i < nq + (kRope ? 2 : 1) * nkv; i += blockDim.x) {
    if (i < nq) {
      const int e = i * V;
      const uint4 x = *reinterpret_cast<const uint4*>(q + (size_t)b * nq * V + e);
      const uint4 f = *reinterpret_cast<const uint4*>(f_row + e % ATT_D);
      *reinterpret_cast<uint4*>(q_out + (size_t)b * nq * V + e) = rope_vec<A>(x, f);
      continue;
    }
    if (!own) break;  // block-uniform: the q vectors come first
    const int j = i - nq;  // vector j of the kv row
    const bool is_k = j < nkv;
    const int e = (is_k ? j : j - nkv) * V;  // element of k (or v): group e / D, lane e % D
    uint4 x = *reinterpret_cast<const uint4*>(kv + (size_t)b * kv_stride + (size_t)j * V);
    if (kRope && is_k) x = rope_vec<A>(x, *reinterpret_cast<const uint4*>(f_row + e % ATT_D));
    const auto slab = cache.slab(b, e / ATT_D);
    using T = typename KV::elem;
    store_vec<A>(const_cast<T*>((is_k ? slab.k : slab.v) + slab.row(pos)) + e % ATT_D, x);
  }
}

// Hq: the q heads of a row (G * Hg; a rank's heads under tensor parallelism);
// q, q_out, kv and freqs of the activations' element A
template <class KV, bool kRope, class A>
int launch_append(const void* q, void* q_out, const void* kv, int kv_stride, const void* freqs,
                  const KV& cache, const int* starts, int B, int G, int Hq, cudaStream_t stream) {
  const int nq = kRope ? Hq * ATT_D / kVec<A> : 0, nkv = G * ATT_D / kVec<A>;
  const int n = nq + (kRope ? 2 : 1) * nkv;
  const int threads = n < 1024 ? (n + 31) / 32 * 32 : 1024;
  rope_kv_append_kernel<KV, kRope, A><<<B, threads, 0, stream>>>(
      static_cast<const A*>(q), static_cast<A*>(q_out), static_cast<const A*>(kv), kv_stride,
      static_cast<const A*>(freqs), cache, starts, nq, nkv);
  return (int)cudaGetLastError();
}

// Copy K/V rows t0 .. t0+KV_TK-1 of one slab into a ring stage with
// cp.async (rows of ROW elements T: bf16 rows padded for ldmatrix, or the
// fp8 staging rows of ATT_D bytes); rows at or past `end` are zero-filled
// (+0 in either type) and read nothing (nor their page id).  Every chunk's
// address first, so that a paged slab's page lookups are in flight together.
template <int NT, class Slab, class T, int ROW>
__device__ __forceinline__ void stage_kv(T (*ks)[ROW], T (*vs)[ROW], const Slab& src, int t0,
                                         int end) {
  constexpr int EC = 16 / sizeof(T);  // elements per 16-byte chunk
  constexpr int CH = ATT_D / EC;      // chunks per row
  constexpr int N = KV_TK * CH / NT;
  static_assert((KV_TK * CH) % NT == 0, "whole passes");
  size_t off[N];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const int i = threadIdx.x + j * NT, pos = t0 + i / CH;
    off[j] = pos < end ? src.row(pos) + (i % CH) * EC : 0;
  }
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const int i = threadIdx.x + j * NT;
    const int r = i / CH, c = (i % CH) * EC;
    const bool ok = t0 + r < end;
    cp_async16(&ks[r][c], src.k + off[j], ok);
    cp_async16(&vs[r][c], src.v + off[j], ok);
  }
}

// A fragments of a warp's 16 query rows (row-major, kRow<A> apart), once.
template <class A>
__device__ __forceinline__ void load_q_frags(A (*qs)[kRow<A>], uint32_t (&qa)[ATT_D / 16][4]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int kk = 0; kk < ATT_D / 16; ++kk)
    ldmatrix_x4(qa[kk], &qs[lane & 15][kk * 16 + (lane >> 4) * 8]);
}

// q * sm_scale rounded to q's type A (bf16 or f16), element by element in
// the fragments: B10, B11 and B12 scale q in its dtype before the dot, as
// the TPU kernels' wrappers do.
template <class A>
__device__ __forceinline__ void scale_q_frags(uint32_t (&qa)[ATT_D / 16][4], float sm_scale) {
#pragma unroll
  for (int kk = 0; kk < ATT_D / 16; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = unpack2<A>(qa[kk][i]);
      qa[kk][i] = pack2<A>(f.x * sm_scale, f.y * sm_scale);
    }
}

// The query rows a warp multiplies: its 16 rows' A fragments, loaded once
// into registers (bf16, f16); f32 rows stay in shared memory and the
// CUDA-core products read them there.  With kScale, q * sm_scale rounded to
// A first (B10, B11, B12): in the fragments, or (f32) in place in shared
// memory, where the rows must be the warp's own.
template <class A>
struct QRows {
  uint32_t a[ATT_D / 16][4];
  template <bool kScale>
  __device__ __forceinline__ void load(A (*qs)[kRow<A>], float sm_scale) {
    load_q_frags(qs, a);
    if (kScale) scale_q_frags<A>(a, sm_scale);
  }
};
template <>
struct QRows<float> {
  const float (*q)[kRow<float>];
  template <bool kScale>
  __device__ __forceinline__ void load(float (*qs)[kRow<float>], float sm_scale) {
    if (kScale) {
      for (int i = threadIdx.x & 31; i < 16 * ATT_D; i += 32)
        qs[i / ATT_D][i % ATT_D] = __fmul_rn(qs[i / ATT_D][i % ATT_D], sm_scale);
      __syncwarp();
    }
    q = qs;
  }
};

__device__ __forceinline__ float dot4(float4 a, float4 b, float c) {
  return fmaf(a.w, b.w, fmaf(a.z, b.z, fmaf(a.y, b.y, fmaf(a.x, b.x, c))));
}

// s[2j], s[2j+1] += q (16 x D) . K rows n0 .. n0+15 of the tile, transposed:
// the m16n8 score tiles of 16 keys.  bf16 / f16: mma.sync.  f32: each
// thread computes its own elements of those tiles by FFMA from the f32
// tiles (rows gid and gid + 8, keys n0 + 8 j + 2 tig + (e & 1)), so the
// softmax, PV and the merges take the same layout.
template <class A>
__device__ __forceinline__ void qk_16keys(const QRows<A>& q, A (*ks)[kRow<A>], int n0,
                                          float (*s)[4]) {
  const int lane = threadIdx.x & 31;
  if constexpr (kIsF32<A>) {
    const int gid = lane >> 2, tig = lane & 3;
    const float* qr[2] = {q.q[gid], q.q[gid + 8]};
    const float* kr[4] = {ks[n0 + 2 * tig], ks[n0 + 2 * tig + 1], ks[n0 + 8 + 2 * tig],
                          ks[n0 + 9 + 2 * tig]};
#pragma unroll 4
    for (int d = 0; d < ATT_D; d += 4) {
      float4 qv[2], kv[4];
#pragma unroll
      for (int h = 0; h < 2; ++h) qv[h] = *reinterpret_cast<const float4*>(qr[h] + d);
#pragma unroll
      for (int c = 0; c < 4; ++c) kv[c] = *reinterpret_cast<const float4*>(kr[c] + d);
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          s[c >> 1][2 * h + (c & 1)] = dot4(qv[h], kv[c], s[c >> 1][2 * h + (c & 1)]);
    }
  } else {
#pragma unroll
    for (int kk = 0; kk < ATT_D / 16; ++kk) {
      uint32_t kf[4];
      ldmatrix_x4(kf, &ks[n0 + (lane & 7) + ((lane >> 4) << 3)][kk * 16 + ((lane >> 3) & 1) * 8]);
      mma_16816<A>(s[0], q.a[kk], kf);
      mma_16816<A>(s[1], q.a[kk], kf + 2);
    }
  }
}

// f32: acc (16 x D) += p (16 x 16, f32 in the two m16n8 score tiles) . V
// rows k0 .. k0+15 by FFMA.  The p of a key sits in one lane of each quad;
// a shuffle brings it to the quad's other lanes, which hold the other
// columns of its rows (acc's C layout: rows gid, gid + 8, columns n * 8 + 2
// tig + {0, 1}).
__device__ __forceinline__ void pv_16keys_f32(float (*p)[4], float (*vs)[kRow<float>], int k0,
                                              float (&acc)[ATT_D / 8][4]) {
  const int lane = threadIdx.x & 31, tig = lane & 3, quad = lane & ~3;
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      float pj[4];  // keys 8 j + 2 t + {0, 1} of rows gid (0, 1) and gid + 8 (2, 3)
#pragma unroll
      for (int e = 0; e < 4; ++e) pj[e] = __shfl_sync(0xffffffffu, p[j][e], quad | t);
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const float* v = vs[k0 + 8 * j + 2 * t + u] + 2 * tig;
#pragma unroll
        for (int n = 0; n < ATT_D / 8; ++n) {
          const float2 vv = *reinterpret_cast<const float2*>(v + n * 8);
          acc[n][0] = fmaf(pj[u], vv.x, acc[n][0]);
          acc[n][1] = fmaf(pj[u], vv.y, acc[n][1]);
          acc[n][2] = fmaf(pj[2 + u], vv.x, acc[n][2]);
          acc[n][3] = fmaf(pj[2 + u], vv.y, acc[n][3]);
        }
      }
    }
}

// acc (16 x D) += p (16 x 16, an A fragment) . V rows k0 .. k0+15 of the tile.
template <class A>
__device__ __forceinline__ void pv_16keys(const uint32_t (&pa)[4], A (*vs)[kRow<A>],
                                          int k0, float (&acc)[ATT_D / 8][4]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int n2 = 0; n2 < ATT_D / 16; ++n2) {
    uint32_t vf[4];
    ldmatrix_x4_trans(vf, &vs[k0 + (lane & 7) + (((lane >> 3) & 1) << 3)][n2 * 16 + (lane >> 4) * 8]);
    mma_16816<A>(acc[2 * n2], pa, vf);
    mma_16816<A>(acc[2 * n2 + 1], pa, vf + 2);
  }
}

// The online-softmax step of one warp over NJ m16n8 score tiles (already
// scaled and masked).  A thread holds rows gid (hh = 0: elements 0, 1) and
// gid + 8 (hh = 1: elements 2, 3); the rows' max and sum reduce over the
// quad.  s becomes p = exp(s - m_new); acc is rescaled by alpha.
template <int NJ>
__device__ __forceinline__ void online_softmax(float (*s)[4], float (&m)[2], float (&l)[2],
                                               float (&acc)[ATT_D / 8][4]) {
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float mx = s[0][2 * hh];
#pragma unroll
    for (int j = 0; j < NJ; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * hh], s[j][2 * hh + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_next = fmaxf(m[hh], mx);
    const float alpha = expf(m[hh] - m_next);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      s[j][2 * hh] = expf(s[j][2 * hh] - m_next);
      s[j][2 * hh + 1] = expf(s[j][2 * hh + 1] - m_next);
      sum += s[j][2 * hh] + s[j][2 * hh + 1];
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    l[hh] = alpha * l[hh] + sum;
    m[hh] = m_next;
#pragma unroll
    for (int n = 0; n < ATT_D / 8; ++n) {
      acc[n][2 * hh] *= alpha;
      acc[n][2 * hh + 1] *= alpha;
    }
  }
}

// The A fragment of 16 keys from their two m16n8 score tiles (the C layout
// of two m16n8 tiles is the A layout of one m16k16): p rounded to A (bf16
// or f16: v's dtype; p_frag), or the A of its remainder p - A(p)
// (p_frag_lo).
template <class A>
__device__ __forceinline__ void p_frag(float (*p)[4], uint32_t (&pa)[4]) {
  pa[0] = pack2<A>(p[0][0], p[0][1]);
  pa[1] = pack2<A>(p[0][2], p[0][3]);
  pa[2] = pack2<A>(p[1][0], p[1][1]);
  pa[3] = pack2<A>(p[1][2], p[1][3]);
}
template <class A>
__device__ __forceinline__ float remainder_of(float x) { return x - round_to<A>(x); }
template <class A>
__device__ __forceinline__ void p_frag_lo(float (*p)[4], uint32_t (&pa)[4]) {
  pa[0] = pack2<A>(remainder_of<A>(p[0][0]), remainder_of<A>(p[0][1]));
  pa[1] = pack2<A>(remainder_of<A>(p[0][2]), remainder_of<A>(p[0][3]));
  pa[2] = pack2<A>(remainder_of<A>(p[1][0]), remainder_of<A>(p[1][1]));
  pa[3] = pack2<A>(remainder_of<A>(p[1][2]), remainder_of<A>(p[1][3]));
}

// acc += p . V over 16 keys: p rounded to A (B4, B5), or p in f32 as two A
// fragments, the remainder in a second product (B10, B11, B12); in f32 p
// is v's dtype and both are one FFMA product.
template <bool kF32P, class A>
__device__ __forceinline__ void pv_step(float (*p)[4], A (*vs)[kRow<A>], int k0,
                                        float (&acc)[ATT_D / 8][4]) {
  if constexpr (kIsF32<A>) {
    pv_16keys_f32(p, vs, k0, acc);
  } else {
    uint32_t pa[4];
    p_frag<A>(p, pa);
    pv_16keys(pa, vs, k0, acc);
    if (kF32P) {
      p_frag_lo<A>(p, pa);
      pv_16keys(pa, vs, k0, acc);
    }
  }
}

// 2 and 4 f32 results stored as the activations' element A.
template <class A>
__device__ __forceinline__ void store2(A* dst, float a, float b) {
  if constexpr (kIsF32<A>)
    *reinterpret_cast<float2*>(dst) = make_float2(a, b);
  else
    *reinterpret_cast<uint32_t*>(dst) = pack2<A>(a, b);
}
template <class A>
__device__ __forceinline__ void store4(A* dst, float4 x) {
  if constexpr (kIsF32<A>)
    *reinterpret_cast<float4*>(dst) = x;
  else
    *reinterpret_cast<uint2*>(dst) = make_uint2(pack2<A>(x.x, x.y), pack2<A>(x.z, x.w));
}

// ---------------------------------------------------------------------------
// Ragged decode attention (B4, B12 dense; B10 paged)
// ---------------------------------------------------------------------------

// The K/V ring of a reader with activations A over a cache of element T:
// stages of A (T = A: bf16, f16 or f32) that the products read in place, or fp8
// stages (k8, v8: rows of ATT_D bytes) and the one tile of A each landed
// stage is converted into (k, v).  stage_k / stage_v name where a copy
// lands, tile_k / tile_v what the fragments read.
template <class A, class T, int STAGES>
struct KVRing {
  static_assert(std::is_same_v<T, A>, "a cache that is not fp8 holds the activations' type");
  T k[STAGES][KV_TK][kRow<A>];
  T v[STAGES][KV_TK][kRow<A>];
  __device__ __forceinline__ T (*stage_k(int st))[kRow<A>] { return k[st]; }
  __device__ __forceinline__ T (*stage_v(int st))[kRow<A>] { return v[st]; }
  __device__ __forceinline__ T (*tile_k(int st))[kRow<A>] { return k[st]; }
  __device__ __forceinline__ T (*tile_v(int st))[kRow<A>] { return v[st]; }
};
template <class A, int STAGES>
struct KVRing<A, e4m3, STAGES> {
  A k[1][KV_TK][kRow<A>];
  A v[1][KV_TK][kRow<A>];
  e4m3 k8[STAGES][KV_TK][ATT_D];
  e4m3 v8[STAGES][KV_TK][ATT_D];
  __device__ __forceinline__ e4m3 (*stage_k(int st))[ATT_D] { return k8[st]; }
  __device__ __forceinline__ e4m3 (*stage_v(int st))[ATT_D] { return v8[st]; }
  __device__ __forceinline__ A (*tile_k(int))[kRow<A>] { return k[0]; }
  __device__ __forceinline__ A (*tile_v(int))[kRow<A>] { return v[0]; }
};

// After stage st landed (and every warp is done with the tile): an fp8 ring
// converts it into the tile of A, 8 bytes a thread at a time, then waits
// for the block; a bf16 or f16 ring has nothing to do.
template <int NT, class A, class T, int STAGES>
__device__ __forceinline__ void land_stage(KVRing<A, T, STAGES>& ring, int st) {
  if constexpr (std::is_same_v<T, e4m3>) {
    constexpr int U = ATT_D / 8;  // 8-byte units per row
#pragma unroll 4
    for (int i = threadIdx.x; i < KV_TK * U; i += NT) {
      const int r = i / U, c = (i % U) * 8;
      land8<A>(&ring.k[0][r][c], *reinterpret_cast<const uint2*>(&ring.k8[st][r][c]));
      land8<A>(&ring.v[0][r][c], *reinterpret_cast<const uint2*>(&ring.v8[st][r][c]));
    }
    __syncthreads();
  }
}

template <class A, class T>
struct DecodeSmem {
  A q[MMA_HEADS][kRow<A>];
  KVRing<A, T, DA_STAGES> ring;
};
// after the tile loop the same bytes hold the warps' states for the block merge
struct DecodeMergeSmem {
  float acc[DA_WARPS][MMA_HEADS][ATT_D];
  float m[DA_WARPS][MMA_HEADS], l[DA_WARPS][MMA_HEADS];
};
static_assert(sizeof(DecodeMergeSmem) <= sizeof(DecodeSmem<bf16, bf16>) &&
                  sizeof(DecodeMergeSmem) <= sizeof(DecodeSmem<bf16, e4m3>),
              "merge state fits the ring");

// Block (b*G + g, sp) attends rows [sp*span, min((sp+1)*span, n_valid)) of
// its (b, g) slab; a (b, g) with at most DA_SOLO_ROWS valid rows is one
// span (block 0 reads them all, merges nothing and leaves part untouched).
// part: (B*G, nspan, Hg, D) f32 unnormalised acc, then (B*G, nspan, Hg, 2)
// f32 (m, l), or null when no (b, g) has two spans; arrivals: B*G int32
// counters, 0 between launches.
template <bool kV2, class KV, bool kLse, class A>
__global__ void __launch_bounds__(DA_THREADS)
decode_attn_kernel(const A* __restrict__ q, const KV kv, const int* __restrict__ lengths,
                   A* __restrict__ out, float* __restrict__ m_out, float* __restrict__ l_out,
                   float* __restrict__ part, int* __restrict__ arrivals, int G, int Hg, int span,
                   int nspan, float sm_scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  using T = typename KV::elem;
  DecodeSmem<A, T>& sm = *reinterpret_cast<DecodeSmem<A, T>*>(smem_raw);
  __shared__ bool merge_here;

  const int bg = blockIdx.x, sp = blockIdx.y, b = bg / G;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  // this thread's 16-byte chunks of q, in flight with the read of lengths
  constexpr int EC = kVec<A>, QCH = MMA_HEADS * (ATT_D / EC) / DA_THREADS;
  const A* qb = q + (size_t)bg * Hg * ATT_D;
  uint4 qv[QCH];
#pragma unroll
  for (int j = 0; j < QCH; ++j) {
    const int i = tid + j * DA_THREADS, h = i / (ATT_D / EC);
    qv[j] = h < Hg ? *reinterpret_cast<const uint4*>(qb + i * EC) : make_uint4(0u, 0u, 0u, 0u);
  }
  // slots 0..lengths[b] inclusive that this view holds: a prefix of its
  // rows, clamped to its capacity (T, or MP * P)
  const int n_valid = kv.valid(lengths[b] + 1);
  if (n_valid <= DA_SOLO_ROWS) span = max(span, (n_valid + KV_TK - 1) / KV_TK * KV_TK);
  const int ran = n_valid > 0 ? (n_valid + span - 1) / span : 0;  // spans with rows
  A* ob = out + (size_t)bg * Hg * ATT_D;
  if (ran == 0) {  // no valid slot: 0, as the TPU kernels' l == 0 guard gives
    if (sp == 0) {
      for (int i = tid; i < Hg * ATT_D; i += DA_THREADS) ob[i] = from_f32<A>(0.f);
      if (kLse && tid < Hg) {  // and (m, l) = (-inf, 0): its merge weight is 0
        m_out[(size_t)bg * Hg + tid] = -INFINITY;
        l_out[(size_t)bg * Hg + tid] = 0.f;
      }
    }
    return;
  }
  if (sp >= ran) return;  // O(length): spans past the row read nothing
  const int t_begin = sp * span, t_end = min(t_begin + span, n_valid);
  const int ntiles = (t_end - t_begin + KV_TK - 1) / KV_TK;
  const auto src = kv.slab(b, bg - b * G);

  // the ring's first tiles in flight while q is staged (rows >= Hg zero)
#pragma unroll
  for (int st = 0; st < DA_STAGES - 1; ++st) {
    if (st < ntiles)
      stage_kv<DA_THREADS>(sm.ring.stage_k(st), sm.ring.stage_v(st), src, t_begin + st * KV_TK,
                           t_end);
    cp_async_commit();
  }
#pragma unroll
  for (int j = 0; j < QCH; ++j) {
    const int i = tid + j * DA_THREADS, h = i / (ATT_D / EC), c = (i % (ATT_D / EC)) * EC;
    if constexpr (kIsF32<A>) {  // the 4 warps share the rows: B12's / B10's scale here
      if (kV2)
        qv[j] = make_uint4(__float_as_uint(__fmul_rn(__uint_as_float(qv[j].x), sm_scale)),
                           __float_as_uint(__fmul_rn(__uint_as_float(qv[j].y), sm_scale)),
                           __float_as_uint(__fmul_rn(__uint_as_float(qv[j].z), sm_scale)),
                           __float_as_uint(__fmul_rn(__uint_as_float(qv[j].w), sm_scale)));
    }
    *reinterpret_cast<uint4*>(&sm.q[h][c]) = qv[j];
  }
  __syncthreads();
  QRows<A> qr;
  qr.template load<kV2 && !kIsF32<A>>(sm.q, sm_scale);

  float m_r[2] = {-INFINITY, -INFINITY}, l_r[2] = {0.f, 0.f};
  float acc[ATT_D / 8][4];
#pragma unroll
  for (int n = 0; n < ATT_D / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  const int r0 = warp * 16;  // this warp's rows of every tile
  for (int it = 0; it < ntiles; ++it) {
    const int t0 = t_begin + it * KV_TK, st = it % DA_STAGES;
    cp_async_wait<DA_STAGES - 2>();  // this tile landed; the later ones stay in flight
    __syncthreads();  // and every warp is done with the stage the next copy reuses
    const int nx = it + DA_STAGES - 1;
    if (nx < ntiles)
      stage_kv<DA_THREADS>(sm.ring.stage_k(nx % DA_STAGES), sm.ring.stage_v(nx % DA_STAGES), src,
                           t_begin + nx * KV_TK, t_end);
    cp_async_commit();
    land_stage<DA_THREADS>(sm.ring, st);
    if (t0 + r0 < t_end) {  // warp-uniform: the warp has a valid row
      float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
      qk_16keys(qr, sm.ring.tile_k(st), r0, s);
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int pos = t0 + r0 + j * 8 + tig * 2 + (e & 1);
          s[j][e] = pos < t_end ? (kV2 ? s[j][e] : s[j][e] * sm_scale) : CHATGLM_MASK_VALUE;
        }
      online_softmax<2>(s, m_r, l_r, acc);
      pv_step<kV2>(s, sm.ring.tile_v(st), r0, acc);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring's bytes now hold the warps' states

  // merge the warps' states
  DecodeMergeSmem& ms = *reinterpret_cast<DecodeMergeSmem*>(smem_raw);
  if (tig == 0) {
    ms.m[warp][gid] = m_r[0];
    ms.m[warp][gid + 8] = m_r[1];
    ms.l[warp][gid] = l_r[0];
    ms.l[warp][gid + 8] = l_r[1];
  }
#pragma unroll
  for (int n = 0; n < ATT_D / 8; ++n) {
    *reinterpret_cast<float2*>(&ms.acc[warp][gid][n * 8 + tig * 2]) = make_float2(acc[n][0], acc[n][1]);
    *reinterpret_cast<float2*>(&ms.acc[warp][gid + 8][n * 8 + tig * 2]) = make_float2(acc[n][2], acc[n][3]);
  }
  __syncthreads();
  const size_t part_ml = (size_t)gridDim.x * nspan * Hg * ATT_D;  // (m, l) after the acc
  float* pacc = ran == 1 ? nullptr : part + ((size_t)bg * nspan + sp) * Hg * ATT_D;
  float* pml = ran == 1 ? nullptr : part + part_ml + ((size_t)bg * nspan + sp) * Hg * 2;
  for (int i = tid; i < Hg * ATT_D; i += DA_THREADS) {
    const int h = i / ATT_D, d = i % ATT_D;
    float mx = ms.m[0][h];
#pragma unroll
    for (int w = 1; w < DA_WARPS; ++w) mx = fmaxf(mx, ms.m[w][h]);  // finite: warp 0 ran
    float l = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < DA_WARPS; ++w) {  // a warp with no row has m = -inf: weight 0
      const float wt = expf(ms.m[w][h] - mx);
      l = fmaf(ms.l[w][h], wt, l);
      a = fmaf(ms.acc[w][h][d], wt, a);
    }
    if (ran == 1) {
      ob[i] = from_f32<A>(a / l);
      if (kLse && d == 0) {  // the scaled scores' natural-log max and the sum under it
        m_out[(size_t)bg * Hg + h] = mx;
        l_out[(size_t)bg * Hg + h] = l;
      }
    } else {
      pacc[i] = a;
      if (d == 0) {
        pml[2 * h] = mx;
        pml[2 * h + 1] = l;
      }
    }
  }
  if (ran == 1) return;

  // the block that finishes this (b, g) last merges its spans, in span order
  __threadfence();
  __syncthreads();
  if (tid == 0) merge_here = atomicAdd(&arrivals[bg], 1) == ran - 1;
  __syncthreads();
  if (!merge_here) return;
  __threadfence();
  const float* acc_bg = part + (size_t)bg * nspan * Hg * ATT_D;
  const float* ml_bg = part + part_ml + (size_t)bg * nspan * Hg * 2;
  // every span's (m, l) into shared memory at once, then per head the max,
  // the weights exp(m_s - max) and their l-sum, in span order
  float2* sml = reinterpret_cast<float2*>(smem_raw);  // (ran, Hg)
  float* wts = reinterpret_cast<float*>(sml + ran * Hg);  // (ran, Hg)
  float* lsum = wts + ran * Hg;  // (Hg,)
  for (int i = tid; i < ran * Hg; i += DA_THREADS)
    sml[i] = __ldcg(reinterpret_cast<const float2*>(ml_bg) + i);
  __syncthreads();
  if (tid < Hg) {
    float mx = -INFINITY;
    for (int s = 0; s < ran; ++s) mx = fmaxf(mx, sml[s * Hg + tid].x);
    float l = 0.f;
    for (int s = 0; s < ran; ++s) {
      const float wt = expf(sml[s * Hg + tid].x - mx);
      wts[s * Hg + tid] = wt;
      l = fmaf(sml[s * Hg + tid].y, wt, l);
    }
    lsum[tid] = l;
    if (kLse) {
      m_out[(size_t)bg * Hg + tid] = mx;
      l_out[(size_t)bg * Hg + tid] = l;
    }
  }
  __syncthreads();
  // each thread's float4 slots of the (Hg, D) output, loaded MB spans at a
  // time so that their loads are in flight together
  constexpr int SLOTS = MMA_HEADS * ATT_D / (DA_THREADS * 4), MB = 4;
  float4 a[SLOTS];
#pragma unroll
  for (int j = 0; j < SLOTS; ++j) a[j] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int s0 = 0; s0 < ran; s0 += MB) {
    float4 x[MB][SLOTS];
#pragma unroll
    for (int u = 0; u < MB; ++u)
#pragma unroll
      for (int j = 0; j < SLOTS; ++j) {
        const int i = (tid + j * DA_THREADS) * 4;
        x[u][j] = s0 + u < ran && i < Hg * ATT_D
                      ? __ldcg(reinterpret_cast<const float4*>(acc_bg + (size_t)(s0 + u) * Hg * ATT_D + i))
                      : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
    for (int u = 0; u < MB; ++u)
#pragma unroll
      for (int j = 0; j < SLOTS; ++j) {
        const int i = (tid + j * DA_THREADS) * 4;
        const float wt = s0 + u < ran && i < Hg * ATT_D ? wts[(s0 + u) * Hg + i / ATT_D] : 0.f;
        a[j].x = fmaf(x[u][j].x, wt, a[j].x);
        a[j].y = fmaf(x[u][j].y, wt, a[j].y);
        a[j].z = fmaf(x[u][j].z, wt, a[j].z);
        a[j].w = fmaf(x[u][j].w, wt, a[j].w);
      }
  }
#pragma unroll
  for (int j = 0; j < SLOTS; ++j) {
    const int i = (tid + j * DA_THREADS) * 4;
    if (i >= Hg * ATT_D) break;
    const float l = lsum[i / ATT_D];
    store4<A>(ob + i, make_float4(a[j].x / l, a[j].y / l, a[j].z / l, a[j].w / l));
  }
  if (tid == 0) arrivals[bg] = 0;  // ready for the next launch (and a graph replay)
}

// The launch checks of the decode forms: the kernel's head dim and heads,
// whole-tile spans, and every span's (m, l) and weight of a (b, g) fit the
// ring's bytes for the merge.
template <class A, class T>
bool decode_args_ok(int D, int Hg, int T_rows, int span) {
  const size_t nspan = (T_rows + (size_t)span - 1) / (span > 0 ? span : 1);
  return D == ATT_D && Hg <= MMA_HEADS && span >= KV_TK && span % KV_TK == 0 &&
         nspan * MMA_HEADS * 12 + MMA_HEADS * 4 <= sizeof(DecodeSmem<A, T>);
}

// q and out of the activations' element A
template <bool kV2, class KV, bool kLse, class A>
int launch_decode_as(const void* q, const KV& kv, const int* lengths, float* part, int* arrivals,
                     void* out, float* m_out, float* l_out, int B, int G, int Hg, int T, int span,
                     float sm_scale, cudaStream_t stream) {
  const int smem = (int)sizeof(DecodeSmem<A, typename KV::elem>);
  const cudaError_t opt_in = smem_opt_in<decode_attn_kernel<kV2, KV, kLse, A>>(smem);
  if (opt_in != cudaSuccess) return (int)opt_in;
  const int nspan = (T + span - 1) / span;
  decode_attn_kernel<kV2, KV, kLse, A><<<dim3(B * G, nspan), DA_THREADS, smem, stream>>>(
      static_cast<const A*>(q), kv, lengths, static_cast<A*>(out), m_out, l_out, part, arrivals,
      G, Hg, span, nspan, sm_scale);
  return (int)cudaGetLastError();
}

// the (m, l) form where m_out and l_out are given (K1, K2), else the output only
template <bool kV2, class KV, class A>
int launch_decode(const void* q, const KV& kv, const int* lengths, float* part, int* arrivals,
                  void* out, float* m_out, float* l_out, int B, int G, int Hg, int T, int span,
                  float sm_scale, cudaStream_t stream) {
  if (m_out && l_out)
    return launch_decode_as<kV2, KV, true, A>(q, kv, lengths, part, arrivals, out, m_out, l_out,
                                              B, G, Hg, T, span, sm_scale, stream);
  return launch_decode_as<kV2, KV, false, A>(q, kv, lengths, part, arrivals, out, nullptr,
                                             nullptr, B, G, Hg, T, span, sm_scale, stream);
}

// ---------------------------------------------------------------------------
// Flash prefill attention (B5, whole-prompt and chunked; B11 paged)
// ---------------------------------------------------------------------------

template <class A, class T>
struct PrefillTileSmem {
  A q[PF_ROWS][kRow<A>];
  KVRing<A, T, PF_STAGES> ring;
};

// Block (sp * nqb + qb, g, b): query block qb (positions qb*qt ..) of (b, g)
// over the K/V rows [sp*span, (sp+1)*span) it reads; with one span (B5, or a
// unit (b, g, qb) whose rows fit one span) block sp = 0 writes the output,
// otherwise every span writes f32 partials and the last to arrive merges.
// part: (B*G*nqb, nspan, PF_ROWS, D) f32 unnormalised acc, then
// (B*G*nqb, nspan, PF_ROWS, 2) f32 (m, l), or null when nspan == 1;
// arrivals: B*G*nqb int32 counters, 0 between launches.  lengths may be
// null (B11: every row reads up to its causal bound and the capacity).
template <class KV, bool kV2, class A>
__global__ void __launch_bounds__(PF_THREADS)
prefill_attn_kernel(const A* __restrict__ q, const KV kv, const int* __restrict__ lengths,
                    const int* __restrict__ q_starts, const int* __restrict__ kv_row_map,
                    A* __restrict__ out, float* __restrict__ part, int* __restrict__ arrivals,
                    int S, int G, int Hg, int span, int nspan, float sm_scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  using T = typename KV::elem;
  PrefillTileSmem<A, T>& sm = *reinterpret_cast<PrefillTileSmem<A, T>*>(smem_raw);
  __shared__ bool merge_here;

  const int qt = PF_ROWS / Hg;  // query positions per block
  const int nqb = (S + qt - 1) / qt;
  const int qb = blockIdx.x % nqb, sp = blockIdx.x / nqb;
  const int q0 = qb * qt;
  const int g = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int rows = min(qt, S - q0) * Hg;  // folded rows that hold a query position
  const int cap = kv.capacity();
  const int length = lengths ? lengths[b] : cap;
  const int q_start = q_starts ? q_starts[b] : 0;  // absolute position of query row 0
  const int kv_row = kv_row_map ? kv_row_map[b] : b;
  const int last_q = q_start + q0 + rows / Hg - 1;  // absolute
  // causal block skip: rows past the block's last query, the row length or
  // the capacity
  const int n_read = max(0, min(min(last_q + 1, length), cap));
  const int ran = max(1, (n_read + span - 1) / span);  // spans with rows (a length-0 row: 1)
  if (sp >= ran) return;
  const int t_begin = sp * span, t_end = min(t_begin + span, n_read);
  const int ntiles = max(0, (t_end - t_begin + KV_TK - 1) / KV_TK);
  const auto src = kv.slab(kv_row, g);

  // row r = (position q0 + r / Hg, head r % Hg); q and out are (B, S, G, Hg, D)
  constexpr int EC = kVec<A>;
  for (int i = tid; i < PF_ROWS * (ATT_D / EC); i += PF_THREADS) {
    const int r = i / (ATT_D / EC), c = (i % (ATT_D / EC)) * EC;
    const int s = q0 + r / Hg, h = r % Hg;
    const bool ok = r < rows;
    const A* qsrc = ok ? q + (((size_t)b * S + s) * G + g) * Hg * ATT_D + h * ATT_D + c : q;
    cp_async16(&sm.q[r][c], qsrc, ok);
  }
#pragma unroll
  for (int st = 0; st < PF_STAGES - 1; ++st) {  // q lands with the first group
    if (st < ntiles)
      stage_kv<PF_THREADS>(sm.ring.stage_k(st), sm.ring.stage_v(st), src, t_begin + st * KV_TK,
                           t_end);
    cp_async_commit();
  }
  cp_async_wait<PF_STAGES - 2>();
  __syncthreads();

  const int r0 = warp * 16;  // this warp's rows
  // the last absolute position among the warp's rows that hold one (-1: none)
  const int warp_hi = r0 < rows ? q_start + q0 + min(r0 + 15, rows - 1) / Hg : -1;
  int qpos[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) qpos[hh] = q_start + q0 + (r0 + gid + 8 * hh) / Hg;
  QRows<A> qr;  // the warp's rows (f32: scaled in place, the warp's own)
  qr.template load<kV2>(sm.q + r0, sm_scale);

  float m_r[2] = {-INFINITY, -INFINITY}, l_r[2] = {0.f, 0.f};
  float acc[ATT_D / 8][4];
#pragma unroll
  for (int n = 0; n < ATT_D / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  for (int it = 0; it < ntiles; ++it) {
    const int t0 = t_begin + it * KV_TK, st = it % PF_STAGES;
    cp_async_wait<PF_STAGES - 2>();  // this tile landed; the later ones stay in flight
    __syncthreads();  // and every warp is done with the stage the next copy reuses
    const int nx = it + PF_STAGES - 1;
    if (nx < ntiles)
      stage_kv<PF_THREADS>(sm.ring.stage_k(nx % PF_STAGES), sm.ring.stage_v(nx % PF_STAGES), src,
                           t_begin + nx * KV_TK, t_end);
    cp_async_commit();
    land_stage<PF_THREADS>(sm.ring, st);
    if (t0 <= warp_hi) {  // warp-uniform: skip a tile wholly above the warp's positions
      float s[KV_TK / 8][4];
#pragma unroll
      for (int j = 0; j < KV_TK / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int n0 = 0; n0 < KV_TK; n0 += 16) qk_16keys(qr, sm.ring.tile_k(st), n0, s + n0 / 8);
#pragma unroll
      for (int j = 0; j < KV_TK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int pos = t0 + j * 8 + tig * 2 + (e & 1);
          s[j][e] = (pos <= qpos[e >> 1] && pos < t_end) ? (kV2 ? s[j][e] : s[j][e] * sm_scale)
                                                         : CHATGLM_MASK_VALUE;
        }
      online_softmax<KV_TK / 8>(s, m_r, l_r, acc);
#pragma unroll
      for (int k0 = 0; k0 < KV_TK; k0 += 16)
        pv_step<kV2>(s + k0 / 8, sm.ring.tile_v(st), k0, acc);
    }
  }
  cp_async_wait<0>();

  if (ran == 1) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = r0 + gid + 8 * hh;
      if (r >= rows) continue;
      const int s = q0 + r / Hg, h = r % Hg;
      const float l = l_r[hh] == 0.f ? 1.f : l_r[hh];  // a length-0 row: acc 0, output 0
      A* o = out + (((size_t)b * S + s) * G + g) * Hg * ATT_D + h * ATT_D;
#pragma unroll
      for (int n = 0; n < ATT_D / 8; ++n)
        store2<A>(o + n * 8 + tig * 2, acc[n][2 * hh] / l, acc[n][2 * hh + 1] / l);
    }
    return;
  }

  // this span's partials of unit (b, g, qb), straight from the fragments
  const int unit = (b * G + g) * nqb + qb;
  const size_t part_ml = (size_t)gridDim.z * G * nqb * nspan * PF_ROWS * ATT_D;
  float* pacc = part + ((size_t)unit * nspan + sp) * PF_ROWS * ATT_D;
  float* pml = part + part_ml + ((size_t)unit * nspan + sp) * PF_ROWS * 2;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = r0 + gid + 8 * hh;
    if (r >= rows) continue;
#pragma unroll
    for (int n = 0; n < ATT_D / 8; ++n)
      *reinterpret_cast<float2*>(pacc + (size_t)r * ATT_D + n * 8 + tig * 2) =
          make_float2(acc[n][2 * hh], acc[n][2 * hh + 1]);
    if (tig == 0) *reinterpret_cast<float2*>(pml + 2 * r) = make_float2(m_r[hh], l_r[hh]);
  }

  // the block that finishes this unit last merges its spans, in span order
  __threadfence();
  __syncthreads();  // also: every warp is done with the tiles' shared memory
  if (tid == 0) merge_here = atomicAdd(&arrivals[unit], 1) == ran - 1;
  __syncthreads();
  if (!merge_here) return;
  __threadfence();
  const float* acc_u = part + (size_t)unit * nspan * PF_ROWS * ATT_D;
  const float2* ml_u = reinterpret_cast<const float2*>(part + part_ml) + (size_t)unit * nspan * PF_ROWS;
  float2* sml = reinterpret_cast<float2*>(smem_raw);  // (ran, rows)
  float* wts = reinterpret_cast<float*>(sml + ran * rows);  // (ran, rows)
  float* lsum = wts + ran * rows;  // (rows,)
  for (int i = tid; i < ran * rows; i += PF_THREADS)
    sml[i] = __ldcg(ml_u + (size_t)(i / rows) * PF_ROWS + i % rows);
  __syncthreads();
  // per row the max over spans, the weights exp(m_s - max) and their l-sum;
  // span 0 holds position 0, so the max is finite and a span with none of
  // the row's positions weighs 0
  for (int r = tid; r < rows; r += PF_THREADS) {
    float mx = -INFINITY;
    for (int s = 0; s < ran; ++s) mx = fmaxf(mx, sml[s * rows + r].x);
    float l = 0.f;
    for (int s = 0; s < ran; ++s) {
      const float wt = expf(sml[s * rows + r].x - mx);
      wts[s * rows + r] = wt;
      l = fmaf(sml[s * rows + r].y, wt, l);
    }
    lsum[r] = l;
  }
  __syncthreads();
  // each thread's float4 slots of the (rows, D) output, MB spans' loads in
  // flight together
  constexpr int SLOTS = PF_ROWS * ATT_D / (PF_THREADS * 4), MB = 2;
  float4 a[SLOTS];
#pragma unroll
  for (int j = 0; j < SLOTS; ++j) a[j] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int s0 = 0; s0 < ran; s0 += MB) {
    float4 x[MB][SLOTS];
#pragma unroll
    for (int u = 0; u < MB; ++u)
#pragma unroll
      for (int j = 0; j < SLOTS; ++j) {
        const int i = (tid + j * PF_THREADS) * 4;
        x[u][j] = s0 + u < ran && i < rows * ATT_D
                      ? __ldcg(reinterpret_cast<const float4*>(acc_u + (size_t)(s0 + u) * PF_ROWS * ATT_D + i))
                      : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
    for (int u = 0; u < MB; ++u)
#pragma unroll
      for (int j = 0; j < SLOTS; ++j) {
        const int i = (tid + j * PF_THREADS) * 4;
        const float wt = s0 + u < ran && i < rows * ATT_D ? wts[(s0 + u) * rows + i / ATT_D] : 0.f;
        a[j].x = fmaf(x[u][j].x, wt, a[j].x);
        a[j].y = fmaf(x[u][j].y, wt, a[j].y);
        a[j].z = fmaf(x[u][j].z, wt, a[j].z);
        a[j].w = fmaf(x[u][j].w, wt, a[j].w);
      }
  }
#pragma unroll
  for (int j = 0; j < SLOTS; ++j) {
    const int i = (tid + j * PF_THREADS) * 4;
    if (i >= rows * ATT_D) break;
    const int r = i / ATT_D, d = i % ATT_D;
    const float l = lsum[r];
    A* o = out + (((size_t)b * S + q0 + r / Hg) * G + g) * Hg * ATT_D + (r % Hg) * ATT_D + d;
    store4<A>(o, make_float4(a[j].x / l, a[j].y / l, a[j].z / l, a[j].w / l));
  }
  if (tid == 0) arrivals[unit] = 0;  // ready for the next launch (and a graph replay)
}

// q and out of the activations' element A
template <class KV, bool kV2, class A>
int launch_prefill(const void* q, const KV& kv, const int* lengths, const int* q_starts,
                   const int* kv_row_map, void* out, float* part, int* arrivals, int B, int S,
                   int G, int Hg, int span, int nspan, float sm_scale, cudaStream_t stream) {
  const int smem = (int)sizeof(PrefillTileSmem<A, typename KV::elem>);
  const cudaError_t opt_in = smem_opt_in<prefill_attn_kernel<KV, kV2, A>>(smem);
  if (opt_in != cudaSuccess) return (int)opt_in;
  const int qt = PF_ROWS / Hg;
  const dim3 grid((S + qt - 1) / qt * nspan, G, B);
  prefill_attn_kernel<KV, kV2, A><<<grid, PF_THREADS, smem, stream>>>(
      static_cast<const A*>(q), kv, lengths, q_starts, kv_row_map, static_cast<A*>(out), part,
      arrivals, S, G, Hg, span, nspan, sm_scale);
  return (int)cudaGetLastError();
}

// The entry points' dispatch on the form code: fn(A{}, T{}) with A the
// activations' element and T the cache's: 0 bf16 over a bf16 cache, 1 bf16
// over a float8_e4m3fn cache, 2 f16 over an f16 cache, 3 f16 over a
// float8_e4m3fn cache, 4 f32 over an f32 cache, 5 f32 over a float8_e4m3fn
// cache (ops/attention.py: FORM_CODES).  The f32 forms instantiate the
// CUDA-core bodies (kIsF32), never the mma.sync ones.
template <class Fn>
int with_kv_type(int form, Fn&& fn) {
  if (form == 0) return fn(bf16{}, bf16{});
  if (form == 1) return fn(bf16{}, e4m3{});
  if (form == 2) return fn(f16{}, f16{});
  if (form == 3) return fn(f16{}, e4m3{});
  if (form == 4) return fn(float{}, float{});
  if (form == 5) return fn(float{}, e4m3{});
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// The attention entries' form code: 0 for bf16 activations over a bf16
// cache or pool, 1 for bf16 over a float8_e4m3fn one (cast on the write,
// upcast on the read), 2 for f16 activations over an f16 one, 3 for f16
// over a float8_e4m3fn one, 4 for f32 activations over an f32 one, 5 for
// f32 over a float8_e4m3fn one; any other code returns
// cudaErrorInvalidValue.
//
// B3 / B9 with the RoPE of q and k (the decode step).  q, q_out (B, Hq, D)
// contiguous (Hq = G * Hg, or a rank's heads); kv (B, 2*G*D), k then v,
// rows kv_stride elements apart; freqs (B, D); k_layer, v_layer the (B, G,
// T, D) views of one cache layer when page_table is null, else the (NP, G,
// P, D) views of one pool layer, read through page_table (B, MP), with T =
// P; starts (B,) int32.  q, kv, freqs and the cache as the form says; all
// 16-byte aligned (kv_stride a multiple of a 16-byte vector's elements),
// D == 128.  A sharded cache
// (K3): the dense view holds global slots offset .. offset + T - 1, the
// paged view's column i logical block i * stride + phase; total is the
// global capacity the position clamps to (0: the view's own, unsharded:
// offset 0, stride 1, phase 0).  A row whose slot another shard holds only
// has its q rotated.
int chatglm_rope_kv_append(const void* q, void* q_out, const void* kv, int kv_stride,
                           const void* freqs, void* k_layer, void* v_layer, const void* page_table,
                           const void* starts, int B, int G, int Hq, int D, int T, int MP,
                           int offset, int stride, int phase, int total, int form,
                           void* stream) {
  if (D != ATT_D || T < 1 || (page_table && MP < 1) || offset < 0 ||
      stride < 1 || phase < 0 || phase >= stride || total < 0)
    return (int)cudaErrorInvalidValue;
  const int* st = static_cast<const int*>(starts);
  const cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  return with_kv_type(form, [&](auto a, auto t) {
    using A = decltype(a);
    using T_ = decltype(t);
    if (kv_stride % kVec<A>) return (int)cudaErrorInvalidValue;  // 16-byte rows
    const T_ *kl = static_cast<const T_*>(k_layer), *vl = static_cast<const T_*>(v_layer);
    if (!page_table) {
      const DenseKV<T_> cache{kl, vl, G, T, offset, total > 0 ? total : offset + T};
      return launch_append<DenseKV<T_>, true, A>(q, q_out, kv, kv_stride, freqs, cache, st, B,
                                                 G, Hq, s);
    }
    const PagedKV<T_> pool{kl, vl, static_cast<const int*>(page_table), G, T, MP, stride, phase,
                           total > 0 ? total : MP * T};
    return launch_append<PagedKV<T_>, true, A>(q, q_out, kv, kv_stride, freqs, pool, st, B, G,
                                               Hq, s);
  });
}

// The write-only form (kv_cache_write_idx, kv_pool_write_idx): src (B, G, D)
// in the form's activation type into the slot of dst_layer, a cache or pool
// layer view as above.
int chatglm_kv_append(void* dst_layer, const void* src, const void* page_table, const void* starts,
                      int B, int G, int D, int T, int MP, int form, void* stream) {
  if (D != ATT_D || T < 1 || (page_table && MP < 1)) return (int)cudaErrorInvalidValue;
  const int* st = static_cast<const int*>(starts);
  const cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  return with_kv_type(form, [&](auto a, auto t) {
    using A = decltype(a);
    using T_ = decltype(t);
    const T_* dst = static_cast<const T_*>(dst_layer);
    if (!page_table)
      return launch_append<DenseKV<T_>, false, A>(nullptr, nullptr, src, G * D, nullptr,
                                                  DenseKV<T_>{dst, dst, G, T, 0, T}, st, B, G, 0,
                                                  s);
    const PagedKV<T_> pool{dst, dst, static_cast<const int*>(page_table), G, T, MP, 1, 0, MP * T};
    return launch_append<PagedKV<T_>, false, A>(nullptr, nullptr, src, G * D, nullptr, pool, st,
                                                B, G, 0, s);
  });
}

// B4 (v2 = 0) and B12 (v2 = 1).  q, out (B, G, Hg, D); k, v (B, G, T, D)
// layer views; lengths (B,) int32 = the cache length before this token;
// part holds B*G*ceil(T/span)*Hg*(D+2) floats, and may be null when no
// (b, g) can have more than one span (ceil(T/span) == 1 or T <= 256);
// arrivals B*G int32 zeros (left zero).  q, out, k and v as the form says;
// D == 128, Hg <= 16, span
// a multiple of 64.  K1 (B4's return_lse form): m_out and l_out (B, G, Hg)
// f32 receive the online softmax's max of the scaled scores (natural log)
// and its sum (-inf and 0 for a (b, g) with no valid row), or are null;
// the view holds global slots offset .. offset + T - 1 of a T-sharded cache
// (0: the whole cache).
int chatglm_decode_attention(const void* q, const void* k, const void* v, const void* lengths,
                             void* part, void* arrivals, void* out, int B, int G, int Hg, int T,
                             int D, int span, int v2, float sm_scale, void* m_out, void* l_out,
                             int offset, int form, void* stream) {
  if (offset < 0 || !m_out != !l_out) return (int)cudaErrorInvalidValue;
  return with_kv_type(form, [&](auto a, auto t) {
    using A = decltype(a);
    using T_ = decltype(t);
    if (!decode_args_ok<A, T_>(D, Hg, T, span)) return (int)cudaErrorInvalidValue;
    const DenseKV<T_> kv{static_cast<const T_*>(k), static_cast<const T_*>(v), G, T, offset,
                         offset + T};
    auto launch =
        v2 ? launch_decode<true, DenseKV<T_>, A> : launch_decode<false, DenseKV<T_>, A>;
    return launch(q, kv, static_cast<const int*>(lengths), static_cast<float*>(part),
                  static_cast<int*>(arrivals), out, static_cast<float*>(m_out),
                  static_cast<float*>(l_out), B, G, Hg, T, span, sm_scale,
                  reinterpret_cast<cudaStream_t>(stream));
  });
}

// q, out (B, S, G, Hg, D); k, v (Bk, G, T, D) layer views; lengths (B,)
// int32.  q_starts (B,) int32 or null (all 0: then T >= S); kv_row_map (B,)
// int32 rows of k/v, or null (row b).  q, out, k and v as the form says;
// D == 128, Hg <= 64.
int chatglm_prefill_attention(const void* q, const void* k, const void* v, const void* lengths,
                              const void* q_starts, const void* kv_row_map, void* out, int B,
                              int S, int G, int Hg, int T, int D, float sm_scale, int form,
                              void* stream) {
  if (D != ATT_D || Hg > 64) return (int)cudaErrorInvalidValue;
  const int span = (T + KV_TK - 1) / KV_TK * KV_TK;  // one span: every row reads in one block
  return with_kv_type(form, [&](auto a, auto t) {
    using A = decltype(a);
    using T_ = decltype(t);
    const DenseKV<T_> kv{static_cast<const T_*>(k), static_cast<const T_*>(v), G, T, 0, T};
    return launch_prefill<DenseKV<T_>, false, A>(
        q, kv, static_cast<const int*>(lengths), static_cast<const int*>(q_starts),
        static_cast<const int*>(kv_row_map), out, nullptr, nullptr, B, S, G, Hg, span, 1,
        sm_scale, reinterpret_cast<cudaStream_t>(stream));
  });
}

// B10.  q, out (B, G, Hg, D); k, v (NP, G, P, D) pool layer views;
// page_table (B, MP) and lengths (B,) int32 = the cache length before this
// token; part and arrivals as chatglm_decode_attention's with T = MP * P.
// q, out and the pool as the form says; D == 128, Hg <= 16, span a
// multiple of 64.  K2 (B10's strided
// return_lse form): table column i holds logical block i * stride + phase,
// and m_out, l_out as chatglm_decode_attention's (or null; stride 1, phase
// 0: the whole row).
int chatglm_decode_paged(const void* q, const void* k, const void* v, const void* page_table,
                         const void* lengths, void* part, void* arrivals, void* out, int B, int G,
                         int Hg, int P, int D, int MP, int span, float sm_scale, void* m_out,
                         void* l_out, int stride, int phase, int form, void* stream) {
  if (P < 1 || MP < 1 || stride < 1 || phase < 0 || phase >= stride || !m_out != !l_out)
    return (int)cudaErrorInvalidValue;
  return with_kv_type(form, [&](auto a, auto t) {
    using A = decltype(a);
    using T_ = decltype(t);
    if (!decode_args_ok<A, T_>(D, Hg, MP * P, span)) return (int)cudaErrorInvalidValue;
    const PagedKV<T_> kv{static_cast<const T_*>(k), static_cast<const T_*>(v),
                         static_cast<const int*>(page_table), G, P, MP, stride, phase,
                         MP * P * stride};
    return launch_decode<true, PagedKV<T_>, A>(
        q, kv, static_cast<const int*>(lengths), static_cast<float*>(part),
        static_cast<int*>(arrivals), out, static_cast<float*>(m_out), static_cast<float*>(l_out),
        B, G, Hg, MP * P, span, sm_scale, reinterpret_cast<cudaStream_t>(stream));
  });
}

// B11.  q, out (B, S, G, Hg, D); k, v (NP, G, P, D) pool layer views;
// page_table (Bt, MP) int32, read at row row_map[b] (row_map (B,) int32, or
// null: row b); starts (B,) int32.  span: K/V rows per block, a multiple of
// 64; part holds B*G*nqb*ceil(MP*P/span)*128*(D+2) floats (nqb =
// ceil(S / (128 / Hg))) and may be null when that is one span; arrivals
// B*G*nqb int32 zeros (left zero).  q, out and the pool as the form says;
// D == 128, Hg <= 64.
int chatglm_chunk_paged(const void* q, const void* k, const void* v, const void* page_table,
                        const void* row_map, const void* starts, void* part, void* arrivals,
                        void* out, int B, int S, int G, int Hg, int P, int D, int MP, int span,
                        float sm_scale, int form, void* stream) {
  const int nspan = span > 0 ? (MP * P + span - 1) / span : 0;
  if (D != ATT_D || Hg > 64 || P < 1 || MP < 1 || span < KV_TK || span % KV_TK ||
      (nspan > 1 && (!part || !arrivals)) ||
      (size_t)nspan * PF_ROWS * 12 + PF_ROWS * 4 > sizeof(PrefillTileSmem<bf16, e4m3>))
    return (int)cudaErrorInvalidValue;
  return with_kv_type(form, [&](auto a, auto t) {
    using A = decltype(a);
    using T_ = decltype(t);
    const PagedKV<T_> kv{static_cast<const T_*>(k), static_cast<const T_*>(v),
                         static_cast<const int*>(page_table), G, P, MP, 1, 0, MP * P};
    return launch_prefill<PagedKV<T_>, true, A>(
        q, kv, nullptr, static_cast<const int*>(starts), static_cast<const int*>(row_map), out,
        static_cast<float*>(part), static_cast<int*>(arrivals), B, S, G, Hg, span, nspan,
        sm_scale, reinterpret_cast<cudaStream_t>(stream));
  });
}

}  // extern "C"

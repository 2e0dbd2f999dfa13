// Attention-side kernels of the serving path: the in-place KV writes (dense
// cache and paged pool), ragged decode attention (dense and paged), flash
// prefill attention (with its chunked-prefill form) and chunk attention over
// the paged pool.  The dense kernels read the cache in its (B, G, T, D)
// per-layer layout (a view of the (L, B, G, T, D) cache); the paged ones read
// one layer's (NP, G, P, D) view of the (L, NP, G, P, D) pool through a
// per-row page table.  All read lengths / starts / page tables from device
// tensors, so a decode step never syncs to the host.
//
// kv_write_kernel replaces chatglm_q_tpu/ops/pallas_attention.py:_kv_write_kernel.
//   Bound by bytes (B*G*D elements read and written) and, at these sizes,
//   by launch latency.  One block per row; the slot is starts[b] clamped to
//   T-1, as JAX's dynamic_update_slice clamps the same write.
//
// pool_write_kernel replaces pallas_attention.py:_pool_write_kernel
// (kv_pool_write_idx).  The paged twin of kv_write_kernel: position
// min(starts[b], MP*P-1) lands in page page_table[b, pos / P] at row pos % P.
// The TPU kernel rewrites an aligned 8-row window; here one block writes the
// row itself, so any page size P works.
//
// decode_attn_kernel<false> replaces pallas_attention.py:_decode_kernel (B4:
// flash_attention_decode / _idx), decode_attn_kernel<true> replaces
// :_decode_v2_kernel (B12: flash_attention_decode_v2, the decode_attn_v2
// option).  Bound by bytes in principle (each valid K/V row read once, ~4
// operations per byte); at batch 1-4 those bytes take under a microsecond
// at the HBM rate, so what bounds it is latency: how many SMs share the
// reads and the chain of dependent steps in one block.  One (b, g) on the
// TPU is one sequential grid program; here the grid runs over (b*g, span of
// rows) for both, with the span (a multiple of the 64-row tile) picked by
// the wrapper so that the grid covers the 132 SMs where the rows allow, and
// a span at or past lengths[b] + 1 exits before it reads anything (the
// O(length) property).  A (b, g) with few valid rows (at most DA_SOLO_ROWS,
// 256) is one span: at those sizes the cross-block merge costs more latency
// than reading a few tiles in one block.
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
// launch does the whole step.
//   Numerics stay the TPU kernels': B4 scales the score by sm_scale in f32,
// sums l from f32 p and rounds p to bf16 for PV (what a bf16 mma consumes);
// B12 scales q by sm_scale and rounds it to bf16 first and keeps p in f32
// through PV, fed as two bf16 fragments, hi = bf16(p) and lo = bf16(p - hi)
// (~16 bits of p).  A row with no valid slot (lengths[b] == -1) outputs 0,
// as the TPU kernels' l == 0 guard gives.
//
// decode_paged_kernel replaces pallas_attention.py:_decode_paged_kernel
// (flash_attention_decode_paged, stride 1 / phase 0).  Bound by bytes: one
// block per (b, g), 32-row K/V tiles in shared memory, online softmax.  The
// TPU kernel double-buffers whole pages of K and V; at P = 256, D = 128 that
// is 256 KB of staging, more than the 227 KB a block may use, so this kernel
// stages 32 rows at a time and resolves each row's page from the table
// (16-byte loads, one page per row).  Rows past capacity are never read:
// positions stop at min(lengths+1, MP*P), so the table is never read at
// column MP.  As on the TPU, q is scaled by sm_scale and rounded to bf16
// before the dot, and probabilities stay f32 in the PV product.
//
// prefill_attn_kernel replaces pallas_attention.py:_prefill_kernel (B5:
// flash_attention_prefill, and its q_starts / kv_row_map chunked form).
// Bound by operations once it runs on the tensor cores (the chunked form
// does ~8.6 GFLOP over 4 x 256 rows on a 2048-slot cache).  The shape of
// FlashAttention-2: a block of 8 warps holds 128 folded (position, head)
// query rows (8 warps beat 4 on both forms on an H100, and halve the K/V
// re-reads), row r at position q0 + r / Hg and head r % Hg as on the TPU,
// so every head of the group shares each K/V tile; each warp owns 16 rows (one
// position at Hg = 16, so its causal bound is uniform) with their A
// fragments loaded once into registers.  64-row bf16 K/V tiles go through a
// 2-stage cp.async ring of the same padded rows as decode.  S = Q K^T by
// mma.sync, scaled by sm_scale in f32 and masked where pos > q_start +
// position or pos >= lengths[b]; the online softmax in registers; P rounded
// to bf16 as PV's A fragment (B5's numerics), V by ldmatrix.trans, the f32
// accumulators normalised at the end.  Query row r of batch b sits at
// absolute position q_starts[b] + r and reads K/V from cache row
// kv_row_map[b]; K/V tiles past the block's last causal position or past
// lengths[b] are not read, a warp skips a tile wholly above its rows'
// positions, rows of a length-0 row output 0, positions >= S are not stored.
// Hg <= 64 folds (a block of one position at Hg = 64).  wgmma / TMA tiles
// are later work.
//
// chunk_paged_kernel replaces pallas_attention.py:_chunk_paged_kernel
// (flash_attention_chunk_paged).  S queries per row at absolute positions
// starts[b] + t attend logical positions <= starts[b] + t through the page
// table: the speculative verify step (S = k+1) and small prefill chunks.
// Folded 64-row query tiles over 32-row K/V tiles read from pages (the same
// staging answer to the TPU's 256 KB of page buffers), with B10's numerics:
// q pre-scaled and rounded to bf16, probabilities f32.  CUDA-core FMAs on
// operands widened to f32 in shared memory.  Bound by bytes at S = 9 (each
// valid K/V row read once per query tile).
#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

// ---------------------------------------------------------------------------
// KV write
// ---------------------------------------------------------------------------

// Elements move as 16-bit words: the cache is bf16.
__global__ void kv_write_kernel(uint16_t* __restrict__ cache, const uint16_t* __restrict__ src,
                                const int* __restrict__ starts, int G, int T, int D) {
  const int b = blockIdx.x;
  const int slot = min(max(starts[b], 0), T - 1);  // clamped, as JAX's write clamps
  for (int i = threadIdx.x; i < G * D; i += blockDim.x) {
    const int g = i / D, d = i % D;
    cache[(((size_t)b * G + g) * T + slot) * D + d] = src[(size_t)b * G * D + i];
  }
}

// ---------------------------------------------------------------------------
// Tensor-core tiles of the dense decode and prefill kernels
// ---------------------------------------------------------------------------

constexpr int ATT_D = 128;            // head dim the kernels are built for
constexpr int KV_STRIDE = ATT_D + 8;  // bf16 per staged row: 272 bytes, so the 8 rows
                                      // of one ldmatrix phase fall in distinct banks
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

// Copy K/V rows t0 .. t0+KV_TK-1 of one (row, group) slab into a ring stage
// with cp.async; rows at or past `end` are zero-filled and read nothing.
template <int NT>
__device__ __forceinline__ void stage_kv(bf16 (*ks)[KV_STRIDE], bf16 (*vs)[KV_STRIDE],
                                         const bf16* __restrict__ kb,
                                         const bf16* __restrict__ vb, int t0, int end) {
  constexpr int CH = ATT_D / 8;  // 16-byte chunks per row
  static_assert((KV_TK * CH) % NT == 0, "whole passes");
#pragma unroll
  for (int j = 0; j < KV_TK * CH / NT; ++j) {
    const int i = threadIdx.x + j * NT;
    const int r = i / CH, c = (i % CH) * 8, pos = t0 + r;
    const bool ok = pos < end;
    const size_t off = (size_t)(ok ? pos : 0) * ATT_D + c;
    cp_async16(&ks[r][c], kb + off, ok);
    cp_async16(&vs[r][c], vb + off, ok);
  }
}

// A fragments of a warp's 16 query rows (row-major, KV_STRIDE apart), once.
__device__ __forceinline__ void load_q_frags(bf16 (*qs)[KV_STRIDE], uint32_t (&qa)[ATT_D / 16][4]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int kk = 0; kk < ATT_D / 16; ++kk)
    ldmatrix_x4(qa[kk], &qs[lane & 15][kk * 16 + (lane >> 4) * 8]);
}

// s[2j], s[2j+1] += q (16 x D) . K rows n0 .. n0+15 of the tile, transposed:
// the m16n8 score tiles of 16 keys.
__device__ __forceinline__ void qk_16keys(const uint32_t (&qa)[ATT_D / 16][4],
                                          bf16 (*ks)[KV_STRIDE], int n0, float (*s)[4]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int kk = 0; kk < ATT_D / 16; ++kk) {
    uint32_t kf[4];
    ldmatrix_x4(kf, &ks[n0 + (lane & 7) + ((lane >> 4) << 3)][kk * 16 + ((lane >> 3) & 1) * 8]);
    mma_bf16_16816(s[0], qa[kk], kf);
    mma_bf16_16816(s[1], qa[kk], kf + 2);
  }
}

// acc (16 x D) += p (16 x 16, an A fragment) . V rows k0 .. k0+15 of the tile.
__device__ __forceinline__ void pv_16keys(const uint32_t (&pa)[4], bf16 (*vs)[KV_STRIDE],
                                          int k0, float (&acc)[ATT_D / 8][4]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int n2 = 0; n2 < ATT_D / 16; ++n2) {
    uint32_t vf[4];
    ldmatrix_x4_trans(vf, &vs[k0 + (lane & 7) + (((lane >> 3) & 1) << 3)][n2 * 16 + (lane >> 4) * 8]);
    mma_bf16_16816(acc[2 * n2], pa, vf);
    mma_bf16_16816(acc[2 * n2 + 1], pa, vf + 2);
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
// of two m16n8 tiles is the A layout of one m16k16): p rounded to bf16
// (p_frag), or the bf16 of its remainder p - bf16(p) (p_frag_lo).
__device__ __forceinline__ void p_frag(float (*p)[4], uint32_t (&pa)[4]) {
  pa[0] = bf16x2_bits(p[0][0], p[0][1]);
  pa[1] = bf16x2_bits(p[0][2], p[0][3]);
  pa[2] = bf16x2_bits(p[1][0], p[1][1]);
  pa[3] = bf16x2_bits(p[1][2], p[1][3]);
}
__device__ __forceinline__ float bf16_remainder(float x) { return x - round_to<bf16>(x); }
__device__ __forceinline__ void p_frag_lo(float (*p)[4], uint32_t (&pa)[4]) {
  pa[0] = bf16x2_bits(bf16_remainder(p[0][0]), bf16_remainder(p[0][1]));
  pa[1] = bf16x2_bits(bf16_remainder(p[0][2]), bf16_remainder(p[0][3]));
  pa[2] = bf16x2_bits(bf16_remainder(p[1][0]), bf16_remainder(p[1][1]));
  pa[3] = bf16x2_bits(bf16_remainder(p[1][2]), bf16_remainder(p[1][3]));
}

// ---------------------------------------------------------------------------
// Ragged decode attention (B4, B12)
// ---------------------------------------------------------------------------

struct DecodeSmem {
  bf16 q[MMA_HEADS][KV_STRIDE];
  bf16 k[DA_STAGES][KV_TK][KV_STRIDE];
  bf16 v[DA_STAGES][KV_TK][KV_STRIDE];
};
// after the tile loop the same bytes hold the warps' states for the block merge
struct DecodeMergeSmem {
  float acc[DA_WARPS][MMA_HEADS][ATT_D];
  float m[DA_WARPS][MMA_HEADS], l[DA_WARPS][MMA_HEADS];
};
static_assert(sizeof(DecodeMergeSmem) <= sizeof(DecodeSmem), "merge state fits the ring");

// Block (b*G + g, sp) attends rows [sp*span, min((sp+1)*span, n_valid)) of
// its (b, g) cache; a (b, g) with at most DA_SOLO_ROWS valid rows is one
// span (block 0 reads them all, merges nothing and leaves part untouched).
// part: (B*G, nspan, Hg, D) f32 unnormalised acc, then (B*G, nspan, Hg, 2)
// f32 (m, l), or null when no (b, g) has two spans; arrivals: B*G int32
// counters, 0 between launches.
template <bool kV2>
__global__ void __launch_bounds__(DA_THREADS)
decode_attn_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const int* __restrict__ lengths,
                   bf16* __restrict__ out, float* __restrict__ part, int* __restrict__ arrivals,
                   int G, int Hg, int Tc, int span, int nspan, float sm_scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  DecodeSmem& sm = *reinterpret_cast<DecodeSmem*>(smem_raw);
  __shared__ bool merge_here;

  const int bg = blockIdx.x, sp = blockIdx.y, b = bg / G;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  // this thread's 16-byte chunks of q, in flight with the read of lengths
  constexpr int QCH = MMA_HEADS * (ATT_D / 8) / DA_THREADS;
  const bf16* qb = q + (size_t)bg * Hg * ATT_D;
  uint4 qv[QCH];
#pragma unroll
  for (int j = 0; j < QCH; ++j) {
    const int i = tid + j * DA_THREADS, h = i / (ATT_D / 8);
    qv[j] = h < Hg ? *reinterpret_cast<const uint4*>(qb + i * 8) : make_uint4(0u, 0u, 0u, 0u);
  }
  const int n_valid = min(lengths[b] + 1, Tc);  // slots 0..lengths[b] inclusive
  if (n_valid <= DA_SOLO_ROWS) span = max(span, (n_valid + KV_TK - 1) / KV_TK * KV_TK);
  const int ran = n_valid > 0 ? (n_valid + span - 1) / span : 0;  // spans with rows
  bf16* ob = out + (size_t)bg * Hg * ATT_D;
  if (ran == 0) {  // no valid slot: 0, as the TPU kernels' l == 0 guard gives
    if (sp == 0)
      for (int i = tid; i < Hg * ATT_D; i += DA_THREADS) ob[i] = from_f32<bf16>(0.f);
    return;
  }
  if (sp >= ran) return;  // O(length): spans past the row read nothing
  const int t_begin = sp * span, t_end = min(t_begin + span, n_valid);
  const int ntiles = (t_end - t_begin + KV_TK - 1) / KV_TK;
  const bf16* kb = k + (size_t)bg * Tc * ATT_D;
  const bf16* vb = v + (size_t)bg * Tc * ATT_D;

  // the ring's first tiles in flight while q is staged: q's rows >= Hg are
  // zero, and B12 scales q by sm_scale in its dtype first, as the TPU
  // kernel's wrapper does
#pragma unroll
  for (int st = 0; st < DA_STAGES - 1; ++st) {
    if (st < ntiles) stage_kv<DA_THREADS>(sm.k[st], sm.v[st], kb, vb, t_begin + st * KV_TK, t_end);
    cp_async_commit();
  }
#pragma unroll
  for (int j = 0; j < QCH; ++j) {
    const int i = tid + j * DA_THREADS, h = i / (ATT_D / 8), c = (i % (ATT_D / 8)) * 8;
    uint4 val = qv[j];
    if (kV2) {
      float f[8];
      load8(reinterpret_cast<const bf16*>(&val), f);
      val = make_uint4(bf16x2_bits(f[0] * sm_scale, f[1] * sm_scale),
                       bf16x2_bits(f[2] * sm_scale, f[3] * sm_scale),
                       bf16x2_bits(f[4] * sm_scale, f[5] * sm_scale),
                       bf16x2_bits(f[6] * sm_scale, f[7] * sm_scale));
    }
    *reinterpret_cast<uint4*>(&sm.q[h][c]) = val;
  }
  __syncthreads();
  uint32_t qa[ATT_D / 16][4];
  load_q_frags(sm.q, qa);

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
      stage_kv<DA_THREADS>(sm.k[nx % DA_STAGES], sm.v[nx % DA_STAGES], kb, vb,
                           t_begin + nx * KV_TK, t_end);
    cp_async_commit();
    if (t0 + r0 < t_end) {  // warp-uniform: the warp has a valid row
      float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
      qk_16keys(qa, sm.k[st], r0, s);
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int pos = t0 + r0 + j * 8 + tig * 2 + (e & 1);
          s[j][e] = pos < t_end ? (kV2 ? s[j][e] : s[j][e] * sm_scale) : CHATGLM_MASK_VALUE;
        }
      online_softmax<2>(s, m_r, l_r, acc);
      uint32_t pa[4];
      p_frag(s, pa);
      pv_16keys(pa, sm.v[st], r0, acc);
      if (kV2) {  // p in f32 through PV: the bf16 remainder in a second product
        p_frag_lo(s, pa);
        pv_16keys(pa, sm.v[st], r0, acc);
      }
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
      ob[i] = from_f32<bf16>(a / l);
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
    *reinterpret_cast<uint2*>(ob + i) = make_uint2(bf16x2_bits(a[j].x / l, a[j].y / l),
                                                   bf16x2_bits(a[j].z / l, a[j].w / l));
  }
  if (tid == 0) arrivals[bg] = 0;  // ready for the next launch (and a graph replay)
}

template <bool kV2>
int launch_decode(const bf16* q, const bf16* k, const bf16* v, const int* lengths, float* part,
                  int* arrivals, bf16* out, int B, int G, int Hg, int Tc, int span,
                  float sm_scale, cudaStream_t stream) {
  const int smem = (int)sizeof(DecodeSmem);
  // the opt-in to > 48 KiB of dynamic shared memory holds for the process
  static const cudaError_t opt_in = cudaFuncSetAttribute(
      decode_attn_kernel<kV2>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (opt_in != cudaSuccess) return (int)opt_in;
  const int nspan = (Tc + span - 1) / span;
  decode_attn_kernel<kV2><<<dim3(B * G, nspan), DA_THREADS, smem, stream>>>(
      q, k, v, lengths, out, part, arrivals, G, Hg, Tc, span, nspan, sm_scale);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Flash prefill attention (B5, whole-prompt and chunked)
// ---------------------------------------------------------------------------

struct PrefillTileSmem {
  bf16 q[PF_ROWS][KV_STRIDE];
  bf16 k[PF_STAGES][KV_TK][KV_STRIDE];
  bf16 v[PF_STAGES][KV_TK][KV_STRIDE];
};

__global__ void __launch_bounds__(PF_THREADS)
prefill_attn_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const int* __restrict__ lengths,
                    const int* __restrict__ q_starts, const int* __restrict__ kv_row_map,
                    bf16* __restrict__ out, int S, int G, int Hg, int Tc, float sm_scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  PrefillTileSmem& sm = *reinterpret_cast<PrefillTileSmem*>(smem_raw);

  const int qt = PF_ROWS / Hg;  // query positions per block
  const int rows = qt * Hg;  // folded rows that hold one
  const int q0 = blockIdx.x * qt;
  const int g = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int length = lengths[b];
  const int q_start = q_starts ? q_starts[b] : 0;  // absolute position of query row 0
  const int kv_row = kv_row_map ? kv_row_map[b] : b;
  const int last_q = q_start + min(q0 + qt, S) - 1;  // absolute
  // causal block skip: rows past the block's last query or the row length
  const int n_read = max(0, min(min(last_q + 1, length), Tc));
  const int ntiles = (n_read + KV_TK - 1) / KV_TK;
  const bf16* kb = k + ((size_t)kv_row * G + g) * Tc * ATT_D;
  const bf16* vb = v + ((size_t)kv_row * G + g) * Tc * ATT_D;

  // row r = (position q0 + r / Hg, head r % Hg); q and out are (B, S, G, Hg, D)
  for (int i = tid; i < PF_ROWS * (ATT_D / 8); i += PF_THREADS) {
    const int r = i / (ATT_D / 8), c = (i % (ATT_D / 8)) * 8;
    const int s = q0 + r / Hg, h = r % Hg;
    const bool ok = r < rows && s < S;
    const bf16* src = ok ? q + (((size_t)b * S + s) * G + g) * Hg * ATT_D + h * ATT_D + c : q;
    cp_async16(&sm.q[r][c], src, ok);
  }
#pragma unroll
  for (int st = 0; st < PF_STAGES - 1; ++st) {  // q lands with the first group
    if (st < ntiles) stage_kv<PF_THREADS>(sm.k[st], sm.v[st], kb, vb, st * KV_TK, n_read);
    cp_async_commit();
  }
  cp_async_wait<PF_STAGES - 2>();
  __syncthreads();

  const int r0 = warp * 16;  // this warp's rows
  // the last absolute position among the warp's rows that hold one (-1: none)
  const int warp_hi = (r0 < rows && q0 + r0 / Hg < S)
                          ? q_start + min(q0 + min(r0 + 15, rows - 1) / Hg, S - 1)
                          : -1;
  int qpos[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) qpos[hh] = q_start + q0 + (r0 + gid + 8 * hh) / Hg;
  uint32_t qa[ATT_D / 16][4];
  load_q_frags(sm.q + r0, qa);

  float m_r[2] = {-INFINITY, -INFINITY}, l_r[2] = {0.f, 0.f};
  float acc[ATT_D / 8][4];
#pragma unroll
  for (int n = 0; n < ATT_D / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  for (int it = 0; it < ntiles; ++it) {
    const int t0 = it * KV_TK, st = it % PF_STAGES;
    cp_async_wait<PF_STAGES - 2>();  // this tile landed; the later ones stay in flight
    __syncthreads();  // and every warp is done with the stage the next copy reuses
    const int nx = it + PF_STAGES - 1;
    if (nx < ntiles)
      stage_kv<PF_THREADS>(sm.k[nx % PF_STAGES], sm.v[nx % PF_STAGES], kb, vb, nx * KV_TK, n_read);
    cp_async_commit();
    if (t0 <= warp_hi) {  // warp-uniform: skip a tile wholly above the warp's positions
      float s[KV_TK / 8][4];
#pragma unroll
      for (int j = 0; j < KV_TK / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int n0 = 0; n0 < KV_TK; n0 += 16) qk_16keys(qa, sm.k[st], n0, s + n0 / 8);
#pragma unroll
      for (int j = 0; j < KV_TK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int pos = t0 + j * 8 + tig * 2 + (e & 1);
          s[j][e] = (pos <= qpos[e >> 1] && pos < length) ? s[j][e] * sm_scale : CHATGLM_MASK_VALUE;
        }
      online_softmax<KV_TK / 8>(s, m_r, l_r, acc);
#pragma unroll
      for (int k0 = 0; k0 < KV_TK; k0 += 16) {
        uint32_t pa[4];
        p_frag(s + k0 / 8, pa);  // p rounded to bf16, as B5 casts it to v's dtype
        pv_16keys(pa, sm.v[st], k0, acc);
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = r0 + gid + 8 * hh;
    const int s = q0 + r / Hg, h = r % Hg;
    if (r >= rows || s >= S) continue;
    const float l = l_r[hh] == 0.f ? 1.f : l_r[hh];  // a length-0 row: acc 0, output 0
    bf16* o = out + (((size_t)b * S + s) * G + g) * Hg * ATT_D + h * ATT_D;
#pragma unroll
    for (int n = 0; n < ATT_D / 8; ++n)
      *reinterpret_cast<uint32_t*>(o + n * 8 + tig * 2) =
          bf16x2_bits(acc[n][2 * hh] / l, acc[n][2 * hh + 1] / l);
  }
}

int launch_prefill(const bf16* q, const bf16* k, const bf16* v, const int* lengths,
                   const int* q_starts, const int* kv_row_map, bf16* out, int B, int S, int G,
                   int Hg, int Tc, float sm_scale, cudaStream_t stream) {
  const int smem = (int)sizeof(PrefillTileSmem);
  // the opt-in to > 48 KiB of dynamic shared memory holds for the process:
  // set it at the first launch only, not on every layer of every prefill
  static const cudaError_t opt_in = cudaFuncSetAttribute(
      prefill_attn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (opt_in != cudaSuccess) return (int)opt_in;
  const int qt = PF_ROWS / Hg;
  const dim3 grid((S + qt - 1) / qt, G, B);
  prefill_attn_kernel<<<grid, PF_THREADS, smem, stream>>>(
      q, k, v, lengths, q_starts, kv_row_map, out, S, G, Hg, Tc, sm_scale);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Paged pool: write, ragged decode, chunk attention (CUDA-core tiles of
// their own: 32-row K/V tiles widened to f32 in shared memory)
// ---------------------------------------------------------------------------

constexpr int ATT_THREADS = 256;
constexpr int DEC_TK = 32;        // KV rows per tile (= warp size: one lane per row)
constexpr int DEC_MAXH = 16;      // query heads per KV group
constexpr int DEC_HPT = DEC_MAXH * ATT_D / ATT_THREADS;  // heads per thread in PV
constexpr int VEC = 8;            // bf16 elements per 16-byte load
constexpr int PRE_ROWS = 64;      // folded (position, head) rows per chunk block
constexpr int PRE_TK = 32;        // KV rows per tile
constexpr int PRE_RPT = PRE_ROWS * ATT_D / ATT_THREADS;  // rows per thread in PV

struct PrefillSmem {
  float qs[PRE_ROWS][ATT_D];
  float ks[PRE_TK][ATT_D + 1];
  float vs[PRE_TK][ATT_D];
  float ps[PRE_ROWS][PRE_TK];
  float m_s[PRE_ROWS], l_s[PRE_ROWS], alpha_s[PRE_ROWS];
};

// 8 bf16 (one 16-byte load) to f32
__device__ __forceinline__ void unpack_bf16x8(const uint4& u, float* dst) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int j = 0; j < VEC / 2; ++j) {
    const float2 f = __bfloat1622float2(h[j]);
    dst[2 * j] = f.x;
    dst[2 * j + 1] = f.y;
  }
}

// Stage K/V rows t0 .. t0+TK-1 of KV group g into shared memory (f32), each
// row read from the page the table maps its position to; rows at or past
// n_read are zero.  row_pt: the row's MP page ids; layer: the (NP, G, P, D)
// view of one pool layer.
template <int TK, int KSTRIDE>
__device__ __forceinline__ void stage_paged_tile(const bf16* __restrict__ kl,
                                                 const bf16* __restrict__ vl,
                                                 const int* __restrict__ row_pt, int g, int G,
                                                 int P, int t0, int n_read, float (*ks)[KSTRIDE],
                                                 float (*vs)[ATT_D]) {
  constexpr int CH = ATT_D / VEC;  // 16-byte chunks per row
  for (int i = threadIdx.x; i < TK * CH; i += ATT_THREADS) {
    const int t = i / CH, c = i % CH, pos = t0 + t;
    float kf[VEC], vf[VEC];
    if (pos < n_read) {
      const int page = row_pt[pos / P];
      const size_t off = (((size_t)page * G + g) * P + pos % P) * ATT_D + c * VEC;
      unpack_bf16x8(*reinterpret_cast<const uint4*>(kl + off), kf);
      unpack_bf16x8(*reinterpret_cast<const uint4*>(vl + off), vf);
    } else {
#pragma unroll
      for (int j = 0; j < VEC; ++j) kf[j] = vf[j] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      ks[t][c * VEC + j] = kf[j];
      vs[t][c * VEC + j] = vf[j];
    }
  }
}

__global__ void pool_write_kernel(uint16_t* __restrict__ pool_layer, const uint16_t* __restrict__ src,
                                  const int* __restrict__ page_table, const int* __restrict__ starts,
                                  int G, int P, int D, int MP) {
  const int b = blockIdx.x;
  const int pos = min(max(starts[b], 0), MP * P - 1);  // capacity clamp
  const int page = page_table[(size_t)b * MP + pos / P];
  const int off = pos % P;
  for (int i = threadIdx.x; i < G * D; i += blockDim.x) {
    const int g = i / D, d = i % D;
    pool_layer[(((size_t)page * G + g) * P + off) * D + d] = src[(size_t)b * G * D + i];
  }
}

__global__ void __launch_bounds__(ATT_THREADS)
decode_paged_kernel(const bf16* __restrict__ q, const bf16* __restrict__ kl,
                    const bf16* __restrict__ vl, const int* __restrict__ page_table,
                    const int* __restrict__ lengths, bf16* __restrict__ out, int G, int Hg, int P,
                    int MP, float sm_scale) {
  __shared__ float qs[DEC_MAXH][ATT_D];
  __shared__ float ks[DEC_TK][ATT_D + 1];
  __shared__ float vs[DEC_TK][ATT_D];
  __shared__ float ps[DEC_MAXH][DEC_TK];
  __shared__ float m_s[DEC_MAXH], l_s[DEC_MAXH], alpha_s[DEC_MAXH];

  const int bg = blockIdx.x;  // b * G + g
  const int b = bg / G, g = bg % G;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // positions 0..lengths[b] inclusive, pages clamped to the table's MP
  const int n_valid = min(lengths[b] + 1, MP * P);
  const int* row_pt = page_table + (size_t)b * MP;
  const bf16* qb = q + (size_t)bg * Hg * ATT_D;

  // q pre-scaled in its own dtype, as the TPU kernel does
  for (int i = tid; i < Hg * ATT_D; i += ATT_THREADS)
    qs[i / ATT_D][i % ATT_D] = round_to<bf16>(to_f32(qb[i]) * sm_scale);
  if (tid < DEC_MAXH) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
  }
  const int d = tid % ATT_D, hs = tid / ATT_D;
  float acc[DEC_HPT];
#pragma unroll
  for (int j = 0; j < DEC_HPT; ++j) acc[j] = 0.f;

  for (int t0 = 0; t0 < n_valid; t0 += DEC_TK) {
    stage_paged_tile<DEC_TK, ATT_D + 1>(kl, vl, row_pt, g, G, P, t0, n_valid, ks, vs);
    __syncthreads();
    for (int i = tid; i < Hg * DEC_TK; i += ATT_THREADS) {
      const int h = i / DEC_TK, t = i % DEC_TK;
      float s = 0.f;
#pragma unroll 8
      for (int dd = 0; dd < ATT_D; ++dd) s = fmaf(qs[h][dd], ks[t][dd], s);
      ps[h][t] = (t0 + t < n_valid) ? s : CHATGLM_MASK_VALUE;
    }
    __syncthreads();
    for (int h = warp; h < Hg; h += ATT_THREADS / 32) {
      const float s = ps[h][lane];
      const float m_prev = m_s[h];
      const float m_next = fmaxf(m_prev, warp_max(s));
      const float alpha = expf(m_prev - m_next);
      const float p = expf(s - m_next);
      const float psum = warp_sum(p);
      ps[h][lane] = p;  // f32 into the PV product, as on the TPU
      if (lane == 0) {
        m_s[h] = m_next;
        l_s[h] = alpha * l_s[h] + psum;
        alpha_s[h] = alpha;
      }
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < DEC_HPT; ++j) {
      const int h = hs + j * (ATT_THREADS / ATT_D);
      if (h < Hg) {
        float o = acc[j] * alpha_s[h];
#pragma unroll 8
        for (int t = 0; t < DEC_TK; ++t) o = fmaf(ps[h][t], vs[t][d], o);
        acc[j] = o;
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int j = 0; j < DEC_HPT; ++j) {
    const int h = hs + j * (ATT_THREADS / ATT_D);
    if (h < Hg) {
      const float l = l_s[h];
      out[((size_t)bg * Hg + h) * ATT_D + d] = from_f32<bf16>(acc[j] / (l == 0.f ? 1.f : l));
    }
  }
}

__global__ void __launch_bounds__(ATT_THREADS)
chunk_paged_kernel(const bf16* __restrict__ q, const bf16* __restrict__ kl,
                   const bf16* __restrict__ vl, const int* __restrict__ page_table,
                   const int* __restrict__ starts, bf16* __restrict__ out, int S, int G, int Hg,
                   int P, int MP, float sm_scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  PrefillSmem& sm = *reinterpret_cast<PrefillSmem*>(smem_raw);

  const int qt = PRE_ROWS / Hg;  // query positions per block
  const int rows = qt * Hg;
  const int q0 = blockIdx.x * qt;
  const int g = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int start = starts[b];
  const int cap = MP * P;  // positions the table can address
  const int last_q = start + min(q0 + qt, S) - 1;  // absolute
  const int n_read = min(last_q + 1, cap);
  const int* row_pt = page_table + (size_t)b * MP;

  // row r = (position q0 + r / Hg, head r % Hg); q and out are (B, S, G, Hg, D)
  for (int i = tid; i < PRE_ROWS * ATT_D; i += ATT_THREADS) {
    const int r = i / ATT_D, dd = i % ATT_D;
    const int s = q0 + r / Hg, h = r % Hg;
    float val = 0.f;
    if (r < rows && s < S)
      val = round_to<bf16>(
          to_f32(q[(((size_t)b * S + s) * G + g) * Hg * ATT_D + h * ATT_D + dd]) * sm_scale);
    sm.qs[r][dd] = val;
  }
  if (tid < PRE_ROWS) {
    sm.m_s[tid] = -INFINITY;
    sm.l_s[tid] = 0.f;
  }
  const int d = tid % ATT_D, rs = tid / ATT_D;
  float acc[PRE_RPT];
#pragma unroll
  for (int j = 0; j < PRE_RPT; ++j) acc[j] = 0.f;

  for (int t0 = 0; t0 < n_read; t0 += PRE_TK) {
    stage_paged_tile<PRE_TK, ATT_D + 1>(kl, vl, row_pt, g, G, P, t0, n_read, sm.ks, sm.vs);
    __syncthreads();
    for (int i = tid; i < PRE_ROWS * PRE_TK; i += ATT_THREADS) {
      const int r = i / PRE_TK, t = i % PRE_TK;
      const int qpos = start + q0 + r / Hg, pos = t0 + t;
      float s = 0.f;
#pragma unroll 8
      for (int dd = 0; dd < ATT_D; ++dd) s = fmaf(sm.qs[r][dd], sm.ks[t][dd], s);
      sm.ps[r][t] = (pos <= qpos && pos < n_read) ? s : CHATGLM_MASK_VALUE;
    }
    __syncthreads();
    for (int r = warp; r < PRE_ROWS; r += ATT_THREADS / 32) {
      const float s = sm.ps[r][lane];
      const float m_prev = sm.m_s[r];
      const float m_next = fmaxf(m_prev, warp_max(s));
      const float alpha = expf(m_prev - m_next);
      const float p = expf(s - m_next);
      const float psum = warp_sum(p);
      sm.ps[r][lane] = p;  // f32 into the PV product, as on the TPU
      if (lane == 0) {
        sm.m_s[r] = m_next;
        sm.l_s[r] = alpha * sm.l_s[r] + psum;
        sm.alpha_s[r] = alpha;
      }
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < PRE_RPT; ++j) {
      const int r = rs + j * (ATT_THREADS / ATT_D);
      float o = acc[j] * sm.alpha_s[r];
#pragma unroll 8
      for (int t = 0; t < PRE_TK; ++t) o = fmaf(sm.ps[r][t], sm.vs[t][d], o);
      acc[j] = o;
    }
    __syncthreads();
  }
#pragma unroll
  for (int j = 0; j < PRE_RPT; ++j) {
    const int r = rs + j * (ATT_THREADS / ATT_D);
    const int s = q0 + r / Hg, h = r % Hg;
    if (r < rows && s < S) {
      const float l = sm.l_s[r];
      out[(((size_t)b * S + s) * G + g) * Hg * ATT_D + h * ATT_D + d] =
          from_f32<bf16>(acc[j] / (l == 0.f ? 1.f : l));
    }
  }
}

}  // namespace

extern "C" {

// cache_layer: the (B, G, T, D) bf16 view of one layer; src: (B, G, D) bf16;
// starts: (B,) int32 on the device.
int chatglm_kv_write(void* cache_layer, const void* src, const void* starts, int B, int G, int T,
                     int D, void* stream) {
  const int want = ((G * D + 31) / 32) * 32;
  const int threads = want < 1024 ? want : 1024;
  kv_write_kernel<<<B, threads, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<uint16_t*>(cache_layer), static_cast<const uint16_t*>(src),
      static_cast<const int*>(starts), G, T, D);
  return (int)cudaGetLastError();
}

// B4 (v2 = 0) and B12 (v2 = 1).  q, out (B, G, Hg, D); k, v (B, G, T, D)
// layer views; lengths (B,) int32 = the cache length before this token;
// part holds B*G*ceil(T/span)*Hg*(D+2) floats, and may be null when no
// (b, g) can have more than one span (ceil(T/span) == 1 or T <= 256);
// arrivals B*G int32 zeros (left zero).  All bf16; D == 128, Hg <= 16, span
// a multiple of 64.
int chatglm_decode_attention(const void* q, const void* k, const void* v, const void* lengths,
                             void* part, void* arrivals, void* out, int B, int G, int Hg, int T,
                             int D, int span, int v2, float sm_scale, void* stream) {
  // the span merge holds every span's (m, l) and weight of a (b, g) in the ring's bytes
  const size_t nspan = (T + (size_t)span - 1) / (span > 0 ? span : 1);
  if (D != ATT_D || Hg > MMA_HEADS || span < KV_TK || span % KV_TK ||
      nspan * MMA_HEADS * 12 + MMA_HEADS * 4 > sizeof(DecodeSmem))
    return (int)cudaErrorInvalidValue;
  auto launch = v2 ? launch_decode<true> : launch_decode<false>;
  return launch(static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                static_cast<const bf16*>(v), static_cast<const int*>(lengths),
                static_cast<float*>(part), static_cast<int*>(arrivals), static_cast<bf16*>(out), B,
                G, Hg, T, span, sm_scale, reinterpret_cast<cudaStream_t>(stream));
}

// q, out (B, S, G, Hg, D); k, v (Bk, G, T, D) layer views; lengths (B,)
// int32.  q_starts (B,) int32 or null (all 0: then T >= S); kv_row_map (B,)
// int32 rows of k/v, or null (row b).  All bf16; D == 128, Hg <= 64.
int chatglm_prefill_attention(const void* q, const void* k, const void* v, const void* lengths,
                              const void* q_starts, const void* kv_row_map, void* out, int B,
                              int S, int G, int Hg, int T, int D, float sm_scale,
                              void* stream) {
  if (D != ATT_D || Hg > 64) return (int)cudaErrorInvalidValue;
  return launch_prefill(static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                static_cast<const bf16*>(v), static_cast<const int*>(lengths),
                static_cast<const int*>(q_starts), static_cast<const int*>(kv_row_map),
                static_cast<bf16*>(out), B, S, G, Hg, T, sm_scale,
                reinterpret_cast<cudaStream_t>(stream));
}

// pool_layer: the (NP, G, P, D) bf16 view of one pool layer; src (B, G, D)
// bf16; page_table (B, MP) and starts (B,) int32 on the device.
int chatglm_pool_write(void* pool_layer, const void* src, const void* page_table, const void* starts,
                       int B, int G, int P, int D, int MP, void* stream) {
  const int want = ((G * D + 31) / 32) * 32;
  const int threads = want < 1024 ? want : 1024;
  pool_write_kernel<<<B, threads, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<uint16_t*>(pool_layer), static_cast<const uint16_t*>(src),
      static_cast<const int*>(page_table), static_cast<const int*>(starts), G, P, D, MP);
  return (int)cudaGetLastError();
}

// q, out (B, G, Hg, D); k, v (NP, G, P, D) pool layer views; page_table (B,
// MP) and lengths (B,) int32 = the cache length before this token.  All
// bf16; D == 128, Hg <= 16.
int chatglm_decode_paged(const void* q, const void* k, const void* v, const void* page_table,
                         const void* lengths, void* out, int B, int G, int Hg, int P, int D,
                         int MP, float sm_scale, void* stream) {
  if (D != ATT_D || Hg > DEC_MAXH) return (int)cudaErrorInvalidValue;
  decode_paged_kernel<<<B * G, ATT_THREADS, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const int*>(page_table), static_cast<const int*>(lengths),
      static_cast<bf16*>(out), G, Hg, P, MP, sm_scale);
  return (int)cudaGetLastError();
}

// q, out (B, S, G, Hg, D); k, v (NP, G, P, D) pool layer views; page_table
// (B, MP) (rows already mapped) and starts (B,) int32.  All bf16; D == 128,
// Hg <= 64.
int chatglm_chunk_paged(const void* q, const void* k, const void* v, const void* page_table,
                        const void* starts, void* out, int B, int S, int G, int Hg, int P, int D,
                        int MP, float sm_scale, void* stream) {
  if (D != ATT_D || Hg > PRE_ROWS) return (int)cudaErrorInvalidValue;
  const int smem = (int)sizeof(PrefillSmem);
  static const cudaError_t opt_in = cudaFuncSetAttribute(
      chunk_paged_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (opt_in != cudaSuccess) return (int)opt_in;
  const int qt = PRE_ROWS / Hg;
  const dim3 grid((S + qt - 1) / qt, G, B);
  chunk_paged_kernel<<<grid, ATT_THREADS, smem, reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const int*>(page_table), static_cast<const int*>(starts),
      static_cast<bf16*>(out), S, G, Hg, P, MP, sm_scale);
  return (int)cudaGetLastError();
}

}  // extern "C"

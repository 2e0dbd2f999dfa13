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
// decode_attn_kernel<false> replaces pallas_attention.py:_decode_kernel
// (flash_attention_decode / _idx).  Bound by bytes: it reads each valid K/V
// row once and does ~4 operations per byte.  One block per (b, g): the 16
// query heads of a KV group share every K/V row the block stages into
// shared memory, and only slots 0..lengths[b] (inclusive) are read — the
// O(length) property.  Online softmax in f32; probabilities are rounded to
// the value dtype before the PV product.  At batch 1 that is B*G = 2 blocks,
// so a long cache leaves most SMs idle: the span grid of B12 below, with
// B4's numerics, is the planned answer (a launch with part set, and the
// merge kernel).
//
// decode_paged_kernel replaces pallas_attention.py:_decode_paged_kernel
// (flash_attention_decode_paged, stride 1 / phase 0).  Bound by bytes, as
// decode_attn_kernel, whose structure it keeps: one block per (b, g), 32-row
// K/V tiles in shared memory, online softmax.  The TPU kernel double-buffers
// whole pages of K and V; at P = 256, D = 128 that is 256 KB of staging, more
// than the 227 KB a block may use, so this kernel stages 32 rows at a time and
// resolves each row's page from the table (16-byte loads, one page per row).
// Rows past capacity are never read: positions stop at min(lengths+1, MP*P),
// so the table is never read at column MP.  As on the TPU, q is scaled by
// sm_scale and rounded to bf16 before the dot, and probabilities stay f32
// in the PV product.
//
// prefill_attn_kernel replaces pallas_attention.py:_prefill_kernel
// (flash_attention_prefill, with its q_starts / kv_row_map chunked form).
// Bound by operations at long prompts.  One block per (b, g, 64 / Hg query
// positions): the Hg heads of the group fold into the 64 rows of the query
// tile, as on the TPU.  Query row r of batch b sits at absolute position
// q_starts[b] + r and reads K/V from cache row kv_row_map[b]; KV tiles above
// the tile's last causal position or past lengths[b] are skipped; rows of a
// length-0 row output 0.  CUDA-core FMAs for now; mma.sync / wgmma tiles are
// later work.
//
// chunk_paged_kernel replaces pallas_attention.py:_chunk_paged_kernel
// (flash_attention_chunk_paged).  S queries per row at absolute positions
// starts[b] + t attend logical positions <= starts[b] + t through the page
// table: the speculative verify step (S = k+1) and small prefill chunks.
// The prefill kernel's folded 64-row tiles over 32-row K/V tiles read from
// pages (the same staging answer to the TPU's 256 KB of page buffers), with
// B10's numerics: q pre-scaled and rounded to bf16, probabilities f32.
// Bound by bytes at S = 9 (each valid K/V row read once per query tile).
//
// decode_attn_kernel<true> + decode_merge_kernel replace
// pallas_attention.py:_decode_v2_kernel (flash_attention_decode_v2, the
// decode_attn_v2 option).  B4's body with B12's numerics: q scaled by
// sm_scale and rounded to bf16 before the dot, probabilities f32 in the PV
// product, a row with no valid slot outputs 0.  Bound by bytes, like B4; the
// TPU kernel's point is reads that grow with the length, not with T.  Here
// the grid runs over (b, g, span of rows): a span at or past lengths[b] + 1
// exits before it reads anything, the others write f32 (m, l, acc)
// partials, and a second small kernel merges them in span order.  At batch
// 1-4, where B4's one block per (b, g) runs 2-8 blocks, the spans give the
// card up to B*G*T/span blocks; the wrapper picks the span.
#include "common.cuh"

namespace {

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
// Ragged decode attention
// ---------------------------------------------------------------------------

constexpr int ATT_D = 128;        // head dim the kernels are built for
constexpr int ATT_THREADS = 256;
constexpr int DEC_TK = 32;        // KV rows per tile (= warp size: one lane per row)
constexpr int DEC_MAXH = 16;      // query heads per KV group
constexpr int DEC_HPT = DEC_MAXH * ATT_D / ATT_THREADS;  // heads per thread in PV
constexpr int VEC = 8;            // bf16 elements per 16-byte load

using bf16 = __nv_bfloat16;

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

// Block (b*G + g, sp) attends rows [sp*span, min((sp+1)*span, n_valid)) of
// its (b, g) cache.  kV2 picks B12's numerics (q pre-scaled and rounded to
// bf16, probabilities f32 in the PV product) over B4's (the score scaled in
// f32, probabilities rounded to bf16).  With part null (B4: one span of Tc
// rows) the block writes the normalised output; otherwise it writes the f32
// partials (m, l, unnormalised acc) of its Hg heads for decode_merge_kernel,
// and a block whose span starts at or past n_valid exits at once.
template <bool kV2>
__global__ void __launch_bounds__(ATT_THREADS)
decode_attn_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const int* __restrict__ lengths,
                   bf16* __restrict__ out, float* __restrict__ part, int G, int Hg, int Tc,
                   int span, int nspan, float sm_scale) {
  __shared__ float qs[DEC_MAXH][ATT_D];
  __shared__ float ks[DEC_TK][ATT_D + 1];
  __shared__ float vs[DEC_TK][ATT_D];
  __shared__ float ps[DEC_MAXH][DEC_TK];
  __shared__ float m_s[DEC_MAXH], l_s[DEC_MAXH], alpha_s[DEC_MAXH];

  const int bg = blockIdx.x, sp = blockIdx.y;  // bg = b * G + g
  const int b = bg / G;
  const int n_valid = min(lengths[b] + 1, Tc);  // slots 0..lengths[b] inclusive
  const int t_begin = sp * span;
  if (part && t_begin >= n_valid) return;  // O(length): spans past the row read nothing
  const int t_end = min(t_begin + span, n_valid);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const bf16* qb = q + (size_t)bg * Hg * ATT_D;
  const bf16* kb = k + (size_t)bg * Tc * ATT_D;
  const bf16* vb = v + (size_t)bg * Tc * ATT_D;

  // B12: q pre-scaled in its own dtype, as the TPU kernel's wrapper does
  for (int i = tid; i < Hg * ATT_D; i += ATT_THREADS)
    qs[i / ATT_D][i % ATT_D] = kV2 ? round_to<bf16>(to_f32(qb[i]) * sm_scale) : to_f32(qb[i]);
  if (tid < DEC_MAXH) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
  }
  const int d = tid % ATT_D, hs = tid / ATT_D;
  float acc[DEC_HPT];
#pragma unroll
  for (int j = 0; j < DEC_HPT; ++j) acc[j] = 0.f;

  constexpr int CH = ATT_D / VEC;  // 16-byte chunks per row
  for (int t0 = t_begin; t0 < t_end; t0 += DEC_TK) {
    for (int i = tid; i < DEC_TK * CH; i += ATT_THREADS) {
      const int t = i / CH, c = i % CH, pos = t0 + t;
      float kf[VEC], vf[VEC];
      if (pos < t_end) {
        unpack_bf16x8(*reinterpret_cast<const uint4*>(kb + (size_t)pos * ATT_D + c * VEC), kf);
        unpack_bf16x8(*reinterpret_cast<const uint4*>(vb + (size_t)pos * ATT_D + c * VEC), vf);
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
    __syncthreads();
    for (int i = tid; i < Hg * DEC_TK; i += ATT_THREADS) {
      const int h = i / DEC_TK, t = i % DEC_TK;
      float s = 0.f;
#pragma unroll 8
      for (int dd = 0; dd < ATT_D; ++dd) s = fmaf(qs[h][dd], ks[t][dd], s);
      ps[h][t] = (t0 + t < t_end) ? (kV2 ? s : s * sm_scale) : CHATGLM_MASK_VALUE;
    }
    __syncthreads();
    for (int h = warp; h < Hg; h += ATT_THREADS / 32) {
      const float s = ps[h][lane];
      const float m_prev = m_s[h];
      const float m_next = fmaxf(m_prev, warp_max(s));
      const float alpha = expf(m_prev - m_next);
      const float p = expf(s - m_next);
      const float psum = warp_sum(p);
      ps[h][lane] = kV2 ? p : round_to<bf16>(p);  // B12: f32 into the PV product
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
  // partial layout per (bg, sp): Hg rows of [m, l, acc[0..D)]
  float* pb = part ? part + ((size_t)bg * nspan + sp) * Hg * (ATT_D + 2) : nullptr;
#pragma unroll
  for (int j = 0; j < DEC_HPT; ++j) {
    const int h = hs + j * (ATT_THREADS / ATT_D);
    if (h >= Hg) continue;
    if (!pb) {
      const float l = l_s[h];
      out[((size_t)bg * Hg + h) * ATT_D + d] = from_f32<bf16>(acc[j] / (l == 0.f ? 1.f : l));
    } else {
      pb[h * (ATT_D + 2) + 2 + d] = acc[j];
      if (d == 0) {
        pb[h * (ATT_D + 2)] = m_s[h];
        pb[h * (ATT_D + 2) + 1] = l_s[h];
      }
    }
  }
}

// One block per (b, g): merge the partials of the spans that ran, in span
// order (deterministic).  A row with no valid slot outputs 0, as the TPU
// kernel's l == 0 guard gives.
__global__ void __launch_bounds__(ATT_THREADS)
decode_merge_kernel(const float* __restrict__ part, const int* __restrict__ lengths,
                    bf16* __restrict__ out, int G, int Hg, int Tc, int span, int nspan) {
  const int bg = blockIdx.x, b = bg / G;
  const int n_valid = min(lengths[b] + 1, Tc);
  const int ran = n_valid > 0 ? (n_valid + span - 1) / span : 0;
  const float* pb = part + (size_t)bg * nspan * Hg * (ATT_D + 2);
  for (int i = threadIdx.x; i < Hg * ATT_D; i += ATT_THREADS) {
    const int h = i / ATT_D, d = i % ATT_D;
    float m = -INFINITY;
    for (int s = 0; s < ran; ++s) m = fmaxf(m, pb[((size_t)s * Hg + h) * (ATT_D + 2)]);
    float l = 0.f, a = 0.f;
    for (int s = 0; s < ran; ++s) {
      const float* r = pb + ((size_t)s * Hg + h) * (ATT_D + 2);
      const float w = expf(r[0] - m);
      l = fmaf(r[1], w, l);
      a = fmaf(r[2 + d], w, a);
    }
    out[((size_t)bg * Hg + h) * ATT_D + d] = from_f32<bf16>(ran ? a / (l == 0.f ? 1.f : l) : 0.f);
  }
}

// ---------------------------------------------------------------------------
// Flash prefill attention
// ---------------------------------------------------------------------------

constexpr int PRE_ROWS = 64;  // folded (position, head) rows per block
constexpr int PRE_TK = 32;    // KV rows per tile
constexpr int PRE_RPT = PRE_ROWS * ATT_D / ATT_THREADS;  // rows per thread in PV

struct PrefillSmem {
  float qs[PRE_ROWS][ATT_D];
  float ks[PRE_TK][ATT_D + 1];
  float vs[PRE_TK][ATT_D];
  float ps[PRE_ROWS][PRE_TK];
  float m_s[PRE_ROWS], l_s[PRE_ROWS], alpha_s[PRE_ROWS];
};

__global__ void __launch_bounds__(ATT_THREADS)
prefill_attn_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const int* __restrict__ lengths,
                    const int* __restrict__ q_starts, const int* __restrict__ kv_row_map,
                    bf16* __restrict__ out, int S, int G, int Hg, int Tc, float sm_scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  PrefillSmem& sm = *reinterpret_cast<PrefillSmem*>(smem_raw);

  const int qt = PRE_ROWS / Hg;  // query positions per block
  const int rows = qt * Hg;
  const int q0 = blockIdx.x * qt;
  const int g = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int length = lengths[b];
  const int q_start = q_starts ? q_starts[b] : 0;  // absolute position of query row 0
  const int kv_row = kv_row_map ? kv_row_map[b] : b;
  const int last_q = q_start + min(q0 + qt, S) - 1;  // absolute
  const bf16* kb = k + ((size_t)kv_row * G + g) * Tc * ATT_D;
  const bf16* vb = v + ((size_t)kv_row * G + g) * Tc * ATT_D;

  // row r = (position q0 + r / Hg, head r % Hg); q and out are (B, S, G, Hg, D)
  for (int i = tid; i < PRE_ROWS * ATT_D; i += ATT_THREADS) {
    const int r = i / ATT_D, dd = i % ATT_D;
    const int s = q0 + r / Hg, h = r % Hg;
    float val = 0.f;
    if (r < rows && s < S) val = to_f32(q[(((size_t)b * S + s) * G + g) * Hg * ATT_D + h * ATT_D + dd]);
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

  // causal block skip: tiles past the block's last query or the row length
  for (int t0 = 0; t0 <= last_q && t0 < length; t0 += PRE_TK) {
    for (int i = tid; i < PRE_TK * ATT_D; i += ATT_THREADS) {
      const int t = i / ATT_D, dd = i % ATT_D, pos = t0 + t;
      const bool ok = pos < length && pos < Tc;
      sm.ks[t][dd] = ok ? to_f32(kb[(size_t)pos * ATT_D + dd]) : 0.f;
      sm.vs[t][dd] = ok ? to_f32(vb[(size_t)pos * ATT_D + dd]) : 0.f;
    }
    __syncthreads();
    for (int i = tid; i < PRE_ROWS * PRE_TK; i += ATT_THREADS) {
      const int r = i / PRE_TK, t = i % PRE_TK;
      const int qpos = q_start + q0 + r / Hg, pos = t0 + t;
      float s = 0.f;
#pragma unroll 8
      for (int dd = 0; dd < ATT_D; ++dd) s = fmaf(sm.qs[r][dd], sm.ks[t][dd], s);
      sm.ps[r][t] = (pos <= qpos && pos < length) ? s * sm_scale : CHATGLM_MASK_VALUE;
    }
    __syncthreads();
    for (int r = warp; r < PRE_ROWS; r += ATT_THREADS / 32) {
      const float s = sm.ps[r][lane];
      const float m_prev = sm.m_s[r];
      const float m_next = fmaxf(m_prev, warp_max(s));
      const float alpha = expf(m_prev - m_next);
      const float p = expf(s - m_next);
      const float psum = warp_sum(p);
      sm.ps[r][lane] = round_to<bf16>(p);
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

int launch_prefill(const bf16* q, const bf16* k, const bf16* v, const int* lengths,
                   const int* q_starts, const int* kv_row_map, bf16* out, int B, int S, int G,
                   int Hg, int Tc, float sm_scale, cudaStream_t stream) {
  const int smem = (int)sizeof(PrefillSmem);
  // the opt-in to > 48 KiB of dynamic shared memory holds for the process:
  // set it at the first launch only, not on every layer of every prefill
  static const cudaError_t opt_in = cudaFuncSetAttribute(
      prefill_attn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (opt_in != cudaSuccess) return (int)opt_in;
  const int qt = PRE_ROWS / Hg;
  const dim3 grid((S + qt - 1) / qt, G, B);
  prefill_attn_kernel<<<grid, ATT_THREADS, smem, stream>>>(q, k, v, lengths, q_starts, kv_row_map,
                                                           out, S, G, Hg, Tc, sm_scale);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Paged pool: write, ragged decode, chunk attention
// ---------------------------------------------------------------------------

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

// q (B, G, Hg, D); k, v (B, G, T, D) layer views; lengths (B,) int32 = the
// cache length before this token; out (B, G, Hg, D).  All bf16; D == 128,
// Hg <= 16.
int chatglm_decode_attention(const void* q, const void* k, const void* v, const void* lengths,
                             void* out, int B, int G, int Hg, int T, int D, float sm_scale,
                             void* stream) {
  if (D != ATT_D || Hg > DEC_MAXH) return (int)cudaErrorInvalidValue;
  decode_attn_kernel<false><<<B * G, ATT_THREADS, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const int*>(lengths), static_cast<bf16*>(out), nullptr, G, Hg, T, T, 1,
      sm_scale);
  return (int)cudaGetLastError();
}

// q, out (B, S, G, Hg, D); k, v (Bk, G, T, D) layer views; lengths (B,)
// int32.  q_starts (B,) int32 or null (all 0: then T >= S); kv_row_map (B,)
// int32 rows of k/v, or null (row b).  All bf16; D == 128, Hg <= 64.
int chatglm_prefill_attention(const void* q, const void* k, const void* v, const void* lengths,
                              const void* q_starts, const void* kv_row_map, void* out, int B,
                              int S, int G, int Hg, int T, int D, float sm_scale, void* stream) {
  if (D != ATT_D || Hg > PRE_ROWS) return (int)cudaErrorInvalidValue;
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

// q, out (B, G, Hg, D); k, v (B, G, T, D) layer views; lengths (B,) int32 =
// the cache length before this token; part holds B*G*ceil(T/span)*Hg*(D+2)
// floats.  All bf16; D == 128, Hg <= 16.
int chatglm_decode_v2(const void* q, const void* k, const void* v, const void* lengths, void* part,
                      void* out, int B, int G, int Hg, int T, int D, int span, float sm_scale,
                      void* stream) {
  if (D != ATT_D || Hg > DEC_MAXH || span < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int nspan = (T + span - 1) / span;
  decode_attn_kernel<true><<<dim3(B * G, nspan), ATT_THREADS, 0, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const int*>(lengths), nullptr, static_cast<float*>(part), G, Hg, T, span, nspan,
      sm_scale);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  decode_merge_kernel<<<B * G, ATT_THREADS, 0, s>>>(
      static_cast<const float*>(part), static_cast<const int*>(lengths), static_cast<bf16*>(out),
      G, Hg, T, span, nspan);
  return (int)cudaGetLastError();
}

}  // extern "C"

"""Serving attention: flash prefill (whole-prompt and chunked), ragged
decode, the in-place KV writes, and their paged-pool twins — wrappers over
the CUDA kernels (csrc/attention.cu), their plain versions, and their launch
counts.

* ``flash_attention_prefill`` replaces chatglm_q_tpu/ops/pallas_attention.py
  :_prefill_kernel.  Causal attention with per-row lengths; query position s
  attends key slots j ≤ s with j < lengths[b]; a length-0 row outputs 0.
  With ``q_starts`` (the chunked-prefill form, counted apart as
  ``flash_attention_prefill_chunk``) query row r of batch b sits at absolute
  position ``q_starts[b] + r`` and attends the whole cache below it;
  ``kv_row_map`` makes row b read K/V from cache row ``kv_row_map[b]``.
* ``flash_attention_decode`` replaces :_decode_kernel (flash_attention_decode
  and its stacked-cache ``_idx`` form: here the caller passes the layer's
  view ``cache[l]``).  Row b attends slots 0..lengths[b] inclusive — the
  token of this step is already written — and reads nothing past them; a
  row of length −1 has no valid slot and outputs 0 (the TPU kernel's
  l == 0 guard; the plain version too).
* ``flash_attention_decode_v2`` replaces :_decode_v2_kernel (the
  ``decode_attn_v2`` option): B4's function with B10's numerics (below).
  Both decode forms launch one kernel over (b·g, span of rows), the span
  from ``decode_span``; the blocks merge their spans in the same launch,
  and a row of at most DECODE_SOLO_ROWS valid slots is one span.
* ``rope_kv_append`` replaces :_kv_write_kernel (B3) and :_pool_write_kernel
  (B9) on the decode step, fused with the RoPE of q and k that XLA fuses
  around them on the TPU: one launch per layer rotates the token's q and k
  (``apply_rotary_emb``'s rounding, bit for bit), writes k and v into the
  dense cache's slot or the pool's page slot, and returns the rotated q for
  the decode attention.  ``rope_kv_append_plain`` is the sequence it
  replaces: two ``apply_rotary_emb`` and two plain writes.
* ``kv_cache_write_idx`` (B3's API) writes one token per row into
  cache[layer, b, :, starts[b], :] in place, with starts clamped to T − 1
  (JAX's dynamic_update_slice clamp: the engines decode past the wall by
  design and roll the tokens back); ``starts`` is read on the device, so a
  decode step never syncs to the host.  It launches the append kernel's
  write-only form.
* ``kv_pool_write_idx`` (B9's API): the same write into the paged pool (L,
  NP, G, P, D), at position min(starts[b], MP·P − 1) of page
  ``page_table[b, pos // P]``; the write-only form too.
* ``flash_attention_decode_paged`` replaces :_decode_paged_kernel: ragged
  decode over the pool's pages, positions 0..lengths[b], pages clamped to
  the table's MP; a row of length −1 outputs 0.  B12's kernel reading
  through the page table: the span from ``decode_paged_span``, the same
  in-launch merge and one-span rule.
* The forms only the mesh runs (tensor-parallel serving, the sharded
  wrappers at the end of this module):
  ``flash_attention_decode_lse`` (K1) is :_decode_kernel with
  ``return_lse`` on a T-shard of the cache: B4's output and the online
  softmax's (m, l) of each (b, g, head), rows of global slots offset ..
  offset + T − 1; ``flash_attention_decode_paged_lse`` (K2) is
  :_decode_paged_kernel with ``stride``, ``phase`` and ``return_lse``:
  table column i holds logical block i·stride + phase, masked by logical
  position; ``merge_lse_partials`` merges the shards' (out, m, l) exactly;
  ``rope_kv_append_sharded`` (K3) is the decode step's append on one shard
  of a sharded cache, which writes a row's token only where the shard holds
  its slot (``KVShard``).  A shard with no valid slot gives out 0, m −inf
  and l 0.
* ``flash_attention_chunk_paged`` replaces :_chunk_paged_kernel: S queries
  per row at absolute positions starts[b] + t over the pool's pages.  B5's
  folded kernel with B10's numerics, reading through the page table (at
  table row ``row_map[b]``), its K/V rows split into ``chunk_span`` spans
  merged in the same launch.

The kernels take six forms: bf16 activations over a bf16 cache (or
pool), bf16 activations over a ``float8_e4m3fn`` one (the ``kv_dtype``
option; JAX's ``init_kv_cache(..., jnp.float8_e4m3fn)``), float16
activations over a float16 one (a float16 checkpoint: the cache takes the
activations' dtype by default), float16 activations over a
``float8_e4m3fn`` one (a float16 checkpoint with ``kv_dtype``), float32
activations over a float32 one (a float32 checkpoint, the loaders' default
dtype) and float32 activations over a ``float8_e4m3fn`` one.
``FORM_CODES`` names them; any other pair (f32 activations over a bf16 or
f16 cache, a 16-bit cache of the other 16-bit type, K and V of two dtypes)
raises ``TypeError``, naming it.  Launches in the five other forms also
count as ``<wrapper>_fp8``, ``<wrapper>_f16``, ``<wrapper>_fp8_f16``,
``<wrapper>_f32`` and ``<wrapper>_fp8_f32`` (f16 or f32 over fp8: in none
of the others).  The f16 forms keep the TPU kernels' rounding points in
f16: p rounded to v's dtype (B4, B5), q pre-scaled in its dtype and p in
f32 (B10, B11, B12), the RoPE's products and sums rounded to f16; over an
fp8 cache the same on the cache upcast exactly to f16.  The f32 forms keep
them in f32 (p is f32 throughout; B10, B11, B12 round q · sm_scale to f32
before the dot) on CUDA-core kernels: TF32 would miss f32's limit.  Into
an fp8 cache an f32 value is rounded to e4m3 once, as JAX's
``astype(float8_e4m3fn)`` rounds it.

The fp8 cache:
Every write into an fp8 cache goes through ``kv_store_cast``: JAX's
``astype(float8_e4m3fn)`` wherever that gives a finite value, finite values
past the range saturating to ±448 where JAX's give NaN, and every NaN stored
as the one byte 0x7F (from bf16 or f16 alike, both exact in f32, and from
f32 itself: one rounding, never through a 16-bit type).
Reads upcast the stored bytes exactly: the plain versions convert K and V
to q's dtype before anything is rounded to v's dtype (as the TPU kernels
upcast after their DMA), and the kernels convert each landed tile to q's
dtype, bf16, f16 or f32, in shared memory (csrc/attention.cu), so a
kernel's fp8 form equals its 16-bit or f32 form on the upcast cache.  A write-only or append
launch casts on the write.  PyTorch implements few ops on fp8
tensors, so the plain writes and gathers here move the cache's bytes
(``kv_bytes``).

Numerics shared with the TPU kernels.  Prefill and decode: scores in f32
scaled by ``sm_scale``, masked scores at MASK_VALUE, probabilities cast to
v's dtype before the PV product.  The paged decode and chunk kernels and
B12, as on the TPU, scale q by ``sm_scale`` in q's dtype before the dot and
keep the probabilities in f32.  The kernels' design notes (what bounds them on
an H100 and what they do about it) are at the top of csrc/attention.cu.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from . import _build

MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)
HEAD_DIM = 128       # the head dim the kernels are built for
MAX_DECODE_HG = 16   # query heads per KV group the decode kernel holds
MAX_PREFILL_HG = 64  # query heads per KV group the prefill tile can fold
DECODE_TILE = 64     # K/V rows per tile of the decode kernel: spans are multiples
DECODE_TARGET_BLOCKS = 132  # decode spans shrink until the grid covers the H100's SMs
DECODE_BLOCK_K = 512  # B4's starting span (B12 takes its ``block_k``)
DECODE_SOLO_ROWS = 256  # the kernel's bound (DA_SOLO_ROWS): a (b, g) with at most
                        # this many valid rows is one span, with no cross-block merge
PREFILL_ROWS = 128   # folded (position, head) query rows per prefill / chunk block (PF_ROWS)
CHUNK_MIN_SPAN = 256  # B11's spans halve no further than four tiles: each span adds a
                      # (PREFILL_ROWS, D) f32 partial that the merging block reads back
CHUNK_MAX_SPANS = 32  # and number at most this many (the merge holds every span's (m, l)
                      # and weight of a block's rows in its shared memory)




FP8 = torch.float8_e4m3fn
FP8_MAX = 448.0   # e4m3fn's largest finite value: the store saturates there
FP8_NAN = 0x7F    # the byte every NaN is stored as
# (activation dtype, cache dtype) -> the C entry points' form code
# (csrc/attention.cu: with_kv_type), and the counter suffix of each form
FORM_CODES = {(torch.bfloat16, torch.bfloat16): 0, (torch.bfloat16, FP8): 1,
              (torch.float16, torch.float16): 2, (torch.float16, FP8): 3,
              (torch.float32, torch.float32): 4, (torch.float32, FP8): 5}
FORM_SUFFIX = {0: "", 1: "fp8", 2: "f16", 3: "fp8_f16", 4: "f32", 5: "fp8_f32"}
CACHE_FORM_SUFFIXES = tuple(s for s in FORM_SUFFIX.values() if s)
# the wrappers whose kernels read or write the cache, each with a counter of
# every form but the first
CACHE_FORMS = ("rope_kv_append", "rope_kv_append_sharded", "kv_cache_write_idx",
               "kv_pool_write_idx", "flash_attention_decode", "flash_attention_decode_v2",
               "flash_attention_decode_lse", "flash_attention_prefill",
               "flash_attention_prefill_chunk", "flash_attention_decode_paged",
               "flash_attention_decode_paged_lse", "flash_attention_chunk_paged")


def kv_store_cast(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x`` as a cache of ``dtype`` stores it.  For ``float8_e4m3fn``:
    x's value rounded to nearest even (from f32: a bf16 or f16 input is
    exact there), bit-equal to JAX's ``astype(jnp.float8_e4m3fn)`` for every
    input JAX maps to a finite value; finite values and ±inf past the range
    saturate to ±448 (JAX's cast gives NaN from ±464 on, ROADMAP §C), and
    every NaN is stored as 0x7F.  The kernels' cast on write (the card's
    ``cvt.rn.satfinite`` after the same clamp) gives the same bytes.  Any
    other ``dtype``: ``x.to(dtype)``."""
    if dtype != FP8:
        return x.to(dtype)
    y = x.float().clamp(-FP8_MAX, FP8_MAX).to(FP8).view(torch.uint8)
    return y.masked_fill(torch.isnan(x), FP8_NAN).view(FP8)


def kv_bytes(t: torch.Tensor) -> torch.Tensor:
    """An fp8 cache tensor as its bytes (a view), for the indexing and
    copies PyTorch does not implement on fp8; any other tensor as it is."""
    return t.view(torch.uint8) if t.dtype == FP8 else t


def kv_put(dst: torch.Tensor, index, new: torch.Tensor) -> None:
    """``dst[index] = new`` in place, ``new`` stored through
    ``kv_store_cast`` (on the bytes for an fp8 ``dst``)."""
    kv_bytes(dst)[index] = kv_bytes(kv_store_cast(new, dst.dtype))


def kv_contiguous(t: torch.Tensor) -> torch.Tensor:
    """``t.contiguous()``, through the bytes for an fp8 tensor."""
    return kv_bytes(t).contiguous().view(t.dtype)


def kv_zeros(shape, dtype, device) -> torch.Tensor:
    """A zeroed cache tensor (an fp8 one made as bytes: +0 is byte 0)."""
    if dtype == FP8:
        return torch.zeros(shape, dtype=torch.uint8, device=device).view(FP8)
    return torch.zeros(shape, dtype=dtype, device=device)


class KVShard(NamedTuple):
    """Which slots of a sharded cache a view holds (K3's write, K1's and K2's
    reads).  A T-shard of the dense cache holds global slots ``offset`` ..
    ``offset + T_local - 1``; a model-sharded pool's strided table column i
    holds logical block ``i * stride + phase``; ``total`` is the global
    capacity a write position clamps to.  The default is the whole cache
    (``total`` 0: the view's own capacity)."""
    offset: int = 0
    stride: int = 1
    phase: int = 0
    total: int = 0


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def flash_attention_prefill_plain(q, k, v, lengths, sm_scale, q_starts=None,
                                  kv_row_map=None):
    """q (B, S, G, Hg, D); k, v (Bk, G, T, D); lengths (B,).  Without
    ``q_starts`` query s sits at position s and reads slots < S (T ≥ S);
    with it, at q_starts[b] + s over all T slots.  Returns (B, S, G, Hg, D)."""
    B, S, G, Hg, D = q.shape
    k, v = k.to(q.dtype), v.to(q.dtype)  # the stored cache upcast, as the kernels read it
    if kv_row_map is not None:
        k, v = k[kv_row_map.long()], v[kv_row_map.long()]
    if q_starts is None:
        k, v = k[:, :, :S], v[:, :, :S]
        q_starts = torch.zeros((B,), dtype=torch.int32, device=q.device)
    T = k.shape[2]
    s = torch.einsum("bsghd,bgtd->bghst", q.float(), k.float()) * sm_scale
    qpos = q_starts.long()[:, None] + torch.arange(S, device=q.device)[None, :]  # (B, S)
    cols = torch.arange(T, device=q.device)[None, None, :]
    mask = (cols <= qpos[:, :, None]) & (cols < lengths.long()[:, None, None])  # (B, S, T)
    s = s.masked_fill(~mask[:, None, None], MASK_VALUE)
    p = torch.softmax(s, dim=-1).to(v.dtype)
    out = torch.einsum("bghst,bgtd->bsghd", p.float(), v.float())
    out = out * (lengths > 0).to(out.dtype)[:, None, None, None, None]
    return out.to(q.dtype)


def flash_attention_decode_plain(q, k, v, lengths, sm_scale):
    """q (B, G, Hg, D); k, v (B, G, T, D); lengths (B,) = the cache length
    before this token.  A row with no valid slot (length −1) outputs 0, as
    the TPU kernel's l == 0 guard gives.  Returns (B, G, Hg, D)."""
    T = k.shape[2]
    k, v = k.to(q.dtype), v.to(q.dtype)  # the stored cache upcast, as the kernels read it
    s = torch.einsum("bghd,bgtd->bght", q.float(), k.float()) * sm_scale
    valid = torch.arange(T, device=q.device)[None, :] <= lengths.long()[:, None]
    s = s.masked_fill(~valid[:, None, None, :], MASK_VALUE)
    p = torch.softmax(s, dim=-1).to(v.dtype) * (lengths >= 0).to(v.dtype)[:, None, None, None]
    return torch.einsum("bght,bgtd->bghd", p.float(), v.float()).to(q.dtype)


def _lse_softmax(s, valid):
    """The online softmax's end state over masked scores s (..., T): m, the
    max of the valid scores (−inf where none), l = Σ exp(s − m), and p."""
    m = s.masked_fill(~valid, float("-inf")).amax(dim=-1)
    p = torch.exp(s - torch.where(torch.isfinite(m), m, 0.0)[..., None]) * valid
    return m, p.sum(dim=-1), p


def flash_attention_decode_lse_plain(q, k, v, lengths, sm_scale, t_offset: int = 0):
    """K1 (B4 with ``return_lse``): q (B, G, Hg, D); k, v (B, G, T, D), the
    T-shard of a cache holding global slots t_offset .. t_offset + T − 1;
    lengths (B,) global.  Row b attends the shard's slots among 0..lengths[b]
    (``clip(lengths + 1 − t_offset, 0, T)`` rows from the shard's start).
    B4's numerics: scores in f32 scaled by sm_scale, p rounded to v's dtype
    for PV.  Returns (out (B, G, Hg, D), m, l (B, G, Hg) f32): m the max of
    the scaled scores, l = Σ exp(s − m); a shard with no valid slot gives 0,
    −inf and 0."""
    T = k.shape[2]
    k, v = k.to(q.dtype), v.to(q.dtype)  # the stored cache upcast, as the kernels read it
    s = torch.einsum("bghd,bgtd->bght", q.float(), k.float()) * sm_scale
    n_local = (lengths.long() + 1 - t_offset).clamp(0, T)
    valid = (torch.arange(T, device=q.device)[None, :] < n_local[:, None])[:, None, None, :]
    m, l, p = _lse_softmax(s, valid)
    acc = torch.einsum("bght,bgtd->bghd", p.to(v.dtype).float(), v.float())
    out = acc / torch.where(l == 0, 1.0, l)[..., None]
    return out.to(q.dtype), m, l


def flash_attention_decode_paged_lse_plain(q, k_pool, v_pool, layer: int, page_table, lengths,
                                           sm_scale, stride: int = 1, phase: int = 0):
    """K2 (B10 with ``stride``, ``phase`` and ``return_lse``): table column i
    of ``page_table`` (B, MP) holds logical block i·stride + phase, and row b
    attends the logical positions ≤ lengths[b] among them (the columns past
    the table's MP hold none).  B10's numerics (q scaled in its dtype, p in
    f32).  Returns (out, m, l) as ``flash_attention_decode_lse_plain``."""
    P, MP = k_pool.shape[3], page_table.shape[1]
    k = gather_pages(k_pool[layer], page_table).to(q.dtype).float()
    v = gather_pages(v_pool[layer], page_table).to(q.dtype).float()
    s = torch.einsum("bghd,bgtd->bght", _prescaled(q, sm_scale), k)
    t = torch.arange(MP * P, device=q.device)
    logical = ((t // P) * stride + phase) * P + t % P
    valid = (logical[None, :] <= lengths.long()[:, None])[:, None, None, :]
    m, l, p = _lse_softmax(s, valid)
    out = torch.einsum("bght,bgtd->bghd", p, v) / torch.where(l == 0, 1.0, l)[..., None]
    return out.to(q.dtype), m, l


def merge_lse_partials(out, m, l, dtype):
    """The exact merge of tp flash partials gathered on a leading axis: out
    (tp, B, G, Hg, D), m and l (tp, B, G, Hg) — JAX's ``_merge_lse_partials``
    after its all-gathers.  An empty shard (l = 0) drops out.  A row empty on
    every shard gives 0, as the unsharded kernels give; JAX's exp(m − max m)
    is exp(−inf + inf) = NaN there."""
    m_max = m.amax(dim=0)
    w = l * torch.exp(m - torch.where(torch.isfinite(m_max), m_max, 0.0)[None])
    den = w.sum(dim=0).clamp_min(1e-30)
    return ((out.float() * w[..., None]).sum(dim=0) / den[..., None]).to(dtype)


def rope_kv_append_sharded_plain(q, kv, freqs, k_cache, v_cache, layer: int, starts,
                                 shard: KVShard, page_table=None):
    """K3's plain version: ``rope_kv_append_plain`` on one shard of a
    sharded cache.  q (B, Gq, Hq, D) is rotated on every rank; the write
    position min(max(starts[b], 0), shard.total − 1) is written only where
    this view holds it: slot − offset of the (L, B, G, T_local, D) T-shard,
    or (with ``page_table``, the strided local table) logical block j on
    the rank whose phase is j % stride, at column j // stride.  In place;
    returns the rotated q."""
    B, G, D = kv.shape[0], k_cache.shape[2], q.shape[-1]
    f = freqs[:, None, None, :]
    k, v = kv.reshape(B, 2, G, D).unbind(1)
    k = apply_rotary_emb(k[:, :, None], f)[:, :, 0]
    cap = k_cache.shape[3] * (1 if page_table is None else page_table.shape[1])
    pos = starts.long().clamp(0, (shard.total or cap) - 1)
    if page_table is None:
        t = pos - shard.offset
        rows = ((t >= 0) & (t < k_cache.shape[3])).nonzero()[:, 0]
        for cache, new in ((k_cache, k), (v_cache, v)):
            kv_put(cache[layer], (rows, slice(None), t[rows]), new[rows])
    else:
        P = k_cache.shape[3]
        blk = pos // P
        col = blk // shard.stride
        rows = ((blk % shard.stride == shard.phase)
                & (col < page_table.shape[1])).nonzero()[:, 0]
        page = page_table.long()[rows, col[rows]]
        for pool, new in ((k_cache, k), (v_cache, v)):
            kv_put(pool[layer], (page, slice(None), pos[rows] % P), new[rows])
    return apply_rotary_emb(q, f)


def kv_cache_write_idx_plain(cache, new, layer: int, starts):
    """cache (L, B, G, T, D); new (B, G, D); starts (B,), clamped to
    [0, T − 1].  In place."""
    B, T = new.shape[0], cache.shape[3]
    rows = torch.arange(B, device=cache.device)
    kv_put(cache[layer], (rows, slice(None), starts.long().clamp(0, T - 1)), new)
    return cache


def gather_pages(pool_layer, page_table):
    """One pool layer (NP, G, P, D) read through ``page_table`` (B, MP) as a
    dense (B, G, MP·P, D) view (a copy, in the pool's dtype)."""
    NP, G, P, D = pool_layer.shape
    B, MP = page_table.shape
    rows = kv_bytes(pool_layer)[page_table.long()]
    return rows.permute(0, 2, 1, 3, 4).reshape(B, G, MP * P, D).view(pool_layer.dtype)


def kv_pool_write_idx_plain(pool, new, layer: int, page_table, starts):
    """pool (L, NP, G, P, D); new (B, G, D); page_table (B, MP); starts (B,).
    Position min(starts[b], MP·P − 1) of row b.  In place."""
    P, MP = pool.shape[3], page_table.shape[1]
    pos = starts.long().clamp(0, MP * P - 1)
    rows = torch.arange(new.shape[0], device=pool.device)
    page = page_table.long()[rows, pos // P]
    kv_put(pool[layer], (page, slice(None), pos % P), new)
    return pool


def apply_rotary_emb(x: torch.Tensor, freqs_cis: torch.Tensor) -> torch.Tensor:
    """x (..., S, G, H, D); freqs_cis broadcastable (..., S, 1, 1, D): the
    interleaved pairs rotated by their [cos, sin] entries, each product and
    sum rounded to x's dtype (chatglm_q_tpu/models/chatglm2.py:68)."""
    xs = x.shape
    x2 = x.reshape(*xs[:-1], xs[-1] // 2, 2)
    f2 = freqs_cis.reshape(*freqs_cis.shape[:-1], xs[-1] // 2, 2)
    o_r = x2[..., 0] * f2[..., 0] - x2[..., 1] * f2[..., 1]
    o_i = x2[..., 0] * f2[..., 1] + x2[..., 1] * f2[..., 0]
    return torch.stack([o_r, o_i], dim=-1).reshape(xs)


def rope_kv_append_plain(q, kv, freqs, k_cache, v_cache, layer: int, starts, page_table=None):
    """One decode token per row: q (B, G, Hg, D); kv (B, 2·G·D), k then v;
    freqs (B, D), the token's RoPE row.  Rotates q and k, writes k and v at
    slot ``starts[b]`` of the (L, B, G, T, D) caches, or with ``page_table``
    (B, MP) into the (L, NP, G, P, D) pools, as the plain writes clamp it.
    In place; returns the rotated q (B, G, Hg, D)."""
    B, G, Hg, D = q.shape
    f = freqs[:, None, None, :]
    k, v = kv.reshape(B, 2, G, D).unbind(1)
    k = apply_rotary_emb(k[:, :, None], f)[:, :, 0]
    if page_table is None:
        kv_cache_write_idx_plain(k_cache, k, layer, starts)
        kv_cache_write_idx_plain(v_cache, v, layer, starts)
    else:
        kv_pool_write_idx_plain(k_cache, k, layer, page_table, starts)
        kv_pool_write_idx_plain(v_cache, v, layer, page_table, starts)
    return apply_rotary_emb(q, f)


def _prescaled(q, sm_scale):
    """q scaled in its own dtype, as B10/B11 scale it on the TPU."""
    return (q.float() * sm_scale).to(q.dtype).float()


def flash_attention_decode_v2_plain(q, k, v, lengths, sm_scale, block_k: int = 512):
    """B4's arguments with B12's numerics: q scaled in its dtype, K, V and
    the probabilities f32.  Rows 0..lengths[b] count; a row with none (length
    −1) outputs 0.  ``block_k`` only splits the kernel's work."""
    T = k.shape[2]
    k, v = k.to(q.dtype), v.to(q.dtype)  # the stored cache upcast, as the kernels read it
    s = torch.einsum("bghd,bgtd->bght", _prescaled(q, sm_scale), k.float())
    valid = torch.arange(T, device=q.device)[None, :] <= lengths.long()[:, None]
    s = s.masked_fill(~valid[:, None, None, :], MASK_VALUE)
    p = torch.softmax(s, dim=-1) * (lengths >= 0).float()[:, None, None, None]
    return torch.einsum("bght,bgtd->bghd", p, v.float()).to(q.dtype)


def flash_attention_decode_paged_plain(q, k_pool, v_pool, layer: int, page_table, lengths,
                                       sm_scale):
    """q (B, G, Hg, D); pools (L, NP, G, P, D); page_table (B, MP); lengths
    (B,) = the cache length before this token.  Row b attends logical
    positions < min(lengths[b] + 1, MP·P); a row with none (length −1)
    outputs 0, as the TPU kernel's l == 0 guard gives.  Returns (B, G, Hg, D)."""
    k = gather_pages(k_pool[layer], page_table).to(q.dtype).float()
    v = gather_pages(v_pool[layer], page_table).to(q.dtype).float()
    T = k.shape[2]
    s = torch.einsum("bghd,bgtd->bght", _prescaled(q, sm_scale), k)
    valid = torch.arange(T, device=q.device)[None, :] <= lengths.long()[:, None]
    s = s.masked_fill(~valid[:, None, None, :], MASK_VALUE)
    p = torch.softmax(s, dim=-1) * (lengths >= 0).float()[:, None, None, None]
    return torch.einsum("bght,bgtd->bghd", p, v).to(q.dtype)


def flash_attention_chunk_paged_plain(q, k_pool, v_pool, layer: int, page_table, starts,
                                      sm_scale, row_map=None):
    """q (B, S, G, Hg, D); pools (L, NP, G, P, D); page_table (Bt, MP), read
    at rows ``row_map`` (B,) when given; starts (B,).  Query t of row b
    attends logical positions ≤ starts[b] + t.  Returns (B, S, G, Hg, D)."""
    if row_map is not None:
        page_table = page_table[row_map.long()]
    B, S = q.shape[:2]
    k = gather_pages(k_pool[layer], page_table).to(q.dtype).float()
    v = gather_pages(v_pool[layer], page_table).to(q.dtype).float()
    T = k.shape[2]
    s = torch.einsum("bsghd,bgtd->bghst", _prescaled(q, sm_scale), k)
    qpos = starts.long()[:, None] + torch.arange(S, device=q.device)[None, :]  # (B, S)
    mask = torch.arange(T, device=q.device)[None, None, :] <= qpos[:, :, None]
    s = s.masked_fill(~mask[:, None, None], MASK_VALUE)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bghst,bgtd->bsghd", p, v).to(q.dtype)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def _check_cuda(name, *tensors):
    dev = tensors[0].device
    for t in tensors:
        if not t.is_cuda or t.device != dev:
            raise ValueError(f"{name}: all tensors must be on one CUDA device")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")


def _check_types(name, acts, caches) -> int:
    """The form the kernels take the activations ``acts`` (one dtype) over
    the cache ``caches`` (K and V of one dtype) in: its code in
    ``FORM_CODES`` (bf16, f16 or f32 over a cache of their own dtype or of
    float8_e4m3fn).  Any other pair raises, naming the dtypes."""
    act, kv = {t.dtype for t in acts}, {t.dtype for t in caches}
    code = FORM_CODES.get((act.pop(), kv.pop())) if len(act) == len(kv) == 1 else None
    if code is None:
        raise TypeError(f"{name}: the CUDA kernel takes bf16, float16 or float32 activations "
                        f"over a cache of their dtype or of float8_e4m3fn (got activations "
                        f"{[t.dtype for t in acts]}, cache {[t.dtype for t in caches]})")
    return code


def _launched(wrapper, out, form: int):
    return _build.launched(wrapper, out, FORM_SUFFIX[form])


def _int32(t):
    return t.to(torch.int32).contiguous()


def flash_attention_prefill(q, k, v, lengths, sm_scale, q_starts=None, kv_row_map=None):
    """Causal prefill attention over the layer's (Bk, G, T, D) cache view;
    with ``q_starts`` the chunked form (see the module note).  Plain version
    on CPU tensors; the CUDA kernel on CUDA tensors."""
    if not _build.on_card(q):
        return flash_attention_prefill_plain(q, k, v, lengths, sm_scale, q_starts, kv_row_map)
    B, S, G, Hg, D = q.shape
    Bk, T = k.shape[0], k.shape[2]
    lengths = _int32(lengths)
    q_starts = None if q_starts is None else _int32(q_starts)
    kv_row_map = None if kv_row_map is None else _int32(kv_row_map)
    _check_cuda("flash_attention_prefill", q, k, v, lengths,
                *[t for t in (q_starts, kv_row_map) if t is not None])
    form = _check_types("flash_attention_prefill", [q], [k, v])
    if (D != HEAD_DIM or Hg > MAX_PREFILL_HG or k.shape != (Bk, G, T, D)
            or v.shape != k.shape or (q_starts is None and T < S)
            or (kv_row_map is None and Bk != B)):
        raise ValueError(f"flash_attention_prefill: unsupported shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}")
    starts_ptr = None if q_starts is None else q_starts.data_ptr()
    rmap_ptr = None if kv_row_map is None else kv_row_map.data_ptr()
    out = torch.empty_like(q)
    _build.call("chatglm_prefill_attention", q.data_ptr(), k.data_ptr(), v.data_ptr(),
                lengths.data_ptr(), starts_ptr, rmap_ptr, out.data_ptr(), B, S, G, Hg, T, D,
                float(sm_scale), form, _build.stream_ptr(q))
    counter = flash_attention_prefill if q_starts is None else flash_attention_prefill_chunk
    return _launched(counter, out, form)


flash_attention_prefill.launches = 0
_build.with_forms(flash_attention_prefill, *CACHE_FORM_SUFFIXES)


def flash_attention_prefill_chunk(q, k, v, lengths, q_starts, sm_scale, kv_row_map=None):
    """B5's chunked-prefill form: ``flash_attention_prefill`` with
    ``q_starts`` (and ``kv_row_map``).  Its launches count here, apart from
    the whole-prompt form's."""
    return flash_attention_prefill(q, k, v, lengths, sm_scale, q_starts, kv_row_map)


flash_attention_prefill_chunk.launches = 0
_build.with_forms(flash_attention_prefill_chunk, *CACHE_FORM_SUFFIXES)


def _tiles(n):
    return -(-n // DECODE_TILE) * DECODE_TILE


@functools.lru_cache(maxsize=None)
def decode_span(batch_groups: int, T: int, block_k: int) -> int:
    """Cache rows per decode block (B4, B12 and B10): ``block_k`` capped at
    T, rounded up to a whole number of DECODE_TILE-row tiles, then halved
    (and rounded up again) down to one tile while the grid of batch_groups ·
    ceil(T / span) blocks would leave SMs of the card idle."""
    span = _tiles(max(1, min(block_k, T)))
    while span > DECODE_TILE and batch_groups * -(-T // span) < DECODE_TARGET_BLOCKS:
        span = _tiles(span // 2)
    return span


def decode_paged_span(batch_groups: int, P: int, MP: int) -> int:
    """B10's span: B4's rule over the table's capacity MP·P."""
    return decode_span(batch_groups, MP * P, DECODE_BLOCK_K)


def chunk_units(B: int, G: int, S: int, Hg: int) -> int:
    """(b, g, query block) units of B11's grid: PREFILL_ROWS folded rows,
    PREFILL_ROWS // Hg positions, per block."""
    return B * G * -(-S // (PREFILL_ROWS // Hg))


@functools.lru_cache(maxsize=None)
def chunk_span(units: int, T: int) -> int:
    """K/V rows per B11 block: the capacity T in whole tiles, halved (and
    rounded up again) while the grid of units · ceil(T / span) blocks would
    leave SMs of the card idle, down to CHUNK_MIN_SPAN rows and to no more
    than CHUNK_MAX_SPANS spans.  A halving happens only below 132 blocks, so
    the partials stay under about 2 · 132 blocks' worth whatever S · Hg is."""
    floor = max(CHUNK_MIN_SPAN, _tiles(-(-T // CHUNK_MAX_SPANS)))
    span = _tiles(max(T, 1))
    while span > floor and units * -(-T // span) < DECODE_TARGET_BLOCKS:
        span = max(_tiles(span // 2), floor)
    return span


def chunk_partial_floats(units: int, T: int) -> int:
    """f32 partials of B11 at ``chunk_span``: (units, nspan, PREFILL_ROWS,
    D + 2), or 0 with one span."""
    nspan = -(-T // chunk_span(units, T))
    return 0 if nspan == 1 else units * nspan * PREFILL_ROWS * (HEAD_DIM + 2)


def _decode_part_ptr(q, T, span):
    """The decode partials' address, or None where no (b, g) can hold more
    than one span."""
    B, G, Hg, D = q.shape
    nspan = -(-T // span)
    if nspan == 1 or T <= DECODE_SOLO_ROWS:
        return None
    return _build.scratch("part", q.device, B * G * nspan * Hg * (D + 2),
                           torch.float32).data_ptr()


def _arrivals_ptr(device, n):
    return _build.scratch("arrivals", device, n, torch.int32).data_ptr()


def _lse_outputs(q, lse):
    """K1's / K2's (m, l) outputs, (B, G, Hg) f32 each, or None."""
    if not lse:
        return None
    return (torch.empty(q.shape[:3], dtype=torch.float32, device=q.device),
            torch.empty(q.shape[:3], dtype=torch.float32, device=q.device))


def _ml_ptrs(ml):
    return (None, None) if ml is None else (ml[0].data_ptr(), ml[1].data_ptr())


def _decode_launch(name, q, k, v, lengths, sm_scale, block_k, v2, lse=False, t_offset=0):
    B, G, Hg, D = q.shape
    T = k.shape[2]
    lengths = _int32(lengths)
    _check_cuda(name, q, k, v, lengths)
    form = _check_types(name, [q], [k, v])
    if (D != HEAD_DIM or Hg > MAX_DECODE_HG or k.shape != (B, G, T, D) or v.shape != k.shape
            or t_offset < 0):
        raise ValueError(f"{name}: unsupported shapes q {tuple(q.shape)}, k {tuple(k.shape)}")
    span = decode_span(B * G, T, block_k)
    out = torch.empty_like(q)
    ml = _lse_outputs(q, lse)
    _build.call("chatglm_decode_attention", q.data_ptr(), k.data_ptr(), v.data_ptr(),
                lengths.data_ptr(), _decode_part_ptr(q, T, span), _arrivals_ptr(q.device, B * G),
                out.data_ptr(), B, G, Hg, T, D, span, int(v2), float(sm_scale),
                *_ml_ptrs(ml), int(t_offset), form, _build.stream_ptr(q))
    return (out if ml is None else (out, *ml)), form


def flash_attention_decode(q, k, v, lengths, sm_scale):
    """Ragged single-token attention over the layer's (B, G, T, D) cache
    view.  Plain version on CPU tensors; the CUDA kernel on CUDA tensors."""
    if _build.exporting(q):
        return _build.export_op("flash_attention_decode")(q, k, v, lengths, sm_scale)
    if not _build.on_card(q):
        return flash_attention_decode_plain(q, k, v, lengths, sm_scale)
    out, form = _decode_launch("flash_attention_decode", q, k, v, lengths, sm_scale,
                              DECODE_BLOCK_K, False)
    return _launched(flash_attention_decode, out, form)


flash_attention_decode.launches = 0
_build.with_forms(flash_attention_decode, *CACHE_FORM_SUFFIXES)


def flash_attention_decode_v2(q, k, v, lengths, sm_scale, block_k: int = 512):
    """B12: ragged single-token attention over the layer's (B, G, T, D) cache
    view with B12's numerics (see the module note).  Plain version on CPU
    tensors; the CUDA kernel on CUDA tensors."""
    if not _build.on_card(q):
        return flash_attention_decode_v2_plain(q, k, v, lengths, sm_scale, block_k)
    out, form = _decode_launch("flash_attention_decode_v2", q, k, v, lengths, sm_scale, block_k,
                              True)
    return _launched(flash_attention_decode_v2, out, form)


flash_attention_decode_v2.launches = 0
_build.with_forms(flash_attention_decode_v2, *CACHE_FORM_SUFFIXES)


def flash_attention_decode_lse(q, k, v, lengths, sm_scale, t_offset: int = 0):
    """K1: B4 with ``return_lse`` over one T-shard of the dense cache (see
    ``flash_attention_decode_lse_plain``); returns (out, m, l).  Plain
    version on CPU tensors; the CUDA kernel on CUDA tensors."""
    if not _build.on_card(q):
        return flash_attention_decode_lse_plain(q, k, v, lengths, sm_scale, t_offset)
    res, form = _decode_launch("flash_attention_decode_lse", q, k, v, lengths, sm_scale,
                              DECODE_BLOCK_K, False, lse=True, t_offset=t_offset)
    return _launched(flash_attention_decode_lse, res, form)


flash_attention_decode_lse.launches = 0
_build.with_forms(flash_attention_decode_lse, *CACHE_FORM_SUFFIXES)


def _aligned(name, *tensors):
    """The append kernel moves 16-byte vectors."""
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"{name}: tensors must start on a 16-byte boundary")


def _layer_ptr(t, layer: int) -> int:
    """The address of ``t[layer]`` without making the view."""
    return t.data_ptr() + layer * t.stride(0) * t.element_size()


def _write_one(name, dst, new, layer: int, starts, page_table=None):
    """The append kernel's write-only form: ``new`` (B, G, D) into the slot
    of ``dst[layer]``, a cache (L, B, G, T, D) or, with ``page_table``, a
    pool (L, NP, G, P, D)."""
    L, _, G, T, D = dst.shape
    B = new.shape[0]
    # a bf16, f16 or f32 cache takes new in its dtype; an fp8 one takes new
    # as it is, bf16, f16 or f32, and the kernel casts on the write
    # (kv_store_cast's bytes)
    src = (new if dst.dtype == FP8 else new.to(dst.dtype)).contiguous()
    if src.data_ptr() % 16:
        src = src.clone()
    starts = _int32(starts)
    page_table = None if page_table is None else _int32(page_table)
    _check_cuda(name, dst, src, starts, *([] if page_table is None else [page_table]))
    form = _check_types(name, [src], [dst])
    if (src.shape != (B, G, D) or starts.shape != (B,) or D != HEAD_DIM
            or not 0 <= layer < L or (page_table is None and dst.shape[1] != B)
            or (page_table is not None and (page_table.dim() != 2
                                            or page_table.shape[0] != B))):
        raise ValueError(f"{name}: unsupported new {tuple(new.shape)}, dst {tuple(dst.shape)}, "
                         f"layer {layer}")
    _aligned(name, dst)
    MP = 0 if page_table is None else page_table.shape[1]
    _build.call("chatglm_kv_append", _layer_ptr(dst, layer), src.data_ptr(),
                None if page_table is None else page_table.data_ptr(), starts.data_ptr(),
                B, G, D, T, MP, form, _build.stream_ptr(dst))
    return form


def kv_cache_write_idx(cache, new, layer: int, starts):
    """Write ``new`` (B, G, D) into cache[layer, b, :, starts[b], :] in place
    and return ``cache``.  Plain version on CPU tensors; the append kernel's
    write-only form on CUDA tensors."""
    if not _build.on_card(cache):
        return kv_cache_write_idx_plain(cache, new, layer, starts)
    form = _write_one("kv_cache_write_idx", cache, new, layer, starts)
    return _launched(kv_cache_write_idx, cache, form)


kv_cache_write_idx.launches = 0
_build.with_forms(kv_cache_write_idx, *CACHE_FORM_SUFFIXES)


def _check_pool(name, pool, page_table, L_idx):
    L, NP, G, P, D = pool.shape
    if page_table.dim() != 2 or not 0 <= L_idx < L:
        raise ValueError(f"{name}: page_table {tuple(page_table.shape)}, layer {L_idx} of {L}")


def kv_pool_write_idx(pool, new, layer: int, page_table, starts):
    """Write ``new`` (B, G, D) at logical position min(starts[b], MP·P − 1)
    of each row's pages in ``pool`` (L, NP, G, P, D), in place; returns
    ``pool``.  Plain version on CPU tensors; the append kernel's write-only
    form on CUDA tensors."""
    if not _build.on_card(pool):
        return kv_pool_write_idx_plain(pool, new, layer, page_table, starts)
    form = _write_one("kv_pool_write_idx", pool, new, layer, starts, page_table)
    return _launched(kv_pool_write_idx, pool, form)


kv_pool_write_idx.launches = 0
_build.with_forms(kv_pool_write_idx, *CACHE_FORM_SUFFIXES)


def rope_kv_append(q, kv, freqs, k_cache, v_cache, layer: int, starts, page_table=None):
    """The decode step's RoPE and KV write in one launch (see
    ``rope_kv_append_plain`` for the arguments); ``kv`` may be a view with a
    row stride.  Plain version on CPU tensors; the CUDA kernel on CUDA
    tensors.  Returns the rotated q (B, G, Hg, D)."""
    if _build.exporting(q):
        return _build.export_op("rope_kv_append")(q, kv, freqs, k_cache, v_cache, layer, starts,
                                                   page_table)
    if not _build.on_card(q):
        return rope_kv_append_plain(q, kv, freqs, k_cache, v_cache, layer, starts, page_table)
    out, form = _append_launch("rope_kv_append", q, kv, freqs, k_cache, v_cache, layer, starts,
                              page_table, None)
    return _launched(rope_kv_append, out, form)


rope_kv_append.launches = 0
_build.with_forms(rope_kv_append, *CACHE_FORM_SUFFIXES)


def rope_kv_append_sharded(q, kv, freqs, k_cache, v_cache, layer: int, starts, shard: KVShard,
                           page_table=None):
    """K3: the decode step's RoPE and KV write on one shard of a sharded
    cache (see ``rope_kv_append_sharded_plain``).  q (B, Gq, Hq, D) may hold
    a rank's heads only.  Plain version on CPU tensors; the CUDA kernel on
    CUDA tensors.  Returns the rotated q."""
    if not _build.on_card(q):
        return rope_kv_append_sharded_plain(q, kv, freqs, k_cache, v_cache, layer, starts, shard,
                                            page_table)
    out, form = _append_launch("rope_kv_append_sharded", q, kv, freqs, k_cache, v_cache, layer,
                              starts, page_table, shard)
    return _launched(rope_kv_append_sharded, out, form)


rope_kv_append_sharded.launches = 0
_build.with_forms(rope_kv_append_sharded, *CACHE_FORM_SUFFIXES)


def _append_launch(name, q, kv, freqs, k_cache, v_cache, layer, starts, page_table, shard):
    B, Gq, Hq, D = q.shape
    q, freqs, starts = q.contiguous(), freqs.contiguous(), _int32(starts)
    if kv.dim() != 2 or kv.stride(1) != 1 or kv.stride(0) % 8:
        kv = kv.contiguous()
    paged = page_table is not None
    if paged:
        page_table = _int32(page_table)
    _check_cuda(name, q, freqs, k_cache, v_cache, starts, *([page_table] if paged else []))
    if not kv.is_cuda or kv.device != q.device:
        raise ValueError(f"{name}: all tensors must be on one CUDA device")
    form = _check_types(name, [q, kv, freqs], [k_cache, v_cache])
    L, rows, G, T, Dc = k_cache.shape
    shard = shard or KVShard()
    if (D != HEAD_DIM or Dc != D or v_cache.shape != k_cache.shape
            or (shard == KVShard() and Gq != G)
            or kv.shape != (B, 2 * G * D) or freqs.shape != (B, D) or starts.shape != (B,)
            or not 0 <= layer < L or (not paged and rows != B)
            or (paged and (page_table.dim() != 2 or page_table.shape[0] != B))
            or shard.offset < 0 or not 0 <= shard.phase < shard.stride or shard.total < 0):
        raise ValueError(f"{name}: unsupported shapes q {tuple(q.shape)}, kv {tuple(kv.shape)}, "
                         f"freqs {tuple(freqs.shape)}, cache {tuple(k_cache.shape)}, "
                         f"layer {layer}, {shard}")
    _aligned(name, q, kv, freqs, k_cache, v_cache)
    out = torch.empty_like(q)
    MP = page_table.shape[1] if paged else 0
    _build.call("chatglm_rope_kv_append", q.data_ptr(), out.data_ptr(), kv.data_ptr(),
                kv.stride(0), freqs.data_ptr(), _layer_ptr(k_cache, layer),
                _layer_ptr(v_cache, layer), page_table.data_ptr() if paged else None,
                starts.data_ptr(), B, G, Gq * Hq, D, T, MP, shard.offset, shard.stride,
                shard.phase, shard.total, form, _build.stream_ptr(q))
    return out, form


def flash_attention_decode_paged(q, k_pool, v_pool, layer: int, page_table, lengths, sm_scale):
    """Ragged single-token attention over the pool's pages (see the module
    note).  Plain version on CPU tensors; the CUDA kernel on CUDA tensors."""
    if not _build.on_card(q):
        return flash_attention_decode_paged_plain(q, k_pool, v_pool, layer, page_table,
                                                  lengths, sm_scale)
    out, form = _decode_paged_launch("flash_attention_decode_paged", q, k_pool, v_pool, layer,
                                    page_table, lengths, sm_scale)
    return _launched(flash_attention_decode_paged, out, form)


def _decode_paged_launch(name, q, k_pool, v_pool, layer, page_table, lengths, sm_scale,
                         stride=1, phase=0, lse=False):
    B, G, Hg, D = q.shape
    L, NP, Gp, P, Dp = k_pool.shape
    page_table, lengths = _int32(page_table), _int32(lengths)
    _check_cuda(name, q, k_pool, v_pool, page_table, lengths)
    form = _check_types(name, [q], [k_pool, v_pool])
    _check_pool(name, k_pool, page_table, layer)
    if (D != HEAD_DIM or Hg > MAX_DECODE_HG or (Gp, Dp) != (G, D)
            or v_pool.shape != k_pool.shape or page_table.shape[0] != B
            or not 0 <= phase < stride):
        raise ValueError(f"{name}: unsupported shapes q {tuple(q.shape)}, "
                         f"pool {tuple(k_pool.shape)}, page_table {tuple(page_table.shape)}, "
                         f"stride {stride}, phase {phase}")
    MP = page_table.shape[1]
    span = decode_paged_span(B * G, P, MP)
    out = torch.empty_like(q)
    ml = _lse_outputs(q, lse)
    _build.call("chatglm_decode_paged", q.data_ptr(), k_pool[layer].data_ptr(),
                v_pool[layer].data_ptr(), page_table.data_ptr(), lengths.data_ptr(),
                _decode_part_ptr(q, MP * P, span), _arrivals_ptr(q.device, B * G),
                out.data_ptr(), B, G, Hg, P, D, MP, span, float(sm_scale), *_ml_ptrs(ml),
                int(stride), int(phase), form, _build.stream_ptr(q))
    return (out if ml is None else (out, *ml)), form


flash_attention_decode_paged.launches = 0
_build.with_forms(flash_attention_decode_paged, *CACHE_FORM_SUFFIXES)


def flash_attention_decode_paged_lse(q, k_pool, v_pool, layer: int, page_table, lengths,
                                     sm_scale, stride: int = 1, phase: int = 0):
    """K2: B10 with ``stride``, ``phase`` and ``return_lse`` over a strided
    local page table (see ``flash_attention_decode_paged_lse_plain``);
    returns (out, m, l).  Plain version on CPU tensors; the CUDA kernel on
    CUDA tensors."""
    if not _build.on_card(q):
        return flash_attention_decode_paged_lse_plain(q, k_pool, v_pool, layer, page_table,
                                                      lengths, sm_scale, stride, phase)
    res, form = _decode_paged_launch("flash_attention_decode_paged_lse", q, k_pool, v_pool,
                                    layer, page_table, lengths, sm_scale, stride, phase, lse=True)
    return _launched(flash_attention_decode_paged_lse, res, form)


flash_attention_decode_paged_lse.launches = 0
_build.with_forms(flash_attention_decode_paged_lse, *CACHE_FORM_SUFFIXES)


def flash_attention_chunk_paged(q, k_pool, v_pool, layer: int, page_table, starts, sm_scale,
                                row_map=None):
    """Chunk attention over the pool's pages (see the module note); with
    ``row_map`` row b reads table row ``row_map[b]``.  Plain version on CPU
    tensors; the CUDA kernel on CUDA tensors."""
    if not _build.on_card(q):
        return flash_attention_chunk_paged_plain(q, k_pool, v_pool, layer, page_table, starts,
                                                 sm_scale, row_map)
    B, S, G, Hg, D = q.shape
    L, NP, Gp, P, Dp = k_pool.shape
    page_table, starts = _int32(page_table), _int32(starts)
    row_map = None if row_map is None else _int32(row_map)
    _check_cuda("flash_attention_chunk_paged", q, k_pool, v_pool, page_table, starts,
                *([] if row_map is None else [row_map]))
    form = _check_types("flash_attention_chunk_paged", [q], [k_pool, v_pool])
    _check_pool("flash_attention_chunk_paged", k_pool, page_table, layer)
    if (D != HEAD_DIM or Hg > MAX_PREFILL_HG or (Gp, Dp) != (G, D)
            or v_pool.shape != k_pool.shape or starts.shape != (B,)
            or (row_map is None and page_table.shape[0] != B)
            or (row_map is not None and row_map.shape != (B,))):
        raise ValueError(f"flash_attention_chunk_paged: unsupported shapes q {tuple(q.shape)}, "
                         f"pool {tuple(k_pool.shape)}, page_table {tuple(page_table.shape)}")
    MP = page_table.shape[1]
    units, T = chunk_units(B, G, S, Hg), MP * P
    span = chunk_span(units, T)
    n_part = chunk_partial_floats(units, T)
    part = _build.scratch("part", q.device, n_part, torch.float32).data_ptr() if n_part else None
    out = torch.empty_like(q)
    _build.call("chatglm_chunk_paged", q.data_ptr(), k_pool[layer].data_ptr(),
                v_pool[layer].data_ptr(), page_table.data_ptr(),
                None if row_map is None else row_map.data_ptr(), starts.data_ptr(), part,
                _arrivals_ptr(q.device, units), out.data_ptr(), B, S, G, Hg, P, D, MP, span,
                float(sm_scale), form, _build.stream_ptr(q))
    return _launched(flash_attention_chunk_paged, out, form)


flash_attention_chunk_paged.launches = 0
_build.with_forms(flash_attention_chunk_paged, *CACHE_FORM_SUFFIXES)


# ---------------------------------------------------------------------------
# Sharded wrappers: tensor-parallel serving over a parallel.sharding.Mesh
# ---------------------------------------------------------------------------
#
# The JAX package maps its kernels per device under shard_map inside one
# global program (pallas_attention.py:552-600, 1074-1272); here each rank of
# the mesh is a process that holds its shard and calls these on it.  Where
# the rank's heads attend only the KV it holds (the head-sharded cache and
# the data-sharded pool) no collective is needed; the T-sharded cache
# (``kv_shard_t``) and the model-sharded pool (``shard_model_pages``) give
# every rank all heads (q is all-gathered by the caller) over a part of each
# row, and the tp partials (out, m, l) merge exactly after one all-gather.


def sharded_page_table(page_table, mesh, pool_pages: int):
    """The data-sharded pool's local table: data rank d holds global pages
    d·pool_pages .. (d + 1)·pool_pages − 1 and its rows' tables point only
    there (the engine's allocator keeps them so); the clip keeps a stray id
    in bounds, as JAX's does."""
    base = mesh.data_index * pool_pages
    return (page_table.long() - base).clamp(0, pool_pages - 1).to(torch.int32)


def msharded_page_table(page_table, mesh, pool_pages: int):
    """The model-sharded pool's strided local table (B, ceil(MP / tp)):
    column i of model rank r holds logical block i·tp + r, whose page lies
    in that rank's sub-pool (global pages (d·tp + r)·pool_pages ..).  Tail
    columns past MP repeat the last one; the kernel's count of columns never
    reaches them (JAX :1176-1183)."""
    tp, r = mesh.n_model, mesh.model_index
    MP = page_table.shape[1]
    idx = (r + tp * torch.arange(-(-MP // tp), device=page_table.device)).clamp(max=MP - 1)
    base = (mesh.data_index * tp + r) * pool_pages
    return (page_table.long()[:, idx] - base).clamp(0, pool_pages - 1).to(torch.int32)


def _merge_over(mesh, out, m, l):
    """All-gather the rank's partial (one f32 tensor: out, m, l side by
    side) over the model axis and merge the tp of them."""
    packed = torch.cat([out.float(), m[..., None], l[..., None]], dim=-1)
    parts = mesh.all_gather(packed, "model")  # (tp, B, G, Hg, D + 2)
    D = out.shape[-1]
    return merge_lse_partials(parts[..., :D], parts[..., D], parts[..., D + 1], out.dtype)


def flash_attention_decode_kv_tsharded(q, k, v, lengths, sm_scale, mesh, kernels: bool = True):
    """Decode over the T-sharded cache: q (B, G, Hg, D) every head, k, v (B,
    G, T_local, D) the rank's T-shard, which holds global slots r·T_local ..;
    K1 over it, then the exact merge over the model axis.  Returns every
    head's output (B, G, Hg, D) on every rank."""
    offset = mesh.model_index * k.shape[2]
    fn = flash_attention_decode_lse if kernels else flash_attention_decode_lse_plain
    return _merge_over(mesh, *fn(q, k, v, lengths, sm_scale, offset))


def flash_attention_decode_paged_msharded(q, k_pool, v_pool, layer: int, local_table, lengths,
                                          sm_scale, mesh, kernels: bool = True):
    """Decode over the model-sharded pool: q (B, G, Hg, D) every head, the
    pool the rank's sub-pool, ``local_table`` from ``msharded_page_table``;
    K2 at stride tp and phase = the model rank, then the exact merge over
    the model axis.  Returns every head's output on every rank."""
    fn = flash_attention_decode_paged_lse if kernels else flash_attention_decode_paged_lse_plain
    return _merge_over(mesh, *fn(q, k_pool, v_pool, layer, local_table, lengths, sm_scale,
                                 mesh.n_model, mesh.model_index))

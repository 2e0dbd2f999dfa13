"""Paged KV cache: a shared pool of fixed-size pages and per-row page
tables — the counterpart of chatglm_q_tpu/models/paged_kv.py.

* pool (L, NP, G, P, D): NP pages of P token rows each, allocated to
  sequences on demand, so memory scales with the tokens in flight;
* page_table (B, MP) int32: logical block j of row b lives at physical page
  ``page_table[b, j]``; physical page 0 is a reserved garbage page (padding
  and inactive rows write there);
* lengths (B,) int32: the valid positions of each row.

As in the dense cache (models/chatglm2.py), the pools are updated in place
where the JAX code returns a new array; ``PagedKVCache.replace`` swaps the
small tensors (page table, lengths) and shares the pools.

Decode rotates q and k and writes one row per sequence in one launch of the
append kernel, then reads pages with the paged ragged-decode kernel
(ops/attention.py).  Prefill attends the freshly computed K/V and never the
pool; chunked prefill attends the pool, through the chunk kernel for chunks
of S·Hg ≤ 512 rows and through a gathered dense view and the chunked flash
prefill for larger ones.

Under a mesh each rank holds its part of the pool and reads it through a
local table (``mesh_table``): its data group's pages, and with
``rt.paged_shard_model`` only the logical blocks of its phase (K3 writes,
K2 reads, chunks attend the all-gathered pages).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import NamedTuple, Optional

import torch

from ..config import ChatGLM2Config, TorchRuntimeConfig, resolve_device
from ..ops import attention as A
from ..ops.linear import quant_embedding_lookup
from ..ops.sampling import GREEDY, Sampling
from ..parallel import sharding as SH
from ..utils import graphs as G
from . import chatglm2 as M

_DEFAULT_RT = TorchRuntimeConfig()
CHUNK_KERNEL_MAX_ROWS = 512  # S·Hg of the largest chunk the chunk kernel attends


@dataclass
class PagedKVCache:
    k_pool: torch.Tensor      # (L, NP, G, P, D)
    v_pool: torch.Tensor      # (L, NP, G, P, D)
    page_table: torch.Tensor  # (B, MP) int32
    lengths: torch.Tensor     # (B,) int32

    @property
    def page_size(self) -> int:
        return self.k_pool.shape[3]

    @property
    def max_length(self) -> int:
        return self.page_table.shape[1] * self.page_size

    def replace(self, **changes) -> "PagedKVCache":
        return dataclasses.replace(self, **changes)


class PagedWrite(NamedTuple):
    """``block_forward``'s kv_write payload for the paged path.  Under a mesh
    the pools are the rank's part and ``page_table`` its local table
    (``mesh_table``); ``shard`` is set on a model-sharded pool."""
    k_pool: torch.Tensor
    v_pool: torch.Tensor
    layer: int
    page_table: torch.Tensor
    start: torch.Tensor      # (B,) first position written per row (prefill: zeros)
    aligned: bool = True     # False: S > 1 tokens at arbitrary (unaligned) starts
    shard: Optional[A.KVShard] = None


def init_paged_kv_cache(config: ChatGLM2Config, batch_size: int, num_pages: int,
                        max_length: Optional[int] = None, page_size: int = 256,
                        dtype=torch.bfloat16, device=None) -> PagedKVCache:
    """A zeroed pool with every table entry on the garbage page.
    ``device=None`` means CUDA (and raises without it)."""
    device = resolve_device(device)
    S = max_length or config.max_sequence_length
    mp = -(-S // page_size)
    shape = (config.num_layers, num_pages, config.num_multi_query_groups, page_size,
             config.head_hidden_size)
    return PagedKVCache(
        k_pool=A.kv_zeros(shape, dtype, device),
        v_pool=A.kv_zeros(shape, dtype, device),
        page_table=torch.zeros((batch_size, mp), dtype=torch.int32, device=device),
        lengths=torch.zeros((batch_size,), dtype=torch.int32, device=device),
    )


def write_pages(pool: torch.Tensor, new: torch.Tensor, layer: int, page_table: torch.Tensor,
                start: torch.Tensor, aligned: bool = True) -> torch.Tensor:
    """Write ``new`` (B, G, S, D) at positions start[b]..start[b]+S-1 of the
    pool (L, NP, G, P, D), in place; returns ``pool``.

    S == 1 and ``aligned=False`` (speculative verification) clamp each
    position to the table's capacity − 1: in-chunk over-generation past the
    last slot overwrites that slot (the host rolls those tokens back) and
    never wraps into a page's earlier, valid rows.  ``aligned`` S > 1 writes
    (prefill; starts page-aligned) clamp the logical block instead, as the
    JAX package's page-by-page write does.  ``new`` is stored through
    ``kv_store_cast``.  Plain PyTorch indexing: JAX leaves this write to
    XLA."""
    B, G, S, D = new.shape
    P, MP = pool.shape[3], page_table.shape[1]
    dev = pool.device
    pos = start.to(dev).long()[:, None] + torch.arange(S, device=dev)[None, :]  # (B, S)
    if S == 1 or not aligned:
        pos = pos.clamp(max=MP * P - 1)
        blk = pos // P
    else:
        blk = (pos // P).clamp(max=MP - 1)
    page = page_table.to(dev).long().gather(1, blk)
    A.kv_put(pool[layer], (page, slice(None), pos % P), new.transpose(1, 2))
    return pool


def gather_layer(pool: torch.Tensor, layer: int, page_table: torch.Tensor) -> torch.Tensor:
    """One layer of the pool as a dense (B, G, MP·P, D) copy (the masked
    path and large prefill chunks)."""
    return A.gather_pages(pool[layer], page_table)


def paged_attention(q, kw, vw, attn, kv_write: PagedWrite, kernels: bool, sm_scale: float):
    """``block_forward``'s paged branch: write this block's K/V (B, G, S, D)
    into the pool, then attend (a prefill, a chunk, or the masked path)."""
    kp, vp, layer, pt = kv_write.k_pool, kv_write.v_pool, kv_write.layer, kv_write.page_table
    S, Hg = q.shape[1], q.shape[3]
    if kv_write.start is None:  # written already (under a mesh)
        pass
    elif S == 1:
        write = A.kv_pool_write_idx if kernels else A.kv_pool_write_idx_plain
        write(kp, kw[:, :, 0], layer, pt, kv_write.start)
        write(vp, vw[:, :, 0], layer, pt, kv_write.start)
    else:
        write_pages(kp, kw, layer, pt, kv_write.start, kv_write.aligned)
        write_pages(vp, vw, layer, pt, kv_write.start, kv_write.aligned)

    if not isinstance(attn, tuple):
        # masked path: a dense view of the pool, masked over its full length
        kc = gather_layer(kp, layer, pt).to(q.dtype)
        vc = gather_layer(vp, layer, pt).to(q.dtype)
        return M._attention_scores(q, kc, vc, attn, kv_layout="bgtd")
    kind, lengths = attn
    if kind == "flash_prefill":  # causality never reaches the pool
        fn = A.flash_attention_prefill if kernels else A.flash_attention_prefill_plain
        return fn(q, kw.contiguous(), vw.contiguous(), lengths, sm_scale)
    lengths, starts, row_map = lengths  # "flash_prefill_chunk"
    if S * Hg <= CHUNK_KERNEL_MAX_ROWS:
        fn = A.flash_attention_chunk_paged if kernels else A.flash_attention_chunk_paged_plain
        return fn(q, kp, vp, layer, pt, starts, sm_scale, row_map)
    # the gathered pages as stored: the chunked prefill upcasts what it reads
    kc, vc = gather_layer(kp, layer, pt), gather_layer(vp, layer, pt)
    fn = A.flash_attention_prefill if kernels else A.flash_attention_prefill_plain
    return fn(q, kc, vc, lengths, sm_scale, q_starts=starts, kv_row_map=row_map)


def paged_decode(q, kv, freqs, lengths, kv_write: PagedWrite, kernels: bool, sm_scale: float):
    """The flash decode step over the pool: q (B, G, Hg, D) and kv (B, 2·G·D)
    of one token a row, its RoPE row freqs (B, D).  Rotates q and k and
    writes k and v at position ``start`` in one op (B9 with the RoPE), then
    attends positions 0..lengths through B10."""
    kp, vp, layer, pt = kv_write.k_pool, kv_write.v_pool, kv_write.layer, kv_write.page_table
    append = A.rope_kv_append if kernels else A.rope_kv_append_plain
    q = append(q, kv, freqs, kp, vp, layer, kv_write.start, pt)
    fn = A.flash_attention_decode_paged if kernels else A.flash_attention_decode_paged_plain
    return fn(q, kp, vp, layer, pt, lengths, sm_scale)


def mesh_table(cache: PagedKVCache, rt: TorchRuntimeConfig):
    """The rank's local page table of the global one (computed once a step)
    and the shard of a model-sharded pool: the strided table at stride tp,
    phase = the model rank (``rt.paged_shard_model``), else the data-sharded
    pool's translated ids.  (table, None) without a mesh."""
    if rt.mesh is None:
        return cache.page_table, None
    pages = cache.k_pool.shape[1]
    if rt.paged_shard_model:
        shard = A.KVShard(stride=rt.mesh.n_model, phase=rt.mesh.model_index,
                          total=cache.max_length)
        return A.msharded_page_table(cache.page_table, rt.mesh, pages), shard
    return A.sharded_page_table(cache.page_table, rt.mesh, pages), None


def _layers_paged(params, config, quant_type, rt, h, freqs_cis, attn, cache: PagedKVCache,
                  start, aligned=True):
    table, shard = mesh_table(cache, rt)
    for l in range(config.num_layers):
        h = M.block_forward(M._layer(params["layers"], l), h, freqs_cis, attn, config,
                            quant_type, rt,
                            PagedWrite(cache.k_pool, cache.v_pool, l, table, start, aligned,
                                       shard))
    return h


def _logits(params, config, quant_type, rt, h):
    h = M.rms_norm(h, params["final_ln"]["weight"], config.layernorm_epsilon)
    return M.lm_head_logits(h, params, config, quant_type, rt)


# ---------------------------------------------------------------------------
# Under a mesh (tensor-parallel serving)
# ---------------------------------------------------------------------------

def write_pages_sharded(pool, new, layer: int, table, start, shard: A.KVShard,
                        aligned: bool = True):
    """``write_pages`` on a model-sharded pool: the positions clamp as on one
    device (over the global table of ``shard.total // P`` blocks), and only
    the logical blocks of this rank's phase are written, at their column of
    the strided local ``table`` (``chatglm2.masked_put``: the others' bits
    stay as they were; where the clamps or a shared garbage page fold
    several positions onto one slot, the last of them writes it)."""
    B, G, S, D = new.shape
    P = pool.shape[3]
    dev = pool.device
    pos = start.to(dev).long()[:, None] + torch.arange(S, device=dev)[None, :]
    if S == 1 or not aligned:
        pos = pos.clamp(max=shard.total - 1)
        blk = pos // P
    else:
        blk = (pos // P).clamp(max=shard.total // P - 1)
    col = blk // shard.stride
    owned = (blk % shard.stride == shard.phase) & (col < table.shape[1])
    page = table.to(dev).long().gather(1, col.clamp(max=table.shape[1] - 1))
    M.masked_put(pool[layer].transpose(1, 2), (page, pos % P), new.transpose(1, 2), owned)
    return pool


def gather_msharded(mesh, pool, layer: int, table, max_length: int):
    """A model-sharded pool layer as a dense (B, G, MP·P, D) view on every
    rank: each rank's strided columns, all-gathered over the model axis and
    put back in logical-block order (JAX's ``gather_layer`` under GSPMD,
    chatglm2.py:409-420)."""
    own = A.gather_pages(pool[layer], table)  # (B, G, MPl·P, D)
    B, G, _, D = own.shape
    P, MPl = pool.shape[3], table.shape[1]
    parts = A.kv_bytes(mesh.all_gather(own, "model")).reshape(mesh.n_model, B, G, MPl, P, D)
    dense = parts.permute(1, 2, 3, 0, 4, 5).reshape(B, G, -1, D).view(own.dtype)
    return dense[:, :, :max_length]


def mesh_paged_attention(q, kv, freqs_cis, attn, kv_write: PagedWrite, config, rt, kernels,
                         sm_scale):
    """``block_forward``'s paged attention on one rank (see
    ``chatglm2._mesh_attention``): the model-sharded pool (K3 and K2 at the
    rank's phase, chunks over the all-gathered pages) or the data-sharded
    one (the rank's groups' pages, the unsharded kernels)."""
    mesh = rt.mesh
    B, S = q.shape[:2]
    G, D = config.num_multi_query_groups, config.head_hidden_size
    g0, Gl, Hgl = SH.head_split(config, mesh.n_model, mesh.model_index)
    own = slice(g0, g0 + Gl)
    kp, vp, layer, table = kv_write.k_pool, kv_write.v_pool, kv_write.layer, kv_write.page_table
    shard = kv_write.shard
    kind, lengths = attn
    if kind == "flash_decode":
        qd, kvd, fd = q.reshape(B, Gl, Hgl, D), kv[:, 0], freqs_cis[:, 0]
        if shard is not None:
            append = A.rope_kv_append_sharded if kernels else A.rope_kv_append_sharded_plain
            qd = append(qd, kvd, fd, kp, vp, layer, kv_write.start, shard, table)
            ctx = A.flash_attention_decode_paged_msharded(
                M.gather_heads(mesh, qd).reshape(B, G, -1, D), kp, vp, layer, table, lengths,
                sm_scale, mesh, kernels)
            return M.own_heads(mesh, ctx)
        append = A.rope_kv_append if kernels else A.rope_kv_append_plain
        qd = append(qd, M.local_kv_row(kvd, g0, Gl, G, D), fd, kp, vp, layer, kv_write.start,
                    table)
        decode = A.flash_attention_decode_paged if kernels else A.flash_attention_decode_paged_plain
        return decode(qd, kp, vp, layer, table, lengths, sm_scale)

    k, v = kv.split(config.kv_size, dim=-1)
    f = freqs_cis[:, :, None, None, :]
    q = A.apply_rotary_emb(q.reshape(B, S, Gl, Hgl, D), f)
    k = A.apply_rotary_emb(k.reshape(B, S, G, 1, D), f).reshape(B, S, G, D)
    kw, vw = k.transpose(1, 2), v.reshape(B, S, G, D).transpose(1, 2)  # (B, G, S, D)
    if shard is not None:
        write_pages_sharded(kp, kw, layer, table, kv_write.start, shard, kv_write.aligned)
        write_pages_sharded(vp, vw, layer, table, kv_write.start, shard, kv_write.aligned)
    else:
        write_pages(kp, kw[:, own], layer, table, kv_write.start, kv_write.aligned)
        write_pages(vp, vw[:, own], layer, table, kv_write.start, kv_write.aligned)
    prefill = A.flash_attention_prefill if kernels else A.flash_attention_prefill_plain
    if kind == "flash_prefill":  # causality never reaches the pool
        return prefill(q, kw[:, own].contiguous(), vw[:, own].contiguous(), lengths, sm_scale)
    lengths, starts, row_map = lengths  # "flash_prefill_chunk"
    if shard is None:
        return paged_attention(q, None, None, ("flash_prefill_chunk", (lengths, starts, row_map)),
                               kv_write._replace(start=None), kernels, sm_scale)
    kc = A.kv_contiguous(gather_msharded(mesh, kp, layer, table, shard.total)[:, own])
    vc = A.kv_contiguous(gather_msharded(mesh, vp, layer, table, shard.total)[:, own])
    return prefill(q, kc, vc, lengths, sm_scale, q_starts=starts, kv_row_map=row_map)


def prefill_paged(params: dict, config: ChatGLM2Config, input_ids: torch.Tensor,
                  lengths: torch.Tensor, cache: PagedKVCache, quant_type: str = "none",
                  dtype=torch.bfloat16, rt: TorchRuntimeConfig = _DEFAULT_RT):
    """Prefill right-padded rows (B, S) of true ``lengths`` from position 0
    into their pages (which must cover S positions); returns last-token
    logits (B, V) and the cache.  Attention runs on the fresh K/V."""
    B, S = input_ids.shape
    dev = input_ids.device
    lengths = lengths.to(device=dev, dtype=torch.int32)
    positions = torch.arange(1, S + 1, device=dev)[None, :].expand(B, S)
    freqs_cis = M._serving_freqs(config, positions, dtype)
    h = quant_embedding_lookup(params["word_embedding"], input_ids, quant_type, dtype)
    if rt.flash_enabled(dev):
        attn = ("flash_prefill", lengths)
    else:
        # the masked path attends a gathered view over the pool's full length
        tq = torch.arange(S, device=dev)[:, None]
        tk = torch.arange(cache.max_length, device=dev)[None, :]
        attn = torch.where(tk <= tq, 0.0, M.MASK_VALUE).float()[None, None, None]
    start = torch.zeros((B,), dtype=torch.int32, device=dev)
    h = _layers_paged(params, config, quant_type, rt, h, freqs_cis, attn, cache, start)
    last = h[torch.arange(B, device=dev), (lengths - 1).long()]
    return _logits(params, config, quant_type, rt, last), cache.replace(lengths=lengths)


def prefill_chunk_paged(params: dict, config: ChatGLM2Config, input_ids: torch.Tensor,
                        starts: torch.Tensor, chunk_valid: torch.Tensor, cache: PagedKVCache,
                        quant_type: str = "none", dtype=torch.bfloat16,
                        rt: TorchRuntimeConfig = _DEFAULT_RT, return_all_logits: bool = False,
                        page_aligned: bool = True):
    """Chunked prefill over the pool (see ``chatglm2.prefill_chunk``): chunk
    rows (B, Sc) at ``starts`` (page-aligned unless ``page_aligned=False``)
    attend everything below them.  Lengths become ``starts + chunk_valid``,
    clamped to the table's capacity − 1 as the JAX package clamps them."""
    B, Sc = input_ids.shape
    dev = input_ids.device
    starts = starts.to(device=dev, dtype=torch.int32)
    chunk_valid = chunk_valid.to(device=dev, dtype=torch.int32)
    positions = starts.long()[:, None] + torch.arange(1, Sc + 1, device=dev)[None, :]
    freqs_cis = M._serving_freqs(config, positions, dtype)
    h = quant_embedding_lookup(params["word_embedding"], input_ids, quant_type, dtype)
    new_lengths = (starts + chunk_valid).clamp(max=cache.max_length - 1).to(torch.int32)
    if rt.flash_enabled(dev):
        attn = ("flash_prefill_chunk", (new_lengths, starts, None))
    else:
        tq = torch.arange(Sc, device=dev)[None, :, None]
        tk = torch.arange(cache.max_length, device=dev)[None, None, :]
        causal = tk <= starts.long()[:, None, None] + tq
        attn = torch.where(causal, 0.0, M.MASK_VALUE).float()[:, None, None]
    h = _layers_paged(params, config, quant_type, rt, h, freqs_cis, attn, cache, starts,
                      page_aligned)
    if not return_all_logits:
        h = h[torch.arange(B, device=dev), (chunk_valid - 1).long()]
    return _logits(params, config, quant_type, rt, h), cache.replace(lengths=new_lengths)


def prefill_paged_program(params: dict, config: ChatGLM2Config, cache: PagedKVCache,
                          rows: int, bucket: int, quant_type: str, dtype,
                          rt: TorchRuntimeConfig):
    """``prefill_paged`` of ``rows`` right-padded rows at one ``bucket``
    width as a step program over ``cache``'s pools (JAX's jitted
    ``_prefill_into_slot`` of that bucket): static "ids" (rows, bucket)
    int64, "lengths" (rows,) int32 and "page_table" (rows, MP) int32, output
    "logits" (rows, V).  Call its step with ``(params, cache.k_pool,
    cache.v_pool)``."""
    MP = cache.page_table.shape[1]
    dev = cache.k_pool.device
    key = ("prefill_paged", G.tensor_key(cache.k_pool), G.tensor_key(cache.v_pool), rows,
           bucket, MP, G.static_key(config, quant_type, dtype, rt))

    def inputs():
        return {"ids": torch.zeros((rows, bucket), dtype=torch.long, device=dev),
                "lengths": torch.ones((rows,), dtype=torch.int32, device=dev),
                "page_table": torch.zeros((rows, MP), dtype=torch.int32, device=dev)}

    def body(inp, params, k_pool, v_pool):
        logits, _ = prefill_paged(params, config, inp["ids"], inp["lengths"],
                                  PagedKVCache(k_pool, v_pool, inp["page_table"], inp["lengths"]),
                                  quant_type, dtype, rt)
        return {"logits": logits}

    return G.programs(params, "prefill").get(key, "prefill_paged", inputs, body, dev, rt,
                                                 refused=G.mesh_prefill_refusal(rt))


def chunk_paged_program(params: dict, config: ChatGLM2Config, cache: PagedKVCache, rows: int,
                        width: int, quant_type: str, dtype, rt: TorchRuntimeConfig):
    """``prefill_chunk_paged`` of ``rows`` compact rows of ``width`` tokens
    (JAX's jitted ``_prefill_chunk_compact``) as a step program over
    ``cache``'s pools: static "ids" (rows, width) int64, "starts", "valid"
    (rows,) int32 and "page_table" (rows, MP) int32; outputs "logits" (rows,
    V) and the rows' new "lengths".  A padding row sits on a garbage table
    row at valid 0: it writes only garbage pages.  Call its step with
    ``(params, cache.k_pool, cache.v_pool)``."""
    MP = cache.page_table.shape[1]
    dev = cache.k_pool.device
    key = ("prefill_chunk_paged", G.tensor_key(cache.k_pool), G.tensor_key(cache.v_pool), rows,
           width, MP, G.static_key(config, quant_type, dtype, rt))

    def inputs():
        return {"ids": torch.zeros((rows, width), dtype=torch.long, device=dev),
                "starts": torch.zeros((rows,), dtype=torch.int32, device=dev),
                "valid": torch.zeros((rows,), dtype=torch.int32, device=dev),
                "page_table": torch.zeros((rows, MP), dtype=torch.int32, device=dev)}

    def body(inp, params, k_pool, v_pool):
        logits, c = prefill_chunk_paged(
            params, config, inp["ids"], inp["starts"], inp["valid"],
            PagedKVCache(k_pool, v_pool, inp["page_table"], inp["starts"]), quant_type, dtype, rt)
        return {"logits": logits, "lengths": c.lengths}

    return G.programs(params, "prefill").get(key, "prefill_chunk_paged", inputs, body, dev, rt,
                                                 refused=G.mesh_prefill_refusal(rt))


def decode_step_paged(params: dict, config: ChatGLM2Config, next_ids: torch.Tensor,
                      cache: PagedKVCache, quant_type: str = "none", dtype=torch.bfloat16,
                      rt: TorchRuntimeConfig = _DEFAULT_RT):
    """One token per row: write position ``lengths`` (inside the mapped
    page), attend positions ≤ ``lengths``; return logits (B, V) and the
    cache with ``min(lengths + 1, max_length − 1)``: in-chunk steps past the
    capacity keep overwriting the last slot, and the host rolls their
    tokens back."""
    dev = next_ids.device
    lengths = cache.lengths
    freqs_cis = M._serving_freqs(config, (lengths + 1)[:, None].long(), dtype)
    h = quant_embedding_lookup(params["word_embedding"], next_ids[:, None], quant_type, dtype)
    if rt.flash_enabled(dev):
        attn = ("flash_decode", lengths)
    else:
        valid = torch.arange(cache.max_length, device=dev)[None, :] <= lengths[:, None]
        attn = torch.where(valid, 0.0, M.MASK_VALUE).float()[:, None, None, None, :]
    h = _layers_paged(params, config, quant_type, rt, h, freqs_cis, attn, cache, lengths)
    logits = _logits(params, config, quant_type, rt, h[:, 0])
    new_lengths = (lengths + 1).clamp(max=cache.max_length - 1).to(torch.int32)
    return logits, cache.replace(lengths=new_lengths)


def decode_paged_program(params: dict, config: ChatGLM2Config, cache: PagedKVCache,
                         quant_type: str, dtype, rt: TorchRuntimeConfig,
                         sampling: Sampling = GREEDY):
    """``decode_step_paged`` with its sampler as a step program
    (utils/graphs.py) over ``cache``'s pools, at ``cache``'s batch and table
    width: static "ids", "lengths" (B,) int32, "page_table" (B, MP) int32
    (and a "rows" sampler's buffers); each step writes the sampled token
    into "ids" and the advanced lengths into "lengths".  Call its steps with
    ``(params, cache.k_pool, cache.v_pool)``."""
    B, MP = cache.page_table.shape
    dev = cache.k_pool.device
    key = ("decode_step_paged", G.tensor_key(cache.k_pool), G.tensor_key(cache.v_pool), B, MP,
           G.static_key(config, quant_type, dtype, rt), sampling.key)

    def inputs():
        return {"ids": torch.zeros((B,), dtype=torch.int32, device=dev),
                "lengths": torch.zeros((B,), dtype=torch.int32, device=dev),
                "page_table": torch.zeros((B, MP), dtype=torch.int32, device=dev),
                **sampling.row_buffers(B, dev)}

    def body(inp, params, k_pool, v_pool):
        logits, c = decode_step_paged(
            params, config, inp["ids"], PagedKVCache(k_pool, v_pool, inp["page_table"],
                                                     inp["lengths"]), quant_type, dtype, rt)
        inp["ids"].copy_(sampling(logits, inp))
        inp["lengths"].copy_(c.lengths)
        return {}

    return G.programs(params).get(key, "decode_step_paged", inputs, body, dev, rt,
                                  sampling.generator)

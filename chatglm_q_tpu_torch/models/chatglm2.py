"""ChatGLM2 in PyTorch: the parity forward (training and evaluation), and
prefill and decode over a preallocated KV cache (serving).

The counterpart of chatglm_q_tpu/models/chatglm2.py.  Parameters are the
JAX package's tree as a plain dict of tensors (same keys, per-layer leaves
stacked on a leading L axis); the JAX ``lax.scan`` over layers is a Python
loop here, and layer ``l`` uses the views ``stack[l]``.

Conventions carried exactly:
* RoPE rotates the first half of the head dim as interleaved [c, s] pairs;
  the table has ``max_sequence_length + 1`` rows and is cast to the
  activation dtype before use; positions are 1-based (prefill 1..S, decode
  lengths + 1).
* Prefill rows are right-padded: padded slots are written to the cache and
  masked by ``lengths``; logits come from position ``lengths - 1``.
* Decode writes slot ``lengths[b]``, attends slots 0..lengths[b], and the
  new length is ``lengths + 1``.  A write at or past the cache's last slot
  lands on that slot, as JAX's ``dynamic_update_slice`` clamps it (the
  engines decode past the wall by design and roll the tokens back).
* ``prefill_chunk`` writes a chunk at per-row offsets and attends the whole
  cache below each query, optionally through a compact ``slot_map``.
* The FFN is ``silu(w_in_h(h)) * w_in_gate(h)``.

Unlike the JAX package (pure functions), the cache tensors are updated in
place: a step writes a few slots, never a whole new cache.  Where JAX jits
its decode loop (``multi_step_decode``'s ``lax.scan``), the port captures one
decode step with its sampler in a CUDA graph and replays it
(``decode_program``, utils/graphs.py), and likewise its prefill, one
program a power-of-two bucket (``prefill_program``), and a compact prefill
chunk (``chunk_program``).  The paged pool
(models/paged_kv.py) goes through the same ``block_forward``.

Under ``rt.mesh`` (tensor-parallel serving) ``block_forward`` runs each
linear per shard (parallel/tp_linear.py) and its attention on the rank's
part of the cache (``_mesh_attention``; the paged pool's in
``paged_kv.mesh_paged_attention``): q_proj gives the rank its heads,
kv_proj every group; a T-sharded cache (``kv_shard_t``) prefills through
ring attention and decodes all heads over the rank's slots (q
all-gathered, K1, the merge); the head-sharded one attends the rank's
heads against its groups; the vocab-split logits are all-gathered before
sampling.  The parity forward takes the same mesh (JAX's ``forward`` under
GSPMD): each rank its data rows, its heads against every group's K/V, and
the collectives differentiable (parallel/autograd_ops.py) so that a
training step's gradients come out whole (utils/train.py).

Parity mode (``forward``, JAX :530-672) keeps the reference's semantics: an
additive −1e10 mask (causal ∨ padding) with cumsum positions, keys
(B, T, G, D) of this call and of ``past_key_values``, train-mode dropout
from an explicit ``torch.Generator``, and the shifted −100 cross-entropy.
Its quantized linears differentiate through ``ops/linear.QuantMatmul``
(B13/B14 in the backward); ``rt.remat_layers`` recomputes each layer in the
backward pass.
"""
from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..config import ChatGLM2Config, TorchRuntimeConfig, resolve_device
from ..ops import attention as A
from ..ops import quant as Q
from ..ops.linear import quant_embedding_lookup, quant_linear
from ..ops.sampling import GREEDY, Sampling, fill_rows, top_p_rows
from ..parallel import autograd_ops as AO
from ..parallel import ring_attention as RA
from ..parallel import sharding as SH
from ..parallel.tp_linear import tp_quant_linear
from ..utils import graphs as G

MASK_VALUE = -1e10  # additive mask of the masked-softmax path (reference model.py:314)

_DEFAULT_RT = TorchRuntimeConfig()


# ---------------------------------------------------------------------------
# RoPE (applied by ops/attention.py's apply_rotary_emb), norm
# ---------------------------------------------------------------------------

def precompute_freqs_cis(dim: int, length: int, theta: float = 10000.0) -> np.ndarray:
    """Rotary table (length, dim): per position [c0, s0, c1, s1, ..., 1, 0,
    1, 0, ...] — the second half of the head dim is an identity bypass."""
    assert dim % 4 == 0
    half = dim // 2
    freqs = 1.0 / (theta ** (np.arange(0, half, 2, dtype=np.float32) / half))
    angles = np.outer(np.arange(length, dtype=np.float32), freqs)
    rot = np.stack([np.cos(angles), np.sin(angles)], axis=-1)
    byp = np.stack([np.ones_like(angles), np.zeros_like(angles)], axis=-1)
    table = np.concatenate([rot, byp], axis=-2)
    return table.reshape(length, dim)


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """f32 rsqrt-mean-square, cast back to x's dtype, times the weight."""
    xf = x.float()
    norm = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return norm.to(x.dtype) * weight.to(x.dtype)


@functools.lru_cache(maxsize=16)
def _freqs_table(dim: int, length: int, device: str, dtype: torch.dtype) -> torch.Tensor:
    return torch.from_numpy(precompute_freqs_cis(dim, length)).to(device=device, dtype=dtype)


def _serving_freqs(config: ChatGLM2Config, positions: torch.Tensor, dtype) -> torch.Tensor:
    # +1 row: positions are 1-based, so a full-context sequence's last token
    # indexes row max_sequence_length.  Positions past the table (decode past
    # the wall, whose tokens the engines roll back) clamp, as JAX's gather does
    n = config.max_sequence_length + 1
    table = _freqs_table(config.head_hidden_size, n, str(positions.device), dtype)
    return table[positions.long().clamp(0, n - 1)]


# ---------------------------------------------------------------------------
# KV cache
# ---------------------------------------------------------------------------

@dataclass
class KVCache:
    """k, v (L, B, G, S_max, D); lengths (B,) int32 — valid slots per row."""
    k: torch.Tensor
    v: torch.Tensor
    lengths: torch.Tensor

    @property
    def max_length(self) -> int:
        return self.k.shape[3]


def init_kv_cache(config: ChatGLM2Config, batch_size: int,
                  max_length: Optional[int] = None, dtype=torch.bfloat16,
                  device=None) -> KVCache:
    """A zeroed cache.  ``device=None`` means CUDA (and raises without it).
    ``dtype`` may be ``torch.float8_e4m3fn``: K/V are cast on the write
    (``ops.attention.kv_store_cast``) and upcast exactly where they are
    read, half the bytes of bf16."""
    device = resolve_device(device)
    shape = (config.num_layers, batch_size, config.num_multi_query_groups,
             max_length or config.max_sequence_length, config.head_hidden_size)
    return KVCache(
        k=A.kv_zeros(shape, dtype, device),
        v=A.kv_zeros(shape, dtype, device),
        lengths=torch.zeros((batch_size,), dtype=torch.int32, device=device),
    )


# ---------------------------------------------------------------------------
# Attention + block
# ---------------------------------------------------------------------------

def _dropout(x: torch.Tensor, rate: float, generator: torch.Generator, full_shape=None,
             part=None) -> torch.Tensor:
    """Inverted dropout (train mode only; the reference's nn.Dropout): keep
    each element with probability 1 − rate, scaled by 1 / (1 − rate).
    Under a mesh x is a rank's part of the activation: the mask is drawn
    over the whole (``full_shape``) and ``part`` cuts the rank's part from
    it, so every rank draws alike and the masks are the single process's."""
    keep = torch.rand(x.shape if full_shape is None else full_shape, generator=generator,
                      device=x.device) >= rate
    if part is not None:
        keep = part(keep)
    return torch.where(keep, x / (1.0 - rate), 0.0).to(x.dtype)


def _own_rows(mesh, x: torch.Tensor):
    """(full_shape, part) of a dropout on x (B, ...), the data rank's rows of
    an activation of n_data · B rows."""
    B, d = x.shape[0], mesh.data_index
    return (B * mesh.n_data, *x.shape[1:]), lambda keep: keep[d * B:(d + 1) * B]


def _attention_scores(q, k, v, mask_bias, dropout=None, kv_layout="btgd"):
    """Masked-softmax MQA attention.  q (B, S, G, Hg, D); k, v (B, T, G, D)
    (parity, ``btgd``) or the cache layout (B, G, T, D) (``bgtd``);
    mask_bias additive f32, broadcastable to (B, G, Hg, S, T); ``dropout`` =
    (rate, generator) drops attention probabilities.  Returns (B, S, G·Hg·D)."""
    B, S, G, Hg, D = q.shape
    # the divisor rounded to q's dtype, a 0-dim tensor made once outside any
    # capture (the training program's eager warm-up makes it)
    q = Q.div_exact(q, math.sqrt(D))
    scores = torch.einsum(f"bsghd,{kv_layout}->bghst", q, k)
    scores = scores.float() + mask_bias
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    if dropout is not None:
        probs = _dropout(probs, *dropout)
    out = torch.einsum(f"bghst,{kv_layout}->bsghd", probs, v)
    return out.reshape(B, S, G * Hg * D)


def write_rows(cache_layer: torch.Tensor, new: torch.Tensor, start: torch.Tensor,
               rows: Optional[torch.Tensor] = None) -> None:
    """Write ``new`` (B, G, S, D) into ``cache_layer`` (Bc, G, T, D) at slots
    start[b]..start[b]+S-1 of cache row ``rows[b]`` (row b when None), in
    place.  The start clamps to [0, T − S], as JAX's dynamic_update_slice
    clamps it; ``new`` is stored through ``kv_store_cast``.  Plain PyTorch
    indexing: JAX leaves this write to XLA."""
    B, G, S, D = new.shape
    T = cache_layer.shape[2]
    dev = cache_layer.device
    pos = start.to(dev).long().clamp(0, T - S)[:, None] + torch.arange(S, device=dev)[None, :]
    r = torch.arange(B, device=dev) if rows is None else rows.to(dev).long()
    A.kv_put(cache_layer, (r[:, None], slice(None), pos), new.transpose(1, 2))


def block_forward(layer_params: dict, x: torch.Tensor, freqs_cis: torch.Tensor,
                  attn, config: ChatGLM2Config, quant_type: str,
                  rt: TorchRuntimeConfig, kv_write=None, past_kv=None, dropout=None,
                  collect_taps: bool = False):
    """One pre-norm transformer block.

    attn: ("flash_prefill", lengths) | ("flash_prefill_chunk", (lengths,
        starts, row_map or None)) | ("flash_decode", lengths) | an additive
        mask bias (the masked-softmax path).
    kv_write: (cache_k, cache_v, layer, start[, slot_map]) — the full
        (L, B, G, T, D) caches, this block's layer, and start = None for a
        prefill (slots 0..S-1) or a (B,) tensor of per-row first slots;
        ``slot_map`` (B,) sends row b to cache row slot_map[b] (a compact
        chunk batch) — or a ``paged_kv.PagedWrite`` for the paged pool.
        Returns the block's output.
    kv_write=None is parity mode: keys are ``past_kv`` (pk, pv), each
        (B, T_past, G, D), followed by this call's; ``attn`` is the additive
        mask; ``dropout`` = (rate, generator) drops the attention
        probabilities, then the FFN activation.  Returns (output, (k_full,
        v_full)), each (B, T, G, D), as JAX's does; with ``collect_taps`` a
        third element, the activations feeding each linear ({"qkv_in",
        "o_in", "w_in_in", "w_out_in"}: what the GPTQ calibration's
        Hessians are built from, quant/calibrate.py).
    """
    from . import paged_kv as PK

    B, S, _ = x.shape
    G = config.num_multi_query_groups
    D = config.head_hidden_size
    Hg = config.num_attention_heads // G
    kernels = rt.kernels_enabled(x.device)

    mesh = rt.mesh
    h = rms_norm(x, layer_params["attn_ln"]["weight"], config.layernorm_epsilon)
    if mesh is not None:  # q_proj's and kv_proj's partial grad_x sum up
        h = AO.copy_to_model(h, mesh)
    q = _linear(h, layer_params["q_proj"], quant_type, rt, "col")
    kv = _linear(h, layer_params["kv_proj"], quant_type, rt, "rep")

    sm_scale = 1.0 / math.sqrt(D)
    kv_out = None
    if mesh is not None and kv_write is not None:
        ctx = _mesh_attention(q, kv, freqs_cis, attn, kv_write, config, rt, kernels, sm_scale)
    elif isinstance(attn, tuple) and attn[0] == "flash_decode":
        # one token a row: RoPE and the K/V write in one op, then attend
        qd, kvd, fd = q.reshape(B, G, Hg, D), kv[:, 0], freqs_cis[:, 0]
        if isinstance(kv_write, PK.PagedWrite):
            ctx = PK.paged_decode(qd, kvd, fd, attn[1], kv_write, kernels, sm_scale)
        else:
            ctx = _dense_decode(qd, kvd, fd, attn[1], kv_write, kernels, sm_scale,
                                rt.decode_attn_v2)
    else:
        # under a mesh (the parity forward) q holds the rank's heads, which
        # read the KV groups from g0
        g0, Gq, Hq = (0, G, Hg) if mesh is None else SH.head_split(config, mesh.n_model,
                                                                     mesh.model_index)
        k, v = kv.split(config.kv_size, dim=-1)
        f = freqs_cis[:, :, None, None, :]
        q = A.apply_rotary_emb(q.reshape(B, S, Gq, Hq, D), f)
        k = A.apply_rotary_emb(k.reshape(B, S, G, 1, D), f).reshape(B, S, G, D)
        v = v.reshape(B, S, G, D)
        if kv_write is None:
            if past_kv is not None:
                k = torch.cat([past_kv[0].to(k.dtype), k], dim=1)
                v = torch.cat([past_kv[1].to(v.dtype), v], dim=1)
            kv_out = (k, v)
            drop = dropout
            if dropout is not None and mesh is not None:
                drop = (*dropout, *_own_heads(mesh, config, B, S, k.shape[1]))
            own = slice(g0, g0 + Gq)
            ctx = _attention_scores(q, k[:, :, own], v[:, :, own], attn, dropout=drop,
                                    kv_layout="btgd")
        elif isinstance(kv_write, PK.PagedWrite):
            ctx = PK.paged_attention(q, k.transpose(1, 2), v.transpose(1, 2), attn, kv_write,
                                     kernels, sm_scale)
        else:
            ctx = _dense_attention(q, k.transpose(1, 2), v.transpose(1, 2), attn, kv_write,
                                   kernels, sm_scale)
    ctx = ctx.reshape(B, S, -1)  # every head, or under a mesh the rank's

    x = x + _linear(ctx, layer_params["o_proj"], quant_type, rt, "row")
    h2 = rms_norm(x, layer_params["ffn_ln"]["weight"], config.layernorm_epsilon)
    if mesh is not None:
        h2 = AO.copy_to_model(h2, mesh)
    gate_in = _linear(h2, layer_params["w_in_h"], quant_type, rt, "col")
    gate = _linear(h2, layer_params["w_in_gate"], quant_type, rt, "col")
    act = F.silu(gate_in) * gate
    if dropout is not None:
        part = () if mesh is None else _own_columns(mesh, act, layer_params["w_out"], config,
                                                    quant_type)
        act = _dropout(act, *dropout, *part)
    x = x + _linear(act, layer_params["w_out"], quant_type, rt, "row")
    if kv_write is not None:
        return x
    if collect_taps:
        return x, kv_out, {"qkv_in": h, "o_in": ctx, "w_in_in": h2, "w_out_in": act}
    return x, kv_out


def _linear(x, params, quant_type, rt, tp_mode):
    """A linear, run per shard in ``tp_mode`` under a mesh
    (parallel/tp_linear.py), else whole."""
    if rt.mesh is None:
        return quant_linear(x, params, quant_type, rt)
    return tp_quant_linear(x, params, quant_type, rt, tp_mode)


def lm_head_logits(h, params, config, quant_type, rt):
    """The lm_head's logits (..., vocab_size); under a mesh each rank's
    vocab columns, all-gathered (differentiably) before sampling or the
    loss."""
    if rt.mesh is None:
        return quant_linear(h, params["lm_head"], quant_type, rt)[..., : config.vocab_size]
    y = _linear(AO.copy_to_model(h, rt.mesh), params["lm_head"], quant_type, rt, "col")
    return AO.gather_from_model(y, rt.mesh)[..., : config.vocab_size]


def _own_heads(mesh, config, B, S, T):
    """(full_shape, part) of a dropout on the attention probabilities of
    this rank's heads (B, Gl, Hgl, S, T): the data rank's rows and the
    rank's heads of every head's (n_data · B, G, Hg, S, T)."""
    G = config.num_multi_query_groups
    Hg = config.num_attention_heads // G
    _, Gl, Hgl = SH.head_split(config, mesh.n_model, mesh.model_index)
    d, h0 = mesh.data_index, mesh.model_index * Gl * Hgl

    def part(keep):
        keep = keep[d * B:(d + 1) * B].reshape(B, G * Hg, S, T)[:, h0:h0 + Gl * Hgl]
        return keep.reshape(B, Gl, Hgl, S, T)

    return (B * mesh.n_data, G, Hg, S, T), part


def _own_columns(mesh, act, w_out, config, quant_type):
    """(full_shape, part) of a dropout on the FFN activation's columns on
    this rank (B, S, n): those of w_out's storage rows, from
    min(m · Ks / tp, I), in the single process's activation of w_out's
    storage K (Ks) columns, and the data rank's rows."""
    B, S, n = act.shape
    Ks_local = SH.storage_k(w_out, quant_type)
    c0, d = min(mesh.model_index * Ks_local, config.inner_hidden_size), mesh.data_index
    return ((B * mesh.n_data, S, Ks_local * mesh.n_model),
            lambda keep: keep[d * B:(d + 1) * B, :, c0:c0 + n])


# ---------------------------------------------------------------------------
# Attention under a mesh (tensor-parallel serving)
# ---------------------------------------------------------------------------

def gather_heads(mesh, q_local):
    """Every rank's heads (B, Gl, Hgl, D) → (B, G, Hg, D) on every rank:
    rank m's heads are m·Hl .. of the flattened (group, head) order."""
    B, D = q_local.shape[0], q_local.shape[-1]
    parts = mesh.all_gather(q_local.reshape(B, -1, D), "model")  # (tp, B, Hl, D)
    return parts.transpose(0, 1).reshape(B, -1, D)


def own_heads(mesh, ctx):
    """The rank's heads' columns of every head's output (B, ..., nH·D)."""
    ctx = ctx.reshape(ctx.shape[0], -1)
    width = ctx.shape[1] // mesh.n_model
    return ctx[:, mesh.model_index * width:(mesh.model_index + 1) * width]


def local_kv_row(kv, g0: int, Gl: int, G: int, D: int):
    """The rank's KV groups of a decode token's kv row (B, 2·G·D), k then v
    (a copy: the append kernel reads k and v as one row)."""
    return torch.cat([kv[:, g0 * D:(g0 + Gl) * D], kv[:, (G + g0) * D:(G + g0 + Gl) * D]],
                     dim=1)


_BITS = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


def masked_put(dst: torch.Tensor, index: tuple, new: torch.Tensor, owned: torch.Tensor) -> None:
    """``dst[index] = new`` at the positions where ``owned`` (the index
    tensors' shape, over dst's leading dims), in place, as a sequential
    write would leave it, without selecting the positions on the host (no
    ``nonzero``, so a CUDA graph can hold it).  The write is an accumulate
    of ``new − old`` on the integer view of dst's bits, zeroed where not
    owned: a position that is not owned adds 0 to the slot its (clamped)
    index names, even a slot that an owned position writes in the same
    call, where a plain ``index_put_`` with repeated indices leaves
    undefined which write wins.  Of the owned positions that name one slot
    the last (in the index's row-major order) writes it; an owned slot ends
    with exactly the bits of new as dst stores it (``kv_store_cast``; the
    integer adds wrap)."""
    lin = index[0].long()
    for dim, ix in enumerate(index[1:], 1):
        lin = lin * dst.shape[dim] + ix.long()
    lin, flat = lin.flatten(), owned.flatten()
    n = lin.numel()
    # a slot's last owned writer: a stable sort groups each slot's writers
    # in order (the unowned positions get keys of their own)
    key = torch.where(flat, lin, -1 - torch.arange(n, device=lin.device))
    order = torch.sort(key, stable=True).indices
    last = torch.ones(n, dtype=torch.bool, device=lin.device)
    last[:-1] = key[order[:-1]] != key[order[1:]]
    owned = flat & torch.empty_like(last).scatter_(0, order, last)
    bits_t = _BITS[dst.element_size()]
    bits = dst.view(bits_t)
    new_bits = A.kv_store_cast(new, dst.dtype).contiguous().view(bits_t)
    keep = owned.reshape(*index[0].shape, *([1] * (new.dim() - index[0].dim()))).to(bits_t)
    bits.index_put_(index, (new_bits - bits[index]) * keep, accumulate=True)


def write_rows_sharded(cache_layer, new, start, shard: "A.KVShard", rows=None) -> None:
    """``write_rows`` on a T-shard (Bc, G, T_local, D) of a cache of
    ``shard.total`` slots: the start clamps to [0, total − S] as on one
    device, and only the positions this shard holds are written
    (``masked_put``: the others' bits stay as they were)."""
    B, G, S, D = new.shape
    dev = cache_layer.device
    T_local = cache_layer.shape[2]
    pos = start.to(dev).long().clamp(0, shard.total - S)[:, None] + torch.arange(S, device=dev)
    t = pos - shard.offset
    r = torch.arange(B, device=dev) if rows is None else rows.to(dev).long()
    masked_put(cache_layer.transpose(1, 2), (r[:, None].expand(B, S), t.clamp(0, T_local - 1)),
               new.transpose(1, 2), (t >= 0) & (t < T_local))


def gather_t_shards(mesh, cache_layer):
    """The whole (Bc, G, T, D) layer of a T-sharded cache on every rank."""
    parts = A.kv_bytes(mesh.all_gather(cache_layer, "model"))  # (tp, Bc, G, T_local, D)
    return parts.permute(1, 2, 0, 3, 4).reshape(*cache_layer.shape[:2], -1,
                                                  cache_layer.shape[3]).view(cache_layer.dtype)


def _mesh_attention(q, kv, freqs_cis, attn, kv_write, config, rt, kernels, sm_scale):
    """``block_forward``'s attention on one rank: q (B, S, Hl·D) its heads, kv
    (B, S, 2·G·D) every group's (kv_proj is whole on every rank).  Returns
    the rank's heads' output (B, S, Hl, D)."""
    from . import paged_kv as PK

    mesh = rt.mesh
    B, S = q.shape[:2]
    G, D = config.num_multi_query_groups, config.head_hidden_size
    g0, Gl, Hgl = SH.head_split(config, mesh.n_model, mesh.model_index)
    if not isinstance(attn, tuple):
        raise ValueError("under a mesh the serving paths take the flash structure")
    if isinstance(kv_write, PK.PagedWrite):
        return PK.mesh_paged_attention(q, kv, freqs_cis, attn, kv_write, config, rt, kernels,
                                       sm_scale)
    ck, cv, layer, start, *rest = kv_write
    slot_map = rest[0] if rest else None
    tp, T_loc = mesh.n_model, ck.shape[3]
    shard = A.KVShard(offset=mesh.model_index * T_loc, total=T_loc * tp)
    kind, lengths = attn
    if kind == "flash_decode":
        qd, kvd, fd = q.reshape(B, Gl, Hgl, D), kv[:, 0], freqs_cis[:, 0]
        if rt.kv_shard_t:
            append = A.rope_kv_append_sharded if kernels else A.rope_kv_append_sharded_plain
            q_all = gather_heads(mesh, append(qd, kvd, fd, ck, cv, layer, start, shard))
            ctx = A.flash_attention_decode_kv_tsharded(
                q_all.reshape(B, G, -1, D), ck[layer], cv[layer], lengths, sm_scale, mesh,
                kernels)
            return own_heads(mesh, ctx)
        append = A.rope_kv_append if kernels else A.rope_kv_append_plain
        qd = append(qd, local_kv_row(kvd, g0, Gl, G, D), fd, ck, cv, layer, start)
        decode = A.flash_attention_decode if kernels else A.flash_attention_decode_plain
        return decode(qd, ck[layer], cv[layer], lengths, sm_scale)

    k, v = kv.split(config.kv_size, dim=-1)
    f = freqs_cis[:, :, None, None, :]
    q = A.apply_rotary_emb(q.reshape(B, S, Gl, Hgl, D), f)
    k = A.apply_rotary_emb(k.reshape(B, S, G, 1, D), f).reshape(B, S, G, D)
    v = v.reshape(B, S, G, D)
    kw, vw = k.transpose(1, 2), v.transpose(1, 2)  # (B, G, S, D)
    own = slice(g0, g0 + Gl)
    if rt.kv_shard_t:
        if start is None:  # a prefill: slots 0 .. S - 1
            start = torch.zeros((B,), dtype=torch.int32, device=q.device)
        write_rows_sharded(ck[layer], kw, start, shard, slot_map)
        write_rows_sharded(cv[layer], vw, start, shard, slot_map)
    elif start is None:
        A.kv_put(ck[layer], (slice(None), slice(None), slice(None, S)), kw[:, own])
        A.kv_put(cv[layer], (slice(None), slice(None), slice(None, S)), vw[:, own])
    else:
        write_rows(ck[layer], kw[:, own], start, slot_map)
        write_rows(cv[layer], vw[:, own], start, slot_map)

    if kind == "flash_prefill" and rt.kv_shard_t:
        # the ring over the prompt's sequence shards: rank m's queries (its
        # heads, every position) against each shard of K and V in turn
        if S % tp:
            raise ValueError(f"ring prefill: {S} positions do not split over tp = {tp}")
        S_loc = S // tp
        mine = slice(mesh.model_index * S_loc, (mesh.model_index + 1) * S_loc)
        return RA.ring_attention_local(q, torch.arange(S, device=q.device), k[:, mine],
                                       v[:, mine], lengths, mesh, sm_scale, kv_groups=own)
    # the cache as stored: the kernel (or the plain version) upcasts what it reads
    prefill = A.flash_attention_prefill if kernels else A.flash_attention_prefill_plain
    if kind == "flash_prefill":
        return prefill(q, ck[layer], cv[layer], lengths, sm_scale)
    lengths, starts, row_map = lengths  # "flash_prefill_chunk"
    if rt.kv_shard_t:  # the whole cache layer of the rank's groups
        kc = A.kv_contiguous(gather_t_shards(mesh, ck[layer])[:, own])
        vc = A.kv_contiguous(gather_t_shards(mesh, cv[layer])[:, own])
    else:
        kc, vc = ck[layer], cv[layer]
    return prefill(q, kc, vc, lengths, sm_scale, q_starts=starts, kv_row_map=row_map)


def _dense_attention(q, kw, vw, attn, kv_write, kernels, sm_scale):
    """Write this block's K/V (B, G, S, D) into the dense cache, then attend
    (a prefill, a chunk, or the masked path)."""
    ck, cv, layer, start, *rest = kv_write
    slot_map = rest[0] if rest else None
    S = q.shape[1]
    if start is None:
        A.kv_put(ck[layer], (slice(None), slice(None), slice(None, S)), kw)
        A.kv_put(cv[layer], (slice(None), slice(None), slice(None, S)), vw)
    elif S == 1 and slot_map is None:
        write = A.kv_cache_write_idx if (kernels and isinstance(attn, tuple)) \
            else A.kv_cache_write_idx_plain
        write(ck, kw[:, :, 0], layer, start)
        write(cv, vw[:, :, 0], layer, start)
    else:
        write_rows(ck[layer], kw, start, slot_map)
        write_rows(cv[layer], vw, start, slot_map)

    kc, vc = ck[layer], cv[layer]  # as stored: the flash paths upcast what they read
    if not isinstance(attn, tuple):
        kc, vc = kc.to(q.dtype), vc.to(q.dtype)  # the masked path upcasts the slab, as JAX's
        if slot_map is not None:  # a compact chunk: the mapped cache rows
            kc, vc = kc[slot_map.long()], vc[slot_map.long()]
        return _attention_scores(q, kc, vc, attn, kv_layout="bgtd")
    kind, lengths = attn
    fn = A.flash_attention_prefill if kernels else A.flash_attention_prefill_plain
    if kind == "flash_prefill":
        return fn(q, kc, vc, lengths, sm_scale)
    lengths, starts, row_map = lengths  # "flash_prefill_chunk"
    return fn(q, kc, vc, lengths, sm_scale, q_starts=starts, kv_row_map=row_map)


def _dense_decode(q, kv, freqs, lengths, kv_write, kernels, sm_scale, decode_v2=False):
    """The flash decode step over the dense cache: q (B, G, Hg, D) and kv
    (B, 2·G·D) of one token a row, its RoPE row freqs (B, D).  Rotates q and
    k and writes k and v at slot ``start`` in one op (B3 with the RoPE), then
    attends slots 0..lengths through B4, or B12 under ``decode_v2``."""
    ck, cv, layer, start, *rest = kv_write
    if start is None or rest:
        raise ValueError("a flash decode writes at per-row starts into every cache row")
    append = A.rope_kv_append if kernels else A.rope_kv_append_plain
    q = append(q, kv, freqs, ck, cv, layer, start)
    if decode_v2:
        fn = A.flash_attention_decode_v2 if kernels else A.flash_attention_decode_v2_plain
    else:
        fn = A.flash_attention_decode if kernels else A.flash_attention_decode_plain
    return fn(q, ck[layer], cv[layer], lengths, sm_scale)


def _layer(tree: dict, l: int) -> dict:
    """Layer ``l``'s views of the stacked (L, ...) leaves."""
    return {k: _layer(v, l) if isinstance(v, dict) else v[l] for k, v in tree.items()}


def _layers_serving(params, config, quant_type, rt, h, freqs_cis, attn, cache, start,
                    slot_map=None):
    for l in range(config.num_layers):
        kv_write = (cache.k, cache.v, l, start) if slot_map is None \
            else (cache.k, cache.v, l, start, slot_map)
        h = block_forward(_layer(params["layers"], l), h, freqs_cis, attn, config,
                          quant_type, rt, kv_write)
    return h


# ---------------------------------------------------------------------------
# Parity-mode forward (reference semantics: mask, positions, loss)
# ---------------------------------------------------------------------------

def build_parity_mask_and_positions(attention_mask: torch.Tensor, n_new: int):
    """(B, S) 1/0 mask → additive (B, n_new, S) f32 mask and (B, n_new)
    position ids, as the reference's ``prepare_input`` (model.py:303-318):
    causal ∨ padding, × −1e10; positions = cumsum(mask), starting at 1; both
    for the last ``n_new`` query positions.  The mask stays additive and
    finite: a query row whose keys are all masked gets a uniform softmax,
    not NaN."""
    S = attention_mask.shape[1]
    dev = attention_mask.device
    position_ids = torch.cumsum(attention_mask.long(), dim=1)
    seq = torch.arange(S, device=dev)
    causal = seq[:, None] < seq[None, :]
    pad = ~attention_mask[:, None, :].bool()
    bias = (causal[None] | pad).float() * MASK_VALUE
    return bias[:, -n_new:, :], position_ids[:, -n_new:]


def _stacked_past(past_key_values, device):
    """The reference's per-layer ``((k, v), ...)`` — each (B, T, G, D) or
    (B, T, G, 1, D) — or a pre-stacked ``(k (L, B, T, G, D), v)`` pair, as
    two stacked (L, B, T, G, D) tensors."""
    if isinstance(past_key_values[0], torch.Tensor):
        return past_key_values[0].to(device), past_key_values[1].to(device)

    def norm(t):
        t = torch.as_tensor(t, device=device)
        return t[:, :, :, 0] if t.dim() == 5 else t

    return (torch.stack([norm(k) for k, _ in past_key_values]),
            torch.stack([norm(v) for _, v in past_key_values]))


def forward(params: dict, config: ChatGLM2Config, input_ids: torch.Tensor,
            attention_mask: Optional[torch.Tensor] = None,
            position_ids: Optional[torch.Tensor] = None,
            labels: Optional[torch.Tensor] = None, quant_type: str = "none",
            dtype=torch.float32, rt: TorchRuntimeConfig = _DEFAULT_RT,
            past_key_values=None, generator: Optional[torch.Generator] = None,
            return_kv: bool = False):
    """Full-sequence forward with the reference's semantics (model.py:329-392).

    ``input_ids`` (B, S_new); ``attention_mask`` (B, S_past + S_new) 1/0
    (default all ones); ``position_ids`` (B, S_new) (default the mask's
    cumsum); ``labels`` (B, S_new) with −100 ignored.  ``past_key_values``
    (see ``_stacked_past``) is the reference's stateless incremental API:
    the new tokens attend over past + new keys.  ``generator`` turns on
    train-mode dropout at ``config.dropout_rate`` (embedding output,
    attention probabilities, FFN activation); without it the forward is
    deterministic.  ``rt.remat_layers`` recomputes each layer in the
    backward pass.

    Returns ``(loss or None, logits (B, S_new, V))``; with ``return_kv`` or
    ``past_key_values``, the reference's 3-tuple with the per-layer
    ``(k, v)``, each (B, T_total, G, 1, D), appended.

    Under ``rt.mesh`` (``params`` the rank's ``shard_params`` slice) the
    inputs are the data rank's rows, the linears run per shard, each rank
    attends its heads, and the logits come back whole on every model rank;
    the loss is the mean over every data rank's valid labels
    (``cross_entropy_loss``).  Dropout draws each mask over the global
    activation, so a mesh drops what one process would from the same
    generator.
    """
    B, S = input_ids.shape
    L = config.num_layers
    dev = input_ids.device
    past = None if past_key_values is None else _stacked_past(past_key_values, dev)
    n_past = 0 if past is None else past[0].shape[2]
    if attention_mask is None:
        attention_mask = torch.ones((B, n_past + S), dtype=torch.int32, device=dev)
    mask_bias, pos = build_parity_mask_and_positions(attention_mask.to(dev), S)
    if position_ids is not None:
        pos = position_ids.to(dev)
    freqs_cis = _serving_freqs(config, pos, dtype)
    h = quant_embedding_lookup(params["word_embedding"], input_ids, quant_type, dtype)
    mask5 = mask_bias[:, None, None]
    mesh = rt.mesh

    rate = config.dropout_rate
    seeds = None
    if generator is not None and rate > 0:
        h = _dropout(h, rate, generator, *(() if mesh is None else _own_rows(mesh, h)))
        # one seed per layer, drawn up front; each layer builds its generator
        # from its seed, so a recomputation under remat draws the same masks
        # (checkpoint restores the default generators only)
        seeds = torch.randint(0, 2 ** 62, (L,), generator=generator,
                              device=generator.device).tolist()

    def layer(l, h):
        drop = None
        if seeds is not None:
            drop = (rate, torch.Generator(device=h.device).manual_seed(seeds[l]))
        pkv = None if past is None else (past[0][l], past[1][l])
        return block_forward(_layer(params["layers"], l), h, freqs_cis, mask5, config,
                             quant_type, rt, past_kv=pkv, dropout=drop)

    kvs = []
    for l in range(L):
        if rt.remat_layers:
            h, kv = checkpoint(layer, l, h, use_reentrant=False)
        else:
            h, kv = layer(l, h)
        kvs.append(kv)
    h = rms_norm(h, params["final_ln"]["weight"], config.layernorm_epsilon)
    logits = lm_head_logits(h, params, config, quant_type, rt)
    loss = None if labels is None else cross_entropy_loss(logits, labels.to(dev), mesh)
    if return_kv or past_key_values is not None:
        return loss, logits, tuple((k[:, :, :, None], v[:, :, :, None]) for k, v in kvs)
    return loss, logits


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor, mesh=None) -> torch.Tensor:
    """Shifted cross-entropy in f32, −100 ignored, the mean over the valid
    positions (at least 1) (model.py:384-388).  Under a mesh of several
    data ranks, each holding its rows, the mean over every rank's valid
    positions: the count is summed over the data axis, and each rank's sum
    over it divided by that count is summed too (``reduce_from``: the
    gradient of each rank's part is its rows' alone), so every rank holds
    the global loss however the −100 labels fall."""
    shift_logits = logits[:, :-1].float()
    shift_labels = labels[:, 1:].long()
    total = F.cross_entropy(shift_logits.reshape(-1, shift_logits.shape[-1]),
                            shift_labels.reshape(-1), ignore_index=-100, reduction="sum")
    count = (shift_labels != -100).sum()
    if mesh is None or mesh.n_data == 1:
        return total / count.clamp_min(1)
    count = mesh.all_reduce(count, SH.DATA_AXIS)
    return AO.reduce_from(total / count.clamp_min(1), mesh, SH.DATA_AXIS)


# ---------------------------------------------------------------------------
# Serving entry points
# ---------------------------------------------------------------------------

def prefill(params: dict, config: ChatGLM2Config, input_ids: torch.Tensor,
            lengths: torch.Tensor, cache: KVCache, quant_type: str = "none",
            dtype=torch.bfloat16, rt: TorchRuntimeConfig = _DEFAULT_RT):
    """Prefill the cache from slot 0 with right-padded rows ``input_ids``
    (B, S) of true lengths ``lengths`` (B,); return last-token logits (B, V)
    and the cache (updated in place)."""
    B, S = input_ids.shape
    T = cache.max_length
    dev = input_ids.device
    positions = torch.arange(1, S + 1, device=dev)[None, :].expand(B, S)
    freqs_cis = _serving_freqs(config, positions, dtype)
    h = quant_embedding_lookup(params["word_embedding"], input_ids, quant_type, dtype)
    lengths = lengths.to(device=dev, dtype=torch.int32)

    if rt.flash_enabled(dev):
        attn = ("flash_prefill", lengths)
    else:
        # query t attends cache slots j ≤ t (slot j holds token j)
        tq = torch.arange(S, device=dev)[:, None]
        tk = torch.arange(T, device=dev)[None, :]
        bias = torch.where(tk <= tq, 0.0, MASK_VALUE).float()
        attn = bias[None, None, None]

    h = _layers_serving(params, config, quant_type, rt, h, freqs_cis, attn, cache, None)
    h = rms_norm(h, params["final_ln"]["weight"], config.layernorm_epsilon)
    last = h[torch.arange(B, device=dev), (lengths - 1).long()]
    logits = lm_head_logits(last, params, config, quant_type, rt)
    return logits, KVCache(cache.k, cache.v, lengths)


def prefill_chunk(params: dict, config: ChatGLM2Config, input_ids: torch.Tensor,
                  starts: torch.Tensor, chunk_valid: torch.Tensor, cache: KVCache,
                  quant_type: str = "none", dtype=torch.bfloat16,
                  rt: TorchRuntimeConfig = _DEFAULT_RT,
                  slot_map: Optional[torch.Tensor] = None, return_all_logits: bool = False):
    """One chunk ``input_ids`` (B, Sc) of each row's prompt: write its KV at
    ``starts`` (B,) and attend causally over the whole cache below each
    query's absolute position ``starts[b] + r``.  Rows' lengths become
    ``starts + chunk_valid``; returns the logits at each row's last valid
    chunk position (B, V), or at every position (B, Sc, V) with
    ``return_all_logits`` (speculative verification), and the cache.

    With ``slot_map`` (B,) the batch is compact: row b belongs to cache row
    ``slot_map[b]`` (writes and attention follow the map, no row copies) and
    the other rows' lengths stay as they were.  ``prefill`` is a single
    chunk at starts = 0."""
    B, Sc = input_ids.shape
    T = cache.max_length
    dev = input_ids.device
    starts = starts.to(device=dev, dtype=torch.int32)
    chunk_valid = chunk_valid.to(device=dev, dtype=torch.int32)
    positions = starts.long()[:, None] + torch.arange(1, Sc + 1, device=dev)[None, :]
    freqs_cis = _serving_freqs(config, positions, dtype)
    h = quant_embedding_lookup(params["word_embedding"], input_ids, quant_type, dtype)

    row_lengths = starts + chunk_valid
    if slot_map is not None:
        slot_map = slot_map.to(device=dev, dtype=torch.int32)
    if rt.flash_enabled(dev):
        attn = ("flash_prefill_chunk", (row_lengths, starts, slot_map))
    else:
        # query r of row b sits at starts[b] + r and attends slots ≤ it
        tq = torch.arange(Sc, device=dev)[None, :, None]
        tk = torch.arange(T, device=dev)[None, None, :]
        causal = tk <= starts.long()[:, None, None] + tq
        attn = torch.where(causal, 0.0, MASK_VALUE).float()[:, None, None]

    h = _layers_serving(params, config, quant_type, rt, h, freqs_cis, attn, cache, starts,
                        slot_map)
    h = rms_norm(h, params["final_ln"]["weight"], config.layernorm_epsilon)
    if not return_all_logits:
        h = h[torch.arange(B, device=dev), (chunk_valid - 1).long()]
    logits = lm_head_logits(h, params, config, quant_type, rt)
    if slot_map is None:
        lengths = row_lengths
    else:
        lengths = cache.lengths.clone()
        lengths[slot_map.long()] = row_lengths
    return logits, KVCache(cache.k, cache.v, lengths)


def decode_step(params: dict, config: ChatGLM2Config, next_ids: torch.Tensor,
                cache: KVCache, quant_type: str = "none", dtype=torch.bfloat16,
                rt: TorchRuntimeConfig = _DEFAULT_RT):
    """One token per row: write slot ``lengths``, attend slots ≤ ``lengths``,
    return logits (B, V) and the cache with ``lengths + 1``."""
    T = cache.max_length
    dev = next_ids.device
    positions = (cache.lengths + 1)[:, None].long()  # 1-based
    freqs_cis = _serving_freqs(config, positions, dtype)
    h = quant_embedding_lookup(params["word_embedding"], next_ids[:, None], quant_type, dtype)

    if rt.flash_enabled(dev):
        attn = ("flash_decode", cache.lengths)
    else:
        valid = torch.arange(T, device=dev)[None, :] <= cache.lengths[:, None]
        attn = torch.where(valid, 0.0, MASK_VALUE).float()[:, None, None, None, :]

    h = _layers_serving(params, config, quant_type, rt, h, freqs_cis, attn, cache,
                        cache.lengths)
    h = rms_norm(h, params["final_ln"]["weight"], config.layernorm_epsilon)
    logits = lm_head_logits(h[:, 0], params, config, quant_type, rt)
    return logits, KVCache(cache.k, cache.v, cache.lengths + 1)


def prompt_bucket(n: int, max_length: int, minimum: int = 16) -> int:
    """The power-of-two width an ``n``-token prompt is prefilled at (JAX's
    ``_bucket``, serving/decoder.py:33): at least ``minimum``, clamped to
    ``max_length`` (the cache's slots).  One prefill program a bucket."""
    b = minimum
    while b < n:
        b *= 2
    return min(b, max_length)


def prefill_program(params: dict, config: ChatGLM2Config, cache: KVCache, bucket: int,
                    quant_type: str, dtype, rt: TorchRuntimeConfig):
    """``prefill`` of right-padded rows at one ``bucket`` width as a step
    program (utils/graphs.py; JAX's jitted prefill of that bucket) over
    ``cache``'s tensors: static "ids" (B, bucket) int64 and "lengths" (B,)
    int32, output "logits" (B, V).  Call its step with ``(params, cache.k,
    cache.v)``.  Padding changes no output at a valid position: a query
    attends slots at or below it, the logits come from ``lengths − 1``, and
    the padding's K/V lands in slots at or above the row's length."""
    B = cache.k.shape[1]
    dev = cache.k.device
    key = ("prefill", G.tensor_key(cache.k), G.tensor_key(cache.v), B, bucket,
           G.static_key(config, quant_type, dtype, rt))

    def inputs():
        return {"ids": torch.zeros((B, bucket), dtype=torch.long, device=dev),
                "lengths": torch.ones((B,), dtype=torch.int32, device=dev)}

    def body(inp, params, k, v):
        logits, _ = prefill(params, config, inp["ids"], inp["lengths"],
                            KVCache(k, v, inp["lengths"]), quant_type, dtype, rt)
        return {"logits": logits}

    return G.programs(params, "prefill").get(key, "prefill", inputs, body, dev, rt,
                                                 refused=G.mesh_prefill_refusal(rt))


def chunk_program(params: dict, config: ChatGLM2Config, cache: KVCache, rows: int, width: int,
                  quant_type: str, dtype, rt: TorchRuntimeConfig):
    """``prefill_chunk`` of a compact batch (``slot_map``) of ``rows`` rows
    of ``width`` tokens as a step program over ``cache``'s tensors: static
    "ids" (rows, width) int64, "starts", "valid", "slot_map" (rows,) int32
    and the cache's "lengths" (B,) int32; outputs "logits" (rows, V) and
    the new "lengths" (B,).  Call its step with ``(params, cache.k,
    cache.v)``."""
    B = cache.k.shape[1]
    dev = cache.k.device
    key = ("prefill_chunk", G.tensor_key(cache.k), G.tensor_key(cache.v), rows, width,
           G.static_key(config, quant_type, dtype, rt))

    def inputs():
        return {"ids": torch.zeros((rows, width), dtype=torch.long, device=dev),
                **{name: torch.zeros((rows,), dtype=torch.int32, device=dev)
                   for name in ("starts", "valid", "slot_map")},
                "lengths": torch.zeros((B,), dtype=torch.int32, device=dev)}

    def body(inp, params, k, v):
        logits, c = prefill_chunk(params, config, inp["ids"], inp["starts"], inp["valid"],
                                  KVCache(k, v, inp["lengths"]), quant_type, dtype, rt,
                                  slot_map=inp["slot_map"])
        return {"logits": logits, "lengths": c.lengths}

    return G.programs(params, "prefill").get(key, "prefill_chunk", inputs, body, dev, rt,
                                                 refused=G.mesh_prefill_refusal(rt))


def decode_program(params: dict, config: ChatGLM2Config, cache: KVCache, quant_type: str,
                   dtype, rt: TorchRuntimeConfig, sampling: Sampling = GREEDY):
    """The decode step with its sampler as a step program (utils/graphs.py)
    over ``cache``'s tensors: static "ids" and "lengths" (B,) int32 (and the
    per-row sampling buffers of a "rows" sampler); each step writes the
    sampled token into "ids" and the advanced lengths into "lengths".  Call
    its steps with ``(params, cache.k, cache.v)``."""
    B = cache.lengths.shape[0]
    dev = cache.k.device
    key = ("decode_step", G.tensor_key(cache.k), G.tensor_key(cache.v),
           G.static_key(config, quant_type, dtype, rt), sampling.key)

    def inputs():
        return {"ids": torch.zeros((B,), dtype=torch.int32, device=dev),
                "lengths": torch.zeros((B,), dtype=torch.int32, device=dev),
                **sampling.row_buffers(B, dev)}

    def body(inp, params, k, v):
        logits, c = decode_step(params, config, inp["ids"], KVCache(k, v, inp["lengths"]),
                                quant_type, dtype, rt)
        inp["ids"].copy_(sampling(logits, inp))
        inp["lengths"].copy_(c.lengths)
        return {}

    return G.programs(params).get(key, "decode_step", inputs, body, dev, rt, sampling.generator)


def multi_step_decode(params: dict, config: ChatGLM2Config, first_ids: torch.Tensor,
                      cache: KVCache, num_steps: int,
                      generator: Optional[torch.Generator] = None,
                      quant_type: str = "none", dtype=torch.bfloat16,
                      rt: TorchRuntimeConfig = _DEFAULT_RT, top_k: int = 100,
                      top_p: float = 0.8, temperature: float = 1.0):
    """``num_steps`` decode steps with in-loop sampling (greedy when
    ``generator`` is None, else top-p): ``num_steps`` replays of one
    captured step (``decode_program``), the counterpart of JAX's jitted
    ``lax.scan``.  Nothing syncs to the host per token.  Returns (tokens
    (B, num_steps) int32, cache)."""
    sampling = GREEDY if generator is None else top_p_rows(top_k, generator)
    prog = decode_program(params, config, cache, quant_type, dtype, rt, sampling)
    prog.load(ids=first_ids.to(torch.int32), lengths=cache.lengths)
    if generator is not None:
        fill_rows(prog.inputs, top_k, top_p, temperature)
    toks = prog.run(num_steps, params, cache.k, cache.v, collect=("ids",))["ids"]
    return toks.t().contiguous(), KVCache(cache.k, cache.v, prog.inputs["lengths"].clone())


# ---------------------------------------------------------------------------
# Random init (the structure is also the param-tree schema)
# ---------------------------------------------------------------------------

def _init_linear(generator: torch.Generator, k: int, n: int, bias: bool, quant_type: str,
                 dtype, device, lead: tuple = (), scale: float = 0.02) -> dict:
    """A (*lead, k, n) linear of N(0, scale²) weights (f32 draws), stored as
    ``quant_type``; a zero bias.  Each leading index (a layer) is quantized
    on its own."""
    w = torch.randn((*lead, k, n), generator=generator, device=generator.device).to(device)
    w.mul_(scale)
    if quant_type == "none":
        p = {"weight": w.to(dtype)}
    elif quant_type == "int8":
        p = Q.quantize_linear_int8(w)
    elif quant_type == "int4g32":
        p = Q.quantize_linear_int4(w)
    else:
        raise NotImplementedError(quant_type)
    if bias:
        p["bias"] = torch.zeros((*lead, n), dtype=dtype, device=device)
    return p


def init_params(generator: torch.Generator, config: ChatGLM2Config, quant_type: str = "none",
                dtype=torch.float32, device=None) -> dict:
    """Random-init parameter tree (tests, benchmarks, the quantizers' float
    input): the JAX package's ``init_params`` keys, shapes, dtypes and N
    padding, drawn from ``generator`` (its values differ from
    ``jax.random``'s).  ``device=None`` means CUDA, and raises where CUDA is
    absent; the draws run on the generator's device."""
    device = resolve_device(device)
    H, I = config.hidden_size, config.inner_hidden_size
    V, L = config.vocab_size, config.num_layers

    emb_w = torch.randn((V, H), generator=generator, device=generator.device).to(device) * 0.02
    if quant_type == "none":
        emb = {"weight": emb_w.to(dtype)}
    elif quant_type == "int8":
        emb = Q.quantize_embedding_int8(emb_w)
    else:
        emb = Q.quantize_embedding_int4(emb_w)
    del emb_w

    def stacked(k, n, bias, pad_n=False):
        p = _init_linear(generator, k, n, bias, quant_type, dtype, device, lead=(L,))
        return Q.pad_linear_n(p, quant_type) if pad_n and quant_type != "none" else p

    ones = torch.ones((L, H), dtype=dtype, device=device)
    layers = {
        "attn_ln": {"weight": ones},
        "q_proj": stacked(H, config.q_size, True),
        "kv_proj": stacked(H, 2 * config.kv_size, True),
        "o_proj": stacked(config.q_size, H, False),
        "ffn_ln": {"weight": ones.clone()},
        "w_in_h": stacked(H, I, False, pad_n=True),
        "w_in_gate": stacked(H, I, False, pad_n=True),
        "w_out": stacked(I, H, False),
    }
    return {
        "word_embedding": emb,
        "layers": layers,
        "final_ln": {"weight": torch.ones((H,), dtype=dtype, device=device)},
        "lm_head": Q.lmhead_pad(_init_linear(generator, H, V, False, quant_type, dtype, device),
                                quant_type),
    }

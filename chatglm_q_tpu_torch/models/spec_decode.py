"""Prompt-lookup speculative decoding inside the decode loop, over the paged
KV cache — the counterpart of chatglm_q_tpu/models/spec_decode.py.

Every step of ``speculative_decode_paged`` stays on the device:

* a token history (B, T) holds each row's prompt and generation; the draft
  of a step is a vectorized n-gram match over it (``find_drafts``);
* verification is one (B, k+1)-token chunked forward over the pool
  (``prefill_chunk_paged`` with unaligned token writes), whose extra k rows
  ride the weight stream a decode step pays anyway;
* acceptance, the next token and the ragged length advances are tensor
  operations; the host reads the per-step (draft, accept, next) triples
  once per chunk.

Greedy-exact: a row accepts exactly the tokens step-by-step greedy decoding
would have produced; a row with no n-gram match drafts the impossible token
−1 and degrades to a plain decode step.  Rejected positions' KV and token
writes sit above the rolled-back lengths and are overwritten later.  The
history is updated in place where the JAX code returns a new array.

Sampled rows (JAX's ``speculative_sampled`` with ``spec_accept_next``) are
not carried: ``PagedServingEngine(speculative_sampled=True)`` raises
``NotImplementedError`` with ``SAMPLED_NOT_PORTED``.
"""
from __future__ import annotations

import torch

from ..config import ChatGLM2Config, TorchRuntimeConfig
from ..utils import graphs as G
from . import paged_kv as PK

_DEFAULT_RT = TorchRuntimeConfig()
SAMPLED_NOT_PORTED = ("speculative decoding of sampled rows (speculative_sampled, "
                      "spec_accept_next) is not ported yet: ROADMAP.md queue A, item 10")


def find_drafts(tokbuf: torch.Tensor, lengths: torch.Tensor, ngram: int, k: int) -> torch.Tensor:
    """Vectorized prompt-lookup drafting.

    ``tokbuf`` (B, T) int32 token history per row (valid below ``lengths``);
    returns (B, k) draft ids with −1 where no draft exists (−1 never equals
    an argmax, so such positions are rejected).  The most recent earlier
    occurrence of the last ``ngram`` tokens wins."""
    B, T = tokbuf.shape
    g = ngram
    dev = tokbuf.device
    lengths = lengths.to(dev).long()
    tail_idx = (lengths[:, None] - g + torch.arange(g, device=dev)[None, :]).clamp(0, T - 1)
    tail = tokbuf.gather(1, tail_idx)
    match = torch.ones((B, T - g), dtype=torch.bool, device=dev)
    for i in range(g):
        match &= tokbuf[:, i:T - g + i] == tail[:, i:i + 1]
    # the occurrence must lie strictly before the tail, and the row must have
    # a g-token tail at all
    p_range = torch.arange(T - g, device=dev)[None, :]
    match &= (p_range <= lengths[:, None] - g - 1) & (lengths[:, None] >= g + 1)
    p_star = torch.where(match, p_range, -1).max(dim=1).values
    src = p_star[:, None] + g + torch.arange(k, device=dev)[None, :]
    draft = tokbuf.gather(1, src.clamp(0, T - 1))
    ok = (p_star >= 0)[:, None] & (src < lengths[:, None])  # only real history
    return torch.where(ok, draft, torch.full_like(draft, -1))


def _write_token_rows(tokbuf: torch.Tensor, seq: torch.Tensor, starts: torch.Tensor) -> None:
    """tokbuf[b, starts[b] + t] = seq[b, t] in place, DROPPING positions at
    or past T.  Not a clamped window: near the end a clamp would shift the
    write down over committed history and corrupt the n-gram search."""
    B, S = seq.shape
    T = tokbuf.shape[1]
    idx = starts.to(tokbuf.device).long()[:, None] + torch.arange(S, device=tokbuf.device)[None]
    ext = torch.cat([tokbuf, tokbuf.new_zeros((B, 1))], dim=1)  # column T takes the drops
    ext.scatter_(1, idx.clamp(max=T), seq.to(tokbuf.dtype))
    tokbuf.copy_(ext[:, :T])


def spec_program(params: dict, config: ChatGLM2Config, cache: PK.PagedKVCache, T: int,
                 k: int = 8, ngram: int = 3, quant_type: str = "none", dtype=torch.bfloat16,
                 rt: TorchRuntimeConfig = _DEFAULT_RT):
    """One greedy verify step of ``speculative_decode_paged`` as a step
    program (utils/graphs.py) over ``cache``'s pools, at its batch and table
    width, with a token history of ``T`` columns: static "tok", "lengths"
    (B,) int32, "page_table" (B, MP) int32 and "tokbuf" (B, T) int32; each
    step writes the next token into "tok", the advanced lengths into
    "lengths" and the step's tokens into "tokbuf", and returns "draft" (B,
    k), "accept" and "next" (B,).  Call its steps with ``(params,
    cache.k_pool, cache.v_pool)``."""
    KT = k + 1
    B, MP = cache.page_table.shape
    dev = cache.k_pool.device
    key = ("spec_step", G.tensor_key(cache.k_pool), G.tensor_key(cache.v_pool), B, MP, T, k,
           ngram, G.static_key(config, quant_type, dtype, rt))

    def inputs():
        return {"tok": torch.zeros((B,), dtype=torch.int32, device=dev),
                "lengths": torch.zeros((B,), dtype=torch.int32, device=dev),
                "page_table": torch.zeros((B, MP), dtype=torch.int32, device=dev),
                "tokbuf": torch.zeros((B, T), dtype=torch.int32, device=dev),
                "full": torch.full((B,), KT, dtype=torch.int32, device=dev)}

    def body(inp, params, k_pool, v_pool):
        tok, tokbuf, l0 = inp["tok"], inp["tokbuf"], inp["lengths"]
        # the pending token joins the searched history (the n-gram tail ends
        # with it)
        _write_token_rows(tokbuf, tok[:, None], l0)
        draft = find_drafts(tokbuf, l0 + 1, ngram, k)
        safe_seq = torch.cat([tok[:, None], draft.clamp(min=0)], dim=1)
        _write_token_rows(tokbuf, safe_seq[:, 1:], l0 + 1)
        cache = PK.PagedKVCache(k_pool, v_pool, inp["page_table"], l0)
        all_logits, cache = PK.prefill_chunk_paged(
            params, config, safe_seq, l0, inp["full"], cache, quant_type, dtype, rt,
            return_all_logits=True, page_aligned=False)
        argm = all_logits.argmax(dim=-1).to(torch.int32)  # (B, KT)
        accept = (argm[:, :k] == draft).to(torch.int32).cumprod(dim=1).sum(dim=1)
        nxt = argm.gather(1, accept[:, None].long())[:, 0]
        # past the capacity the writes clamp and the host rolls the tokens
        # back, so the lengths clamp too
        l0.copy_((l0 + 1 + accept).clamp(max=cache.max_length - 1))
        tok.copy_(nxt)
        return {"draft": draft, "accept": accept.to(torch.int32), "next": nxt}

    return G.programs(params).get(key, "spec_step", inputs, body, dev, rt)


def speculative_decode_paged(params: dict, config: ChatGLM2Config, first_tok: torch.Tensor,
                             cache: PK.PagedKVCache, tokbuf: torch.Tensor, n_steps: int,
                             k: int = 8, ngram: int = 3, quant_type: str = "none",
                             dtype=torch.bfloat16, rt: TorchRuntimeConfig = _DEFAULT_RT):
    """Run ``n_steps`` greedy verify steps: ``n_steps`` replays of one
    captured step (``spec_program``), the counterpart of JAX's jitted
    speculation chunk.  Each step consumes the carried token, writes it and
    its k drafts, and advances each row by ``1 + accept`` positions (clamped
    to the table's capacity − 1).

    Returns (drafts (n, B, k), accepts (n, B), nexts (n, B), cache, tokbuf):
    step s of row b emitted ``drafts[s, b, :accepts[s, b]]`` then
    ``nexts[s, b]``; ``tokbuf`` is updated in place.  Nothing syncs to the
    host."""
    prog = spec_program(params, config, cache, tokbuf.shape[1], k, ngram, quant_type, dtype, rt)
    prog.load(tok=first_tok.to(torch.int32), lengths=cache.lengths, page_table=cache.page_table,
              tokbuf=tokbuf)
    out = prog.run(n_steps, params, cache.k_pool, cache.v_pool,
                   collect=("draft", "accept", "next"))
    tokbuf.copy_(prog.inputs["tokbuf"])
    return (out["draft"], out["accept"], out["next"],
            cache.replace(lengths=prog.inputs["lengths"].clone()), tokbuf)

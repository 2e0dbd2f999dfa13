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

Greedy rows are exact: a row accepts exactly the tokens step-by-step greedy
decoding would have produced; a row with no n-gram match drafts the
impossible token −1 and degrades to a plain decode step.  Sampled rows
(temperature > 0; ``sampling``) accept by exact rejection sampling against
the top-k / top-p filter (``spec_accept_next``): their streams are drawn
from exactly the per-step sampling distribution, not bit-equal to the plain
sampler's (they consume randomness differently); greedy rows keep the
argmax rule, so a mixed batch shares one program.  The draws come from a
``torch.Generator`` registered with the step's graph, so the sampled verify
step is captured like the greedy one.  Rejected positions' KV and token
writes sit above the rolled-back lengths and are overwritten later.  The
history is updated in place where the JAX code returns a new array.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..config import ChatGLM2Config, TorchRuntimeConfig
from ..ops.sampling import GREEDY, Sampling, top_p_filter
from ..utils import graphs as G
from . import paged_kv as PK

_DEFAULT_RT = TorchRuntimeConfig()


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


def draw_rows(probs: torch.Tensor, generator: Optional[torch.Generator]) -> torch.Tensor:
    """One index a row from the distributions ``probs`` (..., K) (each row
    a valid distribution), as int64 (...)."""
    K = probs.shape[-1]
    return torch.multinomial(probs.reshape(-1, K), 1, generator=generator).reshape(probs.shape[:-1])


def spec_accept_next(probs: torch.Tensor, indices: torch.Tensor, draft: torch.Tensor,
                     argm: torch.Tensor, greedy: torch.Tensor,
                     generator: Optional[torch.Generator] = None):
    """Exact speculative acceptance of point-mass drafts at one position (any
    leading shape ``...``; JAX's takes (B,)).

    ``probs`` / ``indices`` (..., K): the row's target filtered distribution
    (``ops.sampling.top_p_filter``); ``draft`` (...) the proposed token;
    ``argm`` (...) the greedy argmax; ``greedy`` (...) bool.  A sampled row
    accepts the draft d with probability p(d) and, where this position ends
    the cascade, emits a draw from p restricted to x ≠ d (the rejection
    residual: for a deterministic draft q = δ_d the accepted / residual
    mixture is exactly p); a greedy row accepts iff argm == draft and emits
    argm.  Draws: one uniform a row, then one residual index a row, from
    ``generator``.  Returns (accept (...) bool, stop_next (...) int32)."""
    is_draft = indices == draft[..., None].to(indices.dtype)
    p_d = torch.where(is_draft, probs, 0.0).sum(dim=-1)
    u = torch.rand(p_d.shape, generator=generator, device=probs.device)
    accept_s = u < p_d
    resid = torch.where(is_draft, 0.0, probs)
    rsum = resid.sum(dim=-1, keepdim=True)
    # p(d) == 1 empties the residual: acceptance then fires almost surely,
    # and the (never emitted) fallback only needs to be a distribution
    resid = torch.where(rsum > 0, resid / rsum.clamp_min(1e-30), 1.0 / probs.shape[-1])
    resample = indices.gather(-1, draw_rows(resid, generator)[..., None])[..., 0]
    accept = torch.where(greedy, argm == draft, accept_s)
    stop_next = torch.where(greedy, argm.to(resample.dtype), resample).to(torch.int32)
    return accept, stop_next


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
                 rt: TorchRuntimeConfig = _DEFAULT_RT, sampling: Sampling = GREEDY):
    """One verify step of ``speculative_decode_paged`` as a step program
    (utils/graphs.py) over ``cache``'s pools, at its batch and table width,
    with a token history of ``T`` columns: static "tok", "lengths" (B,)
    int32, "page_table" (B, MP) int32 and "tokbuf" (B, T) int32, and with a
    "rows" ``sampling`` its per-row buffers ("temperature", "top_p",
    "top_k_limit"; greedy where the temperature is 0).  Each step writes the
    next token into "tok", the advanced lengths into "lengths" and the
    step's tokens into "tokbuf", and returns "draft" (B, k), "accept" and
    "next" (B,).  The sampled form draws from ``sampling.generator``,
    registered with the graph.  Call its steps with ``(params, cache.k_pool,
    cache.v_pool)``."""
    KT = k + 1
    B, MP = cache.page_table.shape
    dev = cache.k_pool.device
    sampled = sampling.mode == "rows"
    key = ("spec_step", G.tensor_key(cache.k_pool), G.tensor_key(cache.v_pool), B, MP, T, k,
           ngram, G.static_key(config, quant_type, dtype, rt), sampling.key)

    def inputs():
        return {"tok": torch.zeros((B,), dtype=torch.int32, device=dev),
                "lengths": torch.zeros((B,), dtype=torch.int32, device=dev),
                "page_table": torch.zeros((B, MP), dtype=torch.int32, device=dev),
                "tokbuf": torch.zeros((B, T), dtype=torch.int32, device=dev),
                "full": torch.full((B,), KT, dtype=torch.int32, device=dev),
                **sampling.row_buffers(B, dev)}

    def accept_sampled(inp, all_logits, draft, argm):
        """Per position: rejection sampling on the sampled rows, the argmax
        rule on the greedy ones; position k ends an all-accepted cascade
        with a plain draw (greedy rows: the argmax)."""
        temperature = inp["temperature"]
        greedy = temperature <= 0
        safe_t = torch.where(greedy, torch.ones_like(temperature), temperature)
        probs, indices = top_p_filter(all_logits, sampling.top_k, inp["top_p"][:, None, None],
                                      safe_t[:, None, None],
                                      inp["top_k_limit"][:, None, None])  # (B, KT, K)
        eq, stops = spec_accept_next(probs[:, :k], indices[:, :k], draft, argm[:, :k],
                                     greedy[:, None], sampling.generator)
        full = indices[:, k].gather(1, draw_rows(probs[:, k], sampling.generator)[:, None])
        last = torch.where(greedy, argm[:, k], full[:, 0].to(torch.int32))
        return eq, torch.cat([stops, last[:, None]], dim=1)

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
        if sampled:
            eq, stops = accept_sampled(inp, all_logits, draft, argm)
        else:
            eq, stops = argm[:, :k] == draft, argm
        accept = eq.to(torch.int32).cumprod(dim=1).sum(dim=1)
        nxt = stops.gather(1, accept[:, None].long())[:, 0]
        # past the capacity the writes clamp and the host rolls the tokens
        # back, so the lengths clamp too
        l0.copy_((l0 + 1 + accept).clamp(max=cache.max_length - 1))
        tok.copy_(nxt)
        return {"draft": draft, "accept": accept.to(torch.int32), "next": nxt}

    return G.programs(params).get(key, "spec_step", inputs, body, dev, rt, sampling.generator)


def speculative_decode_paged(params: dict, config: ChatGLM2Config, first_tok: torch.Tensor,
                             cache: PK.PagedKVCache, tokbuf: torch.Tensor, n_steps: int,
                             k: int = 8, ngram: int = 3, quant_type: str = "none",
                             dtype=torch.bfloat16, rt: TorchRuntimeConfig = _DEFAULT_RT,
                             generator: Optional[torch.Generator] = None, sampling=None,
                             top_k: int = 100):
    """Run ``n_steps`` verify steps: ``n_steps`` replays of one captured
    step (``spec_program``), the counterpart of JAX's jitted speculation
    chunk.  Each step consumes the carried token, writes it and its k
    drafts, and advances each row by ``1 + accept`` positions (clamped to
    the table's capacity − 1).

    Greedy by default.  With ``sampling`` = (temperature (B,), top_p (B,),
    top_k_limit (B,)) and a ``generator``, rows with temperature > 0 accept
    by exact rejection sampling against the top-k / top-p filter of sort
    width ``top_k`` (``spec_accept_next``; JAX's ``rng`` + ``sampling``),
    and temperature-0 rows keep the greedy rule.

    Returns (drafts (n, B, k), accepts (n, B), nexts (n, B), cache, tokbuf):
    step s of row b emitted ``drafts[s, b, :accepts[s, b]]`` then
    ``nexts[s, b]``; ``tokbuf`` is updated in place.  Nothing syncs to the
    host."""
    sampler = GREEDY
    if sampling is not None:
        if generator is None:
            raise ValueError("sampled speculation needs a generator")
        sampler = Sampling("rows", top_k, any_sampled=True, generator=generator)
    prog = spec_program(params, config, cache, tokbuf.shape[1], k, ngram, quant_type, dtype, rt,
                        sampler)
    prog.load(tok=first_tok.to(torch.int32), lengths=cache.lengths, page_table=cache.page_table,
              tokbuf=tokbuf)
    if sampling is not None:
        temperature, top_p, top_k_limit = sampling
        prog.load(temperature=temperature, top_p=top_p, top_k_limit=top_k_limit)
    out = prog.run(n_steps, params, cache.k_pool, cache.v_pool,
                   collect=("draft", "accept", "next"))
    tokbuf.copy_(prog.inputs["tokbuf"])
    return (out["draft"], out["accept"], out["next"],
            cache.replace(lengths=prog.inputs["lengths"].clone()), tokbuf)

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


def speculative_decode_paged(params: dict, config: ChatGLM2Config, first_tok: torch.Tensor,
                             cache: PK.PagedKVCache, tokbuf: torch.Tensor, n_steps: int,
                             k: int = 8, ngram: int = 3, quant_type: str = "none",
                             dtype=torch.bfloat16, rt: TorchRuntimeConfig = _DEFAULT_RT):
    """Run ``n_steps`` greedy verify steps.  Each step consumes the carried
    token, writes it and its k drafts, and advances each row by
    ``1 + accept`` positions (clamped to the table's capacity − 1).

    Returns (drafts (n, B, k), accepts (n, B), nexts (n, B), cache, tokbuf):
    step s of row b emitted ``drafts[s, b, :accepts[s, b]]`` then
    ``nexts[s, b]``.  Nothing syncs to the host."""
    KT = k + 1
    B = first_tok.shape[0]
    dev = first_tok.device
    tok = first_tok.to(torch.int32)
    full = torch.full((B,), KT, dtype=torch.int32, device=dev)
    drafts, accepts, nexts = [], [], []
    for _ in range(n_steps):
        l0 = cache.lengths
        # the pending token joins the searched history (the n-gram tail ends
        # with it)
        _write_token_rows(tokbuf, tok[:, None], l0)
        draft = find_drafts(tokbuf, l0 + 1, ngram, k)
        safe_seq = torch.cat([tok[:, None], draft.clamp(min=0)], dim=1)
        _write_token_rows(tokbuf, safe_seq[:, 1:], l0 + 1)
        all_logits, cache = PK.prefill_chunk_paged(
            params, config, safe_seq, l0, full, cache, quant_type, dtype, rt,
            return_all_logits=True, page_aligned=False)
        argm = all_logits.argmax(dim=-1).to(torch.int32)  # (B, KT)
        accept = (argm[:, :k] == draft).to(torch.int32).cumprod(dim=1).sum(dim=1)
        nxt = argm.gather(1, accept[:, None].long())[:, 0]
        # past the capacity the writes clamp and the host rolls the tokens
        # back, so the lengths clamp too
        new_len = (l0 + 1 + accept).clamp(max=cache.max_length - 1).to(torch.int32)
        cache = cache.replace(lengths=new_len)
        drafts.append(draft)
        accepts.append(accept.to(torch.int32))
        nexts.append(nxt)
        tok = nxt
    return (torch.stack(drafts), torch.stack(accepts), torch.stack(nexts), cache, tokbuf)

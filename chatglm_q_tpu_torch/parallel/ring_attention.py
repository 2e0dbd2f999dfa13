"""Ring attention: causal attention with the keys and values split by
sequence over the model axis — the counterpart of
chatglm_q_tpu/parallel/ring_attention.py, in plain PyTorch as JAX's is plain
``jnp`` (no kernel).

Each rank holds one sequence shard of K and V (rank m: positions m·S_loc ..
(m + 1)·S_loc − 1).  Its queries attend the shard it holds while the shards
pass around the ring (``Mesh.ring_shift``), tp − 1 passes, and an online
softmax in f32 merges the steps exactly (``_ring_attention_local``,
:30-93): masked probabilities are zeroed, so a row with no valid key gives
0.  The queries are any of the rank's: JAX's sequence shard of every head
(``ring_attention``), or, in the model (``kv_shard_t`` prefill), the rank's
own heads at every position, which feed its slice of o_proj directly.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

MASK_VALUE = -1e30


def ring_attention_local(q, q_pos, k, v, lengths, mesh, sm_scale: float, kv_groups=None):
    """q (B, Sq, Gq, Hq, D) at absolute positions ``q_pos`` (Sq,); k, v (B,
    S_loc, G, D) this rank's sequence shard; ``kv_groups`` the slice of G
    the q groups read (default: all, Gq == G); lengths (B,) the rows' valid
    lengths.  Causal: query t attends key slots j ≤ t with j < lengths[b].
    Returns (B, Sq, Gq, Hq, D) in q's dtype."""
    n, idx = mesh.n_model, mesh.model_index
    B, Sq, Gq, Hq, D = q.shape
    S_loc = k.shape[1]
    if kv_groups is None:
        kv_groups = slice(0, k.shape[2])
    qf = q.float()
    lens = lengths.long()
    m = torch.full((B, Gq, Hq, Sq, 1), float("-inf"), device=q.device)
    l = torch.zeros((B, Gq, Hq, Sq, 1), device=q.device)
    acc = torch.zeros((B, Gq, Hq, Sq, D), device=q.device)
    k_cur, v_cur = k, v
    for t in range(n):
        src = (idx - t) % n  # the shard held at this step
        kv_pos = src * S_loc + torch.arange(S_loc, device=q.device)
        kc = k_cur[:, :, kv_groups].float()
        vc = v_cur[:, :, kv_groups].float()
        s = torch.einsum("bsghd,btgd->bghst", qf, kc) * sm_scale
        mask = ((kv_pos[None, None, :] <= q_pos[None, :, None])
                & (kv_pos[None, None, :] < lens[:, None, None]))  # (B, Sq, S_loc)
        s = s.masked_fill(~mask[:, None, None], MASK_VALUE)
        m_next = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_next)
        p = torch.exp(s - m_next) * mask[:, None, None]
        l = alpha * l + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.einsum("bghst,btgd->bghsd", p, vc)
        m = m_next
        if t < n - 1:  # no pass after the last step
            k_cur = mesh.ring_shift(k_cur, "model")
            v_cur = mesh.ring_shift(v_cur, "model")
    out = acc / torch.where(l == 0, 1.0, l)
    return out.permute(0, 3, 1, 2, 4).to(q.dtype)


def ring_attention(q, k, v, lengths, mesh, sm_scale: Optional[float] = None):
    """JAX's ``ring_attention`` on one rank: q (B, S_loc, G, Hg, D), k, v (B,
    S_loc, G, D) the rank's sequence shards (positions m·S_loc ..); returns
    its shard of the exact causal MQA attention output."""
    S_loc, D = q.shape[1], q.shape[-1]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(D)
    q_pos = mesh.model_index * S_loc + torch.arange(S_loc, device=q.device)
    return ring_attention_local(q, q_pos, k, v, lengths, mesh, sm_scale)

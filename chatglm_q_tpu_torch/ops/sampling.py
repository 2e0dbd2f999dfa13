"""Token sampling: greedy, and the reference's top-p sampler.

The counterpart of chatglm_q_tpu/ops/sampling.py: softmax(logits/T) →
top-k → zero the tokens where (cumsum − prob) > top_p (always keeping the
first) → renormalize → one multinomial draw.  Draws come from an explicit
``torch.Generator``; they cannot equal the JAX package's (the two RNGs
differ), only their distribution can.

``Sampling`` names a decode program's sampler (utils/graphs.py): greedy, or
per-row settings read from the program's static buffers ("temperature",
"top_p", "top_k_limit"), as the engines' rows mix greedy and top-p
requests; one setting for every row fills the buffers alike.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch


def top_p_filter(logits: torch.Tensor, top_k: int = 100, top_p: float = 0.8,
                 temperature: float = 1.0,
                 top_k_limit: torch.Tensor | None = None):
    """Returns (probs (..., top_k) summing to 1, vocab indices (..., top_k)).
    ``top_k_limit`` (..., 1) narrows k per row."""
    probs = torch.softmax(logits.float() / temperature, dim=-1)
    probs, indices = torch.topk(probs, top_k, dim=-1)  # sorted descending
    if top_k_limit is not None:
        pos = torch.arange(top_k, device=probs.device)
        probs = torch.where(pos < top_k_limit, probs, 0.0)
    cumsum = torch.cumsum(probs, dim=-1)
    probs = torch.where((cumsum - probs) > top_p, 0.0, probs)
    probs = probs / probs.sum(dim=-1, keepdim=True)
    return probs, indices


def top_p_sampling(logits: torch.Tensor, top_k: int = 100, top_p: float = 0.8,
                   temperature: float = 1.0,
                   top_k_limit: torch.Tensor | None = None,
                   generator: torch.Generator | None = None) -> torch.Tensor:
    """Sample token ids (...,) int32 from logits (...,  V)."""
    probs, indices = top_p_filter(logits, top_k, top_p, temperature, top_k_limit)
    flat = probs.reshape(-1, top_k)
    choice = torch.multinomial(flat, 1, generator=generator)
    choice = choice.reshape(*probs.shape[:-1], 1)
    return torch.gather(indices, -1, choice)[..., 0].to(torch.int32)


def greedy_sampling(logits: torch.Tensor) -> torch.Tensor:
    return torch.argmax(logits, dim=-1).to(torch.int32)


def sample_rows(logits: torch.Tensor, temperature: torch.Tensor, top_p: torch.Tensor,
                top_k_limit: torch.Tensor, any_sampled: bool, top_k: int,
                generator: Optional[torch.Generator]) -> torch.Tensor:
    """Per-row greedy (temperature 0) or top-p sampling (B,) int32; the
    top-p pass runs only where some row samples (``any_sampled``), with a
    sort width of ``top_k`` narrowed per row to ``top_k_limit``."""
    nxt = greedy_sampling(logits)
    if any_sampled:
        safe_t = torch.where(temperature > 0, temperature, torch.ones_like(temperature))
        sampled = top_p_sampling(logits, top_k, top_p[:, None], safe_t[:, None],
                                 top_k_limit=top_k_limit[:, None], generator=generator)
        nxt = torch.where(temperature > 0, sampled, nxt)
    return nxt


class Sampling(NamedTuple):
    """A decode program's sampler.  mode "greedy", or "rows": per-row
    settings read from the program's static buffers, ``top_k`` the sort
    width, the top-p pass only when ``any_sampled``.  One top-p setting for
    every row is "rows" with the buffers filled alike (``fill_rows``), so
    one program serves every temperature.  Draws come from ``generator``."""
    mode: str = "greedy"
    top_k: int = 100
    any_sampled: bool = False
    generator: Optional[torch.Generator] = None

    @property
    def key(self) -> tuple:
        return (self.mode, self.top_k, self.any_sampled,
                None if self.generator is None else id(self.generator))

    def row_buffers(self, batch: int, device) -> dict:
        """The static buffers a "rows" sampler reads."""
        if self.mode != "rows":
            return {}
        return {"temperature": torch.zeros((batch,), dtype=torch.float32, device=device),
                "top_p": torch.ones((batch,), dtype=torch.float32, device=device),
                "top_k_limit": torch.ones((batch,), dtype=torch.int32, device=device)}

    def __call__(self, logits: torch.Tensor, buffers: dict) -> torch.Tensor:
        if self.mode == "greedy":
            return greedy_sampling(logits)
        return sample_rows(logits, buffers["temperature"], buffers["top_p"],
                           buffers["top_k_limit"], self.any_sampled, self.top_k, self.generator)


def top_p_rows(top_k: int, generator: Optional[torch.Generator]) -> Sampling:
    """The sampler of one top-p setting for every row (see ``fill_rows``)."""
    return Sampling("rows", top_k, any_sampled=True, generator=generator)


def fill_rows(buffers: dict, top_k: int, top_p: float, temperature: float) -> None:
    """Every row of a "rows" sampler's buffers to one top-p setting."""
    buffers["temperature"].fill_(temperature)
    buffers["top_p"].fill_(top_p)
    buffers["top_k_limit"].fill_(top_k)


GREEDY = Sampling()

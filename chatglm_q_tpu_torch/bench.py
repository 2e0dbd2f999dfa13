"""Random full-size weights built on the card, and the decode throughput
they give.

``random_quantized_params`` builds the JAX package's param tree with random
packed weights (the shapes, dtypes and bytes of a real checkpoint, with
``int4_storage_k`` padding and the lm_head padded to 65536, the padding
filled as the loader fills it) straight on the device — no float weights,
no quantize pass, no host copy.  The root
``chip_smoke.py`` drives ``decode_rate`` with them on the card.
"""
from __future__ import annotations

import math

import torch

from .config import ChatGLM2Config, TorchRuntimeConfig, resolve_device
from .ops.quant import LMHEAD_N_MULTIPLE, int4_storage_k


def grid_std(qmax: int) -> float:
    """Standard deviation of the uniform integers in [-qmax, qmax]."""
    return math.sqrt(((2 * qmax + 1) ** 2 - 1) / 12)


def unit_gain_scale(k: int, qmax: int) -> float:
    """The mean scale that gives a (k, n) linear of uniform grid values gain
    about 1: outputs of the input's RMS.  A larger gain compounds through
    the layers (q·k scores of std ~7 at 6B widths for a gain of 2.75), the
    softmax turns near-hard, and a one-ulp bf16 difference upstream flips
    which key wins: two correct paths then differ by up to a tenth of
    max|logits| at depth 2."""
    return 1.0 / (math.sqrt(k) * grid_std(qmax))


def random_quantized_params(config: ChatGLM2Config, quant_type: str,
                            generator: torch.Generator, device=None) -> dict:
    """Random params in the port's tree, made on ``device`` (None = CUDA)
    from ``generator`` (which must live on that device)."""
    device = resolve_device(device)
    H, I = config.hidden_size, config.inner_hidden_size
    V, L = config.vocab_size, config.num_layers

    def grid(shape, qmax):
        """Uniform values of the symmetric RTN grid [-qmax, qmax], int8.  Its
        mean is 0: random bytes (int4 nibbles in [-8, 7]) have a mean that
        adds one common component to every output, onto which the whole
        model collapses (every greedy token the same)."""
        return torch.randint(-qmax, qmax + 1, shape, dtype=torch.int8, device=device,
                             generator=generator)

    def pack4(q):
        """(.., K, N) grid values → (.., K/2, N) bytes, K row 2i in the low
        nibble (ops/quant.py)."""
        u = (q & 0xF).to(torch.uint8)
        return u[..., 0::2, :] | (u[..., 1::2, :] << 4)

    def normal(shape, std):
        return (torch.randn(shape, device=device, generator=generator) * std).to(torch.bfloat16)

    def scales(shape, dtype, mean):
        # random per group / channel, in [0.5, 1.5) * mean: a scale read from
        # the wrong group or column changes the output
        u = torch.rand(shape, device=device, generator=generator)
        return (mean * (0.5 + u)).to(dtype)

    def linear(k, n, lead, bias=False, ks=None, ns=None):
        """A (k, n) linear stored as (ks, ns): the storage padding holds what
        the loader pads with (zero weights, scale 1.0), so the tree is one a
        checkpoint could load into, and a padded column computes 0.  Its gain
        is about 1 (``unit_gain_scale``)."""
        ks, ns = ks or k, ns or n
        if quant_type == "int4g32":
            p = {"weight": pack4(grid((*lead, ks, ns), 7)),  # tpu order
                 "weight_scale": scales((*lead, ks // 32, ns), torch.bfloat16,
                                        unit_gain_scale(k, 7))}
            p["weight"][..., k // 2:, :] = 0
            p["weight"][..., n:] = 0
            p["weight_scale"][..., k // 32:, :] = 1.0
            p["weight_scale"][..., n:] = 1.0
        elif quant_type == "int8":
            p = {"weight": grid((*lead, ks, ns), 127),
                 "weight_scale": scales((*lead, ns), torch.float32, unit_gain_scale(k, 127))}
            p["weight"][..., k:, :] = 0
            p["weight"][..., n:] = 0
            p["weight_scale"][..., n:] = 1.0
        else:
            p = {"weight": normal((*lead, ks, ns), k ** -0.5)}
        if bias:
            p["bias"] = torch.zeros((*lead, ns), dtype=torch.bfloat16, device=device)
        return p

    def layer_linear(k, n, bias=False):
        # storage padding: 13696 → 13824 on K (w_out) and on N (the w_in halves)
        return linear(k, n, (L,), bias, int4_storage_k(k), int4_storage_k(n))

    vp = V
    if quant_type != "none" and V >= LMHEAD_N_MULTIPLE:
        vp = -(-V // LMHEAD_N_MULTIPLE) * LMHEAD_N_MULTIPLE  # 65024 → 65536

    # embeddings of about unit RMS, the scale of what the layers add to them
    if quant_type == "int4g32":
        emb = {"weight": pack4(grid((V, H), 7) + 8),  # reference order
               "weight_scale": scales((V // 32, H), torch.float32, 1 / grid_std(7))}
    elif quant_type == "int8":
        emb = {"weight": grid((V, H), 127),
               "weight_scale": scales((H,), torch.float32, 1 / grid_std(127))}
    else:
        emb = {"weight": normal((V, H), 1.0)}

    ones = lambda *shape: torch.ones(shape, dtype=torch.bfloat16, device=device)  # noqa: E731
    return {
        "word_embedding": emb,
        "layers": {
            "attn_ln": {"weight": ones(L, H)},
            "ffn_ln": {"weight": ones(L, H)},
            "q_proj": layer_linear(H, config.q_size, bias=True),
            "kv_proj": layer_linear(H, 2 * config.kv_size, bias=True),
            "o_proj": layer_linear(config.q_size, H),
            "w_in_h": layer_linear(H, I),
            "w_in_gate": layer_linear(H, I),
            "w_out": layer_linear(I, H),
        },
        "final_ln": {"weight": ones(H)},
        "lm_head": linear(H, V, (), ks=int4_storage_k(H), ns=vp),
    }


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def weight_bytes_per_token(params: dict) -> int:
    """Bytes every decode step must read: all layer, final-norm and lm_head
    weights."""
    return sum(t.numel() * t.element_size()
               for sub in (params["layers"], params["lm_head"], params["final_ln"])
               for t in _leaves(sub))


def decode_rate(params: dict, config: ChatGLM2Config, quant_type: str, batch: int,
                prompt_len: int, cache_len: int, rt: TorchRuntimeConfig,
                seed: int = 1, n_small: int = 4, n_large: int = 20) -> dict:
    """Prefill ``batch`` random prompts of ``prompt_len`` tokens, then time
    greedy decode steps by the slope between two step counts."""
    from .models import chatglm2 as M
    from .utils.timing import slope_time, wall_s

    dev = params["final_ln"]["weight"].device
    gen = torch.Generator(device=dev).manual_seed(seed)
    ids = torch.randint(0, config.vocab_size, (batch, prompt_len), device=dev, generator=gen)
    lengths = torch.full((batch,), prompt_len, dtype=torch.int32, device=dev)
    cache = M.init_kv_cache(config, batch, cache_len, torch.bfloat16, device=dev)

    def run_prefill():
        return M.prefill(params, config, ids, lengths, cache, quant_type, torch.bfloat16, rt)

    logits, cache = run_prefill()
    prefill_s = wall_s(run_prefill)
    first = torch.argmax(logits, -1).to(torch.int32)

    def run_n(n):
        c = M.KVCache(cache.k, cache.v, cache.lengths.clone())
        M.multi_step_decode(params, config, first, c, n, None, quant_type, torch.bfloat16, rt)

    per_step = slope_time(run_n, n_small, n_large)
    return {"batch": batch, "prompt_len": prompt_len, "prefill_ms": prefill_s * 1e3,
            "decode_ms_per_step": per_step * 1e3, "tok_per_s": batch / per_step}

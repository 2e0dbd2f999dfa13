"""The decode step's kernel entry points as ``torch.library`` custom ops, for
``torch.export`` (examples/export.py, the counterpart of the JAX package's
``jax.export`` of the decode step).

``torch.export`` traces with fake tensors and cannot follow a ctypes
launch.  So while it traces (``torch.compiler.is_exporting()``) the
wrappers of the kernels a decode step runs hand a CUDA tensor to their op
here instead: ``chatglm_q_tpu_torch::int4g32_matmul`` (B1/B2),
``::int8_matmul`` (B6), ``::rope_kv_append`` (B3 with the RoPE; its cache
writes declared in ``mutates_args``) and ``::flash_attention_decode``
(B4).  Each op's fake gives the output's shape; its implementation is the
wrapper itself, so a reloaded program launches the same kernels as the
eager step (the plain versions on the CPU).  Outside an export nothing
routes here: the eager and captured programs call the wrappers as before.
Import this module before ``torch.export.load`` of such a program.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.library import custom_op

NAMESPACE = "chatglm_q_tpu_torch"


@custom_op(f"{NAMESPACE}::int4g32_matmul", mutates_args=())
def int4g32_matmul(x: torch.Tensor, packed: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    from .quant_matmul import int4g32_matmul as wrapper

    return wrapper(x, packed, scale)


@int4g32_matmul.register_fake
def _(x, packed, scale):
    return x.new_empty((x.shape[0], packed.shape[1]))


@custom_op(f"{NAMESPACE}::int8_matmul", mutates_args=())
def int8_matmul(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    from .int8_matmul import int8_matmul as wrapper

    return wrapper(x, w, scale)


@int8_matmul.register_fake
def _(x, w, scale):
    return x.new_empty((x.shape[0], w.shape[1]))


@custom_op(f"{NAMESPACE}::rope_kv_append", mutates_args=("k_cache", "v_cache"))
def rope_kv_append(q: torch.Tensor, kv: torch.Tensor, freqs: torch.Tensor,
                   k_cache: torch.Tensor, v_cache: torch.Tensor, layer: int,
                   starts: torch.Tensor, page_table: Optional[torch.Tensor]) -> torch.Tensor:
    from .attention import rope_kv_append as wrapper

    return wrapper(q, kv, freqs, k_cache, v_cache, layer, starts, page_table)


@rope_kv_append.register_fake
def _(q, kv, freqs, k_cache, v_cache, layer, starts, page_table):
    return torch.empty_like(q, memory_format=torch.contiguous_format)


@custom_op(f"{NAMESPACE}::flash_attention_decode", mutates_args=())
def flash_attention_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           lengths: torch.Tensor, sm_scale: float) -> torch.Tensor:
    from .attention import flash_attention_decode as wrapper

    return wrapper(q, k, v, lengths, sm_scale)


@flash_attention_decode.register_fake
def _(q, k, v, lengths, sm_scale):
    return torch.empty_like(q, memory_format=torch.contiguous_format)


def op(name: str):
    """The custom op ``name`` of this namespace (registered on import)."""
    return getattr(getattr(torch.ops, NAMESPACE), name)

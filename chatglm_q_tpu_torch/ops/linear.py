"""Quantized/dense linear layers and the embedding lookup.

The counterpart of chatglm_q_tpu/ops/linear.py, with its dispatch
(:65-234):

* int8 → B6 (ops/int8_matmul.py), or B7 (ops/dyn_matmul.py) under
  ``rt.dynamic_int8``;
* int4g32 → B1/B2 (ops/quant_matmul.py), or B8 under ``rt.dynamic_int8``
  when the call has at most ``_INT4_DYN_M_MAX`` rows.

Where a dynamic kernel's shape gate refuses (``*_dyn_supported``), the call
takes the weight-only kernel, as JAX's does.  ``rt.kernels_enabled`` picks
the kernel wrappers or the plain versions of the same functions.

Autograd (JAX's ``custom_vjp``, :75-178): where ``x`` needs a gradient, the
quantized matmul runs inside ``QuantMatmul``, whose backward sends the
gradient to ``x`` only (the packed weights, scales and biases stay frozen)
through the weight-only transposed kernel — B13 (``int8_matmul_t``) or B14
(``int4g32_matmul_t``), also under ``dynamic_int8``, as JAX's
``_int8_matmul_bwd`` / ``_int4_matmul_bwd`` do — and strips the storage
padding from grad_x.  Without a gradient (serving) the forward is called
directly.  ``quant_type="none"`` is a plain ``x @ w`` that autograd
differentiates.

The JAX package's ``StackedWeight`` and its ``_idx`` kernel variants exist
because XLA copies a sliced layer; in PyTorch ``stack[l]`` is a contiguous
view, so the layer loop passes each layer's views and the kernel reads them
in place.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..config import TorchRuntimeConfig
from . import dyn_matmul as D
from . import quant as Q
from .int8_matmul import int8_matmul, int8_matmul_plain, int8_matmul_t, int8_matmul_t_plain
from .quant_matmul import (int4g32_matmul, int4g32_matmul_plain, int4g32_matmul_t,
                           int4g32_matmul_t_plain)

_DEFAULT_RT = TorchRuntimeConfig()

# int4-dyn ceiling of chatglm_q_tpu/ops/linear.py:55-58, measured on the
# TPU.  It decides which numerics a call gets, so it stays as it is to keep
# the port's outputs equal to JAX's; PERF.md has the H100's crossover.
_INT4_DYN_M_MAX = 64


def _pad_x_to_storage(x2: torch.Tensor, k_storage: int) -> torch.Tensor:
    """Zero-pad activation columns up to the weight's storage K (padded
    weight rows dequantize to 0, so the result is exact)."""
    if x2.shape[1] < k_storage:
        x2 = F.pad(x2, (0, k_storage - x2.shape[1]))
    return x2


class QuantMatmul(torch.autograd.Function):
    """y = fwd(x zero-padded to the storage K, w, scale); grad_x =
    bwd(g, w, scale) with the padding columns stripped.  No gradient for
    w or scale."""

    @staticmethod
    def forward(ctx, x2, w, scale, k_storage, fwd, bwd):
        ctx.save_for_backward(w, scale)
        ctx.k, ctx.bwd = x2.shape[1], bwd
        return fwd(_pad_x_to_storage(x2, k_storage), w, scale)

    @staticmethod
    def backward(ctx, g):
        w, scale = ctx.saved_tensors
        gx = ctx.bwd(g.contiguous(), w, scale)[:, : ctx.k]
        return gx, None, None, None, None, None


def _quant_matmul(x2, w, scale, k_storage, fwd, bwd):
    if x2.requires_grad and torch.is_grad_enabled():
        return QuantMatmul.apply(x2, w, scale, k_storage, fwd, bwd)
    return fwd(_pad_x_to_storage(x2, k_storage), w, scale)


def quant_linear(x: torch.Tensor, params: dict, quant_type: str,
                 rt: TorchRuntimeConfig = _DEFAULT_RT) -> torch.Tensor:
    """Apply a (possibly quantized) linear layer to ``x (..., K)``.

    ``params`` layouts (see ops/quant.py):
      none:    {"weight": (K, N) float, "bias"?}
      int8:    {"weight": (Ks, N) int8, "weight_scale": (N,), "bias"?}
      int4g32: {"weight": (Ks//2, N) uint8 tpu order, "weight_scale": (Ks//32, N), "bias"?}
    """
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    kernels = rt.kernels_enabled(x.device)
    if quant_type == "none":
        y = x2 @ params["weight"].to(x.dtype)
    elif quant_type == "int8":
        w, scale = params["weight"], params["weight_scale"]
        if rt.dynamic_int8 and D.int8_dyn_supported(w.shape[0], w.shape[1]):
            fn = D.int8_dyn_matmul if kernels else D.int8_dyn_matmul_plain
        else:
            fn = int8_matmul if kernels else int8_matmul_plain
        bwd = int8_matmul_t if kernels else int8_matmul_t_plain
        y = _quant_matmul(x2, w, scale, w.shape[0], fn, bwd)
    elif quant_type == "int4g32":
        packed, scale = params["weight"], params["weight_scale"]
        if (rt.dynamic_int8 and x2.shape[0] <= _INT4_DYN_M_MAX
                and D.int4_dyn_supported(2 * packed.shape[0], packed.shape[1])):
            fn = D.int4_dyn_matmul if kernels else D.int4_dyn_matmul_plain
        else:
            fn = int4g32_matmul if kernels else int4g32_matmul_plain
        bwd = int4g32_matmul_t if kernels else int4g32_matmul_t_plain
        y = _quant_matmul(x2, packed, scale, 2 * packed.shape[0], fn, bwd)
    else:
        raise NotImplementedError(f"quant_type {quant_type!r}")
    bias = params.get("bias")
    if bias is not None:
        y = y + bias.to(y.dtype)
    return y.reshape(*lead, y.shape[-1])


def quant_embedding_lookup(params: dict, ids: torch.Tensor, quant_type: str,
                           dtype=torch.float32) -> torch.Tensor:
    """Embedding lookup across quant types (int4: per-token nibble unpack)."""
    ids = ids.long()
    if quant_type == "none":
        return params["weight"][ids].to(dtype)
    if quant_type == "int8":
        return Q.embedding_lookup_int8(params, ids, dtype)
    if quant_type == "int4g32":
        return Q.embedding_lookup_int4(params, ids, dtype)
    raise NotImplementedError(f"quant_type {quant_type!r}")

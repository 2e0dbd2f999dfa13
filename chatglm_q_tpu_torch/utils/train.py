"""Fine-tuning through frozen quantized weights.

The counterpart of chatglm_q_tpu/utils/train.py.  The reference
backpropagates *through* its quantized layers (the gradient goes to the
activation only, int8/qlinear.py:42-52), so the float parameters — norms,
biases and dense layers — can be tuned while the packed weights stay
frozen.  Here that is ``partition_params`` (float leaves → trainable f32
masters, everything of a quantized layer → frozen), autograd through
``ops/linear.QuantMatmul`` (B13/B14 on the card), and a ``torch.optim``
optimizer over the trainable leaves.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from ..config import ChatGLM2Config, TorchRuntimeConfig
from ..models import chatglm2 as M


def _is_quantized(tree) -> bool:
    w = tree.get("weight")
    return isinstance(w, torch.Tensor) and not w.is_floating_point()


def partition_params(params: dict):
    """Split into (trainable, frozen) trees of the same keys, each holding
    None where the other holds the leaf.

    A quantized linear or embedding is frozen as a unit: its float
    ``weight_scale`` and ``bias`` are buffers of the packed weight (the
    reference registers them as non-trainable, int8/qlinear.py:83-87); an
    optimizer's weight decay would otherwise shrink the scales with zero
    gradient.  Trainable leaves become f32 masters (new tensors with
    ``requires_grad``): the forward casts them to the activation dtype, and
    f16/bf16 masters break Adam (grad² underflows)."""
    trainable, frozen = {}, {}
    for k, v in params.items():
        if isinstance(v, dict):
            if _is_quantized(v):
                trainable[k], frozen[k] = _nones(v), v
            else:
                trainable[k], frozen[k] = partition_params(v)
        elif v.is_floating_point():
            trainable[k] = v.detach().float().clone().requires_grad_(True)
            frozen[k] = None
        else:
            trainable[k], frozen[k] = None, v
    return trainable, frozen


def _nones(tree: dict) -> dict:
    return {k: _nones(v) if isinstance(v, dict) else None for k, v in tree.items()}


def merge_params(trainable: dict, frozen: dict) -> dict:
    """The full tree: each leaf from whichever of the two holds it."""
    return {k: merge_params(v, frozen[k]) if isinstance(v, dict) else
            (frozen[k] if v is None else v) for k, v in trainable.items()}


def trainable_leaves(trainable: dict) -> list:
    """The trainable tensors in key order: what the optimizer is built over."""
    out = []
    for v in trainable.values():
        if isinstance(v, dict):
            out.extend(trainable_leaves(v))
        elif v is not None:
            out.append(v)
    return out


def loss_and_grads(config: ChatGLM2Config, quant_type: str, trainable: dict, frozen: dict,
                   input_ids: torch.Tensor, labels: torch.Tensor, dtype=torch.bfloat16,
                   rt: Optional[TorchRuntimeConfig] = None,
                   generator: Optional[torch.Generator] = None):
    """The loss and its gradient for every trainable leaf (in
    ``trainable_leaves`` order), leaving ``.grad`` untouched."""
    params = merge_params(trainable, frozen)
    loss, _ = M.forward(params, config, input_ids, labels=labels, quant_type=quant_type,
                        dtype=dtype, rt=rt or TorchRuntimeConfig(), generator=generator)
    return loss.detach(), list(torch.autograd.grad(loss, trainable_leaves(trainable)))


def make_train_step(config: ChatGLM2Config, quant_type: str, optimizer: torch.optim.Optimizer,
                    dtype=torch.bfloat16, rt: Optional[TorchRuntimeConfig] = None) -> Callable:
    """``optimizer`` is built over ``trainable_leaves(trainable)``.  Returns
    ``train_step(trainable, frozen, input_ids, labels, generator=None) ->
    loss``: forward, backward, ``optimizer.step()`` (the trainable leaves
    update in place), ``zero_grad``.  ``generator`` turns on dropout.

    The JAX package refuses ``rt.tp_pallas`` here; the port has no such
    path."""

    def train_step(trainable, frozen, input_ids, labels, generator=None):
        loss, grads = loss_and_grads(config, quant_type, trainable, frozen, input_ids, labels,
                                     dtype, rt, generator)
        for leaf, grad in zip(trainable_leaves(trainable), grads):
            leaf.grad = grad
        optimizer.step()
        optimizer.zero_grad(set_to_none=True)
        return loss

    return train_step

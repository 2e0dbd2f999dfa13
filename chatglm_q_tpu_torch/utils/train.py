"""Fine-tuning through frozen quantized weights.

The counterpart of chatglm_q_tpu/utils/train.py.  The reference
backpropagates *through* its quantized layers (the gradient goes to the
activation only, int8/qlinear.py:42-52), so the float parameters — norms,
biases and dense layers — can be tuned while the packed weights stay
frozen.  Here that is ``partition_params`` (float leaves → trainable f32
masters, everything of a quantized layer → frozen), autograd through
``ops/linear.QuantMatmul`` (B13/B14 on the card), and a ``torch.optim``
optimizer over the trainable leaves.  Over a (data, model) mesh of ranks
the same step runs tensor and data parallel (JAX's ``make_train_step`` under
GSPMD): see ``loss_and_grads``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from ..config import ChatGLM2Config, TorchRuntimeConfig
from ..models import chatglm2 as M
from ..parallel.sharding import leaf_paths
from .distributed import local_batch_slice


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


# replicated trainable leaves whose gradient each model rank holds only in
# part: kv_proj's float weight and bias (quant_type "none") feed every
# rank's kv, whose gradient covers the groups of the rank's heads alone.  The
# norms and the embedding get the whole gradient on every rank
# (``copy_to_model`` sums the parts of their activations' gradients), so
# summing theirs would multiply them by tp.
MODEL_PARTIAL = ("kv_proj",)


def reconcile_grads(trainable: dict, grads: list, mesh) -> list:
    """A mesh rank's gradients (``trainable_leaves`` order) made whole:
    every leaf's summed over the data axis, and over the model axis those
    of ``MODEL_PARTIAL`` alone; a sharded leaf keeps the rank's part."""
    if mesh is None:
        return grads
    out = []
    paths = [p for p, v in leaf_paths(trainable) if v is not None]  # trainable_leaves' order
    for path, g in zip(paths, grads):
        g = mesh.all_reduce(g, "data")
        if any(name in path for name in MODEL_PARTIAL):
            g = mesh.all_reduce(g, "model")
        out.append(g)
    return out


def _local_rows(t: torch.Tensor, mesh) -> torch.Tensor:
    if mesh is None or mesh.n_data == 1:
        return t
    return t[local_batch_slice(t.shape[0], mesh.n_data, mesh.data_index)]


def loss_and_grads(config: ChatGLM2Config, quant_type: str, trainable: dict, frozen: dict,
                   input_ids: torch.Tensor, labels: torch.Tensor, dtype=torch.bfloat16,
                   rt: Optional[TorchRuntimeConfig] = None,
                   generator: Optional[torch.Generator] = None, mesh=None):
    """The loss and its gradient for every trainable leaf (in
    ``trainable_leaves`` order), leaving ``.grad`` untouched.

    With ``mesh`` (a ``parallel.sharding.Mesh``; ``trainable`` and
    ``frozen`` partition the rank's ``shard_params`` slice) every rank
    passes the global batch and runs its data rank's rows
    (``local_batch_slice``) tensor parallel; the loss is the mean over every
    rank's valid labels and the gradients are whole (``reconcile_grads``),
    a sharded leaf's for the rank's part."""
    rt = rt or TorchRuntimeConfig()
    if mesh is not None:
        rt = dataclasses.replace(rt, mesh=mesh)
    params = merge_params(trainable, frozen)
    loss, _ = M.forward(params, config, _local_rows(input_ids, mesh),
                        labels=_local_rows(labels, mesh), quant_type=quant_type, dtype=dtype,
                        rt=rt, generator=generator)
    grads = list(torch.autograd.grad(loss, trainable_leaves(trainable)))
    return loss.detach(), reconcile_grads(trainable, grads, mesh)


def make_train_step(config: ChatGLM2Config, quant_type: str, optimizer: torch.optim.Optimizer,
                    dtype=torch.bfloat16, rt: Optional[TorchRuntimeConfig] = None,
                    mesh=None) -> Callable:
    """``optimizer`` is built over ``trainable_leaves(trainable)``.  Returns
    ``train_step(trainable, frozen, input_ids, labels, generator=None) ->
    loss``: forward, backward, ``optimizer.step()`` (the trainable leaves
    update in place), ``zero_grad``.  ``generator`` turns on dropout.

    With ``mesh`` the step is ``loss_and_grads``' over the mesh: every rank
    passes the global batch and takes the same optimizer step on its leaves
    (the replicated ones stay equal on every rank).  The JAX package
    refuses ``rt.tp_pallas`` here (its per-shard kernels have no autodiff
    rule); the port's linears always run per shard under a mesh, and their
    backward is ``ops/linear.QuantMatmul``'s on the rank's shard."""

    def train_step(trainable, frozen, input_ids, labels, generator=None):
        loss, grads = loss_and_grads(config, quant_type, trainable, frozen, input_ids, labels,
                                     dtype, rt, generator, mesh)
        for leaf, grad in zip(trainable_leaves(trainable), grads):
            leaf.grad = grad
        optimizer.step()
        optimizer.zero_grad(set_to_none=True)
        return loss

    return train_step

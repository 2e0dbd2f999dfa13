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

``make_train_step``'s whole step (forward, backward, the optimizer's step
and ``zero_grad``) is a step program (utils/graphs.py), the counterpart of
JAX's jitted ``train_step``: on one CUDA device eager on its first call,
captured in a CUDA graph on the second, replayed after, over static
``input_ids`` and ``labels`` buffers; on the CPU its body runs eagerly
through the same buffers.  The optimizer must be capturable
(``torch.optim.AdamW(..., capturable=True)``: the step count stays on the
device).  A step with dropout, over a non-capturable optimizer or on a mesh
runs eagerly, with a stated reason (warned once).  The capture bakes in
the optimizer's float hyperparameters and the addresses of its state
(``optimizer_guard``): where a scheduler changes a float lr, or
``load_state_dict`` swaps the state, the step is captured again before it
replays; a tensor lr changes inside the one graph.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from ..config import ChatGLM2Config, TorchRuntimeConfig
from ..models import chatglm2 as M
from ..parallel.sharding import leaf_paths
from . import graphs as G
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


def step_refusal(config: ChatGLM2Config, optimizer, generator, mesh=None) -> Optional[str]:
    """Why a training step runs eagerly on CUDA (dropout, an optimizer that
    is not capturable, a mesh), or None."""
    if mesh is not None:
        return G.MESH_TRAIN_REFUSAL
    if generator is not None and config.dropout_rate > 0:
        return G.DROPOUT_REFUSAL
    if any(group.get("capturable") is False for group in optimizer.param_groups):
        return G.OPTIMIZER_REFUSAL
    return None


def _baked(v):
    """What a captured optimizer step bakes in of a setting or state value:
    a tensor's address (the graph reads its value on every replay), else
    the value itself."""
    if isinstance(v, torch.Tensor):
        return G.tensor_key(v)
    if isinstance(v, (tuple, list)):
        return tuple(_baked(x) for x in v)
    return v


def optimizer_guard(optimizer) -> tuple:
    """What a captured ``optimizer.step()`` bakes in: each group's settings
    (a float lr, betas, weight decay as values; a tensor lr by its address)
    and the addresses of its parameters and their state tensors.  It reads
    otherwise after a scheduler sets a float lr or ``load_state_dict``
    swaps the state, and then the step is captured again."""
    out = []
    for group in optimizer.param_groups:
        out.append(tuple((k, _baked(v)) for k, v in sorted(group.items()) if k != "params"))
        for p in group["params"]:
            state = optimizer.state.get(p, {})
            out.append((G.tensor_key(p),) + tuple((k, _baked(v)) for k, v in sorted(state.items())))
    return tuple(out)


def make_train_step(config: ChatGLM2Config, quant_type: str, optimizer: torch.optim.Optimizer,
                    dtype=torch.bfloat16, rt: Optional[TorchRuntimeConfig] = None,
                    mesh=None) -> Callable:
    """``optimizer`` is built over ``trainable_leaves(trainable)``.  Returns
    ``train_step(trainable, frozen, input_ids, labels, generator=None) ->
    loss``: forward, backward, ``optimizer.step()`` (the trainable leaves
    update in place), ``zero_grad``, through ``train_program``.
    ``generator`` turns on dropout.

    With ``mesh`` the step is ``loss_and_grads``' over the mesh: every rank
    passes the global batch and takes the same optimizer step on its leaves
    (the replicated ones stay equal on every rank).  The JAX package
    refuses ``rt.tp_pallas`` here (its per-shard kernels have no autodiff
    rule); the port's linears always run per shard under a mesh, and their
    backward is ``ops/linear.QuantMatmul``'s on the rank's shard."""

    rt = rt or TorchRuntimeConfig()

    def train_step(trainable, frozen, input_ids, labels, generator=None):
        prog = train_program(config, quant_type, optimizer, trainable, frozen, input_ids.shape,
                             labels.dtype, dtype, rt, generator, mesh)
        prog.load(ids=input_ids, labels=labels)
        # a copy: a captured graph's output is overwritten by the next replay
        return prog.step(trainable, frozen)["loss"].clone()

    return train_step


def train_program(config: ChatGLM2Config, quant_type: str, optimizer, trainable: dict,
                  frozen: dict, shape: tuple, labels_dtype, dtype, rt: TorchRuntimeConfig,
                  generator: Optional[torch.Generator] = None, mesh=None) -> G.StepProgram:
    """The training step as a step program (see the module note): static
    "ids" and "labels" of ``shape``; output "loss".  Call its step with
    ``(trainable, frozen)``.  The gradients are set as each leaf's
    ``.grad`` for the optimizer's step and set to None after it (in a
    capture they are the graph's temporaries)."""
    leaves = trainable_leaves(trainable)
    dev = leaves[0].device
    params = merge_params(trainable, frozen)
    key = ("train_step", id(optimizer), tuple(shape), labels_dtype,
           None if generator is None else id(generator), id(mesh),
           G.static_key(config, quant_type, dtype, rt))

    def inputs():
        return {"ids": torch.zeros(shape, dtype=torch.long, device=dev),
                "labels": torch.zeros(shape, dtype=labels_dtype, device=dev)}

    def body(inp, trainable, frozen):
        loss, grads = loss_and_grads(config, quant_type, trainable, frozen, inp["ids"],
                                     inp["labels"], dtype, rt, generator, mesh)
        for leaf, grad in zip(trainable_leaves(trainable), grads):
            leaf.grad = grad
        optimizer.step()
        optimizer.zero_grad(set_to_none=True)
        return {"loss": loss}

    refused = step_refusal(config, optimizer, generator, rt.mesh if mesh is None else mesh)
    # backward runs on autograd's device threads: capture in global mode
    return G.programs(params, "train").get(key, "train_step", inputs, body, dev, rt,
                                           refused=refused, capture_mode="global",
                                           guard=lambda: optimizer_guard(optimizer))

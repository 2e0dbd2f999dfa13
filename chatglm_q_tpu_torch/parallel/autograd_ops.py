"""The model axis' collectives as autograd functions: what lets a training
step differentiate through a tensor-parallel forward.

JAX differentiates GSPMD's collectives by itself; here each is a
``torch.autograd.Function`` over the ``Mesh`` (parallel/sharding.py), the
Megatron pair and the gather of a column-parallel output:

=================== ============================== ==========================
op                  forward                        backward
=================== ============================== ==========================
``copy_to_model``   identity                       all-reduce (sum) over model
``reduce_from_model`` all-reduce (sum) over model  identity
``gather_from_model`` all-gather of the rank's     the rank's slice of g
                    columns, in column order
=================== ============================== ==========================

A replicated activation that feeds rank-local heads or columns enters them
through ``copy_to_model``: each rank's gradient of it is partial, and the
backward sums the parts.  A row-parallel linear's partial products leave
through ``reduce_from_model``; every rank then holds the whole output and,
downstream, the whole gradient, which goes back to each rank's part as it
is.  ``reduce_from`` does the same over any axis: the training step sums
its loss over the data axis with it.  ``torch.distributed.nn.functional``'s
all-reduce and all-gather sum the gradient over the group in their
backward instead: where every rank computes the same loss that is tp times
the gradient.

The collectives run through the mesh's transport (gloo through the host,
or NCCL), in both passes; without a gradient they cost what the plain
collective does.
"""
from __future__ import annotations

import torch

from .sharding import MODEL_AXIS


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_reduce(g.contiguous(), MODEL_AXIS), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        return mesh.all_reduce(x, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def gather_columns(mesh, y: torch.Tensor) -> torch.Tensor:
    """Every model rank's columns of y (..., n) side by side (..., tp · n),
    rank order (the forward of ``gather_from_model``)."""
    parts = mesh.all_gather(y.contiguous(), MODEL_AXIS)  # (tp, ..., n)
    return parts.movedim(0, -2).reshape(*y.shape[:-1], -1)


def own_columns(mesh, g: torch.Tensor) -> torch.Tensor:
    """This rank's equal share of g's last dim (the backward of
    ``gather_from_model``)."""
    n = g.shape[-1] // mesh.n_model
    return g[..., mesh.model_index * n:(mesh.model_index + 1) * n]


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, mesh):
        ctx.mesh = mesh
        return gather_columns(mesh, y)

    @staticmethod
    def backward(ctx, g):
        return own_columns(ctx.mesh, g).contiguous(), None


def copy_to_model(x: torch.Tensor, mesh) -> torch.Tensor:
    """x as it is; its gradient summed over the model axis."""
    if mesh is None or mesh.n_model == 1:
        return x
    return _CopyToModel.apply(x, mesh)


def reduce_from(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """The sum of x over the axis' ranks; the gradient passes as it is (each
    rank's part of a sum that every rank then holds whole: a row-parallel
    product over the model axis, a loss over the data axis)."""
    if mesh is None or mesh.size(axis) == 1:
        return x
    return _ReduceFrom.apply(x, mesh, axis)


def reduce_from_model(x: torch.Tensor, mesh) -> torch.Tensor:
    """The sum of every model rank's x; the gradient passes as it is."""
    return reduce_from(x, mesh, MODEL_AXIS)


def gather_from_model(y: torch.Tensor, mesh) -> torch.Tensor:
    """Every rank's equal column part of y side by side; the gradient of
    the whole goes back as each rank's columns."""
    if mesh is None or mesh.n_model == 1:
        return y
    return _GatherFromModel.apply(y, mesh)

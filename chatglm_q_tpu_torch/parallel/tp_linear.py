"""Tensor-parallel quantized linears: the counterpart of
chatglm_q_tpu/parallel/tp_linear.py.

Each rank runs the port's own kernels (ops/linear.py's dispatch) on its
shard of the weights, placed by parallel/sharding.py:

* ``col`` (q_proj, w_in_h, w_in_gate, lm_head): x whole, the rank's output
  columns; no collective;
* ``row`` (o_proj, w_out): x the rank's slice of K (the columns the
  previous col-parallel linear gave it; the last rank's is zero-padded at
  its end to the storage K, where the global padding sits), a partial
  product, one all-reduce over the model axis (``reduce_from_model``:
  its backward passes the whole gradient to each rank's part), then the
  bias once;
* ``rep`` (kv_proj): the whole weight on every rank.

There is no GSPMD to hand a global product to, so under a mesh every linear
runs this way: JAX's ``tp_pallas=True``.  As there, an int4g32 linear takes
the weight-only kernels (its per-shard dynamic-int8 form is not carried),
an int8 linear under ``dynamic_int8`` takes B7 in col and rep mode, whose
shards see whole rows of x, and row mode refuses it: per-shard activation
scales over a K slice would be a third numerics mode (:50-60).
"""
from __future__ import annotations

import dataclasses
import functools

import torch

from ..config import TorchRuntimeConfig
from ..ops.linear import quant_linear
from .autograd_ops import reduce_from_model

MODES = ("col", "row", "rep")


@functools.lru_cache(maxsize=64)
def _weight_only(rt: TorchRuntimeConfig) -> TorchRuntimeConfig:
    return dataclasses.replace(rt, dynamic_int8=False)


def tp_quant_linear(x: torch.Tensor, params: dict, quant_type: str, rt: TorchRuntimeConfig,
                    mode: str) -> torch.Tensor:
    """x (..., K) through the rank's shard ``params`` of a linear under
    ``rt.mesh``; see the module note for ``mode``.  Returns the rank's
    columns (col) or the whole output (row, rep)."""
    if mode not in MODES:
        raise ValueError(f"tp mode {mode!r}: one of {MODES}")
    if mode == "row" and quant_type == "int8" and rt.dynamic_int8:
        raise ValueError(
            "dynamic_int8 is unsupported for row-parallel int8 linears under a mesh: "
            "per-shard activation scales over a K slice change the numerics; use "
            "weight-only int8, or dynamic_int8 on one device")
    run_rt = _weight_only(rt) if quant_type == "int4g32" and rt.dynamic_int8 else rt
    if mode != "row":
        return quant_linear(x, params, quant_type, run_rt)
    bias = params.get("bias")
    part = quant_linear(x, {k: v for k, v in params.items() if k != "bias"}, quant_type, run_rt)
    y = reduce_from_model(part, rt.mesh)
    return y if bias is None else y + bias.to(y.dtype)

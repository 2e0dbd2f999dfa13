"""Numerical-debugging helpers: the counterpart of
chatglm_q_tpu/utils/debug.py.

* ``enable_nan_checks()`` — every kernel wrapper checks its output and
  raises, naming the kernel, on a non-finite value (a sync each launch, so
  a CUDA-graph capture refuses it), and autograd's anomaly mode names the
  backward op that made one (JAX's ``jax_debug_nans``);
* ``interpret_kernels()`` — a context in which every kernel wrapper runs
  its plain PyTorch version, on any device (JAX forces the Pallas
  interpreter): the port's kernels and plain versions compute the same
  functions, so a difference inside it localizes a kernel bug;
* ``check_quant_params()`` — the shapes and dtypes of a quantized tree
  (the loader's boundary check).
"""
from __future__ import annotations

import contextlib

import torch

from ..ops import _build
from ..ops.quant import LMHEAD_N_MULTIPLE, int4_storage_k


def enable_nan_checks(enable: bool = True):
    _build.NAN_CHECKS = enable
    torch.autograd.set_detect_anomaly(enable)


@contextlib.contextmanager
def interpret_kernels():
    """Every kernel wrapper runs its plain version within the block."""
    before = _build.INTERPRET
    _build.INTERPRET = True
    try:
        yield
    finally:
        _build.INTERPRET = before


def check_quant_params(params: dict, config, quant_type: str) -> list[str]:
    """Validate a param tree's shapes/dtypes; returns a list of problems
    (empty = OK): the JAX package's checks, with torch's dtypes (uint8
    nibbles, int8)."""
    problems = []
    H, I, V = config.hidden_size, config.inner_hidden_size, config.vocab_size
    L = config.num_layers

    def expect(path, arr, shape=None, dtype=None):
        if shape is not None and tuple(arr.shape) != tuple(shape):
            problems.append(f"{path}: shape {tuple(arr.shape)} != {tuple(shape)}")
        if dtype is not None and arr.dtype != dtype:
            problems.append(f"{path}: dtype {arr.dtype} != {dtype}")

    def check_linear(path, p, k, n, stacked):
        lead = (L,) if stacked else ()
        ks = int4_storage_k(k)
        if quant_type == "int4g32":
            expect(path + ".weight", p["weight"], lead + (ks // 2, n), torch.uint8)
            expect(path + ".weight_scale", p["weight_scale"], lead + (ks // 32, n))
        elif quant_type == "int8":
            expect(path + ".weight", p["weight"], lead + (ks, n), torch.int8)
            expect(path + ".weight_scale", p["weight_scale"], lead + (n,))
        else:
            expect(path + ".weight", p["weight"], lead + (k, n))

    qs = config.q_size
    kv = config.kv_size
    lyr = params["layers"]
    check_linear("q_proj", lyr["q_proj"], H, qs, True)
    check_linear("kv_proj", lyr["kv_proj"], H, 2 * kv, True)
    check_linear("o_proj", lyr["o_proj"], qs, H, True)
    check_linear("w_in_h", lyr["w_in_h"], H, int4_storage_k(I), True)
    check_linear("w_in_gate", lyr["w_in_gate"], H, int4_storage_k(I), True)
    check_linear("w_out", lyr["w_out"], I, H, True)
    # lm_head's vocab dim may be padded to LMHEAD_N_MULTIPLE (ops/quant.lmhead_pad;
    # logits are sliced back to vocab_size at every call site)
    v_stored = params["lm_head"]["weight"].shape[-1]
    v_padded = -(-V // LMHEAD_N_MULTIPLE) * LMHEAD_N_MULTIPLE
    v_ok = v_padded if (quant_type != "none" and v_stored == v_padded) else V
    check_linear("lm_head", params["lm_head"], H, v_ok, False)
    return problems

"""GPTQ (Hessian-based) weight quantization.

The counterpart of chatglm_q_tpu/quant/gptq.py (the reference's
``GPTQLinearQuantizer`` numerics; Frantar et al., arXiv:2210.17323), with
JAX's order of operations:

* the Hessian as a running average, ``H *= n/(n+m); H += (2/(n+m)) XᵀX``,
  in float32 (``accumulate_hessian``);
* dead columns (a zero diagonal) get a diagonal of 1 and zero weights, the
  diagonal is damped by ``percdamp · mean(diag)``, and the sweep reads the
  upper Cholesky factor of H⁻¹ (``_prepare_hinv``, torch.linalg in
  float32, as JAX and the reference compute it);
* blocks of 128 columns: inside a block, each column is quantized and its
  error fed back to the block's later columns (``ops/gptq_sweep.py``: one
  CUDA launch a block, or the plain per-column loop); across blocks, one
  large product ``err @ Hinv[i1:i2, i2:]`` (torch.matmul, as JAX leaves it
  to XLA); each block's losses are halved;
* int8: a fixed per-row scale from the naive pass, taken before the dead
  columns are zeroed; int4g32: a scale recomputed at every group-of-32
  boundary from the block's current columns.

JAX solves H⁻¹ in column slabs of 1,024 (a TPU compile workaround,
gptq.py:76-80); here one ``cholesky_inverse`` does it.

The quantizer assumes IEEE float32 matmuls: TF32 off for the Hessian
product and the cross-block update (PyTorch's default; ``chip_smoke.py``
sets it off).  Weights here are (N out, K in), as the sweep walks them;
``gptq_linear_params_*`` adapt to the package's K-major param dicts.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from ..config import TorchRuntimeConfig
from ..ops import quant as Q
from ..ops.gptq_sweep import gptq_sweep_block, gptq_sweep_block_plain

_DEFAULT_RT = TorchRuntimeConfig()


# ---------------------------------------------------------------------------
# Hessian accumulation
# ---------------------------------------------------------------------------

def init_hessian(k: int, device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """A zero (K, K) f32 Hessian and its sample count (a 0-dim f32 tensor).
    ``device=None`` places both on the CPU; the calibration driver passes
    its params' device."""
    return (torch.zeros((k, k), dtype=torch.float32, device=device),
            torch.zeros((), dtype=torch.float32, device=device))


def accumulate_hessian(hessian: torch.Tensor, n_samples: torch.Tensor, x: torch.Tensor):
    """x: (..., K) activations feeding the linear; returns the updated
    (H, n): the running average with ``2/n``-scaled outer products."""
    x2 = x.reshape(-1, x.shape[-1]).float()
    new_n = n_samples + x2.shape[0]
    hessian = hessian * (n_samples / new_n) + (2.0 / new_n) * (x2.T @ x2)
    return hessian, new_n


# ---------------------------------------------------------------------------
# Shared sweep machinery
# ---------------------------------------------------------------------------

def _prepare_hinv(hessian: torch.Tensor, weight_nk: torch.Tensor, percdamp: float):
    """Dead columns, damping, and the upper Cholesky factor U of H⁻¹
    (H⁻¹ = UᵀU).  Returns (damped H, weight with dead columns zeroed, U,
    whether a factorization failed)."""
    hessian = hessian.float().clone()
    diag = hessian.diagonal()
    dead = diag == 0
    diag.copy_(torch.where(dead, 1.0, diag))
    weight_nk = torch.where(dead[None, :], 0.0, weight_nk.float())
    diag.add_(percdamp * torch.mean(diag))
    chol, info = torch.linalg.cholesky_ex(hessian)
    hinv = torch.cholesky_inverse(chol)
    upper, info_u = torch.linalg.cholesky_ex(hinv, upper=True)
    # row-major: the sweep reads its blocks a row at a time
    return hessian, weight_nk, upper.contiguous(), (info != 0) | (info_u != 0)


def _check_hinv(hinv_u: torch.Tensor, failed: torch.Tensor) -> None:
    """A numerically non-PSD Hessian would quantize the layer to garbage:
    abort with a diagnostic instead (one scalar fetch)."""
    if bool(failed) or bool(torch.isnan(hinv_u).any()):
        raise FloatingPointError(
            "GPTQ Hessian Cholesky produced NaN (non-PSD after damping) — "
            "raise percdamp or check the calibration activations")


def _block_fn(weight: torch.Tensor, rt: TorchRuntimeConfig) -> Callable:
    return gptq_sweep_block if rt.kernels_enabled(weight.device) else gptq_sweep_block_plain


def sweep(weight_nk: torch.Tensor, hinv_u: torch.Tensor, scale_n: Optional[torch.Tensor],
          blocksize: int = 128, groupsize: int = 32, block_fn: Callable = gptq_sweep_block):
    """The column sweep over blocks of ``blocksize`` (JAX's ``_sweep_int8``
    with a fixed ``scale_n``, ``_sweep_int4`` with None).  ``block_fn`` runs
    one block (``ops/gptq_sweep.py``).  Returns (grid (N, K), losses (N, K),
    scales (K / groupsize, N) or None)."""
    N, K = weight_nk.shape
    if scale_n is None and (blocksize % groupsize or K % groupsize):
        raise ValueError(f"int4 GPTQ: blocksize {blocksize} and K {K} must be multiples of "
                         f"groupsize {groupsize}")
    weight = weight_nk.float().clone()
    grid = torch.zeros_like(weight)
    losses = torch.zeros_like(weight)
    scales = []
    for i1 in range(0, K, blocksize):
        i2 = min(i1 + blocksize, K)
        out = block_fn(weight[:, i1:i2], hinv_u[i1:i2, i1:i2], scale_n, groupsize)
        grid[:, i1:i2] = out[0]
        losses[:, i1:i2] = out[2] / 2
        if scale_n is None:
            scales.append(out[3])
        weight[:, i2:] -= out[1] @ hinv_u[i1:i2, i2:]
    return grid, losses, (torch.cat(scales) if scale_n is None else None)


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------

def _naive_scale_int8(weight_nk: torch.Tensor):
    w = weight_nk.float()
    w_max = w.abs().amax(dim=1)
    scale = torch.clamp(Q.div_exact(w_max, Q.MAX_Q_INT8), min=1e-10)
    q = torch.clamp(torch.round(w / scale[:, None]), -127, 127).to(torch.int8)
    return q, scale


def gptq_quantize_int8(weight_nk, hessian, blocksize=128, percdamp=0.01,
                       rt: TorchRuntimeConfig = _DEFAULT_RT):
    """Returns (grid_weight (N, K) f32 on the int8 grid, scale (N,), mean
    quant loss)."""
    _, scale = _naive_scale_int8(weight_nk)
    _, weight_nk, hinv_u, failed = _prepare_hinv(hessian, weight_nk, percdamp)
    _check_hinv(hinv_u, failed)
    grid, losses, _ = sweep(weight_nk, hinv_u, scale, blocksize, 32, _block_fn(weight_nk, rt))
    return grid, scale, float(torch.mean(losses))


def gptq_quantize_int4(weight_nk, hessian, blocksize=128, groupsize=32, percdamp=0.01,
                       rt: TorchRuntimeConfig = _DEFAULT_RT):
    """Returns (grid_weight (N, K) f32, scales (K/groupsize, N), mean quant
    loss)."""
    _, weight_nk, hinv_u, failed = _prepare_hinv(hessian, weight_nk, percdamp)
    _check_hinv(hinv_u, failed)
    grid, losses, scales = sweep(weight_nk, hinv_u, None, blocksize, groupsize,
                                 _block_fn(weight_nk, rt))
    return grid, scales, float(torch.mean(losses))


def debug_mse(debug_input, weight_nk, grid_nk) -> float:
    """The reference's ``debug_loss``: MSE between the float layer's output
    and the grid weight's output on the last calibration activations."""
    x = debug_input.reshape(-1, debug_input.shape[-1]).float()
    ref = x @ weight_nk.float().T
    got = x @ grid_nk.T
    return float(torch.mean((got - ref) ** 2))


def gptq_linear_params_int8(w_kn, hessian, bias=None, blocksize=128, percdamp=0.01,
                            debug_input=None, rt: TorchRuntimeConfig = _DEFAULT_RT):
    """K-major in-memory int8 param dict from GPTQ.  With ``debug_input``
    returns ``(params, quant_loss, debug_loss)``: the reference's per-linear
    diagnostics."""
    grid, scale, quant_loss = gptq_quantize_int8(w_kn.T, hessian, blocksize, percdamp, rt)
    q = torch.clamp(torch.round(grid / scale[:, None]), -127, 127).to(torch.int8)
    p = {"weight": Q.pad_int8_weight(q.T.contiguous()), "weight_scale": scale}
    if bias is not None:
        p["bias"] = bias
    if debug_input is None:
        return p
    return p, quant_loss, debug_mse(debug_input, w_kn.T, grid)


def gptq_linear_params_int4(w_kn, hessian, bias=None, blocksize=128, groupsize=32,
                            percdamp=0.01, debug_input=None,
                            rt: TorchRuntimeConfig = _DEFAULT_RT):
    """K-major in-memory int4g32 param dict from GPTQ.  With ``debug_input``
    returns ``(params, quant_loss, debug_loss)``."""
    grid, scales, quant_loss = gptq_quantize_int4(w_kn.T, hessian, blocksize, groupsize,
                                                  percdamp, rt)
    qgrid = Q.quantize_with_scale_int4(grid.T, scales)
    packed, scales_p = Q.pad_packed_int4(Q.pack_int4_tpu(qgrid), scales)
    p = {"weight": packed, "weight_scale": scales_p.to(Q.SCALE_DTYPE)}
    if bias is not None:
        p["bias"] = bias
    if debug_input is None:
        return p
    return p, quant_loss, debug_mse(debug_input, w_kn.T, grid)

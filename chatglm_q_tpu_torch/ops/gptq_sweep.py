"""GPTQ's in-block column sweep: the wrapper over ``csrc/gptq.cu``'s
``gptq_sweep_kernel``, its plain version, and its launch counts.

No TPU kernel is replaced: the JAX package compiles the sweep into one XLA
program (chatglm_q_tpu/quant/gptq.py:_sweep_int8 / _sweep_int4, a
``lax.fori_loop`` over a block's columns inside a jit), with no
``pallas_call``.  Run column by column from PyTorch (the plain version
below) it takes about a dozen launches a column, so the kernel runs a whole
block of up to 128 columns in one launch: a warp a row, the block of H⁻¹'s
upper Cholesky factor in shared memory (csrc/gptq.cu says more).

``gptq_sweep_block(w_blk, hinv_blk, scale_n, groupsize)``:

* ``w_blk`` (N, bs) f32, a column slice of the weight (its rows may be
  strided); ``hinv_blk`` (bs, bs) f32, the block's diagonal block of the
  factor; bs ≤ 128 on the card;
* ``scale_n`` (N,) f32: int8 with that fixed scale; None: int4, the scale
  recomputed at every ``j % groupsize == 0`` from the block's current
  columns j .. j + groupsize − 1;
* returns ``(q_blk, err_blk, loss_blk)``, each (N, bs) f32 (the dequantized
  grid, the errors that feed the next blocks, the unhalved losses), and for
  int4 also ``scales_blk`` (bs / groupsize, N) f32.

On a CPU tensor it runs the plain version; on a CUDA tensor it launches the
kernel or raises.  The kernel is bit-equal to the plain version on the card
(the same operations, each rounded once, no FMA).
"""
from __future__ import annotations

from typing import Optional

import torch

from . import _build
from .quant import MAX_Q_INT4, MAX_Q_INT8, div_exact

SWEEP_MAX_BS = 128  # the kernel's widest block: 4 columns a lane


def gptq_sweep_block_plain(w_blk: torch.Tensor, hinv_blk: torch.Tensor,
                           scale_n: Optional[torch.Tensor] = None, groupsize: int = 32):
    """The per-column loop, a line-for-line copy of JAX's ``col_body``
    (gptq.py:104-118, :147-178); the update of columns ≥ j is applied to
    the slice ``[:, j:]``, which equals JAX's masked update bit for bit."""
    N, bs = w_blk.shape
    wblk = w_blk.float().clone()
    qblk = torch.zeros_like(wblk)
    eblk = torch.zeros_like(wblk)
    lblk = torch.zeros_like(wblk)
    int4 = scale_n is None
    if int4:
        scale = torch.ones((N,), dtype=torch.float32, device=wblk.device)
        scales_blk = torch.zeros((bs // groupsize, N), dtype=torch.float32, device=wblk.device)
        qmax = MAX_Q_INT4
    else:
        scale = scale_n.float()
        qmax = MAX_Q_INT8
    for j in range(bs):
        if int4 and j % groupsize == 0:
            w_max = wblk[:, j:j + groupsize].abs().amax(dim=1)
            scale = torch.clamp(div_exact(w_max, MAX_Q_INT4), min=1e-10)
            scales_blk[j // groupsize] = scale
        w = wblk[:, j]
        d = hinv_blk[j, j]
        qv = torch.clamp(torch.round(w / scale), -qmax, qmax)
        qd = scale * qv
        err = (w - qd) / d
        loss = (w - qd) ** 2 / d ** 2
        wblk[:, j:] -= err[:, None] * hinv_blk[j, j:][None, :]
        qblk[:, j] = qd
        eblk[:, j] = err
        lblk[:, j] = loss
    return (qblk, eblk, lblk, scales_blk) if int4 else (qblk, eblk, lblk)


def _check(w_blk, hinv_blk, scale_n, groupsize):
    if not (w_blk.is_cuda and hinv_blk.device == w_blk.device
            and (scale_n is None or scale_n.device == w_blk.device)):
        raise ValueError("gptq_sweep_block: w_blk, hinv_blk and scale_n must be on one CUDA device")
    if w_blk.dim() != 2 or hinv_blk.dim() != 2:
        raise ValueError("gptq_sweep_block: w_blk (N, bs), hinv_blk (bs, bs)")
    N, bs = w_blk.shape
    if hinv_blk.shape != (bs, bs) or not 1 <= bs <= SWEEP_MAX_BS or N < 1:
        raise ValueError(f"gptq_sweep_block: unsupported shapes w_blk {tuple(w_blk.shape)}, "
                         f"hinv_blk {tuple(hinv_blk.shape)} (bs <= {SWEEP_MAX_BS})")
    if scale_n is None and (groupsize % 32 or bs % groupsize):
        raise ValueError(f"gptq_sweep_block: int4 needs groupsize % 32 == 0 and bs % groupsize "
                         f"== 0 (bs {bs}, groupsize {groupsize})")
    if scale_n is not None and (scale_n.shape != (N,) or scale_n.dtype != torch.float32
                                or not scale_n.is_contiguous()):
        raise ValueError("gptq_sweep_block: scale_n must be (N,) f32 contiguous")
    if w_blk.dtype != torch.float32 or hinv_blk.dtype != torch.float32:
        raise ValueError("gptq_sweep_block: w_blk and hinv_blk must be f32")


def _launch(w_blk, hinv_blk, scale_n, groupsize):
    N, bs = w_blk.shape
    out = torch.empty((3, N, bs), dtype=torch.float32, device=w_blk.device)
    scales = None if scale_n is not None else torch.empty(
        (bs // groupsize, N), dtype=torch.float32, device=w_blk.device)
    _build.call("chatglm_gptq_sweep", w_blk.data_ptr(), w_blk.stride(0), hinv_blk.data_ptr(),
                hinv_blk.stride(0), 0 if scale_n is None else scale_n.data_ptr(),
                out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(),
                0 if scales is None else scales.data_ptr(), N, bs, groupsize,
                _build.stream_ptr(w_blk))
    return (out[0], out[1], out[2]) if scales is None else (out[0], out[1], out[2], scales)


def gptq_sweep_int8(w_blk, hinv_blk, scale_n):
    """Launch the fixed-scale form (checked inputs on the card)."""
    out = _launch(w_blk, hinv_blk, scale_n, 32)
    return _build.launched(gptq_sweep_int8, out)


gptq_sweep_int8.launches = 0


def gptq_sweep_int4(w_blk, hinv_blk, groupsize):
    """Launch the group-rescale form (checked inputs on the card)."""
    out = _launch(w_blk, hinv_blk, None, groupsize)
    return _build.launched(gptq_sweep_int4, out)


gptq_sweep_int4.launches = 0


def gptq_sweep_block(w_blk: torch.Tensor, hinv_blk: torch.Tensor,
                     scale_n: Optional[torch.Tensor] = None, groupsize: int = 32):
    """One block of the sweep (see the module docstring).  On a CPU tensor
    this is the plain version; on a CUDA tensor it launches the kernel or
    raises."""
    if not _build.on_card(w_blk):
        return gptq_sweep_block_plain(w_blk, hinv_blk, scale_n, groupsize)
    _check(w_blk, hinv_blk, scale_n, groupsize)
    # the kernel reads rows at a stride: a column-major block (the upper
    # factor torch.linalg.cholesky returns) is copied to rows first
    if w_blk.stride(1) != 1:
        w_blk = w_blk.contiguous()
    if hinv_blk.stride(1) != 1:
        hinv_blk = hinv_blk.contiguous()
    if scale_n is None:
        return gptq_sweep_int4(w_blk, hinv_blk, groupsize)
    return gptq_sweep_int8(w_blk, hinv_blk, scale_n)

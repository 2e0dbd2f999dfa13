"""Dynamic-activation int8 matmuls (B7, B8): the per-row activation
quantizer, the wrappers over the CUDA kernels, their plain versions, and
their launch counts.

``TorchRuntimeConfig.dynamic_int8`` routes the quantized linears here
(ops/linear.py).  The activations are quantized per row to int8
(``dyn_quantize_rows``, the JAX package's ``_dyn_quantize_rows``,
chatglm_q_tpu/ops/pallas_matmul.py:1076-1082: plain PyTorch, as the JAX
prologue is jnp outside any kernel); the kernels in ``csrc/dyn_matmul.cu``
then take s8 × s8 products with int32 sums:

* ``int8_dyn_matmul`` (B7, replaces :_int8_dyn_kernel) on int8 weights:
  y = (float(xq @ w) · sx) · scale.  Its kernels equal the plain version
  bit for bit: int32 sums are exact in any order and the f32 epilogue is
  the same operations in the same order.
* ``int4_dyn_matmul`` (B8, replaces :_int4_dyn_kernel) on int4g32 weights,
  nibbles widened to s8: y = (Σ_g float(xq_g @ w8_g) · scale_g) · sx over
  groups of 32 along K.  Each group dot is exact; the f32 sum over groups
  is taken in another order than the plain version's.

Each has two kernels, in f32, bf16 or f16 output alike (their inputs are s8;
only the epilogue's store differs, the f32 result rounded once to x's dtype
as the JAX kernels' ``astype`` rounds it, inf past f16's 65504).  Launches
with an f16 output also count as ``<wrapper>_f16``:

* at M ≤ MMA_MIN_M (decode), ``dyn_splitk_mma_kernel``: B1's split-K design
  on common.cuh's split-K body with s8 mma.sync (the weights as A, xq's rows
  as B), K split so a narrow N fills the card (``splitk_plan`` over s8
  rows), the splits merged in split order by the last block of each column
  tile to arrive, in the same launch; B7 in int32, B8 one s32 partial per
  group folded into f32 with its scale;
* above it (``uses_mma``), ``dyn_wgmma_kernel``: a persistent Hopper kernel
  on the ring of the other Hopper matmuls (TMA stages of 128 s8 elements in
  an mbarrier ring, s8 wgmma with the weights as A from registers, K splits
  from ``dyn_plan`` merged in the launch; B7 one exact int32 accumulator, B8
  one s32 partial per group folded into f32 with its scale).  It needs N %
  16 == 0; the wrappers refuse more than MMA_MIN_M rows otherwise.

``int8_dyn_supported`` / ``int4_dyn_supported`` repeat the shape gates of
the JAX wrappers (pallas_matmul.py:991-994, :1098-1101), which return None,
and so fall back to the weight-only kernels, unless N has a divisor that is
a multiple of 128 and K a block size.  The gate decides which numerics a
call gets, so the port keeps it to match JAX's outputs.
"""
from __future__ import annotations

import torch

from . import _build, autotune
from .quant import div_exact, unpack_int4_tpu_q
from .quant_matmul import (DYN_STEP, MMA_MIN_M, aligned, f16_form, mma_bucket, splitk_plan,
                           splitk_scratch, wg_plan, wg_problem, wg_scratch)

PLAIN_CHUNK_BYTES = 1 << 31  # the int4 plain version's f64 group-dot block (few launches)


def dyn_quantize_rows(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric int8: sx = max(max|x| / 127, 1e-10) (M, 1) f32, the
    quotient correctly rounded on every device, and xq = clip(round(x / sx),
    -127, 127) int8 (M, K).  ``torch.round`` rounds half to even, as
    ``jnp.round`` does."""
    xf = x.float()
    sx = torch.clamp(div_exact(xf.abs().amax(dim=1, keepdim=True), 127.0), min=1e-10)
    xq = torch.clamp(torch.round(xf / sx), -127, 127).to(torch.int8)
    return xq, sx


def int8_dyn_supported(K: int, N: int) -> bool:
    return K % 32 == 0 and N % 128 == 0


def int4_dyn_supported(K: int, N: int) -> bool:
    return K % 128 == 0 and N % 128 == 0


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def int8_dyn_acc_plain(xq: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The exact int32 accumulator xq (M, K) s8 @ w (K, N) s8, as float64.
    (|acc| ≤ 127·127·K stays far below 2^53; a float32 dot would be exact
    only below 2^24, and CUDA PyTorch has no integer matmul to offer.)"""
    return xq.double() @ w.double()


def int8_dyn_matmul_plain(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """B7's function: (float(xq @ w) · sx) · scale in f32, cast to x's dtype."""
    xq, sx = dyn_quantize_rows(x)
    acc = int8_dyn_acc_plain(xq, w).float()
    return ((acc * sx) * scale.float()).to(x.dtype)


def int4_dyn_matmul_plain(x: torch.Tensor, packed: torch.Tensor,
                          scale: torch.Tensor) -> torch.Tensor:
    """B8's function: per-group float64 dots (exact), times the f32 group
    scales, summed in f32, times sx; cast to x's dtype."""
    xq, sx = dyn_quantize_rows(x)
    M, K = xq.shape
    G, N = scale.shape
    xg = xq.double().reshape(M, G, K // G).transpose(0, 1)      # (G, M, 32)
    wg = unpack_int4_tpu_q(packed).double().reshape(G, K // G, N)  # (G, 32, N)
    s = scale.float()
    acc = torch.zeros((M, N), dtype=torch.float32, device=x.device)
    step = max(1, PLAIN_CHUNK_BYTES // (8 * M * N))
    for g0 in range(0, G, step):
        dots = torch.bmm(xg[g0:g0 + step], wg[g0:g0 + step]).float()  # exact: |dot| < 2^15
        acc += (dots * s[g0:g0 + step, None, :]).sum(0)
    return (acc * sx).to(x.dtype)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def _check(name, x, w, scale, int4):
    if not (x.is_cuda and w.device == x.device and scale.device == x.device):
        raise ValueError(f"{name}: x, weights and scale must be on one CUDA device")
    if x.dim() != 2 or w.dim() != 2:
        raise ValueError(f"{name}: x (M, K) and 2-D weights")
    K, N = x.shape[1], w.shape[1]
    if int4:
        ok = (w.shape[0] * 2 == K and scale.shape == (K // 32, N)
              and w.dtype == torch.uint8 and scale.dtype == torch.bfloat16)
    else:
        ok = (w.shape[0] == K and scale.shape == (N,)
              and w.dtype == torch.int8 and scale.dtype == torch.float32)
    if not ok or K % 32 or N % 8 or (x.shape[0] > MMA_MIN_M and N % 16):
        raise ValueError(f"{name}: unsupported x {tuple(x.shape)}, weights "
                         f"{tuple(w.shape)} {w.dtype}, scale {tuple(scale.shape)} {scale.dtype}")
    if x.dtype not in (torch.bfloat16, torch.float16, torch.float32):
        raise TypeError(f"{name}: x must be bf16, f16 or f32, not {x.dtype}")
    for label, t in (("weights", w), ("scale", scale)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: {label} must be contiguous and 16-byte aligned")


def uses_mma(M: int, N: int) -> bool:
    """The s8 tensor-core kernel, for any output dtype (its inputs are s8)."""
    return M > MMA_MIN_M and N % 16 == 0


def dyn_plan(M: int, K: int, N: int, int4: bool = False) -> tuple[int, int, int, int]:
    """(bm, nsplit, stages_per_split, ctas) of ``dyn_wgmma_kernel`` for xq
    (M, K) and N columns: ``wg_plan`` over stages of DYN_STEP s8 elements
    (csrc: DYN_STEP).  At the prefill M it splits K 4 ways where N is narrow:
    q/o/w_out's 32 column tiles become 128 blocks; kv_proj's 4 become 16,
    since each further split adds more to its tile's merge than it saves.
    Or the plan table's "int4_dyn_mma" (B8, ``int4``) / "int8_dyn_mma" (B7)
    entry (ops/autotune.py)."""
    return autotune.plan("int4_dyn_mma" if int4 else "int8_dyn_mma", mma_bucket(M), K, N,
                         lambda: wg_plan(M, K, N, step=DYN_STEP),
                         lambda p: wg_problem(-(-K // DYN_STEP), p))


def _splitk(entry, xq, sx, w, scale, out_dtype):
    M, K = xq.shape
    N = w.shape[1]
    plan = splitk_plan(M, K, N, xbytes=1, int8_weights=w.dtype == torch.int8)
    y = torch.empty((M, N), dtype=out_dtype, device=xq.device)
    part, arrivals = splitk_scratch(xq.device, M, N, plan)
    _build.call(entry, xq.data_ptr(), sx.data_ptr(), w.data_ptr(), scale.data_ptr(),
                y.data_ptr(), part, arrivals, M, K, N, _build.dtype_code(out_dtype), *plan,
                _build.stream_ptr(xq))
    return y


def _mma(entry, xq, sx, w, scale, out_dtype):
    M, K = xq.shape
    N = w.shape[1]
    plan = dyn_plan(M, K, N, int4=w.dtype == torch.uint8)
    bm, nsplit, sps, ctas = plan
    y = torch.empty((M, N), dtype=out_dtype, device=xq.device)
    part, arrivals = wg_scratch(xq.device, M, N, plan)
    _build.call(entry, xq.data_ptr(), sx.data_ptr(), w.data_ptr(), scale.data_ptr(),
                y.data_ptr(), part, arrivals, M, K, N, _build.dtype_code(out_dtype), bm,
                nsplit, sps, ctas, _build.stream_ptr(xq))
    return y


def int8_dyn_splitk(xq, sx, w, scale, out_dtype):
    """Launch B7's split-K tensor-core kernel (checked inputs on the card,
    M ≤ MMA_MIN_M): one launch, the splits merged inside it in int32."""
    y = _splitk("chatglm_int8_dyn_splitk", xq, sx, w, scale, out_dtype)
    return _build.launched(int8_dyn_splitk, y, f16_form(y))


def int8_dyn_mma(xq, sx, w, scale, out_dtype):
    """Launch B7's Hopper kernel (checked inputs on the card, N % 16 == 0):
    one launch, any K splits merged inside it in int32."""
    y = _mma("chatglm_int8_dyn_mma", xq, sx, w, scale, out_dtype)
    return _build.launched(int8_dyn_mma, y, f16_form(y))


def int4_dyn_splitk(xq, sx, packed, scale, out_dtype):
    """Launch B8's split-K tensor-core kernel (checked inputs on the card,
    M ≤ MMA_MIN_M): one launch, the splits merged inside it."""
    y = _splitk("chatglm_int4_dyn_splitk", xq, sx, packed, scale, out_dtype)
    return _build.launched(int4_dyn_splitk, y, f16_form(y))


def int4_dyn_mma(xq, sx, packed, scale, out_dtype):
    """Launch B8's Hopper kernel (checked inputs on the card, N % 16 == 0):
    one launch, any K splits merged inside it."""
    y = _mma("chatglm_int4_dyn_mma", xq, sx, packed, scale, out_dtype)
    return _build.launched(int4_dyn_mma, y, f16_form(y))


for _fn in (int8_dyn_splitk, int8_dyn_mma, int4_dyn_splitk, int4_dyn_mma):
    _fn.launches = 0
    _build.with_forms(_fn, "f16")


def int8_dyn_matmul(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """x (M, K) bf16/f16/f32, quantized per row, @ w (K, N) int8, times sx and
    scale (N,) f32 → (M, N) in x's dtype.  On a CPU tensor this is the plain
    version; on a CUDA tensor it launches a kernel or raises."""
    if not _build.on_card(x):
        return int8_dyn_matmul_plain(x, w, scale)
    _check("int8_dyn_matmul", x, w, scale, int4=False)
    xq, sx = dyn_quantize_rows(x)
    xq, sx = aligned(xq), aligned(sx)
    fn = int8_dyn_mma if uses_mma(xq.shape[0], w.shape[1]) else int8_dyn_splitk
    return fn(xq, sx, w, scale, x.dtype)


def int4_dyn_matmul(x: torch.Tensor, packed: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """x (M, K) bf16/f16/f32, quantized per row, @ s8(packed (K/2, N) tpu order)
    in groups of 32 rows with scale (K/32, N) bf16 → (M, N) in x's dtype.
    On a CPU tensor this is the plain version; on a CUDA tensor it launches
    a kernel or raises."""
    if not _build.on_card(x):
        return int4_dyn_matmul_plain(x, packed, scale)
    _check("int4_dyn_matmul", x, packed, scale, int4=True)
    xq, sx = dyn_quantize_rows(x)
    xq, sx = aligned(xq), aligned(sx)
    fn = int4_dyn_mma if uses_mma(xq.shape[0], packed.shape[1]) else int4_dyn_splitk
    return fn(xq, sx, packed, scale, x.dtype)

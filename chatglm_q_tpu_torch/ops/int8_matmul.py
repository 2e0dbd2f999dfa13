"""int8 weight-only matmul (B6) and its transposed form (B13): the wrappers
over the CUDA kernels, their plain versions, and their launch counts.

Replaces chatglm_q_tpu/ops/pallas_matmul.py:_int8_fwd_kernel
(``int8_matmul_pallas`` and its layer-indexed twin).  One wrapper,
``int8_matmul``, over three kernels in ``csrc/int8_matmul.cu`` chosen by
``int8_route``:

* ``int8_splitk`` — bf16 or f16 activations at M ≤ MMA_MIN_M (decode):
  ``int8_splitk_mma_kernel``, B1's split-K design on common.cuh's split-K
  body: mma.sync with the weights as A (each int8 converted exactly to
  bf16 once, whatever M is) and x's rows as B, K split so a narrow N fills
  the card, the splits' f32 partials summed in split order by the last
  block of each column tile to arrive, in the same launch.  Bound by the
  weight bytes; plan ``splitk_plan``.
* ``int8_mma`` — bf16 or f16 activations above it (prefill, ``uses_mma``):
  ``int8_wgmma_kernel``, a persistent Hopper kernel on B1's mainloop (TMA
  tiles in an mbarrier ring, wgmma with the weights as A from registers,
  each int8 converted exactly to bf16); ``wg_plan`` picks the tile and the
  K splits, merged in the same launch.
* ``int8_gemv`` — bf16, f16 or f32 activations above the split-K limits
  where N % 16 != 0: split-K CUDA-core kernel with a fixed-order second
  pass that sums the f32 partials and applies the per-column scale.

f32 activations take both tensor-core kernels in their f32 forms (counted
apart too as ``<wrapper>_f32``), exactly, on x's three bf16 pieces
(quant_matmul.py: ``split_bf16x3_pass``, ``splitk_f32_plan``):
``int8_splitk`` up to ``F32_SPLITK_MAX`` rows, ``int8_mma`` above it.  The CUDA-core gemv stays callable by name.

All multiply the f32 accumulator by the per-column scale once, after the K
sum, as the TPU kernel does.  The JAX package's jnp fallback scales the
weights before the dot instead (in x's dtype: the f32 scale rounded to it,
then w·s rounded to it): the same function, rounded elsewhere.  The f16
forms (a float16 checkpoint's activations) are the same kernels over f16
tiles, counted apart too as ``<wrapper>_f16``.

``int8_matmul_t`` (B13) replaces pallas_matmul.py:_int8_t_kernel
(``int8_matmul_t_pallas``): the backward of the int8 linear, grad_x =
(g · scale) @ wᵀ, over the same (K, N) weights.  As the TPU kernel does, the
scale folds into g in g's dtype before the dot; JAX's jnp fallback
(``linear.py::_int8_matmul_t_fallback``) scales w instead.  Three kernels,
split as B6's (quant_matmul.py's ``t_route``): ``int8_t_splitk`` (bf16 or
f16, M ≤ MMA_MIN_M): ``csrc/common.cuh``'s ``t_splitk_mma_kernel`` over the
int8 view, mma.sync on the weight rows as read, the scale folded into g as
g is staged in shared memory, the contraction split and merged in the
launch (``t_splitk_plan``); ``int8_t_mma`` (bf16 or f16, M > 16): the
Hopper ``t_wgmma_kernel`` over the same view, which folds the scale into
each g stage in shared memory (``t_mma_plan``); ``int8_t_gemv`` (f32 g;
``csrc/int8_matmul.cu``): the CUDA cores in IEEE f32.  Under f16 g (a
float16 checkpoint's fine-tuning) the fold is f16(g · f16(s)), JAX's
``_int8_t_kernel`` in f16; those launches also count as ``<wrapper>_f16``.
"""
from __future__ import annotations

import torch

from . import _build
from .quant_matmul import (MMA_MIN_M, act_form, aligned, f16_form, gemv_plan, int8_mma_plan,
                           matmul_route, splitk_call, splitk_f32_plan, splitk_plan, t_mma_plan,
                           t_route, t_splitk_call, wg_call)


def int8_matmul_plain(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """(x (M, K) @ w (K, N) int8 in f32) * scale (N,), cast to x's dtype.
    The function the kernels are held against."""
    return ((x.float() @ w.float()) * scale.float()).to(x.dtype)


def _check(x, w, scale):
    if not (x.is_cuda and w.device == x.device and scale.device == x.device):
        raise ValueError("int8_matmul: x, w and scale must be on one CUDA device")
    if x.dim() != 2 or w.dim() != 2 or scale.dim() != 1:
        raise ValueError("int8_matmul: x (M, K), w (K, N), scale (N,)")
    M, K = x.shape
    if w.shape[0] != K or K % 32 or scale.shape[0] != w.shape[1] or w.shape[1] % 8:
        raise ValueError(f"int8_matmul: unsupported shapes x {tuple(x.shape)}, "
                         f"w {tuple(w.shape)}, scale {tuple(scale.shape)}")
    if x.dtype not in (torch.bfloat16, torch.float16, torch.float32):
        raise TypeError(f"int8_matmul: x must be bf16, f16 or f32, not {x.dtype}")
    if w.dtype != torch.int8 or scale.dtype != torch.float32:
        raise TypeError("int8_matmul: w must be int8 and scale f32")
    for name, t in (("w", w), ("scale", scale)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"int8_matmul: {name} must be contiguous and 16-byte aligned")


def int8_route(M: int, N: int, dtype: torch.dtype) -> str:
    """B6's kernel for x (M, K) of ``dtype`` and N columns: "splitk" (bf16
    or f16 at M ≤ MMA_MIN_M, f32 at M ≤ F32_SPLITK_MAX), "mma" above it
    (N % 16 == 0) or "gemv" (N % 16 != 0)."""
    return matmul_route(M, N, dtype, MMA_MIN_M)


def int8_splitk(x, w, scale):
    """Launch the split-K tensor-core kernel (checked bf16 or f16 inputs on
    the card at M ≤ MMA_MIN_M, f32 at M ≤ F32_SPLITK_MAX): one launch, the
    splits merged inside it."""
    M, K = x.shape
    N = w.shape[1]
    plan = (splitk_f32_plan(M, K, N, int8_weights=True) if x.dtype == torch.float32
            else splitk_plan(M, K, N, int8_weights=True))
    y = splitk_call("chatglm_int8_splitk_mma", x, w, scale, plan)
    return _build.launched(int8_splitk, y, act_form(x))


int8_splitk.launches = 0


def int8_gemv(x, w, scale):
    """Launch the CUDA-core split-K kernel (checked inputs on the card)."""
    M, K = x.shape
    N = w.shape[1]
    nsplit, cps = gemv_plan(M, K, N)
    y = torch.empty((M, N), dtype=x.dtype, device=x.device)
    ws = torch.empty((nsplit, M, N), dtype=torch.float32, device=x.device)
    _build.call("chatglm_int8_gemv", x.data_ptr(), w.data_ptr(), scale.data_ptr(), y.data_ptr(),
                ws.data_ptr(), M, K, N, _build.dtype_code(x.dtype), nsplit, cps,
                _build.stream_ptr(x))
    return _build.launched(int8_gemv, y, act_form(x))


int8_gemv.launches = 0


def int8_mma(x, w, scale):
    """Launch the Hopper tensor-core kernel (checked bf16, f16 or f32 inputs
    on the card, N % 16 == 0): one launch, any K splits merged inside it;
    f32 x after the split pass (a launch of its own)."""
    M, K = x.shape
    N = w.shape[1]
    y = torch.empty((M, N), dtype=x.dtype, device=x.device)
    wg_call("chatglm_int8_mma", x, w, scale, y, M, K, N, N,
            int8_mma_plan(M, K, N, x.dtype == torch.float32))
    return _build.launched(int8_mma, y, act_form(x))


int8_mma.launches = 0
for _fn in (int8_splitk, int8_gemv, int8_mma):
    _build.with_forms(_fn, "f16", "f32")


def int8_matmul(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """x (M, K) bf16/f16/f32 @ (w (K, N) int8 · scale (N,) f32) → (M, N) in
    x's dtype.

    On a CPU tensor this is the plain version; on a CUDA tensor it launches
    a kernel or raises.  ``w``/``scale`` may be a layer's view ``stack[l]``."""
    if _build.exporting(x):
        return _build.export_op("int8_matmul")(x, w, scale)
    if not _build.on_card(x):
        return int8_matmul_plain(x, w, scale)
    _check(x, w, scale)
    x = aligned(x)
    route = int8_route(x.shape[0], w.shape[1], x.dtype)
    if route == "splitk":
        return int8_splitk(x, w, scale)
    if route == "mma":
        return int8_mma(x, w, scale)
    return int8_gemv(x, w, scale)


# ---------------------------------------------------------------------------
# Transposed (backward) form, B13
# ---------------------------------------------------------------------------

def int8_matmul_t_plain(g: torch.Tensor, w: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """(g (M, N) · scale (N,) in g's dtype) @ w (K, N)ᵀ in f32, cast to g's
    dtype → (M, K).  The function the B13 kernels are held against."""
    gs = g * scale.to(g.dtype)
    return (gs.float() @ w.float().T).to(g.dtype)


def _check_t(g, w, scale):
    if not (g.is_cuda and w.device == g.device and scale.device == g.device):
        raise ValueError("int8_matmul_t: g, w and scale must be on one CUDA device")
    if g.dim() != 2 or w.dim() != 2 or scale.dim() != 1:
        raise ValueError("int8_matmul_t: g (M, N), w (K, N), scale (N,)")
    K, N = w.shape
    if g.shape[1] != N or K % 32 or scale.shape[0] != N or N % 8:
        raise ValueError(f"int8_matmul_t: unsupported shapes g {tuple(g.shape)}, "
                         f"w {tuple(w.shape)}, scale {tuple(scale.shape)}")
    if g.dtype not in (torch.bfloat16, torch.float16, torch.float32):
        raise TypeError(f"int8_matmul_t: g must be bf16, f16 or f32, not {g.dtype}")
    if w.dtype != torch.int8 or scale.dtype != torch.float32:
        raise TypeError("int8_matmul_t: w must be int8 and scale f32")
    for name, t in (("w", w), ("scale", scale)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"int8_matmul_t: {name} must be contiguous and 16-byte aligned")


def int8_t_splitk(g, w, scale):
    """Launch B13's split-K tensor-core kernel (checked bf16 or f16 inputs on
    the card): one launch, the contraction splits merged inside it."""
    out = t_splitk_call("chatglm_int8_t_splitk", g, w, scale, w.shape[0])
    return _build.launched(int8_t_splitk, out, f16_form(g))


def int8_t_gemv(g, w, scale):
    """Launch B13's CUDA-core kernel (checked f32 inputs on the card)."""
    if g.dtype != torch.float32:
        raise TypeError(f"int8_t_gemv: g must be f32, not {g.dtype}")
    M, N = g.shape
    K = w.shape[0]
    out = torch.empty((M, K), dtype=g.dtype, device=g.device)
    _build.call("chatglm_int8_t_gemv", g.data_ptr(), w.data_ptr(), scale.data_ptr(),
                out.data_ptr(), M, K, N, _build.dtype_code(g.dtype), _build.stream_ptr(g))
    return _build.launched(int8_t_gemv, out)


int8_t_gemv.launches = 0


def int8_t_mma(g, w, scale):
    """Launch B13's Hopper tensor-core kernel (checked bf16 or f16 inputs on
    the card, N % 16 == 0): one launch, any contraction splits merged inside
    it."""
    M, N = g.shape
    K = w.shape[0]
    out = torch.empty((M, K), dtype=g.dtype, device=g.device)
    wg_call("chatglm_int8_t_mma", g, w, scale, out, M, K, N, K,
            t_mma_plan(M, K, N, kind="int8"))
    return _build.launched(int8_t_mma, out, f16_form(g))


for _fn in (int8_t_splitk, int8_t_mma):
    _fn.launches = 0
    _build.with_forms(_fn, "f16")


def int8_matmul_t(g: torch.Tensor, w: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """g (M, N) bf16/f16/f32 @ (w (K, N) int8 · scale (N,) f32)ᵀ → (M, K) in g's
    dtype: the int8 linear's grad_x at the weights' storage K.

    On a CPU tensor this is the plain version; on a CUDA tensor it launches
    a kernel or raises."""
    if not _build.on_card(g):
        return int8_matmul_t_plain(g, w, scale)
    _check_t(g, w, scale)
    g = aligned(g)
    route = t_route(g.shape[0], g.shape[1], g.dtype)
    if route == "splitk":
        return int8_t_splitk(g, w, scale)
    if route == "mma":
        return int8_t_mma(g, w, scale)
    return int8_t_gemv(g, w, scale)

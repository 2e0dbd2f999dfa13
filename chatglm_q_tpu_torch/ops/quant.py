"""Quantized weight representations: RTN quantizers, bit-packing, lookups.

The PyTorch counterpart of chatglm_q_tpu/ops/quant.py, bit for bit: the same
grids, the same packed bytes, the same scales.

Layouts (all linear weights K-major, ``(in K, out N)``):

int8:    ``weight`` int8 ``(K, N)``;   ``weight_scale`` ``(N,)``.
int4g32: ``weight`` uint8 ``(K//2, N)``, two nibbles per byte;
         ``weight_scale`` ``(K//32, N)`` in ``SCALE_DTYPE``.

Two nibble orders exist for int4.  Both pair K-adjacent rows in one byte
(byte row ``i``: ``k=2i`` in the low nibble, ``k=2i+1`` in the high one):

* **reference order** (on disk, and the embedding in memory): the nibble is
  the offset value ``q + 8``;
* **tpu order** (linear weights in memory): the nibble is the two's-complement
  value ``q & 0xF``.  The CUDA kernel sign-extends it in registers.

The two differ by an XOR with ``0x88`` per byte.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

MAX_Q_INT8 = 127
MAX_Q_INT4 = 7
GROUP_K = 32  # int4 group size along K

# lm_head N padding target (65024 → 65536), applied only when N ≥ it
LMHEAD_N_MULTIPLE = 2048

# int4 group scales are stored in bfloat16 (the JAX package's storage type:
# 1/8 of the packed-weight stream, and the kernels read it as is)
SCALE_DTYPE = torch.bfloat16


def lmhead_pad(p: dict, quant_type: str) -> dict:
    """Pad the lm_head's vocab (N) dim to LMHEAD_N_MULTIPLE when large
    enough; callers slice logits back to vocab_size."""
    if quant_type == "none" or p["weight"].shape[-1] < LMHEAD_N_MULTIPLE:
        return p
    return pad_linear_n(p, quant_type, multiple=LMHEAD_N_MULTIPLE)


# ---------------------------------------------------------------------------
# RTN quantizers
# ---------------------------------------------------------------------------

_DIVISORS: dict = {}  # (d, dtype, device) -> the 0-dim divisor div_exact divides by


def div_exact(x: torch.Tensor, d: float) -> torch.Tensor:
    """``x / d``, correctly rounded on every device, as JAX divides.
    PyTorch's CUDA kernels multiply by the reciprocal of a Python-number
    divisor (at times an ulp off the quotient), so the divisor goes in as a
    0-dim tensor on x's device.  That tensor is made once a (d, dtype,
    device), outside any capture (a program's eager warm-up step makes it),
    so a captured step launches no fill for it."""
    key = (d, x.dtype, x.device)
    t = _DIVISORS.get(key)
    if t is None:
        if (x.device.type == "cuda" and torch.cuda.is_available()
                and torch.cuda.is_current_stream_capturing()):
            raise RuntimeError(f"div_exact: the divisor {d} is made on the first eager call; "
                               "capture a step only after one eager step")
        t = _DIVISORS[key] = torch.full((), d, dtype=x.dtype, device=x.device)
    return x / t


def rtn_quantize_int8(w_kn: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-out-channel int8 RTN over a (..., K, N) weight (leading
    dims: a stack of layers, each quantized on its own).

    Returns (q (..., K, N) int8, scale (..., N) f32)."""
    w = w_kn.float()
    w_max = w.abs().amax(dim=-2)
    scale = torch.clamp(div_exact(w_max, MAX_Q_INT8), min=1e-10)
    q = torch.clamp(torch.round(w / scale[..., None, :]), -MAX_Q_INT8, MAX_Q_INT8).to(torch.int8)
    return q, scale


def rtn_quantize_int4(w_kn: torch.Tensor, group_k: int = GROUP_K
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-(group-of-K × out-channel) int4 RTN over a (..., K, N)
    weight.

    Returns (q (..., K, N) int8 in [-7, 7], scale (..., G, N) f32)."""
    *lead, K, N = w_kn.shape
    assert K % group_k == 0, f"{K=} {group_k=}"
    G = K // group_k
    w = w_kn.float().reshape(*lead, G, group_k, N)
    w_max = w.abs().amax(dim=-2, keepdim=True)
    scale = torch.clamp(div_exact(w_max, MAX_Q_INT4), min=1e-10)
    q = torch.clamp(torch.round(w / scale), -MAX_Q_INT4, MAX_Q_INT4).to(torch.int8)
    return q.reshape(*lead, K, N), scale.reshape(*lead, G, N)


def quantize_with_scale_int8(w_kn: torch.Tensor, scale_n: torch.Tensor) -> torch.Tensor:
    """(K, N) weight → int8 grid with a fixed (N,) scale."""
    q = torch.round(w_kn.float() / scale_n.float())
    return torch.clamp(q, -MAX_Q_INT8, MAX_Q_INT8).to(torch.int8)


def quantize_with_scale_int4(w_kn: torch.Tensor, scale_gn: torch.Tensor) -> torch.Tensor:
    """(K, N) weight → int4 grid values in [-7, 7] with fixed (G, N) scales."""
    K, N = w_kn.shape
    G = scale_gn.shape[0]
    assert K % G == 0
    w = w_kn.float().reshape(G, K // G, N)
    q = torch.round(w / scale_gn.float()[:, None, :])
    return torch.clamp(q, -MAX_Q_INT4, MAX_Q_INT4).to(torch.int8).reshape(K, N)


# ---------------------------------------------------------------------------
# int4 nibble packing — reference order and tpu order
# ---------------------------------------------------------------------------

def pack_int4_ref(q_kn: torch.Tensor) -> torch.Tensor:
    """[-7,7] int grid (K, N) → reference-order packed uint8 (K//2, N)."""
    u = (q_kn.to(torch.int32) + 0x8).to(torch.uint8)
    return (u[0::2] & 0xF) | ((u[1::2] & 0xF) << 4)


def unpack_int4_ref(packed: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Reference-order packed (K//2, N) + scale (G, N) → dequantized (K, N) f32."""
    K2, N = packed.shape
    K = 2 * K2
    G = scale.shape[0]
    p = packed.to(torch.int32)
    lo = (p & 0xF) - 0x8
    hi = ((p >> 4) & 0xF) - 0x8
    q = torch.stack([lo, hi], dim=1).reshape(K, N)
    q = q.reshape(G, K // G, N).float() * scale.float()[:, None, :]
    return q.reshape(K, N)


def pack_int4_tpu(q_kn: torch.Tensor) -> torch.Tensor:
    """[-7,7] int grid (..., K, N) → tpu-order packed uint8 (..., K//2, N):
    two's-complement nibbles, ``k=2i`` low and ``k=2i+1`` high in byte row
    ``i``."""
    assert q_kn.shape[-2] % 2 == 0
    u = (q_kn.to(torch.int32) & 0xF).to(torch.uint8)
    return u[..., 0::2, :] | (u[..., 1::2, :] << 4)


def _sign_extend_nibble(v: torch.Tensor) -> torch.Tensor:
    """4-bit two's-complement value in [0, 15] → signed int in [-8, 7]."""
    return torch.bitwise_xor(v, 0x8) - 0x8


def unpack_int4_tpu_q(packed: torch.Tensor) -> torch.Tensor:
    """tpu-order packed (K//2, N) → the integer grid (K, N) int8 in [-8, 7]."""
    K2, N = packed.shape
    p = packed.to(torch.int32)
    lo = _sign_extend_nibble(p & 0xF)
    hi = _sign_extend_nibble((p >> 4) & 0xF)
    return torch.stack([lo, hi], dim=1).reshape(2 * K2, N).to(torch.int8)


def unpack_int4_tpu(packed: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """tpu-order packed (K//2, N) + scale (G, N) → dequantized (K, N) f32.

    The plain dequantization the int4 kernel is held against."""
    K = 2 * packed.shape[0]
    N = packed.shape[1]
    G = scale.shape[0]
    q = unpack_int4_tpu_q(packed).reshape(G, K // G, N).float() * scale.float()[:, None, :]
    return q.reshape(K, N)


def split_bf16x3(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """f32 ``x`` as three bf16 tensors (hi, mid, lo): hi = bf16(x), mid =
    bf16(x - hi), lo = bf16(x - hi - mid), each residual exact in f32.  The
    plain version of the f32 matmul kernels' split (csrc/common.cuh:
    ``split_bf16x3``): three 8-bit pieces hold f32's 24 significant bits
    and bf16 keeps f32's exponent range, so hi + mid + lo == x exactly for
    |x| ≥ 2^-110; below that lo lands among bf16's subnormals and
    |x - (hi + mid + lo)| ≤ 2^-134.  Where bf16(x) overflows to inf (|x|
    above bf16's largest finite value) hi is x truncated toward zero; a
    non-finite x gives hi = x, mid = lo = 0 (so inf·q and NaN propagate as
    the f32 product does)."""
    x = x.float()
    finite = torch.isfinite(x)
    hi = x.to(torch.bfloat16)
    toward_zero = (x.view(torch.int32) & -65536).view(torch.float32).to(torch.bfloat16)
    hi = torch.where(finite & torch.isinf(hi), toward_zero, hi)
    r = torch.where(finite, x - hi.float(), torch.zeros_like(x))
    mid = r.to(torch.bfloat16)
    lo = (r - mid.float()).to(torch.bfloat16)
    return hi, mid, lo


def repack_ref_to_tpu(packed_ref: torch.Tensor) -> torch.Tensor:
    """Reference-order packed uint8 → tpu order (an involution: ``^ 0x88``)."""
    return packed_ref ^ 0x88


def repack_tpu_to_ref(packed_tpu: torch.Tensor) -> torch.Tensor:
    """tpu-order packed uint8 → reference order."""
    return packed_tpu ^ 0x88


# ---------------------------------------------------------------------------
# Storage padding and whole-layer quantize helpers
# ---------------------------------------------------------------------------

def int4_storage_k(K: int) -> int:
    """In-memory K for quantized linear weights: a K > 512 with no
    256-multiple divisor ≤ 1024 (the ChatGLM2 inner dim 13696) is stored
    zero-padded to the next multiple of 512 (13696 → 13824).  Activations
    are zero-padded to match at call time (ops/linear.py)."""
    if K <= 512:
        return K
    d = 256
    while d <= min(K, 1024):
        if K % d == 0:
            return K
        d += 256
    return ((K + 511) // 512) * 512


def pad_int8_weight(q: torch.Tensor) -> torch.Tensor:
    """Zero-pad an int8 (..., K, N) weight's K to the storage size."""
    K = q.shape[-2]
    Ks = int4_storage_k(K)
    if Ks == K:
        return q
    return F.pad(q, (0, 0, 0, Ks - K))


def pad_linear_n(p: dict, quant_type: str = "", multiple: int | None = None) -> dict:
    """Zero-pad a quantized linear's output (N) dim to the storage size (the
    K rule, or an explicit ``multiple``).  Padded scales are 1.0, padded
    bias 0.  ``quant_type`` is accepted for call-site symmetry only."""
    w = p["weight"]
    N = w.shape[-1]
    Ns = ((N + multiple - 1) // multiple) * multiple if multiple else int4_storage_k(N)
    if Ns == N:
        return p
    pad = Ns - N
    out = {"weight": F.pad(w, (0, pad))}
    if "weight_scale" in p:
        out["weight_scale"] = F.pad(p["weight_scale"], (0, pad), value=1.0)
    if "bias" in p:
        out["bias"] = F.pad(p["bias"], (0, pad))
    return out


def quantize_linear_int8(w_kn: torch.Tensor, bias=None) -> dict:
    """(..., K, N) float weight → the in-memory int8 linear (each leading
    index quantized on its own: a stack of layers in one pass)."""
    q, scale = rtn_quantize_int8(w_kn)
    p = {"weight": pad_int8_weight(q), "weight_scale": scale}
    if bias is not None:
        p["bias"] = bias
    return p


def pad_packed_int4(packed: torch.Tensor, scale: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Pad a (..., K/2, N) packed + (..., K/32, N) scale pair to the storage
    K; padded nibbles are 0 and padded scales 1.0, so the padded rows
    dequantize to 0."""
    K = packed.shape[-2] * 2
    Ks = int4_storage_k(K)
    if Ks == K:
        return packed, scale
    packed = F.pad(packed, (0, 0, 0, (Ks - K) // 2))
    scale = F.pad(scale, (0, 0, 0, (Ks - K) // 32), value=1.0)
    return packed, scale


def quantize_linear_int4(w_kn: torch.Tensor, bias=None) -> dict:
    """(..., K, N) float weight → the in-memory int4g32 linear."""
    q, scale = rtn_quantize_int4(w_kn)
    packed, scale = pad_packed_int4(pack_int4_tpu(q), scale)
    p = {"weight": packed, "weight_scale": scale.to(SCALE_DTYPE)}
    if bias is not None:
        p["bias"] = bias
    return p


def quantize_embedding_int8(w_vh: torch.Tensor) -> dict:
    """Embedding (V, H) → int8 with a per-embedding-dim (H,) scale."""
    q, scale = rtn_quantize_int8(w_vh)
    return {"weight": q, "weight_scale": scale}


def quantize_embedding_int4(w_vh: torch.Tensor) -> dict:
    """Embedding (V, H) → int4 packed along V in *reference* nibble order,
    with (V//32, H) scales."""
    q, scale = rtn_quantize_int4(w_vh)
    return {"weight": pack_int4_ref(q), "weight_scale": scale}


def embedding_lookup_int8(params: dict, ids: torch.Tensor, dtype=torch.float32):
    """Gather the rows first, then dequantize only those."""
    rows = params["weight"][ids].to(dtype)
    return rows * params["weight_scale"].to(dtype)


def embedding_lookup_int4(params: dict, ids: torch.Tensor, dtype=torch.float32):
    """Per-token nibble unpack of the reference-order (offset +8) table."""
    packed = params["weight"]
    scale = params["weight_scale"]
    ids = ids.long()
    group_idx = ids // GROUP_K
    byte_idx = ids // 2
    shifts = (ids % 2) * 4
    bytes_ = packed[byte_idx].to(torch.int32)
    nib = ((bytes_ >> shifts[..., None]) & 0xF) - 0x8
    return nib.to(dtype) * scale[group_idx].to(dtype)

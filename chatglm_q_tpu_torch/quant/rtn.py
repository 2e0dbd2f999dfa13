"""Whole-model naive (RTN) quantization: the counterpart of
chatglm_q_tpu/quant/rtn.py.

The float param tree maps to a quantized tree in one pass: each stacked
(L, K, N) linear is quantized whole, every layer with its own scales
(ops/quant.py's quantizers take leading dims, where JAX vmaps).
"""
from __future__ import annotations

from ..config import ChatGLM2Config
from ..ops import quant as Q

LINEAR_KEYS = ("q_proj", "kv_proj", "o_proj", "w_in_h", "w_in_gate", "w_out")


def _quantize_linear(p: dict, quant_type: str) -> dict:
    fn = Q.quantize_linear_int8 if quant_type == "int8" else Q.quantize_linear_int4
    out = fn(p["weight"].float())
    if "bias" in p:
        out["bias"] = p["bias"]
    return out


def rtn_quantize_model(params: dict, config: ChatGLM2Config, quant_type: str) -> dict:
    """Float param tree (quant_type='none') → quantized tree."""
    assert quant_type in ("int8", "int4g32")
    emb_fn = Q.quantize_embedding_int8 if quant_type == "int8" else Q.quantize_embedding_int4
    layers = dict(params["layers"])
    for k in LINEAR_KEYS:
        q = _quantize_linear(params["layers"][k], quant_type)
        if k in ("w_in_h", "w_in_gate"):
            # N-pad to match w_out's K storage (zero columns are exact no-ops)
            q = Q.pad_linear_n(q, quant_type)
        layers[k] = q
    return {
        "word_embedding": emb_fn(params["word_embedding"]["weight"].float()),
        "layers": layers,
        "final_ln": params["final_ln"],
        "lm_head": Q.lmhead_pad(_quantize_linear(params["lm_head"], quant_type), quant_type),
    }

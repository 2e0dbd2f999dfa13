"""Layer-pipelined GPTQ calibration driver: the counterpart of
chatglm_q_tpu/quant/calibrate.py, in its order:

  1. quantize the embedding with naive RTN;
  2. embed every calibration batch once, through the quantized table, with
     the forward's positions and RoPE rows (``max_sequence_length + 1``
     rows: cumsum positions are 1-based);
  3. per layer: run every batch through the float block collecting the
     activations feeding each linear (``block_forward(collect_taps=True)``),
     accumulate the Hessians, quantize the six linears, and hand the float
     block's outputs to the next layer;
  4. final_ln → the lm_head's Hessian → quantize the lm_head.

q_proj / kv_proj share one Hessian (one input), as do w_in_h / w_in_gate.
GPTQ's sweep is independent per output row, so quantizing the splits apart
equals quantizing the fused weights.  The sweep runs one CUDA launch a
128-column block on the card (ops/gptq_sweep.py), or the plain per-column
loop under ``TorchRuntimeConfig(use_kernels=False)`` and on the CPU.
"""
from __future__ import annotations

from typing import Iterable, Optional

import torch
import torch.nn.functional as F

from ..config import ChatGLM2Config, TorchRuntimeConfig
from ..models import chatglm2 as M
from ..ops import quant as Q
from . import gptq as G

_DEFAULT_RT = TorchRuntimeConfig()


def _stack(trees: list) -> dict:
    return {k: _stack([t[k] for t in trees]) if isinstance(v, dict)
            else torch.stack([t[k] for t in trees]) for k, v in trees[0].items()}


def rtn_grid(w_kn: torch.Tensor, quant_type: str) -> torch.Tensor:
    """The naive (RTN) dequantized weight (N, K) f32 of a (K, N) float
    weight, with f32 scales: what GPTQ's grid is compared with."""
    if quant_type == "int8":
        q, scale = Q.rtn_quantize_int8(w_kn)
        return (q.float() * scale).T
    q, scale = Q.rtn_quantize_int4(w_kn)
    K, N = q.shape
    G_ = scale.shape[0]
    return (q.float().reshape(G_, K // G_, N) * scale[:, None, :]).reshape(K, N).T


@torch.no_grad()
def gptq_quantize_model(
    params: dict,
    config: ChatGLM2Config,
    batches: Iterable[tuple],  # (input_ids (B, S), attention_mask (B, S) | None)
    quant_type: str,
    blocksize: int = 128,
    groupsize: int = 32,
    percdamp: float = 0.01,
    dtype=torch.float32,
    rt: TorchRuntimeConfig = _DEFAULT_RT,
    print_loss: bool = False,
    stats: Optional[dict] = None,
) -> dict:
    """Float param tree → GPTQ-quantized tree (the structure of
    ``rtn_quantize_model``'s).  ``print_loss`` prints the reference's line a
    linear (its sweep loss and its output MSE on the last batch's
    activations).  A ``stats`` dict receives, per linear's tag, those two
    and RTN's output MSE on the same activations (``rtn_debug_mse``)."""
    assert quant_type in ("int8", "int4g32")
    batches = list(batches)
    dev = params["final_ln"]["weight"].device

    # 1. embedding: naive RTN
    emb_w = params["word_embedding"]["weight"].float()
    if quant_type == "int8":
        emb_q, lookup = Q.quantize_embedding_int8(emb_w), Q.embedding_lookup_int8
    else:
        emb_q, lookup = Q.quantize_embedding_int4(emb_w), Q.embedding_lookup_int4
    del emb_w

    # 2. embed all batches once, through the quantized embedding
    prepared = []
    for input_ids, attention_mask in batches:
        input_ids = torch.as_tensor(input_ids, device=dev)
        B, S = input_ids.shape
        if attention_mask is None:
            attention_mask = torch.ones((B, S), dtype=torch.int32, device=dev)
        mask_bias, pos = M.build_parity_mask_and_positions(
            torch.as_tensor(attention_mask, device=dev), S)
        prepared.append({"h": lookup(emb_q, input_ids, dtype),
                         "freqs": M._serving_freqs(config, pos, dtype),
                         "mask5": mask_bias[:, None, None]})

    want_dbg = print_loss or stats is not None

    def quant_params(w_kn, hessian, bias, pad_n=False, debug_input=None, tag=""):
        Kh = hessian.shape[0]
        if w_kn.shape[0] < Kh:
            # upstream activations are storage-K padded: pad the float
            # weight rows; dead-column handling zeroes them (exact 0)
            w_kn = F.pad(w_kn, (0, 0, 0, Kh - w_kn.shape[0]))
        dbg = debug_input if want_dbg else None
        if quant_type == "int8":
            out = G.gptq_linear_params_int8(w_kn, hessian, bias, blocksize, percdamp,
                                            debug_input=dbg, rt=rt)
        else:
            out = G.gptq_linear_params_int4(w_kn, hessian, bias, blocksize, groupsize,
                                            percdamp, debug_input=dbg, rt=rt)
        if dbg is not None:
            p, quant_losses, debug_loss = out
            if print_loss:
                print(f"{tag}: {quant_losses=:.8f} {debug_loss=:.8f}", flush=True)
            if stats is not None:
                stats[tag] = {"quant_loss": quant_losses, "debug_mse": debug_loss,
                              "rtn_debug_mse": G.debug_mse(dbg, w_kn.T,
                                                           rtn_grid(w_kn, quant_type))}
        else:
            p = out
        if pad_n:
            p = Q.pad_linear_n(p, quant_type)
        return p

    # 3. layer pipeline
    new_layers = []
    for i in range(config.num_layers):
        lp = M._layer(params["layers"], i)
        hes, dbg, outs = {}, {}, []
        for b in prepared:
            out, _, taps = M.block_forward(lp, b["h"], b["freqs"], b["mask5"], config, "none", rt,
                                           collect_taps=True)
            outs.append(out)
            for name, x in taps.items():
                if name not in hes:
                    hes[name] = G.init_hessian(x.shape[-1], dev)
                hes[name] = G.accumulate_hessian(*hes[name], x)
                dbg[name] = x
        for b, out in zip(prepared, outs):
            b["h"] = out  # the float block's outputs feed the next layer

        def linear(key, tap, pad_n=False):
            return quant_params(lp[key]["weight"], hes[tap][0], lp[key].get("bias"), pad_n=pad_n,
                                debug_input=dbg[tap], tag=f"layer {i} {key}")

        new_layers.append({
            "attn_ln": lp["attn_ln"],
            "ffn_ln": lp["ffn_ln"],
            "q_proj": linear("q_proj", "qkv_in"),
            "kv_proj": linear("kv_proj", "qkv_in"),
            "o_proj": linear("o_proj", "o_in"),
            "w_in_h": linear("w_in_h", "w_in_in", pad_n=True),
            "w_in_gate": linear("w_in_gate", "w_in_in", pad_n=True),
            "w_out": linear("w_out", "w_out_in"),
        })
        del hes, dbg

    layers = _stack(new_layers)

    # 4. lm_head on the final_ln outputs
    Hh, n = G.init_hessian(config.hidden_size, dev)
    final = None
    for b in prepared:
        final = M.rms_norm(b["h"], params["final_ln"]["weight"], config.layernorm_epsilon)
        Hh, n = G.accumulate_hessian(Hh, n, final)
    lm_head = Q.lmhead_pad(
        quant_params(params["lm_head"]["weight"], Hh, params["lm_head"].get("bias"),
                     debug_input=final, tag="lm_head"),
        quant_type,
    )

    return {
        "word_embedding": emb_q,
        "layers": layers,
        "final_ln": params["final_ln"],
        "lm_head": lm_head,
    }

"""Convert the HF ``THUDM/chatglm2-6b`` checkpoint (``pytorch_model*.bin``)
to the reference's safetensors layout, which the port's loader (and the
JAX package's) reads: the port's examples/convert_weight.py.

    python -m chatglm_q_tpu_torch.examples.convert_weight \\
        --source ../models/chatglm2-6b-hf --target ../models/chatglm2-6b-safe

The same explicit map of 3 + 7 names a layer, tensors unchanged, a bf16
``config.json`` (ChatGLM2-6B's config) and the tokenizer copied.  Each
``.bin`` becomes a ``.safetensors`` of the same stem, its tensors ordered as
the ``safetensors`` package orders them (by dtype, widest first, then by
name), so the files are byte for byte what the JAX script writes.  Only a
local directory converts: a hub id would need a download.
"""
from __future__ import annotations

import argparse
import json
import re
import shutil
from pathlib import Path

import torch

from ..config import GLMLoadConfig
from ..loader import write_safetensors

TOP_LEVEL = {
    "transformer.embedding.word_embeddings.weight": "word_embedding.weight",
    "transformer.encoder.final_layernorm.weight": "final_ln.weight",
    "transformer.output_layer.weight": "lm_head.weight",
}
PER_LAYER = {
    "input_layernorm.weight": "attn_ln.weight",
    "self_attention.query_key_value.weight": "attn.qkv_proj.weight",
    "self_attention.query_key_value.bias": "attn.qkv_proj.bias",
    "self_attention.dense.weight": "attn.o_proj.weight",
    "post_attention_layernorm.weight": "ffn_ln.weight",
    "mlp.dense_h_to_4h.weight": "ffn.w_in.weight",
    "mlp.dense_4h_to_h.weight": "ffn.w_out.weight",
}
_LAYER = re.compile(r"transformer\.encoder\.layers\.(\d+)\.(.+)")
# the safetensors package's dtype order (its Dtype enum): files list the
# widest first
_ST_RANK = [torch.bool, torch.uint8, torch.int8, torch.int16, torch.float16, torch.bfloat16,
            torch.int32, torch.float32, torch.float64, torch.int64]


def target_name(name: str):
    """The reference's name of HF tensor ``name``, or None (no counterpart,
    e.g. the rotary inv_freq)."""
    if name in TOP_LEVEL:
        return TOP_LEVEL[name]
    m = _LAYER.fullmatch(name)
    if m and m.group(2) in PER_LAYER:
        return f"layers.{m.group(1)}.{PER_LAYER[m.group(2)]}"
    return None


def safetensors_order(tensors: dict) -> dict:
    """``tensors`` in the order the safetensors package writes them."""
    return dict(sorted(tensors.items(), key=lambda kv: (-_ST_RANK.index(kv[1].dtype), kv[0])))


def convert(source, target) -> list:
    """Convert the local HF checkpoint ``source`` into ``target``; returns
    the safetensors files written."""
    source, target = Path(source), Path(target)
    if not source.is_dir():
        raise FileNotFoundError(f"{str(source)!r} is not a local directory: convert_weight "
                                "takes local paths only (a hub id would need a download)")
    target.mkdir(parents=True, exist_ok=True)
    index = json.loads((source / "pytorch_model.bin.index.json").read_bytes())
    bin_files = sorted(set(index["weight_map"].values()))
    for bin_file in bin_files:
        state_dict = torch.load(source / bin_file, map_location="cpu", weights_only=True)
        out = {}
        for name, t in state_dict.items():
            new = target_name(name)
            if new is None:
                print(f"skipping '{name}' (no target name — e.g. rotary inv_freq)")
                continue
            out[new] = t
        write_safetensors(target / bin_file.replace(".bin", ".safetensors"),
                          safetensors_order(out))
    config = GLMLoadConfig(weight_files=[f.replace(".bin", ".safetensors") for f in bin_files],
                           torch_dtype="bfloat16")
    shutil.copy(source / "tokenizer.model", target / config.tokenizer_file)
    (target / "config.json").write_text(config.to_json())
    return config.weight_files


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--source", required=True,
                    help="local directory with pytorch_model*.bin and tokenizer.model")
    ap.add_argument("--target", default="../models/chatglm2-6b-safe")
    args = ap.parse_args(argv)
    convert(args.source, args.target)
    print(f"converted → {args.target}")


if __name__ == "__main__":
    main()

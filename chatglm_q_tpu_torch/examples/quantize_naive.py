"""Whole-model naive (RTN) quantization of a float checkpoint: the port's
examples/quantize_naive/{int8,int4g32}.py.

    python -m chatglm_q_tpu_torch.examples.quantize_naive --quant int4g32 \\
        --source ../models/chatglm2-6b-safe --target ../models/chatglm2-6b-int4g32

Loads the float checkpoint in float32 on ``--device`` (default CUDA),
quantizes every linear and the embedding (quant/rtn.py), and saves a
float16-config checkpoint in the reference's format.
"""
from __future__ import annotations

import argparse

from ..config import resolve_device


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--quant", choices=("int8", "int4g32"), default="int4g32")
    p.add_argument("--source", default="../models/chatglm2-6b-safe")
    p.add_argument("--target", default=None,
                   help="output directory (default ../models/chatglm2-6b-<quant>)")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    return p.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)
    device = resolve_device(args.device)  # CUDA unless asked: raises before any loading
    from ..loader import load_model_and_tokenizer, save_model_and_tokenizer
    from ..quant.rtn import rtn_quantize_model

    target = args.target or f"../models/chatglm2-6b-{args.quant}"
    config, params, tokenizer = load_model_and_tokenizer(args.source, "float32",
                                                         device=device)
    qparams = rtn_quantize_model(params, config.model_config, args.quant)
    config.quant_type = args.quant
    config.torch_dtype = "float16"
    save_model_and_tokenizer(target, config, qparams, tokenizer)
    print(f"saved → {target}")


if __name__ == "__main__":
    main()

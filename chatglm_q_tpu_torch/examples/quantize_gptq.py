"""GPTQ quantization of a float checkpoint: the port's
examples/quantize_gptq/{int8,int4g32}.py.

    python -m chatglm_q_tpu_torch.examples.quantize_gptq --quant int4g32 \\
        --source ../models/chatglm2-6b-safe --target ../models/chatglm2-6b-int4g32 \\
        --ceval-dir ../data/ceval

The reference's calibration: 200 prompts, seed 42, batches of 20, left
padded; the layer-pipelined Hessians and sweeps of quant/calibrate.py (one
CUDA launch a 128-column block on the card), one loss line a linear; a
float16-config checkpoint in the reference's format.  Calibration text: a
local C-Eval directory (``--ceval-dir``, the reference's source), a text
file of one prompt a line (``--calib-file``), else the synthetic corpus
(examples/data.py); nothing is fetched.
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
    p.add_argument("--calib-file", default=None,
                   help="text file with one calibration prompt per line")
    p.add_argument("--ceval-dir", default=None, help="local C-Eval dataset dir (val split)")
    p.add_argument("--num-prompts", type=int, default=200)
    p.add_argument("--batch-size", type=int, default=20)
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    return p.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)
    device = resolve_device(args.device)  # CUDA unless asked: raises before any loading
    from ..loader import load_model_and_tokenizer, save_model_and_tokenizer
    from ..quant.calibrate import gptq_quantize_model
    from .data import load_calibration_texts

    target = args.target or f"../models/chatglm2-6b-{args.quant}"
    config, params, tokenizer = load_model_and_tokenizer(args.source, "float32",
                                                         device=device)
    texts = load_calibration_texts(calib_file=args.calib_file, ceval_dir=args.ceval_dir,
                                   num_prompts=args.num_prompts, seed=42)
    batches = []
    for i in range(0, len(texts), args.batch_size):
        enc = tokenizer(texts[i:i + args.batch_size], padding=True, return_tensors="pt")
        batches.append((enc["input_ids"], enc["attention_mask"]))
    qparams = gptq_quantize_model(params, config.model_config, batches, args.quant,
                                  print_loss=True)
    config.quant_type = args.quant
    config.torch_dtype = "float16"
    save_model_and_tokenizer(target, config, qparams, tokenizer)
    print(f"saved → {target}")


if __name__ == "__main__":
    main()

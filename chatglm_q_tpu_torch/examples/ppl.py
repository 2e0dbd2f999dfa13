"""Perplexity of a checkpoint under the reference protocol: the port's
examples/evaluations/ppl.py.

    python -m chatglm_q_tpu_torch.examples.ppl --model ../models/chatglm2-6b-int4g32 \\
        --ceval-dir ../data/ceval

Texts in batches of 20, left padded, labels −100 on the pads; ppl =
exp(mean of the batches' mean losses), from ``models.chatglm2.forward``
with labels (through the quantized kernels on the card).  Texts: a local
C-Eval directory or a text file, every text of it; else the synthetic
corpus (``--num-prompts``, default 200).  Activations are bfloat16 unless
``--dtype`` says otherwise: the card's kernels take bfloat16 or float32,
and the reference's checkpoints say float16.
"""
from __future__ import annotations

import argparse
import math

import torch

from ..config import TorchRuntimeConfig, resolve_device
from ..models import chatglm2 as M

_DEFAULT_RT = TorchRuntimeConfig()


@torch.no_grad()
def perplexity(params: dict, config, tokenizer, texts: list, batch_size: int = 20,
               dtype=torch.bfloat16, rt: TorchRuntimeConfig = _DEFAULT_RT) -> float:
    """exp(mean over batches of the batch's mean shifted cross-entropy)."""
    dev = params["final_ln"]["weight"].device
    losses = []
    for i in range(0, len(texts), batch_size):
        enc = tokenizer(texts[i:i + batch_size], padding=True, return_tensors="pt",
                        return_labels=True)
        loss, _ = M.forward(params, config.model_config, enc["input_ids"].to(dev),
                            attention_mask=enc["attention_mask"].to(dev),
                            labels=enc["labels"].to(dev), quant_type=config.quant_type,
                            dtype=dtype, rt=rt)
        losses.append(float(loss))
    return math.exp(sum(losses) / len(losses))


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--model", default="../models/chatglm2-6b-int4g32")
    p.add_argument("--ceval-dir", default=None)
    p.add_argument("--calib-file", default=None)
    p.add_argument("--num-prompts", type=int, default=None,
                   help="texts to evaluate (default: all of a given source, 200 synthetic)")
    p.add_argument("--batch-size", type=int, default=20)
    p.add_argument("--dtype", default="bfloat16", help="float32 / bfloat16 activations")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    return p.parse_args(argv)


def main(argv=None) -> float:
    args = parse_args(argv)
    device = resolve_device(args.device)  # CUDA unless asked: raises before any loading
    from ..config import dtype_from_name
    from ..loader import load_model_and_tokenizer
    from .data import load_calibration_texts

    config, params, tokenizer = load_model_and_tokenizer(args.model, args.dtype,
                                                         device=device)
    n = args.num_prompts or (10 ** 9 if args.calib_file or args.ceval_dir else 200)
    texts = load_calibration_texts(calib_file=args.calib_file, ceval_dir=args.ceval_dir,
                                   num_prompts=n)
    ppl = perplexity(params, config, tokenizer, texts, args.batch_size,
                     dtype_from_name(args.dtype))
    print(f"ppl: {ppl:.6f}")
    return ppl


if __name__ == "__main__":
    main()

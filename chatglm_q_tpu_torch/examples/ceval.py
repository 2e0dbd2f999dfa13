"""C-Eval validation accuracy under the reference protocol: the port's
examples/evaluations/ceval.py.

    python -m chatglm_q_tpu_torch.examples.ceval --model ../models/chatglm2-6b-int4g32 \\
        --ceval-dir ../data/ceval

One forward a question; the prediction is the argmax over the logits of
the four choice tokens "A"/"B"/"C"/"D" at the last position, with the
reference's prompt templates:

  direct (default):  "[Round 1]\\n\\n问：{q}\\n\\n答：正确的选项是："
  --cot:             two passes — thoughts from the think template through
                     ``GLMDecoder.generate`` at temperature 0.5, then the
                     final template scored.

Rows may carry the THUDM evaluation-set fields (``inputs_pretokenized``,
int ``label``) or the raw C-Eval fields (``question``/``A``-``D``/
``answer``); the question text is rebuilt from the raw fields when absent.
Activations are bfloat16 unless ``--dtype`` says otherwise (the card's
forward kernels take bfloat16, float16 or float32).
"""
from __future__ import annotations

import argparse
from collections import defaultdict

import torch

from ..config import TorchRuntimeConfig, resolve_device
from ..models import chatglm2 as M

_DEFAULT_RT = TorchRuntimeConfig()

# the reference's templates
THINK_TEMPLATE = "[Round 1]\n\n问：{}\n\n答："
FINAL_TEMPLATE = "[Round 1]\n\n问：{}\n\n答：{}\n综上所述，正确的选项是："
DIRECT_TEMPLATE = "[Round 1]\n\n问：{}\n\n答：正确的选项是："


def question_text(row: dict) -> str:
    """``inputs_pretokenized`` when present (THUDM eval set), else rebuilt."""
    if "inputs_pretokenized" in row:
        return row["inputs_pretokenized"]
    choices = "".join(f"\n{c}. {row[c]}" for c in ("A", "B", "C", "D") if c in row)
    return f"{row.get('question', '')}{choices}\n答案："


def row_label(row: dict) -> int:
    if "label" in row:
        return int(row["label"])
    return "ABCD".index(row["answer"]) if row.get("answer") in tuple("ABCD") else -1


@torch.no_grad()
def evaluate(params: dict, config, tokenizer, rows: list, dtype=torch.bfloat16,
             rt: TorchRuntimeConfig = _DEFAULT_RT, cot: bool = False):
    """(correct, total, {subject: [correct, total]})."""
    dev = params["final_ln"]["weight"].device
    choice_ids = [tokenizer[c] for c in ("A", "B", "C", "D")]
    decoder = None
    if cot:
        from ..serving.decoder import GLMDecoder

        decoder = GLMDecoder(config, params, tokenizer, rt=rt, dtype=dtype)
    per_cat = defaultdict(lambda: [0, 0])
    correct = total = 0
    for row in rows:
        question = question_text(row)
        if cot:
            thoughts = ""
            for text in decoder.generate(THINK_TEMPLATE.format(question), temperature=0.5):
                thoughts = text
            prompt = FINAL_TEMPLATE.format(question, thoughts)
        else:
            prompt = DIRECT_TEMPLATE.format(question)
        ids = torch.tensor([tokenizer.encode(prompt)], device=dev)
        logits = M.forward(params, config.model_config, ids, quant_type=config.quant_type,
                           dtype=dtype, rt=rt)[1][0, -1]
        pred = int(torch.argmax(logits[choice_ids]))
        ok = pred == row_label(row)
        cat = row.get("subject", "unknown")
        per_cat[cat][0] += ok
        per_cat[cat][1] += 1
        correct += ok
        total += 1
    return correct, total, dict(per_cat)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--model", default="../models/chatglm2-6b-int4g32")
    p.add_argument("--ceval-dir", required=True)
    p.add_argument("--dtype", default="bfloat16",
                   help="float32 / float16 / bfloat16 activations")
    p.add_argument("--cot", action="store_true", help="chain-of-thought 2-pass evaluation")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    return p.parse_args(argv)


def main(argv=None) -> float:
    args = parse_args(argv)
    device = resolve_device(args.device)  # CUDA unless asked: raises before any loading
    from ..config import dtype_from_name
    from ..loader import load_model_and_tokenizer
    from .data import load_ceval_val

    config, params, tokenizer = load_model_and_tokenizer(args.model, args.dtype,
                                                         device=device)
    rows = load_ceval_val(args.ceval_dir)
    if not rows:
        raise SystemExit(f"no C-Eval val rows under {args.ceval_dir}")
    correct, total, per_cat = evaluate(params, config, tokenizer, rows,
                                       dtype_from_name(args.dtype), cot=args.cot)
    print(f"overall: {correct}/{total} = {correct/total:.4f}")
    for cat, (c, t) in sorted(per_cat.items()):
        print(f"  {cat}: {c}/{t} = {c/t:.4f}")
    return correct / total


if __name__ == "__main__":
    main()

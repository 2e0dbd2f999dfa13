"""A tour of the continuous-batching engines on one model: dense, chunked
admission, paged, paged with the prefix cache, paged with speculation.
The port's examples/engine_demo.py.

    python -m chatglm_q_tpu_torch.examples.engine_demo                 # random weights, CUDA
    python -m chatglm_q_tpu_torch.examples.engine_demo --device cpu    # a tiny random model
    python -m chatglm_q_tpu_torch.examples.engine_demo --model ../models/chatglm2-6b-int4g32

With random weights the tokens mean nothing, but every scheduling feature
runs for real: on the card ChatGLM2-6B's widths at ``--layers`` layers
(int4g32 in bf16, the kernels' shapes), on the CPU a tiny config in f32.
Each variant's greedy tokens are compared with the dense engine's; in f32
they are equal, and ``--strict`` fails where one is not (in bf16 the
chunked and paged attention round differently from the whole-prompt
prefill, so a near tie may flip a token).
"""
from __future__ import annotations

import argparse
import time

import numpy as np


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default=None, help="local checkpoint directory (else random)")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--layers", type=int, default=2, help="random weights on the card: depth")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--strict", action="store_true",
                    help="exit 1 where a variant's tokens differ from the dense engine's")
    return ap.parse_args(argv)


def model(args, device):
    """(GLMLoadConfig, params, tokenizer or None, prompts)."""
    import torch

    from ..config import ChatGLM2Config, GLMLoadConfig
    from ..models import chatglm2 as M

    if args.model:
        from ..loader import load_model_and_tokenizer

        config, params, tokenizer = load_model_and_tokenizer(args.model, device=device)
        prompts = [f"[Round 1]\n\n问：讲个{i}句话的故事\n\n答：" for i in range(args.requests)]
        return config, params, tokenizer, prompts
    if device.type == "cuda":
        from ..bench import random_quantized_params

        mc = ChatGLM2Config(num_layers=args.layers, max_sequence_length=512)
        params = random_quantized_params(mc, "int4g32",
                                         torch.Generator(device=device).manual_seed(0), device)
    else:
        mc = ChatGLM2Config(hidden_size=256, inner_hidden_size=512, head_hidden_size=32,
                            num_multi_query_groups=2, num_attention_heads=8, num_layers=4,
                            vocab_size=512, max_sequence_length=256)
        params = M.init_params(torch.Generator().manual_seed(0), mc, "int4g32", device=device)
    config = GLMLoadConfig(model_config=mc, quant_type="int4g32",
                           torch_dtype="bfloat16" if device.type == "cuda" else "float32")
    rng = np.random.RandomState(0)
    shared = rng.randint(3, 500, size=48).tolist()  # a shared "system prompt"
    prompts = [shared + rng.randint(3, 500, size=24 + i).tolist() for i in range(args.requests)]
    return config, params, None, prompts


def run(name, eng, prompts, new_tokens):
    t0 = time.perf_counter()
    for p in prompts:
        if isinstance(p, str):
            eng.submit_text(p, max_new_tokens=new_tokens, temperature=0.0)
        else:
            eng.submit(p, max_new_tokens=new_tokens, temperature=0.0)
    while eng.has_work:
        eng.step()
    dt = time.perf_counter() - t0
    gen = sum(len(r.generated) for r in eng.finished)
    extra = {k: v for k, v in eng.stats.items() if k.startswith(("prefix", "spec")) and v}
    print(f"{name:28s} {gen:4d} tokens in {dt:6.1f}s  ({gen / dt:7.1f} tok/s) {extra}")
    return [r.generated for r in sorted(eng.finished, key=lambda r: r.req_id)]


def main(argv=None) -> int:
    args = parse_args(argv)
    from ..config import resolve_device
    from ..serving import PagedServingEngine, ServingEngine

    device = resolve_device(args.device)
    config, params, tokenizer, prompts = model(args, device)
    common = dict(max_batch=4, decode_chunk=8, device=device)
    paged = dict(num_pages=32, page_size=64, **common)
    base = run("dense", ServingEngine(config, params, tokenizer, **common), prompts,
               args.new_tokens)
    outs = {
        "chunked admission": run("dense + chunked admission", ServingEngine(
            config, params, tokenizer, prefill_chunk_size=64, **common), prompts,
            args.new_tokens),
        "paged": run("paged (64-token pages)", PagedServingEngine(
            config, params, tokenizer, **paged), prompts, args.new_tokens),
        "paged + prefix cache": run("paged + prefix cache", PagedServingEngine(
            config, params, tokenizer, prefill_chunk_size=64, prefix_cache=True, **paged),
            prompts, args.new_tokens),
        "paged + speculative": run("paged + speculative (k=7)", PagedServingEngine(
            config, params, tokenizer, speculative_k=7, **paged), prompts, args.new_tokens),
    }
    bad = [name for name, got in outs.items() if got != base]
    if bad:
        print(f"differ from the dense engine's tokens: {bad}")
        return 1 if args.strict else 0
    print("all engine variants token-exact vs dense")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

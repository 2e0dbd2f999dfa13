"""Export the one-token decode step with ``torch.export``: the port's
examples/export_stablehlo.py.

    python -m chatglm_q_tpu_torch.examples.export [--model DIR] [--out decode_step.pt2] \\
        [--batch 1] [--cache-len 2048] [--device cpu]

The exported program takes ``(params, ids (B,), k, v (L, B, G, T, D),
lengths (B,))``, returns ``(logits (B, V), lengths + 1)`` and writes the
new token's K/V into ``k`` and ``v`` in place (a mutated input, as the
eager step does).  The weights are an input, not part of the artifact (as
``jax.export`` keeps them out of its StableHLO): it holds the computation
alone.  On the card the kernels' entry points trace as the custom ops of
ops/export_ops.py (import it before ``torch.export.load``); on the CPU the
plain versions trace as ATen ops.

The script saves the program with ``torch.export.save``, reloads it with
``torch.export.load`` and runs it once more against the eager step on the
same inputs: logits, lengths and both caches must be equal.  With no
``--model`` it builds a tiny random int4g32 model.
"""
from __future__ import annotations

import argparse

import torch

from ..config import ChatGLM2Config, TorchRuntimeConfig, resolve_device
from ..models import chatglm2 as M
from ..ops import export_ops  # noqa: F401  (registers the custom ops)

TINY = ChatGLM2Config(hidden_size=256, inner_hidden_size=512, head_hidden_size=32,
                      num_multi_query_groups=2, num_attention_heads=8, num_layers=2,
                      vocab_size=1024, max_sequence_length=256)


class DecodeStep(torch.nn.Module):
    """``decode_step`` as a module over its tensors (what torch.export takes)."""

    def __init__(self, config: ChatGLM2Config, quant_type: str, dtype, rt: TorchRuntimeConfig):
        super().__init__()
        self.config, self.quant_type, self.dtype, self.rt = config, quant_type, dtype, rt

    def forward(self, params, ids, k, v, lengths):
        logits, cache = M.decode_step(params, self.config, ids, M.KVCache(k, v, lengths),
                                      self.quant_type, self.dtype, self.rt)
        return logits, cache.lengths


def export_decode_step(params: dict, config: ChatGLM2Config, quant_type: str, dtype,
                       cache: M.KVCache, rt: TorchRuntimeConfig = None):
    """The ``ExportedProgram`` of one decode step at ``cache``'s shapes.  The
    cache is only traced (fake tensors): nothing is written."""
    step = DecodeStep(config, quant_type, dtype, rt or TorchRuntimeConfig())
    ids = torch.zeros((cache.k.shape[1],), dtype=torch.int32, device=cache.k.device)
    return torch.export.export(step, (params, ids, cache.k, cache.v, cache.lengths),
                               strict=False)


def round_trip(params: dict, config: ChatGLM2Config, quant_type: str, dtype, cache: M.KVCache,
               ids: torch.Tensor, path: str, rt: TorchRuntimeConfig = None) -> dict:
    """Export, save, load and run the decode step on copies of ``cache``
    beside the eager step; returns both results and whether each part is
    bit-equal."""
    rt = rt or TorchRuntimeConfig()
    eager_cache = M.KVCache(cache.k.clone(), cache.v.clone(), cache.lengths.clone())
    logits, eager_cache = M.decode_step(params, config, ids, eager_cache, quant_type, dtype, rt)
    ep = export_decode_step(params, config, quant_type, dtype, cache, rt)
    ep.example_inputs = None  # they hold the weights: the artifact keeps the computation alone
    torch.export.save(ep, path)
    loaded = torch.export.load(path)
    k, v = cache.k.clone(), cache.v.clone()
    got_logits, got_lengths = loaded.module()(params, ids, k, v, cache.lengths.clone())
    return {"logits": (logits, got_logits), "k": (eager_cache.k, k), "v": (eager_cache.v, v),
            "lengths": (eager_cache.lengths, got_lengths),
            "equal": {name: bool(torch.equal(*pair)) for name, pair in
                      (("logits", (logits, got_logits)), ("k", (eager_cache.k, k)),
                       ("v", (eager_cache.v, v)),
                       ("lengths", (eager_cache.lengths, got_lengths)))},
            "ops": sorted({str(n.target) for n in ep.graph.nodes
                           if export_ops.NAMESPACE in str(n.target)})}


def prefilled_cache(params, config, quant_type, dtype, batch, cache_len, device, seed=0,
                    rt: TorchRuntimeConfig = None):
    """A cache of ``batch`` rows prefilled with a random prompt of 12-20
    tokens each (so the step attends real slots), and the next ids."""
    gen = torch.Generator().manual_seed(seed)
    n = torch.randint(12, 21, (batch,), generator=gen)
    prompt = torch.randint(3, config.vocab_size, (batch, int(n.max())), generator=gen)
    cache = M.init_kv_cache(config, batch, cache_len, dtype, device)
    logits, cache = M.prefill(params, config, prompt.to(device), n.to(device), cache, quant_type,
                              dtype, rt or TorchRuntimeConfig())
    return cache, logits.argmax(-1).to(torch.int32)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default=None, help="checkpoint dir; default a tiny random model")
    ap.add_argument("--out", default="decode_step.pt2")
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--cache-len", type=int, default=None)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    if args.model:
        from ..loader import load_model_and_tokenizer

        cfg, params, _ = load_model_and_tokenizer(args.model, device=device,
                                                  load_tokenizer=False)
        config, quant_type, dtype = cfg.model_config, cfg.quant_type, cfg.activation_dtype
    else:
        config, quant_type, dtype = TINY, "int4g32", torch.bfloat16
        params = M.init_params(torch.Generator(device=device).manual_seed(0), config, quant_type,
                               device=device)
    cache_len = args.cache_len or min(2048, config.max_sequence_length)
    cache, ids = prefilled_cache(params, config, quant_type, dtype, args.batch, cache_len, device)
    res = round_trip(params, config, quant_type, dtype, cache, ids, args.out)
    print(f"exported the decode step → {args.out} (custom ops: {res['ops'] or 'none'})")
    print(f"reloaded and run: equal to the eager step {res['equal']}")
    return 0 if all(res["equal"].values()) else 1


if __name__ == "__main__":
    raise SystemExit(main())

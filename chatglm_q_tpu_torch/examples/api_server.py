"""Launch the OpenAI-style API server over a checkpoint: the port's
examples/api_server.py.

    python -m chatglm_q_tpu_torch.examples.api_server --model ../models/chatglm2-6b-int4g32 \\
        --port 8000 --max-batch 8 [--paged] [--prefill-chunk 128] [--lookahead]

The checkpoint (a local directory) loads with its tokenizer onto
``--device`` (CUDA unless asked) into a ``ServingEngine``, or with
``--paged`` a ``PagedServingEngine`` with the prefix cache, behind
``GLMAPIServer``.  Then talk to it with any OpenAI client:

    curl http://127.0.0.1:8000/v1/chat/completions -d '{
      "model": "chatglm2-6b", "stream": true,
      "messages": [{"role": "user", "content": "你好"}]}'
"""
from __future__ import annotations

import argparse


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", required=True, help="local checkpoint directory")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8000, help="0 picks a free port")
    ap.add_argument("--name", default="chatglm2-6b", help="served model name")
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--max-seq-len", type=int, default=None)
    ap.add_argument("--decode-chunk", type=int, default=16)
    ap.add_argument("--prefill-chunk", type=int, default=None,
                    help="chunked prefill size (long prompts never stall decode)")
    ap.add_argument("--paged", action="store_true", help="paged KV engine with prefix caching")
    ap.add_argument("--page-size", type=int, default=256, help="paged engine: tokens a page")
    ap.add_argument("--num-pages", type=int, default=64, help="paged engine: pages in the pool")
    ap.add_argument("--lookahead", action="store_true",
                    help="overlap host scheduling with device compute (dense engine)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    return ap.parse_args(argv)


def build_server(args):
    """The engine and ``GLMAPIServer`` of ``args`` (not started)."""
    from ..config import resolve_device
    from ..loader import load_model_and_tokenizer
    from ..serving import PagedServingEngine, ServingEngine
    from ..serving.api_server import GLMAPIServer

    device = resolve_device(args.device)
    config, params, tokenizer = load_model_and_tokenizer(args.model, device=device)
    kw = dict(max_batch=args.max_batch, max_seq_len=args.max_seq_len,
              decode_chunk=args.decode_chunk, prefill_chunk_size=args.prefill_chunk,
              device=device)
    if args.paged:
        engine = PagedServingEngine(config, params, tokenizer, num_pages=args.num_pages,
                                    page_size=args.page_size,
                                    prefix_cache=args.prefill_chunk is not None, **kw)
    else:
        engine = ServingEngine(config, params, tokenizer, lookahead=args.lookahead, **kw)
    return GLMAPIServer(engine, host=args.host, port=args.port, model_name=args.name)


def main(argv=None) -> None:
    server = build_server(parse_args(argv))
    print(f"serving {server.model_name} on http://{server.host}:{server.port}/v1", flush=True)
    server.serve()


if __name__ == "__main__":
    main()

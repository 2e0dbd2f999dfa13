"""Terminal chat over a checkpoint: the port's examples/cli_chat.py.

    python -m chatglm_q_tpu_torch.examples.cli_chat --model ../models/chatglm2-6b-int4g32

Reads a question a line from standard input and streams the answer of
``GLMDecoder.generate`` over the chat template with the history so far; an
empty line or the end of the input quits, ``/clear`` resets the history.
"""
from __future__ import annotations

import argparse


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default="../models/chatglm2-6b-int4g32",
                    help="local checkpoint directory")
    ap.add_argument("--max-tokens", type=int, default=400)
    ap.add_argument("--temperature", type=float, default=1.0)
    ap.add_argument("--top-p", type=float, default=0.8)
    ap.add_argument("--top-k", type=int, default=100)
    ap.add_argument("--seed", type=int, default=None)
    ap.add_argument("--time-log", action="store_true")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    return ap.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)
    from ..serving import GLMDecoder
    from ..serving.chat import chat_template

    decoder = GLMDecoder.from_pretrained(args.model, device=args.device,
                                         time_log=args.time_log)
    history: list[tuple[str, str]] = []
    print("ChatGLM2 on CUDA — empty line to quit, '/clear' to reset history")
    while True:
        try:
            query = input("\n问：").strip()
        except (EOFError, KeyboardInterrupt):
            break
        if not query:
            break
        if query == "/clear":
            history = []
            continue
        shown, answer = 0, ""
        print("答：", end="", flush=True)
        for partial in decoder.generate(chat_template(history, query),
                                        max_generated_tokens=args.max_tokens, top_k=args.top_k,
                                        top_p=args.top_p, temperature=args.temperature,
                                        seed=args.seed):
            print(partial[shown:], end="", flush=True)
            shown, answer = len(partial), partial
        print()
        history.append((query, answer))


if __name__ == "__main__":
    main()

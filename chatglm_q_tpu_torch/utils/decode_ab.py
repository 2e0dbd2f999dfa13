"""Decode and prefill speed of two checkouts of the port, in turns, on one card.

    python -m chatglm_q_tpu_torch.utils.decode_ab OTHER_CHECKOUT [--rounds 1]

Each turn is a fresh process in one checkout's root (so each builds and
imports its own ``chatglm_q_tpu_torch``): ChatGLM2-6B int4g32 with 28 layers
of random weights (``bench.random_quantized_params``, seed 1), a 128-token
prompt, a 1024-slot cache, and ``bench.decode_rate`` at batch 1 and 4, twice
each: its decode ms a step and its prefill ms (host clock around one
prefill of batch x 128 tokens ending in a sync).  The turns run other, this,
this, other per round, so a drift of the host over the call falls on both
sides alike.  Prints the card's name and power limit, one JSON line per
turn, and a last JSON line with every reading by checkout.  Both checkouts need only ``bench.random_quantized_params``
and ``bench.decode_rate``, which the port has had since its first slice.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys

CHILD = """
import json, torch
from chatglm_q_tpu_torch import ChatGLM2Config, TorchRuntimeConfig
from chatglm_q_tpu_torch.bench import decode_rate, random_quantized_params
cfg = ChatGLM2Config()
params = random_quantized_params(cfg, "int4g32", torch.Generator(device="cuda").manual_seed(1))
out = {}
for batch in (1, 4):
    runs = [decode_rate(params, cfg, "int4g32", batch, 128, 1024, TorchRuntimeConfig())
            for _ in range(2)]
    out[batch] = {k: [r[k] for r in runs] for k in ("decode_ms_per_step", "prefill_ms")}
print(json.dumps(out))
"""


def run_turn(root: pathlib.Path) -> dict:
    res = subprocess.run([sys.executable, "-c", CHILD], cwd=root, capture_output=True, text=True,
                         timeout=600)
    if res.returncode != 0:
        raise RuntimeError(f"decode turn in {root} failed:\n{res.stderr[-4000:]}")
    return json.loads(res.stdout.strip().splitlines()[-1])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", type=pathlib.Path, help="root of the other checkout")
    ap.add_argument("--rounds", type=int, default=1)
    args = ap.parse_args(argv)
    this = pathlib.Path(__file__).resolve().parents[2]
    sides = {"other": args.other.resolve(), "this": this}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    keys = ("decode_ms_per_step", "prefill_ms")
    readings = {k: {side: {"1": [], "4": []} for side in sides} for k in keys}
    for _ in range(args.rounds):
        for side in ("other", "this", "this", "other"):
            r = run_turn(sides[side])
            for batch, by_key in r.items():
                for k in keys:
                    readings[k][side][batch] += by_key[k]
            print(json.dumps({"side": side, "root": str(sides[side]), **r}), flush=True)
    print(json.dumps({"card": smi, **readings}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

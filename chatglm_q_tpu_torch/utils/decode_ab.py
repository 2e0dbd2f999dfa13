"""Decode and prefill speed of two checkouts of the port, in turns, on one card.

    python -m chatglm_q_tpu_torch.utils.decode_ab OTHER_CHECKOUT [--rounds 1] [--dyn | --device]
    python -m chatglm_q_tpu_torch.utils.decode_ab --graphs [--rounds 1]

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

With ``--dyn`` a turn times the prefills of the dynamic-int8 modes instead:
28 layers of int8 and of int4g32 random weights (seed 1) under
``TorchRuntimeConfig(dynamic_int8=True)``, one prefill of a 57-token prompt
(phase 5's chat prompt length) in each and of 4 x 128 tokens in int8: the
device ms of one traced prefill (torch.profiler, every kernel's time) and
the host-clock ms (the median of three, ending in a sync).  It needs
``models.chatglm2.prefill`` and ``init_kv_cache``, there since slice 1.

With ``--device`` a turn reads a batch-1 decode step's device time in four
modes: 28 layers of int8 random weights (seed 1) weight-only and under
``dynamic_int8``, then of int4g32 weight-only and under ``dynamic_int8``; a
128-token prompt, a 1024-slot cache, then 8 greedy steps of
``multi_step_decode`` under torch.profiler; then int4g32's paged decode at
batch 4 (``decode_step_paged`` over four 128-token rows on pages of 256):
device ms a step (every kernel's time), the device launches a step
(kernels, copies and fills) and by kernel, the host-clock ms a step of the
same traced steps, and the largest kernels (device us and launches a step).
It needs ``multi_step_decode`` and ``paged_kv``, there since slice 3.

With ``--graphs`` both sides are this checkout: the turns run the default
measurement with the decode programs replayed from CUDA graphs ("captured")
and from eager launches (``TorchRuntimeConfig(cuda_graphs=False)``,
"eager"), in the order eager, captured, captured, eager.
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

GRAPHS_CHILD = CHILD.replace("TorchRuntimeConfig()", "TorchRuntimeConfig(cuda_graphs=GRAPHS)")

DYN_CHILD = """
import json, time, torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile
from chatglm_q_tpu_torch import ChatGLM2Config, TorchRuntimeConfig
from chatglm_q_tpu_torch.bench import random_quantized_params
from chatglm_q_tpu_torch.models import chatglm2 as M
cfg = ChatGLM2Config()
rt = TorchRuntimeConfig(dynamic_int8=True)
gen = torch.Generator(device="cuda").manual_seed(2)
out = {}
for quant, shapes in (("int8", ((1, 57), (4, 128))), ("int4g32", ((1, 57),))):
    params = random_quantized_params(cfg, quant, torch.Generator(device="cuda").manual_seed(1))
    for batch, S in shapes:
        ids = torch.randint(0, cfg.vocab_size, (batch, S), device="cuda", generator=gen)
        lengths = torch.full((batch,), S, dtype=torch.int32, device="cuda")
        cache = lambda: M.init_kv_cache(cfg, batch, 1024, torch.bfloat16)
        run = lambda: M.prefill(params, cfg, ids, lengths, cache(), quant, torch.bfloat16, rt)
        run()
        walls = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        dev = sum(e.self_device_time_total for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA) / 1e3
        out[f"{quant}+dyn {batch}x{S}"] = {"device_ms": dev, "host_ms": sorted(walls)[1]}
    del params
    torch.cuda.empty_cache()
print(json.dumps(out))
"""


DEVICE_CHILD = """
import json, time, torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile
from chatglm_q_tpu_torch import ChatGLM2Config, TorchRuntimeConfig
from chatglm_q_tpu_torch.bench import random_quantized_params
from chatglm_q_tpu_torch.models import chatglm2 as M
from chatglm_q_tpu_torch.models import paged_kv as PK
cfg = ChatGLM2Config()
out, steps = {}, 8
bf16 = torch.bfloat16


def traced(run):
    run(2)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(steps)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ev = sorted((e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
                 and e.self_device_time_total > 0), key=lambda e: -e.self_device_time_total)
    return {"device_ms_per_step": sum(e.self_device_time_total for e in ev) / 1e3 / steps,
            "device_launches_per_step": sum(e.count for e in ev) / steps,
            "traced_host_ms_per_step": wall * 1e3 / steps,
            "top_us_per_step": [(e.key[:70], e.self_device_time_total / steps, e.count / steps)
                                for e in ev[:6]],
            "launches_by_kernel": {e.key: e.count / steps for e in ev}}


for quant, modes in (("int8", (False, True)), ("int4g32", (False, True))):
    params = random_quantized_params(cfg, quant, torch.Generator(device="cuda").manual_seed(1))
    for dyn in modes:
        rt = TorchRuntimeConfig(dynamic_int8=dyn)
        cache = M.init_kv_cache(cfg, 1, 1024, bf16)
        ids = torch.zeros((1, 128), dtype=torch.long, device="cuda")
        lengths = torch.full((1,), 128, dtype=torch.int32, device="cuda")
        logits, cache = M.prefill(params, cfg, ids, lengths, cache, quant, bf16, rt)
        first = torch.argmax(logits, -1).to(torch.int32)
        out[quant + ("+dyn" if dyn else "")] = traced(
            lambda n: M.multi_step_decode(params, cfg, first, cache, n, None, quant, bf16, rt))
    if quant == "int4g32":  # a paged decode step at batch 4: 4 rows of 4 pages of 256
        rt = TorchRuntimeConfig()
        pc = PK.init_paged_kv_cache(cfg, 4, 17, 1024, 256, bf16)
        pc.page_table.copy_(torch.arange(1, 17, dtype=torch.int32, device="cuda").reshape(4, 4))
        ids = torch.zeros((4, 128), dtype=torch.long, device="cuda")
        lengths = torch.full((4,), 128, dtype=torch.int32, device="cuda")
        logits, pc = PK.prefill_paged(params, cfg, ids, lengths, pc, quant, bf16, rt)
        tok = torch.argmax(logits, -1).to(torch.int32)

        def paged(n, pc=pc):
            for _ in range(n):
                logits, pc = PK.decode_step_paged(params, cfg, tok, pc, quant, bf16, rt)
            return logits

        out["int4g32 paged batch 4"] = traced(paged)
    del params
    torch.cuda.empty_cache()
print(json.dumps(out))
"""


def run_turn(root: pathlib.Path, child: str = CHILD) -> dict:
    res = subprocess.run([sys.executable, "-c", child], cwd=root, capture_output=True, text=True,
                         timeout=600)
    if res.returncode != 0:
        raise RuntimeError(f"decode turn in {root} failed:\n{res.stderr[-4000:]}")
    return json.loads(res.stdout.strip().splitlines()[-1])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", type=pathlib.Path, nargs="?", help="root of the other checkout")
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--dyn", action="store_true", help="the dynamic-int8 prefills instead")
    ap.add_argument("--device", action="store_true",
                    help="a batch-1 decode step's device time and launches instead")
    ap.add_argument("--graphs", action="store_true",
                    help="this checkout's decode captured against eager, in turns")
    args = ap.parse_args(argv)
    if (args.other is None) != args.graphs:
        ap.error("give OTHER_CHECKOUT, or --graphs alone")
    this = pathlib.Path(__file__).resolve().parents[2]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    if args.graphs:
        turns = {"eager": [], "captured": []}
        for _ in range(args.rounds):
            for side in ("eager", "captured", "captured", "eager"):
                child = GRAPHS_CHILD.replace("GRAPHS", "False" if side == "eager" else "True")
                turns[side].append(run_turn(this, child))
                print(json.dumps({"side": side, **turns[side][-1]}), flush=True)
        print(json.dumps({"card": smi, **turns}))
        return 0
    sides = {"other": args.other.resolve(), "this": this}
    if args.dyn or args.device:
        child = DEVICE_CHILD if args.device else DYN_CHILD
        turns = {side: [] for side in sides}
        for _ in range(args.rounds):
            for side in ("other", "this", "this", "other"):
                turns[side].append(run_turn(sides[side], child))
                print(json.dumps({"side": side, "root": str(sides[side]), **turns[side][-1]}),
                      flush=True)
        print(json.dumps({"card": smi, **turns}))
        return 0
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

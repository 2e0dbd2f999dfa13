"""The quantized matmuls of two checkouts of the port, in turns, on one card.

    python -m chatglm_q_tpu_torch.utils.matmul_ab OTHER_CHECKOUT [--rounds 1] [--decode]

Each turn is a fresh process in one checkout's root (so each builds and
imports its own ``chatglm_q_tpu_torch``) that times, by CUDA events with the
stream held (``utils.timing.cuda_event_ms``), ``int8_matmul`` (B6),
``int8_matmul_t`` (B13) and ``int4g32_matmul_t`` (B14) on bf16 activations
at the ChatGLM2-6B linears (K x N 4096 x 4096, 4096 x 512, 4096 x 4096,
4096 x 13824, 13824 x 4096, 4096 x 65536; the transposed forms take g (M, N)
and give (M, K)) for M = 17, 48, 128, 512, 1024, each call rotating over
enough copies of the weights to exceed the 50 MB L2 (random weights and
activations from seed 3).  The turns run other, this, this, other per
round.  Prints the card's name and power limit, one JSON line per turn,
and a last JSON line with every reading by checkout: ms[kernel][linear][M].
Both checkouts need only those three wrappers, which the port has had
since its fourth slice.

With ``--decode`` a turn times the decode forms instead, at M = 1, 4 and 16
on the same linears: ``int4g32_matmul`` (B1's split-K kernel), B6's
``int8_matmul``, B7's and B8's kernels alone on activations quantized
beforehand (the wrapper under its name in either checkout:
``int8_dyn_splitk`` / ``int4_dyn_splitk``, or before them ``int8_dyn_gemv`` /
``int4_dyn_gemv``, which include their second pass), and the backward
forms ``int8_matmul_t`` (B13) and ``int4g32_matmul_t`` (B14) on bf16 g (M,
N): the split-K tensor-core kernels, or before them the CUDA-core
``t_gemv_kernel``.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys

M_ROWS = (17, 48, 128, 512, 1024)
DECODE_M_ROWS = (1, 4, 16)
LINEARS = [("q_proj", 4096, 4096), ("kv_proj", 4096, 512), ("o_proj", 4096, 4096),
           ("w_in", 4096, 13824), ("w_out", 13824, 4096), ("lm_head", 4096, 65536)]

CHILD = """
import json, math, sys, torch
from chatglm_q_tpu_torch.ops import int8_matmul as I8, quant_matmul as QM
from chatglm_q_tpu_torch.utils.timing import cuda_event_ms
M_ROWS, LINEARS = json.loads(sys.argv[1])
gen = torch.Generator(device="cuda").manual_seed(3)
out = {"int8_matmul": {}, "int8_matmul_t": {}, "int4g32_matmul_t": {}}
for name, K, N in LINEARS:
    copies = max(2, min(64, math.ceil(160e6 / (K * N))))
    w = torch.randint(-128, 128, (copies, K, N), dtype=torch.int8, device="cuda", generator=gen)
    s8 = (0.5 + torch.rand((copies, N), device="cuda", generator=gen)) * 0.01
    packed = torch.randint(0, 256, (copies, K // 2, N), dtype=torch.uint8, device="cuda",
                           generator=gen)
    s4 = (torch.rand((copies, K // 32, N), device="cuda", generator=gen) * 0.02).to(torch.bfloat16)
    for fn, a_cols, wts, key in ((I8.int8_matmul, K, (w, s8), "int8_matmul"),
                                 (I8.int8_matmul_t, N, (w, s8), "int8_matmul_t"),
                                 (QM.int4g32_matmul_t, N, (packed, s4), "int4g32_matmul_t")):
        out[key][name] = {}
        for M in M_ROWS:
            a = torch.randn((M, a_cols), device="cuda", generator=gen).to(torch.bfloat16)
            n = len(wts[0])
            out[key][name][M] = cuda_event_ms(
                lambda i: fn(a, wts[0][i % n], wts[1][i % n]), iters=30)
    del w, s8, packed, s4
print(json.dumps(out))
"""

DECODE_CHILD = """
import json, math, sys, torch
from chatglm_q_tpu_torch.ops import dyn_matmul as D, int8_matmul as I8, quant_matmul as QM
from chatglm_q_tpu_torch.utils.timing import cuda_event_ms
M_ROWS, LINEARS = json.loads(sys.argv[1])
b7 = getattr(D, "int8_dyn_splitk", None) or D.int8_dyn_gemv
b8 = getattr(D, "int4_dyn_splitk", None) or D.int4_dyn_gemv
gen = torch.Generator(device="cuda").manual_seed(3)
out = {"int4g32_matmul": {}, "int8_matmul": {}, b7.__name__: {}, b8.__name__: {},
       "int8_matmul_t": {}, "int4g32_matmul_t": {}}
for name, K, N in LINEARS:
    copies = max(2, min(64, math.ceil(160e6 / (K * N))))
    w = torch.randint(-128, 128, (copies, K, N), dtype=torch.int8, device="cuda", generator=gen)
    s8 = (0.5 + torch.rand((copies, N), device="cuda", generator=gen)) * 0.01
    packed = torch.randint(0, 256, (copies, K // 2, N), dtype=torch.uint8, device="cuda",
                           generator=gen)
    s4 = (torch.rand((copies, K // 32, N), device="cuda", generator=gen) * 0.02).to(torch.bfloat16)
    for key in out:
        out[key][name] = {}
    for M in M_ROWS:
        x = torch.randn((M, K), device="cuda", generator=gen).to(torch.bfloat16)
        g = torch.randn((M, N), device="cuda", generator=gen).to(torch.bfloat16)
        xq, sx = D.dyn_quantize_rows(x)
        for key, fn, (wt, st) in (
                ("int4g32_matmul", lambda a, b: QM.int4g32_matmul(x, a, b), (packed, s4)),
                ("int8_matmul", lambda a, b: I8.int8_matmul(x, a, b), (w, s8)),
                (b7.__name__, lambda a, b: b7(xq, sx, a, b, x.dtype), (w, s8)),
                (b8.__name__, lambda a, b: b8(xq, sx, a, b, x.dtype), (packed, s4)),
                ("int8_matmul_t", lambda a, b: I8.int8_matmul_t(g, a, b), (w, s8)),
                ("int4g32_matmul_t", lambda a, b: QM.int4g32_matmul_t(g, a, b), (packed, s4))):
            out[key][name][M] = cuda_event_ms(lambda i: fn(wt[i % copies], st[i % copies]),
                                              iters=30)
    del w, s8, packed, s4
print(json.dumps(out))
"""


def run_turn(root: pathlib.Path, decode: bool = False) -> dict:
    arg = json.dumps([list(DECODE_M_ROWS if decode else M_ROWS), LINEARS])
    res = subprocess.run([sys.executable, "-c", DECODE_CHILD if decode else CHILD, arg],
                         cwd=root, capture_output=True, text=True, timeout=900)
    if res.returncode != 0:
        raise RuntimeError(f"matmul turn in {root} failed:\n{res.stderr[-4000:]}")
    return json.loads(res.stdout.strip().splitlines()[-1])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", type=pathlib.Path, help="root of the other checkout")
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--decode", action="store_true", help="the decode forms instead")
    args = ap.parse_args(argv)
    this = pathlib.Path(__file__).resolve().parents[2]
    sides = {"other": args.other.resolve(), "this": this}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    readings = {side: [] for side in sides}
    for _ in range(args.rounds):
        for side in ("other", "this", "this", "other"):
            r = run_turn(sides[side], args.decode)
            readings[side].append(r)
            print(json.dumps({"side": side, "root": str(sides[side]), "ms": r}), flush=True)
    print(json.dumps({"card": smi, "ms": readings}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

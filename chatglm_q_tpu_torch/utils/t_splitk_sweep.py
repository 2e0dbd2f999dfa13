"""Time the transposed split-K kernel (B13 / B14 at bf16 M ≤ 16,
``csrc/common.cuh``'s ``t_splitk_mma_kernel``) at every split count of the
contraction, on the card.

  python -m chatglm_q_tpu_torch.utils.t_splitk_sweep [--m 1,16] [--linears q_proj,kv_proj]

For each main-path linear of ChatGLM2-6B transposed (g (M, N) → (M, K),
storage shapes) and each M it launches ``t_splitk_call`` with the built-in
plan and with every other split count of the contraction's 64-element
chunks the kernel takes (stages as ``t_splitk_plan`` sizes them), each
result within ``KERNEL_TOL`` of the plain version, and times it by CUDA
events with the stream held (``utils/timing.cuda_event_ms``) over copies of
the weight rotated past 160 MB.  Prints the card's name and power limit, a
line per shape (splits × chunks a split: ms), and a last JSON line with
every reading.  The plan's rules (``t_splitk_plan``) rest on these times.
"""
from __future__ import annotations

import argparse
import json
import math
import subprocess

import torch

from ..ops import int8_matmul as I8
from ..ops import quant_matmul as QM
from .timing import cuda_event_ms

LINEARS = {"q_proj": (4096, 4096), "kv_proj": (4096, 512), "o_proj": (4096, 4096),
           "w_in_h": (4096, 13824), "w_out": (13824, 4096), "lm_head": (4096, 65536)}
KERNEL_TOL = 1e-2      # of max|plain| (chip_smoke.py's KERNEL_TOL)
ROTATE_BYTES = 160e6   # past the 50 MB L2
SPLITS = (1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 64)


def candidates(M: int, K: int, N: int) -> list:
    """The built-in plan first, then one plan for each other split count the
    kernel takes."""
    built = QM.t_splitk_plan(M, K, N)
    mt, C = built[0], -(-N // QM.TSK_CHUNK)
    out = [built]
    for cps in sorted({-(-C // n) for n in SPLITS}):
        cs = 4
        while cs < cps and QM.t_splitk_smem(mt, cs + 4) <= QM.TSK_SMEM_MAX:
            cs += 4
        plan = (mt, -(-C // cps), cps, cs)
        if plan[1:3] != built[1:3] and QM.t_splitk_problem(M, K, N, plan) is None:
            out.append(plan)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--m", default="1,16")
    ap.add_argument("--linears", default=",".join(LINEARS))
    args = ap.parse_args(argv)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    gen = torch.Generator(device="cuda").manual_seed(5)
    readings = {}
    for lin in args.linears.split(","):
        K, N = LINEARS[lin]
        copies = max(2, min(64, math.ceil(ROTATE_BYTES / (K * N))))
        w = torch.randint(-128, 128, (copies, K, N), dtype=torch.int8, device="cuda",
                          generator=gen)
        s8 = (0.5 + torch.rand((copies, N), device="cuda", generator=gen)) * 0.01
        packed = torch.randint(0, 256, (copies, K // 2, N), dtype=torch.uint8, device="cuda",
                               generator=gen)
        s4 = (torch.rand((copies, K // 32, N), device="cuda", generator=gen) * 0.02
              ).to(torch.bfloat16)
        for M in (int(v) for v in args.m.split(",")):
            g = torch.randn((M, N), device="cuda", generator=gen).to(torch.bfloat16)
            for kind, entry, plain, wt, st in (
                    ("int8", "chatglm_int8_t_splitk", I8.int8_matmul_t_plain, w, s8),
                    ("int4g32", "chatglm_int4_t_splitk", QM.int4g32_matmul_t_plain, packed, s4)):
                want = plain(g, wt[0], st[0]).float()
                row = []
                for plan in candidates(M, K, N):
                    got = QM.t_splitk_call(entry, g, wt[0], st[0], K, plan).float()
                    rel = ((got - want).abs().max() / want.abs().max().clamp_min(1e-30)).item()
                    if rel > KERNEL_TOL:
                        raise RuntimeError(f"{kind} {lin} M={M} plan {plan}: rel err {rel}")
                    ms = cuda_event_ms(lambda i, p=plan: QM.t_splitk_call(
                        entry, g, wt[i % copies], st[i % copies], K, p), iters=30)
                    row.append({"plan": list(plan), "ms": ms})
                readings[f"{kind} {lin} M={M}"] = row
                print(f"{kind:7s} {lin:8s} M={M:2d} built-in {tuple(row[0]['plan'])}: "
                      + "  ".join(f"{r['plan'][1]}x{r['plan'][2]} {r['ms']:.5f}"
                                  for r in sorted(row, key=lambda r: r["plan"][1])), flush=True)
        del w, s8, packed, s4
        torch.cuda.empty_cache()
    print(json.dumps({"card": smi, "readings": readings}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

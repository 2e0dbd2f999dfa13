"""Sweep the matmul kernels' plans on the card and record the fastest exact
one in the plan table (ops/autotune.py): the counterpart of
benchmarks/autotune_sweep.py.

  python -m chatglm_q_tpu_torch.utils.autotune_sweep --kernel int4 --m 1,16,128 \\
      [--linears q_proj,w_out] [--record] [--json out.json]

For each main-path linear of ChatGLM2-6B (storage shapes) and each M it
times the built-in plan and its neighbours (other K splits, column widths
and staging for the split-K kernels at M ≤ 64; other tiles and K splits
for the Hopper kernels above), each launched through the wrapper the model
calls (``int4g32_matmul``, ``int8_matmul``) under ``autotune.override``.
Times are ``utils/timing.cuda_event_ms`` (the stream held while the
launches are enqueued) over copies of the weight rotated past 160 MB, so
every launch reads its weight from HBM, as a decode step does.  A candidate
may be recorded only if it is as exact as the kernels are held to be: within
``KERNEL_TOL`` of max|plain| and within ``SUM_TOL`` of the sum of its
terms' magnitudes beyond one bf16 rounding of the exact (f64) value.
``--record`` writes each shape's fastest exact plan to ``table_path()``
(``$CHATGLM_Q_TPU_TORCH_AUTOTUNE``), never to the packaged table.

A table entry serves every M of its bucket (``autotune.py``), so a split-K
candidate other than M's built-in plan must fit the bucket's largest M
(8 · m-tiles rows: its shared memory grows with M), and only such a plan
may be recorded; two Ms of one bucket are refused (the second would
overwrite the first's entry).
"""
from __future__ import annotations

import argparse
import json
import math
from typing import Callable, Optional

import torch

from ..ops import autotune
from ..ops import int8_matmul as I8
from ..ops import quant_matmul as QM
from ..ops.quant import unpack_int4_tpu
from .timing import cuda_event_ms

# ChatGLM2-6B's linears at their storage shapes (K, N)
LINEARS = {"q_proj": (4096, 4096), "kv_proj": (4096, 512), "o_proj": (4096, 4096),
           "w_in_h": (4096, 13824), "w_out": (13824, 4096), "lm_head": (4096, 65536)}
KERNEL_TOL = 1e-2      # of max|plain| (chip_smoke.py's KERNEL_TOL)
SUM_TOL = 2.0 ** -23   # of sum|terms| beyond one bf16 rounding (chip_smoke.py's SUM_TOL)
ROTATE_BYTES = 160e6   # past the 50 MB L2


def table_entry(kind: str, M: int) -> tuple:
    """(kernel, bucket) of the table entry that M rows of ``kind`` launch."""
    if M <= (QM.SMALL_M_MAX if kind == "int4" else QM.MMA_MIN_M):
        return QM.SPLITK_KERNELS[(2, kind == "int8")][0], 8 * QM.splitk_mt(M)
    return ("int4_mma" if kind == "int4" else "int8_mma"), QM.mma_bucket(M)


def splitk_candidates(M: int, K: int, N: int, xbytes: int, int8_weights: bool) -> list:
    """The built-in split-K plan of M first, then its neighbours, each
    fitting the bucket's largest M: each column width the kernel takes, K
    split 1-64 ways (at least two groups a warp), the staging chunk as large
    as shared memory allows and half that."""
    kernel, max_mt = QM.SPLITK_KERNELS[(xbytes, int8_weights)]
    base = QM.builtin_splitk_plan(M, K, N, xbytes, int8_weights)
    mt, G = base[0], K // 32
    rows = 8 * mt  # the bucket's largest M
    out = [base]
    for cols in (8, 16):
        for want in (1, 2, 4, 8, 16, 32, 64):
            gps = -(-G // want)
            if gps < min(G, 2 * QM.SPLITK_KW):
                break
            nsplit = -(-G // gps)
            cg_max = -(-gps // 8) * 8
            while cg_max > 8 and QM.splitk_smem(rows, cg_max, cols, xbytes) > QM.SPLITK_SMEM_MAX:
                cg_max -= 8
            for cg in {cg_max, max(8, cg_max // 16 * 8)}:
                plan = (mt, cols, nsplit, gps, cg)
                if plan not in out and \
                        QM.splitk_problem(rows, K, N, plan, xbytes, max_mt) is None:
                    out.append(plan)
    return out


def wg_candidates(M: int, K: int, N: int, int4: bool) -> list:
    """The built-in Hopper plan first, then bm 64 / 128 with K split 1-8
    ways, one block a work unit up to the SMs."""
    base = QM.mma_plan(M, K, N) if int4 else QM.int8_mma_plan(M, K, N)
    out = [base]
    G = K // 32
    steps = -(-G // QM.MMA_STAGE_GROUPS) if int4 else -(-K // QM.MMA_STEP)
    for bm in (128, 64):
        tiles = -(-M // bm) * -(-N // QM.MMA_BN)
        for want in (1, 2, 4, 8):
            sps = -(-steps // want)
            nsplit = -(-steps // sps)
            ctas = min(tiles * nsplit, QM.SPLITK_SMS)
            if int4:
                plan = (bm, nsplit, QM.MMA_STAGE_GROUPS * sps if nsplit > 1 else G, ctas)
                ok = QM.mma_problem(K, plan) is None
            else:
                plan = (bm, nsplit, sps, ctas)
                ok = QM.wg_problem(steps, plan) is None
            if ok and plan not in out:
                out.append(plan)
    return out


def _weights(kind: str, K: int, N: int, gen: torch.Generator):
    """Copies of one random weight (and scale) past ROTATE_BYTES, and its
    exact f64 dequantized form."""
    if kind == "int4":
        wbytes = K // 2 * N + K // 32 * N * 2
        copies = max(2, min(64, math.ceil(ROTATE_BYTES / wbytes)))
        w = torch.randint(0, 256, (copies, K // 2, N), dtype=torch.uint8, device="cuda",
                          generator=gen)
        s = (torch.rand((copies, K // 32, N), device="cuda", generator=gen) * 0.02
             ).to(torch.bfloat16)
        return w, s, unpack_int4_tpu(w[0], s[0]).double()
    wbytes = K * N + 4 * N
    copies = max(2, min(64, math.ceil(ROTATE_BYTES / wbytes)))
    w = torch.randint(-127, 128, (copies, K, N), dtype=torch.int8, device="cuda", generator=gen)
    s = torch.rand((copies, N), device="cuda", generator=gen) * 0.02
    return w, s, w[0].double() * s[0].double()


def sweep_shape(kind: str, name: str, M: int, gen: torch.Generator,
                log: Callable[[str], None] = print) -> dict:
    """Every candidate plan of linear ``name`` at M rows: its ms, errors and
    whether it may be recorded; the fastest exact one as "best"."""
    K, N = LINEARS[name]
    w, s, w64 = _weights(kind, K, N, gen)
    copies = w.shape[0]
    x = torch.randn((M, K), device="cuda", generator=gen).to(torch.bfloat16)
    mm = QM.int4g32_matmul if kind == "int4" else I8.int8_matmul
    plain = QM.int4g32_matmul_plain if kind == "int4" else I8.int8_matmul_plain
    want = plain(x, w[0], s[0]).float()
    exact = x.double() @ w64
    terms = x.double().abs() @ w64.abs()
    half_ulp = torch.ldexp(torch.ones_like(exact), torch.frexp(exact).exponent - 9)
    del w64
    kernel, bucket = table_entry(kind, M)
    if kernel.endswith("splitk"):
        plans = splitk_candidates(M, K, N, 2, kind == "int8")
        max_mt = QM.SPLITK_KERNELS[(2, kind == "int8")][1]
        fits = [QM.splitk_problem(bucket, K, N, p, 2, max_mt) is None for p in plans]
    else:
        plans = wg_candidates(M, K, N, kind == "int4")
        fits = [True] * len(plans)  # a Hopper plan depends on M only through its bucket
    rows = []
    for plan, fit in zip(plans, fits):
        with autotune.override(kernel, bucket, K, N, plan):
            got = mm(x, w[0], s[0])
            rel = ((got.float() - want).abs().max() / want.abs().max().clamp_min(1e-30)).item()
            beyond = (((got.double() - exact).abs() - half_ulp).clamp_min(0.0)
                      / terms.clamp_min(1e-300)).max().item()
            ms = cuda_event_ms(lambda i: mm(x, w[i % copies], s[i % copies]), iters=30)
        ok = rel <= KERNEL_TOL and beyond <= SUM_TOL
        rows.append({"plan": list(plan), "ms": ms, "rel_err": rel, "beyond_sum": beyond,
                     "exact_enough": ok, "fits_bucket": fit, "builtin": plan == plans[0]})
        log(f"  {kernel:12s} {name:8s} M={M:5d} plan {list(plan)}: {ms:.5f} ms  rel {rel:.2e}  "
            f"beyond {beyond:.2e}{'' if ok else '  (not exact enough)'}"
            f"{'' if fit else f'  (does not fit M = {bucket})'}"
            f"{'  [built-in]' if plan == plans[0] else ''}")
    recordable = [r for r in rows if r["exact_enough"] and r["fits_bucket"]]
    best = min(recordable, key=lambda r: r["ms"]) if recordable else None
    return {"kernel": kernel, "linear": name, "M": M, "K": K, "N": N, "bucket": bucket,
            "candidates": rows, "best": best}


def sweep(kind: str, linears, ms, record: bool = False, seed: int = 0,
          log: Callable[[str], None] = print) -> list:
    """``sweep_shape`` over every (linear, M); with ``record`` each shape's
    best plan goes into the user's table (``autotune.record``).  Two Ms of
    one table entry are refused."""
    by_entry = {}
    for M in ms:
        entry = table_entry(kind, M)
        if entry in by_entry:
            raise ValueError(f"M = {by_entry[entry]} and {M} share the {entry[0]} entry of "
                             f"bucket m{entry[1]}: sweep one of them")
        by_entry[entry] = M
    gen = torch.Generator(device="cuda").manual_seed(seed)
    out = []
    for name in linears:
        for M in ms:
            res = sweep_shape(kind, name, M, gen, log)
            if record and res["best"] is not None:
                res["key"] = autotune.record(res["kernel"], res["bucket"], res["K"], res["N"],
                                             res["best"]["plan"], us=1e3 * res["best"]["ms"])
                log(f"  recorded {res['key']} = {res['best']['plan']} in "
                    f"{autotune.table_path()}")
            out.append(res)
    return out


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernel", choices=("int4", "int8"), default="int4")
    ap.add_argument("--m", default="1,16,128",
                    help="rows, comma-separated, at most one a table entry")
    ap.add_argument("--linears", default=",".join(LINEARS),
                    help=f"comma-separated, of {','.join(LINEARS)}")
    ap.add_argument("--record", action="store_true",
                    help="write each shape's fastest exact plan to the user's table")
    ap.add_argument("--json", default=None, help="write every candidate's row here")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("autotune_sweep times the kernels on the card; CUDA is not available")
    res = sweep(args.kernel, args.linears.split(","), [int(m) for m in args.m.split(",")],
                args.record, args.seed)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(res, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""int4g32 dequant-matmul (B1/B2) and its transposed form (B14): the wrappers
over the CUDA kernels, their plain versions, and their launch counts.

Replaces chatglm_q_tpu/ops/pallas_matmul.py:_int4_fwd_kernel (grid form) and
:_int4_pipelined_kernel (decode-M form).  They compute one function, so here
they are one wrapper, ``int4g32_matmul``, over three kernels in
``csrc/int4_matmul.cu`` chosen by ``int4_route``:

* ``int4g32_splitk`` — bf16 or f16 activations at M ≤ SMALL_M_MAX (decode
  at batch 1-4, the speculative verify step): mma.sync with the weights as A and x's
  rows as B, split over K so a narrow N still fills the card, the splits'
  f32 partials summed in split order by the last block of each column tile
  to arrive, in the same launch.  Bound by the weight bytes.
* ``int4g32_mma`` — bf16 or f16 activations above it (prefill, engine
  chunks, training): a persistent Hopper kernel, TMA tiles in an mbarrier ring and
  wgmma with the weights as A from registers, each group's f32 partial
  folded in with its scale while the next group's MMAs run; ``mma_plan``
  picks the tile and the K splits (merged in the same launch).  Bound by
  operations.
* ``int4g32_gemv`` — bf16, f16 or f32 activations above the split-K
  limits where N % 16 != 0 (the Hopper kernel cannot take N): CUDA cores,
  split over K; a second pass sums the f32 partials in a fixed order.

f32 activations (a float32 checkpoint's: the loaders' default dtype) take
the same two tensor-core kernels in their f32 forms, counted apart too as
``<wrapper>_f32``: an f32 x is the exact sum of three bf16 pieces
(``split_bf16x3``), each piece times an integer weight is exact in f32, so
three bf16 products a term give the f32 product.  ``int4g32_splitk`` up to
``F32_SPLITK_MAX`` rows stages the pieces itself, as three rows an x row;
``int4g32_mma`` above it reads them from a (3, M, K) buffer that
``split_bf16x3_pass`` writes first.  The CUDA-core gemv stays callable by
name (phase 2 of ``chip_smoke.py`` times it beside them).

All apply each 32-row group's scale to the f32 partial of that group, so
with integer weights and bf16, f16 or f32 activations they differ from the
plain version only in the order of the f32 sums.  The f16 forms (a float16
checkpoint's activations: the loader gives the model the checkpoint's
``torch_dtype``) are the same kernels over f16 tiles, counted apart too as
``<wrapper>_f16``; each C entry takes the activations' dtype code
(``_build.dtype_code``) and refuses one it has no kernel for.

``int4g32_matmul_t`` (B14) replaces pallas_matmul.py:_int4_t_kernel
(``int4_matmul_t_pallas``): the backward of the int4g32 linear, grad_x =
g @ dequant(packed, scale)ᵀ over the same packed weights.  The scale varies
along K/32 and N, so each weight is rounded once to g's dtype, bf16(q·s)
under bf16, f16(f16(q)·f16(s)) under f16 (JAX's ``_int4_t_kernel`` casts
the bf16 scale to g's dtype first: a subnormal, 0 or inf outside f16's
normal range, where B1 keeps q·s in f32), before the dot, as both JAX forms
do.  Three kernels, chosen by ``t_route`` (the f16 forms, a float16
checkpoint's fine-tuning, are the bf16 kernels over f16 tiles, counted
apart too as ``<wrapper>_f16``):

* ``int4g32_t_splitk`` (bf16 / f16, M ≤ MMA_MIN_M: a training step of ≤ 16
  tokens): ``csrc/common.cuh``'s ``t_splitk_mma_kernel`` over the int4g32
  view, mma.sync with 16 weight rows as A straight from the N-contiguous
  rows and g's rows as B from shared memory, the contraction split over
  blocks and merged in the launch; ``t_splitk_plan``.  Bound by the packed
  bytes.
* ``int4g32_t_mma`` (bf16 / f16, M > 16): the Hopper ``t_wgmma_kernel`` over the
  same view, B1's mainloop with the weights as A from registers (each
  bf16(q·s) one bf16x2 multiply), each stage's f32 partial added to the
  accumulator on the CUDA cores; ``t_mma_plan`` picks the tile and the
  contraction splits.
* ``int4g32_t_gemv`` (f32 g; ``csrc/int4_matmul.cu``): the CUDA cores in
  IEEE f32.

``matmul_route``, ``splitk_f32_plan`` and ``split_bf16x3_pass`` are shared
with B6's f32 forms; ``uses_mma`` and ``MMA_MIN_M`` with the int8 and dynamic int8
matmuls (B6/B7/B8) and the transposed kernels, ``gemv_plan`` with B6's
CUDA-core kernel, ``splitk_plan``, ``splitk_scratch`` and ``splitk_call``
with the split-K kernels of B6, B7 and B8 (bf16 or s8 rows at M ≤
MMA_MIN_M: decode), and ``wg_plan``, ``mma_smem`` and ``wg_scratch`` with
every Hopper kernel (B1, B6, B7, B8, B13, B14), ``t_route``,
``t_splitk_plan`` and ``t_splitk_call`` with B13; B1's own routing and
plans are ``int4_route`` and ``mma_plan``.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from . import _build, autotune
from .quant import unpack_int4_tpu, unpack_int4_tpu_q

GEMV_BN = 256            # columns per gemv block (csrc: GEMV_LANES * GEMV_COLS)
GEMV_KW = 4              # K warps per gemv block
GEMV_TARGET_BLOCKS = 1056  # ~8 blocks per SM on a 132-SM H100
MMA_MIN_M = 16           # bf16 rows above which the tensor-core kernel runs

# The split-K tensor-core kernels (csrc/common.cuh: SK_*): B1's, and B6's, B7's
# and B8's at M <= MMA_MIN_M
SMALL_M_MAX = 64         # B1's bf16 rows up to which it runs (the JAX decode-M limit)
SPLITK_KW = 4            # warps per block, along K
SPLITK_SMEM_MAX = 72 * 1024  # shared bytes a block (csrc: SK_SMEM_MAX); 48 KB up to mt = 2
SPLITK_SMS = 132         # H100 SXM

# The transposed split-K kernel (csrc/common.cuh: TSK_*): B13 and B14 at bf16 M <= MMA_MIN_M
TSK_ROWS = 128           # output rows a block: 4 warps of 32 rows, times 2 along the contraction
TSK_CW = 2               # warps of a block along the contraction
TSK_CHUNK = 64           # contraction elements a chunk (four k16 steps)
TSK_MROWS = 16           # g rows a block (grid.z takes more, where N % 16 != 0)
TSK_SMEM_MAX = 46 * 1024  # shared bytes a block (no opt-in)
TSK_BLOCKS = 2 * SPLITK_SMS  # blocks to fill the card: two 8-warp blocks an SM

# The Hopper kernels (csrc/common.cuh: WG_*): B1 above SMALL_M_MAX, B6, B13, B14
MMA_BN = 128             # output columns a tile (two consumer warpgroups of 64)
MMA_STEP = 64            # contraction elements a pipeline stage
MMA_STAGE_GROUPS = 2     # B1: 32-row groups a stage
MMA_STAGES = 8           # stages in the shared-memory ring
MMA_SMEM_MAX = 227 * 1024  # shared bytes a block may opt into on an H100
DYN_STEP = 128           # B7/B8 (csrc/dyn_matmul.cu): s8 contraction elements a stage
# weight and scale bytes a stage (the views' kWBytes / kSBytes)
MMA_TILE_BYTES = {
    "int4g32": (16 * MMA_STAGE_GROUPS * MMA_BN, MMA_STAGE_GROUPS * MMA_BN * 2),  # B1
    "int8": (MMA_STEP * MMA_BN, 0),                                              # B6
    "int4g32_t": (MMA_BN // 2 * MMA_STEP, MMA_BN // 32 * MMA_STEP * 2),         # B14
    "int8_t": (MMA_BN * MMA_STEP, MMA_STEP * 4),                                 # B13
    "int8_dyn": (DYN_STEP * MMA_BN, 0),                                          # B7
    "int4g32_dyn": (DYN_STEP // 2 * MMA_BN, DYN_STEP // 32 * MMA_BN * 2),       # B8
}
MMA_TILE_BYTES["int4g32_f32"] = MMA_TILE_BYTES["int4g32"]  # the f32 forms of B1 and B6:
MMA_TILE_BYTES["int8_f32"] = MMA_TILE_BYTES["int8"]        # three activation tiles a stage
MMA_PIECES = {"int4g32_f32": 3, "int8_f32": 3}
# wg_plan's cost model, in stages of a 128-row tile
MMA_FILL = 3.0           # a work unit's pipeline fill and epilogue
MMA_MERGE = 1.25         # each split's share of its tile's merge, per 128 rows
MMA_BM64_STEP = 0.6      # a 64-row stage: half the MMAs, the same weight conversion


def int4g32_matmul_plain(x: torch.Tensor, packed: torch.Tensor,
                         scale: torch.Tensor) -> torch.Tensor:
    """x (M, K) @ dequant(packed (K/2, N) tpu order, scale (K/32, N)) in f32,
    cast to x's dtype.  The function the kernels are held against."""
    return (x.float() @ unpack_int4_tpu(packed, scale)).to(x.dtype)


def gemv_plan(M: int, K: int, N: int) -> tuple[int, int]:
    """(nsplit, groups_per_split) of the split-K kernel: enough blocks to fill
    the card, at least one group per K warp of a block."""
    G = K // 32
    mt = 1 if M == 1 else 2 if M == 2 else 4 if M <= 4 else 8
    base = math.ceil(N / GEMV_BN) * math.ceil(M / mt)
    want = max(1, min(G, math.ceil(GEMV_TARGET_BLOCKS / base)))
    gps = min(G, max(math.ceil(G / want), GEMV_KW))
    return math.ceil(G / gps), gps


# the 16-bit activation dtypes the forward tensor-core kernels take (B1, B6)
MMA_DTYPES = (torch.bfloat16, torch.float16)

# The f32 forms of B1 and B6 (f32 x as its three bf16 pieces): the rows up
# to which each takes its split-K kernel, the Hopper kernel above.  The
# split-K kernels stage the pieces as three rows an x row, 3M rows through
# the bf16 body, in at most two m-tiles (3M ≤ 16); the crossover sweep of
# chip_smoke.py's phase 2 on an H100 (PERF.md) puts the Hopper kernel
# behind them on every linear up to that limit.
F32_SPLITK_MAX = 5


def uses_mma(M: int, N: int, dtype: torch.dtype) -> bool:
    """B1's and B6's Hopper kernel (bf16 or f16, M > MMA_MIN_M, N % 16 == 0)."""
    return dtype in MMA_DTYPES and M > MMA_MIN_M and N % 16 == 0


def matmul_route(M: int, N: int, dtype: torch.dtype, splitk_max: int) -> str:
    """B1's or B6's kernel for x (M, K) of ``dtype`` and N columns:
    "splitk" at M ≤ ``splitk_max`` (bf16 or f16) or ≤ F32_SPLITK_MAX (f32),
    "mma" above it where N % 16 == 0, else "gemv"."""
    if dtype == torch.float32:
        if M <= F32_SPLITK_MAX:
            return "splitk"
        return "mma" if N % 16 == 0 else "gemv"
    if dtype in MMA_DTYPES and M <= splitk_max:
        return "splitk"
    return "mma" if uses_mma(M, N, dtype) else "gemv"


def int4_route(M: int, N: int, dtype: torch.dtype) -> str:
    """B1's kernel for x (M, K) of ``dtype`` and N columns: "splitk" (bf16
    or f16 at M ≤ SMALL_M_MAX, f32 at M ≤ F32_SPLITK_MAX), "mma" above it,
    or "gemv" where the Hopper kernel cannot take N."""
    return matmul_route(M, N, dtype, SMALL_M_MAX)


def splitk_smem(M: int, cg: int, cols: int, xbytes: int = 2) -> int:
    """Shared bytes of a split-K block (csrc: sk_smem_bytes): x's M rows over
    a chunk of cg groups, rows padded by 32 elements of ``xbytes`` (bf16 2,
    B7/B8's s8 1; the f32 forms stage 3M bf16 rows); after the loop the
    same bytes hold each of the 4 warps' (M, 8·cols + 1) 4-byte sum."""
    return max(M * (cg * 32 + 32) * xbytes, SPLITK_KW * M * (8 * cols + 1) * 4)


# the split-K kernels by (xbytes, int8 weights): table name and the most
# m-tiles its entry takes (csrc: sk_dispatch<MAX_MT>; the f32 forms:
# splitk_f32_plan)
SPLITK_KERNELS = {(2, False): ("int4_splitk", 8), (2, True): ("int8_splitk", 2),
                  (1, True): ("int8_dyn_splitk", 2), (1, False): ("int4_dyn_splitk", 2)}
SPLITK_MTS = (1, 2, 3, 4, 5, 6, 8)


def splitk_mt(M: int) -> int:
    """The split-K kernels' m-tiles of 8 rows for M rows (no 7-tile form)."""
    mt = -(-M // 8)
    return mt + (mt == 7)


def splitk_problem(M: int, K: int, N: int, plan, xbytes: int = 2,
                   max_mt: int = 8) -> Optional[str]:
    """What a split-K kernel refuses in ``plan`` (csrc: sk_dispatch's
    checks) or leaves wrong (splits that do not cover K's groups), or None."""
    mt, cols, nsplit, gps, cg = plan
    G = K // 32
    if mt not in SPLITK_MTS or mt > max_mt:
        return f"mt {mt} is not one of {[t for t in SPLITK_MTS if t <= max_mt]}"
    if not 1 <= M <= 8 * mt:
        return f"M = {M} rows do not fit {mt} m-tiles"
    if cols not in (8, 16) or (cols == 16 and (N % 16 or mt != 1)):
        return f"cols {cols}: 8, or 16 at one m-tile where N % 16 == 0"
    if nsplit < 1 or gps < 1 or (nsplit - 1) * gps >= G or nsplit * gps < G:
        return f"{nsplit} splits of {gps} groups do not cover K's {G} groups"
    if cg < 8 or cg % 8:
        return f"groups a chunk {cg}: a multiple of 8"
    if splitk_smem(M, cg, cols, xbytes) > SPLITK_SMEM_MAX:
        return f"{splitk_smem(M, cg, cols, xbytes)} shared bytes over {SPLITK_SMEM_MAX}"
    return None


def wg_problem(steps: int, plan) -> Optional[str]:
    """What a Hopper kernel refuses in (bm, nsplit, stages_per_split, ctas)
    over ``steps`` contraction stages (csrc: wg_plan_ok), or None."""
    bm, nsplit, sps, ctas = plan
    if bm not in (64, 128):
        return f"bm {bm}: 64 or 128"
    if nsplit < 1 or sps < 1 or (nsplit - 1) * sps >= steps or nsplit * sps < steps:
        return f"{nsplit} splits of {sps} stages do not cover {steps} stages"
    if ctas < 1:
        return f"{ctas} blocks"
    return None


def mma_bucket(M: int) -> int:
    """A Hopper kernel's table rows: M padded to 64 (its plan depends on M
    only through the tile counts at bm 64 and 128)."""
    return -(-M // 64) * 64


def splitk_plan(M: int, K: int, N: int, xbytes: int = 2,
                int8_weights: bool = False) -> tuple[int, int, int, int, int]:
    """``builtin_splitk_plan``, or this kernel's and shape's entry of the
    plan table (ops/autotune.py: key rows 8 · mt), checked by
    ``splitk_problem`` at the bucket's 8 · mt rows: an entry serves every M
    of its bucket, and its shared memory grows with M."""
    if not 1 <= M <= SMALL_M_MAX:
        raise ValueError(f"splitk_plan: M = {M} outside 1..{SMALL_M_MAX}")
    kernel, max_mt = SPLITK_KERNELS[(xbytes, int8_weights)]
    rows = 8 * splitk_mt(M)
    return autotune.plan(kernel, rows, K, N,
                         lambda: builtin_splitk_plan(M, K, N, xbytes, int8_weights),
                         lambda p: splitk_problem(rows, K, N, p, xbytes, max_mt))


def builtin_splitk_plan(M: int, K: int, N: int, xbytes: int = 2,
                        int8_weights: bool = False) -> tuple[int, int, int, int, int]:
    """(mt, cols, nsplit, groups_per_split, groups_per_chunk) of the split-K
    kernels (csrc/common.cuh: sk_body) for x (M ≤ SMALL_M_MAX, K) of
    ``xbytes`` an element (bf16: B1, and B6 at M ≤ MMA_MIN_M; s8: B7 and
    B8 at M ≤ MMA_MIN_M) and N columns of int4g32 weights (B1, B8) or int8
    weights (``int8_weights``: B6, B7).

    mt m-tiles of 8 rows (1-6, or 8); cols columns a lane, 16 at mt = 1 where N % 16 ==
    0 and N ≥ 2048, else 8 (twice the column tiles for a narrow N, and room
    in registers for the accumulators and both sets of loads), so 8·cols a
    block; as many K splits as keep every SM holding as many blocks as fit
    (4 up to mt = 2, else 2), with at least two groups a warp (one leaves a
    block too little work for its fixed costs); x staged in chunks of as
    many groups (a multiple of 8) as 48 KB of shared memory hold (4 blocks
    an SM; 72 KB from mt = 3 on).  The partials, tiles · nsplit · M · 8·cols
    floats, stay under SPLITK_SMS · 2 · 64 · 64 floats (4.3 MB): fewer
    splits as N grows, one from ~64K columns on.  int8 weights (twice the
    bytes a group) take 16 columns a lane only where each warp still gets
    four groups: at q_proj's 4096 columns 8 columns a lane and 8 splits beat
    16 and 16 splits.  The times behind these choices are in PERF.md."""
    if not 1 <= M <= SMALL_M_MAX:
        raise ValueError(f"splitk_plan: M = {M} outside 1..{SMALL_M_MAX}")
    mt = splitk_mt(M)
    G = K // 32

    def splits(cols):  # (column tiles, groups a split)
        tiles = -(-N // (8 * cols))
        want = max(1, SPLITK_SMS * (4 if mt <= 2 else 2) // tiles)
        return tiles, max(-(-G // want), min(G, 2 * SPLITK_KW))

    cols = 16 if mt == 1 and N % 16 == 0 and N >= 2048 else 8
    if int8_weights and cols == 16 and splits(16)[1] < min(G, 4 * SPLITK_KW):
        cols = 8
    _, gps = splits(cols)
    cg = -(-gps // 8) * 8
    smem_max = 48 * 1024 if mt <= 2 else SPLITK_SMEM_MAX
    while cg > 8 and splitk_smem(M, cg, cols, xbytes) > smem_max:
        cg -= 8
    return mt, cols, -(-G // gps), gps, cg


def splitk_f32_plan(M: int, K: int, N: int,
                    int8_weights: bool = False) -> tuple[int, int, int, int, int]:
    """B1's (or, ``int8_weights``, B6's) split-K kernel on f32 x (M, K): x's
    pieces as 3M staged rows, so the bf16 plan at 3M rows (two m-tiles at
    most), or the plan table's entry under the f32 form's own name,
    "int4_splitk_f32" or "int8_splitk_f32"."""
    if not 1 <= M <= F32_SPLITK_MAX:
        raise ValueError(f"splitk_f32_plan: M = {M} outside 1..{F32_SPLITK_MAX}")
    kernel = ("int8" if int8_weights else "int4") + "_splitk_f32"
    staged = 8 * splitk_mt(3 * M)
    return autotune.plan(kernel, staged, K, N,
                         lambda: builtin_splitk_plan(3 * M, K, N, 2, int8_weights),
                         lambda p: splitk_problem(staged, K, N, p, 2, 2))


def splitk_scratch(device, M: int, N: int, plan) -> tuple:
    """(split partials or None, arrival counters) of a split-K ``plan``: the
    buffers every split-K kernel shares, 4-byte partials (f32, or B7's
    int32) and counters that each launch leaves at 0 (launches on a stream
    run in order).  M: the staged rows (3M in the f32 forms)."""
    _, cols, nsplit, _, _ = plan
    tiles = -(-N // (8 * cols))
    part = (_build.scratch("splitk_part", device, tiles * nsplit * M * 8 * cols,
                           torch.float32).data_ptr() if nsplit > 1 else None)
    return part, _build.scratch("splitk_arrivals", device, tiles, torch.int32).data_ptr()


def splitk_call(name: str, x, w, scale, plan):
    """Launch split-K kernel ``name`` (csrc: chatglm_int4_splitk_mma,
    chatglm_int8_splitk_mma) on checked bf16, f16 or f32 tensors of the
    card with ``plan``; returns y (M, N) in x's dtype."""
    M, K = x.shape
    N = w.shape[1]
    y = torch.empty((M, N), dtype=x.dtype, device=x.device)
    staged = 3 * M if x.dtype == torch.float32 else M
    part, arrivals = splitk_scratch(x.device, staged, N, plan)
    _build.call(name, x.data_ptr(), w.data_ptr(), scale.data_ptr(), y.data_ptr(), part,
                arrivals, M, K, N, _build.dtype_code(x.dtype), *plan, _build.stream_ptr(x))
    return y


def mma_stages(bm: int, kind: str = "int4g32") -> int:
    """Stages of a Hopper kernel's ring (csrc: WgRing's STAGES): MMA_STAGES,
    or as many as fit the opt-in limit (csrc: wg_stages, dyn_stages; B7 at
    bm 128, the f32 forms' three activation tiles a stage)."""
    wbytes, sbytes = MMA_TILE_BYTES[kind]
    xbytes = MMA_PIECES.get(kind, 1) * bm * 128
    return min(MMA_STAGES, (MMA_SMEM_MAX - 16 - 1024) // (xbytes + wbytes + sbytes + 16))


def mma_smem(bm: int, kind: str = "int4g32") -> int:
    """Shared bytes of a block of a Hopper kernel (csrc: WgRing<bm, ...>::BYTES):
    per stage the activations' bm × 128-byte tile (64 bf16, or 128 s8 for
    B7/B8) and the weight and scale tiles of ``kind`` (MMA_TILE_BYTES: B1 32
    packed byte rows × 128 and 2 × 128 scales; B6 64 × 128 int8 bytes; B14
    64 byte rows × 64 and 4 × 64 scales; B13 128 × 64 int8 bytes and 64 f32
    scales; B7 128 × 128 int8 bytes; B8 64 packed byte rows × 128 and 4 ×
    128 scales; the f32 forms "int4g32_f32" and "int8_f32" three
    activation tiles, one a bf16 piece of x); a full and an empty barrier
    per stage, two merge flags, and the slack that aligns the ring to 1024
    bytes."""
    wbytes, sbytes = MMA_TILE_BYTES[kind]
    stages = mma_stages(bm, kind)
    xbytes = MMA_PIECES.get(kind, 1) * bm * 128
    return stages * (xbytes + wbytes + sbytes) + 2 * stages * 8 + 16 + 1024


def wg_plan(M: int, C: int, n_out: int, step: int = MMA_STEP) -> tuple[int, int, int, int]:
    """(bm, nsplit, stages_per_split, ctas) of a Hopper kernel with M
    activation rows, a contraction of C elements (stages of ``step``:
    MMA_STEP bf16, DYN_STEP s8; either is 128 bytes of a row and four
    wgmma steps) and n_out output columns.

    Tiles of bm (128 or 64) rows × 128 columns, each split over the
    contraction into nsplit ranges of stages_per_split stages; the tiles ×
    nsplit work units go to ctas ≤ SPLITK_SMS persistent blocks, one an SM.
    The choice minimises a cost in stages: waves of units × (a unit's stages
    + MMA_FILL + its merge), where a 64-row stage costs MMA_BM64_STEP of a
    128-row one and a split adds MMA_MERGE · bm/128 to its tile's merge (the
    last block reads every split's partial).  Splits only while the units
    stay within two waves and each split keeps at least two stages: a narrow
    output (kv_proj) or a small M fills the card, the wide linears run
    whole."""
    S = -(-C // step)
    ntiles = -(-n_out // MMA_BN)
    best = None
    for bm in (128, 64):
        tiles = -(-M // bm) * ntiles
        step = 1.0 if bm == 128 else MMA_BM64_STEP
        last = 0
        for want in (1, 2, 4, 8, 16, 32):
            sps = -(-S // want)
            nsplit = -(-S // sps)
            if nsplit == last:
                continue
            if nsplit > 1 and (sps < 2 or tiles * nsplit > 2 * SPLITK_SMS):
                break
            last = nsplit
            units = tiles * nsplit
            merge = 0.0 if nsplit == 1 else 0.5 + MMA_MERGE * nsplit * bm / 128
            cost = -(-units // SPLITK_SMS) * (sps * step + MMA_FILL + merge)
            if best is None or cost < best[0]:
                best = (cost, (bm, nsplit, sps, min(units, SPLITK_SMS)))
    return best[1]


def mma_problem(K: int, plan) -> Optional[str]:
    """What B1's Hopper kernel refuses in (bm, nsplit, groups_per_split,
    ctas) (csrc: chatglm_int4_wgmma's checks), or None."""
    bm, nsplit, gps, ctas = plan
    G = K // 32
    steps = -(-G // MMA_STAGE_GROUPS)
    if gps < 1 or (nsplit > 1 and gps % MMA_STAGE_GROUPS) or (nsplit - 1) * gps >= G \
            or nsplit * gps < G:
        return f"{nsplit} splits of {gps} groups do not cover K's {G} groups in whole stages"
    return wg_problem(steps, (bm, nsplit, gps // MMA_STAGE_GROUPS if nsplit > 1 else steps,
                              ctas))


def mma_plan(M: int, K: int, N: int, f32: bool = False) -> tuple[int, int, int, int]:
    """(bm, nsplit, groups_per_split, ctas) of B1's Hopper kernel for bf16 x
    (M, K) and N columns: ``wg_plan`` over K, each split's stages counted in
    32-row groups (all K / 32 groups where K is not split); or the plan
    table's entry (ops/autotune.py, "int4_mma"; the f32 form's own,
    "int4_mma_f32", so that no bf16 entry plans an f32 launch)."""
    def builtin():
        bm, nsplit, sps, ctas = wg_plan(M, K, N)
        return bm, nsplit, (MMA_STAGE_GROUPS * sps if nsplit > 1 else K // 32), ctas

    return autotune.plan("int4_mma_f32" if f32 else "int4_mma", mma_bucket(M), K, N, builtin,
                         lambda p: mma_problem(K, p))


def int8_mma_plan(M: int, K: int, N: int, f32: bool = False) -> tuple[int, int, int, int]:
    """B6's Hopper kernel: ``wg_plan`` over K, or the table's "int8_mma"
    (f32: "int8_mma_f32") entry."""
    return autotune.plan("int8_mma_f32" if f32 else "int8_mma", mma_bucket(M), K, N,
                         lambda: wg_plan(M, K, N), lambda p: wg_problem(-(-K // MMA_STEP), p))


def t_mma_plan(M: int, K: int, N: int, kind: str = "int4g32") -> tuple[int, int, int, int]:
    """(bm, nsplit, stages_per_split, ctas) of the transposed Hopper kernel
    (B13 for ``kind`` "int8", B14 for "int4g32") for g (M, N) and K output
    columns: ``wg_plan`` over the contraction N, or the table's
    "{int8,int4}_t_mma" entry."""
    name = "int8_t_mma" if kind == "int8" else "int4_t_mma"
    return autotune.plan(name, mma_bucket(M), K, N, lambda: wg_plan(M, N, K),
                         lambda p: wg_problem(-(-N // MMA_STEP), p))


def t_route(M: int, N: int, dtype: torch.dtype) -> str:
    """B13's and B14's kernel for g (M, N) of ``dtype``: "splitk" (bf16 or
    f16 at M ≤ MMA_MIN_M, and at any M where N % 16 != 0, which the Hopper
    kernel cannot take), "mma" (bf16 or f16 above it) or "gemv" (f32)."""
    if dtype in MMA_DTYPES and (M <= MMA_MIN_M or N % 16):
        return "splitk"
    if uses_mma(M, N, dtype):
        return "mma"
    return "gemv"


def t_splitk_smem(mt: int, cs: int) -> int:
    """Shared bytes of a transposed split-K block (csrc: tsk_smem_bytes):
    g's 8·mt rows over a stage of cs chunks, rows padded by 8 bf16; after
    the loop the same bytes hold the two contraction warps' (8·mt, 129) f32
    sums."""
    return max(8 * mt * (cs * TSK_CHUNK + 8) * 2, TSK_CW * 8 * mt * (TSK_ROWS + 1) * 4)


def t_splitk_problem(M: int, K: int, N: int, plan) -> Optional[str]:
    """What the transposed split-K kernel refuses in ``plan`` (csrc:
    launch_t_splitk's checks) or leaves wrong (splits that do not cover the
    contraction's chunks), or None."""
    mt, nsplit, cps, cs = plan
    C = -(-N // TSK_CHUNK)
    if mt not in (1, 2) or min(M, TSK_MROWS) > 8 * mt:
        return f"mt {mt}: 1 or 2 m-tiles of 8 rows for {min(M, TSK_MROWS)} rows a block"
    if nsplit < 1 or cps < 1 or (nsplit - 1) * cps >= C or nsplit * cps < C:
        return f"{nsplit} splits of {cps} chunks do not cover N's {C} chunks"
    if cs < 4 or cs % 4:
        return f"chunks a stage {cs}: a multiple of 4"
    if t_splitk_smem(mt, cs) > TSK_SMEM_MAX:
        return f"{t_splitk_smem(mt, cs)} shared bytes over {TSK_SMEM_MAX}"
    return None


def t_splitk_plan(M: int, K: int, N: int) -> tuple[int, int, int, int]:
    """(mt, nsplit, chunks_per_split, chunks_per_stage) of the transposed
    split-K kernel (csrc/common.cuh: t_splitk_mma_kernel) for bf16 g (M, N)
    and K output columns: one m-tile of 8 rows up to 8 rows, else two (16
    rows a block, more in grid.z); the contraction's 64-element chunks in
    as many splits as give the card TSK_BLOCKS blocks (two an SM) over the
    K / 128 row tiles, at least eight chunks a split (four a contraction
    warp: at M = 16 kv_proj's 8 chunks run 1.4-1.5x faster in one split
    than in two, the merge costing more than the wider grid gives); g
    staged in stages of as many chunks (a multiple of 4) as 46 KB hold.
    The partials stay under TSK_BLOCKS · 16 · 128 floats (2.2 MB).  The
    sweep behind these choices (``utils/t_splitk_sweep.py``) is in
    PERF.md."""
    if M < 1 or N < 8 or N % 8 or K < 32 or K % 32:
        raise ValueError(f"t_splitk_plan: unsupported g ({M}, {N}) -> K = {K}")
    mt = 1 if M <= 8 else 2
    C = -(-N // TSK_CHUNK)
    tiles = -(-K // TSK_ROWS) * -(-M // TSK_MROWS)
    want = max(1, TSK_BLOCKS // tiles)
    cps = max(-(-C // want), min(C, 4 * TSK_CW))
    cs = 4
    while cs < cps and t_splitk_smem(mt, cs + 4) <= TSK_SMEM_MAX:
        cs += 4
    return mt, -(-C // cps), cps, cs


def t_splitk_scratch(device, M: int, K: int, plan) -> tuple:
    """(split partials or None, arrival counters) of a transposed split-K
    ``plan``: the split-K kernels' shared buffers (csrc: launch_t_splitk's
    sizes: a (16-row block, row tile, split) slab of min(M, 16) × 128
    partials, a counter a (16-row block, row tile))."""
    _, nsplit, _, _ = plan
    tiles = -(-K // TSK_ROWS) * -(-M // TSK_MROWS)
    part = (_build.scratch("splitk_part", device, tiles * nsplit * min(M, TSK_MROWS) * TSK_ROWS,
                           torch.float32).data_ptr() if nsplit > 1 else None)
    return part, _build.scratch("splitk_arrivals", device, tiles, torch.int32).data_ptr()


def t_splitk_call(name: str, g, w, scale, K: int, plan=None):
    """Launch transposed split-K kernel ``name`` (csrc:
    chatglm_int8_t_splitk, chatglm_int4_t_splitk) on checked bf16 or f16 tensors of
    the card with ``plan`` (default ``t_splitk_plan``'s; another is checked
    by ``t_splitk_problem``); returns out (M, K) in g's dtype."""
    M, N = g.shape
    if plan is None:
        plan = t_splitk_plan(M, K, N)
    elif t_splitk_problem(M, K, N, plan) is not None:
        raise ValueError(f"t_splitk_call: plan {plan}: {t_splitk_problem(M, K, N, plan)}")
    out = torch.empty((M, K), dtype=g.dtype, device=g.device)
    part, arrivals = t_splitk_scratch(g.device, M, K, plan)
    _build.call(name, g.data_ptr(), w.data_ptr(), scale.data_ptr(), out.data_ptr(), part,
                arrivals, M, K, N, _build.dtype_code(g.dtype), *plan, _build.stream_ptr(g))
    return out


def wg_scratch(device, M: int, n_out: int, plan) -> tuple:
    """(split partials or None, arrival counters) of a Hopper kernel's
    ``plan``: the scratch buffers all these kernels share, 4-byte partials
    (f32, or B7's int32) and counters that each launch leaves at 0
    (launches on a stream run in order)."""
    bm, nsplit, _, _ = plan
    tiles = -(-M // bm) * -(-n_out // MMA_BN)
    part = (_build.scratch("mma_part", device, tiles * nsplit * bm * MMA_BN,
                           torch.float32).data_ptr() if nsplit > 1 else None)
    return part, _build.scratch("mma_arrivals", device, 2 * tiles, torch.int32).data_ptr()


def wg_call(name: str, a, w, scale, out, M: int, K: int, N: int, n_out: int, plan) -> None:
    """Launch Hopper kernel ``name`` (csrc: chatglm_*_wgmma) on checked
    tensors of the card with ``plan`` (bm, nsplit, per_split, ctas).  An
    f32 ``a`` (B1's and B6's f32 forms) goes in as its pieces, which
    ``split_bf16x3_pass`` writes first."""
    bm, nsplit, per_split, ctas = plan
    part, arrivals = wg_scratch(a.device, M, n_out, plan)
    code = _build.dtype_code(a.dtype)
    if a.dtype == torch.float32:
        a = split_bf16x3_pass(a)
    _build.call(name, a.data_ptr(), w.data_ptr(), scale.data_ptr(), out.data_ptr(), part,
                arrivals, M, K, N, code, bm, nsplit, per_split, ctas, _build.stream_ptr(a))


def split_bf16x3_pass(x):
    """Launch the f32 forms' split pass (csrc: chatglm_split_bf16x3) on a
    checked f32 x (M, K) of the card: its three bf16 pieces (hi, mid, lo),
    a (3, M, K) view of a scratch buffer that every call reuses (launches
    on a stream run in order), which B1's and B6's Hopper kernels then
    read.  Its plain version is ``split_bf16x3`` (ops/quant.py)."""
    M, K = x.shape
    n = M * K
    buf = _build.scratch("f32_pieces", x.device, 3 * n, torch.bfloat16)
    _build.call("chatglm_split_bf16x3", x.data_ptr(), buf.data_ptr(), n, _build.stream_ptr(x))
    return _build.launched(split_bf16x3_pass, buf[:3 * n].view(3, M, K))


split_bf16x3_pass.launches = 0


def _check(x, packed, scale):
    if not (x.is_cuda and packed.device == x.device and scale.device == x.device):
        raise ValueError("int4g32_matmul: x, packed and scale must be on one CUDA device")
    if x.dim() != 2 or packed.dim() != 2 or scale.dim() != 2:
        raise ValueError("int4g32_matmul: x (M, K), packed (K/2, N), scale (K/32, N)")
    M, K = x.shape
    K2, N = packed.shape
    if K != 2 * K2 or K % 32 or scale.shape != (K // 32, N) or N % 8:
        raise ValueError(f"int4g32_matmul: unsupported shapes x {tuple(x.shape)}, "
                         f"packed {tuple(packed.shape)}, scale {tuple(scale.shape)}")
    if x.dtype not in (torch.bfloat16, torch.float16, torch.float32):
        raise TypeError(f"int4g32_matmul: x must be bf16, f16 or f32, not {x.dtype}")
    if packed.dtype != torch.uint8 or scale.dtype != torch.bfloat16:
        raise TypeError("int4g32_matmul: packed must be uint8 and scale bf16")
    for name, t in (("packed", packed), ("scale", scale)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"int4g32_matmul: {name} must be contiguous and 16-byte aligned")


def aligned(x: torch.Tensor) -> torch.Tensor:
    """``x`` contiguous at a 16-byte aligned address (a copy where needed):
    the kernels read it in 16-byte vectors."""
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def f16_form(x) -> str:
    """The form a launch on ``x`` counts as: "f16" for float16 activations
    (``<wrapper>_f16``), else none."""
    return "f16" if x.dtype == torch.float16 else ""


def act_form(x) -> str:
    """The form a forward matmul's launch on ``x`` counts as: "f16" or, for
    float32 activations (B1's and B6's f32 forms), "f32"; else none."""
    return "f32" if x.dtype == torch.float32 else f16_form(x)


def int4g32_gemv(x, packed, scale):
    """Launch the split-K kernel (checked inputs on the card)."""
    M, K = x.shape
    N = packed.shape[1]
    nsplit, gps = gemv_plan(M, K, N)
    y = torch.empty((M, N), dtype=x.dtype, device=x.device)
    ws = torch.empty((nsplit, M, N), dtype=torch.float32, device=x.device)
    _build.call("chatglm_int4_gemv", x.data_ptr(), packed.data_ptr(), scale.data_ptr(),
                y.data_ptr(), ws.data_ptr(), M, K, N, _build.dtype_code(x.dtype),
                nsplit, gps, _build.stream_ptr(x))
    return _build.launched(int4g32_gemv, y, act_form(x))


int4g32_gemv.launches = 0


def int4g32_mma(x, packed, scale):
    """Launch the Hopper tensor-core kernel (checked bf16, f16 or f32 inputs
    on the card, N % 16 == 0): one launch, any K splits merged inside it;
    f32 x after the split pass (``split_bf16x3_pass``, a launch of its
    own)."""
    M, K = x.shape
    N = packed.shape[1]
    f32 = x.dtype == torch.float32
    y = torch.empty((M, N), dtype=x.dtype, device=x.device)
    wg_call("chatglm_int4_wgmma", x, packed, scale, y, M, K, N, N, mma_plan(M, K, N, f32))
    return _build.launched(int4g32_mma, y, act_form(x))


int4g32_mma.launches = 0


def int4g32_splitk(x, packed, scale):
    """Launch the split-K tensor-core kernel (checked bf16 or f16 inputs on
    the card at M ≤ SMALL_M_MAX, f32 at M ≤ F32_SPLITK_MAX): one launch, the
    splits merged inside it."""
    M, K = x.shape
    N = packed.shape[1]
    plan = splitk_f32_plan(M, K, N) if x.dtype == torch.float32 else splitk_plan(M, K, N)
    y = splitk_call("chatglm_int4_splitk_mma", x, packed, scale, plan)
    return _build.launched(int4g32_splitk, y, act_form(x))


int4g32_splitk.launches = 0
for _fn in (int4g32_gemv, int4g32_mma, int4g32_splitk):
    _build.with_forms(_fn, "f16", "f32")


def int4g32_matmul(x: torch.Tensor, packed: torch.Tensor,
                   scale: torch.Tensor) -> torch.Tensor:
    """x (M, K) bf16/f16/f32 @ dequant(packed (K/2, N) u8, scale (K/32, N)
    bf16) → (M, N) in x's dtype.

    On a CPU tensor this is the plain version; on a CUDA tensor it launches
    a kernel or raises.  ``packed``/``scale`` may be a layer's view
    ``stack[l]`` of the stacked (L, ...) weights: such views are contiguous,
    and their 64-bit addresses come from ``data_ptr()``."""
    if _build.exporting(x):
        return _build.export_op("int4g32_matmul")(x, packed, scale)
    if not _build.on_card(x):
        return int4g32_matmul_plain(x, packed, scale)
    _check(x, packed, scale)
    x = aligned(x)
    route = int4_route(x.shape[0], packed.shape[1], x.dtype)
    if route == "splitk":
        return int4g32_splitk(x, packed, scale)
    if route == "mma":
        return int4g32_mma(x, packed, scale)
    return int4g32_gemv(x, packed, scale)


# ---------------------------------------------------------------------------
# Transposed (backward) form, B14
# ---------------------------------------------------------------------------

def int4g32_matmul_t_plain(g: torch.Tensor, packed: torch.Tensor,
                           scale: torch.Tensor) -> torch.Tensor:
    """g (M, N) @ dequant(packed (K/2, N), scale (K/32, N))ᵀ → (M, K): each
    weight q·s in g's dtype, q and the scale cast to it first and the
    product rounded once (JAX's ``_int4_t_kernel``: in bf16 and f32 the
    exact q·s rounded; in f16 the scale may first round to a subnormal, 0 or
    inf), the dot in f32, cast to g's dtype.  The function the B14 kernels
    are held against."""
    K, N, G = 2 * packed.shape[0], packed.shape[1], scale.shape[0]
    q = unpack_int4_tpu_q(packed).reshape(G, K // G, N).to(g.dtype)
    w = (q * scale.to(g.dtype)[:, None, :]).reshape(K, N).float()
    return (g.float() @ w.T).to(g.dtype)


def _check_t(g, packed, scale):
    if not (g.is_cuda and packed.device == g.device and scale.device == g.device):
        raise ValueError("int4g32_matmul_t: g, packed and scale must be on one CUDA device")
    if g.dim() != 2 or packed.dim() != 2 or scale.dim() != 2:
        raise ValueError("int4g32_matmul_t: g (M, N), packed (K/2, N), scale (K/32, N)")
    K2, N = packed.shape
    K = 2 * K2
    if g.shape[1] != N or K % 32 or scale.shape != (K // 32, N) or N % 8:
        raise ValueError(f"int4g32_matmul_t: unsupported shapes g {tuple(g.shape)}, "
                         f"packed {tuple(packed.shape)}, scale {tuple(scale.shape)}")
    if g.dtype not in (torch.bfloat16, torch.float16, torch.float32):
        raise TypeError(f"int4g32_matmul_t: g must be bf16, f16 or f32, not {g.dtype}")
    if packed.dtype != torch.uint8 or scale.dtype != torch.bfloat16:
        raise TypeError("int4g32_matmul_t: packed must be uint8 and scale bf16")
    for name, t in (("packed", packed), ("scale", scale)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"int4g32_matmul_t: {name} must be contiguous and 16-byte aligned")


def int4g32_t_splitk(g, packed, scale):
    """Launch B14's split-K tensor-core kernel (checked bf16 or f16 inputs on
    the card): one launch, the contraction splits merged inside it."""
    out = t_splitk_call("chatglm_int4_t_splitk", g, packed, scale, 2 * packed.shape[0])
    return _build.launched(int4g32_t_splitk, out, f16_form(g))


def int4g32_t_gemv(g, packed, scale):
    """Launch B14's CUDA-core kernel (checked f32 inputs on the card)."""
    if g.dtype != torch.float32:
        raise TypeError(f"int4g32_t_gemv: g must be f32, not {g.dtype}")
    M, N = g.shape
    K = 2 * packed.shape[0]
    out = torch.empty((M, K), dtype=g.dtype, device=g.device)
    _build.call("chatglm_int4_t_gemv", g.data_ptr(), packed.data_ptr(), scale.data_ptr(),
                out.data_ptr(), M, K, N, _build.dtype_code(g.dtype), _build.stream_ptr(g))
    return _build.launched(int4g32_t_gemv, out)


int4g32_t_gemv.launches = 0


def int4g32_t_mma(g, packed, scale):
    """Launch B14's Hopper tensor-core kernel (checked bf16 or f16 inputs on
    the card, N % 16 == 0): one launch, any contraction splits merged inside
    it."""
    M, N = g.shape
    K = 2 * packed.shape[0]
    out = torch.empty((M, K), dtype=g.dtype, device=g.device)
    wg_call("chatglm_int4_t_mma", g, packed, scale, out, M, K, N, K, t_mma_plan(M, K, N))
    return _build.launched(int4g32_t_mma, out, f16_form(g))


for _fn in (int4g32_t_splitk, int4g32_t_mma):
    _fn.launches = 0
    _build.with_forms(_fn, "f16")


def int4g32_matmul_t(g: torch.Tensor, packed: torch.Tensor,
                     scale: torch.Tensor) -> torch.Tensor:
    """g (M, N) bf16/f16/f32 @ dequant(packed (K/2, N) u8, scale (K/32, N) bf16)ᵀ
    → (M, K) in g's dtype: the int4g32 linear's grad_x at the storage K.

    On a CPU tensor this is the plain version; on a CUDA tensor it launches
    a kernel or raises."""
    if not _build.on_card(g):
        return int4g32_matmul_t_plain(g, packed, scale)
    _check_t(g, packed, scale)
    g = aligned(g)
    route = t_route(g.shape[0], g.shape[1], g.dtype)
    if route == "splitk":
        return int4g32_t_splitk(g, packed, scale)
    if route == "mma":
        return int4g32_t_mma(g, packed, scale)
    return int4g32_t_gemv(g, packed, scale)

"""The transposed split-K tensor-core kernel of the backward matmuls on the
CPU: B13 (``int8_t_splitk``) and B14 (``int4g32_t_splitk``) at bf16 M ≤
MMA_MIN_M, ``csrc/common.cuh``'s ``t_splitk_mma_kernel`` over the int8 and
int4g32 views.  What can be checked without the card:

* ``t_splitk_plan`` at the ChatGLM2-6B linears transposed (g (M, N) →
  (M, K)), M = 1-16, and at the card tests' edge shapes: every output
  column in exactly one (row tile, warp), every contraction element in
  exactly one (split, contraction warp, chunk, k16 step, lane quad), shared
  memory within the 46 KB the launch takes, the grid within two blocks an
  SM, and nothing the kernel's checks refuse.
* The route: bf16 ≤ 16 rows to ``*_t_splitk``, f32 to ``*_t_gemv``, bf16
  above to ``*_t_mma`` (and to ``*_t_splitk`` where N % 16 != 0, which the
  Hopper kernel cannot take); on a tensor that says it is on CUDA the
  wrappers reach that launch.
* The fragments, emulated in numpy from each lane's loads: the int8 rows'
  words through ``s8x4_bf16x2`` and the packed rows through
  ``int4_rows_pair<bf16>`` times the group's scale pair into m16n8k16 A
  registers, g's staged rows as B in the permuted contraction order; every
  (output row, g row) product of a chunk lands in the D element the
  epilogue stores for that row.
* The arithmetic emulated in torch (the scale folded into g in bf16, exact
  products summed in a fresh f32 partial every 32 contraction elements,
  each contraction warp's chunks in order, the two warps' sums in order,
  the splits' in split order, one rounding to bf16) against the JAX
  package's ``int8_matmul_t_pallas`` / ``int4_matmul_t_pallas`` in
  interpret mode on the same numpy inputs: within 2^-23 of the sum of the
  terms' magnitudes beyond a bf16 rounding (chip_smoke.py's SUM_TOL).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from chatglm_q_tpu.ops import pallas_matmul as PM  # noqa: E402
from chatglm_q_tpu_torch.ops import _build  # noqa: E402
from chatglm_q_tpu_torch.ops import int8_matmul as I8  # noqa: E402
from chatglm_q_tpu_torch.ops import quant_matmul as QM  # noqa: E402
from chatglm_q_tpu_torch.ops.quant import unpack_int4_tpu  # noqa: E402

SUM_TOL = 2.0 ** -23
# (K, N) of the transposed linears: g (M, N) -> (M, K); q_proj, kv_proj,
# o_proj, w_in_h / w_in_gate, w_out, lm_head (storage sizes)
LINEARS = [(4096, 4096), (4096, 512), (4096, 4096), (4096, 13824), (13824, 4096),
           (4096, 65536)]
# tests/test_torch_cuda.py's T_EDGES: (M, K, N)
T_EDGES = [(1, 4096, 512), (3, 256, 264), (16, 13824, 4096), (17, 4096, 4096),
           (130, 13824, 4096), (70, 4096, 65536)]
CHUNK, ROWS, CW = QM.TSK_CHUNK, QM.TSK_ROWS, QM.TSK_CW


# ---------------------------------------------------------------------------
# The plan and the route
# ---------------------------------------------------------------------------

def chunk_elements(c, N):
    """Chunk c's contraction elements by (k16 step s, lane quad t): 64c +
    16t + 4s .. + 3 (A registers 0 / 2 hold pairs 4s and 4s + 2), those
    below N."""
    return {(s, t): [n for n in range(CHUNK * c + 16 * t + 4 * s, CHUNK * c + 16 * t + 4 * s + 4)
                     if n < N] for s in range(4) for t in range(4)}


def row_owners(K, row):
    """Output row -> its (row tile, warp) owners, the warp's D rows mapped
    by the view's ``row(rt, gid, hi)`` (csrc: W::tsk_row)."""
    rows = {}
    for tile in range(-(-K // ROWS)):
        for rw in range(ROWS // 32):
            k0 = tile * ROWS + 32 * rw
            if k0 < K:
                for rt in range(2):
                    for gid in range(8):
                        for hi in range(2):
                            rows.setdefault(k0 + row(rt, gid, hi), []).append((tile, rw))
    return rows


def element_owners(N, plan):
    """Contraction element -> its (split, contraction warp, chunk, step,
    quad) owners under ``plan``."""
    _, nsplit, cps, _ = plan
    C = -(-N // CHUNK)
    elems = {}
    for sp in range(nsplit):
        chunks = list(range(sp * cps, min(C, (sp + 1) * cps)))
        for h in range(CW):
            for c in chunks[h::CW]:
                for (s, t), ns in chunk_elements(c, N).items():
                    for n in ns:
                        elems.setdefault(n, []).append((sp, h, c, s, t))
    return elems


INT8_ROW = lambda rt, gid, hi: 16 * rt + gid + 8 * hi  # noqa: E731
INT4_ROW = lambda rt, gid, hi: 16 * rt + 2 * gid + hi  # noqa: E731


SHAPES = sorted({(M, K, N) for K, N in LINEARS for M in range(1, 17)}
                | {(M, K, N) for M, K, N in T_EDGES})


@pytest.mark.parametrize("M,K,N", SHAPES)
def test_plan_covers_every_column_and_element(M, K, N):
    plan = QM.t_splitk_plan(M, K, N)
    mt, nsplit, cps, cs = plan
    assert QM.t_splitk_problem(M, K, N, plan) is None
    assert mt == (1 if M <= 8 else 2)
    assert QM.t_splitk_smem(mt, cs) <= QM.TSK_SMEM_MAX
    for row in (INT8_ROW, INT4_ROW):  # each output column once, in either view's row order
        rows = row_owners(K, row)
        assert sorted(rows) == list(range(K)) and all(len(o) == 1 for o in rows.values())
    elems = element_owners(N, plan)
    assert sorted(elems) == list(range(N)) and all(len(o) == 1 for o in elems.values())
    blocks = -(-K // ROWS) * -(-M // QM.TSK_MROWS) * nsplit
    assert nsplit == 1 or blocks <= QM.TSK_BLOCKS  # one wave at two blocks an SM
    if (K, N) in LINEARS and N >= 4096:  # the wide contractions fill the card
        assert blocks >= QM.SPLITK_SMS


def test_plan_refusals():
    """What the kernel refuses, the check names: rows past the m-tiles,
    splits short of N, stages of other than 4k chunks, too much shared
    memory."""
    assert QM.t_splitk_problem(9, 4096, 4096, (1, 8, 8, 8)) is not None
    assert QM.t_splitk_problem(16, 4096, 4096, (2, 7, 8, 8)) is not None
    assert QM.t_splitk_problem(16, 4096, 4096, (2, 8, 8, 6)) is not None
    assert QM.t_splitk_problem(16, 4096, 4096, (2, 1, 64, 24)) is not None
    assert QM.t_splitk_problem(16, 4096, 4096, (2, 1, 64, 20)) is None
    with pytest.raises(ValueError):
        QM.t_splitk_plan(4, 4096, 4100)


def test_routing():
    bf16, f32 = torch.bfloat16, torch.float32
    for M in range(1, 17):
        for N in (4096, 512, 65536, 264):
            assert QM.t_route(M, N, bf16) == "splitk"
            assert QM.t_route(M, N, f32) == "gemv"
    for M in (17, 64, 1024):
        assert QM.t_route(M, 4096, bf16) == "mma" and QM.t_route(M, 4096, f32) == "gemv"
        assert QM.t_route(M, 264, bf16) == "splitk"  # the Hopper kernel needs N % 16 == 0


class _Launched(Exception):
    pass


class _FakeCuda(torch.Tensor):
    @property
    def is_cuda(self):
        return True


@pytest.mark.parametrize("M,N,dtype,kernel", [
    (1, 256, torch.bfloat16, "splitk"), (16, 256, torch.bfloat16, "splitk"),
    (40, 264, torch.bfloat16, "splitk"), (17, 256, torch.bfloat16, "mma"),
    (4, 256, torch.float32, "gemv")])
def test_wrappers_launch_their_route(monkeypatch, M, N, dtype, kernel):
    """On a tensor that says it is on CUDA, each wrapper reaches its route's
    launch with the plan's arguments (never the plain version)."""
    seen = []

    def call(name, *args):
        seen.append(args)
        raise _Launched(name)

    monkeypatch.setattr(_build, "call", call)
    monkeypatch.setattr(_build, "stream_ptr", lambda t: 0)
    monkeypatch.setattr(_build, "scratch", lambda kind, device, n, dtype: torch.zeros(n, dtype=dtype))
    g = torch.zeros((M, N), dtype=dtype).as_subclass(_FakeCuda)
    with pytest.raises(_Launched, match=f"chatglm_int8_t_{kernel}$"):
        I8.int8_matmul_t(g, torch.zeros((128, N), dtype=torch.int8), torch.ones(N))
    with pytest.raises(_Launched, match=f"chatglm_int4_t_{kernel}$"):
        QM.int4g32_matmul_t(g, torch.zeros((64, N), dtype=torch.uint8),
                            torch.ones((4, N), dtype=torch.bfloat16))
    if kernel == "splitk":  # (..., M, K, N, g's dtype code, mt, nsplit, cps, cs, stream)
        assert all(tuple(a[6:14]) == (M, 128, N, _build.dtype_code(dtype),
                                      *QM.t_splitk_plan(M, 128, N)) for a in seen)


def test_wrappers_are_counted_kernels():
    from chatglm_q_tpu_torch import ops

    wrappers = ops.kernel_wrappers()
    assert wrappers["int8_t_splitk"] is I8.int8_t_splitk
    assert wrappers["int4g32_t_splitk"] is QM.int4g32_t_splitk


# ---------------------------------------------------------------------------
# Fragments: csrc mirrors in numpy
# ---------------------------------------------------------------------------

def byte_perm(x, y, s):
    """CUDA's __byte_perm on uint32 values: byte n of the result is byte
    (s >> 4n) & 7 of the eight bytes of y:x."""
    src = int(x) | (int(y) << 32)
    return sum(((src >> (8 * ((s >> (4 * n)) & 7))) & 0xFF) << (8 * n) for n in range(4))


def s8x4_bf16x2(w):
    """common.cuh s8x4_bf16x2: four int8 bytes → (lo, hi) bf16x2 words."""
    x = np.uint32(w ^ 0x80808080)
    f = [(np.uint32(byte_perm(x, 0x4B000000, 0x7540 + i)).view(np.float32)
          - np.float32(8388736.0)).astype(np.float32).view(np.uint32) for i in range(4)]
    return byte_perm(f[0], f[1], 0x7632), byte_perm(f[2], f[3], 0x7632)


def bf16_bits(v):
    """A float32 value that bf16 holds exactly, as its 16 bits."""
    return int(np.float32(v).view(np.uint32)) >> 16


def bf16x2(lo, hi):
    return bf16_bits(lo) | (bf16_bits(hi) << 16)


def bf16_pair(word):
    """A bf16x2 word's (low, high) halves as floats."""
    lo = np.uint32((int(word) & 0xFFFF) << 16).view(np.float32)
    hi = np.uint32(int(word) & 0xFFFF0000).view(np.float32)
    return float(lo), float(hi)


def nibble_pair_bf16x2(v):
    """common.cuh nibble_pair_bf16x2: bits 0-3 and 16-19 of v, two's
    complement nibbles, as the bf16x2 pair (q0, q1) (136 + q less 136)."""
    m = (v & 0x000F000F) ^ 0x43084308
    lo, hi = bf16_pair(m)
    return bf16x2(lo - 136.0, hi - 136.0)


def int4_rows_bf16x2(v):
    """common.cuh int4_rows_pair<bf16>: bytes b0, b1 (bits 0-15 of v) → (lo, hi)
    = (low nibbles of b0, b1), (high nibbles of b0, b1)."""
    v4 = v >> 4
    return (nibble_pair_bf16x2(byte_perm(v, v4, 0x4140)),
            nibble_pair_bf16x2(byte_perm(v, v4, 0x0504)))


def bf16x2_mul(a, b):
    """mul.rn.bf16x2: each product rounded once to bf16."""
    (a0, a1), (b0, b1) = bf16_pair(a), bf16_pair(b)
    r = torch.tensor([a0 * b0, a1 * b1], dtype=torch.float64).to(torch.bfloat16).float().numpy()
    return bf16x2(r[0], r[1])


def word(u8, i):
    """Word i (bytes 4i..4i+3, little-endian) of 16 bytes."""
    return int(np.ascontiguousarray(u8[4 * i:4 * i + 4]).view(np.uint32)[0])


def assemble_a16(regs):
    """m16n8k16 A (16 x 16) from each lane's 4 bf16x2 registers: a0 row gid
    K 2t..2t+1, a1 row gid + 8, a2 / a3 the same at K + 8."""
    a = {}
    for lane, r in regs.items():
        gid, t = lane >> 2, lane & 3
        for reg, dr, dk in zip(r, (0, 8, 0, 8), (0, 0, 8, 8)):
            lo, hi = bf16_pair(reg)
            a[gid + dr, 2 * t + dk], a[gid + dr, 2 * t + dk + 1] = lo, hi
    return a


def assemble_b16(regs):
    """m16n8k16 B (16 x 8) from each lane's 2 bf16x2 registers: b0 K 2t..2t+1
    of column gid, b1 K 2t + 8.."""
    b = {}
    for lane, (b0, b1) in regs.items():
        gid, t = lane >> 2, lane & 3
        b[2 * t, gid], b[2 * t + 1, gid] = bf16_pair(b0)
        b[2 * t + 8, gid], b[2 * t + 9, gid] = bf16_pair(b1)
    return b


def mma(a, b):
    """D (16 x 8) of one m16n8k16 from assembled A and B, in f64."""
    return np.array([[sum(a[r, k] * b[k, n] for k in range(16)) for n in range(8)]
                     for r in range(16)])


def int8_frag(w_rows, lane, s, rt):
    """Int8TView::tsk_frag (step s): lane (gid, t)'s rows gid + 8 i at its 16
    bytes, word s of rows 2 rt and 2 rt + 1."""
    gid, t = lane >> 2, lane & 3
    r = [w_rows[gid + 8 * i, 16 * t:16 * t + 16].view(np.uint8) for i in range(4)]
    a0, a2 = s8x4_bf16x2(word(r[2 * rt], s))
    a1, a3 = s8x4_bf16x2(word(r[2 * rt + 1], s))
    return a0, a1, a2, a3


def int4_frag(packed_rows, scales, lane, s, rt):
    """Int4TView::tsk_frag (step s): byte row 8 rt + gid at the lane's 16 bytes,
    the group's 16 scales there as bf16x2 pairs."""
    gid, t = lane >> 2, lane & 3
    v = word(packed_rows[8 * rt + gid, 16 * t:16 * t + 16], s)
    sp = [bf16x2(scales[16 * t + 2 * j], scales[16 * t + 2 * j + 1]) for j in range(8)]
    s01, s23 = sp[2 * s], sp[2 * s + 1]
    lo, hi = int4_rows_bf16x2(v & 0xFFFF)
    lo2, hi2 = int4_rows_bf16x2(v >> 16)
    return bf16x2_mul(lo, s01), bf16x2_mul(hi, s01), bf16x2_mul(lo2, s23), bf16x2_mul(hi2, s23)


def staged_b(xs, lane, s):
    """Lane (gid, t)'s B of k16 step s from g's staged row gid: 8 contiguous
    bf16 at 16t + 8 (s >> 1), steps 2h and 2h + 1 its (x, y) and (z, w)."""
    gid, t = lane >> 2, lane & 3
    e = xs[gid, 16 * t + 4 * s:16 * t + 4 * s + 4]
    return bf16x2(e[0], e[1]), bf16x2(e[2], e[3])


@pytest.mark.parametrize("view", ["int8", "int4"])
def test_fragments_hold_each_rows_products(view):
    """One warp, one chunk (64 contraction elements, 32 output rows, 8 g
    rows): the A registers from each lane's loads, B from the staged rows,
    four k16 steps per 16-row tile; every D element holds the dot of the
    output row and g row the epilogue stores it as (tsk_row)."""
    rng = np.random.default_rng(7 if view == "int8" else 8)
    xs = rng.integers(-20, 21, (8, CHUNK)).astype(np.float32) / 4  # exact bf16 values
    if view == "int8":
        w = rng.integers(-128, 128, (32, CHUNK)).astype(np.int8)
        w[0, 0], w[9, 5] = -128, 127
        weights = w.astype(np.float64)  # (output row, element)

        def frag(lane, s, rt):
            return int8_frag(w, lane, s, rt)

        def row(rt, gid, hi):
            return 16 * rt + gid + 8 * hi
    else:
        packed = rng.integers(0, 256, (16, CHUNK), dtype=np.uint8)
        packed[0, 0] = 0x88
        scales = (rng.integers(1, 64, CHUNK) / 256).astype(np.float32)  # exact bf16
        weights = unpack_int4_tpu(torch.from_numpy(packed),
                                  torch.from_numpy(scales[None, :]).to(torch.bfloat16)
                                  ).to(torch.bfloat16).double().numpy()

        def frag(lane, s, rt):
            return int4_frag(packed, scales, lane, s, rt)

        def row(rt, gid, hi):
            return 16 * rt + 2 * gid + hi
    got = np.zeros((32, 8))
    for rt in range(2):
        d = np.zeros((16, 8))
        for s in range(4):
            a = assemble_a16({lane: frag(lane, s, rt) for lane in range(32)})
            b = assemble_b16({lane: staged_b(xs, lane, s) for lane in range(32)})
            d += mma(a, b)
        for lane in range(32):  # each lane's accumulator (e) to its output row and g row
            gid, t = lane >> 2, lane & 3
            for e in range(4):
                got[row(rt, gid, e >> 1), 2 * t + (e & 1)] = d[gid + 8 * (e >> 1), 2 * t + (e & 1)]
    want = weights @ xs.astype(np.float64).T
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# The arithmetic against the JAX kernels
# ---------------------------------------------------------------------------

def emulate(gs, w, plan):
    """t_splitk_mma_kernel's sums of gs (M, N) (the folded g, f32 holding
    bf16 values) times w (K, N) (exact weights): per split, per contraction
    warp, its chunks in order, each chunk's two halves (k16 steps 0-1, 2-3:
    elements 16t + 8h ..) a fresh f32 partial of exact products added to
    the f32 accumulator; the warps' sums in order, the splits' in split
    order; f32 before the output's bf16 rounding."""
    _, nsplit, cps, _ = plan
    M, N = gs.shape
    C = -(-N // CHUNK)
    g64, w64 = gs.double(), w.double()
    y = torch.zeros((M, w.shape[0]), dtype=torch.float32)
    for sp in range(nsplit):
        chunks = list(range(sp * cps, min(C, (sp + 1) * cps)))
        block = []
        for h in range(CW):
            acc = torch.zeros_like(y)
            for c in chunks[h::CW]:
                for half in range(2):
                    idx = [CHUNK * c + 16 * t + 8 * half + j for t in range(4) for j in range(8)
                           if CHUNK * c + 16 * t + 8 * half + j < N]
                    acc = acc + (g64[:, idx] @ w64[:, idx].T).float()
            block.append(acc)
        y = y + (block[0] + block[1])
    return y


def beyond_sum(got, ref, terms):
    """Error of ``got`` against ``ref`` beyond half a bf16 ulp of ref, over
    the sum of the terms' magnitudes."""
    half_ulp = torch.ldexp(torch.ones_like(ref), torch.frexp(ref).exponent - 9)
    excess = ((got.double() - ref.double()).abs() - half_ulp).clamp_min(0.0)
    return (excess / terms.clamp_min(1e-300)).max().item()


def bf16_values(rng, M, N):
    g = rng.standard_normal((M, N)).astype(np.float32)
    g[M // 2] = 0
    return np.array(jnp.asarray(g).astype(jnp.bfloat16).astype(jnp.float32))


# (M, K, N, plan or None for the built-in one): 64 chunks over 8 splits;
# 66 chunks, an odd count a warp, over several stages (cps 7 > cs 4); kv's
# narrow contraction in one split; 9 rows in 3 splits, the last short
ARITH = [(1, 256, 4096, None), (4, 384, 4224, (1, 10, 7, 4)), (16, 256, 512, None),
         (9, 128, 1408, (2, 3, 8, 8))]


@pytest.mark.parametrize("M,K,N,plan", ARITH)
def test_b13_arithmetic_matches_jax_kernel(M, K, N, plan):
    rng = np.random.default_rng(10 * M + K + N)
    w = rng.integers(-128, 128, (K, N)).astype(np.int8)
    scale = ((0.5 + rng.random(N, dtype=np.float32)) * 0.01).astype(np.float32)
    g = bf16_values(rng, M, N)
    want = np.array(PM.int8_matmul_t_pallas(jnp.asarray(g).astype(jnp.bfloat16),
                                              jnp.asarray(w), jnp.asarray(scale), interpret=True)
                      .astype(jnp.float32))
    plan = plan or QM.t_splitk_plan(M, K, N)
    assert QM.t_splitk_problem(M, K, N, plan) is None
    gt = torch.from_numpy(g).to(torch.bfloat16)
    gs = (gt * torch.from_numpy(scale).to(torch.bfloat16)).float()  # the fold, in bf16
    wt = torch.from_numpy(w)
    got = emulate(gs, wt.float(), plan)
    exact = gs.double() @ wt.double().T
    terms = gs.double().abs() @ wt.double().abs().T
    assert beyond_sum(got, torch.from_numpy(want), terms) <= SUM_TOL
    assert beyond_sum(got.to(torch.bfloat16), exact, terms) <= SUM_TOL
    plain = I8.int8_matmul_t_plain(gt, wt, torch.from_numpy(scale))
    assert beyond_sum(got, plain, terms) <= SUM_TOL
    assert not got[M // 2].any()


@pytest.mark.parametrize("M,K,N,plan", ARITH)
def test_b14_arithmetic_matches_jax_kernel(M, K, N, plan):
    rng = np.random.default_rng(20 * M + K + N)
    packed = rng.integers(0, 256, (K // 2, N), dtype=np.uint8)
    scale = (rng.random((K // 32, N), dtype=np.float32) * 0.02).astype(jnp.bfloat16)
    g = bf16_values(rng, M, N)
    want = np.array(PM.int4_matmul_t_pallas(jnp.asarray(g).astype(jnp.bfloat16),
                                              jnp.asarray(packed), jnp.asarray(scale),
                                              interpret=True).astype(jnp.float32))
    plan = plan or QM.t_splitk_plan(M, K, N)
    assert QM.t_splitk_problem(M, K, N, plan) is None
    st = torch.from_numpy(np.asarray(scale).astype(np.float32)).to(torch.bfloat16)
    wq = unpack_int4_tpu(torch.from_numpy(packed), st).to(torch.bfloat16).float()  # bf16(q·s)
    gt = torch.from_numpy(g)
    got = emulate(gt, wq, plan)
    exact = gt.double() @ wq.double().T
    terms = gt.double().abs() @ wq.double().abs().T
    assert beyond_sum(got, torch.from_numpy(want), terms) <= SUM_TOL
    assert beyond_sum(got.to(torch.bfloat16), exact, terms) <= SUM_TOL
    assert not got[M // 2].any()


@pytest.mark.parametrize("view", ["int8", "int4"])
def test_ragged_contraction_matches_exact(view):
    """N = 1000: the last chunk's quads hold 16, 16, 8 and 0 elements below
    N (the 8-byte loads of a row that is not 16-byte aligned), which the
    JAX kernels take only through their jnp fallback: the emulation against
    the exact value and the port's plain version."""
    M, K, N = 5, 256, 1000
    rng = np.random.default_rng(31 if view == "int8" else 32)
    g = torch.from_numpy(bf16_values(rng, M, N)).to(torch.bfloat16)
    if view == "int8":
        w = torch.from_numpy(rng.integers(-128, 128, (K, N)).astype(np.int8))
        scale = torch.from_numpy(((0.5 + rng.random(N)) * 0.01).astype(np.float32))
        gs, wf = (g * scale.to(torch.bfloat16)).float(), w.float()
        plain = I8.int8_matmul_t_plain(g, w, scale)
    else:
        packed = torch.from_numpy(rng.integers(0, 256, (K // 2, N), dtype=np.uint8))
        scale = (torch.from_numpy(rng.random((K // 32, N), dtype=np.float32)) * 0.02
                 ).to(torch.bfloat16)
        gs, wf = g.float(), unpack_int4_tpu(packed, scale).to(torch.bfloat16).float()
        plain = QM.int4g32_matmul_t_plain(g, packed, scale)
    plan = QM.t_splitk_plan(M, K, N)
    got = emulate(gs, wf, plan)
    terms = gs.double().abs() @ wf.double().abs().T
    assert beyond_sum(got.to(torch.bfloat16), gs.double() @ wf.double().T, terms) <= SUM_TOL
    assert beyond_sum(got, plain, terms) <= SUM_TOL
    last = chunk_elements(N // CHUNK, N)  # its elements by lane quad
    assert [sum(len(last[s, t]) for s in range(4)) for t in range(4)] == [16, 16, 8, 0]


def test_arithmetic_shapes_split_and_stage():
    """The shapes above take one split and several (8 and more in two), an
    odd chunk count a warp, and more than one stage."""
    plans = [p or QM.t_splitk_plan(M, K, N) for M, K, N, p in ARITH]
    assert [p[1] for p in plans] == [8, 10, 1, 3]
    assert any(p[2] % (2 * CW) for p in plans) and any(p[2] > p[3] for p in plans)

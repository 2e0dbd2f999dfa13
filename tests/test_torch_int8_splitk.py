"""The split-K tensor-core kernels of the int8 decode matmuls on the CPU: B6
(``int8_splitk``, bf16 x) and B7 / B8 (``int8_dyn_splitk`` /
``int4_dyn_splitk``, per-row s8 xq) at M ≤ MMA_MIN_M, on common.cuh's
split-K body (B1's decode design).  What can be checked without the card:

* ``splitk_plan`` over bf16 rows (B6) and s8 rows (B7/B8), int8 weights
  (B6/B7) and int4g32 ones (B8), at the ChatGLM2-6B linears and M = 1, 2,
  4, 8, 16: every K group in exactly one split, one or two m-tiles, staging
  chunks the kernel takes, shared memory within 48 KB (four blocks an SM),
  partials bounded, the grid filling the card where two groups a warp
  allow; int8 weights take 16 columns a lane only with four groups a warp.
* Routing: bf16 M ≤ 16 to the split-K kernels, M > 16 to the Hopper
  kernels, f32 to the f32 forms of the same two (test_torch_f32_matmul.py),
  B1 unchanged.
* The fragment arrangements, emulated in numpy from each lane's loads: B6's
  PRMT pairing and ``s8x4_bf16x2`` into m16n8k16 bf16 A registers, B7's
  4x4 byte transposes into m16n8k32 s8 A registers, B8's nibbles moved to
  the high half of their bytes (16 q) first; every (column, x row) product
  of a group lands in the D element the kernel's epilogue reads.
* Each kernel's arithmetic emulated in torch (exact products, a fresh
  partial every 32-row group, the warps' sums in warp order, the splits'
  in split order, the scales last) against the JAX package's grid kernels
  in interpret mode on the same numpy inputs: B6 against
  ``int8_matmul_pallas`` at 1e-5 of max|y| in f32, B7 against
  ``int8_dyn_matmul_pallas`` bit for bit, B8 against
  ``int4_dyn_matmul_pallas`` at 1e-5.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from chatglm_q_tpu.ops import pallas_matmul as PM  # noqa: E402
from chatglm_q_tpu_torch.ops import dyn_matmul as D  # noqa: E402
from chatglm_q_tpu_torch.ops import int8_matmul as I8  # noqa: E402
from chatglm_q_tpu_torch.ops import quant_matmul as QM  # noqa: E402
from chatglm_q_tpu_torch.ops.quant import unpack_int4_tpu_q  # noqa: E402

# (K, N) at storage sizes: q_proj, kv_proj, o_proj, w_in_h / w_in_gate,
# w_out, lm_head; then a ragged one (N not a multiple of 16)
LINEARS = [(4096, 4096), (4096, 512), (4096, 4096), (4096, 13824), (13824, 4096),
           (4096, 65536), (4000, 264)]
DECODE_M = (1, 2, 4, 8, 16)
KW = QM.SPLITK_KW


# ---------------------------------------------------------------------------
# Plans and routing
# ---------------------------------------------------------------------------

# (xbytes, int8_weights) of B6, B7 and B8
KERNEL_PLANS = {"b6": (2, True), "b7": (1, True), "b8": (1, False)}


@pytest.mark.parametrize("kind", KERNEL_PLANS)
@pytest.mark.parametrize("M", DECODE_M)
@pytest.mark.parametrize("K,N", LINEARS)
def test_plan_covers_every_group(K, N, M, kind):
    xbytes, int8_weights = KERNEL_PLANS[kind]
    mt, cols, nsplit, gps, cg = QM.splitk_plan(M, K, N, xbytes, int8_weights)
    G = K // 32
    assert mt == (1 if M <= 8 else 2)  # the kernels instantiate one and two m-tiles
    assert cols in (8, 16) and (cols == 8 or (N % 16 == 0 and mt == 1))
    covered = [g for s in range(nsplit) for g in range(s * gps, min(G, (s + 1) * gps))]
    assert covered == list(range(G))  # each group once, in order
    assert cg % 8 == 0 and cg >= 8
    assert QM.splitk_smem(M, cg, cols, xbytes) <= 48 * 1024  # four blocks an SM
    tiles = -(-N // (8 * cols))
    assert 4 * tiles * nsplit * M * 8 * cols <= QM.SPLITK_SMS * 4 * 16 * 128 * 4
    if (K, N) in LINEARS[:6]:  # the grid fills the card where two groups a warp allow
        assert tiles * nsplit >= min(QM.SPLITK_SMS // 2, tiles * -(-G // (2 * KW)))
    if int8_weights and cols == 16:  # twice the bytes a group: four groups a warp
        assert gps >= min(G, 4 * KW)


def test_s8_rows_only_widen_the_staging_chunk():
    """B7/B8 stage s8 rows: the same splits as bf16 rows, chunks as large."""
    for K, N in LINEARS:
        for M in DECODE_M:
            for int8_weights in (False, True):
                a = QM.splitk_plan(M, K, N, 2, int8_weights)
                b = QM.splitk_plan(M, K, N, 1, int8_weights)
                assert a[:4] == b[:4] and b[4] >= a[4]
    assert QM.splitk_smem(16, 40, 8, 1) < QM.splitk_smem(16, 40, 8, 2)


def test_int8_weights_narrow_the_lanes_only_at_q_and_o_proj():
    """At M = 1 and 4, q_proj and o_proj (4096 columns) take 8 columns a
    lane and 8 splits of 16 groups with int8 weights, 16 columns and 16
    splits of 8 with int4g32 ones (B1's plan); the other linears keep one
    plan for both."""
    for M in (1, 4):
        assert QM.splitk_plan(M, 4096, 4096, 2, True)[1:4] == (8, 8, 16)
        assert QM.splitk_plan(M, 4096, 4096, 2, False)[1:4] == (16, 16, 8)
        for K, N in LINEARS[1:2] + LINEARS[3:6]:
            assert QM.splitk_plan(M, K, N, 2, True) == QM.splitk_plan(M, K, N, 2, False)


def test_routing():
    bf16, f32 = torch.bfloat16, torch.float32
    assert QM.MMA_MIN_M == 16
    for M in DECODE_M:
        for N in (4096, 512, 264):
            assert I8.int8_route(M, N, bf16) == "splitk"
            assert I8.int8_route(M, N, f32) == ("splitk" if M <= QM.F32_SPLITK_MAX
                                                else "mma" if N % 16 == 0 else "gemv")
            assert not D.uses_mma(M, N)  # B7/B8: the split-K kernels
    assert I8.int8_route(17, 4096, bf16) == "mma" and D.uses_mma(17, 4096)
    assert I8.int8_route(17, 264, bf16) == "gemv" and not D.uses_mma(17, 264)
    assert I8.int8_route(512, 4096, f32) == "mma"
    for M in (1, 16, 17, 64):  # B1 unchanged
        assert QM.int4_route(M, 4096, bf16) == "splitk"
    assert QM.int4_route(65, 4096, bf16) == "mma"


# ---------------------------------------------------------------------------
# Fragments: csrc mirrors in numpy
# ---------------------------------------------------------------------------

def byte_perm(x, y, s):
    """CUDA's __byte_perm on uint32 values: byte n of the result is byte
    (s >> 4n) & 7 of the eight bytes of y:x."""
    src = int(x) | (int(y) << 32)
    return sum(((src >> (8 * ((s >> (4 * n)) & 7))) & 0xFF) << (8 * n) for n in range(4))


def s8x4_bf16x2(w):
    """common.cuh s8x4_bf16x2: four int8 bytes → (lo, hi) bf16x2 words, each
    byte through f32 (biased byte under the exponent of 2^23, less 2^23 +
    128) and its high half."""
    x = np.uint32(w ^ 0x80808080)
    f = [(np.uint32(byte_perm(x, 0x4B000000, 0x7540 + i)).view(np.float32)
          - np.float32(8388736.0)).astype(np.float32).view(np.uint32) for i in range(4)]
    return byte_perm(f[0], f[1], 0x7632), byte_perm(f[2], f[3], 0x7632)


def bf16_pair(word):
    """A bf16x2 word's (low, high) halves as floats."""
    lo = np.uint32((int(word) & 0xFFFF) << 16).view(np.float32)
    hi = np.uint32(int(word) & 0xFFFF0000).view(np.float32)
    return float(lo), float(hi)


def s8_bytes(word):
    return [((int(word) >> (8 * i)) & 0xFF) - (256 if (int(word) >> (8 * i)) & 0x80 else 0)
            for i in range(4)]


def transpose4x4(r):
    """common.cuh transpose4x4_bytes: byte j of r[i] → byte i of r[j]."""
    t0, t1 = byte_perm(r[0], r[1], 0x5140), byte_perm(r[0], r[1], 0x7362)
    t2, t3 = byte_perm(r[2], r[3], 0x5140), byte_perm(r[2], r[3], 0x7362)
    return [byte_perm(t0, t2, 0x5410), byte_perm(t0, t2, 0x7632),
            byte_perm(t1, t3, 0x5410), byte_perm(t1, t3, 0x7632)]


def words(rows_u8):
    """(R, C) uint8 rows → (R, C / 4) little-endian uint32 words."""
    return np.ascontiguousarray(rows_u8).view(np.uint32)


def mma(a_rows, b_cols, kdim):
    """D (16 x 8) of one mma from its per-thread fragments: A rows and B
    columns as dicts (row or column, logical k) → value."""
    d = np.zeros((16, 8))
    for r in range(16):
        for n in range(8):
            d[r, n] = sum(a_rows[r, k] * b_cols[k, n] for k in range(kdim))
    return d


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


def assemble_a32(regs):
    """m16n8k32 s8 A (16 x 32): a0 row gid K 4t..4t+3, a1 row gid + 8, a2 /
    a3 the same at K + 16."""
    a = {}
    for lane, r in regs.items():
        gid, t = lane >> 2, lane & 3
        for reg, dr, dk in zip(r, (0, 8, 0, 8), (0, 0, 16, 16)):
            for i, v in enumerate(s8_bytes(reg)):
                a[gid + dr, 4 * t + dk + i] = v
    return a


def lanes_d(tile_d, j, cols):
    """Each (D row, x row) of tile j's D as (weight column of the lane group,
    x row): D row gid is column gid*COLS + 2j, gid + 8 column gid*COLS + 2j
    + 1 (the accumulator map the epilogue reads)."""
    out = {}
    for r in range(16):
        col = (r % 8) * cols + 2 * j + r // 8
        for n in range(8):
            out[col, n] = tile_d[r, n]
    return out


@pytest.mark.parametrize("cols", (8, 16))
def test_b6_fragments_hold_each_columns_products(cols):
    """Int8SkView::group: each lane's 8 K rows of its COLS columns, paired
    by PRMT and converted by s8x4_bf16x2 into A; x's bf16 elements 8t +
    4h.. as B; the two k16 steps of a column pair give its group dot."""
    rng = np.random.default_rng(cols)
    w = rng.integers(-128, 128, (32, 8 * cols)).astype(np.int8)  # one group, one tile
    w[0, 0], w[1, 1] = -128, 127
    x = rng.integers(-20, 21, (8, 32)).astype(np.float64) / 4  # exact bf16 values
    got = {}
    for j in range(cols // 2):
        q, sel = j >> 1, (0x7362 if j & 1 else 0x5140)
        d = np.zeros((16, 8))
        for h in range(2):
            regs, b = {}, {}
            for lane in range(32):
                gid, t = lane >> 2, lane & 3
                wd = words(w[8 * t:8 * t + 8, gid * cols:(gid + 1) * cols].view(np.uint8))
                a0, a1 = s8x4_bf16x2(byte_perm(wd[4 * h, q], wd[4 * h + 1, q], sel))
                a2, a3 = s8x4_bf16x2(byte_perm(wd[4 * h + 2, q], wd[4 * h + 3, q], sel))
                regs[lane] = (a0, a1, a2, a3)
                k = 8 * t + 4 * h  # b0: x elements k, k + 1; b1: k + 2, k + 3
                b[2 * t, gid], b[2 * t + 1, gid] = x[gid, k], x[gid, k + 1]
                b[2 * t + 8, gid], b[2 * t + 9, gid] = x[gid, k + 2], x[gid, k + 3]
            d += mma(assemble_a16(regs), b, 16)
        got.update(lanes_d(d, j, cols))
    want = x @ w.astype(np.float64)  # (8 x rows, 8 cols columns)
    assert sorted(got) == [(c, n) for c in range(8 * cols) for n in range(8)]
    for (c, n), v in got.items():
        assert v == want[n, c], (c, n)


@pytest.mark.parametrize("int4", (False, True))
@pytest.mark.parametrize("cols", (8, 16))
def test_s8_fragments_hold_each_columns_products(cols, int4):
    """B7 (Int8DynSkView) and B8 (Int4DynSkView): each lane's K rows 8t..8t+7
    of its COLS columns (B8: byte rows 4t..4t+3, each nibble moved to the
    high half of its byte, reading 16 q) transposed 4x4 into one K-ordered
    word per column; xq's bytes 8t..8t+7 of row gid as B; one m16n8k32 a
    column pair gives its group dot (B8: 16 times it)."""
    rng = np.random.default_rng(10 + cols + int4)
    xq = rng.integers(-127, 128, (8, 32)).astype(np.int8)
    if int4:
        packed = rng.integers(0, 256, (16, 8 * cols), dtype=np.uint8)
        packed[0, 0] = 0x88  # -8 in both nibbles
        w = unpack_int4_tpu_q(torch.from_numpy(packed)).numpy().astype(np.int64)  # (32, N)
    else:
        w8 = rng.integers(-128, 128, (32, 8 * cols)).astype(np.int8)
        w8[0, 0] = -128
        w = w8.astype(np.int64)
    got = {}
    for q in range(cols // 4):
        per_lane = {}
        for lane in range(32):
            gid, t = lane >> 2, lane & 3
            if int4:
                wd = words(packed[4 * t:4 * t + 4, gid * cols:(gid + 1) * cols])[:, q]
                rows = []
                for v in wd:
                    rows += [(int(v) << 4) & 0xF0F0F0F0, int(v) & 0xF0F0F0F0]
            else:
                wd = words(w8[8 * t:8 * t + 8, gid * cols:(gid + 1) * cols].view(np.uint8))
                rows = [int(v) for v in wd[:, q]]
            per_lane[lane] = transpose4x4(rows[:4]), transpose4x4(rows[4:])
        for jj in range(2):
            j = 2 * q + jj
            regs, b = {}, {}
            for lane in range(32):
                gid, t = lane >> 2, lane & 3
                lo, hi = per_lane[lane]
                regs[lane] = (lo[2 * jj], lo[2 * jj + 1], hi[2 * jj], hi[2 * jj + 1])
                for i in range(4):  # b0: xq bytes 8t..8t+3 (logical K 4t..), b1: 8t+4..
                    b[4 * t + i, gid] = int(xq[gid, 8 * t + i])
                    b[16 + 4 * t + i, gid] = int(xq[gid, 8 * t + 4 + i])
            got.update(lanes_d(mma(assemble_a32(regs), b, 32), j, cols))
    want = xq.astype(np.int64) @ w * (16 if int4 else 1)
    assert sorted(got) == [(c, n) for c in range(8 * cols) for n in range(8)]
    for (c, n), v in got.items():
        assert v == want[n, c], (c, n)


# ---------------------------------------------------------------------------
# The arithmetic against the JAX kernels
# ---------------------------------------------------------------------------

def splits(M, K, N, kind):
    """Each split of the kernel's plan: its warps' groups."""
    _, _, nsplit, gps, _ = QM.splitk_plan(M, K, N, *KERNEL_PLANS[kind])
    G = K // 32
    for sp in range(nsplit):
        g0, g1 = sp * gps, min(G, (sp + 1) * gps)
        yield [range(g0 + w, g1, KW) for w in range(KW)]


def group_dot(x, w, g):
    return x[:, 32 * g:32 * g + 32].double() @ w[32 * g:32 * g + 32].double()  # exact


def b6_emulate(x, w, scale):
    """Per split, per warp: acc = f32(acc + f32(group dot)) over its groups;
    the warps' sums in warp order, the splits' in split order; times the
    column scale in f32."""
    M, K = x.shape
    y = torch.zeros((M, w.shape[1]), dtype=torch.float32)
    for warps in splits(M, K, w.shape[1], "b6"):
        block = None
        for groups in warps:
            acc = torch.zeros_like(y)
            for g in groups:
                acc = acc + group_dot(x, w, g).float()
            block = acc if block is None else block + acc
        y = y + block
    return y * scale


def b7_emulate(xq, sx, w, scale):
    """int32 sums (exact in any order), then (float(acc) · sx) · scale."""
    M, K = xq.shape
    acc = torch.zeros((M, w.shape[1]), dtype=torch.int64)
    for warps in splits(M, K, w.shape[1], "b7"):
        for groups in warps:
            for g in groups:
                acc += group_dot(xq, w, g).long()
    assert acc.abs().max() < 2 ** 31
    return (acc.float() * sx) * scale


def b8_emulate(xq, sx, q, gscale):
    """Per split, per warp: acc = fma(float(group dot), scale, acc), one
    rounding (the dot · scale is exact in f64); warps in warp order, splits
    in split order; times sx."""
    M, K = xq.shape
    s = gscale.double()
    y = torch.zeros((M, q.shape[1]), dtype=torch.float32)
    for warps in splits(M, K, q.shape[1], "b8"):
        block = None
        for groups in warps:
            acc = torch.zeros_like(y)
            for g in groups:
                acc = (acc.double() + group_dot(xq, q, g) * s[g]).float()
            block = acc if block is None else block + acc
        y = y + block
    return y * sx


def bf16_values(rng, M, K):
    x = rng.standard_normal((M, K)).astype(np.float32)
    return np.array(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))


# (K, N): split K (N = 256: 4 column tiles of 64), 16 columns a lane at M ≤ 8
# (N = 2048), and w_out's K (groups not a multiple of the warps' pairs)
ARITH = [(1024, 256), (1024, 2048), (13824, 384)]


def test_arithmetic_shapes_split_and_widen():
    plans = [QM.splitk_plan(M, K, N, *KERNEL_PLANS[kind]) for K, N in ARITH for M in (1, 16)
             for kind in KERNEL_PLANS]
    assert any(p[2] > 1 for p in plans) and any(p[1] == 16 for p in plans)


@pytest.mark.parametrize("K,N", ARITH)
@pytest.mark.parametrize("M", (1, 4, 16))
def test_b6_arithmetic_matches_jax_kernel(M, K, N):
    rng = np.random.default_rng(100 * M + K + N)
    w = rng.integers(-128, 128, (K, N)).astype(np.int8)
    scale = ((0.5 + rng.random(N, dtype=np.float32)) * 0.01).astype(np.float32)
    x = bf16_values(rng, M, K)
    want = np.asarray(PM.int8_matmul_pallas(jnp.asarray(x), jnp.asarray(w), jnp.asarray(scale),
                                            scheme="convert", interpret=True))
    got = b6_emulate(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(scale))
    assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()


def x_values(rng, M, K):
    x = rng.standard_normal((M, K)).astype(np.float32)
    x[M // 2] = 0  # sx at its 1e-10 clamp, xq all zero
    return x


@pytest.mark.parametrize("K,N", ARITH)
@pytest.mark.parametrize("M", (1, 4, 16))
def test_b7_arithmetic_matches_jax_kernel_bit_for_bit(M, K, N):
    rng = np.random.default_rng(3 * M + K + N)
    w = rng.integers(-128, 128, (K, N)).astype(np.int8)
    scale = ((0.5 + rng.random(N, dtype=np.float32)) * 0.01).astype(np.float32)
    x = x_values(rng, M, K)
    want = PM.int8_dyn_matmul_pallas(jnp.asarray(x), jnp.asarray(w), jnp.asarray(scale),
                                     interpret=True)
    xq, sx = D.dyn_quantize_rows(torch.from_numpy(x))
    got = b7_emulate(xq, sx, torch.from_numpy(w), torch.from_numpy(scale))
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert torch.equal(got, D.int8_dyn_matmul_plain(torch.from_numpy(x), torch.from_numpy(w),
                                                    torch.from_numpy(scale)))


@pytest.mark.parametrize("K,N", [(1024, 256), (1024, 2048), (13824, 384)])
@pytest.mark.parametrize("M", (1, 4, 16))
def test_b8_arithmetic_matches_jax_kernel(M, K, N):
    rng = np.random.default_rng(5 * M + K + N)
    packed = rng.integers(0, 256, (K // 2, N), dtype=np.uint8)
    gscale = (rng.random((K // 32, N), dtype=np.float32) * 0.02).astype(jnp.bfloat16)
    x = x_values(rng, M, K)
    want = PM.int4_dyn_matmul_pallas(jnp.asarray(x), jnp.asarray(packed), jnp.asarray(gscale),
                                     interpret=True)
    assert want is not None  # the JAX grid kernel, not a fallback
    want = np.asarray(want)
    xq, sx = D.dyn_quantize_rows(torch.from_numpy(x))
    q = unpack_int4_tpu_q(torch.from_numpy(packed))
    s = torch.from_numpy(np.asarray(gscale).astype(np.float32))
    got = b8_emulate(xq, sx, q, s)
    assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()
    assert not got[M // 2].any()

"""The dynamic-int8 Hopper kernel (csrc/dyn_matmul.cu ``dyn_wgmma_kernel``:
B7 ``int8_dyn_mma``, B8 ``int4_dyn_mma``) on the CPU, above ``MMA_MIN_M``
rows.  What can be checked without the card:

* ``dyn_plan`` (``wg_plan`` over stages of 128 s8 elements) at the
  ChatGLM2-6B linears for M = 17, 36, 57, 64, 65, 512: every work unit
  taken once, every output tile with each of its K splits once, the splits
  covering every 128-element stage once; shared memory (``mma_smem``, the
  kernel's ring: as many stages as fit, up to 8) within the H100's opt-in
  limit; the narrow linears split to keep ~128 blocks streaming weights.
* Routing unchanged: the tensor-core kernel above 16 rows, B8 up to the
  JAX package's int4-dyn ceiling of 64 rows.
* The A fragments: a stage's weight tile laid out as TMA's 128B swizzle
  leaves it, each lane's ldmatrix.trans row (mirrors of the views'
  ``lane``), the thread's PRMTs, assembled into each warpgroup's 64 × 32 A
  of every k32 step: every D row holds its column's K-ordered s8 weights
  (B8: 16 q of the tpu-order nibbles), the D rows cover the tile's 128
  columns once, and no ldmatrix phase meets a bank twice.
* B8's conversion: p + 0x4B400000 read as f32, less 2^23 + 2^22, equals
  float(p) for every |p| < 2^22 (every group partial 16·dot, |dot| ≤
  32,512, lies there), and the scale over 16 is exact, so the fold is the
  plain version's float(dot) · scale.
* B7's int32 split merge equals the unsplit sum, where an f32 merge would
  round.
* The kernel's arithmetic emulated in torch with its splits and its fold
  order against the JAX package's ``int8_dyn_matmul_pallas`` /
  ``int4_dyn_matmul_pallas`` in interpret mode, on shapes the JAX grid
  kernels take: B7 bit-equal, B8 within 1e-5 of max|y|.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from chatglm_q_tpu.ops import linear as JL  # noqa: E402
from chatglm_q_tpu.ops import pallas_matmul as PM  # noqa: E402
from chatglm_q_tpu_torch.ops import dyn_matmul as D  # noqa: E402
from chatglm_q_tpu_torch.ops import linear as TL  # noqa: E402
from chatglm_q_tpu_torch.ops import quant_matmul as QM  # noqa: E402
from chatglm_q_tpu_torch.ops.quant import unpack_int4_tpu_q  # noqa: E402

LINEARS = [("q_proj", 4096, 4096), ("kv_proj", 4096, 512), ("o_proj", 4096, 4096),
           ("w_in", 4096, 13824), ("w_out", 13824, 4096), ("lm_head", 4096, 65536),
           ("ragged", 4000, 272)]
PLAN_M = (17, 36, 57, 64, 65, 512)
STEP = 128  # csrc: DYN_STEP


def test_step_mirrors_the_kernel():
    assert QM.DYN_STEP == STEP == 2 * QM.MMA_STEP


@pytest.mark.parametrize("M", PLAN_M)
@pytest.mark.parametrize("name,K,N", LINEARS)
def test_dyn_plan_covers_every_tile_and_stage(M, name, K, N):
    bm, nsplit, sps, ctas = D.dyn_plan(M, K, N)
    assert (bm, nsplit, sps, ctas) == QM.wg_plan(M, K, N, step=STEP)
    S = -(-K // STEP)
    mtiles, ntiles = -(-M // bm), -(-N // QM.MMA_BN)
    n_units = mtiles * ntiles * nsplit
    assert bm in (64, 128) and 1 <= ctas <= min(QM.SPLITK_SMS, n_units)
    assert (nsplit - 1) * sps < S <= nsplit * sps  # csrc: wg_plan_ok
    taken = sorted(u for b in range(ctas) for u in range(b, n_units, ctas))
    assert taken == list(range(n_units))
    by_tile = {}
    for u in range(n_units):  # csrc: WgSchedule::unit
        mt, rest = u % mtiles, u // mtiles
        sp, nt = rest % nsplit, rest // nsplit
        by_tile.setdefault((mt, nt), []).append((sp, sp * sps, min(S, (sp + 1) * sps)))
    assert sorted(by_tile) == [(m, n) for m in range(mtiles) for n in range(ntiles)]
    for splits in by_tile.values():
        assert [s for s, _, _ in splits] == list(range(nsplit))
        assert [s for _, s0, s1 in splits for s in range(s0, s1)] == list(range(S))
    assert mtiles * bm >= M > (mtiles - 1) * bm
    for kind in ("int8_dyn", "int4g32_dyn"):
        assert QM.mma_smem(bm, kind) <= QM.MMA_SMEM_MAX
    if nsplit > 1:
        assert n_units <= 2 * QM.SPLITK_SMS
    if M <= 64 and name in ("q_proj", "o_proj", "w_out"):  # 32 tiles: split to ~128 blocks
        assert nsplit == 4 and n_units == 128
    if name == "kv_proj":  # 4 column tiles
        assert nsplit > 1


@pytest.mark.parametrize("kind,wbytes,sbytes", [("int8_dyn", 128 * 128, 0),
                                                ("int4g32_dyn", 64 * 128, 4 * 128 * 2)])
def test_smem_mirrors_the_kernel_ring(kind, wbytes, sbytes):
    # per stage the bm x 128 s8 activation tile and the view's tiles (B7: 128
    # K rows x 128 int8 bytes; B8: 64 packed byte rows x 128 and 4 x 128 bf16
    # scales); stages as fit 227 KB less barriers, flags and slack, up to 8
    # (csrc: dyn_stages); two barriers a stage, two merge flags, 1024 bytes
    # of alignment slack
    assert QM.MMA_TILE_BYTES[kind] == (wbytes, sbytes)
    for bm in (64, 128):
        stage = bm * 128 + wbytes + sbytes
        stages = min(8, (232448 - 16 - 1024) // (stage + 16))
        assert QM.mma_stages(bm, kind) == stages
        assert QM.mma_smem(bm, kind) == stages * stage + 16 * stages + 16 + 1024 <= 232448
    assert QM.mma_stages(128, "int8_dyn") == 7  # 32 KB stages
    assert QM.mma_stages(64, "int8_dyn") == QM.mma_stages(128, "int4g32_dyn") == 8
    for kind in ("int4g32", "int8", "int4g32_t", "int8_t"):  # the other Hopper rings keep 8
        assert QM.mma_stages(64, kind) == QM.mma_stages(128, kind) == QM.MMA_STAGES


def test_routing_is_unchanged():
    assert QM.MMA_MIN_M == 16
    assert not D.uses_mma(16, 4096) and D.uses_mma(17, 4096) and D.uses_mma(1024, 512)
    assert not D.uses_mma(64, 264)
    assert TL._INT4_DYN_M_MAX == JL._INT4_DYN_M_MAX == 64


# ---------------------------------------------------------------------------
# The A fragments, byte for byte
# ---------------------------------------------------------------------------

def byte_perm(x, y, s):
    """CUDA's __byte_perm on uint32 values: byte n of the result is byte
    (s >> 4n) & 7 of the eight bytes of y:x."""
    src = (int(y) << 32) | int(x)
    return sum(((src >> (8 * ((s >> (4 * n)) & 7))) & 0xFF) << (8 * n) for n in range(4))


def swizzle128(tile):
    """A tile of 128-byte rows as TMA's 128B swizzle stores it: 16-byte chunk
    q of row r at chunk q ^ (r & 7)."""
    out = np.empty_like(tile)
    for r in range(tile.shape[0]):
        for q in range(8):
            p = q ^ (r & 7)
            out[r, 16 * p:16 * p + 16] = tile[r, 16 * q:16 * q + 16]
    return out.reshape(-1)


def ldmatrix_trans(flat, addrs, n):
    """ldmatrix.sync.m8n8.xn.trans.b16 of one warp: matrix i's row r is the
    8 b16 at addrs[8i + r]; lane l = 4 gid + t receives in register i the
    elements (row 2t, column gid) (low half) and (row 2t + 1, column gid)."""
    regs = np.zeros((32, n), np.uint32)
    for lane in range(32):
        gid, t = lane >> 2, lane & 3
        for i in range(n):
            lo = addrs[8 * i + 2 * t] + 2 * gid
            hi = addrs[8 * i + 2 * t + 1] + 2 * gid
            regs[lane, i] = (int(flat[lo]) | int(flat[lo + 1]) << 8
                             | int(flat[hi]) << 16 | int(flat[hi + 1]) << 24)
    return regs


def bank_conflict_free(addrs, n):
    """Each phase (the 8 rows of one matrix, 16 bytes each) hits 8 distinct
    16-byte bank groups of the 128-byte bank line."""
    return all(len({(addrs[8 * i + r] % 128) // 16 for r in range(8)}) == 8 for i in range(n))


def b7_lane(tid):
    """Int8DynView::lane: (c, ldmatrix row offset o, sel_c, sel_c1)."""
    wg, w, l = tid >> 7, (tid >> 5) & 3, tid & 31
    t, q = l & 3, 4 * wg + w
    i, tt = l >> 3, (l & 7) >> 1
    sw = tt & 2
    r = 16 * (i >> 1) + 4 * tt + (2 - sw if i & 1 else sw) + (l & 1)
    c = 16 * q + 2 * ((l >> 2) & 7)
    o = r * 128 + ((q ^ (r & 7)) << 4)
    return c, o, (0x2064 if t & 2 else 0x6420), (0x3175 if t & 2 else 0x7531)


def b8_lane(tid):
    """Int4DynView::lane: (c, ldmatrix row offset o)."""
    l, q = tid & 31, 4 * (tid >> 7) + ((tid >> 5) & 3)
    r = l & 15
    return 16 * q + 2 * ((l >> 2) & 7), r * 128 + ((q ^ (r & 7)) << 4)


def s8_bytes(word):
    return np.frombuffer(np.uint32(word).tobytes(), np.int8).astype(np.int64)


def assemble(frags, cols):
    """Each warpgroup's A of one k32 step (64 D rows x 32) from the threads'
    registers (m64k32 s8: a0 row 16w + gid, K 4t..4t+3; a1 row + 8; a2, a3
    the same at K + 16), and each D row's output column."""
    a = np.full((2, 64, 32), -999, np.int64)
    col = np.full((2, 64), -1)
    for tid, regs in frags.items():
        wg, w, gid, t = tid >> 7, (tid >> 5) & 3, (tid >> 2) & 7, tid & 3
        row = 16 * w + gid
        col[wg, row], col[wg, row + 8] = cols[tid], cols[tid] + 1
        for reg, dr, dk in zip(regs, (0, 8, 0, 8), (0, 0, 16, 16)):
            a[wg, row + dr, 4 * t + dk:4 * t + dk + 4] = s8_bytes(reg)
    assert sorted(col.reshape(-1).tolist()) == list(range(128))  # the pairing is a bijection
    return a, col


def test_b7_fragments_hold_each_columns_weights():
    rng = np.random.default_rng(3)
    w = rng.integers(-128, 128, (128, 128)).astype(np.int8)  # a stage: 128 K rows x 128 N
    flat = swizzle128(w.view(np.uint8))
    for h in range(4):  # the stage's k32 steps
        frags, cols = {}, {}
        for warp in range(8):
            lanes = [b7_lane(32 * warp + l) for l in range(32)]
            addrs = [o + h * 32 * 128 for _, o, _, _ in lanes]
            assert bank_conflict_free(addrs, 4)
            m = ldmatrix_trans(flat, addrs, 4)
            for l, (c, _, sel_c, sel_c1) in enumerate(lanes):
                tid = 32 * warp + l
                cols[tid] = c
                frags[tid] = (byte_perm(m[l, 0], m[l, 1], sel_c), byte_perm(m[l, 0], m[l, 1], sel_c1),
                              byte_perm(m[l, 2], m[l, 3], sel_c), byte_perm(m[l, 2], m[l, 3], sel_c1))
        a, col = assemble(frags, cols)
        for wg in range(2):
            assert np.array_equal(a[wg], w[32 * h:32 * h + 32, col[wg]].T.astype(np.int64))


def test_b7_rows_without_the_swap_would_conflict():
    # the swap of threads 2 and 3's row pairs is what keeps each phase's 8
    # rows in 8 swizzle positions: rows 4t + {0, 1} alone repeat r & 7
    plain = [r * 128 + ((0 ^ (r & 7)) << 4) for r in (0, 1, 4, 5, 8, 9, 12, 13)]
    assert not bank_conflict_free(plain, 1)


def test_b8_fragments_hold_16_q_of_each_column():
    rng = np.random.default_rng(4)
    packed = rng.integers(0, 256, (64, 128), dtype=np.uint8)  # a stage: 64 byte rows x 128 N
    q = unpack_int4_tpu_q(torch.from_numpy(packed)).numpy().astype(np.int64)  # (128 K, 128)
    assert q.min() == -8 and q.max() == 7
    flat = swizzle128(packed)
    for g in range(4):  # the stage's groups, one k32 step each
        frags, cols = {}, {}
        for warp in range(8):
            lanes = [b8_lane(32 * warp + l) for l in range(32)]
            addrs = [lanes[l & 15][1] + g * 16 * 128 for l in range(32)]
            assert bank_conflict_free(addrs, 2)
            m = ldmatrix_trans(flat, addrs, 2)
            for l, (c, _) in enumerate(lanes):
                tid, regs = 32 * warp + l, []
                for i in range(2):  # Int4DynView::load
                    lo = (int(m[l, i]) << 4) & 0xF0F0F0F0
                    hi = int(m[l, i]) & 0xF0F0F0F0
                    regs += [byte_perm(lo, hi, 0x6240), byte_perm(lo, hi, 0x7351)]
                cols[tid] = c
                frags[tid] = (regs[0], regs[1], regs[2], regs[3])
        a, col = assemble(frags, cols)
        for wg in range(2):
            assert np.array_equal(a[wg], 16 * q[32 * g:32 * g + 32, col[wg]].T)


# ---------------------------------------------------------------------------
# B8's fold, bit for bit
# ---------------------------------------------------------------------------

def s32_to_f32_exact(p):
    """csrc: s32_to_f32_exact, on int64 arrays (the int32 add cannot wrap for
    |p| < 2^22)."""
    bits = (np.asarray(p, np.int64) + 0x4B400000).astype(np.uint32)
    return bits.view(np.float32) - np.float32(12582912.0)


def test_conversion_is_exact_over_every_partial():
    dots = np.arange(-32512, 32513, dtype=np.int64)  # every group dot: 32 · 127 · 8
    assert np.array_equal(s32_to_f32_exact(16 * dots), (16 * dots).astype(np.float32))
    edge = 2 ** 22 - 1
    p = np.concatenate([np.arange(-edge, -edge + 4096), np.arange(edge - 4095, edge + 1),
                        np.random.default_rng(5).integers(-edge, edge + 1, 1 << 20)])
    got = s32_to_f32_exact(p)
    assert np.array_equal(got.astype(np.float64), p.astype(np.float64))  # exact ints
    assert s32_to_f32_exact([-edge, edge]).tolist() == [-edge, edge]


def test_fold_is_the_plain_versions_product():
    """float(16 dot) · (s / 16) is float(dot) · s for every finite bf16 scale
    at or above 2^-122 (and 0): the quotient is exact, so the FMA rounds the
    same real number."""
    bits = np.arange(1 << 16, dtype=np.uint32)
    s = (bits << np.uint32(16)).view(np.float32)
    keep = np.isfinite(s) & ((np.abs(s) >= 2.0 ** -122) | (s == 0))
    s = s[keep]
    s16 = s * np.float32(0.0625)
    assert np.array_equal(s16.astype(np.float64), s.astype(np.float64) / 16)
    rng = np.random.default_rng(6)
    dots = rng.integers(-32512, 32513, s.size)
    want = dots.astype(np.float64) * s.astype(np.float64)
    got = s32_to_f32_exact(16 * dots).astype(np.float64) * s16.astype(np.float64)
    assert np.array_equal(got, want)


def test_int32_split_merge_equals_the_unsplit_sum():
    """B7's splits' int32 partials summed in split order are the exact sum;
    an f32 merge of the same partials rounds (|acc| passes 2^24 at K =
    13824)."""
    K, N, M = 13824, 64, 4
    xq = torch.full((M, K), 127, dtype=torch.int32)
    xq[1::2] = -127
    w = torch.full((K, N), 127, dtype=torch.int32)
    w[:, 1::2] = torch.randint(-128, 128, (K, N // 2), generator=torch.Generator().manual_seed(7),
                               dtype=torch.int32)
    w[::STEP] = 126  # odd sums in every split: above 2^24 they do not fit an f32
    exact = xq.long() @ w.long()
    assert exact.abs().max() > 2 ** 24 and exact.abs().max() < 2 ** 31
    for nsplit, sps in ((4, 27), (2, 54), (8, 14)):
        parts = [(xq[:, s0:s1].long() @ w[s0:s1].long()).int()
                 for s0, s1 in ((STEP * sp * sps, min(K, STEP * (sp + 1) * sps))
                                for sp in range(nsplit))]
        merged = torch.zeros_like(parts[0])
        for p in parts:
            merged += p
        assert torch.equal(merged.long(), exact)
    f32 = sum(p.float() for p in parts)
    assert not torch.equal(f32.double(), exact.double())


# ---------------------------------------------------------------------------
# The arithmetic against the JAX kernels
# ---------------------------------------------------------------------------

def b7_emulate(xq, w, sx, scale, plan):
    """int32 partials per K split of ``plan`` (any order within: exact),
    merged in split order; then (float(acc) · sx) · scale in f32."""
    M, K = xq.shape
    _, nsplit, sps, _ = plan
    acc = torch.zeros((M, w.shape[1]), dtype=torch.int64)
    for sp in range(nsplit):
        k0, k1 = STEP * sp * sps, min(K, STEP * (sp + 1) * sps)
        acc += (xq[:, k0:k1].long() @ w[k0:k1].long()).int().long()
    assert acc.abs().max() < 2 ** 31
    return (acc.float() * sx) * scale


def b8_emulate(xq, q, gscale, sx, plan):
    """Per K split, each group's exact dot times its scale added to the f32
    accumulator (one rounding: dot · s is exact in f32, |dot| < 2^15 and s
    of 8 bits), groups in order; the splits added in split order; · sx."""
    M, K = xq.shape
    _, nsplit, sps, _ = plan
    G = K // 32
    y = torch.zeros((M, q.shape[1]), dtype=torch.float32)
    s = gscale.float()
    for sp in range(nsplit):
        acc = torch.zeros_like(y)
        for g in range(4 * sp * sps, min(G, 4 * (sp + 1) * sps)):
            dot = (xq[:, 32 * g:32 * g + 32].long() @ q[32 * g:32 * g + 32].long()).float()
            prod = dot * s[g]
            assert torch.equal(prod.double(), dot.double() * s[g].double())  # exact
            acc = acc + prod
        y = y + acc
    return y * sx


def x_values(rng, M, K):
    x = rng.standard_normal((M, K)).astype(np.float32)
    x[M // 2] = 0  # sx at its 1e-10 clamp, xq all zero
    return x


# (M, K, N): shapes the JAX grid kernels take, M across 17-130, the plan with
# and without K splits
DYN_EMULATED = [(17, 512, 256), (36, 1024, 384), (57, 2048, 256), (64, 4096, 256),
                (65, 512, 512), (130, 768, 256)]


def test_emulated_shapes_merge_splits():
    splits = [D.dyn_plan(M, K, N)[1] for M, K, N in DYN_EMULATED]
    assert any(p > 1 for p in splits) and any(p == 1 for p in splits)


@pytest.mark.parametrize("M,K,N", DYN_EMULATED)
def test_b7_arithmetic_matches_jax_kernel(M, K, N):
    rng = np.random.default_rng(M + 3 * K + N)
    w = rng.integers(-128, 128, (K, N)).astype(np.int8)
    scale = ((0.5 + rng.random(N, dtype=np.float32)) * 0.01).astype(np.float32)
    x = x_values(rng, M, K)
    want = PM.int8_dyn_matmul_pallas(jnp.asarray(x), jnp.asarray(w), jnp.asarray(scale),
                                     interpret=True)
    assert want is not None  # the JAX grid kernel, not a fallback
    xq, sx = D.dyn_quantize_rows(torch.from_numpy(x))
    got = b7_emulate(xq, torch.from_numpy(w), sx, torch.from_numpy(scale), D.dyn_plan(M, K, N))
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert torch.equal(got, D.int8_dyn_matmul_plain(torch.from_numpy(x), torch.from_numpy(w),
                                                    torch.from_numpy(scale)))


@pytest.mark.parametrize("M,K,N", DYN_EMULATED)
def test_b8_arithmetic_matches_jax_kernel(M, K, N):
    rng = np.random.default_rng(2 * M + K + N)
    packed = rng.integers(0, 256, (K // 2, N), dtype=np.uint8)
    gscale = (rng.random((K // 32, N), dtype=np.float32) * 0.02).astype(jnp.bfloat16)
    x = x_values(rng, M, K)
    want = PM.int4_dyn_matmul_pallas(jnp.asarray(x), jnp.asarray(packed), jnp.asarray(gscale),
                                     interpret=True)
    assert want is not None  # the JAX grid kernel, not a fallback
    want = np.asarray(want)
    xq, sx = D.dyn_quantize_rows(torch.from_numpy(x))
    q = unpack_int4_tpu_q(torch.from_numpy(packed))
    s = torch.from_numpy(np.asarray(gscale).astype(np.float32)).to(torch.bfloat16)
    got = b8_emulate(xq, q, s, sx, D.dyn_plan(M, K, N))
    assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()
    assert not got[M // 2].any()

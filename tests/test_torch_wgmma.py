"""The Hopper weight-only kernels on B1's mainloop (csrc/common.cuh) on the
CPU: B6's ``int8_wgmma_kernel`` (``int8_mma``) and the transposed
``t_wgmma_kernel`` of B13 (``int8_t_mma``) and B14 (``int4g32_t_mma``),
bf16 activations above ``MMA_MIN_M`` rows.  What can be checked without
the card:

* The plans (``wg_plan`` for B6; ``t_mma_plan``, the same over the
  contraction N, for B13/B14) at the ChatGLM2-6B linears for M = 17, 65,
  128, 512, 1024: every work unit taken once, every output tile with each
  of its contraction splits once, the splits covering every 64-element
  stage once, the tiles overhanging M and the output by less than a tile,
  shared memory (``mma_smem``, equal to the kernel's ring) within the
  H100's opt-in limit; ``kv_proj``'s 4 column tiles split to fill the card.
* Routing unchanged: bf16 above MMA_MIN_M with N % 16 == 0.
* The conversions (csrc/common.cuh), emulated bit for bit:
  ``s8x4_bf16x2`` exact over all 256 bytes; B14's ``int4_rows_pair<bf16>``
  times ``mul2<bf16>`` equal to ``unpack_int4_tpu(...).to(bf16)`` over all
  16 nibbles in both nibble positions and a sweep of scales; B13's fold
  bf16(g · bf16(s)) equal to the plain version's ``g * scale.to(bf16)``,
  its 256 threads covering every (row, 16-byte chunk) of a g stage once
  with that chunk's own scales under TMA's 128B swizzle.
* The A fragments: each stage's weight (and scale) tiles laid out as TMA's
  swizzles leave them (128B for B6, 64B for B13/B14), each consumer
  thread's loads at its lane offsets (mirrors of the views' ``lane``) and
  conversions, assembled into each warpgroup's 64 × 16 A matrices: every D
  row holds its output column's weights, and the D rows map onto the
  tile's 128 output columns one to one (the pairing the epilogue inverts).
* The kernels' arithmetic emulated in torch (per contraction split each
  64-element stage's f32 partial of exact products added to an f32
  accumulator, the splits added in split order; B6's column scale on the
  total) against the JAX package's grid kernels in interpret mode —
  ``int8_matmul_pallas(scheme="convert")``, ``int8_matmul_t_pallas``,
  ``int4_matmul_t_pallas`` — on the same numpy inputs, at 1e-5 of max|y|.
  They run in f32, where JAX rounds neither B14's weights nor B13's
  folded g to bf16: there the scales make those products exact in bf16
  (B14 s = k/64 with k < 16, B13 s a power of two); the conversion tests
  above check the roundings for any scale.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from chatglm_q_tpu.ops import pallas_matmul as PM  # noqa: E402
from chatglm_q_tpu_torch.ops import quant_matmul as QM  # noqa: E402
from chatglm_q_tpu_torch.ops.quant import unpack_int4_tpu  # noqa: E402

# (name, K, N) at storage sizes, and a ragged one (partial stages and tiles)
LINEARS = [("q_proj", 4096, 4096), ("kv_proj", 4096, 512), ("o_proj", 4096, 4096),
           ("w_in", 4096, 13824), ("w_out", 13824, 4096), ("lm_head", 4096, 65536),
           ("ragged", 4000, 272)]
PLAN_M = (17, 65, 128, 512, 1024)


@pytest.mark.parametrize("M", PLAN_M)
@pytest.mark.parametrize("name,K,N", LINEARS)
@pytest.mark.parametrize("kind", ["int8", "transposed"])
def test_plan_covers_every_tile_and_stage(kind, M, name, K, N):
    """B6 contracts over K into N columns, B13/B14 over N into K."""
    C, n_out = (K, N) if kind == "int8" else (N, K)
    bm, nsplit, sps, ctas = QM.wg_plan(M, C, n_out)
    if kind == "transposed":
        assert (bm, nsplit, sps, ctas) == QM.t_mma_plan(M, K, N)
    S = -(-C // QM.MMA_STEP)
    mtiles, ntiles = -(-M // bm), -(-n_out // QM.MMA_BN)
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
    assert ntiles * QM.MMA_BN >= n_out > (ntiles - 1) * QM.MMA_BN
    for k in (("int8",) if kind == "int8" else ("int8_t", "int4g32_t")):
        assert QM.mma_smem(bm, k) <= QM.MMA_SMEM_MAX
    if nsplit > 1:  # the split partials stay within two waves of units
        assert n_units <= 2 * QM.SPLITK_SMS
    if name != "ragged" and M >= 512:  # prefill and training shapes fill the card
        assert n_units >= QM.SPLITK_SMS // 2
    if kind == "int8" and name == "kv_proj":
        assert nsplit > 1


@pytest.mark.parametrize("kind,wbytes,sbytes", [("int8", 64 * 128, 0),
                                                ("int4g32_t", 64 * 64, 4 * 64 * 2),
                                                ("int8_t", 128 * 64, 64 * 4)])
def test_smem_mirrors_the_kernel_ring(kind, wbytes, sbytes):
    # per stage the activations' bm x 64 bf16 and the view's tiles (B6: 64 K
    # rows x 128 int8 bytes; B14: 64 byte rows x 64 and 4 x 64 bf16 scales;
    # B13: 128 rows x 64 bytes and 64 f32 scales); two barriers a stage, two
    # merge flags, 1024 bytes of alignment slack — B1's layout
    assert QM.MMA_TILE_BYTES[kind] == (wbytes, sbytes)
    for bm in (64, 128):
        stage = bm * 128 + wbytes + sbytes
        assert QM.mma_smem(bm, kind) == QM.MMA_STAGES * stage + 16 * QM.MMA_STAGES + 16 + 1024
    assert QM.mma_smem(128) == QM.mma_smem(128, "int4g32") == 8 * (16384 + 4096 + 512) + 1168


def test_routing_is_unchanged():
    bf16, f32 = torch.bfloat16, torch.float32
    assert QM.MMA_MIN_M == 16
    assert not QM.uses_mma(16, 4096, bf16) and QM.uses_mma(17, 4096, bf16)
    assert QM.uses_mma(1024, 512, bf16) and not QM.uses_mma(1024, 264, bf16)
    assert not QM.uses_mma(1024, 4096, f32)


# ---------------------------------------------------------------------------
# The device arithmetic, bit for bit
# ---------------------------------------------------------------------------

def byte_perm(x, y, s):
    """CUDA's __byte_perm on uint32 arrays: byte n of the result is byte
    (s >> 4n) & 7 of the eight bytes of y:x."""
    x, y = np.asarray(x, np.uint64), np.asarray(y, np.uint64)
    src = x | (y << np.uint64(32))
    out = np.zeros(np.broadcast(x, y).shape, np.uint64)
    for n in range(4):
        sel = (s >> (4 * n)) & 7
        out |= ((src >> np.uint64(8 * sel)) & np.uint64(0xFF)) << np.uint64(8 * n)
    return out.astype(np.uint32)


def to_bf16_bits(f32):
    """Round-to-nearest-even f32 → bf16 bits (what cvt.rn.bf16 and the RN
    bf16x2 arithmetic give for an exactly known f32 value)."""
    t = torch.from_numpy(np.ascontiguousarray(f32, np.float32)).to(torch.bfloat16)
    return t.view(torch.int16).numpy().astype(np.uint16).astype(np.uint32)


def bits_to_f32(bits):
    return (np.asarray(bits, np.uint32) << np.uint32(16)).view(np.float32)


def halves(word):
    """A bf16x2 word's (low, high) halves as f32."""
    w = np.asarray(word, np.uint32)
    return bits_to_f32(w & np.uint32(0xFFFF)), bits_to_f32(w >> np.uint32(16))


def pack(lo_bits, hi_bits):
    return np.asarray(lo_bits, np.uint32) | (np.asarray(hi_bits, np.uint32) << np.uint32(16))


def bf16x2_mul(a, b):
    """mul.rn.bf16x2: each product of two bf16 values, exact in f32, rounded
    once to bf16."""
    (a0, a1), (b0, b1) = halves(a), halves(b)
    return pack(to_bf16_bits(a0 * b0), to_bf16_bits(a1 * b1))


def nibble_pair_bf16x2(v):
    """csrc/common.cuh nibble_pair_bf16x2: LOP3 (v & 0x000F000F) ^ 0x43084308,
    then an FMA by 1 and -136 in bf16x2 (exact: 136 + q - 136)."""
    m = (np.asarray(v, np.uint32) & np.uint32(0x000F000F)) ^ np.uint32(0x43084308)
    lo, hi = halves(m)
    return pack(to_bf16_bits(lo - 136.0), to_bf16_bits(hi - 136.0))


def int4_rows_bf16x2(v):
    v = np.asarray(v, np.uint32)
    v4 = v >> np.uint32(4)
    return (nibble_pair_bf16x2(byte_perm(v, v4, 0x4140)),
            nibble_pair_bf16x2(byte_perm(v, v4, 0x0504)))


def s8x4_bf16x2(w):
    """csrc/common.cuh s8x4_bf16x2: four int8 bytes → (lo, hi) bf16x2 words."""
    x = np.asarray(w, np.uint32) ^ np.uint32(0x80808080)
    f = [(byte_perm(x, 0x4B000000, 0x7540 + i).view(np.float32) - np.float32(8388736.0))
         .astype(np.float32).view(np.uint32) for i in range(4)]
    return byte_perm(f[0], f[1], 0x7632), byte_perm(f[2], f[3], 0x7632)


def test_int8_conversion_is_exact_over_all_256_bytes():
    b = np.arange(256, dtype=np.uint32)
    want = b.astype(np.uint8).view(np.int8).astype(np.float32)
    wbits = to_bf16_bits(want)  # bf16 holds every int8 exactly
    assert np.array_equal(bits_to_f32(wbits), want)
    for pos in range(4):  # each byte in each of the four positions of a word
        lo, hi = s8x4_bf16x2(b << np.uint32(8 * pos))
        vals = np.concatenate([np.stack(halves(lo), -1), np.stack(halves(hi), -1)], -1)
        assert np.array_equal(vals[:, pos], want)
        assert not np.delete(vals, pos, axis=1).any()  # the other bytes are 0
        got = ((lo if pos < 2 else hi) >> np.uint32(16 * (pos & 1))) & np.uint32(0xFFFF)
        assert np.array_equal(got, wbits)


def test_b14_weights_are_bf16_of_q_times_s():
    """Two neighbouring packed bytes (every pair of the 256 x 256) against a
    sweep of scale pairs: the two bf16x2 pairs of int4_rows_bf16x2, each
    multiplied by the scale pair, equal unpack_int4_tpu's dequantized
    weights rounded to bf16 — every nibble in both positions."""
    b0, b1 = np.meshgrid(np.arange(256, dtype=np.uint32), np.arange(256, dtype=np.uint32))
    b0, b1 = b0.reshape(-1), b1.reshape(-1)
    lo, hi = int4_rows_bf16x2(b0 | (b1 << np.uint32(8)))
    # the reference: byte row 0 of one 32-row group holds the pairs side by side
    packed = torch.zeros((16, 2 * len(b0)), dtype=torch.uint8)
    packed[0] = torch.from_numpy(np.stack([b0, b1], 1).reshape(-1).astype(np.uint8))
    rng = np.random.default_rng(11)
    sweep = np.concatenate([rng.random(6, dtype=np.float32) * 0.05,
                            np.float32([1.0, 3.0e-3, 7.77e-4, -0.0123, 1.5e-5, 0.5])])
    for s_lo, s_hi in zip(sweep, sweep[::-1]):
        sbits = pack(to_bf16_bits([s_lo]), to_bf16_bits([s_hi]))
        scale = torch.tensor([[s_lo, s_hi]]).to(torch.bfloat16).repeat(1, len(b0))
        want = unpack_int4_tpu(packed, scale).to(torch.bfloat16).float().numpy()
        for k, pair in ((0, lo), (1, hi)):  # low nibbles: output row 2r; high: 2r + 1
            got = np.stack(halves(bf16x2_mul(pair, sbits)), 1).reshape(-1)
            assert np.array_equal(got, want[k])


def test_b13_fold_is_bf16_of_g_times_bf16_s():
    rng = np.random.default_rng(12)
    g = torch.from_numpy(rng.standard_normal(4096).astype(np.float32)).to(torch.bfloat16)
    s = torch.from_numpy((rng.random(4096, dtype=np.float32) * 0.05).astype(np.float32))
    gb = g.view(torch.int16).numpy().astype(np.uint16).astype(np.uint32)
    sb = to_bf16_bits(s.numpy())  # cvt.rn.bf16x2.f32 of the f32 scales
    lo, hi = halves(bf16x2_mul(pack(gb[0::2], gb[1::2]), pack(sb[0::2], sb[1::2])))
    want = (g * s.to(torch.bfloat16)).float().numpy()  # int8_matmul_t_plain's fold
    assert np.array_equal(np.stack([lo, hi], 1).reshape(-1), want)


@pytest.mark.parametrize("bm", (64, 128))
def test_b13_fold_covers_each_chunk_once_with_its_scales(bm):
    seen = {}
    for i in range(256):  # Int8TView::fold_tile
        p, r0 = i & 7, i >> 3
        q = p ^ (r0 & 7)
        for j in range(bm // 32):
            r = r0 + 32 * j
            assert p ^ (r & 7) == q  # chunk p of row r holds columns 8q..8q+7 there
            seen[r, q] = seen.get((r, q), 0) + 1
    assert sorted(seen) == [(r, q) for r in range(bm) for q in range(8)]
    assert set(seen.values()) == {1}


def swizzle(tile, row_bytes):
    """A tile as TMA's swizzle stores it: 128B (128-byte rows: 16-byte chunk
    q of row r at chunk q ^ (r & 7)) or 64B (64-byte rows: chunk q at q ^
    ((r >> 1) & 3))."""
    out = np.empty_like(tile)
    for r in range(tile.shape[0]):
        x = (r & 7) if row_bytes == 128 else ((r >> 1) & 3)
        for q in range(row_bytes // 16):
            p = q ^ x
            out[r, 16 * p:16 * p + 16] = tile[r, 16 * q:16 * q + 16]
    return out.reshape(-1)


def u16(flat, off):
    return np.uint32(flat[off]) | (np.uint32(flat[off + 1]) << np.uint32(8))


def u32(flat, off):
    return np.frombuffer(flat[off:off + 4].tobytes(), np.uint32)[0]


def thread_ids(tid):
    return tid >> 7, (tid >> 5) & 3, (tid >> 2) & 7, tid & 3


def assemble(fragments):
    """Each warpgroup's A per k16 step (64 D rows x 16) from the threads'
    fragment registers (m64k16: a0 row gid, K 2t..2t+1; a1 row gid + 8; a2,
    a3 the same at K + 8), and each D row's output column."""
    a = np.full((4, 2, 64, 16), np.nan, np.float32)
    cols = np.full((2, 64), -1)
    for tid, (regs, c0, c1) in fragments.items():
        wg, w, gid, t = thread_ids(tid)
        row = 16 * w + gid
        cols[wg, row], cols[wg, row + 8] = c0, c1
        for h in range(4):
            for reg, dr, dk in zip(regs[h], (0, 8, 0, 8), (0, 0, 8, 8)):
                lo, hi = (np.ravel(v)[0] for v in halves(reg))
                a[h, wg, row + dr, 2 * t + dk], a[h, wg, row + dr, 2 * t + dk + 1] = lo, hi
    # the D-row pairing: a bijection onto the tile's 128 columns
    assert sorted(cols.reshape(-1).tolist()) == list(range(128))
    return a, cols


def test_b6_fragments_hold_each_columns_weights():
    rng = np.random.default_rng(3)
    w = rng.integers(-128, 128, (64, 128)).astype(np.int8)  # a stage: 64 K rows x 128 N
    flat = swizzle(w.view(np.uint8), 128)
    frags = {}
    for tid in range(256):  # Int8FwdView::lane and load
        wg, wp, gid, t = thread_ids(tid)
        c = wg * 64 + 16 * wp + 2 * gid
        o = []
        for i in range(4):  # K rows 2t, 2t + 1, 2t + 8, 2t + 9 at columns c, c + 1
            r = 2 * t + (i & 1) + 8 * (i >> 1)
            o.append(r * 128 + (((c >> 4) ^ (r & 7)) << 4) + (c & 15))
        regs = []
        for h in range(4):
            r = [u16(flat, h * 16 * 128 + oi) for oi in o]
            f0, f1 = s8x4_bf16x2(byte_perm(r[0], r[1], 0x5140))
            f2, f3 = s8x4_bf16x2(byte_perm(r[2], r[3], 0x5140))
            regs.append((f0, f1, f2, f3))
        frags[tid] = (regs, c, c + 1)
    a, cols = assemble(frags)
    for h in range(4):
        for wg in range(2):
            assert np.array_equal(a[h, wg], w[16 * h:16 * h + 16, cols[wg]].T.astype(np.float32))


def test_b14_fragments_hold_each_columns_weights():
    rng = np.random.default_rng(13)
    packed = rng.integers(0, 256, (64, 64), dtype=np.uint8)  # a stage: 64 byte rows x 64 N
    scale = torch.from_numpy(rng.random((4, 64), dtype=np.float32) * 0.02).to(torch.bfloat16)
    flat = swizzle(packed, 64)
    sflat = scale.view(torch.int16).numpy().view(np.uint8).reshape(-1)
    frags = {}
    for tid in range(256):  # Int4TView::lane and load
        wg, w, gid, t = thread_ids(tid)
        c = wg * 64 + 16 * w + 2 * gid
        r = c >> 1
        o = [r * 64 + ((h ^ ((r >> 1) & 3)) << 4) + 2 * t for h in range(4)]
        so = (c >> 5) * 128 + 4 * t
        regs = []
        for h in range(4):
            s0, s1 = u32(sflat, so + 32 * h), u32(sflat, so + 32 * h + 16)
            lo0, hi0 = int4_rows_bf16x2(u16(flat, o[h]))
            lo1, hi1 = int4_rows_bf16x2(u16(flat, o[h] + 8))
            regs.append((bf16x2_mul(lo0, s0), bf16x2_mul(hi0, s0), bf16x2_mul(lo1, s1),
                         bf16x2_mul(hi1, s1)))
        frags[tid] = (regs, c, c + 1)
    a, cols = assemble(frags)
    w_hat = unpack_int4_tpu(torch.from_numpy(packed), scale).to(torch.bfloat16).float().numpy()
    for h in range(4):
        for wg in range(2):
            assert np.array_equal(a[h, wg], w_hat[cols[wg], 16 * h:16 * h + 16])


def test_b13_fragments_hold_each_columns_weights():
    rng = np.random.default_rng(14)
    w = rng.integers(-128, 128, (128, 64)).astype(np.int8)  # a stage: 128 rows x 64 N
    flat = swizzle(w.view(np.uint8), 64)
    frags = {}
    for tid in range(256):  # Int8TView::lane and load
        wg, wp, gid, t = thread_ids(tid)
        c = wg * 64 + 16 * wp + gid
        regs = []
        for h in range(4):
            o = c * 64 + ((h ^ ((c >> 1) & 3)) << 4) + 2 * t
            r = [u16(flat, o), u16(flat, o + 512), u16(flat, o + 8), u16(flat, o + 520)]
            a0, a1 = s8x4_bf16x2(byte_perm(r[0], r[1], 0x5410))
            a2, a3 = s8x4_bf16x2(byte_perm(r[2], r[3], 0x5410))
            regs.append((a0, a1, a2, a3))
        frags[tid] = (regs, c, c + 8)
    a, cols = assemble(frags)
    for h in range(4):
        for wg in range(2):
            assert np.array_equal(a[h, wg], w[cols[wg], 16 * h:16 * h + 16].astype(np.float32))


# ---------------------------------------------------------------------------
# The arithmetic against the JAX kernels
# ---------------------------------------------------------------------------

def wg_emulate(a, w_t, plan):
    """The mainloop's sums for activations a (M, C) and weights w_t (n_out,
    C), both as the kernel's fragments hold them: per contraction split of
    ``plan``, each 64-element stage's f32 partial (exact products, summed
    exactly, then rounded to f32) added to an f32 accumulator, one rounding
    each; the splits' accumulators added in split order."""
    M, C = a.shape
    _, nsplit, sps, _ = plan
    S = -(-C // QM.MMA_STEP)
    y = torch.zeros((M, w_t.shape[0]), dtype=torch.float32)
    for sp in range(nsplit):
        acc = torch.zeros_like(y)
        for s in range(sp * sps, min(S, (sp + 1) * sps)):
            c0, c1 = s * QM.MMA_STEP, min(C, (s + 1) * QM.MMA_STEP)
            acc = acc + (a[:, c0:c1].double() @ w_t[:, c0:c1].double().T).float()
        y = y + acc
    return y


def bf16_values(rng, shape):
    x = rng.standard_normal(shape).astype(np.float32)
    return np.array(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))


def rel(got, want):
    return np.abs(got.numpy() - want).max() / np.abs(want).max()


B6_EMULATED = [(65, 1024, 512), (130, 2048, 256), (200, 512, 1024), (17, 4096, 256),
               (72, 768, 384), (512, 256, 2048)]
T_EMULATED = [(65, 512, 2048), (130, 1024, 512), (200, 256, 1024), (17, 2048, 256),
              (512, 2048, 256)]


@pytest.mark.parametrize("M,K,N", B6_EMULATED)
def test_b6_arithmetic_matches_jax_kernel(M, K, N):
    # shapes the JAX grid kernel takes (not its jnp fallback)
    assert PM._largest_divisor(K, 256, 2048) or PM._largest_divisor(K, 32, 2048)
    assert PM._largest_divisor(N, 128, 2048)
    rng = np.random.default_rng(5 * M + K + N)
    w = rng.integers(-128, 128, (K, N)).astype(np.int8)
    scale = (0.5 + rng.random(N, dtype=np.float32)) * 0.01
    x = bf16_values(rng, (M, K))
    want = np.asarray(PM.int8_matmul_pallas(jnp.asarray(x), jnp.asarray(w), jnp.asarray(scale),
                                            scheme="convert", interpret=True))
    got = wg_emulate(torch.from_numpy(x), torch.from_numpy(w).T, QM.wg_plan(M, K, N))
    assert rel(got * torch.from_numpy(scale), want) <= 1e-5


@pytest.mark.parametrize("M,K,N", T_EMULATED)
def test_b14_arithmetic_matches_jax_kernel(M, K, N):
    assert PM._pick_int4_bk(K, 512) and PM._largest_divisor(N, 128, 2048)  # the grid kernel
    rng = np.random.default_rng(3 * M + K + N)
    packed = rng.integers(0, 256, (K // 2, N), dtype=np.uint8)
    scale = (rng.integers(1, 16, (K // 32, N)) / 64.0).astype(jnp.bfloat16)  # q·s exact in bf16
    g = bf16_values(rng, (M, N))
    want = np.asarray(PM.int4_matmul_t_pallas(jnp.asarray(g), jnp.asarray(packed),
                                              jnp.asarray(scale), interpret=True))
    s = torch.from_numpy(np.asarray(scale).astype(np.float32)).to(torch.bfloat16)
    w_hat = unpack_int4_tpu(torch.from_numpy(packed), s).to(torch.bfloat16).float()
    assert torch.equal(w_hat, unpack_int4_tpu(torch.from_numpy(packed), s))  # exact
    assert rel(wg_emulate(torch.from_numpy(g), w_hat, QM.t_mma_plan(M, K, N)), want) <= 1e-5


@pytest.mark.parametrize("M,K,N", T_EMULATED)
def test_b13_arithmetic_matches_jax_kernel(M, K, N):
    assert PM._largest_divisor(K, 128, 512) and PM._largest_divisor(N, 128, 2048)
    rng = np.random.default_rng(4 * M + K + N)
    w = rng.integers(-128, 128, (K, N)).astype(np.int8)
    scale = (2.0 ** rng.integers(-9, -4, N)).astype(np.float32)  # g·s exact in bf16
    g = bf16_values(rng, (M, N))
    want = np.asarray(PM.int8_matmul_t_pallas(jnp.asarray(g), jnp.asarray(w), jnp.asarray(scale),
                                              interpret=True))
    tg = torch.from_numpy(g).to(torch.bfloat16)
    gs = (tg * torch.from_numpy(scale).to(torch.bfloat16)).float()  # the fold, exact here
    assert torch.equal(gs, torch.from_numpy(g) * torch.from_numpy(scale))
    assert rel(wg_emulate(gs, torch.from_numpy(w).float(), QM.t_mma_plan(M, K, N)), want) <= 1e-5


def test_emulated_shapes_merge_splits():
    # the emulations above run the merge on some of their shapes, not all
    for plan, shapes in ((QM.wg_plan, B6_EMULATED), (QM.t_mma_plan, T_EMULATED)):
        splits = [plan(M, K, N)[1] for M, K, N in shapes]
        assert any(p > 1 for p in splits) and any(p == 1 for p in splits)

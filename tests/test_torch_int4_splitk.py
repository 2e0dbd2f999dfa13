"""B1's split-K tensor-core kernel (``int4g32_splitk``) on the CPU: what can
be checked without the card.

* The kernel's byte → bf16x2 conversion (common.cuh: ``int4_pair_bf16x2``)
  emulated bit for bit in torch over all 256 bytes at each byte position of
  a word, against ``unpack_int4_tpu_q``'s integers.
* ``splitk_plan`` at the ChatGLM2-6B linears: every K group in exactly one
  split, staging chunks the kernel accepts, shared memory and partials
  bounded.
* ``int4_route``, and the routing B6/B7/B8 share (``uses_mma``,
  ``gemv_plan``), unchanged.
* The kernel's arithmetic emulated in torch (exact-integer products, each
  group's f32 partial times its scale in f32, the warps' sums in warp
  order, the splits' in split order) against the JAX package's decode-M
  kernel, ``int4_matmul_pallas_pipelined(..., interpret=True)``, on the same
  numpy inputs: at 1e-5 of max|y| in f32 (the two sum in another order).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from chatglm_q_tpu.ops import pallas_matmul as PM  # noqa: E402
from chatglm_q_tpu_torch.ops import dyn_matmul as D  # noqa: E402
from chatglm_q_tpu_torch.ops import quant_matmul as QM  # noqa: E402
from chatglm_q_tpu_torch.ops.quant import unpack_int4_tpu_q  # noqa: E402

# (K, N) at storage sizes: q_proj, kv_proj, o_proj, w_in_h / w_in_gate,
# w_out, lm_head
LINEARS = [(4096, 4096), (4096, 512), (4096, 4096), (4096, 13824), (13824, 4096),
           (4096, 65536)]
PLAN_M = (1, 4, 16, 27, 32, 36, 56, 64)


def _bf16_from_bits(bits):
    """int32 tensor of 16-bit patterns → their bf16 values as f32."""
    return (bits.to(torch.int32) << 16).view(torch.float32)


def _pair_bf16x2(w, p):
    """int4_pair_bf16x2(w, w >> 4, p) on an int64 tensor of 32-bit words:
    (low half, high half) as f32."""
    sh = w >> 4

    def byte(v):
        return (v >> (8 * p)) & 0xFF

    # PRMT selector p | p << 4 | (4 + p) << 8 | (4 + p) << 12
    v = byte(w) | byte(w) << 8 | byte(sh) << 16 | byte(sh) << 24
    v = (v & 0x000F000F) ^ 0x43084308
    minus = _bf16_from_bits(torch.tensor([0xC308]))  # the FMA's addend, bf16 -136
    assert minus.item() == -136.0
    lo = _bf16_from_bits(v & 0xFFFF) + minus
    hi = _bf16_from_bits(v >> 16) + minus
    # fma.rn.bf16x2 rounds to bf16: the result must already be a bf16
    for h in (lo, hi):
        assert torch.equal(h.to(torch.bfloat16).float(), h)
    return lo, hi


@pytest.mark.parametrize("p", range(4))
def test_nibble_conversion_is_exact_for_every_byte(p):
    rng = np.random.default_rng(p)
    b = torch.arange(256, dtype=torch.int64)
    others = torch.from_numpy(rng.integers(0, 256, (3, 256)))
    pos = [i for i in range(4) if i != p]
    w = b << (8 * p)
    for row, i in zip(others, pos):
        w = w | row << (8 * i)  # neighbouring bytes must not leak in
    lo, hi = _pair_bf16x2(w, p)
    q = unpack_int4_tpu_q(b.to(torch.uint8)[None]).float()  # (2, 256): low, high nibble
    assert torch.equal(lo, q[0]) and torch.equal(hi, q[1])
    assert lo.min() == -8 and lo.max() == 7


@pytest.mark.parametrize("M", PLAN_M)
@pytest.mark.parametrize("K,N", LINEARS + [(320, 65536), (4096, 264), (64, 8)])
def test_splitk_plan_covers_every_group(M, K, N):
    mt, cols, nsplit, gps, cg = QM.splitk_plan(M, K, N)
    G = K // 32
    assert 8 * mt >= M > 8 * (mt - 1) - 8 * (mt == 8) and mt in (1, 2, 3, 4, 5, 6, 8)
    assert cols in (8, 16) and (cols == 8 or N % 16 == 0)
    covered = [g for s in range(nsplit) for g in range(s * gps, min(G, (s + 1) * gps))]
    assert covered == list(range(G))  # each group once, in order
    assert cg % 8 == 0 and cg >= 8  # each warp an even count of groups a chunk
    assert QM.splitk_smem(M, cg, cols) <= QM.SPLITK_SMEM_MAX
    tiles = -(-N // (8 * cols))
    part_bytes = 4 * tiles * nsplit * M * 8 * cols if nsplit > 1 else 0
    assert part_bytes <= QM.SPLITK_SMS * 4 * 16 * 128 * 4  # 4.3 MB
    if (K, N) in LINEARS:  # the grid fills the card where two groups a warp allow
        assert tiles * nsplit >= min(QM.SPLITK_SMS // 2, tiles * -(-G // (2 * QM.SPLITK_KW)))


def test_lm_head_takes_no_split_at_decode():
    for M in (1, 4):
        assert QM.splitk_plan(M, 4096, 65536)[2] == 1


def test_routing():
    bf16, f32 = torch.bfloat16, torch.float32
    for M in (1, 4, 16, 17, 27, QM.SMALL_M_MAX):
        assert QM.int4_route(M, 4096, bf16) == "splitk"
        assert QM.int4_route(M, 264, bf16) == "splitk"
        assert QM.int4_route(M, 4096, f32) == ("splitk" if M <= QM.F32_SPLITK_MAX else "mma")
    assert QM.SMALL_M_MAX <= 64  # the JAX decode-M kernel's own limit
    assert QM.int4_route(QM.SMALL_M_MAX + 1, 4096, bf16) == "mma"
    assert QM.int4_route(512, 4096, bf16) == "mma"
    assert QM.int4_route(512, 264, bf16) == "gemv"  # the tile kernel needs N % 16 == 0
    assert QM.int4_route(512, 4096, f32) == "mma"
    # B6/B7/B8 (and B13/B14) keep their switch at MMA_MIN_M and their plan
    assert QM.MMA_MIN_M == 16
    assert not QM.uses_mma(16, 4096, bf16) and QM.uses_mma(17, 4096, bf16)
    assert not QM.uses_mma(512, 4096, f32) and not QM.uses_mma(512, 264, bf16)
    assert not D.uses_mma(16, 4096) and D.uses_mma(17, 4096)
    assert [QM.gemv_plan(*s) for s in [(1, 4096, 4096), (4, 4096, 512), (1, 13824, 4096),
                                       (4, 4096, 65536), (16, 4096, 13824)]] == \
        [(32, 4), (32, 4), (62, 7), (5, 26), (10, 13)]


def splitk_emulate(x, packed, scale):
    """The split-K kernel's arithmetic in torch: per split, per warp (groups
    g0 + w, g0 + w + 4, ...), acc = fma(f32 group partial, f32 scale, acc);
    the warps' sums in warp order, then the splits' in split order."""
    M, K = x.shape
    N = packed.shape[1]
    _, _, nsplit, gps, _ = QM.splitk_plan(M, K, N)
    G = K // 32
    q = unpack_int4_tpu_q(packed).double()
    s = scale.double()
    xd = x.double()
    y = torch.zeros((M, N), dtype=torch.float32)
    for split in range(nsplit):
        g0, g1 = split * gps, min(G, (split + 1) * gps)
        block = None
        for w in range(QM.SPLITK_KW):
            acc = torch.zeros((M, N), dtype=torch.float32)
            for g in range(g0 + w, g1, QM.SPLITK_KW):
                part = (xd[:, 32 * g:32 * g + 32] @ q[32 * g:32 * g + 32]).float()  # exact
                acc = (acc.double() + part.double() * s[g]).float()  # fmaf: one rounding
            block = acc if block is None else block + acc
        y = y + block
    return y


@pytest.mark.parametrize("K,N", [(1024, 256), (2048, 32768)])
@pytest.mark.parametrize("M", (1, 4, 27))
def test_splitk_arithmetic_matches_jax_decode_kernel(M, K, N):
    rng = np.random.default_rng(1000 * M + K)
    packed = rng.integers(0, 256, (K // 2, N), dtype=np.uint8)
    scale = (rng.random((K // 32, N), dtype=np.float32) * 0.02).astype(jnp.bfloat16)
    x = rng.standard_normal((M, K)).astype(np.float32)
    x = np.array(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))  # bf16 values
    want = PM.int4_matmul_pallas_pipelined(jnp.asarray(x), jnp.asarray(packed),
                                           jnp.asarray(scale), interpret=True)
    assert want is not None
    want = np.asarray(want)
    got = splitk_emulate(torch.from_numpy(x), torch.from_numpy(packed),
                         torch.from_numpy(np.asarray(scale).astype(np.float32)).to(torch.bfloat16))
    nsplit = QM.splitk_plan(M, K, N)[2]
    assert nsplit > 1 or N == 32768  # the narrow shape merges splits
    err = np.abs(got.numpy() - want).max() / np.abs(want).max()
    assert err <= 1e-5, err

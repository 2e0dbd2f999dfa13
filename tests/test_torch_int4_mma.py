"""B1's Hopper tensor-core kernel (``int4g32_mma``: bf16 activations above
``SMALL_M_MAX`` rows) on the CPU: what can be checked without the card.

* ``mma_plan`` at the ChatGLM2-6B linears for prefill, engine-chunk and
  training M: the persistent blocks take every work unit once, every output
  tile gets every one of its K splits once, the splits cover every 32-row
  group once and start on a stage, the last row and column tiles overhang
  M and N by less than a tile (the kernel masks them), shared memory fits
  the H100's opt-in limit and the split partials stay bounded.
* ``int4_route`` unchanged: bf16 above SMALL_M_MAX with N % 16 == 0 takes
  the tensor-core kernel.
* The kernel's arithmetic emulated in torch (each 32-row group's f32
  partial of exact integer products, folded into the f32 accumulator times
  the group's scale with one rounding; the K splits' sums added in split
  order) against the JAX package's grid kernel in its exact "grouped"
  scheme, ``int4_matmul_pallas(..., scheme="grouped", interpret=True)``, on
  the same numpy inputs: at 1e-5 of max|y| in f32 (the two sum in another
  order).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from chatglm_q_tpu.ops import pallas_matmul as PM  # noqa: E402
from chatglm_q_tpu_torch.ops import quant_matmul as QM  # noqa: E402
from chatglm_q_tpu_torch.ops.quant import unpack_int4_tpu_q  # noqa: E402

# (name, K, N) at storage sizes
LINEARS = [("q_proj", 4096, 4096), ("kv_proj", 4096, 512), ("o_proj", 4096, 4096),
           ("w_in", 4096, 13824), ("w_out", 13824, 4096), ("lm_head", 4096, 65536)]
PLAN_M = (65, 128, 200, 512, 1024, 4096)


def units(M, K, N):
    """The kernel's work units in its order: unit u is m-tile u % mtiles,
    then K split, then column tile; (m-tile, column tile, split, g0, g1)."""
    bm, nsplit, gps, _ = QM.mma_plan(M, K, N)
    mtiles, ntiles, G = -(-M // bm), -(-N // QM.MMA_BN), K // 32
    out = []
    for u in range(mtiles * ntiles * nsplit):
        mt, rest = u % mtiles, u // mtiles
        sp, nt = rest % nsplit, rest // nsplit
        out.append((mt, nt, sp, sp * gps, min(G, (sp + 1) * gps)))
    return out


@pytest.mark.parametrize("M", PLAN_M)
@pytest.mark.parametrize("name,K,N", LINEARS + [("ragged", 320, 272)])
def test_mma_plan_covers_every_tile_and_group(M, name, K, N):
    bm, nsplit, gps, ctas = QM.mma_plan(M, K, N)
    G = K // 32
    mtiles, ntiles = -(-M // bm), -(-N // QM.MMA_BN)
    work = units(M, K, N)
    assert bm in (64, 128) and 1 <= ctas <= min(QM.SPLITK_SMS, len(work))
    # the persistent blocks (b, b + ctas, ...) take every unit once
    taken = sorted(u for b in range(ctas) for u in range(b, len(work), ctas))
    assert taken == list(range(len(work)))
    # every tile once with each of its splits once, the splits covering
    # each group once, in order, none empty, each starting on a stage
    by_tile = {}
    for mt, nt, sp, g0, g1 in work:
        by_tile.setdefault((mt, nt), []).append((sp, g0, g1))
    assert sorted(by_tile) == [(m, n) for m in range(mtiles) for n in range(ntiles)]
    for splits in by_tile.values():
        assert [s for s, _, _ in splits] == list(range(nsplit))
        assert [g for _, g0, g1 in splits for g in range(g0, g1)] == list(range(G))
        assert all(g1 > g0 for _, g0, g1 in splits)
        assert nsplit == 1 or all(g0 % QM.MMA_STAGE_GROUPS == 0 for _, g0, _ in splits)
    # the last tiles overhang M and N by less than a tile: masked stores
    assert mtiles * bm >= M > (mtiles - 1) * bm
    assert ntiles * QM.MMA_BN >= N > (ntiles - 1) * QM.MMA_BN
    assert QM.mma_smem(bm) <= QM.MMA_SMEM_MAX
    # the split partials (f32, tiles x splits x bm x 128) stay within two
    # waves of units
    if nsplit > 1:
        assert len(work) <= 2 * QM.SPLITK_SMS
        assert 4 * len(work) * bm * QM.MMA_BN <= 2 * QM.SPLITK_SMS * 4 * 128 * 128


def test_mma_smem_mirrors_the_kernel_layout():
    # per stage x's bm x 64 bf16, 32 x 128 packed bytes, 2 x 128 bf16 scales;
    # two barriers a stage, two merge flags, 1024 bytes of alignment slack
    for bm in (64, 128):
        stage = bm * 64 * 2 + 32 * 128 + 2 * 128 * 2
        assert QM.mma_smem(bm) == QM.MMA_STAGES * stage + 16 * QM.MMA_STAGES + 16 + 1024
    assert QM.MMA_STAGES >= 3


@pytest.mark.parametrize("M", (128, 512, 1024))
@pytest.mark.parametrize("name,K,N", LINEARS)
def test_mma_plan_fills_the_card_on_the_main_path(M, name, K, N):
    """At prefill and training M a linear runs whole K only where its tiles
    alone keep half the SMs busy; a narrow N (kv_proj) or a small M is
    split over K into more work units than there were tiles."""
    bm, nsplit, gps, ctas = QM.mma_plan(M, K, N)
    tiles = -(-M // bm) * -(-N // QM.MMA_BN)
    assert nsplit > 1 or tiles >= QM.SPLITK_SMS // 2
    if name == "kv_proj":
        assert nsplit > 1 and ctas >= 32


def test_routing_is_unchanged():
    bf16, f32 = torch.bfloat16, torch.float32
    assert QM.SMALL_M_MAX == 64
    for M in (QM.SMALL_M_MAX + 1, 128, 512, 1024, 4096):
        assert QM.int4_route(M, 4096, bf16) == "mma"
        assert QM.int4_route(M, 512, bf16) == "mma"
        assert QM.int4_route(M, 264, bf16) == "gemv"  # the tile kernel needs N % 16 == 0
        assert QM.int4_route(M, 4096, f32) == "mma"
    assert QM.int4_route(QM.SMALL_M_MAX, 4096, bf16) == "splitk"


def mma_emulate(x, packed, scale):
    """The Hopper kernel's arithmetic in torch: per K split, acc = fma(f32
    group partial, f32 scale, acc) over its groups in order (the partial
    exact in double, then rounded to f32; fmaf: one rounding); the splits'
    accumulators added in split order."""
    M, K = x.shape
    N = packed.shape[1]
    _, nsplit, gps, _ = QM.mma_plan(M, K, N)
    G = K // 32
    q = unpack_int4_tpu_q(packed).double()
    s = scale.double()
    xd = x.double()
    y = torch.zeros((M, N), dtype=torch.float32)
    for sp in range(nsplit):
        acc = torch.zeros((M, N), dtype=torch.float32)
        for g in range(sp * gps, min(G, (sp + 1) * gps)):
            part = (xd[:, 32 * g:32 * g + 32] @ q[32 * g:32 * g + 32]).float()
            acc = (acc.double() + part.double() * s[g]).float()
        y = y + acc
    return y


@pytest.mark.parametrize("M,K,N", [(65, 2048, 256), (128, 1024, 512), (200, 4096, 256),
                                   (130, 1024, 1024), (72, 768, 384)])
def test_mma_arithmetic_matches_jax_grouped_kernel(M, K, N):
    # shapes the JAX grid kernel takes (not its jnp fallback)
    assert PM._pick_int4_bk(K, 2048) and PM._largest_divisor(N, 128, 2048)
    rng = np.random.default_rng(7 * M + K + N)
    packed = rng.integers(0, 256, (K // 2, N), dtype=np.uint8)
    scale = (rng.random((K // 32, N), dtype=np.float32) * 0.02).astype(jnp.bfloat16)
    x = rng.standard_normal((M, K)).astype(np.float32)
    x = np.array(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))  # bf16 values
    want = np.asarray(PM.int4_matmul_pallas(jnp.asarray(x), jnp.asarray(packed),
                                            jnp.asarray(scale), scheme="grouped",
                                            interpret=True))
    got = mma_emulate(torch.from_numpy(x), torch.from_numpy(packed),
                      torch.from_numpy(np.asarray(scale).astype(np.float32)).to(torch.bfloat16))
    err = np.abs(got.numpy() - want).max() / np.abs(want).max()
    assert err <= 1e-5, err


def test_emulated_shapes_merge_splits():
    # the emulation above runs the merge on some of its shapes
    assert any(QM.mma_plan(M, K, N)[1] > 1
               for M, K, N in [(65, 2048, 256), (128, 1024, 512), (200, 4096, 256)])

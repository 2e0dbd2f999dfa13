"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: without a GPU every test here skips (decided inside the
fixture, never at import).  On a machine with one:

    python -m pytest tests/test_torch_cuda.py -q

Shapes cover the edges the main path does not: odd M, N not a multiple of
the tile, f32 activations for the matmuls, fewer heads per group, the M
where a matmul switches from its split-K kernel to its tensor-core kernel,
and an all-zero activation row (the 1e-10 clamp of the dynamic scale).
B7 (``int8_dyn_matmul``) is held bit-exact: its int32 sums are exact.  The
attention kernels and the KV write take bf16 only.  The tolerance is the
bf16 one of chip_smoke.py (1e-2 of max|plain|; f32 1e-5): kernels and plain
versions sum the same exact products in another order.
"""
import math

import pytest

torch = pytest.importorskip("torch")

from chatglm_q_tpu_torch.ops import attention as A  # noqa: E402
from chatglm_q_tpu_torch.ops import dyn_matmul as D  # noqa: E402
from chatglm_q_tpu_torch.ops import int8_matmul as I8  # noqa: E402
from chatglm_q_tpu_torch.ops import quant_matmul as QM  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.Generator(device="cuda").manual_seed(0)


def _rel(a, b):
    return ((a.float() - b.float()).abs().max() / b.float().abs().max().clamp_min(1e-30)).item()


def _tol(dtype):
    return 1e-2 if dtype == torch.bfloat16 else 1e-5


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("M,K,N", [(1, 64, 8), (3, 4096, 264), (17, 1024, 272),
                                   (70, 13824, 512), (5, 320, 65536)])
def test_int4g32_matmul_matches_plain(gen, dtype, M, K, N):
    packed = torch.randint(0, 256, (K // 2, N), dtype=torch.uint8, device="cuda", generator=gen)
    scale = (torch.rand((K // 32, N), device="cuda", generator=gen) * 0.02).to(torch.bfloat16)
    x = torch.randn((M, K), device="cuda", generator=gen).to(dtype)
    got = QM.int4g32_matmul(x, packed, scale)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (M, N)
    assert _rel(got, QM.int4g32_matmul_plain(x, packed, scale)) <= _tol(dtype)


def test_int4g32_matmul_reads_a_layer_view(gen):
    stack = torch.randint(0, 256, (3, 512, 4096), dtype=torch.uint8, device="cuda", generator=gen)
    scales = (torch.rand((3, 32, 4096), device="cuda", generator=gen) * 0.02).to(torch.bfloat16)
    x = torch.randn((1, 1024), device="cuda", generator=gen).to(torch.bfloat16)
    got = QM.int4g32_matmul(x, stack[2], scales[2])
    assert _rel(got, QM.int4g32_matmul_plain(x, stack[2].clone(), scales[2].clone())) <= 1e-2


def test_int4g32_matmul_rejects_what_it_cannot_take(gen):
    x = torch.randn((2, 64), device="cuda", generator=gen)
    packed = torch.zeros((32, 12), dtype=torch.uint8, device="cuda")  # N % 8 != 0
    with pytest.raises(ValueError):
        QM.int4g32_matmul(x, packed, torch.ones((2, 12), dtype=torch.bfloat16, device="cuda"))
    packed = torch.zeros((32, 16), dtype=torch.uint8, device="cuda")
    with pytest.raises(TypeError):
        QM.int4g32_matmul(x, packed, torch.ones((2, 16), dtype=torch.float32, device="cuda"))


@pytest.mark.parametrize("Hg", [16, 4])
def test_decode_attention_matches_plain(gen, Hg):
    dtype = torch.bfloat16
    B, G, D, T = 3, 2, 128, 200
    q = torch.randn((B, G, Hg, D), device="cuda", generator=gen).to(dtype)
    k = torch.randn((B, G, T, D), device="cuda", generator=gen).to(dtype)
    v = torch.randn((B, G, T, D), device="cuda", generator=gen).to(dtype)
    lengths = torch.tensor([0, 31, T - 1], dtype=torch.int32, device="cuda")
    sm = 1 / math.sqrt(D)
    got = A.flash_attention_decode(q, k, v, lengths, sm)
    torch.cuda.synchronize()
    assert _rel(got, A.flash_attention_decode_plain(q, k, v, lengths, sm)) <= 1e-2


@pytest.mark.parametrize("Hg", [16, 4])
def test_prefill_attention_matches_plain(gen, Hg):
    dtype = torch.bfloat16
    B, S, G, D, T = 3, 37, 2, 128, 64
    q = torch.randn((B, S, G, Hg, D), device="cuda", generator=gen).to(dtype)
    k = torch.randn((B, G, T, D), device="cuda", generator=gen).to(dtype)
    v = torch.randn((B, G, T, D), device="cuda", generator=gen).to(dtype)
    lengths = torch.tensor([37, 0, 12], dtype=torch.int32, device="cuda")
    sm = 1 / math.sqrt(D)
    got = A.flash_attention_prefill(q, k, v, lengths, sm)
    torch.cuda.synchronize()
    assert not got[1].any()
    assert _rel(got, A.flash_attention_prefill_plain(q, k, v, lengths, sm)) <= 1e-2


def test_kv_write_matches_plain(gen):
    cache = torch.randn((4, 3, 2, 50, 128), device="cuda", generator=gen).to(torch.bfloat16)
    ref = cache.clone()
    new = torch.randn((3, 2, 128), device="cuda", generator=gen)  # cast on the way in
    starts = torch.tensor([0, 49, 7], dtype=torch.int32, device="cuda")
    A.kv_cache_write_idx(cache, new, 2, starts)
    A.kv_cache_write_idx_plain(ref, new, 2, starts)
    torch.cuda.synchronize()
    assert torch.equal(cache, ref)


def test_attention_kernels_take_bf16_only(gen):
    q = torch.randn((1, 2, 16, 128), device="cuda", generator=gen)
    k = torch.randn((1, 2, 8, 128), device="cuda", generator=gen)
    lengths = torch.zeros((1,), dtype=torch.int32, device="cuda")
    with pytest.raises(TypeError):
        A.flash_attention_decode(q, k, k, lengths, 0.1)
    with pytest.raises(TypeError):
        A.flash_attention_prefill(q[:, None], k, k, lengths, 0.1)
    with pytest.raises(TypeError):
        A.kv_cache_write_idx(k[None], q[:, :, 0], 0, lengths)


# M across the split-K / tensor-core switch (16 | 17) and the int4-dyn
# ceiling (64); K = 13824 (w_out's storage K), N = 512 (kv_proj)
MATMUL_EDGES = [(1, 13824, 512), (3, 13824, 512), (16, 13824, 512), (17, 13824, 512),
                (64, 13824, 512), (5, 4096, 65536), (130, 4096, 4224)]


def _x(gen, M, K, dtype):
    x = torch.randn((M, K), device="cuda", generator=gen).to(dtype)
    x[M // 2] = 0  # a zero row: sx takes the 1e-10 clamp, xq is all 0
    return x


def _int8_weights(gen, K, N):
    w = torch.randint(-128, 128, (K, N), dtype=torch.int8, device="cuda", generator=gen)
    scale = torch.rand((N,), device="cuda", generator=gen) * 0.02 + 0.005
    return w, scale


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("M,K,N", MATMUL_EDGES)
def test_int8_matmul_matches_plain(gen, dtype, M, K, N):
    w, scale = _int8_weights(gen, K, N)
    x = _x(gen, M, K, dtype)
    got = I8.int8_matmul(x, w, scale)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (M, N)
    assert _rel(got, I8.int8_matmul_plain(x, w, scale)) <= _tol(dtype)
    assert not got[M // 2].any()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("M,K,N", MATMUL_EDGES)
def test_int8_dyn_matmul_is_bit_exact(gen, dtype, M, K, N):
    w, scale = _int8_weights(gen, K, N)
    x = _x(gen, M, K, dtype)
    got = D.int8_dyn_matmul(x, w, scale)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (M, N)
    want = D.int8_dyn_matmul_plain(x, w, scale)
    assert torch.equal(got, want), _rel(got, want)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("M,K,N", MATMUL_EDGES)
def test_int4_dyn_matmul_matches_plain(gen, dtype, M, K, N):
    packed = torch.randint(0, 256, (K // 2, N), dtype=torch.uint8, device="cuda", generator=gen)
    scale = (torch.rand((K // 32, N), device="cuda", generator=gen) * 0.02).to(torch.bfloat16)
    x = _x(gen, M, K, dtype)
    got = D.int4_dyn_matmul(x, packed, scale)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (M, N)
    assert _rel(got, D.int4_dyn_matmul_plain(x, packed, scale)) <= _tol(dtype)
    assert not got[M // 2].any()


def test_int8_kernels_read_a_layer_view(gen):
    stack = torch.randint(-128, 128, (3, 1024, 4096), dtype=torch.int8, device="cuda",
                          generator=gen)
    scales = torch.rand((3, 4096), device="cuda", generator=gen) * 0.02
    for M in (1, 40):
        x = torch.randn((M, 1024), device="cuda", generator=gen).to(torch.bfloat16)
        got = I8.int8_matmul(x, stack[2], scales[2])
        assert _rel(got, I8.int8_matmul_plain(x, stack[2].clone(), scales[2].clone())) <= 1e-2
        got = D.int8_dyn_matmul(x, stack[1], scales[1])
        assert torch.equal(got, D.int8_dyn_matmul_plain(x, stack[1].clone(), scales[1].clone()))


def test_int8_kernels_reject_what_they_cannot_take(gen):
    x = torch.randn((2, 64), device="cuda", generator=gen)
    w = torch.zeros((64, 12), dtype=torch.int8, device="cuda")  # N % 8 != 0
    with pytest.raises(ValueError):
        I8.int8_matmul(x, w, torch.ones((12,), device="cuda"))
    with pytest.raises(ValueError):
        D.int8_dyn_matmul(x, w, torch.ones((12,), device="cuda"))
    w = torch.zeros((64, 16), dtype=torch.int8, device="cuda")
    with pytest.raises(TypeError):
        I8.int8_matmul(x, w, torch.ones((16,), dtype=torch.bfloat16, device="cuda"))
    with pytest.raises(ValueError):  # B8 takes bf16 group scales only
        D.int4_dyn_matmul(x, torch.zeros((32, 16), dtype=torch.uint8, device="cuda"),
                          torch.ones((2, 16), device="cuda"))

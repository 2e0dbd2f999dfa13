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

from chatglm_q_tpu_torch.ops import _build  # noqa: E402
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


# chip_smoke.py's limits on the error beyond the output's bf16 rounding of
# the kernels that keep p in f32 through PV
B12_TOL = 1e-5
B10_TOL = 7.5e-6
B11_TOL = 1.5e-5


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


def _int4_weights(gen, K, N, layers=None):
    lead = () if layers is None else (layers,)
    packed = torch.randint(0, 256, lead + (K // 2, N), dtype=torch.uint8, device="cuda",
                           generator=gen)
    scale = (torch.rand(lead + (K // 32, N), device="cuda", generator=gen) * 0.02
             ).to(torch.bfloat16)
    return packed, scale


# B1's split-K tensor-core kernel: every m-tile count (1-6 and 8 tiles of 8
# rows) and its edges, the verify step's 27 and 36, N = 264 / 272 (8 columns
# a lane, or a 16-column tile past N), K = 13824 (w_out), the lm_head's N
SPLITK_M = (1, 2, 3, 4, 5, 8, 16, 17, 27, 32, 33, 36, 48, 56, 64)
SPLITK_SHAPES = [(4096, 264), (1024, 272), (13824, 512), (4096, 4096), (320, 65536)]


@pytest.mark.parametrize("K,N", SPLITK_SHAPES)
@pytest.mark.parametrize("M", SPLITK_M)
def test_int4g32_splitk_matches_plain(gen, M, K, N):
    packed, scale = _int4_weights(gen, K, N)
    x = torch.randn((M, K), device="cuda", generator=gen).to(torch.bfloat16)
    assert QM.int4_route(M, N, torch.bfloat16) == "splitk"
    before = QM.int4g32_splitk.launches, QM.int4g32_gemv.launches, QM.int4g32_mma.launches
    got = QM.int4g32_matmul(x, packed, scale)
    torch.cuda.synchronize()
    after = QM.int4g32_splitk.launches, QM.int4g32_gemv.launches, QM.int4g32_mma.launches
    assert [a - b for a, b in zip(after, before)] == [1, 0, 0]  # one launch, no second pass
    assert got.dtype == torch.bfloat16 and got.shape == (M, N)
    assert _rel(got, QM.int4g32_matmul_plain(x, packed, scale)) <= 1e-2


@pytest.mark.parametrize("K,N", SPLITK_SHAPES)
@pytest.mark.parametrize("M", (1, 2, 3, 4, 9, 20, 27, 36, 48, 64))
def test_int4g32_splitk_error_is_its_bf16_rounding(gen, M, K, N):
    """Every output is the exact result rounded to bf16, give or take the
    f32 sums: beyond half a bf16 ulp, its error is within one f32 epsilon
    (2^-23) of sum|x·w| over its K terms (on an H100 the kernel read at
    most 4.5e-9 of it, the plain f32 product 1.7e-8).  A wrong group,
    scale, nibble, row or split is off by ~1/K of sum|x·w| or more, which
    the 1e-2 · max|y| limit above would let through.  (Measured in ulps of
    the output instead, every path, the plain one too, fails where an
    output cancels to ~1e-6 of its terms.)"""
    packed, scale = _int4_weights(gen, K, N)
    x = torch.randn((M, K), device="cuda", generator=gen).to(torch.bfloat16)
    got = QM.int4g32_matmul(x, packed, scale).double()
    w = QM.unpack_int4_tpu(packed, scale).double()
    want = x.double() @ w
    terms = x.double().abs() @ w.abs()
    half_ulp = torch.ldexp(torch.ones_like(want), torch.frexp(want)[1] - 9)  # bf16: 8 bits
    beyond = ((got - want).abs() - half_ulp).clamp_min(0) / terms
    assert beyond.max().item() <= 2.0 ** -23, beyond.max().item()


@pytest.mark.parametrize("M", (1, 4, 27))
def test_int4g32_splitk_reads_a_layer_view(gen, M):
    stack, scales = _int4_weights(gen, 4096, 4096, layers=3)
    x = torch.randn((M, 4096), device="cuda", generator=gen).to(torch.bfloat16)
    got = QM.int4g32_matmul(x, stack[2], scales[2])
    assert _rel(got, QM.int4g32_matmul_plain(x, stack[2].clone(), scales[2].clone())) <= 1e-2


@pytest.mark.parametrize("M,K,N", [(1, 4096, 512), (4, 13824, 4096), (27, 4096, 13824),
                                   (64, 4096, 264)])
def test_int4g32_splitk_is_deterministic_and_replays_in_a_graph(gen, M, K, N):
    """Two calls are bit-equal and leave every arrival counter at 0 (the
    merging block resets its own); one call captured in a CUDA graph and
    replayed twice is bit-equal to the eager call."""
    packed, scale = _int4_weights(gen, K, N)
    x = torch.randn((M, K), device="cuda", generator=gen).to(torch.bfloat16)
    first = QM.int4g32_matmul(x, packed, scale)
    second = QM.int4g32_matmul(x, packed, scale)
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    _, cols, _, _, _ = QM.splitk_plan(M, K, N)
    tiles = -(-N // (8 * cols))
    assert not _build.scratch("splitk_arrivals", x.device, tiles, torch.int32)[:tiles].any()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        QM.int4g32_matmul(x, packed, scale)  # warm-up on the capture stream
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = QM.int4g32_matmul(x, packed, scale)
    for _ in range(2):
        captured.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(captured, first)


# B1's Hopper kernel (bf16 above SMALL_M_MAX): prefill, engine-chunk and
# training M on kv_proj (K splits), q_proj and w_out shapes, and a ragged M
# and N (the last row and column tiles masked)
MMA_CASES = [(M, K, N) for M in (65, 128, 512, 1024)
             for K, N in ((4096, 512), (4096, 4096), (13824, 4096))] + [(200, 1024, 272)]


def _b1_launches():
    return QM.int4g32_splitk.launches, QM.int4g32_gemv.launches, QM.int4g32_mma.launches


@pytest.mark.parametrize("M,K,N", MMA_CASES)
def test_int4g32_mma_error_is_its_bf16_rounding(gen, M, K, N):
    """The split-K kernel's bound, on the Hopper kernel: one launch, and
    every output within 2^-23 of sum|x·w| of its exact value beyond half a
    bf16 ulp (see test_int4g32_splitk_error_is_its_bf16_rounding)."""
    packed, scale = _int4_weights(gen, K, N)
    x = torch.randn((M, K), device="cuda", generator=gen).to(torch.bfloat16)
    assert QM.int4_route(M, N, torch.bfloat16) == "mma"
    before = _b1_launches()
    got = QM.int4g32_matmul(x, packed, scale)
    torch.cuda.synchronize()
    assert [a - b for a, b in zip(_b1_launches(), before)] == [0, 0, 1]
    assert got.dtype == torch.bfloat16 and got.shape == (M, N)
    got = got.double()
    w = QM.unpack_int4_tpu(packed, scale).double()
    want = x.double() @ w
    terms = x.double().abs() @ w.abs()
    half_ulp = torch.ldexp(torch.ones_like(want), torch.frexp(want)[1] - 9)  # bf16: 8 bits
    beyond = ((got - want).abs() - half_ulp).clamp_min(0) / terms
    assert beyond.max().item() <= 2.0 ** -23, beyond.max().item()


def test_int4g32_mma_reads_a_layer_view(gen):
    stack, scales = _int4_weights(gen, 4096, 4096, layers=3)
    x = torch.randn((130, 4096), device="cuda", generator=gen).to(torch.bfloat16)
    got = QM.int4g32_matmul(x, stack[2], scales[2])
    assert _rel(got, QM.int4g32_matmul_plain(x, stack[2].clone(), scales[2].clone())) <= 1e-2


@pytest.mark.parametrize("M,K,N", [(512, 4096, 512), (512, 4096, 4096), (65, 13824, 512),
                                   (130, 1024, 272)])
def test_int4g32_mma_is_deterministic_and_replays_in_a_graph(gen, M, K, N):
    """Two calls are bit-equal and leave every arrival counter at 0 (the
    merging warpgroup resets its own); one call captured in a CUDA graph
    and replayed twice is bit-equal to the eager call."""
    packed, scale = _int4_weights(gen, K, N)
    x = torch.randn((M, K), device="cuda", generator=gen).to(torch.bfloat16)
    first = QM.int4g32_matmul(x, packed, scale)
    second = QM.int4g32_matmul(x, packed, scale)
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    bm = QM.mma_plan(M, K, N)[0]
    tiles = -(-M // bm) * -(-N // QM.MMA_BN)
    assert not _build.scratch("mma_arrivals", x.device, 2 * tiles, torch.int32)[:2 * tiles].any()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        QM.int4g32_matmul(x, packed, scale)  # warm-up on the capture stream
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = QM.int4g32_matmul(x, packed, scale)
    for _ in range(2):
        captured.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(captured, first)


def test_int4g32_mma_rejects_a_plan_it_cannot_take(gen):
    packed, scale = _int4_weights(gen, 1024, 512)  # 32 groups
    x = torch.randn((100, 1024), device="cuda", generator=gen).to(torch.bfloat16)
    y = torch.empty((100, 512), dtype=torch.bfloat16, device="cuda")
    ws = torch.empty((1 << 20,), dtype=torch.float32, device="cuda")
    arrivals = torch.zeros((64,), dtype=torch.int32, device="cuda")
    for bm, nsplit, gps in ((128, 2, 8), (128, 4, 16), (96, 1, 32)):  # groups uncovered,
        with pytest.raises(RuntimeError):                            # an empty split, no tile
            _build.call("chatglm_int4_wgmma", x.data_ptr(), packed.data_ptr(), scale.data_ptr(),
                        y.data_ptr(), ws.data_ptr(), arrivals.data_ptr(), 100, 1024, 512, bm,
                        nsplit, gps, 8, _build.stream_ptr(x))


def test_int4g32_routes_by_m_and_dtype(gen):
    packed, scale = _int4_weights(gen, 1024, 512)
    cases = [(QM.SMALL_M_MAX, torch.bfloat16, QM.int4g32_splitk),
             (QM.SMALL_M_MAX + 1, torch.bfloat16, QM.int4g32_mma),
             (1, torch.float32, QM.int4g32_gemv)]
    for M, dtype, fn in cases:
        x = torch.randn((M, 1024), device="cuda", generator=gen).to(dtype)
        before = fn.launches
        got = QM.int4g32_matmul(x, packed, scale)
        assert fn.launches == before + 1
        assert _rel(got, QM.int4g32_matmul_plain(x, packed, scale)) <= _tol(dtype)


def test_int4g32_splitk_rejects_what_it_cannot_take(gen):
    packed, scale = _int4_weights(gen, 64, 16)
    x = torch.randn((2, 64), device="cuda", generator=gen).to(torch.bfloat16)
    with pytest.raises(TypeError):  # int activations
        QM.int4g32_matmul(x.to(torch.int32), packed, scale)
    with pytest.raises(ValueError):  # K of x and of the weights differ
        QM.int4g32_matmul(x[:, :32], packed, scale)
    with pytest.raises(ValueError):  # weights on the CPU
        QM.int4g32_matmul(x, packed.cpu(), scale.cpu())
    with pytest.raises(ValueError):  # past SMALL_M_MAX the plan has no tile
        QM.splitk_plan(QM.SMALL_M_MAX + 1, 64, 16)
    x9 = torch.zeros((9, 64), dtype=torch.bfloat16, device="cuda")
    y9 = torch.empty((9, 16), dtype=torch.bfloat16, device="cuda")
    arrivals = torch.zeros((16,), dtype=torch.int32, device="cuda")
    with pytest.raises(RuntimeError):  # a plan the kernel refuses: M over mt's rows
        _build.call("chatglm_int4_splitk_mma", x9.data_ptr(), packed.data_ptr(),
                    scale.data_ptr(), y9.data_ptr(), None, arrivals.data_ptr(),
                    9, 64, 16, 1, 16, 1, 2, 8, _build.stream_ptr(x9))


def _decode_edges(B, T, span, past_end=False):
    """Lengths −1 (outputs 0), 0, span − 1, span, span + 1 and T − 1 (and
    T + 5 with ``past_end``), then the kernel's one-span bound less 1 and
    the bound (the last one-span row and the first merged across blocks),
    for the first rows; the rest spread over T."""
    edges = [-1, 0, span - 1, span, span + 1, T - 1] + ([T + 5] if past_end else [])
    edges += [A.DECODE_SOLO_ROWS - 1, A.DECODE_SOLO_ROWS]
    rest = [(37 * i) % T for i in range(B - len(edges))]
    return torch.tensor((edges + rest)[:B], dtype=torch.int32, device="cuda")


def _decode_inputs(gen, B, G, Hg, T, D=128):
    q = torch.randn((B, G, Hg, D), device="cuda", generator=gen).to(torch.bfloat16)
    k = torch.randn((B, G, T, D), device="cuda", generator=gen).to(torch.bfloat16)
    v = torch.randn((B, G, T, D), device="cuda", generator=gen).to(torch.bfloat16)
    return q, k, v


# (B, T): T = 200 (no multiple of the tile; every row one span, no
# partials), spans of 128 rows at T = 1000 (a 257-row row merged from three
# blocks), and a grid of B*G = 132 (b, g) where spans stay 512 rows (8 tiles)
@pytest.mark.parametrize("B,T", [(6, 200), (10, 1000), (66, 1000)])
@pytest.mark.parametrize("Hg", [16, 4])
def test_decode_attention_matches_plain(gen, Hg, B, T):
    G, D = 2, 128
    q, k, v = _decode_inputs(gen, B, G, Hg, T)
    lengths = _decode_edges(B, T, A.decode_span(B * G, T, A.DECODE_BLOCK_K))
    sm = 1 / math.sqrt(D)
    got = A.flash_attention_decode(q, k, v, lengths, sm)
    torch.cuda.synchronize()
    assert torch.isfinite(got.float()).all() and not got[0].float().any()
    assert _rel(got, A.flash_attention_decode_plain(q, k, v, lengths, sm)) <= 1e-2


@pytest.mark.parametrize("v2", [False, True])
def test_decode_attention_is_deterministic_in_one_launch(gen, v2):
    """Two calls on the same inputs are bit-equal (the fused span merge runs
    in span order and resets its counters), and one call is one kernel."""
    from torch.profiler import ProfilerActivity, profile

    B, G, Hg, T = 4, 2, 16, 1024
    q, k, v = _decode_inputs(gen, B, G, Hg, T)
    lengths = torch.tensor([1000, 600, 200, 0], dtype=torch.int32, device="cuda")
    fn = A.flash_attention_decode_v2 if v2 else A.flash_attention_decode
    first = fn(q, k, v, lengths, 0.088)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        again = fn(q, k, v, lengths, 0.088)
        torch.cuda.synchronize()
    assert torch.equal(first, again)
    kernels = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(kernels) == 1 and "decode_attn_kernel" in kernels[0], kernels


@pytest.mark.parametrize("S", [37, 130])
@pytest.mark.parametrize("Hg", [16, 4, 64])
def test_prefill_attention_matches_plain(gen, Hg, S):
    """S no multiple of the 64-row tile, a length-0 row, a short row."""
    dtype = torch.bfloat16
    B, G, D, T = 3, 2, 128, 192
    q = torch.randn((B, S, G, Hg, D), device="cuda", generator=gen).to(dtype)
    k = torch.randn((B, G, T, D), device="cuda", generator=gen).to(dtype)
    v = torch.randn((B, G, T, D), device="cuda", generator=gen).to(dtype)
    lengths = torch.tensor([S, 0, 12], dtype=torch.int32, device="cuda")
    sm = 1 / math.sqrt(D)
    got = A.flash_attention_prefill(q, k, v, lengths, sm)
    torch.cuda.synchronize()
    assert torch.isfinite(got.float()).all() and not got[1].any()
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


def test_kv_write_clamps_at_the_wall(gen):
    """starts == T and past it land on slot T - 1, as JAX's write clamps."""
    L, B, G, T, D = 2, 2, 2, 16, 128
    cache = torch.randn((L, B, G, T, D), device="cuda", generator=gen).to(torch.bfloat16)
    ref = cache.clone()
    new = torch.randn((B, G, D), device="cuda", generator=gen).to(torch.bfloat16)
    starts = torch.tensor([T, T + 5], dtype=torch.int32, device="cuda")
    A.kv_cache_write_idx(cache, new, 1, starts)
    A.kv_cache_write_idx_plain(ref, new, 1, starts)
    torch.cuda.synchronize()
    assert torch.equal(cache, ref) and torch.equal(cache[1, :, :, T - 1], new)


def _paged_pool(gen, L, NP, G, P, D=128):
    shape = (L, NP, G, P, D)
    return (torch.randn(shape, device="cuda", generator=gen).to(torch.bfloat16),
            torch.randn(shape, device="cuda", generator=gen).to(torch.bfloat16))


def _scattered_table(gen, B, MP, NP):
    """Distinct pages per row, page 0 (garbage) never used."""
    perm = torch.randperm(NP - 1, device="cuda", generator=gen)[: B * MP] + 1
    return perm.reshape(B, MP).to(torch.int32)


@pytest.mark.parametrize("P", [16, 256])
def test_pool_write_matches_plain(gen, P):
    L, G, D, MP = 3, 2, 128, 4
    B, NP = 4, 4 * MP + 1
    pool, _ = _paged_pool(gen, L, NP, G, P)
    ref = pool.clone()
    pt = _scattered_table(gen, B, MP, NP)
    new = torch.randn((B, G, D), device="cuda", generator=gen).to(torch.bfloat16)
    starts = torch.tensor([0, P + 3, MP * P - 1, MP * P + 40], dtype=torch.int32, device="cuda")
    A.kv_pool_write_idx(pool, new, 2, pt, starts)
    A.kv_pool_write_idx_plain(ref, new, 2, pt, starts)
    torch.cuda.synchronize()
    assert torch.equal(pool, ref)


def _rope_case(gen, B, paged, P=256, T=1024, L=3):
    """The decode step's inputs at 6B's heads (G = 2, Hg = 16, D = 128): q,
    the kv row as a view with a row stride (kv_proj's output row of a wider
    buffer), the freqs rows of positions 5 .. 2048, and a cache (L, B, G, T,
    D) or a pool (L, NP, G, P, D) of 4 pages a row with its table."""
    G, Hg, D = 2, 16, 128
    q = torch.randn((B, G, Hg, D), device="cuda", generator=gen).to(torch.bfloat16)
    wide = torch.randn((B, 2 * G * D + 64), device="cuda", generator=gen).to(torch.bfloat16)
    kv = wide[:, : 2 * G * D]
    pos = torch.tensor([5, 700, 1500, 2048][:B], device="cuda")
    from chatglm_q_tpu_torch.models.chatglm2 import precompute_freqs_cis

    table = torch.from_numpy(precompute_freqs_cis(D, 2049)).to("cuda", torch.bfloat16)
    freqs = table[pos]
    if not paged:
        k, v = (torch.randn((L, B, G, T, D), device="cuda", generator=gen).to(torch.bfloat16)
                for _ in range(2))
        return q, kv, freqs, k, v, None, T
    MP = 4
    NP = B * MP + 1
    k, v = _paged_pool(gen, L, NP, G, P)
    return q, kv, freqs, k, v, _scattered_table(gen, B, MP, NP), MP * P


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("B", [1, 4])
def test_rope_kv_append_is_bit_equal_to_plain(gen, B, paged):
    """B3 / B9 fused with the RoPE of q and k: the rotated q, the cache or
    pool bit-equal to the plain sequence (two apply_rotary_emb, two plain
    writes), with the kv row strided and starts in the middle, at the wall
    and past the capacity; one launch counted."""
    q, kv, freqs, k, v, pt, cap = _rope_case(gen, B, paged)
    assert kv.stride(0) != kv.shape[1]
    starts = torch.tensor([7, cap - 1, cap, cap + 300][:B], dtype=torch.int32, device="cuda")
    for st in (starts, torch.full_like(starts, cap + 9)):
        kr, vr = k.clone(), v.clone()
        before = A.rope_kv_append.launches
        got = A.rope_kv_append(q, kv, freqs, k, v, 2, st, pt)
        want = A.rope_kv_append_plain(q, kv, freqs, kr, vr, 2, st, pt)
        torch.cuda.synchronize()
        assert A.rope_kv_append.launches == before + 1
        assert got.shape == (B, 2, 16, 128) and torch.equal(got, want)
        assert torch.equal(k, kr) and torch.equal(v, vr)


def test_rope_kv_append_replays_in_a_graph(gen):
    """One launch captured in a CUDA graph (no host sync, no allocation in
    the launch, no state between launches), replayed on new inputs copied
    into the captured tensors: each replay bit-equal to the plain sequence."""
    B = 4
    q, kv, freqs, k, v, pt, cap = _rope_case(gen, B, True)
    starts = torch.tensor([3, 300, 700, cap + 5], dtype=torch.int32, device="cuda")
    A.rope_kv_append(q, kv, freqs, k, v, 1, starts, pt)  # warm-up (build, load)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = A.rope_kv_append(q, kv, freqs, k, v, 1, starts, pt)
    for step in range(2):
        q.copy_(torch.randn(q.shape, device="cuda", generator=gen))
        kv.copy_(torch.randn(kv.shape, device="cuda", generator=gen))
        starts.add_(1)
        kr, vr = k.clone(), v.clone()
        graph.replay()
        want = A.rope_kv_append_plain(q, kv, freqs, kr, vr, 1, starts, pt)
        torch.cuda.synchronize()
        assert torch.equal(out, want) and torch.equal(k, kr) and torch.equal(v, vr), step


def test_rope_kv_append_rejects_what_it_cannot_take(gen):
    q, kv, freqs, k, v, _, _ = _rope_case(gen, 2, False, T=64)
    starts = torch.zeros((2,), dtype=torch.int32, device="cuda")
    with pytest.raises(TypeError):
        A.rope_kv_append(q.float(), kv, freqs, k, v, 0, starts)
    narrow = [t[..., :64].contiguous() for t in (q, freqs, k, v)]
    with pytest.raises(ValueError):  # D != 128
        A.rope_kv_append(narrow[0], kv[:, :256].contiguous(), *narrow[1:], 0, starts)
    with pytest.raises(ValueError):  # a layer the cache does not have
        A.rope_kv_append(q, kv, freqs, k, v, 3, starts)
    buf = torch.empty((q.numel() + 8,), dtype=q.dtype, device="cuda")
    with pytest.raises(ValueError):  # q not on a 16-byte boundary
        A.rope_kv_append(buf[1:1 + q.numel()].view(q.shape), kv, freqs, k, v, 0, starts)


# (P, MP): capacities of about 1024 rows, so rows past DECODE_SOLO_ROWS span
# several blocks; P = 16 (the CPU tests' size, four pages a tile), 96 (no
# multiple of the 64-row tile: tiles straddle pages) and 256 (the engines')
PAGED_SHAPES = [(16, 64), (96, 11), (256, 4)]


def _paged_decode_edges(P, MP, B):
    """Lengths −1 (outputs 0), 0, P − 1, P, P + 1, 255 and 256 (the last
    one-span row and the first merged across blocks), MP·P − 1 and past
    capacity, 0 for the garbage-table padding row (row 9), the rest spread."""
    cap = MP * P
    edges = [-1, 0, P - 1, P, P + 1, 255, 256, cap - 1, cap + 30, 0]
    rest = [(371 * i) % cap for i in range(1, B - len(edges) + 1)]
    return torch.tensor(edges + rest, dtype=torch.int32, device="cuda")


def _paged_decode_f32(q, kp, vp, layer, pt, lengths, sm_scale, p_bf16=False):
    """B10's function in f32 (B12's over the gathered pages)."""
    return _decode_v2_f32(q, A.gather_pages(kp[layer], pt), A.gather_pages(vp[layer], pt),
                          lengths, sm_scale, p_bf16)


@pytest.mark.parametrize("P,MP", PAGED_SHAPES)
@pytest.mark.parametrize("Hg", [16, 4])
def test_decode_paged_matches_plain(gen, P, MP, Hg):
    """The edges of ``_paged_decode_edges``, read from layer 1 through
    scattered pages.  Within 1e-2 of max|plain| and, since B10 keeps p in f32
    through PV, within B10_TOL beyond the output's bf16 rounding, where p
    rounded to bf16 lands above it."""
    L, G, D, B = 2, 2, 128, 12
    NP = B * MP + 1
    kp, vp = _paged_pool(gen, L, NP, G, P)
    pt = _scattered_table(gen, B, MP, NP)
    pt[9] = 0
    lengths = _paged_decode_edges(P, MP, B)
    q = torch.randn((B, G, Hg, D), device="cuda", generator=gen).to(torch.bfloat16)
    sm = 1 / math.sqrt(D)
    got = A.flash_attention_decode_paged(q, kp, vp, 1, pt, lengths, sm)
    torch.cuda.synchronize()
    want = A.flash_attention_decode_paged_plain(q, kp, vp, 1, pt, lengths, sm)
    assert torch.isfinite(got.float()).all() and not got[0].float().any()
    assert _rel(got, want) <= 1e-2
    want32 = _paged_decode_f32(q, kp, vp, 1, pt, lengths, sm)
    control = _paged_decode_f32(q, kp, vp, 1, pt, lengths, sm, p_bf16=True).to(torch.bfloat16)
    assert _beyond_rounding(got, want32) <= B10_TOL < _beyond_rounding(control, want32)


def _chunk_paged_f32(q, kp, vp, layer, pt, starts, sm_scale, row_map=None, p_bf16=False):
    """B11's function in f32, before the output's bf16 rounding: q scaled
    in its dtype, l from f32 p; with ``p_bf16`` p rounded to bf16 before PV
    (the control)."""
    if row_map is not None:
        pt = pt[row_map.long()]
    k, v = A.gather_pages(kp[layer], pt).float(), A.gather_pages(vp[layer], pt).float()
    S, T = q.shape[1], k.shape[2]
    s = torch.einsum("bsghd,bgtd->bghst", A._prescaled(q, sm_scale), k)
    qpos = starts.long()[:, None] + torch.arange(S, device=q.device)[None, :]
    mask = torch.arange(T, device=q.device)[None, None, :] <= qpos[:, :, None]
    s = s.masked_fill(~mask[:, None, None], A.MASK_VALUE)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    l = p.sum(-1, keepdim=True)
    pv = p.to(torch.bfloat16).float() if p_bf16 else p
    return (torch.einsum("bghst,bgtd->bghsd", pv, v) / l).permute(0, 3, 1, 2, 4)


@pytest.mark.parametrize("P,MP", PAGED_SHAPES)
@pytest.mark.parametrize("S,Hg", [(1, 16), (9, 16), (32, 16), (128, 4)])
def test_chunk_paged_matches_plain(gen, P, MP, S, Hg):
    """Starts 0, across a page edge, at capacity − S and past it, and 700
    (its K/V rows split into spans merged in the launch); with and without
    a row map; read from layer 1; S·Hg up to 512 (the engines' bound).
    Within 1e-2 of max|plain| and within B11_TOL beyond the output's bf16
    rounding, where p rounded to bf16 lands above it."""
    L, G, D = 2, 2, 128
    Bt, B, cap = 6, 5, MP * P
    NP = Bt * MP + 1
    kp, vp = _paged_pool(gen, L, NP, G, P)
    pt = _scattered_table(gen, Bt, MP, NP)
    starts = torch.tensor([0, P - 2, cap - S, cap - S + 5, 700], dtype=torch.int32,
                          device="cuda")
    rmap = torch.tensor([5, 0, 3, 1, 2], dtype=torch.int32, device="cuda")
    q = torch.randn((B, S, G, Hg, D), device="cuda", generator=gen).to(torch.bfloat16)
    sm = 1 / math.sqrt(D)
    for table, row_map in ((pt[:B].contiguous(), None), (pt, rmap)):
        got = A.flash_attention_chunk_paged(q, kp, vp, 1, table, starts, sm, row_map)
        torch.cuda.synchronize()
        want = A.flash_attention_chunk_paged_plain(q, kp, vp, 1, table, starts, sm, row_map)
        assert torch.isfinite(got.float()).all()
        assert _rel(got, want) <= 1e-2
        want32 = _chunk_paged_f32(q, kp, vp, 1, table, starts, sm, row_map)
        control = _chunk_paged_f32(q, kp, vp, 1, table, starts, sm, row_map,
                                   p_bf16=True).to(torch.bfloat16)
        assert _beyond_rounding(got, want32) <= B11_TOL < _beyond_rounding(control, want32)


@pytest.mark.parametrize("kind", ["decode", "chunk"])
def test_paged_attention_is_deterministic_in_one_launch(gen, kind):
    """B10 and B11 at the engines' shapes (P = 256, 2048-slot rows, rows of
    1000 / 600 / 200 / 0 slots): two calls on the same inputs are bit-equal
    (the spans merge in order and the counters reset in the launch), and one
    call, row map included, is one kernel."""
    from torch.profiler import ProfilerActivity, profile

    L, G, Hg, D, P, MP, B = 2, 2, 16, 128, 256, 8, 4
    kp, vp = _paged_pool(gen, L, B * MP + 1, G, P)
    pt = _scattered_table(gen, B, MP, B * MP + 1)
    lens = torch.tensor([1000, 600, 200, 0], dtype=torch.int32, device="cuda")
    if kind == "decode":
        q = torch.randn((B, G, Hg, D), device="cuda", generator=gen).to(torch.bfloat16)

        def call():
            return A.flash_attention_decode_paged(q, kp, vp, 1, pt, lens, 0.088)
    else:
        q = torch.randn((B, 9, G, Hg, D), device="cuda", generator=gen).to(torch.bfloat16)
        rmap = torch.tensor([2, 0, 3, 1], dtype=torch.int32, device="cuda")

        def call():
            return A.flash_attention_chunk_paged(q, kp, vp, 1, pt, lens, 0.088, rmap)
    first = call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        again = call()
        torch.cuda.synchronize()
    assert torch.equal(first, again)
    kernels = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    want = "decode_attn_kernel" if kind == "decode" else "prefill_attn_kernel"
    assert len(kernels) == 1 and want in kernels[0], kernels


@pytest.mark.parametrize("starts", [[256, 0, 448], [200, 3, 447]])
@pytest.mark.parametrize("Hg", [16, 4, 64])
def test_prefill_chunk_form_matches_plain(gen, Hg, starts):
    """A compact batch of 3 chunk rows against a 4-row cache of T = 512 at
    chunk offsets on and off the 64-row tiles, with a row map and a
    length-0 padding row."""
    G, D, T, S = 2, 128, 512, 64
    q = torch.randn((3, S, G, Hg, D), device="cuda", generator=gen).to(torch.bfloat16)
    k = torch.randn((4, G, T, D), device="cuda", generator=gen).to(torch.bfloat16)
    v = torch.randn((4, G, T, D), device="cuda", generator=gen).to(torch.bfloat16)
    starts = torch.tensor(starts, dtype=torch.int32, device="cuda")
    lengths = starts + torch.tensor([40, 64, 0], dtype=torch.int32, device="cuda")
    lengths[2] = 0
    rmap = torch.tensor([3, 1, 0], dtype=torch.int32, device="cuda")
    sm = 1 / math.sqrt(D)
    got = A.flash_attention_prefill_chunk(q, k, v, lengths, starts, sm, rmap)
    torch.cuda.synchronize()
    want = A.flash_attention_prefill_plain(q, k, v, lengths, sm, starts, rmap)
    assert torch.isfinite(got.float()).all()
    assert _rel(got, want) <= 1e-2
    assert not got[2].float().any()


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


# The int8 decode matmuls' split-K tensor-core kernels (B6 bf16; B7 / B8 in
# bf16 and f32 output): one and two m-tiles and their edges, N = 264 (8
# columns a lane, the last tile past N), N = 2064 (16 columns a lane at M
# <= 8, the last tile past N), w_out's K, kv_proj's N (K splits), the lm_head
SPLITK8_M = (1, 2, 3, 4, 5, 8, 9, 16)
SPLITK8_SHAPES = [(4096, 264), (1024, 2064), (13824, 512), (4096, 4096), (320, 65536)]


def _beyond_sum(got, exact, terms):
    """The largest error of a bf16 output beyond half a bf16 ulp of its
    exact value, over the sum of its terms' magnitudes (all f64)."""
    half_ulp = torch.ldexp(torch.ones_like(exact), torch.frexp(exact)[1] - 9)
    excess = ((got.double() - exact).abs() - half_ulp).clamp_min(0)
    return (excess / terms.clamp_min(1e-300)).max().item()


def _b6_launches():
    return I8.int8_splitk.launches, I8.int8_gemv.launches, I8.int8_mma.launches


@pytest.mark.parametrize("K,N", SPLITK8_SHAPES)
@pytest.mark.parametrize("M", SPLITK8_M)
def test_int8_splitk_error_is_its_bf16_rounding(gen, M, K, N):
    """One launch of B6's split-K kernel, no second pass; every output within
    2^-23 of sum|x·w|·s of its exact value beyond half a bf16 ulp (a fresh
    f32 partial every 32 K rows keeps the mma's sums from drifting)."""
    w, scale = _int8_weights(gen, K, N)
    x = _x(gen, M, K, torch.bfloat16)
    assert I8.int8_route(M, N, torch.bfloat16) == "splitk"
    before = _b6_launches()
    got = I8.int8_matmul(x, w, scale)
    torch.cuda.synchronize()
    assert [a - b for a, b in zip(_b6_launches(), before)] == [1, 0, 0]
    assert got.dtype == torch.bfloat16 and got.shape == (M, N)
    assert _rel(got, I8.int8_matmul_plain(x, w, scale)) <= 1e-2
    s64 = scale.double()
    exact = (x.double() @ w.double()) * s64
    assert _beyond_sum(got, exact, (x.double().abs() @ w.double().abs()) * s64) <= 2.0 ** -23
    assert not got[M // 2].any()


def _int4_dyn_exact(x, packed, scale):
    """B8's exact function and the sum of its terms' magnitudes, f64."""
    xq, sx = D.dyn_quantize_rows(x)
    w = QM.unpack_int4_tpu(packed, scale).double()
    s = sx.double()
    return (xq.double() @ w) * s, (xq.double().abs() @ w.abs()) * s


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("K,N", SPLITK8_SHAPES)
@pytest.mark.parametrize("M", SPLITK8_M)
@pytest.mark.parametrize("kind", ["int8_dyn", "int4_dyn"])
def test_dyn_splitk_matches_plain(gen, kind, M, K, N, dtype):
    """One launch of B7's / B8's split-K kernel; B7 bit for bit, B8 within
    the kernels' tolerance and (bf16) within 2^-23 of sum|terms| of its
    exact value beyond its bf16 rounding."""
    x = _x(gen, M, K, dtype)
    if kind == "int8_dyn":
        w, scale = _int8_weights(gen, K, N)
        fn, plain, kernel = D.int8_dyn_matmul, D.int8_dyn_matmul_plain, D.int8_dyn_splitk
    else:
        w, scale = _int4_weights(gen, K, N)
        fn, plain, kernel = D.int4_dyn_matmul, D.int4_dyn_matmul_plain, D.int4_dyn_splitk
    before = kernel.launches, D.int8_dyn_mma.launches + D.int4_dyn_mma.launches
    got = fn(x, w, scale)
    torch.cuda.synchronize()
    assert (kernel.launches - before[0],
            D.int8_dyn_mma.launches + D.int4_dyn_mma.launches - before[1]) == (1, 0)
    assert got.dtype == dtype and got.shape == (M, N)
    want = plain(x, w, scale)
    if kind == "int8_dyn":
        assert torch.equal(got, want), _rel(got, want)
        return
    assert _rel(got, want) <= _tol(dtype)
    assert not got[M // 2].any()
    if dtype == torch.bfloat16:
        exact, terms = _int4_dyn_exact(x, w, scale)
        assert _beyond_sum(got, exact, terms) <= 2.0 ** -23


@pytest.mark.parametrize("M,K,N", [(1, 4096, 512), (4, 13824, 4096), (16, 4096, 264),
                                   (1, 1024, 2064)])
@pytest.mark.parametrize("kind", ["int8", "int8_dyn", "int4_dyn"])
def test_int8_splitk_kernels_are_deterministic_and_replay_in_a_graph(gen, kind, M, K, N):
    """Two calls are bit-equal and leave every arrival counter at 0 (the
    merging block resets its own); one call captured in a CUDA graph and
    replayed twice is bit-equal to the eager call."""
    if kind == "int4_dyn":
        w, scale = _int4_weights(gen, K, N)
        fn, xbytes = D.int4_dyn_matmul, 1
    else:
        w, scale = _int8_weights(gen, K, N)
        fn, xbytes = (I8.int8_matmul, 2) if kind == "int8" else (D.int8_dyn_matmul, 1)
    plan = QM.splitk_plan(M, K, N, xbytes, int8_weights=kind != "int4_dyn")
    x = torch.randn((M, K), device="cuda", generator=gen).to(torch.bfloat16)
    first = fn(x, w, scale)
    second = fn(x, w, scale)
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    tiles = -(-N // (8 * plan[1]))
    assert not _build.scratch("splitk_arrivals", x.device, tiles, torch.int32)[:tiles].any()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn(x, w, scale)  # warm-up on the capture stream
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = fn(x, w, scale)
    for _ in range(2):
        captured.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(captured, first)


@pytest.mark.parametrize("entry", ["chatglm_int8_splitk_mma", "chatglm_int8_dyn_splitk",
                                   "chatglm_int4_dyn_splitk"])
def test_int8_splitk_kernels_reject_a_plan_they_cannot_take(gen, entry):
    """More rows than the plan's m-tiles hold, more than two m-tiles, 16
    columns a lane at two m-tiles: refused at the launch, never run."""
    x = torch.zeros((24, 64), dtype=torch.bfloat16, device="cuda")
    sx = torch.ones((24,), device="cuda")
    w = torch.zeros((64, 16), dtype=torch.int8, device="cuda")
    scale = torch.ones((64, 16), device="cuda")  # bytes enough for either scale
    y = torch.empty((24, 16), dtype=torch.bfloat16, device="cuda")
    arrivals = torch.zeros((16,), dtype=torch.int32, device="cuda")
    for M, mt, cols in ((9, 1, 8), (24, 3, 8), (9, 2, 16)):
        lead = [x.data_ptr()] if "dyn" not in entry else [x.data_ptr(), sx.data_ptr()]
        mid = [] if "dyn" not in entry else [1]
        with pytest.raises(RuntimeError):
            _build.call(entry, *lead, w.data_ptr(), scale.data_ptr(), y.data_ptr(), None,
                        arrivals.data_ptr(), M, 64, 16, *mid, mt, cols, 1, 2, 8,
                        _build.stream_ptr(x))


def test_dyn_matmuls_refuse_many_rows_at_a_narrow_n(gen):
    """Above MMA_MIN_M rows the dynamic kernels need N % 16 == 0."""
    x = torch.randn((17, 64), device="cuda", generator=gen).to(torch.bfloat16)
    w = torch.zeros((64, 264), dtype=torch.int8, device="cuda")
    with pytest.raises(ValueError):
        D.int8_dyn_matmul(x, w, torch.ones((264,), device="cuda"))
    with pytest.raises(ValueError):
        D.int4_dyn_matmul(x, torch.zeros((32, 264), dtype=torch.uint8, device="cuda"),
                          torch.ones((2, 264), dtype=torch.bfloat16, device="cuda"))


# B13 / B14 (the backward matmuls): g (M, N) -> (M, K).  M across the
# split-K / tensor-core switch, N = 264 (not a multiple of 16: the CUDA-core
# kernel even in bf16), the storage K of w_out, and the lm_head's N.
T_EDGES = [(1, 4096, 512), (3, 256, 264), (16, 13824, 4096), (17, 4096, 4096),
           (130, 13824, 4096), (70, 4096, 65536)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("M,K,N", T_EDGES)
def test_int8_matmul_t_matches_plain(gen, dtype, M, K, N):
    w, scale = _int8_weights(gen, K, N)
    g = _x(gen, M, N, dtype)
    got = I8.int8_matmul_t(g, w, scale)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (M, K)
    assert _rel(got, I8.int8_matmul_t_plain(g, w, scale)) <= _tol(dtype)
    assert not got[M // 2].any()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("M,K,N", T_EDGES)
def test_int4g32_matmul_t_matches_plain(gen, dtype, M, K, N):
    packed = torch.randint(0, 256, (K // 2, N), dtype=torch.uint8, device="cuda", generator=gen)
    scale = (torch.rand((K // 32, N), device="cuda", generator=gen) * 0.02).to(torch.bfloat16)
    g = _x(gen, M, N, dtype)
    got = QM.int4g32_matmul_t(g, packed, scale)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (M, K)
    assert _rel(got, QM.int4g32_matmul_t_plain(g, packed, scale)) <= _tol(dtype)


def test_transposed_kernels_read_a_layer_view(gen):
    stack = torch.randint(0, 256, (3, 512, 4096), dtype=torch.uint8, device="cuda", generator=gen)
    scales = (torch.rand((3, 32, 4096), device="cuda", generator=gen) * 0.02).to(torch.bfloat16)
    w8 = torch.randint(-128, 128, (3, 1024, 4096), dtype=torch.int8, device="cuda", generator=gen)
    s8 = torch.rand((3, 4096), device="cuda", generator=gen) * 0.02
    for M in (2, 64):
        g = torch.randn((M, 4096), device="cuda", generator=gen).to(torch.bfloat16)
        got = QM.int4g32_matmul_t(g, stack[2], scales[2])
        assert _rel(got, QM.int4g32_matmul_t_plain(g, stack[2].clone(), scales[2].clone())) <= 1e-2
        got = I8.int8_matmul_t(g, w8[1], s8[1])
        assert _rel(got, I8.int8_matmul_t_plain(g, w8[1].clone(), s8[1].clone())) <= 1e-2


@pytest.mark.parametrize("quant", ["int8", "int4g32"])
def test_autograd_backward_launches_the_transposed_kernels(gen, monkeypatch, quant):
    """On CUDA tensors quant_linear's backward launches B13/B14 (never their
    plain versions) and its grad_x agrees with the plain path's; K = 4000
    is stored padded to 4096 and comes back stripped."""
    from chatglm_q_tpu_torch import TorchRuntimeConfig
    from chatglm_q_tpu_torch.ops import linear as TL

    K, Ks, N = 4000, 4096, 1024
    if quant == "int8":
        w, scale = _int8_weights(gen, Ks, N)
        w[K:] = 0
        params, kernels = {"weight": w, "weight_scale": scale}, ("int8_t_gemv", "int8_t_mma")
        plain_name = "int8_matmul_t_plain"
    else:
        packed = torch.randint(0, 256, (Ks // 2, N), dtype=torch.uint8, device="cuda",
                               generator=gen)
        packed[K // 2:] = 0
        scale = (torch.rand((Ks // 32, N), device="cuda", generator=gen) * 0.02).to(torch.bfloat16)
        params, kernels = {"weight": packed, "weight_scale": scale}, ("int4g32_t_gemv",
                                                                      "int4g32_t_mma")
        plain_name = "int4g32_matmul_t_plain"
    fns = [getattr(I8 if quant == "int8" else QM, k) for k in kernels]
    plain = getattr(TL, plain_name)
    xs = {M: torch.randn((M, K), device="cuda", generator=gen).to(torch.bfloat16)
          for M in (8, 256)}
    grads = {}
    for use_kernels in (False, True):
        if use_kernels:
            monkeypatch.setattr(TL, plain_name, lambda *a: pytest.fail("plain backward ran"))
        before = [f.launches for f in fns]
        for M, x0 in xs.items():
            x = x0.clone().requires_grad_(True)
            y = TL.quant_linear(x, params, quant, TorchRuntimeConfig(use_kernels=use_kernels))
            y.float().square().sum().backward()
            torch.cuda.synchronize()
            assert x.grad.shape == (M, K)
            grads[use_kernels, M] = x.grad
        launched = [f.launches - b for f, b in zip(fns, before)]
        assert launched == ([1, 1] if use_kernels else [0, 0]), launched
    monkeypatch.setattr(TL, plain_name, plain)
    for M in (8, 256):
        assert _rel(grads[True, M], grads[False, M]) <= 2e-2


# The Hopper kernels of B6 (int8_mma), B13 (int8_t_mma) and B14
# (int4g32_t_mma): every main-path linear (K, N) — q/o, kv, w_in, w_out and
# the lm_head's 65536 — at a verify step's and a short prompt's M, a ragged
# M, a 4 x 128 prefill and a training step's M.  The transposed forms take
# g (M, N) to (M, K).
WG_LINEARS = [(4096, 4096), (4096, 512), (4096, 13824), (13824, 4096), (4096, 65536)]
WG_M = (17, 48, 65, 200, 512, 1024)


def _beyond_sum(got, exact, terms):
    """chip_smoke.py's SUM_TOL reading: the error beyond half a bf16 ulp of
    the exact value (f64), over the sum of the terms' magnitudes (f64)."""
    half_ulp = torch.ldexp(torch.ones_like(exact), torch.frexp(exact)[1] - 9)
    excess = ((got.double() - exact).abs() - half_ulp).clamp_min(0)
    return (excess / terms.clamp_min(1e-300)).max().item()


def _int4_t_weights(gen, K, N):
    packed = torch.randint(0, 256, (K // 2, N), dtype=torch.uint8, device="cuda", generator=gen)
    scale = (torch.rand((K // 32, N), device="cuda", generator=gen) * 0.02).to(torch.bfloat16)
    return packed, scale


def _wg_case(gen, kind, M, K, N):
    """(call, its wrapper, plain version, exact f64 value, f64 sum|terms|)
    of one Hopper matmul on random inputs."""
    if kind == "int8":
        w, scale = _int8_weights(gen, K, N)
        x = torch.randn((M, K), device="cuda", generator=gen).to(torch.bfloat16)
        w64, s64 = w.double(), scale.double()
        return (lambda: I8.int8_matmul(x, w, scale), I8.int8_mma,
                lambda: I8.int8_matmul_plain(x, w, scale),
                lambda: ((x.double() @ w64) * s64, (x.double().abs() @ w64.abs()) * s64))
    g = torch.randn((M, N), device="cuda", generator=gen).to(torch.bfloat16)
    if kind == "int8_t":
        w, scale = _int8_weights(gen, K, N)
        gs, w64 = (g * scale.to(torch.bfloat16)).double(), w.double()
        return (lambda: I8.int8_matmul_t(g, w, scale), I8.int8_t_mma,
                lambda: I8.int8_matmul_t_plain(g, w, scale),
                lambda: (gs @ w64.T, gs.abs() @ w64.abs().T))
    packed, scale = _int4_t_weights(gen, K, N)
    w64 = QM.unpack_int4_tpu(packed, scale).to(torch.bfloat16).double()  # bf16(q·s)
    return (lambda: QM.int4g32_matmul_t(g, packed, scale), QM.int4g32_t_mma,
            lambda: QM.int4g32_matmul_t_plain(g, packed, scale),
            lambda: (g.double() @ w64.T, g.double().abs() @ w64.abs().T))


@pytest.mark.parametrize("K,N", WG_LINEARS)
@pytest.mark.parametrize("M", WG_M)
@pytest.mark.parametrize("kind", ["int8", "int8_t", "int4g32_t"])
def test_wgmma_kernels_error_is_their_bf16_rounding(gen, kind, M, K, N):
    """One launch of the Hopper kernel, within the bf16 tolerance of the
    plain version and within 2^-23 of sum|terms| of the exact value beyond
    half a bf16 ulp (B1's bound: f32 sums of exact products, one rounding)."""
    call, kernel, plain, exact = _wg_case(gen, kind, M, K, N)
    before = kernel.launches
    got = call()
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    assert got.dtype == torch.bfloat16 and got.shape == (M, N if kind == "int8" else K)
    assert torch.isfinite(got.float()).all()
    assert _rel(got, plain()) <= 1e-2
    assert _beyond_sum(got, *exact()) <= 2.0 ** -23


@pytest.mark.parametrize("M,K,N", [(65, 4096, 512), (512, 4096, 4096), (200, 1024, 272)])
@pytest.mark.parametrize("kind", ["int8", "int8_t", "int4g32_t"])
def test_wgmma_kernels_are_deterministic_and_replay_in_a_graph(gen, kind, M, K, N):
    """Two calls are bit-equal and leave every arrival counter at 0 (the
    merging warpgroup resets its own; the first shape splits the
    contraction); one call captured in a CUDA graph and replayed twice is
    bit-equal to the eager call."""
    call, _, _, _ = _wg_case(gen, kind, M, K, N)
    first, second = call(), call()
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    bm, nsplit = (QM.wg_plan(M, K, N) if kind == "int8" else QM.t_mma_plan(M, K, N))[:2]
    assert nsplit > 1 or (M, K, N) != (65, 4096, 512)
    tiles = -(-M // bm) * -(-(N if kind == "int8" else K) // QM.MMA_BN)
    assert not _build.scratch("mma_arrivals", first.device, 2 * tiles,
                              torch.int32)[:2 * tiles].any()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        call()  # warm-up on the capture stream
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = call()
    for _ in range(2):
        captured.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(captured, first)


@pytest.mark.parametrize("entry", ["chatglm_int8_mma", "chatglm_int8_t_mma",
                                   "chatglm_int4_t_mma"])
def test_wgmma_kernels_reject_a_plan_they_cannot_take(gen, entry):
    a = torch.randn((100, 1024), device="cuda", generator=gen).to(torch.bfloat16)
    w = torch.zeros((1024, 1024), dtype=torch.int8, device="cuda")  # bytes enough for any view
    scale = torch.ones((1024, 1024), device="cuda")
    out = torch.empty((100, 1024), dtype=torch.bfloat16, device="cuda")
    ws = torch.empty((1 << 20,), dtype=torch.float32, device="cuda")
    arrivals = torch.zeros((64,), dtype=torch.int32, device="cuda")
    # 16 stages of 64: stages uncovered, an empty split, no such tile, splits without a workspace
    for bm, nsplit, sps, part in ((128, 2, 4, ws), (128, 4, 8, ws), (96, 1, 16, ws),
                                  (64, 2, 8, None)):
        with pytest.raises(RuntimeError):
            _build.call(entry, a.data_ptr(), w.data_ptr(), scale.data_ptr(), out.data_ptr(),
                        None if part is None else part.data_ptr(), arrivals.data_ptr(), 100,
                        1024, 1024, bm, nsplit, sps, 8, _build.stream_ptr(a))


# B7 / B8 above 16 rows (dyn_wgmma_kernel): every main-path linear (q/o,
# kv, w_in, w_out, the lm_head's 65536) at a short prompt's, a verify
# step's, the 57-token chat prompt's, the int4-dyn ceiling's and prefill M.
DYN_M = (17, 36, 57, 64, 65, 128, 512)


def _beyond_sum_of(got, exact, terms, bits):
    """_beyond_sum for an output of ``bits`` significant bits (bf16 8, f32 24)."""
    half_ulp = torch.ldexp(torch.ones_like(exact), torch.frexp(exact)[1] - (bits + 1))
    excess = ((got.double() - exact).abs() - half_ulp).clamp_min(0)
    return (excess / terms.clamp_min(1e-300)).max().item()


def _dyn_case(gen, kind, M, K, N, dtype):
    """(call, its Hopper wrapper, plain version, exact f64 value and f64
    sum|terms| of B8) of one dynamic matmul on random inputs with a zero
    row (sx at its 1e-10 clamp)."""
    x = _x(gen, M, K, dtype)
    if kind == "int8":
        w, scale = _int8_weights(gen, K, N)
        return (lambda: D.int8_dyn_matmul(x, w, scale), D.int8_dyn_mma,
                lambda: D.int8_dyn_matmul_plain(x, w, scale), None)
    packed, scale = _int4_t_weights(gen, K, N)

    def exact():
        xq, sx = D.dyn_quantize_rows(x)
        w64 = QM.unpack_int4_tpu(packed, scale).double()  # q·s, exact
        s64 = sx.double()
        return (xq.double() @ w64) * s64, (xq.double().abs() @ w64.abs()) * s64

    return (lambda: D.int4_dyn_matmul(x, packed, scale), D.int4_dyn_mma,
            lambda: D.int4_dyn_matmul_plain(x, packed, scale), exact)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("K,N", WG_LINEARS)
@pytest.mark.parametrize("M", DYN_M)
@pytest.mark.parametrize("kind", ["int8", "int4g32"])
def test_dyn_wgmma_kernel_matches_plain(gen, kind, M, K, N, dtype):
    """One launch of the Hopper kernel in x's dtype.  B7 equals its plain
    version bit for bit (exact int32 sums, the same f32 epilogue); B8 is
    within 1e-2 (f32: 1e-5) of max|plain| and within 2^-23 of sum|terms| of
    its exact value beyond half an ulp of the output (its f32 sum over
    groups in another order).  A second launch is bit-equal and every
    arrival counter is back at 0."""
    call, kernel, plain, exact = _dyn_case(gen, kind, M, K, N, dtype)
    before = kernel.launches
    got = call()
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    assert got.dtype == dtype and got.shape == (M, N)
    assert torch.isfinite(got.float()).all() and not got[M // 2].any()
    want = plain()
    if kind == "int8":
        assert torch.equal(got, want), _rel(got, want)
    else:
        assert _rel(got, want) <= _tol(dtype)
        bits = 8 if dtype == torch.bfloat16 else 24
        assert _beyond_sum_of(got, *exact(), bits) <= 2.0 ** -23
    assert torch.equal(call(), got)
    bm = D.dyn_plan(M, K, N)[0]
    tiles = -(-M // bm) * -(-N // QM.MMA_BN)
    torch.cuda.synchronize()
    assert not _build.scratch("mma_arrivals", got.device, 2 * tiles,
                              torch.int32)[:2 * tiles].any()


@pytest.mark.parametrize("M,K,N", [(64, 4096, 512), (512, 4096, 4096), (200, 1024, 272),
                                   (40, 4000, 4224)])
@pytest.mark.parametrize("kind", ["int8", "int4g32"])
def test_dyn_wgmma_kernel_replays_in_a_graph_and_takes_ragged_shapes(gen, kind, M, K, N):
    """Ragged M, N and K (4000: a last stage of 32 elements, B8's of one
    group) and a split plan; one call captured in a CUDA graph and replayed
    twice is bit-equal to the eager call."""
    call, _, plain, _ = _dyn_case(gen, kind, M, K, N, torch.bfloat16)
    first = call()
    torch.cuda.synchronize()
    want = plain()
    assert torch.equal(first, want) if kind == "int8" else _rel(first, want) <= 1e-2
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        call()  # warm-up on the capture stream
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = call()
    for _ in range(2):
        captured.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(captured, first)


@pytest.mark.parametrize("entry", ["chatglm_int8_dyn_mma", "chatglm_int4_dyn_mma"])
def test_dyn_wgmma_kernel_rejects_a_plan_it_cannot_take(gen, entry):
    xq = torch.zeros((100, 2048), dtype=torch.int8, device="cuda")
    sx = torch.ones((100,), device="cuda")
    w = torch.zeros((2048, 1024), dtype=torch.int8, device="cuda")  # bytes enough for either
    scale = torch.ones((2048, 1024), device="cuda")
    y = torch.empty((100, 1024), dtype=torch.bfloat16, device="cuda")
    ws = torch.empty((1 << 20,), dtype=torch.float32, device="cuda")
    arrivals = torch.zeros((64,), dtype=torch.int32, device="cuda")
    # 16 stages of 128: stages uncovered, an empty split, no such tile, splits without a workspace
    for bm, nsplit, sps, part in ((128, 2, 4, ws), (128, 4, 8, ws), (96, 1, 16, ws),
                                  (64, 2, 8, None)):
        with pytest.raises(RuntimeError):
            _build.call(entry, xq.data_ptr(), sx.data_ptr(), w.data_ptr(), scale.data_ptr(),
                        y.data_ptr(), None if part is None else part.data_ptr(),
                        arrivals.data_ptr(), 100, 2048, 1024, 1, bm, nsplit, sps, 8,
                        _build.stream_ptr(xq))


def _decode_v2_f32(q, k, v, lengths, sm_scale, p_bf16=False):
    """B12's function in f32, before the output's bf16 rounding (with
    ``p_bf16``, p rounded to bf16 before PV: the control)."""
    s = torch.einsum("bghd,bgtd->bght", A._prescaled(q, sm_scale), k.float())
    valid = torch.arange(k.shape[2], device=q.device)[None, :] <= lengths.long()[:, None]
    s = s.masked_fill(~valid[:, None, None, :], A.MASK_VALUE)
    p = torch.exp(s - s.amax(-1, keepdim=True)) * (lengths >= 0).float()[:, None, None, None]
    l = p.sum(-1, keepdim=True)
    pv = p.to(torch.bfloat16).float() if p_bf16 else p
    return torch.einsum("bght,bgtd->bghd", pv, v.float()) / torch.where(l > 0, l, 1.0)


def _beyond_rounding(got, want32):
    """max(|got − want32| − half a bf16 ulp of want32) / max|want32|."""
    half_ulp = torch.ldexp(torch.ones_like(want32), torch.frexp(want32).exponent - 9)
    half_ulp = torch.where(want32 == 0, 0.0, half_ulp)
    excess = ((got.float() - want32).abs() - half_ulp).clamp_min(0.0).max().item()
    return excess / want32.abs().max().item()


@pytest.mark.parametrize("B,T", [(10, 1000), (66, 1000)])
@pytest.mark.parametrize("Hg", [16, 4])
def test_decode_v2_matches_plain(gen, Hg, B, T):
    """T = 1000 (no multiple of the tile), lengths −1 (outputs 0), 0, around
    the span and the one-span bound, and past the cache, at several
    block_k.  B12 keeps p in f32 through PV, so besides 1e-2 of max|plain|
    its error beyond the output's bf16 rounding stays within chip_smoke.py's
    B12_TOL, where B12's function with p rounded to bf16 lands above it."""
    G, D = 2, 128
    q, k, v = _decode_inputs(gen, B, G, Hg, T)
    sm = 1 / math.sqrt(D)
    for block_k in (512, 64, 1000):
        lengths = _decode_edges(B, T, A.decode_span(B * G, T, block_k), past_end=True)
        got = A.flash_attention_decode_v2(q, k, v, lengths, sm, block_k)
        torch.cuda.synchronize()
        assert torch.isfinite(got.float()).all() and not got[0].float().any()
        assert _rel(got, A.flash_attention_decode_v2_plain(q, k, v, lengths, sm)) <= 1e-2
        want32 = _decode_v2_f32(q, k, v, lengths, sm)
        control = _decode_v2_f32(q, k, v, lengths, sm, p_bf16=True).to(torch.bfloat16)
        assert _beyond_rounding(got, want32) <= B12_TOL < _beyond_rounding(control, want32)


# ---------------------------------------------------------------------------
# The sharded forms: K1 (B4 with return_lse on a T-shard), K2 (B10 strided,
# with return_lse), K3 (the fused RoPE + KV append on a sharded cache)
# ---------------------------------------------------------------------------

LSE_TOL = 1e-4  # chip_smoke.py's: (m, l) of the kernel against its plain version


def _hold_lse(got, want):
    (o, m, l), (op, mp, lp) = got, want
    empty = torch.isinf(mp)
    assert torch.equal(torch.isinf(m), empty) and not l[empty].any()
    assert not o[empty].float().any() and torch.isfinite(o.float()).all()
    assert _rel(o, op) <= 1e-2
    fin = ~empty
    if fin.any():
        assert ((m[fin] - mp[fin]).abs() / mp[fin].abs().clamp_min(1.0)).max() <= LSE_TOL
        assert ((l[fin] - lp[fin]).abs() / lp[fin]).max() <= LSE_TOL


@pytest.mark.parametrize("shard", [0, 1, 3])
@pytest.mark.parametrize("Hg", [16, 4])
def test_decode_lse_matches_plain_on_a_t_shard(gen, Hg, shard):
    """Shard ``shard`` of a 4-way split of a 4096-slot cache: rows ending
    before it (0, −inf, 0), at its edges, across it (several spans, the
    in-launch merge writing (m, l)) and a length −1 row; the shards merged
    equal the unsharded kernel within 1e-2."""
    B, G, D, T, tp = 8, 2, 128, 4096, 4
    Tl = T // tp
    q, k, v = _decode_inputs(gen, B, G, Hg, T)
    sm = 1 / math.sqrt(D)
    lengths = torch.tensor([-1, 5, Tl - 1, Tl, 2 * Tl + 300, 3 * Tl - 2, T - 1, 1500],
                           dtype=torch.int32, device="cuda")
    parts = []
    for r in range(tp):
        ks = k[:, :, r * Tl:(r + 1) * Tl].contiguous()
        vs = v[:, :, r * Tl:(r + 1) * Tl].contiguous()
        got = A.flash_attention_decode_lse(q, ks, vs, lengths, sm, r * Tl)
        torch.cuda.synchronize()
        if r == shard:
            _hold_lse(got, A.flash_attention_decode_lse_plain(q, ks, vs, lengths, sm, r * Tl))
        parts.append(got)
    merged = A.merge_lse_partials(*(torch.stack(x) for x in zip(*parts)), torch.bfloat16)
    assert _rel(merged, A.flash_attention_decode(q, k, v, lengths, sm)) <= 1e-2
    assert not merged[0].float().any()


@pytest.mark.parametrize("stride", [2, 4])
@pytest.mark.parametrize("P,MPl", [(256, 4), (96, 6)])
def test_decode_paged_lse_matches_plain(gen, stride, P, MPl):
    """K2 at every phase of a strided local table: lengths −1, within the
    first page, at page edges, spanning every column, past the capacity
    (the column count clamps to the table); a page size off the tile."""
    B, G, Hg, D, NP = 9, 2, 16, 128, 40
    cap = MPl * stride * P
    kp = torch.randn((2, NP, G, P, D), device="cuda", generator=gen).to(torch.bfloat16)
    vp = torch.randn((2, NP, G, P, D), device="cuda", generator=gen).to(torch.bfloat16)
    table = torch.randint(0, NP, (B, MPl), dtype=torch.int32, device="cuda", generator=gen)
    q = torch.randn((B, G, Hg, D), device="cuda", generator=gen).to(torch.bfloat16)
    lengths = torch.tensor([-1, 0, P - 1, P, stride * P, cap // 2 + 7, cap - 1, cap + 50, 300],
                           dtype=torch.int32, device="cuda")
    sm = 1 / math.sqrt(D)
    for phase in range(stride):
        got = A.flash_attention_decode_paged_lse(q, kp, vp, 1, table, lengths, sm, stride, phase)
        torch.cuda.synchronize()
        _hold_lse(got, A.flash_attention_decode_paged_lse_plain(q, kp, vp, 1, table, lengths, sm,
                                                                stride, phase))


def test_decode_lse_forms_are_deterministic_and_replay_in_a_graph(gen):
    """K1 and K2 bit-equal over two launches (the merging block resets its
    counter), and each captured in a CUDA graph and replayed on new q:
    bit-equal to an eager launch."""
    B, G, Hg, D, T = 4, 2, 16, 128, 2048
    q, k, v = _decode_inputs(gen, B, G, Hg, T)
    lengths = torch.tensor([2000, 900, 100, -1], dtype=torch.int32, device="cuda")
    kp = k.reshape(B * G * T // 256, 1, 256, D).expand(-1, G, -1, -1).contiguous()[None]
    vp = v.reshape(B * G * T // 256, 1, 256, D).expand(-1, G, -1, -1).contiguous()[None]
    table = torch.arange(B * 8, dtype=torch.int32, device="cuda").reshape(B, 8)
    sm = 1 / math.sqrt(D)
    calls = [lambda: A.flash_attention_decode_lse(q, k, v, lengths, sm, 512),
             lambda: A.flash_attention_decode_paged_lse(q, kp, vp, 0, table, lengths, sm, 2, 1)]
    for call in calls:
        a, b = call(), call()
        assert all(torch.equal(x, y) for x, y in zip(a, b))
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = call()
        for _ in range(2):
            q.copy_(torch.randn(q.shape, device="cuda", generator=gen))
            graph.replay()
            want = call()
            torch.cuda.synchronize()
            assert all(torch.equal(x, y) for x, y in zip(out, want))


def _sharded_append_case(gen, B, paged, tp):
    G, Hg, D, L = 2, 16, 128, 3
    q = torch.randn((B, 1, Hg, D), device="cuda", generator=gen).to(torch.bfloat16)
    kv = torch.randn((B, 2 * G * D), device="cuda", generator=gen).to(torch.bfloat16)
    freqs = torch.randn((B, D), device="cuda", generator=gen).to(torch.bfloat16)
    if not paged:
        T = 1024
        k = torch.randn((L, B, G, T // tp, D), device="cuda", generator=gen).to(torch.bfloat16)
        return q, kv, freqs, k, k.clone().normal_(generator=gen), None, T
    P, MP = 64, 8
    sp = B * MP // tp + 1
    k = torch.randn((L, sp, G, P, D), device="cuda", generator=gen).to(torch.bfloat16)
    table = torch.randint(0, sp, (B, MP // tp), dtype=torch.int32, device="cuda",
                          generator=gen)
    return q, kv, freqs, k, k.clone().normal_(generator=gen), table, MP * P


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("tp", [2, 4])
def test_rope_kv_append_sharded_is_bit_equal_to_plain(gen, paged, tp):
    """K3 on every shard: rows whose slot the shard holds and rows whose
    slot another shard holds (q rotated, nothing written), at the wall and
    past it; bit-equal to its plain version, cache and q."""
    B = 6
    q, kv, freqs, k, v, table, cap = _sharded_append_case(gen, B, paged, tp)
    starts = torch.tensor([0, cap // tp - 1, cap // tp, cap // 2 + 70, cap - 1, cap + 9],
                          dtype=torch.int32, device="cuda")
    for r in range(tp):
        shard = (A.KVShard(stride=tp, phase=r, total=cap) if paged
                 else A.KVShard(offset=r * (cap // tp), total=cap))
        kr, vr, kk, vv = k.clone(), v.clone(), k.clone(), v.clone()
        got = A.rope_kv_append_sharded(q, kv, freqs, kr, vr, 2, starts, shard, table)
        torch.cuda.synchronize()
        want = A.rope_kv_append_sharded_plain(q, kv, freqs, kk, vv, 2, starts, shard, table)
        assert torch.equal(got, want) and torch.equal(kr, kk) and torch.equal(vr, vv), r


def test_rope_kv_append_sharded_replays_in_a_graph(gen):
    q, kv, freqs, k, v, table, cap = _sharded_append_case(gen, 4, True, 2)
    starts = torch.tensor([3, 300, 130, cap + 5], dtype=torch.int32, device="cuda")
    shard = A.KVShard(stride=2, phase=1, total=cap)
    A.rope_kv_append_sharded(q, kv, freqs, k, v, 1, starts, shard, table)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = A.rope_kv_append_sharded(q, kv, freqs, k, v, 1, starts, shard, table)
    for step in range(2):
        q.copy_(torch.randn(q.shape, device="cuda", generator=gen))
        kv.copy_(torch.randn(kv.shape, device="cuda", generator=gen))
        starts.add_(64)
        kr, vr = k.clone(), v.clone()
        graph.replay()
        want = A.rope_kv_append_sharded_plain(q, kv, freqs, kr, vr, 1, starts, shard, table)
        torch.cuda.synchronize()
        assert torch.equal(out, want) and torch.equal(k, kr) and torch.equal(v, vr), step


# -- CUDA graphs: the attention kernels and the captured decode programs ------

def _attention_call(gen, kind):
    """(zero-argument call of one attention kernel at a main-path shape,
    the inputs it reads, which a replay test refreshes in place)."""
    sm = 1 / math.sqrt(128)
    B, G, Hg, D, T = 4, 2, 16, 128, 1024
    if kind in ("decode", "decode_v2"):
        q, k, v = _decode_inputs(gen, B, G, Hg, T)
        lengths = torch.tensor([1000, 600, 200, 0], dtype=torch.int32, device="cuda")
        fn = A.flash_attention_decode_v2 if kind == "decode_v2" else A.flash_attention_decode
        return (lambda: fn(q, k, v, lengths, sm)), (q, k, v)
    if kind in ("prefill", "prefill_chunk"):
        S = 128 if kind == "prefill" else 64
        q = torch.randn((B, S, G, Hg, D), device="cuda", generator=gen).to(torch.bfloat16)
        k, v = (torch.randn((B, G, 256, D), device="cuda", generator=gen).to(torch.bfloat16)
                for _ in range(2))
        lengths = torch.tensor([128, 77, 33, 5], dtype=torch.int32, device="cuda")
        if kind == "prefill":
            return (lambda: A.flash_attention_prefill(q, k, v, lengths, sm)), (q, k, v)
        starts = torch.tensor([192, 100, 0, 7], dtype=torch.int32, device="cuda")
        ends = starts + 64
        return (lambda: A.flash_attention_prefill(q, k, v, ends, sm, q_starts=starts)), (q, k, v)
    P, MP, L = 256, 8, 2
    NP = B * MP + 1
    kp, vp = _paged_pool(gen, L, NP, G, P)
    pt = _scattered_table(gen, B, MP, NP)
    if kind == "decode_paged":
        q = torch.randn((B, G, Hg, D), device="cuda", generator=gen).to(torch.bfloat16)
        lengths = torch.tensor([1000, 600, 200, 0], dtype=torch.int32, device="cuda")
        return (lambda: A.flash_attention_decode_paged(q, kp, vp, 1, pt, lengths, sm)), (q, kp, vp)
    q = torch.randn((B, 9, G, Hg, D), device="cuda", generator=gen).to(torch.bfloat16)
    starts = torch.tensor([1000, 600, 200, 0], dtype=torch.int32, device="cuda")
    return (lambda: A.flash_attention_chunk_paged(q, kp, vp, 1, pt, starts, sm)), (q, kp, vp)


@pytest.mark.parametrize("kind", ["decode", "decode_v2", "prefill", "prefill_chunk",
                                  "decode_paged", "chunk_paged"])
def test_attention_kernels_replay_in_a_graph(gen, kind):
    """B4, B12, B5 (both forms), B10 and B11 captured in a CUDA graph and
    replayed on new inputs copied into the captured tensors: every replay
    bit-equal to one eager launch on the same inputs (the span merges'
    counters reset in the launch, the partials are kept scratch)."""
    call, inputs = _attention_call(gen, kind)
    call()  # warm-up: build, load, size the scratch
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = call()
    for step in range(2):
        for t in inputs:
            t.copy_(torch.randn(t.shape, device="cuda", generator=gen).to(t.dtype))
        out.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, call()), (kind, step)


def test_rope_kv_append_dense_replays_in_a_graph(gen):
    """The dense form of the fused RoPE + K/V append (the paged one is above)
    replayed: bit-equal to the plain sequence each time."""
    q, kv, freqs, k, v, _, cap = _rope_case(gen, 4, False)
    starts = torch.tensor([3, 300, 700, cap + 5], dtype=torch.int32, device="cuda")
    A.rope_kv_append(q, kv, freqs, k, v, 1, starts)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = A.rope_kv_append(q, kv, freqs, k, v, 1, starts)
    for step in range(2):
        q.copy_(torch.randn(q.shape, device="cuda", generator=gen))
        kv.copy_(torch.randn(kv.shape, device="cuda", generator=gen))
        starts.add_(1)
        kr, vr = k.clone(), v.clone()
        graph.replay()
        want = A.rope_kv_append_plain(q, kv, freqs, kr, vr, 1, starts)
        torch.cuda.synchronize()
        assert torch.equal(out, want) and torch.equal(k, kr) and torch.equal(v, vr), step


_DEPTH2 = {}


def _depth2_tree(gen):
    """ChatGLM2-6B widths at depth 2, int4g32, random unit-gain weights."""
    from chatglm_q_tpu_torch import ChatGLM2Config
    from chatglm_q_tpu_torch.bench import random_quantized_params

    if not _DEPTH2:
        cfg = ChatGLM2Config(num_layers=2)
        _DEPTH2["tree"] = (cfg, random_quantized_params(cfg, "int4g32", gen))
    return _DEPTH2["tree"]


def test_captured_decode_steps_are_bit_equal_to_eager(gen):
    """A depth-2 6B-width ``multi_step_decode`` (batch 4, ragged) and the
    paged decode program (batch 4 on scattered pages), captured, over 8
    steps: tokens, lengths and every cache / pool byte equal the eager
    steps' (``cuda_graphs=False``), and the launch counts are 8 steps'."""
    from chatglm_q_tpu_torch import TorchRuntimeConfig, ops
    from chatglm_q_tpu_torch.models import chatglm2 as M
    from chatglm_q_tpu_torch.models import paged_kv as PK

    cfg, params = _depth2_tree(gen)
    bf16 = torch.bfloat16
    ids = torch.randint(0, cfg.vocab_size, (4, 64), device="cuda", generator=gen)
    lengths = torch.tensor([64, 40, 17, 3], dtype=torch.int32, device="cuda")
    cache = M.init_kv_cache(cfg, 4, 256, bf16)
    logits, cache = M.prefill(params, cfg, ids, lengths, cache, "int4g32", bf16)
    first = torch.argmax(logits, -1).to(torch.int32)
    runs = {}
    for graphs in (False, True):
        c = M.KVCache(cache.k.clone(), cache.v.clone(), cache.lengths.clone())
        ops.reset_launch_counts()
        toks, out = M.multi_step_decode(params, cfg, first, c, 8, None, "int4g32", bf16,
                                        TorchRuntimeConfig(cuda_graphs=graphs))
        torch.cuda.synchronize()
        runs[graphs] = (toks, out, ops.launch_counts())
    (t0, c0, n0), (t1, c1, n1) = runs[False], runs[True]
    assert torch.equal(t0, t1) and torch.equal(c0.lengths, c1.lengths)
    assert torch.equal(c0.k, c1.k) and torch.equal(c0.v, c1.v)
    assert n0 == n1 and n1["int4g32_splitk"] == 8 * (6 * cfg.num_layers + 1)
    prog = M.decode_program(params, cfg, c1, "int4g32", bf16, TorchRuntimeConfig())
    assert prog.graph is not None and prog.replays == 7

    P, MP = 256, 2
    pool = PK.init_paged_kv_cache(cfg, 4, 9, MP * P, P, bf16)
    pool.page_table.copy_(torch.arange(1, 9, dtype=torch.int32, device="cuda").flip(0)
                          .reshape(4, 2))
    logits, pool = PK.prefill_paged(params, cfg, ids, lengths, pool, "int4g32", bf16)
    first = torch.argmax(logits, -1).to(torch.int32)
    outs = []
    for graphs in (False, True):
        p = pool.replace(k_pool=pool.k_pool.clone(), v_pool=pool.v_pool.clone())
        prog = PK.decode_paged_program(params, cfg, p, "int4g32", bf16,
                                       TorchRuntimeConfig(cuda_graphs=graphs))
        prog.load(ids=first, lengths=p.lengths, page_table=p.page_table)
        toks = prog.run(8, params, p.k_pool, p.v_pool, collect=("ids",))["ids"]
        torch.cuda.synchronize()
        outs.append((toks, prog.inputs["lengths"].clone(), p, prog.graph is not None))
    assert not outs[0][3] and outs[1][3]
    assert torch.equal(outs[0][0], outs[1][0]) and torch.equal(outs[0][1], outs[1][1])
    assert torch.equal(outs[0][2].k_pool, outs[1][2].k_pool)
    assert torch.equal(outs[0][2].v_pool, outs[1][2].v_pool)


def test_a_capture_that_syncs_raises_and_runs_nothing(gen):
    """A step whose body reads a value on the host cannot be captured: the
    second call raises ``CaptureError`` and the step does not run eagerly in
    its place; the card keeps working."""
    from chatglm_q_tpu_torch.utils import graphs as G

    def body(inp):
        if inp["x"].sum().item() > 1e9:  # a host sync
            inp["x"].zero_()
        inp["x"].add_(1)
        return {}

    prog = G.StepProgram("syncing step", body, {"x": torch.zeros(4, device="cuda")}, True,
                         G.Programs())
    prog.step()
    with pytest.raises(G.CaptureError, match="syncing step: CUDA-graph capture failed"):
        prog.step()
    torch.cuda.synchronize()
    assert prog.graph is None and prog.inputs["x"].tolist() == [1.0] * 4
    assert torch.ones(3, device="cuda").sum().item() == 3


def test_scratch_a_graph_captured_outlives_a_larger_eager_call(gen):
    """A split-K matmul captured at M = 1, then an eager call whose plan
    needs more arrival counters than the captured buffer holds: the buffer
    the graph captured is kept (not freed to the allocator, where another
    tensor would take it), so a replay still gives the eager result."""
    packed, scale = _int4_weights(gen, 4096, 4096)
    x = torch.randn((1, 4096), device="cuda", generator=gen).to(torch.bfloat16)
    want = QM.int4g32_matmul(x, packed, scale)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        y = QM.int4g32_matmul(x, packed, scale)
    held = _build.scratch("splitk_arrivals", x.device, 1, torch.int32)
    wide_packed, wide_scale = _int4_weights(gen, 256, 131072)
    assert -(-131072 // (8 * QM.splitk_plan(9, 256, 131072)[1])) == 2048  # column tiles
    QM.int4g32_matmul(torch.randn((9, 256), device="cuda", generator=gen).to(torch.bfloat16),
                      wide_packed, wide_scale)
    assert _build.scratch("splitk_arrivals", x.device, 1, torch.int32) is not held
    shape = held.shape
    del held  # only the scratch's own record may keep it alive now
    junk = [torch.full(shape, 5, dtype=torch.int32, device="cuda") for _ in range(8)]
    for _ in range(2):
        y.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(y, want)
    assert all((j == 5).all() for j in junk)  # no replay wrote into another tensor
    assert len(_build._HELD) > 0


def test_top_p_draws_advance_through_replays(gen):
    """A sampled decode program draws from its registered generator: the
    captured replays draw anew each step, and reseeding the generator
    repeats the eager run's tokens exactly."""
    from chatglm_q_tpu_torch import TorchRuntimeConfig
    from chatglm_q_tpu_torch.models import chatglm2 as M

    cfg, params = _depth2_tree(gen)
    bf16 = torch.bfloat16
    ids = torch.randint(0, cfg.vocab_size, (2, 16), device="cuda", generator=gen)
    cache = M.init_kv_cache(cfg, 2, 128, bf16)
    logits, cache = M.prefill(params, cfg, ids, torch.tensor([16, 9], dtype=torch.int32,
                                                              device="cuda"), cache, "int4g32", bf16)
    first = torch.argmax(logits, -1).to(torch.int32)
    sg = torch.Generator(device="cuda")
    runs = []
    for graphs in (False, True, True):
        sg.manual_seed(9)
        c = M.KVCache(cache.k.clone(), cache.v.clone(), cache.lengths.clone())
        toks, _ = M.multi_step_decode(params, cfg, first, c, 12, sg, "int4g32", bf16,
                                      TorchRuntimeConfig(cuda_graphs=graphs), top_k=100,
                                      top_p=0.95, temperature=5.0)
        runs.append(toks)
    assert torch.equal(runs[0], runs[1]) and torch.equal(runs[1], runs[2])
    assert len(set(runs[1][0].tolist())) > 3  # the draws move from step to step


# ---------------------------------------------------------------------------
# GPTQ's column sweep (csrc/gptq.cu): bit-equal to its plain version
# ---------------------------------------------------------------------------

def _sweep_factor(gen, bs):
    """The upper Cholesky factor of H⁻¹ for a random positive-definite H."""
    a = torch.randn((bs, 2 * bs), device="cuda", generator=gen)
    h = a @ a.T / bs + 0.01 * torch.eye(bs, device="cuda")
    return torch.linalg.cholesky(torch.cholesky_inverse(torch.linalg.cholesky(h)), upper=True)


@pytest.mark.parametrize("kind,N,bs", [(k, n, b) for k in ("int8", "int4")
                                       for n, b in ((4099, 128), (37, 96), (8, 32), (1000, 64))]
                         + [("int8", 300, 100)])
def test_gptq_sweep_bit_equal_to_plain(gen, kind, N, bs):
    """One block (a strided column slice, a dead column, N not a multiple
    of the 12 rows a block sweeps at once): the kernel and the per-column
    loop give the same bits, and two launches give the same bits."""
    from chatglm_q_tpu_torch.ops import gptq_sweep as GS

    full = torch.randn((N, bs + 24), device="cuda", generator=gen)
    full[:, 24 + 5] = 0.0
    w = full[:, 24:]
    u = _sweep_factor(gen, bs)
    scale = None if kind == "int4" else torch.clamp(w.abs().amax(dim=1) / 127, min=1e-10)
    got = GS.gptq_sweep_block(w, u, scale)
    again = GS.gptq_sweep_block(w, u, scale)
    want = GS.gptq_sweep_block_plain(w, u, scale)
    on_cpu = GS.gptq_sweep_block_plain(w.cpu(), u.cpu(), None if scale is None else scale.cpu())
    torch.cuda.synchronize()
    assert len(got) == len(want) == (4 if kind == "int4" else 3)
    for a, b, c, d in zip(got, again, want, on_cpu):
        assert a.shape == c.shape and a.dtype == torch.float32
        assert torch.equal(a, b) and torch.equal(a, c) and torch.equal(a.cpu(), d)
    assert torch.all(got[0][:, 5] == 0)


@pytest.mark.parametrize("kind", ["int8", "int4"])
def test_gptq_sweep_whole_linear_bit_equal_with_a_short_last_block(gen, kind):
    """quant/gptq.py's sweep over K = 416 (three blocks of 128 and one of
    32): one launch a block, the same grid, losses and scales as the plain
    loop's."""
    from chatglm_q_tpu_torch import ops
    from chatglm_q_tpu_torch.ops import gptq_sweep as GS
    from chatglm_q_tpu_torch.quant import gptq as TG

    N, K = 520, 416
    w = torch.randn((N, K), device="cuda", generator=gen)
    u = _sweep_factor(gen, K)
    scale = None if kind == "int4" else torch.clamp(w.abs().amax(dim=1) / 127, min=1e-10)
    ops.reset_launch_counts()
    got = TG.sweep(w, u, scale, 128, 32, GS.gptq_sweep_block)
    counts = ops.launch_counts()
    want = TG.sweep(w, u, scale, 128, 32, GS.gptq_sweep_block_plain)
    torch.cuda.synchronize()
    assert counts["gptq_sweep_int4" if kind == "int4" else "gptq_sweep_int8"] == 4
    for a, b in zip(got, want):
        assert (a is None and b is None) or torch.equal(a, b)


@pytest.mark.parametrize("kind", ["int8", "int4"])
def test_rtn_on_the_card_equals_the_cpu(gen, kind):
    """The RTN quantizers give the CPU's (and so the JAX package's) bits on
    the card: every scale divides by 127 or 7 correctly rounded (PyTorch's
    CUDA division by a Python number multiplies by its reciprocal)."""
    from chatglm_q_tpu_torch.ops import quant as Q

    w = torch.randn((4096, 1024), device="cuda", generator=gen) * 0.02
    fn = Q.rtn_quantize_int8 if kind == "int8" else Q.rtn_quantize_int4
    q, s = fn(w)
    q_cpu, s_cpu = fn(w.cpu())
    assert torch.equal(s.cpu(), s_cpu) and torch.equal(q.cpu(), q_cpu)


def test_gptq_sweep_rejects_what_it_cannot_take(gen):
    from chatglm_q_tpu_torch.ops import gptq_sweep as GS

    w = torch.randn((16, 160), device="cuda", generator=gen)
    with pytest.raises(ValueError):  # wider than 128 columns
        GS.gptq_sweep_block(w, torch.eye(160, device="cuda"), w.abs().amax(dim=1))
    with pytest.raises(ValueError):  # int4 block not whole groups
        GS.gptq_sweep_block(w[:, :48], torch.eye(48, device="cuda"), None)
    with pytest.raises(ValueError):  # f16
        GS.gptq_sweep_block(w[:, :64].half(), torch.eye(64, device="cuda"), None)

"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: without a GPU every test here skips (decided inside the
fixture, never at import).  On a machine with one:

    python -m pytest tests/test_torch_cuda.py -q

Shapes cover the edges the main path does not: odd M, N not a multiple of
the tile, f32 activations for the matmuls, fewer heads per group, the M
where a matmul switches from its split-K kernel to its tensor-core kernel,
and an all-zero activation row (the 1e-10 clamp of the dynamic scale).
B7 (``int8_dyn_matmul``) is held bit-exact: its int32 sums are exact.  The
attention kernels and the KV write take bf16, f16 or f32 activations over
a cache of their dtype or of float8_e4m3fn; each fp8 form is bit-equal to
its bf16 (f16, f32) form on the upcast cache, and the cast on write
byte-equal to ``kv_store_cast``.  The tolerance is the bf16 one of
chip_smoke.py (1e-2 of max|plain|; f32 1e-5): kernels and plain versions
sum the same exact products in another order.  The f16 forms are held to
chip_smoke.py's f16 limits, the f32 forms (the last section) to 1e-5.
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
                        y.data_ptr(), ws.data_ptr(), arrivals.data_ptr(), 100, 1024, 512,
                        _build.dtype_code(x.dtype), bm, nsplit, gps, 8, _build.stream_ptr(x))


def test_int4g32_routes_by_m_and_dtype(gen):
    packed, scale = _int4_weights(gen, 1024, 512)
    cases = [(QM.SMALL_M_MAX, torch.bfloat16, QM.int4g32_splitk),
             (QM.SMALL_M_MAX + 1, torch.bfloat16, QM.int4g32_mma),
             (1, torch.float32, QM.int4g32_splitk),
             (QM.F32_SPLITK_MAX + 1, torch.float32, QM.int4g32_mma)]
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
                    9, 64, 16, _build.dtype_code(x9.dtype), 1, 16, 1, 2, 8,
                    _build.stream_ptr(x9))


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
    """Named for the refusal it held until float32 was ported: f32
    activations over an f32 cache now run the kernels' f32 form (form 4):
    decode, prefill and the write-only store against their plain versions
    (within the f32 limit; the store bit-equal)."""
    q = torch.randn((1, 2, 16, 128), device="cuda", generator=gen)
    k = torch.randn((1, 2, 8, 128), device="cuda", generator=gen)
    v = torch.randn((1, 2, 8, 128), device="cuda", generator=gen)
    lengths = torch.tensor([5], dtype=torch.int32, device="cuda")
    got = A.flash_attention_decode(q, k, v, lengths, 0.1)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32
    assert _rel(got, A.flash_attention_decode_plain(q, k, v, lengths, 0.1)) <= 1e-5
    qp = torch.randn((1, 8, 2, 16, 128), device="cuda", generator=gen)
    got = A.flash_attention_prefill(qp, k, v, lengths + 1, 0.1)
    torch.cuda.synchronize()
    assert _rel(got, A.flash_attention_prefill_plain(qp, k, v, lengths + 1, 0.1)) <= 1e-5
    cache, ref = k[None].clone(), k[None].clone()
    A.kv_cache_write_idx(cache, q[:, :, 0], 0, lengths)
    A.kv_cache_write_idx_plain(ref, q[:, :, 0], 0, lengths)
    torch.cuda.synchronize()
    assert torch.equal(cache, ref)


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
        mid = [_build.dtype_code(y.dtype)]  # x's (B6) or y's (B7 / B8) dtype code
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
# split-K / tensor-core switch, N = 264 (not a multiple of 16: the split-K
# kernel's 8-byte loads), the storage K of w_out, and the lm_head's N; the
# split-K kernel's bf16 rows at the six linears follow (T_SPLITK_*).
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
    plain versions: the split-K tensor-core kernel at M = 8, the Hopper one
    at 256) and its grad_x agrees with the plain path's; K = 4000 is stored
    padded to 4096 and comes back stripped."""
    from chatglm_q_tpu_torch import TorchRuntimeConfig
    from chatglm_q_tpu_torch.ops import linear as TL

    K, Ks, N = 4000, 4096, 1024
    if quant == "int8":
        w, scale = _int8_weights(gen, Ks, N)
        w[K:] = 0
        params, kernels = {"weight": w, "weight_scale": scale}, ("int8_t_splitk", "int8_t_mma")
        plain_name = "int8_matmul_t_plain"
    else:
        packed = torch.randint(0, 256, (Ks // 2, N), dtype=torch.uint8, device="cuda",
                               generator=gen)
        packed[K // 2:] = 0
        scale = (torch.rand((Ks // 32, N), device="cuda", generator=gen) * 0.02).to(torch.bfloat16)
        params, kernels = {"weight": packed, "weight_scale": scale}, ("int4g32_t_splitk",
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


# T_EDGES' bf16 rows of the transposed split-K kernel (B13 / B14 at M <=
# 16): the six linears' (K, N) at M = 2, 4, 8, 9 (two m-tiles) and 16
T_SPLITK_LINEARS = [(4096, 4096), (4096, 512), (4096, 4096), (4096, 13824), (13824, 4096),
                    (4096, 65536)]
T_SPLITK_M = (2, 4, 8, 9, 16)


def _t_splitk_case(gen, kind, M, K, N):
    """(call, its wrapper, plain version, exact f64 value and f64
    sum|terms|) of one transposed matmul at bf16 g (M, N) on random
    inputs, with a zero row."""
    g = _x(gen, M, N, torch.bfloat16)
    if kind == "int8":
        w, scale = _int8_weights(gen, K, N)
        gs, w64 = (g * scale.to(torch.bfloat16)).double(), w.double()
        return (lambda: I8.int8_matmul_t(g, w, scale), I8.int8_t_splitk,
                lambda: I8.int8_matmul_t_plain(g, w, scale),
                lambda: (gs @ w64.T, gs.abs() @ w64.abs().T))
    packed, scale = _int4_t_weights(gen, K, N)
    w64 = QM.unpack_int4_tpu(packed, scale).to(torch.bfloat16).double()  # bf16(q·s)
    return (lambda: QM.int4g32_matmul_t(g, packed, scale), QM.int4g32_t_splitk,
            lambda: QM.int4g32_matmul_t_plain(g, packed, scale),
            lambda: (g.double() @ w64.T, g.double().abs() @ w64.abs().T))


@pytest.mark.parametrize("K,N", T_SPLITK_LINEARS)
@pytest.mark.parametrize("M", T_SPLITK_M)
@pytest.mark.parametrize("kind", ["int8", "int4g32"])
def test_t_splitk_error_is_its_bf16_rounding(gen, kind, M, K, N):
    """One launch of the split-K kernel, within the bf16 tolerance of the
    plain version and within 2^-23 of sum|terms| of the exact value beyond
    half a bf16 ulp; the zero row stays zero."""
    call, kernel, plain, exact = _t_splitk_case(gen, kind, M, K, N)
    before = kernel.launches
    got = call()
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    assert got.dtype == torch.bfloat16 and got.shape == (M, K)
    assert torch.isfinite(got.float()).all() and not got[M // 2].any()
    assert _rel(got, plain()) <= 1e-2
    assert _beyond_sum(got, *exact()) <= 2.0 ** -23


@pytest.mark.parametrize("M,K,N", [(16, 4096, 4096), (1, 4096, 512), (9, 13824, 4096),
                                   (3, 256, 264), (40, 4000, 264)])
@pytest.mark.parametrize("kind", ["int8", "int4g32"])
def test_t_splitk_is_deterministic_and_replays_in_a_graph(gen, kind, M, K, N):
    """Two calls are bit-equal and leave every arrival counter at 0; one call
    captured in a CUDA graph and replayed twice is bit-equal to the eager
    call (N = 264: the 8-byte loads; M = 40: three 16-row blocks in
    grid.z)."""
    call, kernel, _, exact = _t_splitk_case(gen, kind, M, K, N)
    before = kernel.launches
    first, second = call(), call()
    torch.cuda.synchronize()
    assert kernel.launches == before + 2
    assert torch.equal(first, second)
    assert _beyond_sum(first, *exact()) <= 2.0 ** -23
    tiles = -(-K // QM.TSK_ROWS) * -(-M // QM.TSK_MROWS)
    assert not _build.scratch("splitk_arrivals", first.device, tiles, torch.int32)[:tiles].any()
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


@pytest.mark.parametrize("entry", ["chatglm_int8_t_splitk", "chatglm_int4_t_splitk"])
def test_t_splitk_refuses_a_plan_it_cannot_take(gen, entry):
    """More rows than the plan's m-tiles hold, splits short of N, a stage
    of other than 4k chunks: refused at the launch, never run."""
    g = torch.zeros((16, 512), dtype=torch.bfloat16, device="cuda")
    w = torch.zeros((256, 512), dtype=torch.int8, device="cuda")
    scale = torch.ones((256, 512), device="cuda")  # bytes enough for either scale
    out = torch.empty((16, 256), dtype=torch.bfloat16, device="cuda")
    ws = torch.zeros((1 << 16,), device="cuda")
    arrivals = torch.zeros((16,), dtype=torch.int32, device="cuda")
    for plan in ((1, 2, 4, 4), (2, 1, 4, 4), (2, 2, 4, 6)):
        with pytest.raises(RuntimeError):
            _build.call(entry, g.data_ptr(), w.data_ptr(), scale.data_ptr(), out.data_ptr(),
                        ws.data_ptr(), arrivals.data_ptr(), 16, 256, 512,
                        _build.dtype_code(g.dtype), *plan, _build.stream_ptr(g))


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


# The shard shapes of a tp = 2 training step at 6B widths (2 x 256 tokens a
# rank; chip_smoke.py's TP2_SHAPES): q_proj's columns, o_proj's storage rows,
# w_in's columns on rank 0 and on rank 1 (the split ends where the logical
# 13696 do), w_out's storage rows on rank 1 (their last 128 the storage
# padding) and the lm_head's columns.
TP2_LINEARS = [(4096, 2048), (2048, 4096), (4096, 6912), (4096, 6784), (6912, 4096),
               (4096, 32768)]


@pytest.mark.parametrize("K,N", TP2_LINEARS)
@pytest.mark.parametrize("kind", ["int4g32", "int8", "int4g32_t", "int8_t"])
def test_tp2_shard_matmuls_error_is_their_bf16_rounding(gen, kind, K, N):
    """B1 and B6 forward, B14 and B13 backward at M = 512 on every tp = 2
    shard shape: one Hopper launch each, within the bf16 tolerance of the
    plain version and 2^-23 of sum|terms| beyond the output's rounding."""
    M = 512
    if kind == "int4g32":
        packed, scale = _int4_weights(gen, K, N)
        x = torch.randn((M, K), device="cuda", generator=gen).to(torch.bfloat16)
        w64 = QM.unpack_int4_tpu(packed, scale).double()
        call, kernel = (lambda: QM.int4g32_matmul(x, packed, scale)), QM.int4g32_mma
        plain = lambda: QM.int4g32_matmul_plain(x, packed, scale)  # noqa: E731
        exact = lambda: (x.double() @ w64, x.double().abs() @ w64.abs())  # noqa: E731
    else:
        call, kernel, plain, exact = _wg_case(gen, kind, M, K, N)
    before = kernel.launches
    got = call()
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    assert got.shape == (M, K if kind.endswith("_t") else N)
    assert torch.isfinite(got.float()).all()
    assert _rel(got, plain()) <= 1e-2
    assert _beyond_sum(got, *exact()) <= 2.0 ** -23


@pytest.mark.parametrize("quant", ["int4g32", "int8"])
def test_quant_matmul_backward_through_a_padded_row_shard(gen, quant):
    """The row shard of w_out that rank 1 of a tp = 2 mesh holds at 6B
    widths: 6784 logical K rows stored as 6912 (the last 128 the storage
    padding, zero).  QuantMatmul pads x to the storage K, runs B1 / B6, and
    its backward runs B14 / B13 and strips grad_x back to 6784 columns,
    within the bf16 tolerance of the plain path's grad."""
    from chatglm_q_tpu_torch import TorchRuntimeConfig
    from chatglm_q_tpu_torch.ops import linear as TL

    K, Ks, N, M = 6784, 6912, 4096, 512
    if quant == "int4g32":
        w, scale = _int4_weights(gen, Ks, N)
        w[K // 2:] = 0
        fns = (QM.int4g32_mma, QM.int4g32_t_mma)
    else:
        w, scale = _int8_weights(gen, Ks, N)
        w[K:] = 0
        fns = (I8.int8_mma, I8.int8_t_mma)
    params = {"weight": w, "weight_scale": scale}
    x0 = torch.randn((M, K), device="cuda", generator=gen).to(torch.bfloat16)
    g = torch.randn((M, N), device="cuda", generator=gen).to(torch.bfloat16)
    grads = {}
    for use_kernels in (False, True):
        before = [f.launches for f in fns]
        x = x0.clone().requires_grad_(True)
        y = TL.quant_linear(x, params, quant, TorchRuntimeConfig(use_kernels=use_kernels))
        y.backward(g)
        torch.cuda.synchronize()
        assert x.grad.shape == (M, K)
        assert [f.launches - b for f, b in zip(fns, before)] == ([1, 1] if use_kernels
                                                                 else [0, 0])
        grads[use_kernels] = x.grad
    assert _rel(grads[True], grads[False]) <= 1e-2


def test_interpret_kernels_and_nan_checks_on_the_card(gen):
    """Inside ``interpret_kernels`` a linear on CUDA tensors launches
    nothing and equals the plain path bit for bit; under
    ``enable_nan_checks`` a NaN in x makes the launch raise, naming B1's
    Hopper kernel, and a capture refuses the check."""
    from chatglm_q_tpu_torch import TorchRuntimeConfig
    from chatglm_q_tpu_torch.ops import launch_counts
    from chatglm_q_tpu_torch.ops import linear as TL
    from chatglm_q_tpu_torch.utils import debug

    packed, scale = _int4_weights(gen, 4096, 4096)
    params = {"weight": packed, "weight_scale": scale}
    x = torch.randn((128, 4096), device="cuda", generator=gen).to(torch.bfloat16)
    before = launch_counts()
    with debug.interpret_kernels():
        got = TL.quant_linear(x, params, "int4g32", TorchRuntimeConfig(use_kernels=True))
    assert launch_counts() == before
    assert torch.equal(got, TL.quant_linear(x, params, "int4g32",
                                            TorchRuntimeConfig(use_kernels=False)))
    x[3, 7] = float("nan")
    try:
        debug.enable_nan_checks()
        with pytest.raises(FloatingPointError, match="int4g32_mma"):
            QM.int4g32_matmul(x, packed, scale)
        x[3, 7] = 0.0
        QM.int4g32_matmul(x, packed, scale)  # warm-up outside the capture
        with pytest.raises(RuntimeError, match="NaN checks sync"):
            with torch.cuda.graph(torch.cuda.CUDAGraph()):
                QM.int4g32_matmul(x, packed, scale)
    finally:
        debug.enable_nan_checks(False)


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
                        1024, 1024, _build.dtype_code(a.dtype), bm, nsplit, sps, 8,
                        _build.stream_ptr(a))


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


def test_sampled_speculation_captured_equals_eager(gen):
    """The sampled verify step (``spec_accept_next`` in the program, draws
    from a generator registered with the graph) over 6 steps of a mixed
    batch, two rows greedy and two at temperature 0.8 / top-p 0.8:
    captured, its drafts, accepts and next tokens equal the eager steps' on
    one seed (twice), and its greedy rows equal the greedy program's."""
    from chatglm_q_tpu_torch import TorchRuntimeConfig
    from chatglm_q_tpu_torch.models import paged_kv as PK
    from chatglm_q_tpu_torch.models import spec_decode as SD

    cfg, params = _depth2_tree(gen)
    bf16, P, MP, T = torch.bfloat16, 256, 2, 512
    span = torch.randint(3, 60000, (12,), device="cuda", generator=gen)
    ids = torch.cat([span] * 5)[None].expand(4, -1).contiguous()  # 60 tokens, repeating
    lengths = torch.full((4,), 60, dtype=torch.int32, device="cuda")
    pool = PK.init_paged_kv_cache(cfg, 4, 9, MP * P, P, bf16)
    pool.page_table.copy_(torch.arange(1, 9, dtype=torch.int32, device="cuda").reshape(4, 2))
    logits, pool = PK.prefill_paged(params, cfg, ids, lengths, pool, "int4g32", bf16)
    first = torch.argmax(logits, -1).to(torch.int32)
    tokbuf = torch.zeros((4, T), dtype=torch.int32, device="cuda")
    tokbuf[:, :60] = ids
    rows = (torch.tensor([0.0, 0.8, 0.0, 0.8], device="cuda"),
            torch.full((4,), 0.8, device="cuda"),
            torch.full((4,), 100, dtype=torch.int32, device="cuda"))
    sg = torch.Generator(device="cuda")
    runs = []
    for graphs, sampled in ((False, True), (True, True), (True, True), (True, False)):
        sg.manual_seed(13)
        p = pool.replace(k_pool=pool.k_pool.clone(), v_pool=pool.v_pool.clone())
        kw = dict(generator=sg, sampling=rows) if sampled else {}
        d, a, n, _, _ = SD.speculative_decode_paged(
            params, cfg, first, p, tokbuf.clone(), 6, 8, 3, "int4g32", bf16,
            TorchRuntimeConfig(cuda_graphs=graphs), **kw)
        torch.cuda.synchronize()
        runs.append((d, a, n))
    for run in runs[1:3]:
        assert all(torch.equal(x, y) for x, y in zip(runs[0], run))
    for x, y in zip(runs[1], runs[3]):  # the greedy rows, 0 and 2
        assert torch.equal(x[:, 0::2], y[:, 0::2])


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


def reciprocal_split_rows():
    """chip_smoke.py's rows whose max|x| / 127 and max|x| times the f32
    reciprocal of 127 round apart (found on the host with numpy)."""
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.reciprocal_split_rows()


def test_dyn_quantize_rows_on_the_card_equals_the_cpu(gen):
    """The dynamic row quantizer's sx = max|x| / 127 is the correctly rounded
    quotient on the card, as on the CPU and in JAX, on rows where the
    reciprocal product rounds apart (which a Python-number divisor gives
    on the card: the control)."""
    x = torch.from_numpy(reciprocal_split_rows())
    for dtype in (torch.float32, torch.bfloat16):
        xc = x.to(dtype)
        xq, sx = D.dyn_quantize_rows(xc.cuda())
        xq_cpu, sx_cpu = D.dyn_quantize_rows(xc)
        assert torch.equal(sx.cpu(), sx_cpu) and torch.equal(xq.cpu(), xq_cpu)
    control = (x.cuda().abs().amax(dim=1, keepdim=True) / 127.0).cpu()
    assert (control != x.abs().amax(dim=1, keepdim=True) / 127.0).float().mean() > 0.5


def test_gptq_sweep_rejects_what_it_cannot_take(gen):
    from chatglm_q_tpu_torch.ops import gptq_sweep as GS

    w = torch.randn((16, 160), device="cuda", generator=gen)
    with pytest.raises(ValueError):  # wider than 128 columns
        GS.gptq_sweep_block(w, torch.eye(160, device="cuda"), w.abs().amax(dim=1))
    with pytest.raises(ValueError):  # int4 block not whole groups
        GS.gptq_sweep_block(w[:, :48], torch.eye(48, device="cuda"), None)
    with pytest.raises(ValueError):  # f16
        GS.gptq_sweep_block(w[:, :64].half(), torch.eye(64, device="cuda"), None)


# ---------------------------------------------------------------------------
# The prefill, chunk and training programs captured against eager; the
# exported decode step; a plan-table entry at the launch
# ---------------------------------------------------------------------------

PROG_CFG = dict(hidden_size=512, inner_hidden_size=1024, head_hidden_size=128,
                num_multi_query_groups=2, num_attention_heads=4, num_layers=2, vocab_size=1024,
                max_sequence_length=512)


def _prog_tree(gen, quant="int4g32"):
    from chatglm_q_tpu_torch import ChatGLM2Config
    from chatglm_q_tpu_torch.bench import random_quantized_params

    cfg = ChatGLM2Config(**PROG_CFG)
    return cfg, random_quantized_params(cfg, quant, gen)


def _rts():
    from chatglm_q_tpu_torch import TorchRuntimeConfig

    return {"captured": TorchRuntimeConfig(), "eager": TorchRuntimeConfig(cuda_graphs=False)}


def test_captured_prefill_equals_eager(gen):
    from chatglm_q_tpu_torch.models import chatglm2 as M

    cfg, params = _prog_tree(gen)
    ids = torch.zeros((2, 64), dtype=torch.long, device="cuda")
    ids[:, :57] = torch.randint(0, 1024, (2, 57), device="cuda", generator=gen)
    lengths = torch.tensor([57, 40], dtype=torch.int32, device="cuda")
    caches = {k: M.init_kv_cache(cfg, 2, 256, torch.bfloat16) for k in ("captured", "eager")}
    progs = {k: M.prefill_program(params, cfg, caches[k], 64, "int4g32", torch.bfloat16, r)
             for k, r in _rts().items()}
    for _ in range(3):  # warm-up, capture, replay
        out = {}
        for k, prog in progs.items():
            prog.load(ids=ids, lengths=lengths)
            out[k] = prog.step(params, caches[k].k, caches[k].v)["logits"].clone()
        assert torch.equal(out["captured"], out["eager"])
    assert progs["captured"].graph is not None and progs["captured"].replays == 2
    for row, n in enumerate(lengths.tolist()):
        for part in ("k", "v"):
            a, b = getattr(caches["captured"], part), getattr(caches["eager"], part)
            assert torch.equal(a[:, row, :, :n], b[:, row, :, :n])


def test_captured_chunk_steps_equal_eager(gen):
    from chatglm_q_tpu_torch.models import chatglm2 as M
    from chatglm_q_tpu_torch.models import paged_kv as PK

    cfg, params = _prog_tree(gen)
    ids = torch.randint(0, 1024, (2, 32), device="cuda", generator=gen)
    starts = torch.tensor([0, 64], dtype=torch.int32, device="cuda")  # page-aligned
    valid = torch.tensor([32, 20], dtype=torch.int32, device="cuda")
    slots = torch.tensor([1, 3], dtype=torch.int32, device="cuda")
    table = torch.arange(1, 9, dtype=torch.int32, device="cuda").reshape(2, 4)
    out = {}
    for k, rt in _rts().items():
        cache = M.init_kv_cache(cfg, 4, 256, torch.bfloat16)
        pool = PK.init_paged_kv_cache(cfg, 2, 12, 256, 64, torch.bfloat16)
        dense = M.chunk_program(params, cfg, cache, 2, 32, "int4g32", torch.bfloat16, rt)
        paged = PK.chunk_paged_program(params, cfg, pool, 2, 32, "int4g32", torch.bfloat16, rt)
        res = []
        for _ in range(3):
            dense.load(ids=ids, starts=starts, valid=valid, slot_map=slots, lengths=cache.lengths)
            paged.load(ids=ids, starts=starts, valid=valid, page_table=table)
            res.append(dense.step(params, cache.k, cache.v)["logits"].clone())
            res.append(paged.step(params, pool.k_pool, pool.v_pool)["logits"].clone())
        out[k] = (res, cache, pool)
        if k == "captured":
            assert dense.replays == 2 and paged.replays == 2
    for a, b in zip(out["captured"][0], out["eager"][0]):
        assert torch.equal(a, b)
    assert torch.equal(out["captured"][1].k, out["eager"][1].k)
    assert torch.equal(out["captured"][2].v_pool[:, 1:9], out["eager"][2].v_pool[:, 1:9])


def test_dense_engine_whole_prompts_one_captured_program_a_bucket(gen):
    """The dense engine's whole-prompt admission over four slots: one
    prefill program a bucket (a one-row chunk, the slot its map), captured
    and replayed, and the greedy tokens of the eager engine."""
    from chatglm_q_tpu_torch import GLMLoadConfig
    from chatglm_q_tpu_torch.models import chatglm2 as M
    from chatglm_q_tpu_torch.serving import ServingEngine
    from chatglm_q_tpu_torch.utils import graphs as G

    cfg, params = _prog_tree(gen)
    load = GLMLoadConfig(model_config=cfg, quant_type="int4g32", torch_dtype="bfloat16")
    lens = (9, 14, 40, 12, 50, 11)  # buckets 16 (4 prompts) and 64 (2)
    prompts = [torch.randint(1, 1024, (n,), generator=torch.Generator().manual_seed(n)).tolist()
               for n in lens]
    out = {}
    for k, rt in _rts().items():
        eng = ServingEngine(load, params, None, max_batch=4, max_seq_len=256, decode_chunk=4,
                            rt=rt, device="cuda")
        reg = G.programs(params, "prefill")
        before = set(reg._programs)
        out[k] = eng.run(prompts, max_new_tokens=6, temperature=0.0)
        new = [reg._programs[key] for key in reg._programs if key not in before]
        assert len(new) == len({M.prompt_bucket(n, 256) for n in lens})
        if k == "captured":
            assert all(p.graph is not None for p in new) and sum(p.replays for p in new) == 4
    assert out["captured"] == out["eager"] and all(len(t) == 6 for t in out["eager"])


@pytest.mark.parametrize("quant", ["int4g32", "int8"])
def test_captured_training_step_equals_eager_over_3_steps(gen, quant):
    from chatglm_q_tpu_torch.utils.train import (make_train_step, partition_params,
                                                 trainable_leaves)

    cfg, params = _prog_tree(gen, quant)
    ids = torch.randint(0, 1024, (2, 64), device="cuda", generator=gen)
    labels = ids.clone()
    labels[:, :8] = -100
    losses = {}
    for k, rt in _rts().items():
        tr, fr = partition_params(params)
        opt = torch.optim.AdamW(trainable_leaves(tr), lr=1e-3, capturable=True)
        step = make_train_step(cfg, quant, opt, torch.bfloat16, rt)
        losses[k] = [step(tr, fr, ids, labels).item() for _ in range(3)]
    assert losses["captured"] == losses["eager"] and all(math.isfinite(x) for x in losses["eager"])


@pytest.mark.parametrize("lr", ["float", "tensor"])
def test_captured_training_step_follows_a_scheduled_lr(gen, lr):
    """A LambdaLR stepped between calls: the captured step's losses and
    leaves equal the eager step's over 4 steps.  A float lr is captured
    again at each change (three more captures); a tensor lr, filled in
    place by the scheduler, stays in the one graph."""
    from chatglm_q_tpu_torch.utils import graphs as G
    from chatglm_q_tpu_torch.utils.train import (make_train_step, merge_params,
                                                 partition_params, trainable_leaves)

    cfg, params = _prog_tree(gen)
    ids = torch.randint(0, 1024, (2, 64), device="cuda", generator=gen)
    labels = ids.clone()
    labels[:, :8] = -100
    out = {}
    for k, rt in _rts().items():
        tr, fr = partition_params(params)
        opt = torch.optim.AdamW(trainable_leaves(tr), capturable=True,
                                lr=1e-3 if lr == "float" else torch.tensor(1e-3, device="cuda"))
        sched = torch.optim.lr_scheduler.LambdaLR(opt, lambda i: 1.0 / (1 + i))
        step = make_train_step(cfg, "int4g32", opt, torch.bfloat16, rt)
        reg = G.programs(merge_params(tr, fr), "train")
        losses = []
        for _ in range(4):
            losses.append(step(tr, fr, ids, labels).item())
            sched.step()
        out[k] = (losses, trainable_leaves(tr), reg.captures)
    assert out["captured"][0] == out["eager"][0]
    for a, b in zip(out["captured"][1], out["eager"][1]):
        assert torch.equal(a, b)
    assert out["captured"][2] == (3 if lr == "float" else 1) and out["eager"][2] == 0


@pytest.mark.parametrize("quant", ["int4g32", "int8"])
def test_exported_decode_step_round_trips_bit_equal(gen, quant, tmp_path):
    from chatglm_q_tpu_torch.examples import export as EX

    cfg, params = _prog_tree(gen, quant)
    cache, ids = EX.prefilled_cache(params, cfg, quant, torch.bfloat16, 2, 128, "cuda")
    res = EX.round_trip(params, cfg, quant, torch.bfloat16, cache, ids, str(tmp_path / "s.pt2"))
    assert all(res["equal"].values()), res["equal"]
    assert "chatglm_q_tpu_torch.rope_kv_append.default" in res["ops"]


def test_a_recorded_plan_reaches_the_launch(gen, tmp_path, monkeypatch):
    from chatglm_q_tpu_torch.ops import autotune as AT

    monkeypatch.setenv(AT.ENV, str(tmp_path / "table.json"))
    AT.reload()
    try:
        plan = (1, 8, 8, 16, 16)
        assert plan != QM.builtin_splitk_plan(1, 4096, 4096)
        AT.record("int4_splitk", 8, 4096, 4096, plan)
        calls, call = [], _build.call
        monkeypatch.setattr(_build, "call", lambda name, *a: (calls.append(a), call(name, *a)))
        packed = torch.randint(0, 256, (2048, 4096), dtype=torch.uint8, device="cuda",
                               generator=gen)
        scale = (torch.rand((128, 4096), device="cuda", generator=gen) * 0.02).to(torch.bfloat16)
        for M in (1, 8):  # the entry of bucket m8 serves M = 1 to 8
            x = torch.randn((M, 4096), device="cuda", generator=gen).to(torch.bfloat16)
            got = QM.int4g32_matmul(x, packed, scale)
            assert tuple(calls[-1][10:15]) == plan  # after M, K, N and the dtype code
            assert _rel(got, QM.int4g32_matmul_plain(x, packed, scale)) <= 1e-2
    finally:
        AT.reload()


# ---------------------------------------------------------------------------
# The float8_e4m3fn cache: every attention kernel's fp8 form
# ---------------------------------------------------------------------------

FP8 = torch.float8_e4m3fn


def _fp8(gen, shape, scale=1.0):
    """A random fp8 cache tensor (through the port's store) and its exact
    bf16 upcast."""
    x = torch.randn(shape, device="cuda", generator=gen) * scale
    k8 = A.kv_store_cast(x, FP8)
    return k8, k8.to(torch.bfloat16)


def _bytes_equal(a, b):
    return torch.equal(a.view(torch.uint8), b.view(torch.uint8))


def test_fp8_store_on_the_card_equals_kv_store_cast_over_every_bf16_pattern(gen):
    """All 65,536 bf16 patterns (NaN, inf, past ±448, subnormals, ±0)
    through the write-only append (B3) and the fused append's v (B9's
    pool), byte for byte against ``kv_store_cast`` on the card and on the
    CPU."""
    bits = torch.arange(65536, dtype=torch.int32, device="cuda").to(torch.int16)
    x = bits.view(torch.bfloat16).reshape(256, 2, 128)
    want = A.kv_store_cast(x, FP8)
    assert _bytes_equal(want.cpu(), A.kv_store_cast(x.cpu(), FP8))
    cache = A.kv_zeros((2, 256, 2, 4, 128), FP8, "cuda")
    starts = torch.full((256,), 3, dtype=torch.int32, device="cuda")
    before = A.kv_cache_write_idx.fp8.launches
    A.kv_cache_write_idx(cache, x, 1, starts)
    torch.cuda.synchronize()
    assert A.kv_cache_write_idx.fp8.launches == before + 1
    assert _bytes_equal(cache[1, :, :, 3], want)
    assert not cache[0].view(torch.uint8).any() and not cache[1, :, :, :3].view(torch.uint8).any()
    # the fused append's v half (v is not rotated) into a pool of one page a row
    q = torch.zeros((256, 2, 16, 128), dtype=torch.bfloat16, device="cuda")
    kv = torch.cat([torch.zeros_like(x), x], dim=1).reshape(256, 512)
    freqs = torch.zeros((256, 128), dtype=torch.bfloat16, device="cuda")
    kp, vp = (A.kv_zeros((1, 257, 2, 16, 128), FP8, "cuda") for _ in range(2))
    pt = torch.arange(1, 257, dtype=torch.int32, device="cuda")[:, None]
    A.rope_kv_append(q, kv, freqs, kp, vp, 0, torch.full((256,), 5, dtype=torch.int32,
                                                          device="cuda"), pt)
    torch.cuda.synchronize()
    assert _bytes_equal(vp[0, 1:, :, 5], want)


@pytest.mark.parametrize("kind", ["decode", "decode_v2", "paged", "chunk", "prefill"])
def test_fp8_read_is_exact_for_all_256_bytes(gen, kind):
    """V slot 0 of two groups holds all 256 bytes, K is 0, one valid slot:
    p = 1 exactly, so each head outputs its group's V row as the kernel
    read it: the exact upcast of every non-NaN byte (subnormals included),
    NaN where the byte is NaN."""
    B, G, Hg, D, T = 1, 2, 4, 128, 64
    v8 = A.kv_zeros((B, G, T, D), FP8, "cuda")
    v8.view(torch.uint8)[0, :, 0] = torch.arange(256, device="cuda").to(torch.uint8).reshape(2, 128)
    k8 = A.kv_zeros((B, G, T, D), FP8, "cuda")
    want = v8[0, :, 0].to(torch.bfloat16)  # (G, D)
    q = torch.randn((B, G, Hg, D), device="cuda", generator=gen).to(torch.bfloat16)
    zero = torch.zeros((B,), dtype=torch.int32, device="cuda")
    if kind in ("decode", "decode_v2"):
        fn = A.flash_attention_decode if kind == "decode" else A.flash_attention_decode_v2
        out = fn(q, k8, v8, zero, 0.1)[0]  # (G, Hg, D)
    elif kind == "prefill":
        out = A.flash_attention_prefill(q[:, None], k8, v8, zero + 1, 0.1)[0, 0]
    else:
        kp, vp = k8[None], v8[None]  # a pool of one page of T rows
        pt = torch.zeros((1, 1), dtype=torch.int32, device="cuda")
        if kind == "paged":
            out = A.flash_attention_decode_paged(q, kp, vp, 0, pt, zero, 0.1)[0]
        else:
            out = A.flash_attention_chunk_paged(q[:, None], kp, vp, 0, pt, zero, 0.1)[0, 0]
    torch.cuda.synchronize()
    got = out.float()
    ref = want.float()[:, None].expand_as(got)
    nan = torch.isnan(ref)
    assert nan.sum() == 2 * Hg  # 0x7F and 0xFF, in every head of their group
    assert torch.equal(torch.isnan(got), nan)
    assert torch.equal(got[~nan], ref[~nan])


@pytest.mark.parametrize("B,T", [(6, 200), (10, 1000)])
@pytest.mark.parametrize("kind", ["decode", "decode_v2", "lse"])
def test_fp8_decode_forms_equal_the_bf16_form_on_the_upcast_cache(gen, kind, B, T):
    """B4, B12 and K1 over an fp8 cache: bit-equal to the same kernel over
    the cache upcast to bf16 (the tiling is shared), and within the bf16
    forms' limit of the plain version."""
    G, Hg, D = 2, 16, 128
    q = torch.randn((B, G, Hg, D), device="cuda", generator=gen).to(torch.bfloat16)
    (k8, k16), (v8, v16) = _fp8(gen, (B, G, T, D)), _fp8(gen, (B, G, T, D))
    lengths = _decode_edges(B, T, A.decode_span(B * G, T, A.DECODE_BLOCK_K))
    sm = 1 / math.sqrt(D)
    fn, plain = {"decode": (A.flash_attention_decode, A.flash_attention_decode_plain),
                 "decode_v2": (A.flash_attention_decode_v2, A.flash_attention_decode_v2_plain),
                 "lse": (lambda *a: A.flash_attention_decode_lse(*a, T // 2),
                         lambda *a: A.flash_attention_decode_lse_plain(*a, T // 2))}[kind]
    wrapper = {"decode": A.flash_attention_decode, "decode_v2": A.flash_attention_decode_v2,
               "lse": A.flash_attention_decode_lse}[kind]
    before = wrapper.fp8.launches
    got = fn(q, k8, v8, lengths, sm)
    same = fn(q, k16, v16, lengths, sm)
    torch.cuda.synchronize()
    assert wrapper.fp8.launches == before + 1
    pairs = zip(got, same) if kind == "lse" else [(got, same)]
    assert all(torch.equal(a, b) for a, b in pairs)
    want = plain(q, k8, v8, lengths, sm)
    if kind == "lse":
        _hold_lse(got, want)
    else:
        assert _rel(got, want) <= 1e-2


@pytest.mark.parametrize("P,MP", [(16, 64), (256, 4)])
def test_fp8_paged_forms_equal_the_bf16_form_on_the_upcast_pool(gen, P, MP):
    """B10, K2 (each phase of a stride-2 table) and B11 (S = 1, 9, 32, with
    a row map) over an fp8 pool: bit-equal to the bf16 form on the upcast
    pool, within their limits of the plain version."""
    L, G, Hg, D = 2, 2, 16, 128
    B = 10
    NP = B * MP + 1
    (kp8, kp16), (vp8, vp16) = _fp8(gen, (L, NP, G, P, D)), _fp8(gen, (L, NP, G, P, D))
    pt = _scattered_table(gen, B, MP, NP)
    lengths = _paged_decode_edges(P, MP, B)
    sm = 1 / math.sqrt(D)
    q = torch.randn((B, G, Hg, D), device="cuda", generator=gen).to(torch.bfloat16)
    got = A.flash_attention_decode_paged(q, kp8, vp8, 1, pt, lengths, sm)
    assert torch.equal(got, A.flash_attention_decode_paged(q, kp16, vp16, 1, pt, lengths, sm))
    assert _rel(got, A.flash_attention_decode_paged_plain(q, kp8, vp8, 1, pt, lengths, sm)) <= 1e-2
    half = pt[:, ::2].contiguous()
    for phase in (0, 1):
        got = A.flash_attention_decode_paged_lse(q, kp8, vp8, 1, half, lengths, sm, 2, phase)
        same = A.flash_attention_decode_paged_lse(q, kp16, vp16, 1, half, lengths, sm, 2, phase)
        assert all(torch.equal(a, b) for a, b in zip(got, same))
        _hold_lse(got, A.flash_attention_decode_paged_lse_plain(q, kp8, vp8, 1, half, lengths,
                                                                sm, 2, phase))
    starts = torch.tensor([0, P - 2, 300, MP * P - 40, 7], dtype=torch.int32, device="cuda")
    rmap = torch.tensor([5, 0, 3, 1, 2], dtype=torch.int32, device="cuda")
    for S in (1, 9, 32):
        qc = torch.randn((5, S, G, Hg, D), device="cuda", generator=gen).to(torch.bfloat16)
        got = A.flash_attention_chunk_paged(qc, kp8, vp8, 0, pt, starts, sm, rmap)
        same = A.flash_attention_chunk_paged(qc, kp16, vp16, 0, pt, starts, sm, rmap)
        torch.cuda.synchronize()
        assert torch.equal(got, same), S
        want32 = _chunk_paged_f32(qc, kp16, vp16, 0, pt, starts, sm, rmap)
        assert _beyond_rounding(got, want32) <= B11_TOL


@pytest.mark.parametrize("chunked", [False, True])
@pytest.mark.parametrize("Hg", [16, 4])
def test_fp8_prefill_forms_equal_the_bf16_form_on_the_upcast_cache(gen, Hg, chunked):
    """B5 (whole prompt, and the chunked form with a row map) over an fp8
    cache: bit-equal to the bf16 form on the upcast cache."""
    G, D, T, S = 2, 128, 512, 64 if chunked else 130
    Bk = 4 if chunked else 3
    (k8, k16), (v8, v16) = _fp8(gen, (Bk, G, T, D)), _fp8(gen, (Bk, G, T, D))
    sm = 1 / math.sqrt(D)
    q = torch.randn((3, S, G, Hg, D), device="cuda", generator=gen).to(torch.bfloat16)
    if chunked:
        starts = torch.tensor([200, 3, 447], dtype=torch.int32, device="cuda")
        lengths = starts + torch.tensor([40, 64, 0], dtype=torch.int32, device="cuda")
        rmap = torch.tensor([3, 1, 0], dtype=torch.int32, device="cuda")
        got = A.flash_attention_prefill_chunk(q, k8, v8, lengths, starts, sm, rmap)
        same = A.flash_attention_prefill_chunk(q, k16, v16, lengths, starts, sm, rmap)
        want = A.flash_attention_prefill_plain(q, k8, v8, lengths, sm, starts, rmap)
    else:
        lengths = torch.tensor([S, 0, 12], dtype=torch.int32, device="cuda")
        got = A.flash_attention_prefill(q, k8, v8, lengths, sm)
        same = A.flash_attention_prefill(q, k16, v16, lengths, sm)
        want = A.flash_attention_prefill_plain(q, k8, v8, lengths, sm)
    torch.cuda.synchronize()
    assert torch.equal(got, same) and _rel(got, want) <= 1e-2


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("B", [1, 4])
def test_fp8_rope_kv_append_is_bit_equal_to_plain(gen, B, paged):
    """B3 / B9 with the RoPE into an fp8 cache or pool: the rotated q and
    every stored byte equal the plain sequence's (RoPE in bf16, then
    ``kv_store_cast``), at the wall and past it; K3 on each shard of a
    2-way split likewise."""
    q, kv, freqs, k, v, pt, cap = _rope_case(gen, B, paged)
    k, v = A.kv_store_cast(k, FP8), A.kv_store_cast(v, FP8)
    starts = torch.tensor([7, cap - 1, cap, cap + 300][:B], dtype=torch.int32, device="cuda")
    kr, vr = (t.view(torch.uint8).clone().view(FP8) for t in (k, v))
    got = A.rope_kv_append(q, kv, freqs, k, v, 2, starts, pt)
    want = A.rope_kv_append_plain(q, kv, freqs, kr, vr, 2, starts, pt)
    torch.cuda.synchronize()
    assert torch.equal(got, want) and _bytes_equal(k, kr) and _bytes_equal(v, vr)
    for r in range(2):
        shard = (A.KVShard(stride=2, phase=r, total=cap) if paged
                 else A.KVShard(offset=r * (cap // 2), total=cap))
        own = slice(r * (cap // 2), (r + 1) * (cap // 2))  # a T-shard, or the whole pool
        hk8, hv8 = ((t if paged else t[:, :, :, own]).view(torch.uint8).contiguous().view(FP8)
                    for t in (k, v))
        kk, vv = (t.view(torch.uint8).clone().view(FP8) for t in (hk8, hv8))
        table = None if pt is None else pt[:, r::2].contiguous()
        got = A.rope_kv_append_sharded(q, kv, freqs, hk8, hv8, 1, starts, shard, table)
        want = A.rope_kv_append_sharded_plain(q, kv, freqs, kk, vv, 1, starts, shard, table)
        torch.cuda.synchronize()
        assert torch.equal(got, want) and _bytes_equal(hk8, kk) and _bytes_equal(hv8, vv), r


def test_fp8_captured_decode_steps_are_bit_equal_to_eager(gen):
    """``multi_step_decode`` and the paged decode program at depth 2, 6B
    widths, over an fp8 cache and pool: captured against eager over 8
    steps, the tokens and every cache byte equal; the fp8 forms launched."""
    from chatglm_q_tpu_torch import TorchRuntimeConfig, ops
    from chatglm_q_tpu_torch.models import chatglm2 as M
    from chatglm_q_tpu_torch.models import paged_kv as PK

    cfg, params = _depth2_tree(gen)
    bf16 = torch.bfloat16
    ids = torch.randint(0, cfg.vocab_size, (4, 64), device="cuda", generator=gen)
    lengths = torch.tensor([64, 40, 17, 3], dtype=torch.int32, device="cuda")
    cache = M.init_kv_cache(cfg, 4, 256, FP8)
    logits, cache = M.prefill(params, cfg, ids, lengths, cache, "int4g32", bf16)
    first = torch.argmax(logits, -1).to(torch.int32)

    def copy(t):
        return t.view(torch.uint8).clone().view(FP8)

    runs = {}
    for graphs in (False, True):
        c = M.KVCache(copy(cache.k), copy(cache.v), cache.lengths.clone())
        ops.reset_launch_counts()
        toks, out = M.multi_step_decode(params, cfg, first, c, 8, None, "int4g32", bf16,
                                        TorchRuntimeConfig(cuda_graphs=graphs))
        torch.cuda.synchronize()
        runs[graphs] = (toks, out, ops.launch_counts())
    (t0, c0, n0), (t1, c1, n1) = runs[False], runs[True]
    assert torch.equal(t0, t1) and torch.equal(c0.lengths, c1.lengths)
    assert _bytes_equal(c0.k, c1.k) and _bytes_equal(c0.v, c1.v)
    assert n0 == n1 and n1["rope_kv_append_fp8"] == n1["rope_kv_append"] == 8 * cfg.num_layers
    assert n1["flash_attention_decode_fp8"] == 8 * cfg.num_layers

    P, MP = 256, 2
    pool = PK.init_paged_kv_cache(cfg, 4, 9, MP * P, P, FP8)
    pool.page_table.copy_(torch.arange(1, 9, dtype=torch.int32, device="cuda").flip(0)
                          .reshape(4, 2))
    logits, pool = PK.prefill_paged(params, cfg, ids, lengths, pool, "int4g32", bf16)
    first = torch.argmax(logits, -1).to(torch.int32)
    outs = []
    for graphs in (False, True):
        p = pool.replace(k_pool=copy(pool.k_pool), v_pool=copy(pool.v_pool))
        ops.reset_launch_counts()
        prog = PK.decode_paged_program(params, cfg, p, "int4g32", bf16,
                                       TorchRuntimeConfig(cuda_graphs=graphs))
        prog.load(ids=first, lengths=p.lengths, page_table=p.page_table)
        toks = prog.run(8, params, p.k_pool, p.v_pool, collect=("ids",))["ids"]
        torch.cuda.synchronize()
        outs.append((toks, prog.inputs["lengths"].clone(), p, prog.graph is not None,
                     ops.launch_counts()))
    assert not outs[0][3] and outs[1][3]
    assert torch.equal(outs[0][0], outs[1][0]) and torch.equal(outs[0][1], outs[1][1])
    assert _bytes_equal(outs[0][2].k_pool, outs[1][2].k_pool)
    assert _bytes_equal(outs[0][2].v_pool, outs[1][2].v_pool)
    assert outs[1][4]["flash_attention_decode_paged_fp8"] == 8 * cfg.num_layers


def test_attention_kernels_refuse_other_cache_and_activation_dtypes(gen):
    """bf16, f16 or f32 activations over a cache of their dtype or of fp8,
    nothing else: an f32 cache under bf16 q, an f16 cache under bf16 q, a
    bf16 cache under f32 q, or K and V of two dtypes raise, naming the pair.
    f32 into an fp8 cache is stored with one rounding from f32, as
    ``kv_store_cast`` stores it (a bf16 hop would round twice)."""
    q = torch.randn((1, 2, 16, 128), device="cuda", generator=gen).to(torch.bfloat16)
    k8, _ = _fp8(gen, (1, 2, 64, 128))
    lengths = torch.zeros((1,), dtype=torch.int32, device="cuda")
    for kk, vv, qq in ((k8.to(torch.bfloat16).float(),) * 2 + (q,),
                       (k8.to(torch.float16),) * 2 + (q,),
                       (k8.to(torch.bfloat16),) * 2 + (q.float(),),
                       (k8, k8.to(torch.bfloat16), q)):
        with pytest.raises(TypeError, match="float8_e4m3fn"):
            A.flash_attention_decode(qq, kk, vv, lengths, 0.1)
        with pytest.raises(TypeError, match="float8_e4m3fn"):
            A.flash_attention_prefill(qq[:, None], kk, vv, lengths + 1, 0.1)
    x = torch.randn((64, 2, 128), device="cuda", generator=gen) * 8
    cache = A.kv_zeros((1, 64, 2, 4, 128), FP8, "cuda")
    A.kv_cache_write_idx(cache, x, 0, torch.full((64,), 1, dtype=torch.int32, device="cuda"))
    torch.cuda.synchronize()
    want = A.kv_store_cast(x, FP8)
    assert _bytes_equal(cache[0, :, :, 1], want)
    assert not _bytes_equal(want, A.kv_store_cast(x.to(torch.bfloat16), FP8))


# ---------------------------------------------------------------------------
# float16 activations (a float16 checkpoint): B1 / B6 and every attention
# kernel's f16 form, against their plain versions in f16
# ---------------------------------------------------------------------------

F16 = torch.float16
# The f16 limits: max|Δ| / max|plain| of an f16 output (chip_smoke.py's
# F16_KERNEL_TOL: f32 sums in another order, one f16 rounding apart, at most
# 2^-10 of the top binade) and B4's error beyond the output's f16 rounding
# of its function with p rounded to f16 by row (chip_smoke.py's F16_B4_TOL:
# the kernel rounds p per tile).  At these edge shapes B10, B11 and B12 in
# f16 are held to the bf16 forms' B12_TOL beyond the output's rounding
# (chip_smoke.py holds the main shapes to its tighter F16_B1x_TOL); the
# control, p rounded to bf16, must land above each.
F16_TOL = 1.05e-3
F16_B4_BEYOND_TOL = 5e-5


def _beyond_rounding_f16(got, want32):
    """max(|got − want32| − half an f16 ulp of want32) / max|want32|."""
    half_ulp = torch.ldexp(torch.ones_like(want32), torch.frexp(want32).exponent - 12)
    half_ulp = torch.where(want32 == 0, 0.0, half_ulp)
    excess = ((got.float() - want32).abs() - half_ulp).clamp_min(0.0).max().item()
    return excess / want32.abs().max().item()


@pytest.mark.parametrize("kind", ["int4g32", "int8"])
@pytest.mark.parametrize("M,K,N", [(1, 4096, 4096), (4, 4096, 512), (16, 13824, 4096),
                                   (36, 4096, 264), (64, 4096, 13824), (65, 1024, 512),
                                   (80, 1024, 264), (128, 4096, 4096), (512, 4096, 512)])
def test_f16_matmuls_match_plain(gen, kind, M, K, N):
    """B1 (split-K to 64 rows, wgmma above) and B6 (split-K to 16 rows,
    wgmma above; the CUDA-core gemv where N % 16 != 0 above them) in f16:
    one launch of the route's kernel, counted in its f16 form; within
    F16_TOL of the plain version and within 2^-23 of sum|terms| of the
    exact value beyond half an f16 ulp."""
    x = torch.randn((M, K), device="cuda", generator=gen).to(F16)
    if kind == "int4g32":
        w, scale = _int4_weights(gen, K, N)
        fn, plain, route = QM.int4g32_matmul, QM.int4g32_matmul_plain, QM.int4_route
        wrap = {"splitk": QM.int4g32_splitk, "mma": QM.int4g32_mma, "gemv": QM.int4g32_gemv}
        w64 = QM.unpack_int4_tpu(w, scale).double()
        s64 = 1.0
    else:
        w = torch.randint(-128, 128, (K, N), dtype=torch.int8, device="cuda", generator=gen)
        scale = (0.5 + torch.rand((N,), device="cuda", generator=gen)) * 0.01
        fn, plain, route = I8.int8_matmul, I8.int8_matmul_plain, I8.int8_route
        wrap = {"splitk": I8.int8_splitk, "mma": I8.int8_mma, "gemv": I8.int8_gemv}
        w64, s64 = w.double(), scale.double()
    kernel = wrap[route(M, N, F16)]
    assert route(M, N, F16) == route(M, N, torch.bfloat16)
    before = kernel.launches, kernel.f16.launches
    got = fn(x, w, scale)
    torch.cuda.synchronize()
    assert (kernel.launches, kernel.f16.launches) == (before[0] + 1, before[1] + 1)
    assert got.dtype == F16 and torch.isfinite(got).all()
    assert _rel(got, plain(x, w, scale)) <= F16_TOL
    exact, terms = (x.double() @ w64) * s64, (x.double().abs() @ w64.abs()) * s64
    assert _beyond_sum_of(got, exact, terms, 11) <= 2.0 ** -23


def test_f16_matmul_entries_refuse_what_has_no_kernel(gen):
    """The dtype code is checked at the entry: f32 at the tensor-core ones
    (the transposed split-K kernel too), an unknown code at the dynamic
    one; the wrappers send f16 to B8 and B14's kernels."""
    packed, scale = _int4_weights(gen, 64, 16)
    x = torch.zeros((2, 64), dtype=F16, device="cuda")
    y = torch.empty((2, 16), dtype=F16, device="cuda")
    arrivals = torch.zeros((16,), dtype=torch.int32, device="cuda")
    for code in (0, 3):
        with pytest.raises(RuntimeError):
            _build.call("chatglm_int4_splitk_mma", x.data_ptr(), packed.data_ptr(),
                        scale.data_ptr(), y.data_ptr(), None, arrivals.data_ptr(), 2, 64, 16,
                        code, 1, 8, 1, 2, 8, _build.stream_ptr(x))
    sx = torch.ones((2,), device="cuda")
    with pytest.raises(RuntimeError):
        _build.call("chatglm_int4_dyn_splitk", x.data_ptr(), sx.data_ptr(), packed.data_ptr(),
                    scale.data_ptr(), y.data_ptr(), None, arrivals.data_ptr(), 2, 64, 16, 3, 1,
                    8, 1, 2, 8, _build.stream_ptr(x))
    g32 = torch.zeros((2, 16), device="cuda")
    with pytest.raises(RuntimeError):
        _build.call("chatglm_int4_t_splitk", g32.data_ptr(), packed.data_ptr(), scale.data_ptr(),
                    x.data_ptr(), None, arrivals.data_ptr(), 2, 64, 16, 0, 1, 1, 1, 4,
                    _build.stream_ptr(x))
    assert D.int4_dyn_matmul(x, packed, scale).dtype == F16
    assert QM.int4g32_matmul_t(torch.zeros((2, 16), dtype=F16, device="cuda"), packed,
                               scale).dtype == F16


def _f16_cache(gen, shape):
    return torch.randn(shape, device="cuda", generator=gen).to(F16)


def _decode_b4_f32(q, k, v, lengths, sm_scale, p_dtype):
    """B4's function in f32 before the output's rounding: scores scaled in
    f32, p rounded to ``p_dtype`` (f16: v's dtype; bf16: the control), l
    from f32 p."""
    s = torch.einsum("bghd,bgtd->bght", q.float(), k.float()) * sm_scale
    valid = torch.arange(k.shape[2], device=q.device)[None, :] <= lengths.long()[:, None]
    s = s.masked_fill(~valid[:, None, None, :], A.MASK_VALUE)
    p = torch.exp(s - s.amax(-1, keepdim=True)) * (lengths >= 0).float()[:, None, None, None]
    l = p.sum(-1, keepdim=True)
    return torch.einsum("bght,bgtd->bghd", p.to(p_dtype).float(), v.float()) / \
        torch.where(l > 0, l, 1.0)


@pytest.mark.parametrize("B,T", [(4, 1024), (10, 1000)])
@pytest.mark.parametrize("kind", ["decode", "decode_v2", "lse"])
def test_f16_decode_forms_match_plain(gen, kind, B, T):
    """B4, B12 and K1 over an f16 cache at the decode edges: counted in
    their f16 form, within F16_TOL of the plain version, and (B4, B12)
    within B12_TOL beyond the output's f16 rounding of their
    function in f32, where the same function with p rounded to bf16 lands
    above it."""
    G, Hg, D = 2, 16, 128
    q = torch.randn((B, G, Hg, D), device="cuda", generator=gen).to(F16)
    k, v = _f16_cache(gen, (B, G, T, D)), _f16_cache(gen, (B, G, T, D))
    lengths = _decode_edges(B, T, A.decode_span(B * G, T, A.DECODE_BLOCK_K))
    sm = 1 / math.sqrt(D)
    wrapper = {"decode": A.flash_attention_decode, "decode_v2": A.flash_attention_decode_v2,
               "lse": A.flash_attention_decode_lse}[kind]
    before = wrapper.f16.launches
    if kind == "lse":
        got = A.flash_attention_decode_lse(q, k, v, lengths, sm, T // 2)
        torch.cuda.synchronize()
        _hold_lse(got, A.flash_attention_decode_lse_plain(q, k, v, lengths, sm, T // 2))
    else:
        got = wrapper(q, k, v, lengths, sm)
        torch.cuda.synchronize()
        plain = (A.flash_attention_decode_plain if kind == "decode"
                 else A.flash_attention_decode_v2_plain)
        assert got.dtype == F16 and _rel(got, plain(q, k, v, lengths, sm)) <= F16_TOL
        if kind == "decode":  # p rounded to f16 by tile (the kernel) or by row (want32)
            want32 = _decode_b4_f32(q, k, v, lengths, sm, F16)
            control = _decode_b4_f32(q, k, v, lengths, sm, torch.bfloat16)
            limit = F16_B4_BEYOND_TOL
        else:
            want32 = _decode_v2_f32(q, k, v, lengths, sm)
            control = _decode_v2_f32(q, k, v, lengths, sm, p_bf16=True)
            limit = B12_TOL
        assert _beyond_rounding_f16(got, want32) <= limit < \
            _beyond_rounding_f16(control.to(F16), want32)
    assert wrapper.f16.launches == before + 1


@pytest.mark.parametrize("P,MP", [(16, 64), (256, 4)])
def test_f16_paged_forms_match_plain(gen, P, MP):
    """B10, K2 (each phase of a stride-2 table) and B11 (S = 1, 9, 32, with
    a row map) over an f16 pool, within their f16 limits of the plain
    version (B10, B11: beyond the output's rounding of their f32 function,
    against the bf16-p control)."""
    L, G, Hg, D, B = 2, 2, 16, 128, 10
    NP = B * MP + 1
    kp, vp = _f16_cache(gen, (L, NP, G, P, D)), _f16_cache(gen, (L, NP, G, P, D))
    pt = _scattered_table(gen, B, MP, NP)
    lengths = _paged_decode_edges(P, MP, B)
    sm = 1 / math.sqrt(D)
    q = torch.randn((B, G, Hg, D), device="cuda", generator=gen).to(F16)
    before = A.flash_attention_decode_paged.f16.launches
    got = A.flash_attention_decode_paged(q, kp, vp, 1, pt, lengths, sm)
    torch.cuda.synchronize()
    assert A.flash_attention_decode_paged.f16.launches == before + 1
    assert _rel(got, A.flash_attention_decode_paged_plain(q, kp, vp, 1, pt, lengths, sm)) <= F16_TOL
    want32 = _paged_decode_f32(q, kp, vp, 1, pt, lengths, sm)
    control = _paged_decode_f32(q, kp, vp, 1, pt, lengths, sm, p_bf16=True).to(F16)
    assert _beyond_rounding_f16(got, want32) <= B12_TOL < \
        _beyond_rounding_f16(control, want32)
    for phase in (0, 1):
        table = pt[:, phase::2].contiguous()
        _hold_lse(A.flash_attention_decode_paged_lse(q, kp, vp, 1, table, lengths, sm, 2, phase),
                  A.flash_attention_decode_paged_lse_plain(q, kp, vp, 1, table, lengths, sm, 2,
                                                           phase))
    cap = MP * P
    for S in (1, 9, 32):
        qs = torch.randn((B, S, G, Hg, D), device="cuda", generator=gen).to(F16)
        starts = torch.tensor([0, P - 1, 700 % cap, cap - S] + [(97 * i) % (cap - S)
                                                               for i in range(B - 4)],
                              dtype=torch.int32, device="cuda")
        rmap = torch.randperm(B, device="cuda", generator=gen).to(torch.int32)
        for row_map in (None, rmap):
            got = A.flash_attention_chunk_paged(qs, kp, vp, 1, pt, starts, sm, row_map)
            torch.cuda.synchronize()
            want = A.flash_attention_chunk_paged_plain(qs, kp, vp, 1, pt, starts, sm, row_map)
            assert got.dtype == F16 and _rel(got, want) <= F16_TOL
            want32 = _chunk_paged_f32(qs, kp, vp, 1, pt, starts, sm, row_map)
            control = _chunk_paged_f32(qs, kp, vp, 1, pt, starts, sm, row_map, p_bf16=True)
            assert _beyond_rounding_f16(got, want32) <= B12_TOL < \
                _beyond_rounding_f16(control.to(F16), want32)


@pytest.mark.parametrize("chunked", [False, True])
def test_f16_prefill_matches_plain(gen, chunked):
    """B5 in f16, whole prompts (lengths 128, 77, 0, 5) and its chunked form
    (starts and a row map over a 512-slot cache)."""
    B, G, Hg, D, T = 4, 2, 16, 128, 512
    S = 128 if not chunked else 96
    q = torch.randn((B, S, G, Hg, D), device="cuda", generator=gen).to(F16)
    k, v = _f16_cache(gen, (B, G, T, D)), _f16_cache(gen, (B, G, T, D))
    sm = 1 / math.sqrt(D)
    if chunked:
        starts = torch.tensor([0, 96, 300, 416], dtype=torch.int32, device="cuda")
        lengths = starts + torch.tensor([96, 50, 96, 96], dtype=torch.int32, device="cuda")
        rmap = torch.tensor([2, 0, 3, 1], dtype=torch.int32, device="cuda")
        got = A.flash_attention_prefill_chunk(q, k, v, lengths, starts, sm, rmap)
        want = A.flash_attention_prefill_plain(q, k, v, lengths, sm, starts, rmap)
    else:
        lengths = torch.tensor([128, 77, 0, 5], dtype=torch.int32, device="cuda")
        got = A.flash_attention_prefill(q, k, v, lengths, sm)
        want = A.flash_attention_prefill_plain(q, k, v, lengths, sm)
    torch.cuda.synchronize()
    assert got.dtype == F16 and torch.isfinite(got).all() and _rel(got, want) <= F16_TOL


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_f16_appends_bit_equal_to_plain(gen, paged):
    """B3 / B9 with the RoPE, the write-only forms and K3 into f16 caches:
    bit-equal to their plain versions (each RoPE product and sum rounded
    to f16 at once)."""
    from chatglm_q_tpu_torch.models.chatglm2 import precompute_freqs_cis

    L, B, G, Hg, D = 3, 4, 2, 16, 128
    table = torch.from_numpy(precompute_freqs_cis(D, 2049)).to("cuda", F16)
    q = torch.randn((B, G, Hg, D), device="cuda", generator=gen).to(F16)
    kv = torch.randn((B, 2 * G * D), device="cuda", generator=gen).to(F16)
    freqs = table[torch.tensor([5, 700, 1500, 2048], device="cuda")]
    if paged:
        P, MP = 16, 4
        k, v = _f16_cache(gen, (L, 4 * MP + 1, G, P, D)), _f16_cache(gen, (L, 4 * MP + 1, G, P, D))
        pt = _scattered_table(gen, B, MP, 4 * MP + 1)
        starts = torch.tensor([0, P, MP * P - 1, MP * P + 9], dtype=torch.int32, device="cuda")
        shard, spt = A.KVShard(stride=2, phase=1, total=MP * P), pt[:, 1::2].contiguous()
    else:
        T = 64
        k, v = _f16_cache(gen, (L, B, G, T, D)), _f16_cache(gen, (L, B, G, T, D))
        pt, spt = None, None
        starts = torch.tensor([0, 31, 63, 70], dtype=torch.int32, device="cuda")
        shard = A.KVShard(offset=32, total=96)
    kk, vv = k.clone(), v.clone()
    got = A.rope_kv_append(q, kv, freqs, k, v, 1, starts, pt)
    want = A.rope_kv_append_plain(q, kv, freqs, kk, vv, 1, starts, pt)
    torch.cuda.synchronize()
    assert torch.equal(got, want) and torch.equal(k, kk) and torch.equal(v, vv)
    got = A.rope_kv_append_sharded(q, kv, freqs, k, v, 2, starts, shard, spt)
    want = A.rope_kv_append_sharded_plain(q, kv, freqs, kk, vv, 2, starts, shard, spt)
    torch.cuda.synchronize()
    assert torch.equal(got, want) and torch.equal(k, kk) and torch.equal(v, vv)
    new = torch.randn((B, G, D), device="cuda", generator=gen).to(F16)
    if paged:
        A.kv_pool_write_idx(k, new, 0, pt, starts)
        A.kv_pool_write_idx_plain(kk, new, 0, pt, starts)
    else:
        A.kv_cache_write_idx(k, new, 0, starts)
        A.kv_cache_write_idx_plain(kk, new, 0, starts)
    torch.cuda.synchronize()
    assert torch.equal(k, kk)


def test_f16_captured_decode_steps_equal_eager(gen):
    """``multi_step_decode`` at depth 2, 6B widths, f16 activations over an
    f16 cache: captured against eager over 8 steps, the tokens and every
    cache element equal; B1's and the attention kernels' f16 forms
    launched, 8 steps' worth."""
    from chatglm_q_tpu_torch import TorchRuntimeConfig, ops
    from chatglm_q_tpu_torch.models import chatglm2 as M

    cfg, params = _depth2_tree(gen)
    ids = torch.randint(0, cfg.vocab_size, (4, 64), device="cuda", generator=gen)
    lengths = torch.tensor([64, 40, 17, 3], dtype=torch.int32, device="cuda")
    cache = M.init_kv_cache(cfg, 4, 256, F16)
    logits, cache = M.prefill(params, cfg, ids, lengths, cache, "int4g32", F16)
    assert logits.dtype == F16 and torch.isfinite(logits).all()
    first = torch.argmax(logits, -1).to(torch.int32)
    runs = {}
    for graphs in (False, True):
        c = M.KVCache(cache.k.clone(), cache.v.clone(), cache.lengths.clone())
        ops.reset_launch_counts()
        toks, out = M.multi_step_decode(params, cfg, first, c, 8, None, "int4g32", F16,
                                        TorchRuntimeConfig(cuda_graphs=graphs))
        torch.cuda.synchronize()
        runs[graphs] = (toks, out, ops.launch_counts())
    (t0, c0, n0), (t1, c1, n1) = runs[False], runs[True]
    assert torch.equal(t0, t1) and torch.equal(c0.k, c1.k) and torch.equal(c0.v, c1.v)
    assert n0 == n1 and n1["int4g32_splitk_f16"] == n1["int4g32_splitk"] == \
        8 * (6 * cfg.num_layers + 1)
    assert n1["rope_kv_append_f16"] == n1["flash_attention_decode_f16"] == 8 * cfg.num_layers
    prog = M.decode_program(params, cfg, c1, "int4g32", F16, TorchRuntimeConfig())
    assert prog.graph is not None and prog.replays == 7


def test_f16_checkpoint_serves_through_the_launch_path(gen, tmp_path):
    """A float32 checkpoint (head dim 128, as the kernels take) quantized by
    ``examples/quantize_naive`` into a float16-config checkpoint, loaded by
    ``GLMDecoder.from_pretrained`` with no dtype, generates on the card
    through the f16 kernels (no TypeError), captured equal to eager."""
    from chatglm_q_tpu_torch import ChatGLM2Config, GLMLoadConfig, TorchRuntimeConfig, ops
    from chatglm_q_tpu_torch import loader as TLD
    from chatglm_q_tpu_torch.examples import quantize_naive
    from chatglm_q_tpu_torch.models import chatglm2 as M
    from chatglm_q_tpu_torch.serving import GLMDecoder
    from chatglm_q_tpu_torch.tokenizer import ChatGLM2Tokenizer
    from chatglm_q_tpu_torch.tokenizer.build import build_unigram_model

    vocab = {f"tok{i}": -float(i) for i in range(200)}
    (tmp_path / "sp.model").write_bytes(build_unigram_model(vocab))
    tok = ChatGLM2Tokenizer(tmp_path / "sp.model")
    cfg = ChatGLM2Config(hidden_size=512, inner_hidden_size=1024, head_hidden_size=128,
                         num_multi_query_groups=2, num_attention_heads=4, num_layers=2,
                         vocab_size=((len(tok) + 63) // 64) * 64, max_sequence_length=256)
    params = M.init_params(torch.Generator().manual_seed(5), cfg, "none", torch.float32, "cpu")
    TLD.save_model_and_tokenizer(tmp_path / "fp", GLMLoadConfig(model_config=cfg,
                                                                torch_dtype="float32"),
                                 params, tok)
    texts = {}
    for quant in ("int8", "int4g32"):
        quantize_naive.main(["--quant", quant, "--source", str(tmp_path / "fp"),
                             "--target", str(tmp_path / quant)])
        for graphs in (True, False):
            dec = GLMDecoder.from_pretrained(tmp_path / quant,
                                             rt=TorchRuntimeConfig(cuda_graphs=graphs))
            assert dec.dtype == F16 and dec.device.type == "cuda"
            ops.reset_launch_counts()
            out = list(dec.generate("tok1 tok2 tok3", max_generated_tokens=12, temperature=0.0))
            torch.cuda.synchronize()
            counts = ops.launch_counts()
            assert out and counts["flash_attention_decode_f16"] > 0
            assert counts["int8_splitk_f16" if quant == "int8" else "int4g32_splitk_f16"] > 0
            texts[(quant, graphs)] = out
        assert texts[(quant, True)] == texts[(quant, False)]


# ---------------------------------------------------------------------------
# The last float16 forms: dynamic int8 (B7 / B8) with f16 outputs,
# fine-tuning's backward (B13 / B14) on f16 gradients, and every attention
# kernel under f16 activations over an fp8 cache
# ---------------------------------------------------------------------------

F16_DYN_EDGES = [(1, 4096, 4096), (4, 13824, 512), (16, 4096, 13824), (17, 4096, 512),
                 (57, 4096, 4096), (64, 13824, 4096), (128, 4096, 65536), (512, 4096, 512)]


@pytest.mark.parametrize("M,K,N", F16_DYN_EDGES)
@pytest.mark.parametrize("kind", ["int8", "int4g32"])
def test_f16_dyn_matmuls_match_plain(gen, kind, M, K, N):
    """B7 and B8 with f16 outputs (split-K to 16 rows, wgmma above): one
    launch of the route's kernel counted in its f16 form; B7 bit-equal to
    its plain version, B8 within F16_TOL of it and within 2^-23 of
    sum|terms| of its exact value beyond half an f16 ulp."""
    call, _, plain, exact = _dyn_case(gen, kind, M, K, N, F16)
    name = ("int8" if kind == "int8" else "int4") + ("_dyn_mma" if D.uses_mma(M, N)
                                                    else "_dyn_splitk")
    kernel = getattr(D, name)
    before = kernel.launches, kernel.f16.launches
    got = call()
    torch.cuda.synchronize()
    assert (kernel.launches, kernel.f16.launches) == (before[0] + 1, before[1] + 1)
    assert got.dtype == F16 and torch.isfinite(got).all() and not got[M // 2].any()
    want = plain()
    if kind == "int8":
        assert torch.equal(got, want), _rel(got, want)
    else:
        assert _rel(got, want) <= F16_TOL
        assert _beyond_sum_of(got, *exact(), 11) <= 2.0 ** -23


@pytest.mark.parametrize("M", [1, 40])
def test_f16_dyn_output_overflows_to_inf_as_plain(gen, M):
    """Past 65,504 B7's f16 output is inf, as the plain version's (and
    JAX's) astype gives: the kernels' epilogue rounds the f32 result once."""
    K, N = 4096, 512
    w, _ = _int8_weights(gen, K, N)
    scale = torch.full((N,), 60.0, device="cuda")
    x = torch.randn((M, K), device="cuda", generator=gen).to(F16)
    got = D.int8_dyn_matmul(x, w, scale)
    torch.cuda.synchronize()
    want = D.int8_dyn_matmul_plain(x, w, scale)
    assert torch.isinf(want).any() and torch.equal(got, want)


def _t_f16_case(gen, kind, M, K, N):
    """(call, plain version, exact f64 value and sum|terms|) of one
    transposed matmul on f16 g (M, N) with a zero row: B13's g · f16(s) and
    B14's f16(f16(q) · f16(s)) in f16, the function the kernels compute."""
    g = _x(gen, M, N, F16)
    if kind == "int8":
        w, scale = _int8_weights(gen, K, N)
        gs, w64 = (g * scale.to(F16)).double(), w.double()
        return (lambda: I8.int8_matmul_t(g, w, scale), lambda: I8.int8_matmul_t_plain(g, w, scale),
                lambda: (gs @ w64.T, gs.abs() @ w64.abs().T))
    packed, scale = _int4_t_weights(gen, K, N)
    q = QM.unpack_int4_tpu(packed, torch.ones_like(scale)).to(F16)
    w64 = (q.reshape(K // 32, 32, N) * scale.to(F16)[:, None]).reshape(K, N).double()
    return (lambda: QM.int4g32_matmul_t(g, packed, scale),
            lambda: QM.int4g32_matmul_t_plain(g, packed, scale),
            lambda: (g.double() @ w64.T, g.double().abs() @ w64.abs().T))


@pytest.mark.parametrize("K,N", [(4096, 4096), (4096, 512), (13824, 4096), (4096, 13824),
                                 (4096, 65536), (256, 264)])
@pytest.mark.parametrize("M", [1, 4, 16, 17, 128, 512])
@pytest.mark.parametrize("kind", ["int8", "int4g32"])
def test_f16_t_matmuls_match_plain(gen, kind, M, K, N):
    """B13 and B14 on f16 g (split-K to 16 rows and where N % 16 != 0,
    wgmma above): one launch counted in its f16 form, within F16_TOL of the
    plain version and within 2^-23 of sum|terms| of the exact value beyond
    half an f16 ulp, the zero row zero; a second call bit-equal."""
    call, plain, exact = _t_f16_case(gen, kind, M, K, N)
    route = QM.t_route(M, N, F16)
    kernel = {("int8", "splitk"): I8.int8_t_splitk, ("int8", "mma"): I8.int8_t_mma,
              ("int4g32", "splitk"): QM.int4g32_t_splitk,
              ("int4g32", "mma"): QM.int4g32_t_mma}[(kind, route)]
    before = kernel.launches, kernel.f16.launches
    got = call()
    torch.cuda.synchronize()
    assert (kernel.launches, kernel.f16.launches) == (before[0] + 1, before[1] + 1)
    assert got.dtype == F16 and got.shape == (M, K)
    assert torch.isfinite(got).all() and not got[M // 2].any()
    assert _rel(got, plain()) <= F16_TOL
    assert _beyond_sum_of(got, *exact(), 11) <= 2.0 ** -23
    assert torch.equal(call(), got)


@pytest.mark.parametrize("e", [-20, -27, 17])
def test_f16_int4_t_follows_jax_past_the_normal_range(gen, e):
    """B14's f16(s) below 2^-14 (a subnormal), below 2^-25 (0) and past
    65,504 (inf: q · inf, 0 · inf = NaN): the kernels equal the plain
    version, which follows JAX's kernel, at 1 and 128 rows."""
    K, N = 4096, 512
    packed, scale = _int4_t_weights(gen, K, N)
    scale = (scale.float() * 50 * 2.0 ** e).to(torch.bfloat16)
    for M in (1, 128):
        g = torch.randn((M, N), device="cuda", generator=gen).to(F16)
        got = QM.int4g32_matmul_t(g, packed, scale)
        torch.cuda.synchronize()
        want = QM.int4g32_matmul_t_plain(g, packed, scale)
        assert torch.equal(torch.isnan(got), torch.isnan(want))
        fin = ~torch.isnan(want)
        if fin.any() and want[fin].abs().max() > 0:
            assert _rel(got[fin], want[fin]) <= F16_TOL
        else:
            assert not got[fin].any()


def test_f16_store_into_fp8_equals_kv_store_cast_over_every_f16_pattern(gen):
    """All 65,536 f16 patterns through the write-only append (B3) and the
    fused append's v (B9's pool) into fp8, byte for byte against
    ``kv_store_cast`` on the card and on the CPU; counted in the
    f16-over-fp8 form."""
    bits = torch.arange(65536, dtype=torch.int32, device="cuda").to(torch.int16)
    x = bits.view(F16).reshape(256, 2, 128)
    want = A.kv_store_cast(x, FP8)
    assert _bytes_equal(want.cpu(), A.kv_store_cast(x.cpu(), FP8))
    cache = A.kv_zeros((2, 256, 2, 4, 128), FP8, "cuda")
    starts = torch.full((256,), 3, dtype=torch.int32, device="cuda")
    before = A.kv_cache_write_idx.fp8_f16.launches
    A.kv_cache_write_idx(cache, x, 1, starts)
    torch.cuda.synchronize()
    assert A.kv_cache_write_idx.fp8_f16.launches == before + 1
    assert _bytes_equal(cache[1, :, :, 3], want)
    assert not cache[0].view(torch.uint8).any() and not cache[1, :, :, :3].view(torch.uint8).any()
    q = torch.zeros((256, 2, 16, 128), dtype=F16, device="cuda")
    kv = torch.cat([torch.zeros_like(x), x], dim=1).reshape(256, 512)
    freqs = torch.zeros((256, 128), dtype=F16, device="cuda")
    kp, vp = (A.kv_zeros((1, 257, 2, 16, 128), FP8, "cuda") for _ in range(2))
    pt = torch.arange(1, 257, dtype=torch.int32, device="cuda")[:, None]
    A.rope_kv_append(q, kv, freqs, kp, vp, 0, torch.full((256,), 5, dtype=torch.int32,
                                                          device="cuda"), pt)
    torch.cuda.synchronize()
    assert _bytes_equal(vp[0, 1:, :, 5], want)


@pytest.mark.parametrize("kind", ["decode", "decode_v2", "paged", "chunk", "prefill"])
def test_f16_over_fp8_read_is_exact_for_all_256_bytes(gen, kind):
    """As the bf16 readers' test: V slot 0 of two groups holds all 256
    bytes, one valid slot, p = 1, so each head outputs the f16 upcast of
    every byte; NaN where the byte is NaN."""
    B, G, Hg, D, T = 1, 2, 4, 128, 64
    v8 = A.kv_zeros((B, G, T, D), FP8, "cuda")
    v8.view(torch.uint8)[0, :, 0] = torch.arange(256, device="cuda").to(torch.uint8).reshape(2, 128)
    k8 = A.kv_zeros((B, G, T, D), FP8, "cuda")
    want = v8[0, :, 0].to(F16)
    q = torch.randn((B, G, Hg, D), device="cuda", generator=gen).to(F16)
    zero = torch.zeros((B,), dtype=torch.int32, device="cuda")
    if kind in ("decode", "decode_v2"):
        fn = A.flash_attention_decode if kind == "decode" else A.flash_attention_decode_v2
        out = fn(q, k8, v8, zero, 0.1)[0]
    elif kind == "prefill":
        out = A.flash_attention_prefill(q[:, None], k8, v8, zero + 1, 0.1)[0, 0]
    else:
        kp, vp = k8[None], v8[None]
        pt = torch.zeros((1, 1), dtype=torch.int32, device="cuda")
        if kind == "paged":
            out = A.flash_attention_decode_paged(q, kp, vp, 0, pt, zero, 0.1)[0]
        else:
            out = A.flash_attention_chunk_paged(q[:, None], kp, vp, 0, pt, zero, 0.1)[0, 0]
    torch.cuda.synchronize()
    got = out.float()
    ref = want.float()[:, None].expand_as(got)
    nan = torch.isnan(ref)
    assert nan.sum() == 2 * Hg
    assert torch.equal(torch.isnan(got), nan) and torch.equal(got[~nan], ref[~nan])


def _fp8_f16(gen, shape):
    """A random fp8 cache tensor and its exact f16 upcast."""
    k8, _ = _fp8(gen, shape)
    return k8, k8.to(F16)


@pytest.mark.parametrize("B,T", [(6, 200), (10, 1000)])
@pytest.mark.parametrize("kind", ["decode", "decode_v2", "lse"])
def test_f16_over_fp8_decode_forms_equal_the_f16_form_on_the_upcast_cache(gen, kind, B, T):
    """B4, B12 and K1 under f16 over an fp8 cache: counted in that form,
    bit-equal to the f16 form over the cache upcast to f16, within F16_TOL
    of the plain version."""
    G, Hg, D = 2, 16, 128
    q = torch.randn((B, G, Hg, D), device="cuda", generator=gen).to(F16)
    (k8, k16), (v8, v16) = _fp8_f16(gen, (B, G, T, D)), _fp8_f16(gen, (B, G, T, D))
    lengths = _decode_edges(B, T, A.decode_span(B * G, T, A.DECODE_BLOCK_K))
    sm = 1 / math.sqrt(D)
    fn, plain = {"decode": (A.flash_attention_decode, A.flash_attention_decode_plain),
                 "decode_v2": (A.flash_attention_decode_v2, A.flash_attention_decode_v2_plain),
                 "lse": (lambda *a: A.flash_attention_decode_lse(*a, T // 2),
                         lambda *a: A.flash_attention_decode_lse_plain(*a, T // 2))}[kind]
    wrapper = {"decode": A.flash_attention_decode, "decode_v2": A.flash_attention_decode_v2,
               "lse": A.flash_attention_decode_lse}[kind]
    before = wrapper.fp8_f16.launches
    got = fn(q, k8, v8, lengths, sm)
    same = fn(q, k16, v16, lengths, sm)
    torch.cuda.synchronize()
    assert wrapper.fp8_f16.launches == before + 1
    pairs = zip(got, same) if kind == "lse" else [(got, same)]
    assert all(torch.equal(a, b) for a, b in pairs)
    want = plain(q, k8, v8, lengths, sm)
    if kind == "lse":
        _hold_lse(got, want)
    else:
        assert got.dtype == F16 and _rel(got, want) <= F16_TOL


@pytest.mark.parametrize("P,MP", [(16, 64), (256, 4)])
def test_f16_over_fp8_paged_forms_equal_the_f16_form_on_the_upcast_pool(gen, P, MP):
    """B10, K2 (each phase of a stride-2 table) and B11 (S = 1, 9, 32, with
    a row map) under f16 over an fp8 pool: bit-equal to the f16 form on the
    upcast pool, within F16_TOL of the plain version."""
    L, G, Hg, D, B = 2, 2, 16, 128, 10
    NP = B * MP + 1
    (kp8, kp16), (vp8, vp16) = _fp8_f16(gen, (L, NP, G, P, D)), _fp8_f16(gen, (L, NP, G, P, D))
    pt = _scattered_table(gen, B, MP, NP)
    lengths = _paged_decode_edges(P, MP, B)
    sm = 1 / math.sqrt(D)
    q = torch.randn((B, G, Hg, D), device="cuda", generator=gen).to(F16)
    got = A.flash_attention_decode_paged(q, kp8, vp8, 1, pt, lengths, sm)
    assert torch.equal(got, A.flash_attention_decode_paged(q, kp16, vp16, 1, pt, lengths, sm))
    assert _rel(got, A.flash_attention_decode_paged_plain(q, kp8, vp8, 1, pt, lengths,
                                                          sm)) <= F16_TOL
    half = pt[:, ::2].contiguous()
    for phase in (0, 1):
        got = A.flash_attention_decode_paged_lse(q, kp8, vp8, 1, half, lengths, sm, 2, phase)
        same = A.flash_attention_decode_paged_lse(q, kp16, vp16, 1, half, lengths, sm, 2, phase)
        assert all(torch.equal(a, b) for a, b in zip(got, same))
        _hold_lse(got, A.flash_attention_decode_paged_lse_plain(q, kp8, vp8, 1, half, lengths,
                                                                sm, 2, phase))
    starts = torch.tensor([0, P - 2, 300, MP * P - 40, 7], dtype=torch.int32, device="cuda")
    rmap = torch.tensor([5, 0, 3, 1, 2], dtype=torch.int32, device="cuda")
    for S in (1, 9, 32):
        qc = torch.randn((5, S, G, Hg, D), device="cuda", generator=gen).to(F16)
        got = A.flash_attention_chunk_paged(qc, kp8, vp8, 0, pt, starts, sm, rmap)
        same = A.flash_attention_chunk_paged(qc, kp16, vp16, 0, pt, starts, sm, rmap)
        torch.cuda.synchronize()
        assert torch.equal(got, same), S
        want = A.flash_attention_chunk_paged_plain(qc, kp8, vp8, 0, pt, starts, sm, rmap)
        assert _rel(got, want) <= F16_TOL


@pytest.mark.parametrize("chunked", [False, True])
def test_f16_over_fp8_prefill_forms_equal_the_f16_form_on_the_upcast_cache(gen, chunked):
    """B5 (whole prompt, and the chunked form with a row map) under f16
    over an fp8 cache: bit-equal to the f16 form on the upcast cache."""
    G, Hg, D, T, S = 2, 16, 128, 512, 64 if chunked else 130
    Bk = 4 if chunked else 3
    (k8, k16), (v8, v16) = _fp8_f16(gen, (Bk, G, T, D)), _fp8_f16(gen, (Bk, G, T, D))
    sm = 1 / math.sqrt(D)
    q = torch.randn((3, S, G, Hg, D), device="cuda", generator=gen).to(F16)
    if chunked:
        starts = torch.tensor([200, 3, 447], dtype=torch.int32, device="cuda")
        lengths = starts + torch.tensor([40, 64, 0], dtype=torch.int32, device="cuda")
        rmap = torch.tensor([3, 1, 0], dtype=torch.int32, device="cuda")
        got = A.flash_attention_prefill_chunk(q, k8, v8, lengths, starts, sm, rmap)
        same = A.flash_attention_prefill_chunk(q, k16, v16, lengths, starts, sm, rmap)
        want = A.flash_attention_prefill_plain(q, k8, v8, lengths, sm, starts, rmap)
    else:
        lengths = torch.tensor([S, 0, 12], dtype=torch.int32, device="cuda")
        got = A.flash_attention_prefill(q, k8, v8, lengths, sm)
        same = A.flash_attention_prefill(q, k16, v16, lengths, sm)
        want = A.flash_attention_prefill_plain(q, k8, v8, lengths, sm)
    torch.cuda.synchronize()
    assert torch.equal(got, same) and _rel(got, want) <= F16_TOL


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("B", [1, 4])
def test_f16_over_fp8_rope_kv_append_is_bit_equal_to_plain(gen, B, paged):
    """B3 / B9 with the RoPE in f16 into an fp8 cache or pool, and K3 on
    each shard of a 2-way split: the rotated q and every stored byte equal
    the plain sequence's (RoPE in f16, then ``kv_store_cast``)."""
    q, kv, freqs, k, v, pt, cap = _rope_case(gen, B, paged)
    q, kv, freqs = q.to(F16), kv.to(F16), freqs.to(F16)
    k, v = A.kv_store_cast(k, FP8), A.kv_store_cast(v, FP8)
    starts = torch.tensor([7, cap - 1, cap, cap + 300][:B], dtype=torch.int32, device="cuda")
    kr, vr = (t.view(torch.uint8).clone().view(FP8) for t in (k, v))
    before = A.rope_kv_append.fp8_f16.launches
    got = A.rope_kv_append(q, kv, freqs, k, v, 2, starts, pt)
    want = A.rope_kv_append_plain(q, kv, freqs, kr, vr, 2, starts, pt)
    torch.cuda.synchronize()
    assert A.rope_kv_append.fp8_f16.launches == before + 1
    assert got.dtype == F16 and torch.equal(got, want)
    assert _bytes_equal(k, kr) and _bytes_equal(v, vr)
    for r in range(2):
        shard = (A.KVShard(stride=2, phase=r, total=cap) if paged
                 else A.KVShard(offset=r * (cap // 2), total=cap))
        own = slice(r * (cap // 2), (r + 1) * (cap // 2))
        hk8, hv8 = ((t if paged else t[:, :, :, own]).view(torch.uint8).contiguous().view(FP8)
                    for t in (k, v))
        kk, vv = (t.view(torch.uint8).clone().view(FP8) for t in (hk8, hv8))
        table = None if pt is None else pt[:, r::2].contiguous()
        got = A.rope_kv_append_sharded(q, kv, freqs, hk8, hv8, 1, starts, shard, table)
        want = A.rope_kv_append_sharded_plain(q, kv, freqs, kk, vv, 1, starts, shard, table)
        torch.cuda.synchronize()
        assert torch.equal(got, want) and _bytes_equal(hk8, kk) and _bytes_equal(hv8, vv), r


def test_f16_over_fp8_captured_decode_steps_equal_eager(gen):
    """``multi_step_decode`` at depth 2, 6B widths, f16 activations over an
    fp8 cache: captured against eager over 8 steps, the tokens and every
    cache byte equal; the f16-over-fp8 attention forms launched."""
    from chatglm_q_tpu_torch import TorchRuntimeConfig, ops
    from chatglm_q_tpu_torch.models import chatglm2 as M

    cfg, params = _depth2_tree(gen)
    ids = torch.randint(0, cfg.vocab_size, (4, 64), device="cuda", generator=gen)
    lengths = torch.tensor([64, 40, 17, 3], dtype=torch.int32, device="cuda")
    cache = M.init_kv_cache(cfg, 4, 256, FP8)
    logits, cache = M.prefill(params, cfg, ids, lengths, cache, "int4g32", F16)
    assert logits.dtype == F16 and torch.isfinite(logits).all()
    first = torch.argmax(logits, -1).to(torch.int32)

    def copy(t):
        return t.view(torch.uint8).clone().view(FP8)

    runs = {}
    for graphs in (False, True):
        c = M.KVCache(copy(cache.k), copy(cache.v), cache.lengths.clone())
        ops.reset_launch_counts()
        toks, out = M.multi_step_decode(params, cfg, first, c, 8, None, "int4g32", F16,
                                        TorchRuntimeConfig(cuda_graphs=graphs))
        torch.cuda.synchronize()
        runs[graphs] = (toks, out, ops.launch_counts())
    (t0, c0, n0), (t1, c1, n1) = runs[False], runs[True]
    assert torch.equal(t0, t1) and _bytes_equal(c0.k, c1.k) and _bytes_equal(c0.v, c1.v)
    assert n0 == n1 and n1["rope_kv_append_fp8_f16"] == n1["rope_kv_append"] == \
        8 * cfg.num_layers
    assert n1["flash_attention_decode_fp8_f16"] == 8 * cfg.num_layers


@pytest.mark.parametrize("quant", ["int4g32", "int8"])
def test_f16_captured_dyn_decode_steps_equal_eager(gen, quant):
    """``multi_step_decode`` with ``dynamic_int8`` at depth 2, f16: captured
    against eager over 8 steps, tokens and cache equal, B7 / B8's f16 forms
    launched."""
    from chatglm_q_tpu_torch import ChatGLM2Config, TorchRuntimeConfig, ops
    from chatglm_q_tpu_torch.bench import random_quantized_params
    from chatglm_q_tpu_torch.models import chatglm2 as M

    cfg = ChatGLM2Config(num_layers=2)
    params = random_quantized_params(cfg, quant, gen)
    ids = torch.randint(0, cfg.vocab_size, (4, 64), device="cuda", generator=gen)
    lengths = torch.tensor([64, 40, 17, 3], dtype=torch.int32, device="cuda")
    rt = dict(dynamic_int8=True)
    cache = M.init_kv_cache(cfg, 4, 256, F16)
    logits, cache = M.prefill(params, cfg, ids, lengths, cache, quant, F16,
                              TorchRuntimeConfig(**rt))
    first = torch.argmax(logits, -1).to(torch.int32)
    runs = {}
    for graphs in (False, True):
        c = M.KVCache(cache.k.clone(), cache.v.clone(), cache.lengths.clone())
        ops.reset_launch_counts()
        toks, out = M.multi_step_decode(params, cfg, first, c, 8, None, quant, F16,
                                        TorchRuntimeConfig(cuda_graphs=graphs, **rt))
        torch.cuda.synchronize()
        runs[graphs] = (toks, out, ops.launch_counts())
    (t0, c0, n0), (t1, c1, n1) = runs[False], runs[True]
    assert torch.equal(t0, t1) and torch.equal(c0.k, c1.k) and torch.equal(c0.v, c1.v)
    kern = "int8_dyn_splitk" if quant == "int8" else "int4_dyn_splitk"
    assert n0 == n1 and n1[kern + "_f16"] == n1[kern] > 0


@pytest.mark.parametrize("quant", ["int4g32", "int8"])
def test_f16_captured_training_step_equals_eager_over_3_steps(gen, quant):
    """The training step in f16 (B13 / B14 on f16 g): captured against
    eager, the losses bit-equal over 3 steps, the backward's f16 forms
    launched."""
    from chatglm_q_tpu_torch import ops
    from chatglm_q_tpu_torch.utils.train import (make_train_step, partition_params,
                                                 trainable_leaves)

    cfg, params = _prog_tree(gen, quant)
    losses, counts = {}, {}
    for S in (64, 8):  # 2 x 64 rows: the Hopper backward; 1 x 8: the split-K one
        ids = torch.randint(0, 1024, (2 if S == 64 else 1, S), device="cuda", generator=gen)
        labels = ids.clone()
        labels[:, :2] = -100
        for k, rt in _rts().items():
            tr, fr = partition_params(params)
            opt = torch.optim.AdamW(trainable_leaves(tr), lr=1e-3, capturable=True)
            step = make_train_step(cfg, quant, opt, F16, rt)
            ops.reset_launch_counts()
            losses[(S, k)] = [step(tr, fr, ids, labels).item() for _ in range(3)]
            counts[(S, k)] = ops.launch_counts()
        assert losses[(S, "captured")] == losses[(S, "eager")]
        assert all(math.isfinite(x) for x in losses[(S, "eager")])
    t = "int8_t" if quant == "int8" else "int4g32_t"
    assert counts[(64, "eager")][t + "_mma_f16"] > 0 and counts[(8, "eager")][t + "_splitk_f16"] > 0


# ---------------------------------------------------------------------------
# float32 activations (a float32 checkpoint): every attention kernel's f32
# form over an f32 and an fp8 cache, on the CUDA cores
# ---------------------------------------------------------------------------

F32 = torch.float32
F32_TOL = 1e-5  # chip_smoke.py's: the order of f32 sums alone


def _f32_decode(kind, T):
    fn, plain = {"decode": (A.flash_attention_decode, A.flash_attention_decode_plain),
                 "decode_v2": (A.flash_attention_decode_v2, A.flash_attention_decode_v2_plain),
                 "lse": (lambda *a: A.flash_attention_decode_lse(*a, T // 2),
                         lambda *a: A.flash_attention_decode_lse_plain(*a, T // 2))}[kind]
    wrapper = {"decode": A.flash_attention_decode, "decode_v2": A.flash_attention_decode_v2,
               "lse": A.flash_attention_decode_lse}[kind]
    return fn, plain, wrapper


def _hold_f32(got, want):
    """An f32 output (or K1 / K2's (out, m, l)) within F32_TOL of its plain
    version; (m, l) within F32_TOL too, an empty row 0, -inf, 0."""
    if isinstance(got, tuple):
        (o, m, l), (op, mp, lp) = got, want
        empty = torch.isinf(mp)
        assert torch.equal(torch.isinf(m), empty) and not l[empty].any() and not o[empty].any()
        fin = ~empty
        assert ((m[fin] - mp[fin]).abs() / mp[fin].abs().clamp_min(1.0)).max() <= F32_TOL
        assert ((l[fin] - lp[fin]).abs() / lp[fin]).max() <= F32_TOL
        got, want = o, op
    assert got.dtype == F32 and torch.isfinite(got).all() and _rel(got, want) <= F32_TOL


@pytest.mark.parametrize("B,T", [(6, 200), (10, 1000), (66, 1000)])
@pytest.mark.parametrize("kind", ["decode", "decode_v2", "lse"])
def test_f32_decode_forms_match_plain(gen, kind, B, T):
    """B4, B12 and K1 in f32 over an f32 cache at the decode edges (one span,
    merged spans, a row of length -1): counted in their f32 form, within
    F32_TOL of the plain version; over an fp8 cache bit-equal to the f32
    form on the upcast cache, counted as fp8_f32."""
    G, Hg, D = 2, 16, 128
    q = torch.randn((B, G, Hg, D), device="cuda", generator=gen)
    (k8, k32), (v8, v32) = ((t, t.float()) for t in (_fp8(gen, (B, G, T, D))[0],
                                                     _fp8(gen, (B, G, T, D))[0]))
    k, v = torch.randn_like(k32), torch.randn_like(v32)
    lengths = _decode_edges(B, T, A.decode_span(B * G, T, A.DECODE_BLOCK_K))
    sm = 1 / math.sqrt(D)
    fn, plain, wrapper = _f32_decode(kind, T)
    before, before8 = wrapper.f32.launches, wrapper.fp8_f32.launches
    got = fn(q, k, v, lengths, sm)
    torch.cuda.synchronize()
    _hold_f32(got, plain(q, k, v, lengths, sm))
    got8, same = fn(q, k8, v8, lengths, sm), fn(q, k32, v32, lengths, sm)
    torch.cuda.synchronize()
    pairs = zip(got8, same) if kind == "lse" else [(got8, same)]
    assert all(torch.equal(a, b) for a, b in pairs)
    _hold_f32(got8, plain(q, k8, v8, lengths, sm))
    assert (wrapper.f32.launches, wrapper.fp8_f32.launches) == (before + 2, before8 + 1)


@pytest.mark.parametrize("P,MP", [(16, 64), (256, 4)])
def test_f32_paged_forms_match_plain(gen, P, MP):
    """B10, K2 (each phase of a stride-2 table) and B11 (S = 1, 9, 32, with
    and without a row map) in f32 over an f32 pool within F32_TOL of their
    plain versions, and over an fp8 pool bit-equal to the f32 form on the
    upcast pool."""
    L, G, Hg, D, B = 2, 2, 16, 128, 10
    NP = B * MP + 1
    kp8, vp8 = _fp8(gen, (L, NP, G, P, D))[0], _fp8(gen, (L, NP, G, P, D))[0]
    kp32, vp32 = kp8.float(), vp8.float()
    kp, vp = torch.randn_like(kp32), torch.randn_like(vp32)
    pt = _scattered_table(gen, B, MP, NP)
    lengths = _paged_decode_edges(P, MP, B)
    sm = 1 / math.sqrt(D)
    q = torch.randn((B, G, Hg, D), device="cuda", generator=gen)
    before = A.flash_attention_decode_paged.f32.launches
    got = A.flash_attention_decode_paged(q, kp, vp, 1, pt, lengths, sm)
    torch.cuda.synchronize()
    assert A.flash_attention_decode_paged.f32.launches == before + 1
    _hold_f32(got, A.flash_attention_decode_paged_plain(q, kp, vp, 1, pt, lengths, sm))
    assert torch.equal(A.flash_attention_decode_paged(q, kp8, vp8, 1, pt, lengths, sm),
                       A.flash_attention_decode_paged(q, kp32, vp32, 1, pt, lengths, sm))
    for phase in (0, 1):
        table = pt[:, phase::2].contiguous()
        _hold_f32(A.flash_attention_decode_paged_lse(q, kp, vp, 1, table, lengths, sm, 2, phase),
                  A.flash_attention_decode_paged_lse_plain(q, kp, vp, 1, table, lengths, sm, 2,
                                                           phase))
        got = A.flash_attention_decode_paged_lse(q, kp8, vp8, 1, table, lengths, sm, 2, phase)
        same = A.flash_attention_decode_paged_lse(q, kp32, vp32, 1, table, lengths, sm, 2, phase)
        assert all(torch.equal(a, b) for a, b in zip(got, same))
    cap = MP * P
    starts = torch.tensor([0, P - 1, 700 % cap, cap - 32] + [(97 * i) % (cap - 32)
                                                            for i in range(B - 4)],
                          dtype=torch.int32, device="cuda")
    rmap = torch.randperm(B, device="cuda", generator=gen).to(torch.int32)
    for S in (1, 9, 32):
        qs = torch.randn((B, S, G, Hg, D), device="cuda", generator=gen)
        for row_map in (None, rmap):
            got = A.flash_attention_chunk_paged(qs, kp, vp, 1, pt, starts, sm, row_map)
            torch.cuda.synchronize()
            _hold_f32(got, A.flash_attention_chunk_paged_plain(qs, kp, vp, 1, pt, starts, sm,
                                                               row_map))
            got8 = A.flash_attention_chunk_paged(qs, kp8, vp8, 0, pt, starts, sm, row_map)
            same = A.flash_attention_chunk_paged(qs, kp32, vp32, 0, pt, starts, sm, row_map)
            torch.cuda.synchronize()
            assert torch.equal(got8, same), S


@pytest.mark.parametrize("chunked", [False, True])
def test_f32_prefill_matches_plain(gen, chunked):
    """B5 in f32, whole prompts (lengths 130, 0, 12) and its chunked form
    (starts and a row map over a 512-slot cache), within F32_TOL of the
    plain version; over an fp8 cache bit-equal to the f32 form on the
    upcast cache."""
    G, Hg, D, T, S = 2, 16, 128, 512, 64 if chunked else 130
    Bk = 4 if chunked else 3
    k8, v8 = _fp8(gen, (Bk, G, T, D))[0], _fp8(gen, (Bk, G, T, D))[0]
    k, v = torch.randn((Bk, G, T, D), device="cuda", generator=gen), \
        torch.randn((Bk, G, T, D), device="cuda", generator=gen)
    sm = 1 / math.sqrt(D)
    q = torch.randn((3, S, G, Hg, D), device="cuda", generator=gen)
    if chunked:
        starts = torch.tensor([200, 3, 447], dtype=torch.int32, device="cuda")
        lengths = starts + torch.tensor([40, 64, 0], dtype=torch.int32, device="cuda")
        rmap = torch.tensor([3, 1, 0], dtype=torch.int32, device="cuda")

        def run(kk, vv):
            return A.flash_attention_prefill_chunk(q, kk, vv, lengths, starts, sm, rmap)

        want = A.flash_attention_prefill_plain(q, k, v, lengths, sm, starts, rmap)
    else:
        lengths = torch.tensor([S, 0, 12], dtype=torch.int32, device="cuda")

        def run(kk, vv):
            return A.flash_attention_prefill(q, kk, vv, lengths, sm)

        want = A.flash_attention_prefill_plain(q, k, v, lengths, sm)
    got = run(k, v)
    torch.cuda.synchronize()
    _hold_f32(got, want)
    assert torch.equal(run(k8, v8), run(k8.float(), v8.float()))


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("fp8", [False, True], ids=["f32", "fp8"])
def test_f32_appends_bit_equal_to_plain(gen, paged, fp8):
    """B3 / B9 with the RoPE, K3 on each shard of a 2-way split and the
    write-only forms in f32, into an f32 or an fp8 cache: the rotated q and
    every stored element (byte) equal the plain sequence's (each RoPE
    product and sum the f32 op; into fp8 one rounding from f32)."""
    from chatglm_q_tpu_torch.models.chatglm2 import precompute_freqs_cis

    q, _, _, k, v, pt, cap = _rope_case(gen, 4, paged)
    q = q.float()
    kv = torch.randn((4, 2 * 2 * 128 + 64), device="cuda", generator=gen)[:, :512]  # strided
    table = torch.from_numpy(precompute_freqs_cis(128, 2049)).to("cuda")
    freqs = table[torch.tensor([5, 700, 1500, 2048], device="cuda")]
    k, v = ((A.kv_store_cast(t.float() * 3, FP8) if fp8 else t.float()) for t in (k, v))

    def copy(t):
        return A.kv_bytes(t).clone().view(t.dtype)

    starts = torch.tensor([7, cap - 1, cap, cap + 300], dtype=torch.int32, device="cuda")
    kr, vr = copy(k), copy(v)
    form = "fp8_f32" if fp8 else "f32"
    before = getattr(A.rope_kv_append, form).launches
    got = A.rope_kv_append(q, kv, freqs, k, v, 2, starts, pt)
    want = A.rope_kv_append_plain(q, kv, freqs, kr, vr, 2, starts, pt)
    torch.cuda.synchronize()
    assert getattr(A.rope_kv_append, form).launches == before + 1
    assert got.dtype == F32 and torch.equal(got, want)
    assert _bytes_equal(k, kr) and _bytes_equal(v, vr)
    for r in range(2):
        shard = (A.KVShard(stride=2, phase=r, total=cap) if paged
                 else A.KVShard(offset=r * (cap // 2), total=cap))
        own = slice(r * (cap // 2), (r + 1) * (cap // 2))
        hk, hv = (copy(A.kv_contiguous(t if paged else t[:, :, :, own])) for t in (k, v))
        kk, vv = copy(hk), copy(hv)
        table = None if pt is None else pt[:, r::2].contiguous()
        got = A.rope_kv_append_sharded(q, kv, freqs, hk, hv, 1, starts, shard, table)
        want = A.rope_kv_append_sharded_plain(q, kv, freqs, kk, vv, 1, starts, shard, table)
        torch.cuda.synchronize()
        assert torch.equal(got, want) and _bytes_equal(hk, kk) and _bytes_equal(hv, vv), r
    new = torch.randn((4, k.shape[2], 128), device="cuda", generator=gen) * 100
    if paged:
        A.kv_pool_write_idx(k, new, 0, pt, starts)
        A.kv_pool_write_idx_plain(kr, new, 0, pt, starts)
    else:
        A.kv_cache_write_idx(k, new, 0, starts)
        A.kv_cache_write_idx_plain(kr, new, 0, starts)
    torch.cuda.synchronize()
    assert _bytes_equal(k, kr)


def test_f32_store_into_fp8_rounds_once_as_kv_store_cast(gen):
    """f32 values at every e4m3 exponent and around every rounding midpoint
    (and past ±448, ±inf, NaN) through the write-only append (B3) and the
    fused append's v (B9's pool) into fp8: byte for byte ``kv_store_cast``
    on the card and on the CPU; a bf16 hop first gives other bytes (the
    control)."""
    e = torch.arange(-12, 10, device="cuda").float()
    m = torch.linspace(1, 2, 64, device="cuda")
    grid = (m[None, :] * torch.exp2(e)[:, None]).flatten()
    nudge = torch.tensor([1 - 2 ** -9, 1, 1 + 2 ** -9], device="cuda")
    x = torch.cat([(grid[:, None] * nudge).flatten(), torch.randn(4096, device="cuda",
                                                                  generator=gen) * 64,
                   torch.tensor([448.0, 449.0, 464.0, 1e30, float("inf"), float("nan")],
                                device="cuda")])
    x = torch.cat([x, -x])
    x = torch.cat([x, x.new_zeros(-x.numel() % 256)]).reshape(-1, 2, 128)
    want = A.kv_store_cast(x, FP8)
    assert _bytes_equal(want.cpu(), A.kv_store_cast(x.cpu(), FP8))
    assert not _bytes_equal(want, A.kv_store_cast(x.to(torch.bfloat16), FP8))
    n = x.shape[0]
    cache = A.kv_zeros((1, n, 2, 4, 128), FP8, "cuda")
    before = A.kv_cache_write_idx.fp8_f32.launches
    A.kv_cache_write_idx(cache, x, 0, torch.full((n,), 3, dtype=torch.int32, device="cuda"))
    torch.cuda.synchronize()
    assert A.kv_cache_write_idx.fp8_f32.launches == before + 1
    assert _bytes_equal(cache[0, :, :, 3], want)
    q = torch.zeros((n, 2, 16, 128), device="cuda")
    kv = torch.cat([torch.zeros_like(x), x], dim=1).reshape(n, 512)
    freqs = torch.zeros((n, 128), device="cuda")
    kp, vp = (A.kv_zeros((1, n + 1, 2, 16, 128), FP8, "cuda") for _ in range(2))
    pt = torch.arange(1, n + 1, dtype=torch.int32, device="cuda")[:, None]
    A.rope_kv_append(q, kv, freqs, kp, vp, 0, torch.full((n,), 5, dtype=torch.int32,
                                                          device="cuda"), pt)
    torch.cuda.synchronize()
    assert _bytes_equal(vp[0, 1:, :, 5], want)


@pytest.mark.parametrize("kind", ["decode", "decode_v2", "paged", "chunk", "prefill"])
def test_f32_over_fp8_read_is_exact_for_all_256_bytes(gen, kind):
    """As the 16-bit readers' test: V slot 0 of two groups holds all 256
    bytes, one valid slot, p = 1, so each head outputs the f32 upcast of
    every byte; NaN where the byte is NaN."""
    B, G, Hg, D, T = 1, 2, 4, 128, 64
    v8 = A.kv_zeros((B, G, T, D), FP8, "cuda")
    v8.view(torch.uint8)[0, :, 0] = torch.arange(256, device="cuda").to(torch.uint8).reshape(2, 128)
    k8 = A.kv_zeros((B, G, T, D), FP8, "cuda")
    want = v8[0, :, 0].float()
    q = torch.randn((B, G, Hg, D), device="cuda", generator=gen)
    zero = torch.zeros((B,), dtype=torch.int32, device="cuda")
    if kind in ("decode", "decode_v2"):
        fn = A.flash_attention_decode if kind == "decode" else A.flash_attention_decode_v2
        out = fn(q, k8, v8, zero, 0.1)[0]
    elif kind == "prefill":
        out = A.flash_attention_prefill(q[:, None], k8, v8, zero + 1, 0.1)[0, 0]
    else:
        kp, vp = k8[None], v8[None]
        pt = torch.zeros((1, 1), dtype=torch.int32, device="cuda")
        if kind == "paged":
            out = A.flash_attention_decode_paged(q, kp, vp, 0, pt, zero, 0.1)[0]
        else:
            out = A.flash_attention_chunk_paged(q[:, None], kp, vp, 0, pt, zero, 0.1)[0, 0]
    torch.cuda.synchronize()
    ref = want[:, None].expand_as(out)
    nan = torch.isnan(ref)
    assert nan.sum() == 2 * Hg
    assert torch.equal(torch.isnan(out), nan) and torch.equal(out[~nan], ref[~nan])


@pytest.mark.parametrize("kv_dtype", [F32, FP8], ids=["f32", "fp8"])
def test_f32_captured_decode_steps_equal_eager(gen, kv_dtype):
    """``multi_step_decode`` at depth 2, 6B widths, f32 activations over an
    f32 or an fp8 cache: captured against eager over 8 steps, the tokens
    and every cache byte equal; B1's f32 split-K form (never the gemv) and
    the attention kernels' f32 (fp8_f32) forms launched, 8 steps' worth."""
    from chatglm_q_tpu_torch import TorchRuntimeConfig, ops
    from chatglm_q_tpu_torch.models import chatglm2 as M

    cfg, params = _depth2_tree(gen)
    ids = torch.randint(0, cfg.vocab_size, (4, 16), device="cuda", generator=gen)
    lengths = torch.tensor([16, 11, 7, 3], dtype=torch.int32, device="cuda")
    cache = M.init_kv_cache(cfg, 4, 256, kv_dtype)
    logits, cache = M.prefill(params, cfg, ids, lengths, cache, "int4g32", F32)
    assert logits.dtype == F32 and torch.isfinite(logits).all()
    first = torch.argmax(logits, -1).to(torch.int32)

    def copy(t):
        return A.kv_bytes(t).clone().view(t.dtype)

    runs = {}
    for graphs in (False, True):
        c = M.KVCache(copy(cache.k), copy(cache.v), cache.lengths.clone())
        ops.reset_launch_counts()
        toks, out = M.multi_step_decode(params, cfg, first, c, 8, None, "int4g32", F32,
                                        TorchRuntimeConfig(cuda_graphs=graphs))
        torch.cuda.synchronize()
        runs[graphs] = (toks, out, ops.launch_counts())
    (t0, c0, n0), (t1, c1, n1) = runs[False], runs[True]
    assert torch.equal(t0, t1) and _bytes_equal(c0.k, c1.k) and _bytes_equal(c0.v, c1.v)
    form = "f32" if kv_dtype == F32 else "fp8_f32"
    assert n0 == n1 and n1["int4g32_splitk_f32"] == 8 * (6 * cfg.num_layers + 1)
    assert n1["int4g32_gemv"] == 0
    assert n1[f"rope_kv_append_{form}"] == n1[f"flash_attention_decode_{form}"] == \
        n1["flash_attention_decode"] == 8 * cfg.num_layers
    prog = M.decode_program(params, cfg, c1, "int4g32", F32, TorchRuntimeConfig())
    assert prog.graph is not None and prog.replays == 7


# ---------------------------------------------------------------------------
# B1's and B6's f32 forms: f32 x as its three bf16 pieces on the tensor cores
# (the split-K kernels, the Hopper kernels after the split pass), held to F32_TOL and to F32_SUM_C · 2^-24 · Σ|x·w| of the plain
# version per element
# ---------------------------------------------------------------------------

# chip_smoke.py's: 1.5x the largest reading of |kernel - plain| / (2^-24
# Σ|x_k w_k|) over its three seeds; a control without lo exceeds it
F32_SUM_C = 25.0
F32_LINEARS = [(4096, 4096), (4096, 512), (13824, 4096), (4096, 13824), (4096, 65536)]
F32_MATMUL_M = (1, 4, 16, 36, 57, 128, 512)


def _f32_kind(kind):
    """(weights, matmul, plain, route, wrappers by route) of B1 or B6."""
    if kind == "int4g32":
        return (_int4_weights, QM.int4g32_matmul, QM.int4g32_matmul_plain, QM.int4_route,
                {"splitk": QM.int4g32_splitk, "mma": QM.int4g32_mma, "gemv": QM.int4g32_gemv})
    return (_int8_weights, I8.int8_matmul, I8.int8_matmul_plain, I8.int8_route,
            {"splitk": I8.int8_splitk, "mma": I8.int8_mma, "gemv": I8.int8_gemv})


def _f32_terms(kind, x, w, s):
    """Σ_k |x_k · w_k| of each output in f64 (int8: times the column scale)."""
    if kind == "int4g32":
        return x.double().abs() @ QM.unpack_int4_tpu(w, s).double().abs()
    return (x.double().abs() @ w.double().abs()) * s.double()


def _f32_reading(got, want, terms):
    """max |got - want| / (2^-24 Σ|terms|) over the outputs."""
    return ((got.double() - want.double()).abs() / (2.0 ** -24 * terms).clamp_min(1e-300)
            ).max().item()


def _f32_counts(wrappers):
    return {**{k: fn.f32.launches for k, fn in wrappers.items()},
            "pass": QM.split_bf16x3_pass.launches}


@pytest.mark.parametrize("M", F32_MATMUL_M)
@pytest.mark.parametrize("K,N", F32_LINEARS)
@pytest.mark.parametrize("kind", ["int4g32", "int8"])
def test_f32_forms_match_plain(gen, kind, K, N, M):
    """One launch of the route's f32 form (the Hopper form after one split
    pass), none of the gemv; within F32_TOL of max|plain| and F32_SUM_C ·
    2^-24 · Σ|x·w| of plain per output, TF32 off."""
    assert not torch.backends.cuda.matmul.allow_tf32
    weights, fn, plain, route, wrappers = _f32_kind(kind)
    w, s = weights(gen, K, N)
    x = torch.randn((M, K), device="cuda", generator=gen)
    r = route(M, N, F32)
    assert r in ("splitk", "mma")
    before = _f32_counts(wrappers)
    got = fn(x, w, s)
    torch.cuda.synchronize()
    after = _f32_counts(wrappers)
    want = {k: int(k == r) for k in wrappers}
    want["pass"] = int(r == "mma")
    assert {k: after[k] - before[k] for k in after} == want
    ref = plain(x, w, s)
    assert got.dtype == F32 and got.shape == (M, N) and torch.isfinite(got).all()
    assert _rel(got, ref) <= F32_TOL
    assert _f32_reading(got, ref, _f32_terms(kind, x, w, s)) <= F32_SUM_C


@pytest.mark.parametrize("M", range(1, QM.F32_SPLITK_MAX + 1))
@pytest.mark.parametrize("kind", ["int4g32", "int8"])
def test_f32_splitk_agrees_with_plain(gen, kind, M):
    """The split-K kernel's f32 form at every row count it takes, on one
    narrow and one wide linear: within the f32 limits."""
    weights, _, plain, _, wrappers = _f32_kind(kind)
    for K, N in ((4096, 512), (4096, 4096)):
        w, s = weights(gen, K, N)
        x = torch.randn((M, K), device="cuda", generator=gen)
        got = wrappers["splitk"](x, w, s)
        ref = plain(x, w, s)
        assert _rel(got, ref) <= F32_TOL
        assert _f32_reading(got, ref, _f32_terms(kind, x, w, s)) <= F32_SUM_C


def _f32_edge_rows(gen, M, K, kind):
    """f32 rows across 2^-60 .. 2^60, a row of subnormals, a row each with
    one inf, one -inf, one NaN, and (int8) two rows each with one f32 value
    above bf16's largest finite one.  (int4g32 takes no such row: its
    group partial of unscaled integers overflows there where the plain
    version's x · (q·s) does not, the grouped scheme's range.)"""
    x = torch.randn((M, K), device="cuda", generator=gen)
    e = torch.linspace(-60, 60, M, device="cuda").round()
    x = x * torch.exp2(e)[:, None]
    x[1] = torch.randn(K, device="cuda", generator=gen) * 2.0 ** -130  # subnormal
    x[2, 5], x[3, 77], x[4, 300] = float("inf"), float("-inf"), float("nan")
    if kind == "int8":
        x[5, 0], x[6, 0] = 3.4e38, -3.3896e38
    return x


@pytest.mark.parametrize("M", (8, 40, 200))
@pytest.mark.parametrize("kind", ["int4g32", "int8"])
def test_f32_forms_on_edge_rows(gen, kind, M):
    """Wide-range, subnormal and non-finite rows: the plain version's NaN and
    inf positions exactly; each finite output within F32_SUM_C · 2^-24 ·
    Σ|x·w| of its exact value, plus 2^-134 · Σ|w| where x's split is not
    exact (|x| < 2^-110).  The Hopper form takes the M rows in one call,
    the split-K form (at M = 8) F32_SPLITK_MAX rows a call."""
    weights, fn, plain, route, _ = _f32_kind(kind)
    K, N = 4096, 512
    w, s = weights(gen, K, N)
    if kind == "int8":  # |w| <= 1 under the near-max values: finite outputs there
        w[0, :256] = torch.randint(-1, 2, (256,), device="cuda", generator=gen).to(torch.int8)
    x = _f32_edge_rows(gen, M, K, kind)
    outs = [fn(x, w, s)]
    if M == 8:
        step = QM.F32_SPLITK_MAX
        outs.append(torch.cat([fn(x[i:i + step], w, s) for i in range(0, M, step)]))
        assert route(step, N, F32) == "splitk" and route(M, N, F32) == "mma"
    torch.cuda.synchronize()
    ref = plain(x, w, s)
    fin = torch.isfinite(ref)
    xd = torch.where(torch.isfinite(x), x, torch.zeros_like(x)).double()
    if kind == "int4g32":
        wd = QM.unpack_int4_tpu(w, s).double()
        exact, terms = xd @ wd, xd.abs() @ wd.abs()
        wsum = wd.abs().sum(0)[None, :]
    else:
        exact = (xd @ w.double()) * s.double()
        terms = (xd.abs() @ w.double().abs()) * s.double()
        wsum = (w.double().abs().sum(0) * s.double())[None, :]
    limit = F32_SUM_C * 2.0 ** -24 * terms + 2.0 ** -134 * wsum
    for got in outs:
        for test in (torch.isnan, torch.isposinf, torch.isneginf):
            assert torch.equal(test(got), test(ref))
        err = (got.double() - exact).abs()
        assert (err[fin] <= limit[fin]).all(), (err / limit)[fin].max().item()


@pytest.mark.parametrize("M", (1, 4, 16, 36, 128))
@pytest.mark.parametrize("kind", ["int4g32", "int8"])
def test_f32_forms_replay_in_a_graph_bit_equal(gen, kind, M):
    """The f32 forms captured in a CUDA graph (after an eager call sizes the
    scratch) replay the eager call's output bit for bit, on new inputs
    copied in place."""
    weights, fn, _, _, _ = _f32_kind(kind)
    w, s = weights(gen, 4096, 512)
    x = torch.randn((M, 4096), device="cuda", generator=gen)
    fn(x, w, s)  # sizes the scratch buffers
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(stream):
        fn(x, w, s)
        with torch.cuda.graph(graph, stream=stream):
            out = fn(x, w, s)
    torch.cuda.current_stream().wait_stream(stream)
    for _ in range(2):
        x.copy_(torch.randn((M, 4096), device="cuda", generator=gen))
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, fn(x, w, s))

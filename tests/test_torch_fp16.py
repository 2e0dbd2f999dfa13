"""float16 activations in the port (a float16 checkpoint served as it says)
against the JAX package, on the CPU, fed the same numpy inputs.

* The kernels' f16 conversions emulated bit for bit: a packed int4 byte to
  its f16x2 pair over f16 1024 (csrc/common.cuh ``nibble_pair<__half>``),
  over all 256 bytes at each byte position of a word, and four int8 bytes
  to two f16x2 pairs (``s8x4_f16x2``), over all 256 values.
* Routing and refusal on tensors that say they are on CUDA: B1 / B6 (and
  B13 / B14) send f16 to their tensor-core kernels, every matmul entry
  receives the activations' dtype code, every attention entry the f16
  form's code; f32 attention, or f16 activations over a bf16 cache, raise
  ``TypeError`` (B7 / B8 / B13 / B14 in f16 and f16 over fp8 are ported:
  tests/test_torch_fp16_rest.py).
* Each plain version in f16 against JAX's function in f16 (its Pallas
  kernel in interpret mode): B1 / B2 and B6 at M = 1, 4, 36, 128; B4, B12,
  B10, B11, B5 (both forms), K1, K2; the writes B3 / B9, the fused RoPE +
  append and K3 bit for bit.
* B1 at scales whose q·s f16 cannot hold: the port (and JAX's grouped
  Pallas scheme) keep q·s exact in f32; JAX's jnp fallback and its default
  Pallas scheme round it to f16 (to a subnormal, to 0, to inf).
* The model at depth 2 (int8, int4g32; prefill and 8 decode steps, dense
  and paged) in f16 against JAX's in f16; and the launch path: a float16
  checkpoint written by ``examples/quantize_naive.py`` through
  ``GLMDecoder.from_pretrained`` gives JAX's decoder's text.

Each tolerance is stated beside its test, about 1.5x the largest reading
on these inputs; f16 rounds at 2^-11, so they sit under the bf16 tests'.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from chatglm_q_tpu.config import ChatGLM2Config as JConfig, TpuRuntimeConfig  # noqa: E402
from chatglm_q_tpu.models import chatglm2 as JM  # noqa: E402
from chatglm_q_tpu.models import paged_kv as JPK  # noqa: E402
from chatglm_q_tpu.ops import linear as JL  # noqa: E402
from chatglm_q_tpu.ops import pallas_attention as PA  # noqa: E402
from chatglm_q_tpu.ops import pallas_matmul as PM  # noqa: E402
from chatglm_q_tpu.serving.decoder import GLMDecoder as JDecoder  # noqa: E402
from chatglm_q_tpu_torch import ChatGLM2Config, GLMLoadConfig, TorchRuntimeConfig  # noqa: E402
from chatglm_q_tpu_torch import loader as TLD  # noqa: E402
from chatglm_q_tpu_torch.convert import params_from_numpy  # noqa: E402
from chatglm_q_tpu_torch.examples import quantize_naive  # noqa: E402
from chatglm_q_tpu_torch.models import chatglm2 as TM  # noqa: E402
from chatglm_q_tpu_torch.models import paged_kv as TPK  # noqa: E402
from chatglm_q_tpu_torch.ops import _build  # noqa: E402
from chatglm_q_tpu_torch.ops import attention as A  # noqa: E402
from chatglm_q_tpu_torch.ops import dyn_matmul as D  # noqa: E402
from chatglm_q_tpu_torch.ops import int8_matmul as I8  # noqa: E402
from chatglm_q_tpu_torch.ops import quant_matmul as QM  # noqa: E402
from chatglm_q_tpu_torch.ops.quant import unpack_int4_tpu, unpack_int4_tpu_q  # noqa: E402
from chatglm_q_tpu_torch.serving import GLMDecoder  # noqa: E402
from chatglm_q_tpu_torch.tokenizer import ChatGLM2Tokenizer  # noqa: E402
from chatglm_q_tpu_torch.tokenizer.build import build_unigram_model  # noqa: E402

F16, JF16 = torch.float16, jnp.float16
# A matmul output against JAX's, max|Δ| / max|JAX|: both sum exact products
# (q·s is exact in f16's normal range) in f32 and round once to f16, in
# another order, so they differ by up to one f16 ulp (2^-11 of the top
# binade).  Largest reading 4.66e-4 (B1 against the exact function).
MATMUL_TOL = 7e-4
# B6 against JAX's jnp fallback, which rounds the scale and w·s to f16
# first: largest reading 7.77e-4.
INT8_FALLBACK_TOL = 1.2e-3
# An attention output against JAX's kernel, the same measure: p rounded to
# f16 at other places (per block on the TPU, per row here), then the
# output's own rounding.  Largest reading 7.05e-4 (B5).
ATT_TOL = 1.1e-3
# Logits of the depth-2 model against JAX's, the same measure: f16
# roundings at other places carried through two layers.  Largest reading
# 1.07e-3 (int8, dense).
LOGIT_TOL = 1.6e-3


def _randn(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _t(a, dtype=None):
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t if dtype is None else t.to(dtype)


def _f16(a):
    """numpy f32 -> the same f16 values in both packages."""
    return jnp.asarray(a, JF16), _t(a, F16)


def _rel(got, want):
    got = got.double().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float64)
    want = np.asarray(jnp.asarray(want, jnp.float32), np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


# ---------------------------------------------------------------------------
# The kernels' f16 conversions, bit for bit
# ---------------------------------------------------------------------------

def _f16_from_bits(bits):
    """int tensor of 16-bit patterns -> their f16 values as f32."""
    return bits.to(torch.int32).to(torch.int16).view(F16).float()


@pytest.mark.parametrize("p", range(4))
def test_nibble_f16_conversion_is_exact_for_every_byte(p):
    """nibble_pair<__half>(__byte_perm(w, w >> 4, sel(p))): the LOP3 writes
    (v & 0x000F000F) ^ 0x64086408, f16 1032 + q, and fma.rn.f16x2 by 1.0
    and -1032 gives q, exactly, for both nibbles of every byte."""
    rng = np.random.default_rng(p)
    b = torch.arange(256, dtype=torch.int64)
    w = b << (8 * p)
    for i in [i for i in range(4) if i != p]:  # neighbouring bytes must not leak in
        w = w | torch.from_numpy(rng.integers(0, 256, 256)) << (8 * i)
    sh = w >> 4
    byte = lambda v: (v >> (8 * p)) & 0xFF  # noqa: E731
    v = byte(w) | byte(w) << 8 | byte(sh) << 16 | byte(sh) << 24  # the PRMT
    v = (v & 0x000F000F) ^ 0x64086408
    lo, hi = (_f16_from_bits(h) + _f16_from_bits(torch.tensor([0xE408]))
              for h in (v & 0xFFFF, v >> 16))
    assert _f16_from_bits(torch.tensor([0xE408])).item() == -1032.0
    for h in (lo, hi):  # fma.rn.f16x2 rounds to f16: the result must already be one
        assert torch.equal(h.to(F16).float(), h)
    q = unpack_int4_tpu_q(b.to(torch.uint8)[None]).float()  # (2, 256): low, high nibble
    assert torch.equal(lo, q[0]) and torch.equal(hi, q[1])


def test_s8_f16_conversion_is_exact_for_every_byte():
    """s8x4_f16x2: PRMT writes b + 128 under the byte 0x64 (f16 1024 + 128 +
    b), fma.rn.f16x2 by 1.0 and -1152 gives b; lo holds bytes 0, 1 and hi
    bytes 2, 3, the lower byte in bits 0-15."""
    vals = torch.arange(-128, 128, dtype=torch.int64)
    w = (vals & 0xFF) | ((vals.roll(1) & 0xFF) << 8) | ((vals.roll(2) & 0xFF) << 16) \
        | ((vals.roll(3) & 0xFF) << 24)
    x = w ^ 0x80808080
    minus = _f16_from_bits(torch.tensor([0xE480]))
    assert minus.item() == -1152.0
    got = []
    for sel in ((0, 1), (2, 3)):
        for j in sel:
            h = ((x >> (8 * j)) & 0xFF) | 0x6400  # the byte under 0x64
            got.append(_f16_from_bits(h) + minus)
    for g, shift in zip(got, range(4)):
        assert torch.equal(g.to(F16).float(), g)
        assert torch.equal(g, vals.roll(shift).float())


# ---------------------------------------------------------------------------
# Routing and refusal on tensors that say they are on CUDA
# ---------------------------------------------------------------------------

class _Launched(Exception):
    pass


class _FakeCuda(torch.Tensor):
    @property
    def is_cuda(self):
        return True


@pytest.fixture
def fake_launch(monkeypatch):
    def call(name, *args):
        raise _Launched(name, args)

    monkeypatch.setattr(_build, "call", call)
    monkeypatch.setattr(_build, "stream_ptr", lambda t: 0)
    monkeypatch.setattr(_build, "scratch",
                        lambda kind, device, n, dtype: torch.zeros(max(n, 1), dtype=dtype))


def _fake(t):
    return t.as_subclass(_FakeCuda)


def test_routes_send_f16_to_the_tensor_cores():
    for M in (1, 4, 16, 36, QM.SMALL_M_MAX):
        assert QM.int4_route(M, 4096, F16) == QM.int4_route(M, 4096, torch.bfloat16) == "splitk"
    for M in (QM.SMALL_M_MAX + 1, 128, 512):
        assert QM.int4_route(M, 4096, F16) == "mma"
        assert QM.int4_route(M, 264, F16) == "gemv"  # the Hopper kernel needs N % 16 == 0
    for M in (1, 4, 16):
        assert I8.int8_route(M, 4096, F16) == "splitk"
    for M in (17, 36, 128):
        assert I8.int8_route(M, 4096, F16) == "mma"
    assert QM.uses_mma(17, 4096, F16) and not QM.uses_mma(17, 4096, torch.float32)
    # the backward takes f16 g as bf16 g: the Hopper kernel above 16 rows
    assert QM.t_route(512, 4096, F16) == "mma" and QM.t_route(16, 4096, F16) == "splitk"


# (wrapper, M, N, entry, index of M among its arguments: M, K, N, then the
# dtype code)
MATMUL_ENTRIES = [
    ("int4", 1, 256, "chatglm_int4_splitk_mma", 6), ("int4", 36, 256, "chatglm_int4_splitk_mma", 6),
    ("int4", 128, 256, "chatglm_int4_wgmma", 6), ("int4", 128, 264, "chatglm_int4_gemv", 5),
    ("int8", 1, 256, "chatglm_int8_splitk_mma", 6), ("int8", 36, 256, "chatglm_int8_mma", 6),
    ("int8", 128, 264, "chatglm_int8_gemv", 5)]


@pytest.mark.parametrize("kind,M,N,entry,at", MATMUL_ENTRIES)
def test_matmul_entries_receive_the_f16_dtype_code(fake_launch, kind, M, N, entry, at):
    x = _fake(torch.zeros((M, 256), dtype=F16))
    with pytest.raises(_Launched) as launched:
        if kind == "int4":
            QM.int4g32_matmul(x, torch.zeros((128, N), dtype=torch.uint8),
                              torch.ones((8, N), dtype=torch.bfloat16))
        else:
            I8.int8_matmul(x, torch.zeros((256, N), dtype=torch.int8), torch.ones(N))
    name, args = launched.value.args
    assert name == entry
    assert args[at:at + 4] == (M, 256, N, _build.dtype_code(F16)) and _build.dtype_code(F16) == 2
    # and bf16 still gets bf16's code, f32 f32's
    assert _build.dtype_code(torch.bfloat16) == 1 and _build.dtype_code(torch.float32) == 0


def test_unported_f16_forms_raise_naming_the_dtype(fake_launch):
    """What stays unported raises naming the dtype pair: f16 activations
    over a bf16 cache (two 16-bit types), f32 activations over a 16-bit
    cache.  The f16 forms of B7 / B8 / B13 / B14 (and f16 over an fp8
    cache, tests/test_torch_fp16_rest.py) reach their kernels, and so does
    f32 attention over an f32 or an fp8 cache (forms 4 and 5,
    tests/test_torch_fp32.py)."""
    x = _fake(torch.zeros((4, 256), dtype=F16))
    w8, s8 = torch.zeros((256, 256), dtype=torch.int8), torch.ones(256)
    p4, s4 = torch.zeros((128, 256), dtype=torch.uint8), torch.ones((8, 256), dtype=torch.bfloat16)
    for fn, args, entry in ((D.int8_dyn_matmul, (x, w8, s8), "chatglm_int8_dyn_splitk"),
                            (D.int4_dyn_matmul, (x, p4, s4), "chatglm_int4_dyn_splitk"),
                            (I8.int8_matmul_t, (x, w8, s8), "chatglm_int8_t_splitk"),
                            (QM.int4g32_matmul_t, (x, p4, s4), "chatglm_int4_t_splitk")):
        with pytest.raises(_Launched) as launched:  # the f16 forms: ported
            fn(*args)
        assert launched.value.args[0] == entry
    q = _fake(torch.zeros((2, 2, 4, 128)))
    k = _fake(torch.zeros((2, 2, 64, 128)))
    lens = _fake(torch.zeros((2,), dtype=torch.int32))
    for cache, form in ((k, 4), (k.to(A.FP8), 5)):  # f32 attention: ported
        with pytest.raises(_Launched) as launched:
            A.flash_attention_decode(q, cache, cache, lens, 0.1)
        assert launched.value.args[0] == "chatglm_decode_attention"
        assert launched.value.args[1][-2] == form
    with pytest.raises(TypeError, match="bfloat16"):  # f32 over a 16-bit cache
        A.flash_attention_decode(q, k.to(torch.bfloat16), k.to(torch.bfloat16), lens, 0.1)
    with pytest.raises(TypeError, match="bfloat16"):  # two 16-bit types
        A.flash_attention_decode(q.to(F16), k.to(torch.bfloat16), k.to(torch.bfloat16), lens, 0.1)


def _attention_calls():
    """One call of each attention wrapper on f16 tensors (q, caches, pools)."""
    q = _fake(torch.zeros((2, 2, 4, 128), dtype=F16))
    qs = _fake(torch.zeros((2, 3, 2, 4, 128), dtype=F16))
    k = _fake(torch.zeros((2, 2, 64, 128), dtype=F16))
    cache = _fake(torch.zeros((2, 2, 2, 64, 128), dtype=F16))
    pool = _fake(torch.zeros((2, 6, 2, 16, 128), dtype=F16))
    pt = _fake(torch.zeros((2, 3), dtype=torch.int32))
    lens = _fake(torch.ones((2,), dtype=torch.int32))
    kv = _fake(torch.zeros((2, 512), dtype=F16))
    fr = _fake(torch.zeros((2, 128), dtype=F16))
    new = _fake(torch.zeros((2, 2, 128), dtype=F16))
    return {
        "chatglm_decode_attention": lambda: A.flash_attention_decode(q, k, k, lens, 0.1),
        "chatglm_decode_attention v2": lambda: A.flash_attention_decode_v2(q, k, k, lens, 0.1),
        "chatglm_decode_attention lse": lambda: A.flash_attention_decode_lse(q, k, k, lens, 0.1),
        "chatglm_prefill_attention": lambda: A.flash_attention_prefill(qs, k, k, lens, 0.1),
        "chatglm_prefill_attention chunk": lambda: A.flash_attention_prefill_chunk(
            qs, k, k, lens, lens, 0.1),
        "chatglm_decode_paged": lambda: A.flash_attention_decode_paged(q, pool, pool, 1, pt, lens,
                                                                       0.1),
        "chatglm_decode_paged lse": lambda: A.flash_attention_decode_paged_lse(
            q, pool, pool, 1, pt, lens, 0.1, 2, 1),
        "chatglm_chunk_paged": lambda: A.flash_attention_chunk_paged(qs, pool, pool, 1, pt, lens,
                                                                     0.1),
        "chatglm_rope_kv_append": lambda: A.rope_kv_append(q, kv, fr, cache, cache, 1, lens),
        "chatglm_rope_kv_append sharded": lambda: A.rope_kv_append_sharded(
            q, kv, fr, cache, cache, 1, lens, A.KVShard(offset=64, total=128)),
        "chatglm_kv_append": lambda: A.kv_cache_write_idx(cache, new, 1, lens),
        "chatglm_kv_append pool": lambda: A.kv_pool_write_idx(pool, new, 1, pt, lens),
    }


@pytest.mark.parametrize("key", list(_attention_calls()))
def test_attention_entries_receive_the_f16_form(fake_launch, key):
    with pytest.raises(_Launched) as launched:
        _attention_calls()[key]()
    name, args = launched.value.args
    assert name == key.split()[0]
    assert args[-2] == A.FORM_CODES[(F16, F16)] == 2  # the form code, before the stream


# ---------------------------------------------------------------------------
# B1 / B2 and B6: the plain versions in f16 against JAX's kernels in f16
# ---------------------------------------------------------------------------

def _int4_weights(K, N, seed, scale=0.02):
    rng = np.random.default_rng(seed)
    packed = rng.integers(0, 256, (K // 2, N), dtype=np.uint8)
    s = (rng.random((K // 32, N), dtype=np.float32) * scale).astype(jnp.bfloat16)
    return packed, s


def _bf16_t(a):
    return _t(np.asarray(a).astype(np.float32), torch.bfloat16)


@pytest.mark.parametrize("M", [1, 4, 36, 128])
def test_int4_plain_f16_matches_jax(M):
    """B1 (the grid kernel) and, at M <= 64, B2 (the decode-M kernel),
    JAX's Pallas in interpret mode in f16."""
    K, N = 1024, 256
    packed, s = _int4_weights(K, N, M)
    jx, tx = _f16(_randn((M, K), 100 + M))
    got = QM.int4g32_matmul(tx, _t(packed), _bf16_t(s))
    assert got.dtype == F16
    want = PM.int4_matmul_pallas(jx, jnp.asarray(packed), jnp.asarray(s), interpret=True)
    assert want.dtype == JF16
    assert _rel(got, want) <= MATMUL_TOL
    if M <= 64:
        want2 = PM.int4_matmul_pallas_pipelined(jx, jnp.asarray(packed), jnp.asarray(s),
                                                interpret=True)
        assert want2 is not None and _rel(got, want2) <= MATMUL_TOL


@pytest.mark.parametrize("M", [1, 4, 36, 128])
def test_int8_plain_f16_matches_jax(M):
    """B6 against JAX's Pallas kernel in f16 (the f32 scale on the f32 sum)
    and against its jnp fallback (the scale and w·s rounded to f16 first)."""
    K, N = 512, 256
    rng = np.random.default_rng(M)
    w = rng.integers(-128, 128, (K, N), dtype=np.int8)
    scale = ((0.5 + rng.random(N, dtype=np.float32)) * 0.01).astype(np.float32)
    jx, tx = _f16(_randn((M, K), 200 + M))
    got = I8.int8_matmul(tx, _t(w), _t(scale))
    assert got.dtype == F16
    want = PM.int8_matmul_pallas(jx, jnp.asarray(w), jnp.asarray(scale), interpret=True)
    assert _rel(got, want) <= MATMUL_TOL
    fallback = JL._int8_matmul_fallback(jx, jnp.asarray(w), jnp.asarray(scale))
    assert _rel(got, fallback) <= INT8_FALLBACK_TOL


# (scale exponent, what JAX's jnp fallback gives) for B1 where q·s leaves f16's normal range
EDGE_SCALES = [(-10, "normal"), (-20, "subnormal"), (-27, "flush"), (13, "inf")]
X_EXP = {"normal": 0, "subnormal": 8, "flush": 12, "inf": -13}


@pytest.mark.parametrize("e,case", EDGE_SCALES)
def test_int4_f16_scales_past_the_normal_range(e, case):
    """q·s (at most 11 significant bits) is exact in f16's normal range, so
    every form agrees there.  At a scale whose q·s is an f16 subnormal
    (below 2^-14), below f16's smallest subnormal, or past 65504, the port
    (its plain version and its kernels: the f32 scale on the f32 partial)
    and JAX's grouped Pallas scheme keep q·s exactly; JAX's jnp fallback
    (linear.py:119-121) and its default Pallas scheme round it to f16 first:
    off by up to half a subnormal step, to one bit or none, to inf."""
    K, N, M = 256, 128, 4
    packed, s = _int4_weights(K, N, 7 + abs(e), scale=1.0)
    s = (np.asarray(s, np.float32) * 2.0 ** e).astype(jnp.bfloat16)
    # x scaled so that the outputs are f16 normals: only q·s leaves the range
    x = _randn((M, K), 300, scale=2.0 ** X_EXP[case])
    jx, tx = _f16(x)
    got = QM.int4g32_matmul(tx, _t(packed), _bf16_t(s))
    # the exact function in f64, rounded once to f16
    w64 = unpack_int4_tpu(_t(packed), _bf16_t(s)).double()
    exact = (tx.double() @ w64).to(F16)
    assert torch.isfinite(got).all()
    assert _rel(got, exact.float().numpy()) <= MATMUL_TOL
    grouped = PM.int4_matmul_pallas(jx, jnp.asarray(packed), jnp.asarray(s), scheme="grouped",
                                    interpret=True)
    assert _rel(got, grouped) <= MATMUL_TOL
    fallback = np.asarray(JL._int4_matmul_fallback(jx, jnp.asarray(packed), jnp.asarray(s)),
                          np.float32)
    if case == "normal":
        assert _rel(got, fallback) <= MATMUL_TOL
    elif case == "subnormal":  # q·s kept to 2^-24: read 6.5e-3 on these inputs
        assert np.isfinite(fallback).all() and _rel(got, fallback) > 2 * MATMUL_TOL
    elif case == "flush":  # q·s to 0 or one 2^-24 step
        assert _rel(got, fallback) > 0.1
    else:
        assert not np.isfinite(fallback).all()


# ---------------------------------------------------------------------------
# The attention forms: plain versions in f16 against JAX's kernels in f16
# ---------------------------------------------------------------------------

SM = 1.0 / math.sqrt(128)
PT = np.array([[5, 2, 7, 3], [8, 1, 6, 4]], np.int32)


def _pool(seed, L=2, NP=9, G=2, P=16, D=128):
    return _f16(_randn((L, NP, G, P, D), seed)), _f16(_randn((L, NP, G, P, D), seed + 1))


def test_decode_plain_f16_matches_jax():
    """B4: p rounded to v's dtype, f16."""
    B, G, Hg, D, T = 2, 2, 4, 128, 256
    (jq, tq), (jk, tk), (jv, tv) = (_f16(_randn(s, i)) for i, s in
                                    enumerate([(B, G, Hg, D), (B, G, T, D), (B, G, T, D)]))
    lengths = np.array([200, 37], np.int32)
    want = PA.flash_attention_decode(jq, jk, jv, jnp.asarray(lengths), SM, 64, interpret=True)
    got = A.flash_attention_decode(tq, tk, tv, _t(lengths), SM)
    assert got.dtype == F16 and _rel(got, want) <= ATT_TOL


def test_decode_v2_plain_f16_matches_jax():
    """B12: q pre-scaled in f16, p in f32."""
    B, G, Hg, D, T = 2, 2, 4, 128, 256
    (jq, tq), (jk, tk), (jv, tv) = (_f16(_randn(s, 10 + i)) for i, s in
                                    enumerate([(B, G, Hg, D), (B, G, T, D), (B, G, T, D)]))
    lengths = np.array([255, 70], np.int32)
    want = PA.flash_attention_decode_v2(jq, jk, jv, jnp.asarray(lengths), SM, block_k=128,
                                        interpret=True)
    got = A.flash_attention_decode_v2(tq, tk, tv, _t(lengths), SM, 128)
    assert got.dtype == F16 and _rel(got, want) <= ATT_TOL


def test_decode_paged_plain_f16_matches_jax():
    """B10."""
    (jk, tk), (jv, tv) = _pool(20)
    jq, tq = _f16(_randn((2, 2, 4, 128), 22))
    lengths = np.array([50, 9], np.int32)
    want = PA.flash_attention_decode_paged(jq, jk, jv, jnp.int32(1), jnp.asarray(PT),
                                           jnp.asarray(lengths), SM, interpret=True)
    got = A.flash_attention_decode_paged(tq, tk, tv, 1, _t(PT), _t(lengths), SM)
    assert got.dtype == F16 and _rel(got, want) <= ATT_TOL


def test_chunk_paged_plain_f16_matches_jax():
    """B11."""
    (jk, tk), (jv, tv) = _pool(30)
    jq, tq = _f16(_randn((2, 5, 2, 4, 128), 32))
    starts = np.array([40, 3], np.int32)
    want = PA.flash_attention_chunk_paged(jq, jk, jv, jnp.int32(0), jnp.asarray(PT),
                                          jnp.asarray(starts), SM, interpret=True)
    got = A.flash_attention_chunk_paged(tq, tk, tv, 0, _t(PT), _t(starts), SM)
    assert got.dtype == F16 and _rel(got, want) <= ATT_TOL


@pytest.mark.parametrize("chunked", [False, True])
def test_prefill_plain_f16_matches_jax(chunked):
    """B5, whole prompts and its chunked (q_starts) form."""
    B, S, G, Hg, D, T = 2, 12, 2, 4, 128, 48
    (jq, tq), (jk, tk), (jv, tv) = (_f16(_randn(s, 40 + i)) for i, s in
                                    enumerate([(B, S, G, Hg, D), (B, G, T, D), (B, G, T, D)]))
    if chunked:
        starts, lengths = np.array([20, 0], np.int32), np.array([32, 9], np.int32)
        extra, textra = dict(q_starts=jnp.asarray(starts)), dict(q_starts=_t(starts))
    else:
        lengths, extra, textra = np.array([12, 5], np.int32), {}, {}
    want = PA.flash_attention_prefill(jq, jk, jv, jnp.asarray(lengths), SM, 8, 16,
                                      interpret=True, **extra)
    got = A.flash_attention_prefill(tq, tk, tv, _t(lengths), SM, **textra)
    assert got.dtype == F16 and _rel(got, want) <= ATT_TOL


def test_decode_lse_plain_f16_matches_jax():
    """K1 on a T-shard: out, m and l."""
    B, G, Hg, D, Tl, off = 3, 2, 4, 128, 64, 64
    (jq, tq), (jk, tk), (jv, tv) = (_f16(_randn(s, 50 + i)) for i, s in
                                    enumerate([(B, G, Hg, D), (B, G, Tl, D), (B, G, Tl, D)]))
    lengths = np.array([30, 100, 127], np.int32)
    local = np.clip(lengths + 1 - off, 0, Tl) - 1
    want = PA.flash_attention_decode(jq, jk, jv, jnp.asarray(local), SM, 16, interpret=True,
                                     return_lse=True)
    out, m, l = A.flash_attention_decode_lse(tq, tk, tv, _t(lengths), SM, off)
    assert out.dtype == F16 and _rel(out, want[0]) <= ATT_TOL
    fin = np.isfinite(np.asarray(want[1]))
    np.testing.assert_array_equal(np.isfinite(m.numpy()), fin)
    np.testing.assert_allclose(m.numpy()[fin], np.asarray(want[1])[fin], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(l.numpy(), np.asarray(want[2]), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("phase", [0, 1])
def test_decode_paged_lse_plain_f16_matches_jax(phase):
    """K2 on the strided local table (stride 2)."""
    (jk, tk), (jv, tv) = _pool(60)
    jq, tq = _f16(_randn((2, 2, 4, 128), 62))
    table = np.array([[5, 2], [8, 1]], np.int32)
    lengths = np.array([60, 20], np.int32)
    want = PA.flash_attention_decode_paged(
        jq, jk, jv, jnp.int32(1), jnp.asarray(table), jnp.asarray(lengths), SM, interpret=True,
        stride=2, phase=jnp.full((1,), phase, jnp.int32), return_lse=True)
    out, m, l = A.flash_attention_decode_paged_lse(tq, tk, tv, 1, _t(table), _t(lengths), SM, 2,
                                                   phase)
    assert out.dtype == F16 and _rel(out, want[0]) <= ATT_TOL
    np.testing.assert_allclose(l.numpy(), np.asarray(want[2]), rtol=1e-5, atol=1e-6)


def _np16(x):
    return (x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)).view(np.uint16)


def test_kv_writes_f16_bit_equal_to_jax():
    """B3 and B9 into f16 caches, bit for bit."""
    L, B, G, T, D = 2, 2, 2, 16, 128
    jn, tn = _f16(_randn((B, G, D), 70))
    starts = np.array([3, 15], np.int32)
    jc, tc = _f16(_randn((L, B, G, T, D), 71))
    want = PA.kv_cache_write_idx(jc, jn, jnp.asarray(1), jnp.asarray(starts), interpret=True)
    A.kv_cache_write_idx(tc, tn, 1, _t(starts))
    np.testing.assert_array_equal(_np16(tc), _np16(want))
    (jp, tp), _ = _pool(72)
    pstarts = np.array([17, 63], np.int32)
    want = PA.kv_pool_write_idx(jp, jn, jnp.asarray(0), jnp.asarray(PT), jnp.asarray(pstarts),
                                interpret=True)
    A.kv_pool_write_idx(tp, tn, 0, _t(PT), _t(pstarts))
    np.testing.assert_array_equal(_np16(tp), _np16(want))


G6, HG6, D6 = 2, 16, 128
TABLE = JM.precompute_freqs_cis(D6, 2049)


def _rope_inputs(B, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, G6, HG6, D6)).astype(np.float32)
    kv = rng.standard_normal((B, 2 * G6 * D6)).astype(np.float32)
    return q, kv, TABLE[[5, 700, 1500, 2048][:B]]


def _jax_rope(q, kv, freqs):
    B = q.shape[0]
    jq, jkv, jf = (jnp.asarray(a, JF16) for a in (q, kv, freqs))
    f = jf[:, None, None, :]
    k = JM.apply_rotary_emb(jkv[:, : G6 * D6].reshape(B, G6, 1, D6), f).reshape(B, G6, D6)
    return JM.apply_rotary_emb(jq, f), k, jkv[:, G6 * D6:].reshape(B, G6, D6)


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_rope_kv_append_plain_f16_bit_equal_to_jax(paged):
    """B3 / B9 with the RoPE of q and k: JAX's apply_rotary_emb in f16 (each
    product and sum rounded to f16), then its Pallas writes."""
    B, L, T = 4, 3, 24
    q, kv, freqs = _rope_inputs(B, 80)
    qr, k, v = _jax_rope(q, kv, freqs)
    starts = np.array([3, 17, 0, 23], np.int32)
    if paged:
        pt = np.array([[5, 2], [8, 1], [6, 4], [7, 3]], np.int32)
        (jk, tk), (jv, tv) = _pool(81, L=L, NP=9, G=G6, P=16, D=D6)
        wk = PA.kv_pool_write_idx(jk, k, jnp.asarray(1), jnp.asarray(pt), jnp.asarray(starts),
                                  interpret=True)
        wv = PA.kv_pool_write_idx(jv, v, jnp.asarray(1), jnp.asarray(pt), jnp.asarray(starts),
                                  interpret=True)
    else:
        pt = None
        (jk, tk), (jv, tv) = (_f16(_randn((L, B, G6, T, D6), s)) for s in (82, 83))
        wk = PA.kv_cache_write_idx(jk, k, jnp.asarray(1), jnp.asarray(starts), interpret=True)
        wv = PA.kv_cache_write_idx(jv, v, jnp.asarray(1), jnp.asarray(starts), interpret=True)
    got = A.rope_kv_append(_t(q, F16), _t(kv, F16), _t(freqs, F16), tk, tv, 1, _t(starts),
                           None if pt is None else _t(pt))
    assert got.dtype == F16
    np.testing.assert_array_equal(_np16(got), _np16(qr))
    np.testing.assert_array_equal(_np16(tk), _np16(wk))
    np.testing.assert_array_equal(_np16(tv), _np16(wv))


def test_rope_kv_append_sharded_plain_f16_bit_equal_to_jax():
    """K3 on the second T-shard of a dense cache: the rotated q on every row,
    and the shard's slice of JAX's write into the whole cache."""
    B, L, Tl = 4, 2, 16
    q, kv, freqs = _rope_inputs(B, 90)
    qr, k, v = _jax_rope(q, kv, freqs)
    starts = np.array([3, 16, 31, 20], np.int32)  # shard 0, then shard 1
    (jk, tk_all), (jv, tv_all) = (_f16(_randn((L, B, G6, 2 * Tl, D6), s)) for s in (91, 92))
    wk = PA.kv_cache_write_idx(jk, k, jnp.asarray(1), jnp.asarray(starts), interpret=True)
    wv = PA.kv_cache_write_idx(jv, v, jnp.asarray(1), jnp.asarray(starts), interpret=True)
    tk, tv = tk_all[:, :, :, Tl:].contiguous(), tv_all[:, :, :, Tl:].contiguous()
    got = A.rope_kv_append_sharded(_t(q, F16), _t(kv, F16), _t(freqs, F16), tk, tv, 1,
                                   _t(starts), A.KVShard(offset=Tl, total=2 * Tl))
    np.testing.assert_array_equal(_np16(got), _np16(qr))
    np.testing.assert_array_equal(_np16(tk), _np16(wk)[:, :, :, Tl:])
    np.testing.assert_array_equal(_np16(tv), _np16(wv)[:, :, :, Tl:])


# ---------------------------------------------------------------------------
# The model in f16: prefill + 8 decode steps, dense and paged
# ---------------------------------------------------------------------------

TINY = dict(hidden_size=256, inner_hidden_size=512, head_hidden_size=32,
            num_multi_query_groups=2, num_attention_heads=8, num_layers=2,
            vocab_size=512, max_sequence_length=128)
JCFG, TCFG = JConfig(**TINY), ChatGLM2Config(**TINY)
IDS = np.array([[5, 9, 100, 301, 77, 3, 250], [7, 8, 9, 0, 0, 0, 0]], np.int32)
LENGTHS = np.array([7, 3], np.int32)
STEPS = 8
JRT = TpuRuntimeConfig(use_pallas=True, use_flash_attention=True)
TRT = TorchRuntimeConfig(use_kernels=True, use_flash_attention=True)


@pytest.fixture(scope="module", params=["int8", "int4g32"])
def tiny(request):
    quant = request.param
    jp = JM.init_params(jax.random.PRNGKey(7), JCFG, quant, jnp.float32)
    return quant, jp, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def _jax_model(jp, quant, paged, teacher):
    if paged:
        cache = JPK.init_paged_kv_cache(JCFG, 2, 9, 64, 16, JF16)
        cache = cache.replace(page_table=jnp.asarray(PT))
        prefill = jax.jit(lambda p, i, n, c: JPK.prefill_paged(p, JCFG, i, n, c, quant, JF16,
                                                                 JRT))
        step = jax.jit(lambda p, t, c: JPK.decode_step_paged(p, JCFG, t, c, quant, JF16, JRT))
    else:
        cache = JM.init_kv_cache(JCFG, 2, 32, JF16)
        prefill = jax.jit(lambda p, i, n, c: JM.prefill(p, JCFG, i, n, c, quant, JF16, JRT))
        step = jax.jit(lambda p, t, c: JM.decode_step(p, JCFG, t, c, quant, JF16, JRT))
    logits, cache = prefill(jp, jnp.asarray(IDS), jnp.asarray(LENGTHS), cache)
    out = [np.asarray(logits, np.float32)]
    for s in range(STEPS):
        logits, cache = step(jp, jnp.asarray(teacher[s]), cache)
        out.append(np.asarray(logits, np.float32))
    return out


def _port_model(tp, quant, paged):
    if paged:
        cache = TPK.init_paged_kv_cache(TCFG, 2, 9, 64, 16, F16, device="cpu")
        cache.page_table.copy_(_t(PT))
        prefill, step = TPK.prefill_paged, TPK.decode_step_paged
    else:
        cache = TM.init_kv_cache(TCFG, 2, 32, F16, device="cpu")
        prefill, step = TM.prefill, TM.decode_step
    logits, cache = prefill(tp, TCFG, _t(IDS), _t(LENGTHS), cache, quant, F16, TRT)
    out, toks = [logits.float().numpy()], []
    for _ in range(STEPS):
        tok = logits.argmax(-1).to(torch.int32)
        toks.append(tok.numpy())
        logits, cache = step(tp, TCFG, tok, cache, quant, F16, TRT)
        assert logits.dtype == F16
        out.append(logits.float().numpy())
    k = cache.k_pool if paged else cache.k
    assert k.dtype == F16
    return out, toks


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_model_in_f16_matches_jax(tiny, paged):
    """Teacher-forced on the port's greedy tokens, so that a near-tie cannot
    send the two down other streams; every step's logits within LOGIT_TOL
    of max|JAX|."""
    quant, jp, tp = tiny
    got, toks = _port_model(tp, quant, paged)
    want = _jax_model(jp, quant, paged, toks)
    for g, w in zip(got, want):
        assert np.isfinite(g).all() and _rel(g, w) <= LOGIT_TOL


# ---------------------------------------------------------------------------
# The launch path: a float16 checkpoint written by examples/quantize_naive.py
# ---------------------------------------------------------------------------

LTINY = dict(hidden_size=64, inner_hidden_size=64, head_hidden_size=16,
             num_multi_query_groups=2, num_attention_heads=4, num_layers=2,
             max_sequence_length=128)


@pytest.fixture(scope="module")
def f16_ckpts(tmp_path_factory):
    """A tiny float32 checkpoint, and its int8 / int4g32 RTN checkpoints as
    the port's quantize_naive writes them (float16 config)."""
    d = tmp_path_factory.mktemp("f16")
    vocab = {f"tok{i}": -float(i) for i in range(40)}
    vocab.update({"hello": -0.5, "world": -0.6})
    tok_file = d / "sp.model"
    tok_file.write_bytes(build_unigram_model(vocab))
    tok = ChatGLM2Tokenizer(tok_file)
    cfg = ChatGLM2Config(vocab_size=((len(tok) + 63) // 64) * 64, **LTINY)
    params = TM.init_params(torch.Generator().manual_seed(3), cfg, "none", torch.float32, "cpu")
    TLD.save_model_and_tokenizer(d / "fp", GLMLoadConfig(model_config=cfg,
                                                         torch_dtype="float32"), params, tok)
    out = {}
    for quant in ("int8", "int4g32"):
        quantize_naive.main(["--quant", quant, "--source", str(d / "fp"),
                             "--target", str(d / quant), "--device", "cpu"])
        out[quant] = d / quant
    return out


def _run(gen):
    stream = []
    while True:
        try:
            stream.append(next(gen))
        except StopIteration as e:
            return stream, e.value


@pytest.mark.parametrize("quant", ["int8", "int4g32"])
def test_float16_checkpoint_serves_through_the_launch_path(f16_ckpts, quant):
    """``GLMDecoder.from_pretrained`` with no dtype serves the checkpoint's
    float16 (activations and cache), through the kernels' plain versions,
    and its greedy text is JAX's decoder's on the same files."""
    path = f16_ckpts[quant]
    td = GLMDecoder.from_pretrained(path, device="cpu", rt=TRT)
    assert td.config.torch_dtype == "float16" and td.dtype == F16 and td.kv_dtype == F16
    jd = JDecoder.from_pretrained(path, rt=TpuRuntimeConfig(use_pallas=False))
    for prompt in ("hello world", "hello " * 20):
        got = _run(td.generate(prompt, max_generated_tokens=12, temperature=0.0))
        want = _run(jd.generate(prompt, max_generated_tokens=12, temperature=0.0))
        assert got == want, prompt
        assert len(got[1]) > 0
    cache = td._free_caches[0][0]
    assert cache.k.dtype == F16


# ---------------------------------------------------------------------------
# The distributed engines in f16 on two gloo ranks
# ---------------------------------------------------------------------------

DCFG = dict(hidden_size=256, inner_hidden_size=512, head_hidden_size=32,
            num_multi_query_groups=2, num_attention_heads=8, num_layers=2,
            vocab_size=1024, max_sequence_length=64)
DPROMPTS = [np.random.RandomState(9).randint(3, 900, size=n).tolist() for n in (19, 4, 26, 9)]
DSUBMIT = dict(max_new_tokens=6, temperature=0.0)
DENGINE = dict(max_batch=4, max_seq_len=64, decode_chunk=4, dtype=F16)
# int4g32: its q·s is exact in f16, so JAX's jnp fallback computes the
# port's function (int8's fallback rounds w·s to f16: another function)
DCASES = {
    # the head-sharded cache: the rank's groups, B3 / B4 on them
    "dense heads f16": ("dense", DENGINE, [DPROMPTS], DSUBMIT),
    # the T-sharded cache: K3 writes, K1 over each shard, the merge
    "dense kv_shard_t chunked f16": ("dense", dict(DENGINE, prefill_chunk_size=8,
                                                   rt=dict(kv_shard_t=True)), [DPROMPTS],
                                     DSUBMIT),
    # the model-sharded pool: K3, K2 and the all-gathered f16 pages
    "paged shard_model_pages chunked f16": (
        "paged", dict(DENGINE, num_pages=24, page_size=8, shard_model_pages=True,
                      prefill_chunk_size=8), [DPROMPTS], DSUBMIT),
}


@pytest.fixture(scope="module")
def dist_runs():
    import torch_dist_workers as W
    from chatglm_q_tpu.config import GLMLoadConfig as JLoad
    from chatglm_q_tpu.serving.engine import ServingEngine as JEngine
    from chatglm_q_tpu_torch.utils.distributed import run_spmd

    jp = JM.init_params(jax.random.PRNGKey(21), JConfig(**DCFG), "int4g32", jnp.float32)
    eng = JEngine(JLoad(model_config=JConfig(**DCFG), quant_type="int4g32",
                        torch_dtype="float16"),
                  jp, None, rt=TpuRuntimeConfig(use_pallas=False), max_batch=4, max_seq_len=64,
                  decode_chunk=4)
    want = eng.run(DPROMPTS, **DSUBMIT)
    ranks = run_spmd(W.engine_cases, 2, "gloo", 200,
                     args=(jax.tree.map(np.asarray, jp), DCFG, "int4g32", [(1, 2, DCASES)]))
    return want, ranks


@pytest.mark.parametrize("name", list(DCASES))
def test_distributed_engine_in_f16_equals_jax(dist_runs, name):
    """Token for token with JAX's single-device engine in f16 (a float16
    config), on every rank: the f16 activations and cache through the
    sharded attention forms and the gloo collectives (16-bit tensors move as
    bytes; the all-reduce sums in f32)."""
    want, ranks = dist_runs
    for r in ranks:
        assert r[name]["dtypes"] == ("torch.float16", "torch.float16")
        assert r[name]["tokens"] == want, (name, r[name]["tokens"], want)
        assert r[name]["pages_in_use"] in (None, 0)

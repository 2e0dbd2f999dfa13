"""The last float16 forms of the port against the JAX package, on the CPU,
fed the same numpy inputs: dynamic int8 (B7 / B8) with f16 activations,
fine-tuning's backward (B13 / B14) with f16 gradients, and every attention
kernel under f16 activations over a float8_e4m3fn cache.

* The kernels' conversions emulated bit for bit: an e4m3 byte to f16
  (csrc/attention.cu ``e4m3x2_f16x2`` and ``e4m3x8_act<__half>``) over all
  256 bytes against JAX's upcast; the f16 -> e4m3 store (the clamp, the
  card's ``cvt.rn.satfinite``, NaN as 0x7F) over all 65,536 f16 patterns
  against ``kv_store_cast`` and JAX's cast.
* Routing and entry codes on tensors that say they are on CUDA: f16 sends
  B7 / B8 / B13 / B14 to their kernels with the f16 dtype code, and every
  attention entry receives form 3 (f16 over fp8).
* Each plain version in f16 against JAX's function in f16 (its Pallas
  kernel in interpret mode): B7 bit for bit and B8 at M = 1, 4, 36, 128;
  B13 and B14 at M = 1, 16, 128 and at scales past f16's normal range; B4,
  B12, B10, B11, B5 (both forms), K1, K2 and the writes over an fp8 cache.
* The model at depth 2 in f16 with ``dynamic_int8`` (int8, int4g32) and
  over an fp8 cache (dense and paged); the f16 training step's loss and
  grads; the distributed engine on two gloo ranks in f16 over fp8.

Each tolerance is stated beside its test, about 1.5x the largest reading
on these inputs.
"""
import math

import ml_dtypes
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from chatglm_q_tpu.config import ChatGLM2Config as JConfig, TpuRuntimeConfig  # noqa: E402
from chatglm_q_tpu.models import chatglm2 as JM  # noqa: E402
from chatglm_q_tpu.models import paged_kv as JPK  # noqa: E402
from chatglm_q_tpu.ops import pallas_attention as PA  # noqa: E402
from chatglm_q_tpu.ops import pallas_matmul as PM  # noqa: E402
from chatglm_q_tpu.utils import train as JT  # noqa: E402
from chatglm_q_tpu_torch import ChatGLM2Config, TorchRuntimeConfig  # noqa: E402
from chatglm_q_tpu_torch.convert import params_from_numpy  # noqa: E402
from chatglm_q_tpu_torch.models import chatglm2 as TM  # noqa: E402
from chatglm_q_tpu_torch.models import paged_kv as TPK  # noqa: E402
from chatglm_q_tpu_torch.ops import _build  # noqa: E402
from chatglm_q_tpu_torch.ops import attention as A  # noqa: E402
from chatglm_q_tpu_torch.ops import dyn_matmul as D  # noqa: E402
from chatglm_q_tpu_torch.ops import int8_matmul as I8  # noqa: E402
from chatglm_q_tpu_torch.ops import quant_matmul as QM  # noqa: E402
from chatglm_q_tpu_torch.ops.quant import unpack_int4_tpu  # noqa: E402
from chatglm_q_tpu_torch.utils import train as TT  # noqa: E402

F16, JF16 = torch.float16, jnp.float16
FP8, JFP8 = torch.float8_e4m3fn, jnp.float8_e4m3fn
# B8 against JAX's kernel, max|Δ| / max|JAX|: both sum exact group dots
# times the f32 scale in f32, in another order, and round once to f16: one
# f16 ulp (2^-11 of the top binade) apart at most.  Largest reading 2.58e-4.
DYN_TOL = 3.9e-4
# B13 / B14 against JAX's kernels, the same measure: the same f16 products
# (q·s, g·s rounded alike) summed in f32 in another order, then the output's
# f16 rounding.  Largest reading 3.63e-4 (B14, M = 16).
T_TOL = 5.4e-4
# An attention output over an fp8 cache against JAX's kernel, the same
# measure: p rounded to f16 per block on the TPU, per row here, then the
# output's rounding.  Largest reading 6.18e-4 (B4).
ATT_TOL = 9.3e-4
# Logits of the depth-2 model against JAX's, the same measure, every step.
# The f16 roundings at other places (tests/test_torch_fp16.py's LOGIT_TOL,
# 1.6e-3) are then quantized: dynamic int8 rounds each activation row to
# 1/127 of its max, an fp8 cache each K / V element to 3 mantissa bits, so
# one f16 ulp apart can flip a step of those.  Largest readings 1.8e-2
# (dynamic_int8) and 6.9e-3 (fp8); JAX's own f16 run against its f32 run on
# the same tokens reads 1.4e-2 to 2.1e-2 and 6.7e-4 to 1.4e-2.
LOGIT_TOL = {"dyn": 2.7e-2, "fp8": 1.05e-2}
# The f16 training step against JAX's: |Δloss| / |loss| (largest reading
# 8.2e-6) and, per trainable leaf, max|Δgrad| / max|grad| (largest 1.83e-2
# in int8, whose f16 fold of the scale into g or w moves JAX's own f16
# grads 3.1e-2 to 4.8e-2 from its f32 ones; 1.1e-3 in int4g32).
TRAIN_LOSS_TOL = 1.3e-5
TRAIN_GRAD_TOL = {"int8": 2.8e-2, "int4g32": 1.7e-3}


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


def _bits16(x):
    return (x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)).view(np.uint16)


def _fp8_bytes(x):
    """f32 numpy values as fp8 bytes through JAX's cast (finite inputs)."""
    return np.asarray(jnp.asarray(x, jnp.float32).astype(JFP8)).view(np.uint8)


def _fp8_pair(b):
    """The same fp8 bytes as a JAX array and a torch tensor."""
    return (jnp.asarray(b.view(ml_dtypes.float8_e4m3fn)),
            torch.from_numpy(np.ascontiguousarray(b)).view(FP8))


# ---------------------------------------------------------------------------
# The kernels' conversions, bit for bit
# ---------------------------------------------------------------------------

def _f16_bits_to_f32(bits):
    return torch.from_numpy(bits.astype(np.uint16).view(np.int16).copy()).view(F16).float()


def _e4m3x2_f16x2(x):
    """csrc e4m3x2_f16x2 on uint32 words (a byte in the low byte of each
    16-bit half): the bits moved into f16's places, one f16x2 product by
    2^8 (exact: the result must be an f16 already), the sign or-ed back."""
    mag = (x << np.uint32(7)) & np.uint32(0x3F803F80)
    out = np.zeros_like(x)
    for shift in (0, 16):
        h = _f16_bits_to_f32((mag >> np.uint32(shift)) & np.uint32(0xFFFF))
        prod = h * 256.0
        assert torch.equal(prod.to(F16).float(), prod)  # mul.rn.f16x2 rounds nothing
        p = prod.to(F16).view(torch.int16).numpy().view(np.uint16).astype(np.uint32)
        out |= p << np.uint32(shift)
    return out | ((x << np.uint32(8)) & np.uint32(0x80008000))


def e4m3_to_f16_emulated(b):
    """csrc e4m3x8_act<__half> over bytes b (a multiple of 8): f16 bit
    patterns, a NaN byte as the quiet NaN of its sign."""
    w = b.reshape(-1, 2, 4).view(np.uint32).reshape(-1, 2)  # little endian words
    words = []
    for wi in (w[:, 0], w[:, 1]):
        lo = (wi & np.uint32(0xFF)) | ((wi >> np.uint32(8)) & np.uint32(0xFF)) << np.uint32(16)
        hi = ((wi >> np.uint32(16)) & np.uint32(0xFF)) | (wi >> np.uint32(24)) << np.uint32(16)
        words += [_e4m3x2_f16x2(lo), _e4m3x2_f16x2(hi)]  # __byte_perm 0x4140, 0x4342
    o = np.stack(words, -1)
    out = np.stack([o & np.uint32(0xFFFF), o >> np.uint32(16)], -1).reshape(-1).astype(np.uint16)
    nan = (b & 0x7F) == 0x7F
    out[nan] = 0x7E00 | ((b[nan].astype(np.uint16) & 0x80) << 8)
    return out


def test_e4m3_to_f16_upcast_emulated_over_all_bytes():
    """The f16 readers' conversion is exact: bit-equal to JAX's upcast for
    all 256 bytes, subnormals m · 2^-9 and NaN bytes (f16's quiet NaN of
    their sign, 0x7E00 / 0xFE00) included; equal to PyTorch's
    ``.to(torch.float16)`` but at the two NaN bytes, where PyTorch gives
    another NaN pattern."""
    b = np.arange(256, dtype=np.uint8)
    got = e4m3_to_f16_emulated(b)
    want = np.asarray(jnp.asarray(b.view(ml_dtypes.float8_e4m3fn)).astype(JF16)).view(np.uint16)
    np.testing.assert_array_equal(got, want)
    torch_bits = _bits16(torch.from_numpy(b).view(FP8).to(F16).view(torch.int16))
    assert np.nonzero(got != torch_bits)[0].tolist() == [0x7F, 0xFF]
    vals = _f16_bits_to_f32(got).numpy()
    assert np.isnan(vals[[0x7F, 0xFF]]).all()
    np.testing.assert_array_equal(vals[:8], np.arange(8) * 2.0 ** -9)
    assert vals[0x7E] == 448.0 and vals[0xFE] == -448.0 and got[0x80] == 0x8000


def _store_emulated(x16):
    """csrc e4m3x2_store on f16 inputs: f16 -> f32 (exact), fmin(fmax(x,
    -448), 448) (a NaN comes out as -448, then the fix), round to nearest
    even (cvt.rn.satfinite: in range after the clamp), every NaN to 0x7F."""
    x = x16.float().numpy()
    c = np.fmin(np.fmax(x, -448.0), 448.0).astype(np.float32)
    byte = torch.from_numpy(c).to(FP8).view(torch.uint8).numpy().copy()
    byte[np.isnan(x)] = 0x7F
    return byte


def test_f16_store_matches_jax_over_every_f16_pattern():
    """The store from f16 (``kv_store_cast``, and the kernels' store
    emulated) over all 65,536 f16 patterns: bit-equal to JAX's
    ``astype(float8_e4m3fn)`` wherever that is finite; where JAX gives NaN
    from a number (past ±464, ±inf) the port saturates to ±448; every NaN
    is stored as 0x7F."""
    bits = np.arange(65536, dtype=np.uint32).astype(np.uint16)
    x = torch.from_numpy(bits.view(np.int16).copy()).view(F16)
    got = A.kv_store_cast(x, FP8).view(torch.uint8).numpy()
    np.testing.assert_array_equal(_store_emulated(x), got)
    want = np.asarray(jnp.asarray(bits.view(np.float16)).astype(JFP8)).view(np.uint8)
    finite = (want & 0x7F) != 0x7F
    np.testing.assert_array_equal(got[finite], want[finite])
    xf = x.float().numpy()
    nan = np.isnan(xf)
    assert (got[nan] == A.FP8_NAN).all()
    past = ~finite & ~nan
    assert past.sum() > 0 and (np.abs(xf[past]) > 464).all()
    np.testing.assert_array_equal(got[past], np.where(xf[past] > 0, 0x7E, 0xFE))
    assert ((got & 0x7F) != 0x7F)[~nan].all()


def test_f16_store_then_read_roundtrips_every_byte():
    """Every non-NaN byte read as f16 (exactly) and stored again is itself."""
    b = np.arange(256, dtype=np.uint8)
    f = torch.from_numpy(e4m3_to_f16_emulated(b).view(np.int16).copy()).view(F16)
    back = A.kv_store_cast(f, FP8).view(torch.uint8).numpy()
    keep = (b & 0x7F) != 0x7F
    np.testing.assert_array_equal(back[keep], b[keep])


# ---------------------------------------------------------------------------
# Routing and entry codes on tensors that say they are on CUDA
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


def test_t_route_sends_f16_like_bf16():
    for M in (1, 4, 16):
        assert QM.t_route(M, 4096, F16) == QM.t_route(M, 4096, torch.bfloat16) == "splitk"
    for M in (17, 128, 1024):
        assert QM.t_route(M, 4096, F16) == QM.t_route(M, 4096, torch.bfloat16) == "mma"
        assert QM.t_route(M, 264, F16) == "splitk"  # N % 16 != 0: the Hopper kernel cannot
    assert QM.t_route(512, 4096, torch.float32) == "gemv"
    assert D.uses_mma(17, 4096) and not D.uses_mma(16, 4096)


# (function, M, entry, index of M among the entry's arguments: M, K, N, then
# the dtype code)
F16_ENTRIES = [
    ("int8_dyn", 1, "chatglm_int8_dyn_splitk", 7), ("int8_dyn", 36, "chatglm_int8_dyn_mma", 7),
    ("int4_dyn", 4, "chatglm_int4_dyn_splitk", 7), ("int4_dyn", 36, "chatglm_int4_dyn_mma", 7),
    ("int8_t", 1, "chatglm_int8_t_splitk", 6), ("int8_t", 16, "chatglm_int8_t_splitk", 6),
    ("int8_t", 128, "chatglm_int8_t_mma", 6), ("int4_t", 4, "chatglm_int4_t_splitk", 6),
    ("int4_t", 128, "chatglm_int4_t_mma", 6)]


@pytest.mark.parametrize("kind,M,entry,at", F16_ENTRIES)
def test_f16_reaches_the_dynamic_and_backward_kernels(fake_launch, kind, M, entry, at):
    """f16 activations (B7 / B8) and f16 gradients (B13 / B14) go to the
    route's kernel with the f16 dtype code, where they raised before."""
    K, N = 256, 256
    w8, s8 = torch.zeros((K, N), dtype=torch.int8), torch.ones(N)
    p4, s4 = torch.zeros((K // 2, N), dtype=torch.uint8), torch.ones((K // 32, N),
                                                                     dtype=torch.bfloat16)
    x = _fake(torch.randn((M, K)).to(F16))
    g = _fake(torch.randn((M, N)).to(F16))
    fn, args = {"int8_dyn": (D.int8_dyn_matmul, (x, w8, s8)),
                "int4_dyn": (D.int4_dyn_matmul, (x, p4, s4)),
                "int8_t": (I8.int8_matmul_t, (g, w8, s8)),
                "int4_t": (QM.int4g32_matmul_t, (g, p4, s4))}[kind]
    with pytest.raises(_Launched) as launched:
        fn(*args)
    name, got = launched.value.args
    assert name == entry
    assert got[at:at + 4] == (M, K, N, _build.dtype_code(F16))


def _fp8_attention_calls():
    """One call of each attention wrapper on f16 activations over fp8
    caches and pools."""
    q = _fake(torch.zeros((2, 2, 4, 128), dtype=F16))
    qs = _fake(torch.zeros((2, 3, 2, 4, 128), dtype=F16))
    k = _fake(A.kv_zeros((2, 2, 64, 128), FP8, "cpu"))
    cache = _fake(A.kv_zeros((2, 2, 2, 64, 128), FP8, "cpu"))
    pool = _fake(A.kv_zeros((2, 6, 2, 16, 128), FP8, "cpu"))
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


@pytest.mark.parametrize("key", list(_fp8_attention_calls()))
def test_attention_entries_receive_the_f16_over_fp8_form(fake_launch, key):
    with pytest.raises(_Launched) as launched:
        _fp8_attention_calls()[key]()
    name, args = launched.value.args
    assert name == key.split()[0]
    assert args[-2] == A.FORM_CODES[(F16, FP8)] == 3  # the form code, before the stream
    assert A.FORM_SUFFIX[3] == "fp8_f16"


def test_every_cache_wrapper_counts_the_f16_over_fp8_form():
    from chatglm_q_tpu_torch import ops

    wrappers = ops.kernel_wrappers()
    for name in A.CACHE_FORMS:
        assert wrappers[f"{name}_fp8_f16"] is getattr(wrappers[name], "fp8_f16")
    for name in ("int8_dyn_splitk", "int8_dyn_mma", "int4_dyn_splitk", "int4_dyn_mma",
                 "int8_t_splitk", "int8_t_mma", "int4g32_t_splitk", "int4g32_t_mma"):
        assert wrappers[f"{name}_f16"] is getattr(wrappers[name], "f16")


# ---------------------------------------------------------------------------
# B7 / B8: the plain versions in f16 against JAX's dynamic kernels in f16
# ---------------------------------------------------------------------------

def _int4_weights(K, N, seed, scale=0.02):
    rng = np.random.default_rng(seed)
    packed = rng.integers(0, 256, (K // 2, N), dtype=np.uint8)
    s = (rng.random((K // 32, N), dtype=np.float32) * scale).astype(jnp.bfloat16)
    return packed, s


def _bf16_t(a):
    return _t(np.asarray(a).astype(np.float32), torch.bfloat16)


@pytest.mark.parametrize("M", [1, 4, 36, 128])
def test_int8_dyn_plain_f16_bit_equal_to_jax(M):
    """B7: (acc.f32 · xs · s) rounded once to f16, bit for bit."""
    K, N = 512, 256
    rng = np.random.default_rng(400 + M)
    w = rng.integers(-128, 128, (K, N), dtype=np.int8)
    scale = ((0.5 + rng.random(N, dtype=np.float32)) * 0.01).astype(np.float32)
    jx, tx = _f16(_randn((M, K), 410 + M))
    want = PM.int8_dyn_matmul_pallas(jx, jnp.asarray(w), jnp.asarray(scale), interpret=True)
    assert want is not None and want.dtype == JF16
    got = D.int8_dyn_matmul(tx, _t(w), _t(scale))
    assert got.dtype == F16
    np.testing.assert_array_equal(_bits16(got), _bits16(want))


def test_int8_dyn_f16_overflows_to_inf_as_jax():
    """Past 65,504 the f16 output is inf, as JAX's astype gives."""
    K, N, M = 256, 128, 4
    rng = np.random.default_rng(420)
    w = rng.integers(-128, 128, (K, N), dtype=np.int8)
    scale = np.full(N, 40.0, np.float32)
    jx, tx = _f16(_randn((M, K), 421))
    want = np.asarray(PM.int8_dyn_matmul_pallas(jx, jnp.asarray(w), jnp.asarray(scale),
                                                interpret=True))
    got = D.int8_dyn_matmul(tx, _t(w), _t(scale))
    assert np.isinf(want).any() and not np.isinf(want).all()
    np.testing.assert_array_equal(_bits16(got), want.view(np.uint16))


@pytest.mark.parametrize("M", [1, 4, 36, 128])
def test_int4_dyn_plain_f16_matches_jax(M):
    """B8: Σ_g pg.f32 · s_g, then · xs, rounded once to f16."""
    K, N = 1024, 256
    packed, s = _int4_weights(K, N, 430 + M)
    jx, tx = _f16(_randn((M, K), 440 + M))
    want = PM.int4_dyn_matmul_pallas(jx, jnp.asarray(packed), jnp.asarray(s), interpret=True)
    assert want is not None and want.dtype == JF16
    got = D.int4_dyn_matmul(tx, _t(packed), _bf16_t(s))
    assert got.dtype == F16
    assert _rel(got, want) <= DYN_TOL


# ---------------------------------------------------------------------------
# B13 / B14: the plain versions in f16 against JAX's transposed kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("M", [1, 16, 128])
def test_int8_t_plain_f16_matches_jax(M):
    """B13: f16(g · f16(s)), the int8 weights exact, f32 sums."""
    K, N = 512, 768
    rng = np.random.default_rng(450 + M)
    w = rng.integers(-128, 128, (K, N), dtype=np.int8)
    scale = ((0.5 + rng.random(N, dtype=np.float32)) * 0.01).astype(np.float32)
    jg, tg = _f16(_randn((M, N), 460 + M))
    want = PM.int8_matmul_t_pallas(jg, jnp.asarray(w), jnp.asarray(scale), interpret=True)
    assert want.dtype == JF16
    got = I8.int8_matmul_t(tg, _t(w), _t(scale))
    assert got.dtype == F16 and _rel(got, want) <= T_TOL


@pytest.mark.parametrize("M", [1, 16, 128])
def test_int4_t_plain_f16_matches_jax(M):
    """B14: f16(f16(q) · f16(s)) rounded once before the dot."""
    K, N = 1024, 512
    packed, s = _int4_weights(K, N, 470 + M)
    jg, tg = _f16(_randn((M, N), 480 + M))
    want = PM.int4_matmul_t_pallas(jg, jnp.asarray(packed), jnp.asarray(s), interpret=True)
    assert want.dtype == JF16
    got = QM.int4g32_matmul_t(tg, _t(packed), _bf16_t(s))
    assert got.dtype == F16 and _rel(got, want) <= T_TOL


# (scale exponent, what f16(s) is) for B14 where the bf16 scale leaves f16's normal range
T_EDGE_SCALES = [(-10, "normal"), (-20, "subnormal"), (-27, "zero"), (17, "inf")]


@pytest.mark.parametrize("e,case", T_EDGE_SCALES)
def test_int4_t_f16_scales_past_the_normal_range(e, case):
    """JAX's ``_int4_t_kernel`` casts the bf16 scale to f16 before the
    product: below 2^-14 to a subnormal (fewer bits), below 2^-25 to 0, at
    65,520 and above to inf (then q · inf, and 0 · inf = NaN).  The port
    follows the kernel there, not B1's f32 q · s: equal to JAX in every
    case, and (but in the normal range) off the exact function."""
    K, N, M = 256, 256, 4
    packed, s = _int4_weights(K, N, 490 + abs(e), scale=1.0)
    s = (np.asarray(s, np.float32) * 2.0 ** e).astype(jnp.bfloat16)
    jg, tg = _f16(_randn((M, N), 495))
    want = np.asarray(PM.int4_matmul_t_pallas(jg, jnp.asarray(packed), jnp.asarray(s),
                                              interpret=True), np.float32)
    got = QM.int4g32_matmul_t(tg, _t(packed), _bf16_t(s)).float().numpy()
    exact = (tg.double() @ unpack_int4_tpu(_t(packed), _bf16_t(s)).double().T).float().numpy()
    if case == "inf":
        assert np.isnan(want).all() and np.isnan(got).all()
        return
    if case == "zero":
        assert (want == 0).all() and (got == 0).all() and np.abs(exact).max() > 0
        return
    # the outputs themselves are f16 subnormals here: compare in f32 units
    assert np.abs(got - want).max() <= T_TOL * np.abs(want).max()
    off = np.abs(got - exact).max() / np.abs(exact).max()
    assert off <= T_TOL if case == "normal" else off > 2 * T_TOL


@pytest.mark.parametrize("e", [-20, -27])
def test_int8_t_f16_scales_past_the_normal_range(e):
    """B13's f16(s): a subnormal or 0, as JAX's ``_int8_t_kernel`` rounds it."""
    K, N, M = 256, 256, 4
    rng = np.random.default_rng(500 - e)
    w = rng.integers(-128, 128, (K, N), dtype=np.int8)
    scale = ((0.5 + rng.random(N, dtype=np.float32)) * 2.0 ** e).astype(np.float32)
    jg, tg = _f16(_randn((M, N), 505, scale=2.0 ** 10))
    want = np.asarray(PM.int8_matmul_t_pallas(jg, jnp.asarray(w), jnp.asarray(scale),
                                              interpret=True), np.float32)
    got = I8.int8_matmul_t(tg, _t(w), _t(scale)).float().numpy()
    if e == -27:
        assert (want == 0).all() and (got == 0).all()
    else:
        assert np.abs(got - want).max() <= T_TOL * np.abs(want).max()


# ---------------------------------------------------------------------------
# The attention forms under f16 over an fp8 cache against JAX's kernels
# ---------------------------------------------------------------------------

SM = 1.0 / math.sqrt(128)
PT = np.array([[5, 2, 7, 3], [8, 1, 6, 4]], np.int32)


def _fp8(shape, seed):
    return _fp8_pair(_fp8_bytes(_randn(shape, seed)))


def _pool(seed, L=2, NP=9, G=2, P=16, D=128):
    return _fp8((L, NP, G, P, D), seed), _fp8((L, NP, G, P, D), seed + 1)


def test_decode_plain_f16_over_fp8_matches_jax():
    """B4: the cache upcast to f16 after the load, p rounded to f16."""
    B, G, Hg, D, T = 2, 2, 4, 128, 256
    jq, tq = _f16(_randn((B, G, Hg, D), 600))
    (jk, tk), (jv, tv) = _fp8((B, G, T, D), 601), _fp8((B, G, T, D), 602)
    lengths = np.array([200, 37], np.int32)
    want = PA.flash_attention_decode(jq, jk, jv, jnp.asarray(lengths), SM, 64, interpret=True)
    got = A.flash_attention_decode(tq, tk, tv, _t(lengths), SM)
    assert got.dtype == F16 and _rel(got, want) <= ATT_TOL


def test_decode_v2_plain_f16_over_fp8_matches_jax():
    """B12: q pre-scaled in f16, p in f32."""
    B, G, Hg, D, T = 2, 2, 4, 128, 256
    jq, tq = _f16(_randn((B, G, Hg, D), 610))
    (jk, tk), (jv, tv) = _fp8((B, G, T, D), 611), _fp8((B, G, T, D), 612)
    lengths = np.array([255, 70], np.int32)
    want = PA.flash_attention_decode_v2(jq, jk, jv, jnp.asarray(lengths), SM, block_k=128,
                                        interpret=True)
    got = A.flash_attention_decode_v2(tq, tk, tv, _t(lengths), SM, 128)
    assert got.dtype == F16 and _rel(got, want) <= ATT_TOL


def test_decode_paged_plain_f16_over_fp8_matches_jax():
    """B10."""
    (jk, tk), (jv, tv) = _pool(620)
    jq, tq = _f16(_randn((2, 2, 4, 128), 622))
    lengths = np.array([50, 9], np.int32)
    want = PA.flash_attention_decode_paged(jq, jk, jv, jnp.int32(1), jnp.asarray(PT),
                                           jnp.asarray(lengths), SM, interpret=True)
    got = A.flash_attention_decode_paged(tq, tk, tv, 1, _t(PT), _t(lengths), SM)
    assert got.dtype == F16 and _rel(got, want) <= ATT_TOL


def test_chunk_paged_plain_f16_over_fp8_matches_jax():
    """B11."""
    (jk, tk), (jv, tv) = _pool(630)
    jq, tq = _f16(_randn((2, 5, 2, 4, 128), 632))
    starts = np.array([40, 3], np.int32)
    want = PA.flash_attention_chunk_paged(jq, jk, jv, jnp.int32(0), jnp.asarray(PT),
                                          jnp.asarray(starts), SM, interpret=True)
    got = A.flash_attention_chunk_paged(tq, tk, tv, 0, _t(PT), _t(starts), SM)
    assert got.dtype == F16 and _rel(got, want) <= ATT_TOL


@pytest.mark.parametrize("chunked", [False, True])
def test_prefill_plain_f16_over_fp8_matches_jax(chunked):
    """B5, whole prompts and its chunked (q_starts) form, over the fp8 slab
    as stored, against JAX's kernel fed the slab upcast to f16 (its model
    upcasts before the call, chatglm_q_tpu/models/chatglm2.py:386)."""
    B, S, G, Hg, D, T = 2, 12, 2, 4, 128, 48
    jq, tq = _f16(_randn((B, S, G, Hg, D), 640))
    (jk, tk), (jv, tv) = _fp8((B, G, T, D), 641), _fp8((B, G, T, D), 642)
    if chunked:
        starts, lengths = np.array([20, 0], np.int32), np.array([32, 9], np.int32)
        extra, textra = dict(q_starts=jnp.asarray(starts)), dict(q_starts=_t(starts))
    else:
        lengths, extra, textra = np.array([12, 5], np.int32), {}, {}
    want = PA.flash_attention_prefill(jq, jk.astype(JF16), jv.astype(JF16), jnp.asarray(lengths),
                                      SM, 8, 16, interpret=True, **extra)
    got = A.flash_attention_prefill(tq, tk, tv, _t(lengths), SM, **textra)
    assert got.dtype == F16 and _rel(got, want) <= ATT_TOL


def test_decode_lse_plain_f16_over_fp8_matches_jax():
    """K1 on a T-shard of an fp8 cache: out, m and l."""
    B, G, Hg, D, Tl, off = 3, 2, 4, 128, 64, 64
    jq, tq = _f16(_randn((B, G, Hg, D), 650))
    (jk, tk), (jv, tv) = _fp8((B, G, Tl, D), 651), _fp8((B, G, Tl, D), 652)
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
def test_decode_paged_lse_plain_f16_over_fp8_matches_jax(phase):
    """K2 on the strided local table (stride 2) of an fp8 pool."""
    (jk, tk), (jv, tv) = _pool(660)
    jq, tq = _f16(_randn((2, 2, 4, 128), 662))
    table = np.array([[5, 2], [8, 1]], np.int32)
    lengths = np.array([60, 20], np.int32)
    want = PA.flash_attention_decode_paged(
        jq, jk, jv, jnp.int32(1), jnp.asarray(table), jnp.asarray(lengths), SM, interpret=True,
        stride=2, phase=jnp.full((1,), phase, jnp.int32), return_lse=True)
    out, m, l = A.flash_attention_decode_paged_lse(tq, tk, tv, 1, _t(table), _t(lengths), SM, 2,
                                                   phase)
    assert out.dtype == F16 and _rel(out, want[0]) <= ATT_TOL
    np.testing.assert_allclose(l.numpy(), np.asarray(want[2]), rtol=1e-5, atol=1e-6)


def test_kv_writes_f16_into_fp8_equal_jax_bytes():
    """B3 and B9 of f16 values into fp8 caches: JAX's cast of new, byte for
    byte (none past ±464 here, where JAX's cast gives NaN)."""
    L, B, G, T, D = 2, 2, 2, 16, 128
    new = _randn((B, G, D), 670) * 40  # some past the top binade, under 464
    new = np.clip(new, -460, 460)
    jn, tn = _f16(new)
    starts = np.array([3, 15], np.int32)
    jc, tc = _fp8((L, B, G, T, D), 671)
    want = PA.kv_cache_write_idx(jc, jn, jnp.asarray(1), jnp.asarray(starts), interpret=True)
    A.kv_cache_write_idx(tc, tn, 1, _t(starts))
    np.testing.assert_array_equal(tc.view(torch.uint8).numpy(), np.asarray(want).view(np.uint8))
    (jk, tk), _ = _pool(672)
    pstarts = np.array([17, 63], np.int32)
    want = PA.kv_pool_write_idx(jk, jn, jnp.asarray(0), jnp.asarray(PT), jnp.asarray(pstarts),
                                interpret=True)
    A.kv_pool_write_idx(tk, tn, 0, _t(PT), _t(pstarts))
    np.testing.assert_array_equal(tk.view(torch.uint8).numpy(), np.asarray(want).view(np.uint8))


G6, HG6, D6 = 2, 16, 128
TABLE = JM.precompute_freqs_cis(D6, 2049)


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_rope_kv_append_plain_f16_over_fp8_equal_to_jax(paged):
    """B3 / B9 with the RoPE of q and k in f16 over an fp8 cache: q bit-equal
    to JAX's apply_rotary_emb in f16, the cache JAX's Pallas write of the
    rotated k and the raw v, byte for byte."""
    B, L, T = 4, 3, 24
    rng = np.random.default_rng(680)
    q = rng.standard_normal((B, G6, HG6, D6)).astype(np.float32)
    kv = rng.standard_normal((B, 2 * G6 * D6)).astype(np.float32)
    freqs = TABLE[[5, 700, 1500, 2048][:B]]
    jq, jkv, jf = (jnp.asarray(a, JF16) for a in (q, kv, freqs))
    f = jf[:, None, None, :]
    jk_new = JM.apply_rotary_emb(jkv[:, : G6 * D6].reshape(B, G6, 1, D6), f).reshape(B, G6, D6)
    jv_new = jkv[:, G6 * D6:].reshape(B, G6, D6)
    starts = np.array([3, 17, 0, 23], np.int32)
    if paged:
        pt = np.array([[5, 2], [8, 1], [6, 4], [7, 3]], np.int32)
        (jk, tk), (jv, tv) = _pool(681, L=L, NP=9, G=G6, P=16, D=D6)
        wk = PA.kv_pool_write_idx(jk, jk_new, jnp.asarray(1), jnp.asarray(pt),
                                  jnp.asarray(starts), interpret=True)
        wv = PA.kv_pool_write_idx(jv, jv_new, jnp.asarray(1), jnp.asarray(pt),
                                  jnp.asarray(starts), interpret=True)
    else:
        pt = None
        (jk, tk), (jv, tv) = _fp8((L, B, G6, T, D6), 682), _fp8((L, B, G6, T, D6), 683)
        wk = PA.kv_cache_write_idx(jk, jk_new, jnp.asarray(1), jnp.asarray(starts),
                                   interpret=True)
        wv = PA.kv_cache_write_idx(jv, jv_new, jnp.asarray(1), jnp.asarray(starts),
                                   interpret=True)
    got = A.rope_kv_append(_t(q, F16), _t(kv, F16), _t(freqs, F16), tk, tv, 1, _t(starts),
                           None if pt is None else _t(pt))
    assert got.dtype == F16
    np.testing.assert_array_equal(_bits16(got), _bits16(JM.apply_rotary_emb(jq, f)))
    np.testing.assert_array_equal(tk.view(torch.uint8).numpy(), np.asarray(wk).view(np.uint8))
    np.testing.assert_array_equal(tv.view(torch.uint8).numpy(), np.asarray(wv).view(np.uint8))


# ---------------------------------------------------------------------------
# The model in f16: dynamic int8, and over an fp8 cache
# ---------------------------------------------------------------------------

TINY = dict(hidden_size=256, inner_hidden_size=512, head_hidden_size=32,
            num_multi_query_groups=2, num_attention_heads=8, num_layers=2,
            vocab_size=512, max_sequence_length=128)
JCFG, TCFG = JConfig(**TINY), ChatGLM2Config(**TINY)
IDS = np.array([[5, 9, 100, 301, 77, 3, 250], [7, 8, 9, 0, 0, 0, 0]], np.int32)
LENGTHS = np.array([7, 3], np.int32)
STEPS = 8
# (quant, dynamic_int8, paged, cache dtype)
MODEL_CASES = {"int8 dyn": ("int8", True, False, None),
               "int4g32 dyn": ("int4g32", True, False, None),
               "int4g32 fp8 dense": ("int4g32", False, False, "fp8"),
               "int4g32 fp8 paged": ("int4g32", False, True, "fp8")}
_TREES = {}


def _tree(quant):
    if quant not in _TREES:
        jp = JM.init_params(jax.random.PRNGKey(7), JCFG, quant, jnp.float32)
        _TREES[quant] = (jp, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu"))
    return _TREES[quant]


def _jax_model(jp, quant, dyn, paged, kv, teacher):
    rt = TpuRuntimeConfig(use_pallas=True, use_flash_attention=True, dynamic_int8=dyn)
    if paged:
        cache = JPK.init_paged_kv_cache(JCFG, 2, 9, 64, 16, kv)
        cache = cache.replace(page_table=jnp.asarray(PT))
        prefill = jax.jit(lambda p, i, n, c: JPK.prefill_paged(p, JCFG, i, n, c, quant, JF16, rt))
        step = jax.jit(lambda p, t, c: JPK.decode_step_paged(p, JCFG, t, c, quant, JF16, rt))
    else:
        cache = JM.init_kv_cache(JCFG, 2, 32, kv)
        prefill = jax.jit(lambda p, i, n, c: JM.prefill(p, JCFG, i, n, c, quant, JF16, rt))
        step = jax.jit(lambda p, t, c: JM.decode_step(p, JCFG, t, c, quant, JF16, rt))
    logits, cache = prefill(jp, jnp.asarray(IDS), jnp.asarray(LENGTHS), cache)
    out = [np.asarray(logits, np.float32)]
    for s in range(STEPS):
        logits, cache = step(jp, jnp.asarray(teacher[s]), cache)
        out.append(np.asarray(logits, np.float32))
    return out


def _port_model(tp, quant, dyn, paged, kv):
    rt = TorchRuntimeConfig(use_kernels=True, use_flash_attention=True, dynamic_int8=dyn)
    if paged:
        cache = TPK.init_paged_kv_cache(TCFG, 2, 9, 64, 16, kv, device="cpu")
        cache.page_table.copy_(_t(PT))
        prefill, step = TPK.prefill_paged, TPK.decode_step_paged
    else:
        cache = TM.init_kv_cache(TCFG, 2, 32, kv, device="cpu")
        prefill, step = TM.prefill, TM.decode_step
    logits, cache = prefill(tp, TCFG, _t(IDS), _t(LENGTHS), cache, quant, F16, rt)
    out, toks = [logits.float().numpy()], []
    for _ in range(STEPS):
        tok = logits.argmax(-1).to(torch.int32)
        toks.append(tok.numpy())
        logits, cache = step(tp, TCFG, tok, cache, quant, F16, rt)
        assert logits.dtype == F16
        out.append(logits.float().numpy())
    k = cache.k_pool if paged else cache.k
    assert k.dtype == kv
    return out, toks


@pytest.mark.parametrize("case", list(MODEL_CASES))
def test_model_in_f16_matches_jax(case):
    """Prefill and 8 decode steps in f16 (dynamic int8 over an f16 cache,
    or weight-only over an fp8 one), teacher-forced on the port's greedy
    tokens so that a near-tie cannot send the two down other streams; every
    step's logits within LOGIT_TOL of max|JAX|."""
    quant, dyn, paged, cache = MODEL_CASES[case]
    jp, tp = _tree(quant)
    got, toks = _port_model(tp, quant, dyn, paged, FP8 if cache else F16)
    want = _jax_model(jp, quant, dyn, paged, JFP8 if cache else JF16, toks)
    tol = LOGIT_TOL["fp8" if cache else "dyn"]
    for g, w in zip(got, want):
        assert np.isfinite(g).all() and _rel(g, w) <= tol


# ---------------------------------------------------------------------------
# Fine-tuning in f16: the loss and grads, and one step
# ---------------------------------------------------------------------------

_rng = np.random.default_rng(11)
TIDS = _rng.integers(0, TINY["vocab_size"], (2, 12)).astype(np.int32)
TLABELS = TIDS.copy()
TLABELS[:, :3] = -100


def _paths(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_paths(v, prefix + k + "."))
        elif v is not None:
            out[prefix + k] = v
    return out


@pytest.mark.parametrize("quant", ["int8", "int4g32"])
def test_f16_train_step_matches_jax(quant):
    """The loss and the grad of every trainable leaf in f16 (the masters
    f32, the forward and backward in f16 through the Pallas kernels: B6 /
    B1 forward, B13 / B14 backward) against JAX's, then one SGD step of
    ``make_train_step(dtype=float16)`` against JAX's."""
    jp, tp = _tree(quant)
    jrt = TpuRuntimeConfig(use_pallas=True, use_flash_attention=False)
    trt = TorchRuntimeConfig(use_kernels=True, use_flash_attention=False)
    jtr, jfr = JT.partition_params(jp)

    def loss_fn(tr):
        loss, _ = JM.forward(JT.merge_params(tr, jfr), JCFG, jnp.asarray(TIDS),
                             labels=jnp.asarray(TLABELS), quant_type=quant, dtype=JF16, rt=jrt)
        return loss

    jloss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(jtr)
    jgrads = _paths(jgrads)
    trainable, frozen = TT.partition_params(tp)
    loss, grads = TT.loss_and_grads(TCFG, quant, trainable, frozen, _t(TIDS).long(),
                                    _t(TLABELS).long(), F16, trt)
    assert abs(loss.item() - float(jloss)) <= TRAIN_LOSS_TOL * abs(float(jloss))
    names = list(_paths(trainable))
    assert sorted(names) == sorted(jgrads)
    for name, g in zip(names, grads):
        want = np.asarray(jgrads[name], np.float64)
        assert g.dtype == torch.float32 and np.isfinite(g.numpy()).all(), name
        assert np.abs(g.double().numpy() - want).max() <= \
            TRAIN_GRAD_TOL[quant] * np.abs(want).max(), name

    lr = 1e-2
    jstep = jax.jit(JT.make_train_step(JCFG, quant, optax.sgd(lr), JF16, jrt))
    jtr2, _, jloss2 = jstep(jtr, jfr, optax.sgd(lr).init(jtr), jnp.asarray(TIDS),
                            jnp.asarray(TLABELS))
    opt = torch.optim.SGD(TT.trainable_leaves(trainable), lr=lr)
    step = TT.make_train_step(TCFG, quant, opt, F16, trt)
    loss2 = step(trainable, frozen, _t(TIDS).long(), _t(TLABELS).long())
    assert abs(float(loss2) - float(jloss2)) <= TRAIN_LOSS_TOL * abs(float(jloss2))
    want, starts = _paths(jtr2), _paths(jtr)
    for name, v in _paths(trainable).items():
        start = np.asarray(starts[name], np.float64)
        d_want = np.asarray(want[name], np.float64) - start
        d_got = v.detach().double().numpy() - start
        assert np.abs(d_got - d_want).max() <= TRAIN_GRAD_TOL[quant] * np.abs(d_want).max(), name


# ---------------------------------------------------------------------------
# The distributed engines in f16 over an fp8 cache on two gloo ranks
# ---------------------------------------------------------------------------

DCFG = dict(hidden_size=256, inner_hidden_size=512, head_hidden_size=32,
            num_multi_query_groups=2, num_attention_heads=8, num_layers=2,
            vocab_size=1024, max_sequence_length=64)
DPROMPTS = [np.random.RandomState(9).randint(3, 900, size=n).tolist() for n in (19, 4, 26, 9)]
DSUBMIT = dict(max_new_tokens=6, temperature=0.0)
DENGINE = dict(max_batch=4, max_seq_len=64, decode_chunk=4, dtype=F16, kv_dtype=FP8)
# int4g32: its q·s is exact in f16, so JAX's jnp fallback computes the
# port's function (tests/test_torch_fp16.py's DCASES)
DCASES = {
    # the head-sharded cache: the rank's groups, B3 / B4 on them
    "dense heads f16 fp8": ("dense", DENGINE, [DPROMPTS], DSUBMIT),
    # the T-sharded cache: K3 writes, K1 over each shard, the merge
    "dense kv_shard_t chunked f16 fp8": ("dense", dict(DENGINE, prefill_chunk_size=8,
                                                       rt=dict(kv_shard_t=True)), [DPROMPTS],
                                         DSUBMIT),
    # the model-sharded pool: K3, K2 and the all-gathered fp8 pages
    "paged shard_model_pages chunked f16 fp8": (
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
                  jp, None, rt=TpuRuntimeConfig(use_pallas=False), kv_dtype=JFP8, max_batch=4,
                  max_seq_len=64, decode_chunk=4)
    want = eng.run(DPROMPTS, **DSUBMIT)
    ranks = run_spmd(W.engine_cases, 2, "gloo", 200,
                     args=(jax.tree.map(np.asarray, jp), DCFG, "int4g32", [(1, 2, DCASES)]))
    return want, ranks, jp


# The T-sharded cache rounds each shard's output to f16 before the merge,
# where JAX's single-device kernel rounds once: over an fp8 cache that moves
# a logit by a few f16 ulps, and a near-tie may then go the other way (on
# these prompts JAX's own top two differ by 1.84e-3 of max|logits| at one
# step).  Its streams are held as chip_smoke.py holds the engines': every
# emitted token within GAP_TOL · max|logits| of the argmax of JAX's model
# teacher-forced on the stream (largest reading 1.84e-3), the stream shifted
# by one token above it.  The other two cases must equal JAX's tokens.
GAP_TOL = 2.8e-3
GAP_HELD = {"dense kv_shard_t chunked f16 fp8"}


def _jax_gaps(jp, prompts, streams, shift):
    """The largest (max logit − logit of the emitted token) / max|logit|
    over the streams' steps, of JAX's plain model in f16 over an fp8 cache
    prefilled on each prompt and fed its stream; ``shift`` 1 compares each
    step's logits with the next token instead (the control)."""
    cfg, rt = JConfig(**DCFG), TpuRuntimeConfig(use_pallas=False)
    step = jax.jit(lambda p, t, c: JM.decode_step(p, cfg, t, c, "int4g32", JF16, rt))
    worst = 0.0
    for prompt, stream in zip(prompts, streams):
        cache = JM.init_kv_cache(cfg, 1, DCFG["max_sequence_length"], JFP8)
        logits, cache = JM.prefill(jp, cfg, jnp.asarray([prompt]),
                                   jnp.asarray([len(prompt)], jnp.int32), cache, "int4g32", JF16,
                                   rt)
        for i, tok in enumerate(stream):
            lg = np.asarray(logits[0], np.float32)
            if i + shift < len(stream):
                worst = max(worst, (lg.max() - lg[stream[i + shift]]) / np.abs(lg).max())
            logits, cache = step(jp, jnp.asarray([tok], jnp.int32), cache)
    return worst


@pytest.mark.parametrize("name", list(DCASES))
def test_distributed_engine_f16_over_fp8_equals_jax(dist_runs, name):
    """Token for token with JAX's single-device engine in f16 over an fp8
    cache, on every rank (the T-sharded cache: equal on both ranks and
    within GAP_TOL of JAX's greedy choice): f16 activations, the fp8 cache
    written and read through the sharded attention forms, the gloo
    collectives moving fp8 as bytes."""
    want, ranks, jp = dist_runs
    for r in ranks:
        assert r[name]["dtypes"] == ("torch.float16", "torch.float8_e4m3fn")
        assert r[name]["pages_in_use"] in (None, 0)
        assert r[name]["tokens"] == ranks[0][name]["tokens"]
        if name not in GAP_HELD:
            assert r[name]["tokens"] == want, (name, r[name]["tokens"], want)
    if name in GAP_HELD:
        got = ranks[0][name]["tokens"]
        assert _jax_gaps(jp, DPROMPTS, got, 0) <= GAP_TOL < _jax_gaps(jp, DPROMPTS, got, 1)

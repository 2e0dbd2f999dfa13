"""The float8_e4m3fn KV cache of the port against the JAX package's, on the
CPU, fed the same numpy inputs.

* The store: ``ops.attention.kv_store_cast`` over every bf16 bit pattern
  and f32 edge values against JAX's ``astype(float8_e4m3fn)``: bit-equal
  wherever JAX's cast is finite; where JAX gives NaN (±464 and beyond, ±inf)
  the port saturates to ±448, and every NaN is stored as 0x7F.
* The read: the kernels' e4m3 -> bf16 conversion (csrc/attention.cu
  ``e4m3x8_act<bf16>``) emulated with its bit operations over all 256 bytes,
  against JAX's upcast and ``Tensor.to(torch.bfloat16)``, NaN bytes
  included.
* C4: each plain attention version on fp8 K/V against JAX's Pallas kernel
  in interpret mode on the same bytes (B4, B12, B10, B11, B5 fed the upcast
  slab as JAX's model feeds it, K1, K2) and the B3 / B9 writes byte for
  byte.  The plain versions used to round p to v's dtype, fp8 here.
* The model (prefill + 8 decode steps, dense and paged) and the engines
  (``ServingEngine``, ``PagedServingEngine`` with speculation, and
  ``DistributedServingEngine`` on two gloo ranks) with an fp8 cache against
  JAX's: logits at tests/test_torch_model.py's tolerance, greedy tokens
  equal.
"""
import math

import ml_dtypes
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import torch_dist_workers as W  # noqa: E402
from chatglm_q_tpu.config import ChatGLM2Config as JConfig  # noqa: E402
from chatglm_q_tpu.config import GLMLoadConfig as JLoad, TpuRuntimeConfig  # noqa: E402
from chatglm_q_tpu.models import chatglm2 as JM  # noqa: E402
from chatglm_q_tpu.models import paged_kv as JPK  # noqa: E402
from chatglm_q_tpu.ops import pallas_attention as PA  # noqa: E402
from chatglm_q_tpu.serving.engine import ServingEngine as JEngine  # noqa: E402
from chatglm_q_tpu.serving.paged_engine import PagedServingEngine as JPaged  # noqa: E402
from chatglm_q_tpu_torch import ChatGLM2Config, GLMLoadConfig, TorchRuntimeConfig  # noqa: E402
from chatglm_q_tpu_torch.convert import params_from_numpy  # noqa: E402
from chatglm_q_tpu_torch.models import chatglm2 as TM  # noqa: E402
from chatglm_q_tpu_torch.models import paged_kv as TPK  # noqa: E402
from chatglm_q_tpu_torch.ops import attention as A  # noqa: E402
from chatglm_q_tpu_torch.serving import PagedServingEngine, ServingEngine  # noqa: E402
from chatglm_q_tpu_torch.utils.distributed import run_spmd  # noqa: E402

FP8, JFP8 = torch.float8_e4m3fn, jnp.float8_e4m3fn
DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}
# attention outputs against JAX's kernels, as a fraction of max|JAX|: f32
# sums in another order (tests/test_torch_attention.py's 1e-5), or one bf16
# rounding of the output apart (tests/test_torch_dist_attention.py's 1e-2)
OUT_TOL = {"float32": 1e-5, "bfloat16": 1e-2}
LOGIT_TOL = dict(rtol=2e-4, atol=2e-4)  # tests/test_torch_model.py's


def _bytes(x):
    """f32 numpy values as fp8 bytes through JAX's cast (finite inputs)."""
    return np.asarray(jnp.asarray(x, jnp.float32).astype(JFP8)).view(np.uint8)


def _fp8_pair(b):
    """The same fp8 bytes as a JAX array and a torch tensor."""
    return (jnp.asarray(b.view(ml_dtypes.float8_e4m3fn)),
            torch.from_numpy(np.ascontiguousarray(b)).view(FP8))


def _randn(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _t(a, dtype=None):
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t if dtype is None else t.to(dtype)


# ---------------------------------------------------------------------------
# The store and the read
# ---------------------------------------------------------------------------

def test_store_cast_matches_jax_over_every_bf16_pattern():
    bits = np.arange(65536, dtype=np.uint32).astype(np.uint16)
    x = torch.from_numpy(bits.view(np.int16).copy()).view(torch.bfloat16)
    got = A.kv_store_cast(x, FP8).view(torch.uint8).numpy()
    want = np.asarray(jnp.asarray(bits.view(ml_dtypes.bfloat16)).astype(JFP8)).view(np.uint8)
    finite = (want & 0x7F) != 0x7F
    np.testing.assert_array_equal(got[finite], want[finite])
    xf = x.float().numpy()
    nan = np.isnan(xf)
    assert (got[nan] == A.FP8_NAN).all()
    # where JAX's cast gives NaN from a number, the port saturates
    past = ~finite & ~nan
    assert past.sum() > 0 and (np.abs(xf[past]) >= 464).all()
    np.testing.assert_array_equal(got[past], np.where(xf[past] > 0, 0x7E, 0xFE))
    # and every number JAX keeps finite stays so: 460 -> 448
    assert ((got & 0x7F) != 0x7F)[~nan].all()


@pytest.mark.parametrize("value,byte", [
    (448.0, 0x7E), (-448.0, 0xFE), (460.0, 0x7E), (464.0, 0x7E), (-464.0, 0xFE),
    (2.0 ** -9, 0x01), (2.0 ** -10, 0x00), (3 * 2.0 ** -10, 0x02), (-7 * 2.0 ** -9, 0x87),
    (2.0 ** -6, 0x08), (0.0, 0x00), (-0.0, 0x80), (1.0, 0x38), (-2.5, 0xC2)])
def test_store_cast_f32_edges_equal_jax(value, byte):
    x = np.array([value], np.float32)
    want = np.asarray(jnp.asarray(x).astype(JFP8)).view(np.uint8)[0]
    got = A.kv_store_cast(_t(x), FP8).view(torch.uint8)[0].item()
    assert got == want == byte


@pytest.mark.parametrize("value,byte", [
    (470.0, 0x7E), (500.0, 0x7E), (-1e4, 0xFE), (math.inf, 0x7E), (-math.inf, 0xFE),
    (math.nan, 0x7F), (-math.nan, 0x7F)])
def test_store_cast_saturates_where_jax_gives_nan(value, byte):
    """ROADMAP §C: JAX's cast turns finite values from ±464 on (and ±inf)
    into NaN, which then poisons every later token of the row; the port's
    store, like the card's cvt.rn.satfinite, saturates to ±448.  NaN stays
    NaN (one byte)."""
    x = np.array([value], np.float32)
    want = np.asarray(jnp.asarray(x).astype(JFP8)).view(np.uint8)[0]
    assert want & 0x7F == 0x7F  # JAX: NaN
    assert A.kv_store_cast(_t(x), FP8).view(torch.uint8)[0].item() == byte
    assert A.kv_store_cast(_t(x).to(torch.bfloat16), FP8).view(torch.uint8)[0].item() == byte


def _byte_perm(x, s):
    """CUDA's __byte_perm(x, 0, s) on uint32 numpy arrays."""
    out = np.zeros_like(x)
    for i in range(4):
        sel = (s >> (4 * i)) & 0xF
        byte = (x >> np.uint32(8 * sel)) & np.uint32(0xFF) if sel < 4 else np.uint32(0)
        out |= byte << np.uint32(8 * i)
    return out


def _e4m3x2_bf16x2(x):
    """csrc e4m3x2_bf16x2: the bits moved into bf16's places, one bf16x2
    fma by 2^120 (+ -0), the sign or-ed back."""
    mag = (x << np.uint32(4)) & np.uint32(0x07F007F0)
    halves = np.stack([mag & np.uint32(0xFFFF), mag >> np.uint32(16)], -1).astype(np.uint16)
    h = torch.from_numpy(halves.view(np.int16).copy()).view(torch.bfloat16)
    prod = (h.float() * 2.0 ** 120 + -0.0).to(torch.bfloat16)  # exact: fma.rn of an exact product
    p = prod.view(torch.int16).numpy().view(np.uint16).astype(np.uint32)
    return (p[..., 0] | (p[..., 1] << np.uint32(16))) | ((x << np.uint32(8)) & np.uint32(0x80008000))


def e4m3_to_bf16_emulated(b):
    """csrc e4m3x8_act<bf16> over bytes b (a multiple of 8): bf16 bit patterns."""
    w = b.reshape(-1, 2, 4).view(np.uint32).reshape(-1, 2)  # little endian words
    words = []
    for wi in (w[:, 0], w[:, 1]):
        words += [_e4m3x2_bf16x2(_byte_perm(wi, 0x4140)), _e4m3x2_bf16x2(_byte_perm(wi, 0x4342))]
    o = np.stack(words, -1)  # (n, 4) uint32: 8 bf16
    out = np.stack([o & np.uint32(0xFFFF), o >> np.uint32(16)], -1).reshape(-1).astype(np.uint16)
    nan = (b & 0x7F) == 0x7F
    out[nan] = 0x7FC0 | ((b[nan].astype(np.uint16) & 0x80) << 8)
    return out


def test_e4m3_upcast_emulated_over_all_bytes():
    """The kernels' read is exact: equal to JAX's upcast for all 256 bytes,
    NaN bytes (quiet NaN of their sign) and subnormals included; equal to
    PyTorch's ``.to(torch.bfloat16)`` except at 0xFF, where PyTorch drops
    the NaN's sign (both NaN)."""
    b = np.arange(256, dtype=np.uint8)
    got = e4m3_to_bf16_emulated(b)
    jax_bits = np.asarray(jnp.asarray(b.view(ml_dtypes.float8_e4m3fn)).astype(jnp.bfloat16))
    np.testing.assert_array_equal(got, jax_bits.view(np.uint16))
    torch_bits = (torch.from_numpy(b).view(FP8).to(torch.bfloat16).view(torch.int16)
                  .numpy().view(np.uint16))
    differ = np.nonzero(got != torch_bits)[0].tolist()
    assert differ == [0xFF] and (got[0xFF], torch_bits[0xFF]) == (0xFFC0, 0x7FC0)
    # the subnormals m * 2^-9 and the largest value
    vals = torch.from_numpy(got.view(np.int16).copy()).view(torch.bfloat16).float().numpy()
    np.testing.assert_array_equal(vals[:8], np.arange(8) * 2.0 ** -9)
    assert vals[0x7E] == 448.0 and vals[0xFE] == -448.0


def test_store_then_read_roundtrips_every_byte():
    """Every non-NaN byte read (exactly) and stored again is itself."""
    b = np.arange(256, dtype=np.uint8)
    bf = torch.from_numpy(e4m3_to_bf16_emulated(b).view(np.int16).copy()).view(torch.bfloat16)
    back = A.kv_store_cast(bf, FP8).view(torch.uint8).numpy()
    keep = (b & 0x7F) != 0x7F
    np.testing.assert_array_equal(back[keep], b[keep])


# ---------------------------------------------------------------------------
# C4: the plain attention versions on fp8 K/V against JAX's kernels
# ---------------------------------------------------------------------------

def _hold(got, want, dtype):
    got = got.double().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float64)
    err = np.abs(got - want).max()
    assert err <= OUT_TOL[dtype] * np.abs(want).max(), (err, np.abs(want).max())


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_decode_plain_on_fp8_matches_jax(dtype):
    """B4 on an fp8 cache: the read found C4 (0.0566 at max|out| 1.57 in
    bf16, the plain version rounding p to fp8)."""
    B, G, Hg, D, T = 2, 2, 4, 128, 256
    td, jd = DTYPES[dtype]
    q = _randn((B, G, Hg, D), 0)
    (jk, tk), (jv, tv) = _fp8_pair(_bytes(_randn((B, G, T, D), 1))), \
        _fp8_pair(_bytes(_randn((B, G, T, D), 2)))
    lengths = np.array([200, 37], np.int32)
    sm = 1.0 / math.sqrt(D)
    want = PA.flash_attention_decode(jnp.asarray(q, jd), jk, jv, jnp.asarray(lengths), sm, 64,
                                     interpret=True)
    got = A.flash_attention_decode_plain(_t(q, td), tk, tv, _t(lengths), sm)
    _hold(got.float(), jnp.asarray(want, jnp.float32), dtype)
    torch.testing.assert_close(A.flash_attention_decode(_t(q, td), tk, tv, _t(lengths), sm), got,
                               rtol=0, atol=0)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_decode_v2_plain_on_fp8_matches_jax(dtype):
    B, G, Hg, D, T = 2, 2, 4, 128, 256
    td, jd = DTYPES[dtype]
    q = _randn((B, G, Hg, D), 3)
    (jk, tk), (jv, tv) = _fp8_pair(_bytes(_randn((B, G, T, D), 4))), \
        _fp8_pair(_bytes(_randn((B, G, T, D), 5)))
    lengths = np.array([255, 70], np.int32)
    sm = 1.0 / math.sqrt(D)
    want = PA.flash_attention_decode_v2(jnp.asarray(q, jd), jk, jv, jnp.asarray(lengths), sm,
                                        block_k=128, interpret=True)
    got = A.flash_attention_decode_v2_plain(_t(q, td), tk, tv, _t(lengths), sm, 128)
    _hold(got.float(), jnp.asarray(want, jnp.float32), dtype)


def _pool(seed, L=2, NP=9, G=2, P=16, D=128):
    kp = _fp8_pair(_bytes(_randn((L, NP, G, P, D), seed)))
    vp = _fp8_pair(_bytes(_randn((L, NP, G, P, D), seed + 1)))
    return kp, vp


PT = np.array([[5, 2, 7, 3], [8, 1, 6, 4]], np.int32)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_decode_paged_plain_on_fp8_matches_jax(dtype):
    td, jd = DTYPES[dtype]
    (jk, tk), (jv, tv) = _pool(6)
    q = _randn((2, 2, 4, 128), 8)
    lengths = np.array([50, 9], np.int32)
    sm = 1.0 / math.sqrt(128)
    want = PA.flash_attention_decode_paged(jnp.asarray(q, jd), jk, jv, jnp.int32(1),
                                           jnp.asarray(PT), jnp.asarray(lengths), sm,
                                           interpret=True)
    got = A.flash_attention_decode_paged_plain(_t(q, td), tk, tv, 1, _t(PT), _t(lengths), sm)
    _hold(got.float(), jnp.asarray(want, jnp.float32), dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_chunk_paged_plain_on_fp8_matches_jax(dtype):
    td, jd = DTYPES[dtype]
    (jk, tk), (jv, tv) = _pool(9)
    q = _randn((2, 5, 2, 4, 128), 11)
    starts = np.array([40, 3], np.int32)
    sm = 1.0 / math.sqrt(128)
    want = PA.flash_attention_chunk_paged(jnp.asarray(q, jd), jk, jv, jnp.int32(0),
                                          jnp.asarray(PT), jnp.asarray(starts), sm,
                                          interpret=True)
    got = A.flash_attention_chunk_paged_plain(_t(q, td), tk, tv, 0, _t(PT), _t(starts), sm)
    _hold(got.float(), jnp.asarray(want, jnp.float32), dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("chunked", [False, True])
def test_prefill_plain_on_fp8_matches_jax(dtype, chunked):
    """B5 over the fp8 slab as stored, against JAX's kernel fed the slab
    upcast to q's dtype (chatglm_q_tpu/models/chatglm2.py:386)."""
    td, jd = DTYPES[dtype]
    B, S, G, Hg, D, T = 2, 12, 2, 4, 128, 48
    q = _randn((B, S, G, Hg, D), 12)
    (jk, tk), (jv, tv) = _fp8_pair(_bytes(_randn((B, G, T, D), 13))), \
        _fp8_pair(_bytes(_randn((B, G, T, D), 14)))
    sm = 1.0 / math.sqrt(D)
    if chunked:
        starts, lengths = np.array([20, 0], np.int32), np.array([32, 9], np.int32)
        extra = dict(q_starts=jnp.asarray(starts))
        textra = dict(q_starts=_t(starts))
    else:
        lengths, extra, textra = np.array([12, 5], np.int32), {}, {}
    want = PA.flash_attention_prefill(jnp.asarray(q, jd), jk.astype(jd), jv.astype(jd),
                                      jnp.asarray(lengths), sm, 8, 16, interpret=True, **extra)
    got = A.flash_attention_prefill_plain(_t(q, td), tk, tv, _t(lengths), sm, **textra)
    _hold(got.float(), jnp.asarray(want, jnp.float32), dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_decode_lse_plain_on_fp8_matches_jax(dtype):
    """K1 on a T-shard of an fp8 cache: out, m and l."""
    td, jd = DTYPES[dtype]
    B, G, Hg, D, Tl, off = 3, 2, 4, 128, 64, 64
    q = _randn((B, G, Hg, D), 15)
    (jk, tk), (jv, tv) = _fp8_pair(_bytes(_randn((B, G, Tl, D), 16))), \
        _fp8_pair(_bytes(_randn((B, G, Tl, D), 17)))
    lengths = np.array([30, 100, 127], np.int32)
    sm = 1.0 / math.sqrt(D)
    local = np.clip(lengths + 1 - off, 0, Tl) - 1
    want = PA.flash_attention_decode(jnp.asarray(q, jd), jk, jv, jnp.asarray(local), sm, 16,
                                     interpret=True, return_lse=True)
    out, m, l = A.flash_attention_decode_lse_plain(_t(q, td), tk, tv, _t(lengths), sm, off)
    _hold(out.float(), jnp.asarray(want[0], jnp.float32), dtype)
    fin = np.isfinite(np.asarray(want[1]))
    np.testing.assert_array_equal(np.isfinite(m.numpy()), fin)
    np.testing.assert_allclose(m.numpy()[fin], np.asarray(want[1])[fin], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(l.numpy(), np.asarray(want[2]), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("stride,phase", [(2, 0), (2, 1)])
def test_decode_paged_lse_plain_on_fp8_matches_jax(stride, phase):
    """K2 on the strided local table of an fp8 pool."""
    (jk, tk), (jv, tv) = _pool(18)
    q = _randn((2, 2, 4, 128), 20)
    table = np.array([[5, 2], [8, 1]], np.int32)
    lengths = np.array([60, 20], np.int32)
    sm = 1.0 / math.sqrt(128)
    want = PA.flash_attention_decode_paged(
        jnp.asarray(q), jk, jv, jnp.int32(1), jnp.asarray(table), jnp.asarray(lengths), sm,
        interpret=True, stride=stride, phase=jnp.full((1,), phase, jnp.int32), return_lse=True)
    out, m, l = A.flash_attention_decode_paged_lse_plain(_t(q), tk, tv, 1, _t(table),
                                                         _t(lengths), sm, stride, phase)
    _hold(out, want[0], "float32")
    np.testing.assert_allclose(l.numpy(), np.asarray(want[2]), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_kv_writes_on_fp8_equal_jax_bytes(dtype):
    """B3 and B9 into fp8 caches: the stored bytes are JAX's cast of new."""
    td, jd = DTYPES[dtype]
    L, B, G, T, D = 2, 2, 2, 16, 128
    new = _randn((B, G, D), 21) * 40  # some past the top binade
    starts = np.array([3, 15], np.int32)
    cache_b = _bytes(_randn((L, B, G, T, D), 22))
    jc, tc = _fp8_pair(cache_b.copy())
    want = PA.kv_cache_write_idx(jc, jnp.asarray(new, jd), jnp.asarray(1), jnp.asarray(starts),
                                 interpret=True)
    A.kv_cache_write_idx(tc, _t(new, td), 1, _t(starts))
    np.testing.assert_array_equal(tc.view(torch.uint8).numpy(), np.asarray(want).view(np.uint8))
    (jk, tk), _ = _pool(23)
    want = PA.kv_pool_write_idx(jk, jnp.asarray(new, jd), jnp.asarray(0), jnp.asarray(PT),
                                jnp.asarray(np.array([17, 63], np.int32)), interpret=True)
    A.kv_pool_write_idx(tk, _t(new, td), 0, _t(PT), _t(np.array([17, 63], np.int32)))
    np.testing.assert_array_equal(tk.view(torch.uint8).numpy(), np.asarray(want).view(np.uint8))


# ---------------------------------------------------------------------------
# The model: prefill + 8 decode steps, dense and paged
# ---------------------------------------------------------------------------

TINY = dict(hidden_size=256, inner_hidden_size=512, head_hidden_size=32,
            num_multi_query_groups=2, num_attention_heads=8, num_layers=2,
            vocab_size=512, max_sequence_length=128)
JCFG, TCFG = JConfig(**TINY), ChatGLM2Config(**TINY)
IDS = np.array([[5, 9, 100, 301, 77, 3, 250], [7, 8, 9, 0, 0, 0, 0]], np.int32)
LENGTHS = np.array([7, 3], np.int32)
STEPS = 8
PATHS = {"flash": (TpuRuntimeConfig(use_pallas=True, use_flash_attention=True),
                   TorchRuntimeConfig(use_kernels=True, use_flash_attention=True)),
         "masked": (TpuRuntimeConfig(use_pallas=False, use_flash_attention=False),
                    TorchRuntimeConfig(use_kernels=False, use_flash_attention=False))}


@pytest.fixture(scope="module")
def tiny():
    jp = JM.init_params(jax.random.PRNGKey(7), JCFG, "int8", jnp.float32)
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def _jax_model(jp, rt, paged):
    if paged:
        cache = JPK.init_paged_kv_cache(JCFG, 2, 9, 64, 16, JFP8)
        cache = cache.replace(page_table=jnp.asarray(PT))
        prefill = jax.jit(lambda p, i, n, c: JPK.prefill_paged(p, JCFG, i, n, c, "int8",
                                                                 jnp.float32, rt))
        step = jax.jit(lambda p, t, c: JPK.decode_step_paged(p, JCFG, t, c, "int8",
                                                              jnp.float32, rt))
    else:
        cache = JM.init_kv_cache(JCFG, 2, 32, JFP8)
        prefill = jax.jit(lambda p, i, n, c: JM.prefill(p, JCFG, i, n, c, "int8",
                                                        jnp.float32, rt))
        step = jax.jit(lambda p, t, c: JM.decode_step(p, JCFG, t, c, "int8", jnp.float32, rt))
    logits, cache = prefill(jp, jnp.asarray(IDS), jnp.asarray(LENGTHS), cache)
    out, toks = [np.asarray(logits)], []
    for _ in range(STEPS):
        tok = jnp.argmax(logits, -1).astype(jnp.int32)
        toks.append(np.asarray(tok))
        logits, cache = step(jp, tok, cache)
        out.append(np.asarray(logits))
    return out, toks, cache


def _port_model(tp, rt, paged):
    if paged:
        cache = TPK.init_paged_kv_cache(TCFG, 2, 9, 64, 16, FP8, device="cpu")
        cache.page_table.copy_(_t(PT))
        prefill, step = TPK.prefill_paged, TPK.decode_step_paged
    else:
        cache = TM.init_kv_cache(TCFG, 2, 32, FP8, device="cpu")
        prefill, step = TM.prefill, TM.decode_step
    logits, cache = prefill(tp, TCFG, _t(IDS), _t(LENGTHS), cache, "int8", torch.float32, rt)
    out, toks = [logits.numpy()], []
    for _ in range(STEPS):
        tok = logits.argmax(-1).to(torch.int32)
        toks.append(tok.numpy())
        logits, cache = step(tp, TCFG, tok, cache, "int8", torch.float32, rt)
        out.append(logits.numpy())
    return out, toks, cache


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("path", list(PATHS))
def test_model_with_fp8_cache_matches_jax(tiny, path, paged):
    jrt, trt = PATHS[path]
    want, want_toks, jcache = _jax_model(tiny[0], jrt, paged)
    got, toks, cache = _port_model(tiny[1], trt, paged)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **LOGIT_TOL)
    assert [t.tolist() for t in toks] == [t.tolist() for t in want_toks]
    k = cache.k_pool if paged else cache.k
    jk = jcache.k_pool if paged else jcache.k
    assert k.dtype == FP8
    # the caches hold the same bytes but where a K or V element sat on a
    # rounding tie of f32 sums taken in another order
    same = (k.view(torch.uint8).numpy() == np.asarray(jk).view(np.uint8)).mean()
    assert same > 0.999, same


# ---------------------------------------------------------------------------
# The engines
# ---------------------------------------------------------------------------

ETINY = dict(hidden_size=64, inner_hidden_size=64, head_hidden_size=16,
             num_multi_query_groups=2, num_attention_heads=4, num_layers=2,
             vocab_size=128, max_sequence_length=64)
ENGINE_KW = dict(max_batch=4, max_seq_len=64, decode_chunk=4)
# (JAX runtime, port runtime) of each attention path: the flash paths (JAX's
# Pallas attention in interpret mode, jnp matmuls) and the masked ones.  With
# an fp8 cache the two compute different functions (a paged whole-prompt
# prefill attends its fresh K/V on the flash path, the stored bytes on the
# masked one), so each is held to its own.
EPATHS = {"flash": (TpuRuntimeConfig(use_pallas=False, use_flash_attention=True),
                    TorchRuntimeConfig(use_kernels=True, use_flash_attention=True)),
          "masked": (TpuRuntimeConfig(use_pallas=False, use_flash_attention=False),
                     TorchRuntimeConfig())}
SPEC_KW = dict(page_size=8, num_pages=40, speculative_k=4, speculative_ngram=2)


def _workload():
    rng = np.random.default_rng(11)
    head = rng.integers(3, 120, size=16).tolist()
    span = rng.integers(3, 120, size=5).tolist()
    shared = [head + rng.integers(3, 120, size=n).tolist() for n in (5, 3, 9)]
    return list(zip([shared[0], span * 4, [7, 9] + span * 3] + shared[1:], (6, 10, 7, 9, 5)))


WORK = _workload()


def _drain(engine, work=WORK):
    ids = [engine.submit(p, max_new_tokens=b, temperature=0.0) for p, b in work]
    steps = 0
    while engine.has_work:
        engine.step()
        steps += 1
        assert steps < 300, "engine did not drain"
    by_id = {r.req_id: r.generated for r in engine.finished}
    return [by_id[i] for i in ids]


@pytest.fixture(scope="module")
def eparts():
    """The tiny tree for both packages, and JAX's fp8-cache engines' tokens
    by (engine, path, kwargs), each run once."""
    jp = JM.init_params(jax.random.PRNGKey(0), JConfig(**ETINY), "none", jnp.float32)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    jl = JLoad(model_config=JConfig(**ETINY), torch_dtype="float32")
    tl = GLMLoadConfig(model_config=ChatGLM2Config(**ETINY), torch_dtype="float32")
    runs = {}

    def want(paged, path, **kw):
        key = (paged, path, tuple(sorted(kw.items())))
        if key not in runs:
            cls = JPaged if paged else JEngine
            runs[key] = _drain(cls(jl, jp, None, rt=EPATHS[path][0], kv_dtype=JFP8,
                                   **ENGINE_KW, **kw))
        return runs[key]

    return tl, tp, want


@pytest.mark.parametrize("chunked", [False, True])
@pytest.mark.parametrize("path", list(EPATHS))
def test_serving_engine_with_fp8_cache_equals_jax(eparts, path, chunked):
    tl, tp, want = eparts
    kw = dict(prefill_chunk_size=8) if chunked else {}
    eng = ServingEngine(tl, tp, None, rt=EPATHS[path][1], kv_dtype=FP8, device="cpu",
                        **ENGINE_KW, **kw)
    assert eng.cache.k.dtype == FP8
    assert _drain(eng) == want(False, path, **kw)


@pytest.mark.parametrize("chunked", [False, True])
@pytest.mark.parametrize("path", list(EPATHS))
def test_paged_engine_with_fp8_pool_and_speculation_equals_jax(eparts, path, chunked):
    """In-loop speculation over an fp8 pool: its verify steps attend the
    pool (B11's plain version on the flash path)."""
    tl, tp, want = eparts
    kw = dict(SPEC_KW, **(dict(prefill_chunk_size=8) if chunked else {}))
    eng = PagedServingEngine(tl, tp, None, rt=EPATHS[path][1], kv_dtype=FP8, device="cpu",
                             **ENGINE_KW, **kw)
    assert eng.cache.k_pool.dtype == FP8
    assert _drain(eng) == want(True, path, **kw)
    assert eng.stats["spec_accepted"] > 0 and eng.pages_in_use == 0


def test_paged_engine_with_fp8_pool_chunked_prefix_equals_jax(eparts):
    """Chunked admission with the prefix cache: shared fp8 pages, B11 over them."""
    tl, tp, want = eparts
    kw = dict(page_size=8, num_pages=40, prefill_chunk_size=8, prefix_cache=True)
    eng = PagedServingEngine(tl, tp, None, rt=EPATHS["flash"][1], kv_dtype=FP8, device="cpu",
                             **ENGINE_KW, **kw)
    assert _drain(eng) == want(True, "flash", **kw)
    assert eng.stats["prefix_hits"] > 0


# DistributedServingEngine on two gloo ranks (tests/torch_dist_workers.py)
DCFG = dict(hidden_size=256, inner_hidden_size=512, head_hidden_size=32,
            num_multi_query_groups=2, num_attention_heads=8, num_layers=2,
            vocab_size=1024, max_sequence_length=64)
DPROMPTS = [np.random.RandomState(9).randint(3, 900, size=n).tolist() for n in (19, 4, 26, 9)]
DSUBMIT = dict(max_new_tokens=6, temperature=0.0)
DENGINE = dict(max_batch=4, max_seq_len=64, decode_chunk=4, kv_dtype=FP8)
# Each case's prefill attends the stored bytes, as JAX's single-device dense
# engine's does (a ring prefill would attend its fresh K/V).
DCASES = {
    # the head-sharded cache: the rank's groups, B3 / B4 on them (C4's mesh path)
    "dense heads fp8": ("dense", DENGINE, [DPROMPTS], DSUBMIT),
    "dense heads chunked fp8": ("dense", dict(DENGINE, prefill_chunk_size=8), [DPROMPTS],
                                DSUBMIT),
    # the T-sharded cache: K3 writes, K1 over each shard, the merge
    "dense kv_shard_t chunked fp8": ("dense", dict(DENGINE, prefill_chunk_size=8,
                                                   rt=dict(kv_shard_t=True)), [DPROMPTS],
                                     DSUBMIT),
    # the model-sharded pool: K3, K2 and the all-gathered fp8 pages
    "paged shard_model_pages chunked fp8": (
        "paged", dict(DENGINE, num_pages=24, page_size=8, shard_model_pages=True,
                      prefill_chunk_size=8), [DPROMPTS], DSUBMIT),
}


@pytest.fixture(scope="module")
def dist_runs():
    jp = JM.init_params(jax.random.PRNGKey(21), JConfig(**DCFG), "int8", jnp.float32)
    eng = JEngine(JLoad(model_config=JConfig(**DCFG), quant_type="int8", torch_dtype="float32"),
                  jp, None, rt=TpuRuntimeConfig(use_pallas=False), kv_dtype=JFP8,
                  max_batch=4, max_seq_len=64, decode_chunk=4)
    want = eng.run(DPROMPTS, **DSUBMIT)
    ranks = run_spmd(W.engine_cases, 2, "gloo", 200,
                     args=(jax.tree.map(np.asarray, jp), DCFG, "int8", [(1, 2, DCASES)]))
    return want, ranks


@pytest.mark.parametrize("name", list(DCASES))
def test_distributed_engine_with_fp8_cache_equals_jax(dist_runs, name):
    """Token for token with JAX's single-device engine over an fp8 cache, on
    every rank.  The head-sharded decode passed the fp8 slab to the plain
    B4, which rounded p to fp8 (C4)."""
    want, ranks = dist_runs
    for r in ranks:
        assert r[name]["tokens"] == want, (name, r[name]["tokens"], want)
        assert r[name]["pages_in_use"] in (None, 0)

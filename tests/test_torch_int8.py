"""The port's int8 and dynamic-int8 paths against the JAX package, on the CPU.

Kernel level (f32):
* B6 ``int8_matmul_plain`` against JAX ``int8_matmul``'s jnp fallback (which
  scales the weights before the dot: the same function, rounded elsewhere),
  rtol 1e-5 of max|y|.
* B7 ``int8_dyn_matmul_plain`` against ``int8_dyn_matmul_pallas`` in
  interpret mode: the quantized rows and scales equal, the int32
  accumulators exact, the outputs within 1e-6 of max|y|.
* B8 ``int4_dyn_matmul_plain`` against ``int4_dyn_matmul_pallas`` in
  interpret mode, within 1e-5 of max|y| (the group sums run in another
  order).
The dims are ones where JAX really takes its dynamic kernels (N a multiple
of 128, K a block size): each test asserts that JAX's wrapper returned an
array.  Each input has an all-zero row (the 1e-10 clamp of sx).

Model level: greedy tokens over 16 steps equal JAX's for int8 weight-only
(4 layers, JAX's jnp fallback) and for int8 and int4g32 under
``dynamic_int8`` (2 layers, JAX through its Pallas kernels in interpret
mode, where its ``dynamic_int8`` lives).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from chatglm_q_tpu.config import ChatGLM2Config as JConfig, TpuRuntimeConfig  # noqa: E402
from chatglm_q_tpu.models import chatglm2 as JM  # noqa: E402
from chatglm_q_tpu.ops import linear as JL  # noqa: E402
from chatglm_q_tpu.ops import pallas_matmul as PM  # noqa: E402
from chatglm_q_tpu.ops import quant as JQ  # noqa: E402
from chatglm_q_tpu_torch import ChatGLM2Config, TorchRuntimeConfig  # noqa: E402
from chatglm_q_tpu_torch.convert import params_from_numpy  # noqa: E402
from chatglm_q_tpu_torch.models import chatglm2 as TM  # noqa: E402
from chatglm_q_tpu_torch.ops import dyn_matmul as D  # noqa: E402
from chatglm_q_tpu_torch.ops import int8_matmul as I8  # noqa: E402
from chatglm_q_tpu_torch.ops import linear as TL  # noqa: E402
from chatglm_q_tpu_torch.ops import quant_matmul as QM  # noqa: E402

MS = [1, 3, 64, 65, 128]
K, N = 512, 256


def _rng(seed):
    return np.random.default_rng(seed)


def _x(m, k, seed):
    x = _rng(seed).standard_normal((m, k)).astype(np.float32)
    x[m // 2] = 0.0
    return x


def _close(got, want, rel):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rel, atol=rel * np.abs(want).max())


def _int8_weights(seed):
    w = _rng(seed).standard_normal((K, N)).astype(np.float32)
    p = JQ.quantize_linear_int8(jnp.asarray(w))
    return np.array(p["weight"]), np.array(p["weight_scale"])  # writable copies


def _int4_weights(seed):
    w = _rng(seed).standard_normal((K, N)).astype(np.float32)
    p = JQ.quantize_linear_int4(jnp.asarray(w))
    return np.asarray(p["weight"]), np.asarray(p["weight_scale"])


@pytest.mark.parametrize("m", MS)
def test_int8_plain_matches_jax_fallback(m):
    w, s = _int8_weights(m)
    x = _x(m, K, 10 + m)
    want = JL.int8_matmul((False, 128, False), jnp.asarray(x), jnp.asarray(w), jnp.asarray(s))
    tw, ts, tx = torch.from_numpy(w), torch.from_numpy(s), torch.from_numpy(x)
    got = I8.int8_matmul_plain(tx, tw, ts)
    _close(got.numpy(), want, 1e-5)
    # the wrapper runs the plain version on a CPU tensor
    assert torch.equal(I8.int8_matmul(tx, tw, ts), got)


@pytest.mark.parametrize("m", MS)
def test_int8_dyn_plain_matches_jax_interpret(m):
    w, s = _int8_weights(20 + m)
    x = _x(m, K, 30 + m)
    want = PM.int8_dyn_matmul_pallas(jnp.asarray(x), jnp.asarray(w), jnp.asarray(s),
                                     interpret=True)
    assert want is not None  # JAX took its dynamic kernel at these dims
    jxq, jsx = PM._dyn_quantize_rows(jnp.asarray(x))
    xq, sx = D.dyn_quantize_rows(torch.from_numpy(x))
    np.testing.assert_array_equal(xq.numpy(), np.asarray(jxq))
    np.testing.assert_array_equal(sx.numpy(), np.asarray(jsx))
    assert sx[m // 2].item() == pytest.approx(1e-10) and not xq[m // 2].any()
    # the int32 accumulators: exact
    acc = D.int8_dyn_acc_plain(xq, torch.from_numpy(w))
    want_acc = np.asarray(jxq).astype(np.int64) @ w.astype(np.int64)
    np.testing.assert_array_equal(acc.numpy().astype(np.int64), want_acc)
    tx, tw, ts = torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(s)
    got = D.int8_dyn_matmul_plain(tx, tw, ts)
    _close(got.numpy(), want, 1e-6)
    assert torch.equal(D.int8_dyn_matmul(tx, tw, ts), got)


@pytest.mark.parametrize("m", MS)
def test_int4_dyn_plain_matches_jax_interpret(m):
    packed, s = _int4_weights(40 + m)
    x = _x(m, K, 50 + m)
    want = PM.int4_dyn_matmul_pallas(jnp.asarray(x), jnp.asarray(packed), jnp.asarray(s),
                                     interpret=True)
    assert want is not None  # JAX took its dynamic kernel at these dims
    tp = params_from_numpy({"p": packed, "s": s}, "cpu")
    tx = torch.from_numpy(x)
    got = D.int4_dyn_matmul_plain(tx, tp["p"], tp["s"])
    _close(got.numpy(), want, 1e-5)
    assert not got[m // 2].any()
    assert torch.equal(D.int4_dyn_matmul(tx, tp["p"], tp["s"]), got)


def test_dyn_shape_gates_follow_jax():
    """Where JAX's dynamic wrappers return None (and fall back to the
    weight-only kernels), the port's gates refuse too."""
    for k, n in [(512, 256), (512, 96), (96, 256), (640, 128), (384, 128), (64, 128)]:
        x = jnp.ones((2, k), jnp.float32)
        w = jnp.ones((k, n), jnp.int8)
        jax_int8 = PM.int8_dyn_matmul_pallas(x, w, jnp.ones((n,)), interpret=True) is not None
        assert D.int8_dyn_supported(k, n) == jax_int8, (k, n)
        p = jnp.zeros((k // 2, n), jnp.uint8)
        jax_int4 = PM.int4_dyn_matmul_pallas(x, p, jnp.ones((k // 32, n), jnp.bfloat16),
                                             interpret=True) is not None
        assert D.int4_dyn_supported(k, n) == jax_int4, (k, n)


@pytest.mark.parametrize("m", [64, 65])
def test_int4_dyn_ceiling_matches_jax(m):
    """``dynamic_int8`` takes B8 up to _INT4_DYN_M_MAX = 64 rows and B1 from
    65 on, in both packages."""
    assert TL._INT4_DYN_M_MAX == JL._INT4_DYN_M_MAX == 64
    jp = JQ.quantize_linear_int4(jnp.asarray(_rng(60).standard_normal((K, N)), jnp.float32))
    x = _x(m, K, 61)
    want = JL.quant_linear(jnp.asarray(x), jp, "int4g32",
                           TpuRuntimeConfig(use_pallas=True, dynamic_int8=True))
    tp = params_from_numpy({k: np.asarray(v) for k, v in jp.items()}, "cpu")
    tx = torch.from_numpy(x)
    got = TL.quant_linear(tx, tp, "int4g32", TorchRuntimeConfig(dynamic_int8=True))
    _close(got.numpy(), want, 1e-5)
    dyn = D.int4_dyn_matmul_plain(tx, tp["weight"], tp["weight_scale"])
    b1 = QM.int4g32_matmul_plain(tx, tp["weight"], tp["weight_scale"])
    assert torch.equal(got, dyn if m <= 64 else b1)
    assert not torch.equal(dyn, b1)


# ---------------------------------------------------------------------------
# Model level
# ---------------------------------------------------------------------------

TINY = dict(hidden_size=256, inner_hidden_size=512, head_hidden_size=32,
            num_multi_query_groups=2, num_attention_heads=8, vocab_size=512,
            max_sequence_length=128)
IDS = np.array([[5, 9, 100, 301, 77, 3, 250], [7, 8, 9, 0, 0, 0, 0]], np.int32)
LENGTHS = np.array([7, 3], np.int32)
CACHE_LEN = 32


def _greedy_both(quant, layers, steps, jrt, trts, seed):
    jcfg, tcfg = JConfig(num_layers=layers, **TINY), ChatGLM2Config(num_layers=layers, **TINY)
    jp = JM.init_params(jax.random.PRNGKey(seed), jcfg, quant, jnp.float32)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    prefill = jax.jit(lambda p, i, n, c: JM.prefill(p, jcfg, i, n, c, quant, jnp.float32, jrt))
    jc = JM.init_kv_cache(jcfg, 2, CACHE_LEN, jnp.float32)
    logits, jc = prefill(jp, jnp.asarray(IDS), jnp.asarray(LENGTHS), jc)
    first = np.asarray(jnp.argmax(logits, -1).astype(jnp.int32))
    want, _ = jax.jit(lambda p, f, c: JM.multi_step_decode(
        p, jcfg, f, c, steps, None, quant, jnp.float32, jrt))(jp, jnp.asarray(first), jc)
    for trt in trts:
        tc = TM.init_kv_cache(tcfg, 2, CACHE_LEN, torch.float32, device="cpu")
        tlog, tc = TM.prefill(tp, tcfg, torch.from_numpy(IDS), torch.from_numpy(LENGTHS), tc,
                              quant, torch.float32, trt)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(logits), rtol=2e-4, atol=2e-4)
        tfirst = torch.argmax(tlog, -1).to(torch.int32)
        np.testing.assert_array_equal(tfirst.numpy(), first)
        got, _ = TM.multi_step_decode(tp, tcfg, tfirst, tc, steps, None, quant, torch.float32,
                                      trt)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_int8_greedy_tokens_equal_jax_4_layers_16_steps():
    _greedy_both("int8", 4, 16, TpuRuntimeConfig(use_pallas=False),
                 (TorchRuntimeConfig(use_kernels=True, use_flash_attention=True),
                  TorchRuntimeConfig(use_flash_attention=False)), seed=11)


@pytest.mark.parametrize("quant", ["int8", "int4g32"])
def test_dynamic_int8_greedy_tokens_equal_jax(quant):
    _greedy_both(quant, 2, 16, TpuRuntimeConfig(use_pallas=True, dynamic_int8=True),
                 (TorchRuntimeConfig(use_kernels=True, use_flash_attention=True,
                                     dynamic_int8=True),
                  TorchRuntimeConfig(dynamic_int8=True, use_flash_attention=False)), seed=12)

"""The port's backward matmuls (B13 ``int8_matmul_t``, B14
``int4g32_matmul_t``) and the autograd of its quantized linears against the
JAX package.

The plain versions go against the Pallas transposed kernels in interpret
mode and against JAX's jnp fallbacks, at the shapes of
tests/test_pallas_kernels.py: f32 within rtol/atol 1e-4 (that file's
tolerance), bf16 within 1e-2 of max|ref| (the two JAX forms round the scale
at different places: the kernel folds it into g, the fallback into w; one
bf16 rounding is 3.9e-3).  ``quant_linear``'s grad_x goes against
``jax.vjp`` of JAX's ``quant_linear`` (custom_vjp), with dynamic int8 in the
forward and the storage padding stripped, f32 at 1e-4.  On a tensor that
says it is on CUDA, the wrappers reach a kernel launch, never the plain
version.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from chatglm_q_tpu.config import TpuRuntimeConfig  # noqa: E402
from chatglm_q_tpu.ops import linear as JL  # noqa: E402
from chatglm_q_tpu.ops import pallas_matmul as PM  # noqa: E402
from chatglm_q_tpu.ops import quant as JQ  # noqa: E402
from chatglm_q_tpu_torch.config import TorchRuntimeConfig  # noqa: E402
from chatglm_q_tpu_torch.convert import params_from_numpy  # noqa: E402
from chatglm_q_tpu_torch.ops import _build  # noqa: E402
from chatglm_q_tpu_torch.ops import int8_matmul as I8  # noqa: E402
from chatglm_q_tpu_torch.ops import linear as TL  # noqa: E402
from chatglm_q_tpu_torch.ops import quant_matmul as QM  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
SHAPES = [(4, 256, 512), (9, 384, 256)]  # (M, K, N): tests/test_pallas_kernels.py:53-68


def _rng(seed):
    return np.random.default_rng(seed)


def _int8(k, n, seed):
    w, s = JQ.rtn_quantize_int8(jnp.asarray(_rng(seed).standard_normal((k, n)), jnp.float32))
    return np.asarray(w), np.asarray(s)


def _int4(k, n, seed):
    q, s = JQ.rtn_quantize_int4(jnp.asarray(_rng(seed).standard_normal((k, n)), jnp.float32))
    return np.asarray(JQ.pack_int4_tpu(q)), np.asarray(s)


def _bf16_close(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert np.abs(got - want).max() <= 1e-2 * np.abs(want).max()


@pytest.mark.parametrize("m,k,n", SHAPES)
def test_int8_t_plain_matches_pallas_and_fallback(m, k, n):
    w, s = _int8(k, n, m)
    g = _rng(10 + m).standard_normal((m, n)).astype(np.float32)
    tw, ts = params_from_numpy({"w": w, "s": s}, "cpu").values()
    for dtype, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        jg = jnp.asarray(g, jdt)
        kern = PM.int8_matmul_t_pallas(jg, jnp.asarray(w), jnp.asarray(s), interpret=True)
        fall = JL._int8_matmul_t_fallback(jg, jnp.asarray(w), jnp.asarray(s))
        tg = torch.from_numpy(g).to(dtype)
        got = I8.int8_matmul_t_plain(tg, tw, ts)
        assert got.dtype == dtype and got.shape == (m, k)
        assert torch.equal(I8.int8_matmul_t(tg, tw, ts), got)  # CPU: the plain version
        got = got.float().numpy()
        if dtype == torch.float32:
            np.testing.assert_allclose(got, np.asarray(kern), **TOL)
            np.testing.assert_allclose(got, np.asarray(fall), **TOL)
        else:
            _bf16_close(got, kern)
            _bf16_close(got, fall)


@pytest.mark.parametrize("m,k,n", SHAPES)
def test_int4_t_plain_matches_pallas_and_fallback(m, k, n):
    p, s = _int4(k, n, 20 + m)
    g = _rng(30 + m).standard_normal((m, n)).astype(np.float32)
    tp_, ts = params_from_numpy({"p": p, "s": s}, "cpu").values()
    for dtype, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        jg = jnp.asarray(g, jdt)
        kern = PM.int4_matmul_t_pallas(jg, jnp.asarray(p), jnp.asarray(s), interpret=True)
        fall = JL._int4_matmul_t_fallback(jg, jnp.asarray(p), jnp.asarray(s))
        tg = torch.from_numpy(g).to(dtype)
        got = QM.int4g32_matmul_t_plain(tg, tp_, ts)
        assert got.dtype == dtype and got.shape == (m, k)
        assert torch.equal(QM.int4g32_matmul_t(tg, tp_, ts), got)
        got = got.float().numpy()
        if dtype == torch.float32:
            np.testing.assert_allclose(got, np.asarray(kern), **TOL)
            np.testing.assert_allclose(got, np.asarray(fall), **TOL)
        else:
            _bf16_close(got, kern)
            _bf16_close(got, fall)


def _linear_params(quant, k, n, seed):
    w = _rng(seed).standard_normal((k, n)).astype(np.float32) * 0.1
    b = _rng(seed + 1).standard_normal(n).astype(np.float32) * 0.1
    if quant == "int8":
        return JQ.quantize_linear_int8(jnp.asarray(w), jnp.asarray(b))
    return JQ.quantize_linear_int4(jnp.asarray(w), jnp.asarray(b))


@pytest.mark.parametrize("dynamic_int8", [False, True])
@pytest.mark.parametrize("quant", ["int8", "int4g32"])
@pytest.mark.parametrize("m", [5, 70])
def test_quant_linear_grad_x_matches_jax_vjp(quant, m, dynamic_int8):
    """K = 640 stored padded to 1024: grad_x comes back at the logical 640
    columns.  The backward is the weight-only transposed matmul in every
    forward mode (int4-dyn forwards only at M ≤ 64)."""
    K, N = 640, 256
    jp = _linear_params(quant, K, N, m)
    assert jp["weight"].shape[0] * (2 if quant == "int4g32" else 1) == 1024
    x = _rng(40 + m).standard_normal((1, m, K)).astype(np.float32)
    g = _rng(50 + m).standard_normal((1, m, N)).astype(np.float32)
    jrt = TpuRuntimeConfig(use_pallas=True, dynamic_int8=dynamic_int8)  # interpret on CPU
    y_j, vjp = jax.vjp(lambda a: JL.quant_linear(a, jp, quant, jrt), jnp.asarray(x))
    (gx_j,) = vjp(jnp.asarray(g))
    tp = params_from_numpy({k: np.asarray(v) for k, v in jp.items()}, "cpu")
    for use_kernels in (True, False):
        rt = TorchRuntimeConfig(use_kernels=use_kernels, dynamic_int8=dynamic_int8)
        xt = torch.from_numpy(x).requires_grad_(True)
        y = TL.quant_linear(xt, tp, quant, rt)
        y.backward(torch.from_numpy(g))
        assert xt.grad.shape == (1, m, K)
        np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx_j), **TOL)
        assert all(not t.requires_grad and t.grad is None for t in tp.values())
    if not dynamic_int8:
        np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_j), **TOL)


def _graph_nodes(fn, seen=None):
    seen = set() if seen is None else seen
    if fn is not None and type(fn).__name__ not in seen:
        seen.add(type(fn).__name__)
        for nxt, _ in fn.next_functions:
            _graph_nodes(nxt, seen)
    return seen


def test_serving_call_takes_no_autograd_node():
    """Without a gradient to compute (serving), the forward is called as it
    is: no QuantMatmul node on the output."""
    tp = params_from_numpy({k: np.asarray(v) for k, v in _linear_params("int8", 64, 128, 0).items()},
                           "cpu")
    x = torch.ones((2, 64))
    assert TL.quant_linear(x, tp, "int8").grad_fn is None
    y = TL.quant_linear(x.requires_grad_(True), tp, "int8")
    assert "QuantMatmulBackward" in _graph_nodes(y.grad_fn)
    with torch.no_grad():
        assert TL.quant_linear(x, tp, "int8").grad_fn is None


@pytest.mark.parametrize("quant", ["int8", "int4g32"])
def test_backward_takes_the_kernel_wrappers(monkeypatch, quant):
    """With kernels on, the backward calls the B13/B14 wrappers (which, on a
    CUDA tensor, launch or raise); with them off, the plain versions."""
    name = "int8_matmul_t" if quant == "int8" else "int4g32_matmul_t"
    calls = []
    for attr in (name, name + "_plain"):
        fn = getattr(TL, attr)
        monkeypatch.setattr(TL, attr, lambda *a, fn=fn, attr=attr: calls.append(attr) or fn(*a))
    tp = params_from_numpy({k: np.asarray(v) for k, v in _linear_params(quant, 64, 128, 1).items()},
                           "cpu")
    for use_kernels in (True, False):
        x = torch.ones((3, 64), requires_grad=True)
        TL.quant_linear(x, tp, quant, TorchRuntimeConfig(use_kernels=use_kernels)).sum().backward()
    assert calls == [name, name + "_plain"]


class _Launched(Exception):
    pass


class _FakeCuda(torch.Tensor):
    @property
    def is_cuda(self):
        return True


@pytest.fixture
def fake_launch(monkeypatch):
    def call(name, *args):
        raise _Launched(name)

    monkeypatch.setattr(_build, "call", call)
    monkeypatch.setattr(_build, "stream_ptr", lambda t: 0)


@pytest.mark.parametrize("M,dtype,kernel", [(1, torch.bfloat16, "splitk"),
                                            (16, torch.bfloat16, "splitk"),
                                            (17, torch.bfloat16, "mma"), (512, torch.float32, "gemv")])
def test_transposed_wrappers_launch_on_cuda(fake_launch, M, dtype, kernel):
    g = torch.zeros((M, 256), dtype=dtype).as_subclass(_FakeCuda)
    w = torch.zeros((128, 256), dtype=torch.int8)
    with pytest.raises(_Launched, match=f"chatglm_int8_t_{kernel}"):
        I8.int8_matmul_t(g, w, torch.ones(256))
    packed = torch.zeros((64, 256), dtype=torch.uint8)
    with pytest.raises(_Launched, match=f"chatglm_int4_t_{kernel}"):
        QM.int4g32_matmul_t(g, packed, torch.ones((4, 256), dtype=torch.bfloat16))


def test_transposed_wrappers_refuse_what_they_cannot_take(fake_launch):
    g = torch.zeros((4, 12)).as_subclass(_FakeCuda)  # N % 8 != 0
    with pytest.raises(ValueError):
        I8.int8_matmul_t(g, torch.zeros((32, 12), dtype=torch.int8), torch.ones(12))
    g = torch.zeros((4, 16), dtype=torch.float64).as_subclass(_FakeCuda)  # f16 g: ported
    with pytest.raises(TypeError):
        QM.int4g32_matmul_t(g, torch.zeros((16, 16), dtype=torch.uint8),
                            torch.ones((1, 16), dtype=torch.bfloat16))

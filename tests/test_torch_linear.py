"""The port's linears against the JAX package: the plain int4g32 matmul (and
the kernel wrapper's CPU path) against the Pallas int4 kernels in interpret
mode, and ``quant_linear`` for all three quant types against JAX
``quant_linear`` through its Pallas kernels (interpret) and its jnp
fallback.  f32, rtol/atol 1e-4 (the tests/test_pallas_kernels.py tolerance).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from chatglm_q_tpu.config import TpuRuntimeConfig  # noqa: E402
from chatglm_q_tpu.ops import linear as JL  # noqa: E402
from chatglm_q_tpu.ops import pallas_matmul as PM  # noqa: E402
from chatglm_q_tpu.ops import quant as JQ  # noqa: E402
from chatglm_q_tpu_torch.config import TorchRuntimeConfig  # noqa: E402
from chatglm_q_tpu_torch.convert import params_from_numpy  # noqa: E402
from chatglm_q_tpu_torch.ops import linear as TL  # noqa: E402
from chatglm_q_tpu_torch.ops import quant_matmul as QM  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)


def _rng(seed):
    return np.random.default_rng(seed)


def _int4(k, n, seed):
    w = _rng(seed).standard_normal((k, n)).astype(np.float32)
    p = JQ.quantize_linear_int4(jnp.asarray(w))
    return np.asarray(p["weight"]), np.asarray(p["weight_scale"])


@pytest.mark.parametrize("m", [1, 5, 70])
def test_int4g32_plain_matches_pallas_grid_kernel(m):
    K, N = 1024, 256
    packed, scale = _int4(K, N, m)
    x = _rng(100 + m).standard_normal((m, K)).astype(np.float32)
    want = np.asarray(PM.int4_matmul_pallas(jnp.asarray(x), jnp.asarray(packed),
                                            jnp.asarray(scale), interpret=True))
    tp = params_from_numpy({"w": packed, "s": scale}, "cpu")
    xt = torch.from_numpy(x)
    plain = QM.int4g32_matmul_plain(xt, tp["w"], tp["s"])
    np.testing.assert_allclose(plain.numpy(), want, **TOL)
    # the wrapper runs the plain version on a CPU tensor
    np.testing.assert_array_equal(QM.int4g32_matmul(xt, tp["w"], tp["s"]).numpy(), plain.numpy())


@pytest.mark.parametrize("m", [1, 5])
def test_int4g32_plain_matches_pallas_pipelined_kernel(m):
    """The decode-M form (the lm_head at M ≤ 64)."""
    K, N = 1024, 512
    packed, scale = _int4(K, N, 20 + m)
    x = _rng(200 + m).standard_normal((m, K)).astype(np.float32)
    want = PM.int4_matmul_pallas_pipelined(jnp.asarray(x), jnp.asarray(packed),
                                           jnp.asarray(scale), interpret=True)
    assert want is not None
    tp = params_from_numpy({"w": packed, "s": scale}, "cpu")
    got = QM.int4g32_matmul(torch.from_numpy(x), tp["w"], tp["s"])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _linear_params(quant, k, n, seed):
    w = _rng(seed).standard_normal((k, n)).astype(np.float32) * 0.1
    b = _rng(seed + 1).standard_normal(n).astype(np.float32) * 0.1
    if quant == "none":
        return {"weight": jnp.asarray(w), "bias": jnp.asarray(b)}
    if quant == "int8":
        return JQ.quantize_linear_int8(jnp.asarray(w), jnp.asarray(b))
    return JQ.quantize_linear_int4(jnp.asarray(w), jnp.asarray(b))


@pytest.mark.parametrize("use_pallas", [True, False])
@pytest.mark.parametrize("quant", ["none", "int8", "int4g32"])
@pytest.mark.parametrize("m", [1, 5, 70])
def test_quant_linear_matches_jax(quant, m, use_pallas):
    """K = 640 is stored padded to 1024 for the quantized types, so the
    activations are zero-padded on the way in; leading dims are kept."""
    K, N = 640, 256
    jp = _linear_params(quant, K, N, m)
    if quant != "none":
        assert jp["weight"].shape[0] * (2 if quant == "int4g32" else 1) == 1024
    x = _rng(300 + m).standard_normal((1, m, K)).astype(np.float32)
    want = JL.quant_linear(jnp.asarray(x), jp, quant, TpuRuntimeConfig(use_pallas=use_pallas))
    tp = params_from_numpy({k: np.asarray(v) for k, v in jp.items()}, "cpu")
    for rt in (TorchRuntimeConfig(), TorchRuntimeConfig(use_kernels=True),
               TorchRuntimeConfig(use_kernels=False)):
        got = TL.quant_linear(torch.from_numpy(x), tp, quant, rt)
        assert got.shape == (1, m, N)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_gemv_plan_covers_every_group():
    """The split-K plan of the decode kernel covers all K groups, gives every
    K warp of a block work, and fills the card at the main-path shapes."""
    for M, K, N in [(1, 4096, 4096), (4, 4096, 256), (1, 13824, 4096), (4, 4096, 65536),
                    (1, 4096, 13824), (9, 64, 8)]:
        nsplit, gps = QM.gemv_plan(M, K, N)
        G = K // 32
        assert nsplit * gps >= G > (nsplit - 1) * gps
        assert gps >= min(G, QM.GEMV_KW)
    nsplit, _ = QM.gemv_plan(1, 13824, 4096)
    assert nsplit * -(-4096 // QM.GEMV_BN) >= 132  # at least one block per SM
    assert QM.uses_mma(512, 13824, torch.bfloat16)
    assert not QM.uses_mma(4, 13824, torch.bfloat16)
    assert not QM.uses_mma(512, 13824, torch.float32)


class _Launched(Exception):
    pass


def _int8_on_fake_cuda(monkeypatch, dynamic_int8):
    """Route a tensor that says it is on CUDA through quant_linear, with the
    kernel library replaced by a recorder: the call must reach a launch."""
    from chatglm_q_tpu_torch.ops import _build

    jp = _linear_params("int8", 64, 128, 0)
    tp = params_from_numpy({k: np.asarray(v) for k, v in jp.items()}, "cpu")

    class FakeCuda(torch.Tensor):
        @property
        def is_cuda(self):
            return True

    def call(name, *args):
        raise _Launched(name)

    monkeypatch.setattr(_build, "call", call)
    monkeypatch.setattr(_build, "stream_ptr", lambda t: 0)
    x = torch.zeros((1, 64)).as_subclass(FakeCuda)
    rt = TorchRuntimeConfig(use_kernels=True, dynamic_int8=dynamic_int8)
    with pytest.raises(_Launched) as launched:
        TL.quant_linear(x, tp, "int8", rt)
    return str(launched.value)


def test_int8_on_cuda_is_not_ported(monkeypatch):
    """int8 on a CUDA tensor no longer raises NotImplementedError: it goes to
    the B6 kernel (the split-K kernel at M = 1), never the plain version."""
    assert _int8_on_fake_cuda(monkeypatch, False) == "chatglm_int8_splitk_mma"


def test_dynamic_int8_on_cuda_goes_to_the_b7_kernel(monkeypatch):
    assert _int8_on_fake_cuda(monkeypatch, True) == "chatglm_int8_dyn_splitk"

"""The port's GPTQ pieces (chatglm_q_tpu_torch/quant/gptq.py,
ops/gptq_sweep.py, ops/quant.quantize_with_scale_*) against the JAX
package's, on the CPU, from the same numpy inputs.

Tolerances:

* ``quantize_with_scale_*``: bit-equal (round half to even, the same clip);
* ``accumulate_hessian``: rtol 1e-6 plus 1e-6 of max|H| (f32 products summed
  in another order);
* the whole quantizer on the same Hessian (``gptq_quantize_*``): at most 2%
  of the integer grid points differ and the losses agree to 2e-2 — the
  limits of JAX's own test against the reference (tests/test_gptq.py:83-109);
  the Cholesky factors are rounded differently (torch.linalg against
  jax.scipy), which can move a value across a rounding boundary;
* the sweep alone on one factor: the plain per-column loop against JAX's
  ``_sweep_int8`` / ``_sweep_int4``: the grids to 1e-5 of max|grid|, at most
  1% of the integer grid points apart, the scales to rtol 1e-5, the losses
  to rtol 1e-4 (XLA may round a product and a difference as one fused
  operation where PyTorch rounds each).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from chatglm_q_tpu.ops import quant as JQ  # noqa: E402
from chatglm_q_tpu.quant import gptq as JG  # noqa: E402
from chatglm_q_tpu_torch import ops  # noqa: E402
from chatglm_q_tpu_torch.config import TorchRuntimeConfig  # noqa: E402
from chatglm_q_tpu_torch.ops import gptq_sweep as GS  # noqa: E402
from chatglm_q_tpu_torch.ops import quant as TQ  # noqa: E402
from chatglm_q_tpu_torch.quant import gptq as TG  # noqa: E402

PLAIN = TorchRuntimeConfig(use_kernels=False)


def _rng(seed):
    return np.random.default_rng(seed)


def _calib(k, seed, dead=()):
    """Correlated activations (a rank-k/4 mix plus noise), some columns
    dead (all zero), in 4 batches."""
    r = _rng(seed)
    x = r.standard_normal((96, k // 4)) @ r.standard_normal((k // 4, k)) \
        + 0.1 * r.standard_normal((96, k))
    x = x.astype(np.float32)
    x[:, list(dead)] = 0.0
    return np.split(x, 4)


def _hessians(k, seed, dead=()):
    jh, jn = JG.init_hessian(k)
    th, tn = TG.init_hessian(k)
    for xb in _calib(k, seed, dead):
        jh, jn = JG.accumulate_hessian(jh, jn, jnp.asarray(xb))
        th, tn = TG.accumulate_hessian(th, tn, torch.from_numpy(xb))
    return np.asarray(jh), float(jn), th, float(tn)


def _int_grid(grid, scale, int4):
    """The integer grid points of an (N, K) grid under its scales."""
    s = np.repeat(scale, 32, axis=0).T if int4 else scale[:, None]
    return np.round(grid / s)


@pytest.mark.parametrize("kind", ["int8", "int4"])
def test_quantize_with_scale_bit_equal(kind):
    w = _rng(0).standard_normal((128, 48)).astype(np.float32) * 3
    if kind == "int8":
        s = (_rng(1).random(48) * 0.02 + 1e-3).astype(np.float32)
        j, t = JQ.quantize_with_scale_int8, TQ.quantize_with_scale_int8
    else:
        s = (_rng(1).random((4, 48)) * 0.4 + 1e-3).astype(np.float32)
        j, t = JQ.quantize_with_scale_int4, TQ.quantize_with_scale_int4
    w[0, :8] = s.reshape(-1)[:8] * np.array([0.5, 1.5, 2.5, -0.5, -1.5, 200, -200, 3.5],
                                           np.float32)  # ties and clips
    want = np.asarray(j(jnp.asarray(w), jnp.asarray(s)))
    got = t(torch.from_numpy(w), torch.from_numpy(s)).numpy()
    assert got.dtype == want.dtype == np.int8
    np.testing.assert_array_equal(got, want)


def test_accumulate_hessian_matches_jax():
    jh, jn, th, tn = _hessians(96, 3)
    assert jn == tn == 96.0
    np.testing.assert_allclose(th.numpy(), jh, rtol=1e-6, atol=1e-6 * np.abs(jh).max())


@pytest.mark.parametrize("kind", ["int8", "int4"])
def test_gptq_quantize_matches_jax_on_the_same_hessian(kind):
    N, K = 40, 192
    w = _rng(5).standard_normal((N, K)).astype(np.float32)
    jh, _, _, _ = _hessians(K, 6, dead=(7,))
    h = torch.from_numpy(jh.copy())
    if kind == "int8":
        jg, js, jl = JG.gptq_quantize_int8(jnp.asarray(w), jnp.asarray(jh), blocksize=64)
        tg, ts, tl = TG.gptq_quantize_int8(torch.from_numpy(w), h, blocksize=64, rt=PLAIN)
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6)
    else:
        jg, js, jl = JG.gptq_quantize_int4(jnp.asarray(w), jnp.asarray(jh), blocksize=64)
        tg, ts, tl = TG.gptq_quantize_int4(torch.from_numpy(w), h, blocksize=64, rt=PLAIN)
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-3, atol=1e-6)
    jg, js = np.asarray(jg), np.asarray(js)
    assert tg.shape == (N, K) and tg.dtype == torch.float32
    mismatch = np.mean(_int_grid(tg.numpy(), ts.numpy(), kind == "int4")
                       != _int_grid(jg, js, kind == "int4"))
    assert mismatch < 0.02, mismatch
    assert tl > 0
    np.testing.assert_allclose(tl, jl, rtol=2e-2)
    assert np.all(tg.numpy()[:, 7] == 0)  # the dead column quantizes to 0
    x = np.concatenate(_calib(K, 6, dead=(7,)))[-24:]
    np.testing.assert_allclose(TG.debug_mse(torch.from_numpy(x), torch.from_numpy(w), tg),
                               JG.debug_mse(jnp.asarray(x), jnp.asarray(w), jnp.asarray(jg)),
                               rtol=2e-2)


@pytest.mark.parametrize("kind,blocksize", [("int8", 64), ("int8", 100), ("int4", 64),
                                            ("int4", 128)])
def test_plain_sweep_matches_jax_sweep_on_one_factor(kind, blocksize):
    """The sweep alone, on JAX's own factor: group boundaries inside and
    across blocks, a short last block (K = 224), and a dead column."""
    N, K = 24, 224
    w = _rng(8).standard_normal((N, K)).astype(np.float32)
    jh, _, _, _ = _hessians(K, 9, dead=(33,))
    _, wz, u = JG._prepare_hinv(jnp.asarray(jh), jnp.asarray(w), 0.01)
    wz, u = np.asarray(wz), np.asarray(u)
    tw, tu = torch.from_numpy(wz.copy()), torch.from_numpy(u.copy())
    if kind == "int8":
        s = np.array(JG._naive_scale_int8(jnp.asarray(w))[1])
        jg, jl = map(np.asarray, JG._sweep_int8(jnp.asarray(wz), jnp.asarray(u), jnp.asarray(s),
                                                 blocksize))
        js = s
        tg, tl, ts = TG.sweep(tw, tu, torch.from_numpy(s), blocksize,
                              block_fn=GS.gptq_sweep_block_plain)
        assert ts is None
        ts = torch.from_numpy(s)
    else:
        jg, js, jl = map(np.asarray, JG._sweep_int4(jnp.asarray(wz), jnp.asarray(u), blocksize, 32))
        tg, tl, ts = TG.sweep(tw, tu, None, blocksize, 32, block_fn=GS.gptq_sweep_block_plain)
        assert ts.shape == (K // 32, N)
        np.testing.assert_allclose(ts.numpy(), js, rtol=1e-5)
    np.testing.assert_allclose(tg.numpy(), jg, rtol=0, atol=1e-5 * np.abs(jg).max())
    mismatch = np.mean(_int_grid(tg.numpy(), ts.numpy(), kind == "int4")
                       != _int_grid(jg, js, kind == "int4"))
    assert mismatch <= 0.01, mismatch
    np.testing.assert_allclose(tl.numpy(), jl, rtol=1e-4, atol=1e-4 * np.abs(jl).max())
    assert np.all(tg.numpy()[:, 33] == 0) and np.all(tl.numpy()[:, 33] == 0)


def test_sweep_feeds_the_error_back_inside_a_block():
    """The in-block feedback is what the sweep is: on one block of one
    factor, the swept grid differs from the naive grid of the same scale,
    and the block's first column (no earlier error) equals it."""
    N, K = 16, 64
    w = torch.from_numpy(_rng(10).standard_normal((N, K)).astype(np.float32))
    jh, _, _, _ = _hessians(K, 11)
    _, wz, u, failed = TG._prepare_hinv(torch.from_numpy(jh), w, 0.01)
    assert not bool(failed)
    scale = TG._naive_scale_int8(w)[1]
    q, err, loss = GS.gptq_sweep_block(wz, u, scale)
    naive = torch.clamp(torch.round(wz / scale[:, None]), -127, 127) * scale[:, None]
    torch.testing.assert_close(q[:, 0], naive[:, 0], rtol=0, atol=0)
    assert (q != naive).float().mean() > 0.1
    torch.testing.assert_close(err[:, 0], (wz[:, 0] - q[:, 0]) / u[0, 0], rtol=0, atol=0)
    assert torch.all(loss >= 0)


def test_sweep_wrapper_runs_the_plain_version_on_cpu_tensors():
    N, bs = 12, 64
    w = torch.from_numpy(_rng(12).standard_normal((N, 2 * bs)).astype(np.float32))
    u = torch.linalg.cholesky(torch.eye(bs) * 2 + 0.1, upper=True)
    ops.reset_launch_counts()
    for scale in (None, w.abs().amax(dim=1) / 127):
        got = GS.gptq_sweep_block(w[:, bs:], u, scale)  # a strided column slice
        want = GS.gptq_sweep_block_plain(w[:, bs:].contiguous(), u, scale)
        assert len(got) == len(want) == (4 if scale is None else 3)
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
    counts = ops.launch_counts()
    assert counts["gptq_sweep_int8"] == counts["gptq_sweep_int4"] == 0


@pytest.mark.parametrize("kind", ["int8", "int4"])
def test_gptq_linear_params_match_jax(kind):
    K, N = 96, 40
    w_kn = _rng(13).standard_normal((K, N)).astype(np.float32)
    jh, _, _, _ = _hessians(K, 14)
    bias = _rng(15).standard_normal(N).astype(np.float32)
    if kind == "int8":
        jp = JG.gptq_linear_params_int8(jnp.asarray(w_kn), jnp.asarray(jh), jnp.asarray(bias),
                                        blocksize=32)
        tp = TG.gptq_linear_params_int8(torch.from_numpy(w_kn), torch.from_numpy(jh.copy()),
                                        torch.from_numpy(bias), blocksize=32, rt=PLAIN)
        q_j, q_t = np.asarray(jp["weight"]), tp["weight"].numpy()
    else:
        jp = JG.gptq_linear_params_int4(jnp.asarray(w_kn), jnp.asarray(jh), jnp.asarray(bias),
                                        blocksize=32)
        tp = TG.gptq_linear_params_int4(torch.from_numpy(w_kn), torch.from_numpy(jh.copy()),
                                        torch.from_numpy(bias), blocksize=32, rt=PLAIN)
        q_j = TQ.unpack_int4_tpu_q(torch.from_numpy(np.array(jp["weight"]))).numpy()
        q_t = TQ.unpack_int4_tpu_q(tp["weight"]).numpy()
    assert sorted(tp) == sorted(jp)
    for k in jp:
        a, b = np.asarray(jp[k]), tp[k]
        assert tuple(b.shape) == a.shape, k
        assert str(b.dtype).removeprefix("torch.") == a.dtype.name, k
    np.testing.assert_array_equal(tp["bias"].numpy(), bias)
    assert np.mean(q_t != q_j) < 0.02


def test_non_psd_hessian_raises():
    k = 32
    h = -np.eye(k, dtype=np.float32)  # negative definite: the Cholesky fails
    with pytest.raises(FloatingPointError):
        JG.gptq_quantize_int8(jnp.ones((4, k)), jnp.asarray(h))
    with pytest.raises(FloatingPointError, match="non-PSD"):
        TG.gptq_quantize_int8(torch.ones((4, k)), torch.from_numpy(h), rt=PLAIN)

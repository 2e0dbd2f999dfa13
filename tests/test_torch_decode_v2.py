"""B12 (``flash_attention_decode_v2``, the ``decode_attn_v2`` option)
against the JAX package.

The plain version goes against JAX's ``flash_attention_decode_v2`` in
interpret mode on the ragged case of tests/test_attention.py:277-295
(lengths 0, 17, 63, and a row of length −1 that outputs 0): f32 within
rtol/atol 1e-5 (that test's tolerance); bf16 at sm_scale 0.3, where q's
rounding to bf16 before the dot shows, within 1e-2 of max|ref| (one bf16
rounding is 3.9e-3).  The dense serving path with ``decode_attn_v2=True``
goes against the masked path and JAX's v2 path at 2e-4
(tests/test_attention.py:298-320), and ``ServingEngine``'s greedy tokens
against the default path's; the paged engine ignores the option.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from chatglm_q_tpu.config import ChatGLM2Config as JConfig, TpuRuntimeConfig  # noqa: E402
from chatglm_q_tpu.models import chatglm2 as JM  # noqa: E402
from chatglm_q_tpu.ops.pallas_attention import flash_attention_decode_v2 as jax_v2  # noqa: E402
from chatglm_q_tpu_torch import ChatGLM2Config, GLMLoadConfig, TorchRuntimeConfig  # noqa: E402
from chatglm_q_tpu_torch.convert import params_from_numpy  # noqa: E402
from chatglm_q_tpu_torch.models import chatglm2 as TM  # noqa: E402
from chatglm_q_tpu_torch.ops import _build  # noqa: E402
from chatglm_q_tpu_torch.ops import attention as A  # noqa: E402

B, T, G, Hg, D = 3, 64, 2, 4, 16


def _qkv(seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, G, Hg, D)).astype(dtype)
    k = rng.standard_normal((B, G, T, D)).astype(dtype)
    v = rng.standard_normal((B, G, T, D)).astype(dtype)
    return q, k, v


@pytest.mark.parametrize("lengths", [[0, 17, 63], [-1, 5, 40]])
def test_v2_plain_matches_jax_interpret_f32(lengths):
    q, k, v = _qkv(13)
    lens = np.asarray(lengths, np.int32)
    sm = 1.0 / np.sqrt(D)
    want = np.asarray(jax_v2(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lens),
                             sm, 16, interpret=True))
    tq, tk, tv, tl = (torch.from_numpy(a) for a in (q, k, v, lens))
    got = A.flash_attention_decode_v2_plain(tq, tk, tv, tl, sm, 16)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    assert torch.equal(A.flash_attention_decode_v2(tq, tk, tv, tl, sm), got)  # CPU: plain
    if lengths[0] < 0:
        assert not got[0].any() and not want[0].any()


def test_v2_plain_matches_jax_interpret_bf16():
    q, k, v = _qkv(21)
    lens = np.asarray([0, 17, 63], np.int32)
    sm = 0.3
    want = jax_v2(jnp.asarray(q, jnp.bfloat16), jnp.asarray(k, jnp.bfloat16),
                  jnp.asarray(v, jnp.bfloat16), jnp.asarray(lens), sm, 16, interpret=True)
    want = np.asarray(want.astype(jnp.float32))
    bf = [torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)]
    got = A.flash_attention_decode_v2_plain(*bf, torch.from_numpy(lens), sm).float().numpy()
    assert np.abs(got - want).max() <= 1e-2 * np.abs(want).max()
    # B4's numerics (q unscaled, probabilities rounded to bf16) are another function
    b4 = A.flash_attention_decode_plain(*bf, torch.from_numpy(lens), sm).float().numpy()
    assert np.abs(got - b4).max() > 0


class _Launched(Exception):
    pass


class _FakeCuda(torch.Tensor):
    @property
    def is_cuda(self):
        return True


def test_v2_wrapper_launches_on_cuda_and_splits_over_t(monkeypatch):
    def call(name, *args):
        raise _Launched(name, args)

    monkeypatch.setattr(_build, "call", call)
    monkeypatch.setattr(_build, "stream_ptr", lambda t: 0)
    q = torch.zeros((4, 2, 16, 128), dtype=torch.bfloat16).as_subclass(_FakeCuda)
    k = torch.zeros((4, 2, 1024, 128), dtype=torch.bfloat16).as_subclass(_FakeCuda)
    lens = torch.zeros((4,), dtype=torch.int32).as_subclass(_FakeCuda)
    with pytest.raises(_Launched, match="chatglm_decode_attention") as launched:
        A.flash_attention_decode_v2(q, k, k, lens, 0.1)
    span, v2 = launched.value.args[1][12:14]  # one launch of B4's entry, B12's flag
    assert (span, v2) == (64, 1)
    # f32 launches B4's entry too, in form 4; f32 over a bf16 cache raises
    with pytest.raises(_Launched, match="chatglm_decode_attention") as launched:
        A.flash_attention_decode_v2(q.float(), k.float(), k.float(), lens, 0.1)
    assert launched.value.args[1][13] == 1 and launched.value.args[1][-2] == 4
    with pytest.raises(TypeError, match="float32"):
        A.flash_attention_decode_v2(q.float(), k, k, lens, 0.1)
    # the span: block_k, halved until the grid covers the card, down to one
    # 64-row tile, and always whole tiles
    assert A.decode_span(8, 1024, 512) == 64
    assert A.decode_span(2, 8192, 512) == 64
    assert A.decode_span(128, 8192, 512) == 512
    assert A.decode_span(8, 100, 512) == 64
    assert A.decode_span(8, 40, 512) == 64


TINY = dict(hidden_size=64, inner_hidden_size=128, head_hidden_size=16,
            num_multi_query_groups=2, num_attention_heads=4, num_layers=2,
            vocab_size=128, max_sequence_length=64)
IDS = np.array([[3, 17, 42, 99, 5], [7, 9, 11, 0, 0]], np.int32)
LENGTHS = np.array([5, 3], np.int32)
V2 = TorchRuntimeConfig(use_flash_attention=True, decode_attn_v2=True)
MASKED = TorchRuntimeConfig(use_flash_attention=False)


@pytest.fixture(scope="module")
def trees():
    jp = jax.jit(lambda k: JM.init_params(k, JConfig(**TINY), "int4g32", jnp.float32))(
        jax.random.PRNGKey(0))
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def _torch_run(tp, rt, steps=3):
    cfg = ChatGLM2Config(**TINY)
    cache = TM.init_kv_cache(cfg, 2, 16, torch.float32, device="cpu")
    logits, cache = TM.prefill(tp, cfg, torch.from_numpy(IDS), torch.from_numpy(LENGTHS), cache,
                               "int4g32", torch.float32, rt)
    out = [logits]
    for _ in range(steps):
        tok = torch.argmax(logits, -1).to(torch.int32)
        logits, cache = TM.decode_step(tp, cfg, tok, cache, "int4g32", torch.float32, rt)
        out.append(logits)
    return out


def test_serving_path_decode_v2_matches_masked_and_jax(trees, monkeypatch):
    jp, tp = trees
    calls = []
    plain = A.flash_attention_decode_v2_plain
    monkeypatch.setattr(A, "flash_attention_decode_v2_plain",
                        lambda *a: calls.append(1) or plain(*a))
    got = _torch_run(tp, V2)
    assert len(calls) == 3 * TINY["num_layers"]  # every decode step, every layer
    for a, b in zip(got, _torch_run(tp, MASKED)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-4, atol=2e-4)

    jcfg = JConfig(**TINY)
    jrt = TpuRuntimeConfig(use_pallas=False, use_flash_attention=True, decode_attn_v2=True)
    cache = JM.init_kv_cache(jcfg, 2, 16, jnp.float32)
    logits, cache = jax.jit(lambda p, c: JM.prefill(p, jcfg, jnp.asarray(IDS), jnp.asarray(LENGTHS),
                                                    c, "int4g32", jnp.float32, jrt))(jp, cache)
    want = [logits]
    step = jax.jit(lambda p, t, c: JM.decode_step(p, jcfg, t, c, "int4g32", jnp.float32, jrt))
    for _ in range(3):
        logits, cache = step(jp, jnp.argmax(logits, -1).astype(jnp.int32), cache)
        want.append(logits)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-4, atol=2e-4)


def test_engines_take_the_option(trees, monkeypatch):
    """ServingEngine decodes through B12 under the option (through
    ``decode_step``, as ``GLMDecoder`` does) and emits the greedy tokens of
    the default path; the paged engine ignores it."""
    from chatglm_q_tpu_torch.serving import PagedServingEngine, ServingEngine

    _, tp = trees
    cfg = ChatGLM2Config(**TINY)
    load = GLMLoadConfig(model_config=cfg, quant_type="int4g32")
    calls = []
    plain = A.flash_attention_decode_v2_plain
    monkeypatch.setattr(A, "flash_attention_decode_v2_plain",
                        lambda *a: calls.append(1) or plain(*a))

    def tokens(engine_cls, rt, **kw):
        eng = engine_cls(load, tp, max_batch=2, max_seq_len=32, decode_chunk=4, rt=rt,
                         device="cpu", **kw)
        ids = [eng.submit(list(map(int, IDS[0])), temperature=0.0, max_new_tokens=6)]
        while eng.has_work:
            eng.step()
        return {r.req_id: r.generated for r in eng.finished}[ids[0]]

    flash = TorchRuntimeConfig(use_flash_attention=True)
    want = tokens(ServingEngine, flash)
    assert not calls
    assert tokens(ServingEngine, V2) == want and calls
    calls.clear()
    paged = dict(num_pages=12, page_size=8)
    assert tokens(PagedServingEngine, V2, **paged) == tokens(PagedServingEngine, flash, **paged)
    assert not calls

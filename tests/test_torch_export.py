"""``torch.export`` of the port's decode step (examples/export.py, the
counterpart of examples/export_stablehlo.py) on the CPU, and the custom ops
the card's kernels trace as (ops/export_ops.py).

On the CPU the wrappers run their plain versions, so the export traces ATen
ops; the round trip (export, ``torch.export.save``, ``torch.export.load``,
run) must give the eager step's logits, lengths and both caches exactly.
With the wrappers routed to their custom ops as on the card (the routing
switch patched to ignore the device), the graph calls
``chatglm_q_tpu_torch::int4g32_matmul`` / ``::int8_matmul``,
``::rope_kv_append`` (its cache writes declared as mutations) and
``::flash_attention_decode``, and the reloaded program still equals the eager
step.  ``torch.library.opcheck`` checks each op's schema, fake and
mutations.  The eager step itself matches the JAX package's ``decode_step``
at the model tests' tolerance."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from chatglm_q_tpu.config import ChatGLM2Config as JConfig, TpuRuntimeConfig  # noqa: E402
from chatglm_q_tpu.models import chatglm2 as JM  # noqa: E402
from chatglm_q_tpu_torch import ChatGLM2Config, TorchRuntimeConfig  # noqa: E402
from chatglm_q_tpu_torch.convert import params_from_numpy  # noqa: E402
from chatglm_q_tpu_torch.examples import export as EX  # noqa: E402
from chatglm_q_tpu_torch.models import chatglm2 as TM  # noqa: E402
from chatglm_q_tpu_torch.ops import _build  # noqa: E402
from chatglm_q_tpu_torch.ops import export_ops as E  # noqa: E402
from chatglm_q_tpu_torch.ops import quant as Q  # noqa: E402

TINY = dict(hidden_size=64, inner_hidden_size=128, head_hidden_size=16,
            num_multi_query_groups=2, num_attention_heads=4, num_layers=2,
            vocab_size=128, max_sequence_length=64)
JCFG, TCFG = JConfig(**TINY), ChatGLM2Config(**TINY)
FLASH = TorchRuntimeConfig(use_kernels=True, use_flash_attention=True)
F32 = torch.float32
_TREES = {}


@pytest.fixture(autouse=True)
def one_thread():
    """Small models on one thread: under a run of parallel test workers an
    op split over every core's thread waits on all of them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _trees(quant):
    if quant not in _TREES:
        jp = JM.init_params(jax.random.PRNGKey(4), JCFG, quant, jnp.float32)
        _TREES[quant] = (jp, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu"))
    return _TREES[quant]


def _round_trip(quant, rt, tmp_path, dtype=F32):
    _, tp = _trees(quant)
    cache, ids = EX.prefilled_cache(tp, TCFG, quant, dtype, 2, 32, "cpu", rt=rt)
    return EX.round_trip(tp, TCFG, quant, dtype, cache, ids, str(tmp_path / "step.pt2"), rt)


@pytest.mark.parametrize("quant", ["int8", "int4g32"])
@pytest.mark.parametrize("rt_name", ["masked", "flash"])
def test_export_round_trip_equals_the_eager_step(quant, rt_name, tmp_path):
    rt = FLASH if rt_name == "flash" else TorchRuntimeConfig()
    res = _round_trip(quant, rt, tmp_path)
    assert all(res["equal"].values()), res["equal"]
    assert res["ops"] == []  # the CPU traces the plain versions
    logits, lengths = res["logits"][0], res["lengths"][0]
    assert logits.shape == (2, TINY["vocab_size"]) and torch.isfinite(logits).all()
    assert (res["k"][0] != 0).any() and bool((lengths >= 13).all())  # prompts of 12-20 + 1


@pytest.mark.parametrize("quant", ["int8", "int4g32"])
def test_export_through_the_custom_ops(quant, tmp_path, monkeypatch):
    """The card's route: every wrapper of the decode step hands its tensors
    to its custom op while exporting; the reloaded program equals the eager
    step (bf16, as on the card)."""
    monkeypatch.setattr(_build, "exporting", lambda t: torch.compiler.is_exporting())
    res = _round_trip(quant, FLASH, tmp_path, torch.bfloat16)
    assert all(res["equal"].values()), res["equal"]
    mm = "int4g32_matmul" if quant == "int4g32" else "int8_matmul"
    assert res["ops"] == sorted(f"chatglm_q_tpu_torch.{op}.default" for op in
                                (mm, "rope_kv_append", "flash_attention_decode"))


def test_the_wrappers_take_their_ops_only_on_the_card_while_exporting():
    assert not _build.exporting(torch.zeros(1))
    assert not torch.compiler.is_exporting()


def _op_inputs():
    g = torch.Generator().manual_seed(6)
    w = torch.randn((64, 32), generator=g)
    p4, p8 = Q.quantize_linear_int4(w), Q.quantize_linear_int8(w)
    x = torch.randn((3, 64), generator=g).to(torch.bfloat16)
    B, G, Hg, D, L, T = 2, 2, 2, 16, 2, 8
    q = torch.randn((B, G, Hg, D), generator=g).to(torch.bfloat16)
    kv = torch.randn((B, 2 * G * D), generator=g).to(torch.bfloat16)
    freqs = torch.randn((B, D), generator=g).to(torch.bfloat16)
    kc = torch.randn((L, B, G, T, D), generator=g).to(torch.bfloat16)
    vc = torch.randn((L, B, G, T, D), generator=g).to(torch.bfloat16)
    starts = torch.tensor([3, 5], dtype=torch.int32)
    return {
        "int4g32_matmul": (x, p4["weight"], p4["weight_scale"]),
        "int8_matmul": (x, p8["weight"], p8["weight_scale"]),
        "rope_kv_append": (q, kv, freqs, kc, vc, 1, starts, None),
        "flash_attention_decode": (q, kc[1], vc[1], starts, 0.25),
    }


@pytest.mark.parametrize("name", ["int4g32_matmul", "int8_matmul", "rope_kv_append",
                                  "flash_attention_decode"])
def test_custom_ops_opcheck_and_equal_their_wrappers(name):
    from chatglm_q_tpu_torch.ops import attention as A
    from chatglm_q_tpu_torch.ops import int8_matmul as I8
    from chatglm_q_tpu_torch.ops import quant_matmul as QM

    args = _op_inputs()[name]
    wrapper = {"int4g32_matmul": QM.int4g32_matmul, "int8_matmul": I8.int8_matmul,
               "rope_kv_append": A.rope_kv_append,
               "flash_attention_decode": A.flash_attention_decode}[name]
    clone = [a.clone() if isinstance(a, torch.Tensor) else a for a in args]
    got = E.op(name)(*args)
    want = wrapper(*clone)
    assert torch.equal(got, want)
    for a, b in zip(args, clone):  # the same in-place writes (rope_kv_append's caches)
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b)
    torch.library.opcheck(E.op(name), [a.clone() if isinstance(a, torch.Tensor) else a
                                       for a in args])


@pytest.mark.parametrize("quant", ["none", "int8", "int4g32"])
def test_eager_decode_step_matches_jax(quant):
    """The step the export is held against: the port's ``decode_step`` after
    the same prefill as JAX's, logits within rtol/atol 2e-4, lengths equal."""
    jp, tp = _trees(quant)
    ids = np.array([[5, 9, 100, 30, 77, 3], [7, 8, 9, 0, 0, 0]], np.int32)
    lengths = np.array([6, 3], np.int32)
    jrt = TpuRuntimeConfig(use_pallas=False, use_flash_attention=False)
    jc = JM.init_kv_cache(JCFG, 2, 32, jnp.float32)
    jl, jc = JM.prefill(jp, JCFG, jnp.asarray(ids), jnp.asarray(lengths), jc, quant,
                        jnp.float32, jrt)
    nxt = jnp.argmax(jl, -1).astype(jnp.int32)
    want, jc = JM.decode_step(jp, JCFG, nxt, jc, quant, jnp.float32, jrt)
    for rt in (TorchRuntimeConfig(), FLASH):
        tc = TM.init_kv_cache(TCFG, 2, 32, F32, device="cpu")
        _, tc = TM.prefill(tp, TCFG, torch.from_numpy(ids), torch.from_numpy(lengths), tc, quant,
                           F32, rt)
        got, tc = TM.decode_step(tp, TCFG, torch.from_numpy(np.array(nxt)), tc, quant, F32, rt)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-4)
        assert tc.lengths.tolist() == np.asarray(jc.lengths).tolist()

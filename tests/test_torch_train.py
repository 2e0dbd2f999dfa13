"""The port's parity forward, loss and training step against the JAX
package's, on a 2-layer tiny ChatGLM2 in f32.

JAX runs with ``use_pallas=False``: its Pallas kernels ≡ jnp fallback chain
is pinned by the JAX tests.  The port runs its plain versions (CPU tensors),
through the kernel wrappers' CPU path and with ``use_kernels=False``.
Tolerances: logits rtol/atol 2e-4 (tests/test_attention.py's), the loss
1e-5 relative, every trainable leaf's grad within 1e-4 of its max|grad|,
and the leaves after one optimizer step within 1e-5.  Dropout draws from
``torch.Generator``s, which give other numbers than ``jax.random``: its
tests are statistical, or compare the port with itself.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from chatglm_q_tpu.config import ChatGLM2Config as JConfig, TpuRuntimeConfig  # noqa: E402
from chatglm_q_tpu.models import chatglm2 as JM  # noqa: E402
from chatglm_q_tpu.utils import train as JT  # noqa: E402
from chatglm_q_tpu_torch import ChatGLM2Config, TorchRuntimeConfig  # noqa: E402
from chatglm_q_tpu_torch.convert import params_from_numpy  # noqa: E402
from chatglm_q_tpu_torch.models import chatglm2 as TM  # noqa: E402
from chatglm_q_tpu_torch.utils import train as TT  # noqa: E402

TINY = dict(hidden_size=64, inner_hidden_size=128, head_hidden_size=16,
            num_multi_query_groups=2, num_attention_heads=4, num_layers=2,
            vocab_size=128, max_sequence_length=64)
JCFG, TCFG = JConfig(**TINY), ChatGLM2Config(**TINY)
JRT = TpuRuntimeConfig(use_pallas=False, use_flash_attention=False)
RTS = (TorchRuntimeConfig(), TorchRuntimeConfig(use_kernels=False))
TOL = dict(rtol=2e-4, atol=2e-4)
QUANTS = ["none", "int8", "int4g32"]

_rng = np.random.default_rng(3)
IDS = _rng.integers(0, TINY["vocab_size"], (2, 12)).astype(np.int32)
LABELS = IDS.copy()
LABELS[:, :4] = -100
LABELS[1, 9] = -100
MASK = np.ones((2, 12), np.int32)
MASK[1, :3] = 0  # left padding

_PARAMS, _JAX = {}, {}


def _init(key, cfg, quant, dtype):
    return jax.jit(lambda k: JM.init_params(k, cfg, quant, dtype))(key)


def _params(quant):
    if quant not in _PARAMS:
        jp = _init(jax.random.PRNGKey(7), JCFG, quant, jnp.float32)
        _PARAMS[quant] = (jp, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu"))
    return _PARAMS[quant]


def _jax_reference(quant):
    """JAX's loss, logits and the grad of every trainable leaf (one jit)."""
    if quant not in _JAX:
        jp, _ = _params(quant)
        jtr, jfr = JT.partition_params(jp)

        def loss_fn(tr):
            loss, logits = JM.forward(JT.merge_params(tr, jfr), JCFG, jnp.asarray(IDS),
                                      jnp.asarray(MASK), labels=jnp.asarray(LABELS),
                                      quant_type=quant, rt=JRT)
            return loss, logits

        (loss, logits), g = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(jtr)
        _JAX[quant] = float(loss), np.asarray(logits), _paths(g)
    return _JAX[quant]


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _paths(tree, prefix=""):
    """{key path: leaf} of a nested dict, None leaves left out."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_paths(v, prefix + k + "."))
        elif v is not None:
            out[prefix + k] = v
    return out


@pytest.mark.parametrize("quant", QUANTS)
def test_forward_logits_and_loss_match_jax(quant):
    _, tp = _params(quant)
    jl, jlog, _ = _jax_reference(quant)
    for rt in RTS:
        tl, tlog = TM.forward(tp, TCFG, _t(IDS), _t(MASK), labels=_t(LABELS), quant_type=quant,
                              dtype=torch.float32, rt=rt)
        assert tlog.shape == (2, 12, TINY["vocab_size"])
        np.testing.assert_allclose(tlog.detach().numpy(), jlog, **TOL)
        np.testing.assert_allclose(tl.item(), jl, rtol=1e-5)
    loss, _ = TM.forward(tp, TCFG, _t(IDS), quant_type=quant, dtype=torch.float32)
    assert loss is None


@pytest.mark.parametrize("quant", ["none", "int4g32"])
def test_past_key_values_incremental_logits_match_jax(quant):
    """A prefix with ``return_kv``, then the rest with ``past_key_values``:
    the incremental logits equal the full forward's tail and JAX's, and the
    3-tuple's per-layer (k, v) are (B, T_total, G, 1, D)."""
    jp, tp = _params(quant)
    split = 7

    @jax.jit
    def incremental(p):
        _, _, kv = JM.forward(p, JCFG, jnp.asarray(IDS[:, :split]), jnp.asarray(MASK[:, :split]),
                              quant_type=quant, rt=JRT, return_kv=True)
        return JM.forward(p, JCFG, jnp.asarray(IDS[:, split:]), jnp.asarray(MASK),
                          quant_type=quant, rt=JRT, past_key_values=kv)[1:]

    jlog, jkv2 = incremental(jp)
    _, full = TM.forward(tp, TCFG, _t(IDS), _t(MASK), quant_type=quant, dtype=torch.float32)
    loss, _, kv = TM.forward(tp, TCFG, _t(IDS[:, :split]), _t(MASK[:, :split]), quant_type=quant,
                             dtype=torch.float32, return_kv=True)
    assert loss is None and len(kv) == TINY["num_layers"]
    G, D = TINY["num_multi_query_groups"], TINY["head_hidden_size"]
    assert kv[0][0].shape == (2, split, G, 1, D)
    for past in (kv, tuple((k[:, :, :, 0], v[:, :, :, 0]) for k, v in kv),
                 (torch.stack([k[:, :, :, 0] for k, _ in kv]),
                  torch.stack([v[:, :, :, 0] for _, v in kv]))):
        _, log, kv2 = TM.forward(tp, TCFG, _t(IDS[:, split:]), _t(MASK), quant_type=quant,
                                 dtype=torch.float32, past_key_values=past)
        np.testing.assert_allclose(log.numpy(), np.asarray(jlog), **TOL)
        np.testing.assert_allclose(log.numpy(), full[:, split:].numpy(), **TOL)
        assert kv2[0][0].shape == (2, 12, G, 1, D)
        for (k, v), (jk, jv) in zip(kv2, jkv2):
            np.testing.assert_allclose(k.numpy(), np.asarray(jk), **TOL)
            np.testing.assert_allclose(v.numpy(), np.asarray(jv), **TOL)


def test_parity_mask_and_positions_match_jax():
    mask = np.array([[0, 0, 1, 1, 1], [1, 1, 1, 1, 1], [0, 0, 0, 0, 0]], np.int32)
    for n_new in (5, 2):
        jb, jpos = JM.build_parity_mask_and_positions(jnp.asarray(mask), n_new)
        tb, tpos = TM.build_parity_mask_and_positions(_t(mask), n_new)
        assert tb.dtype == torch.float32 and tb.shape == (3, n_new, 5)
        np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
        np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))
    # additive and finite: a query whose keys are all masked gets a uniform
    # softmax, not NaN
    tb, _ = TM.build_parity_mask_and_positions(_t(mask), 5)
    probs = torch.softmax(torch.zeros(3, 5, 5) + tb, dim=-1)
    assert torch.isfinite(tb).all() and torch.isfinite(probs).all()
    torch.testing.assert_close(probs[2], torch.full((5, 5), 0.2))


def test_cross_entropy_matches_jax():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((2, 6, 11)).astype(np.float32) * 3
    labels = rng.integers(0, 11, (2, 6)).astype(np.int32)
    labels[0, 1:4] = -100
    for lab in (labels, np.full_like(labels, -100)):
        want = float(JM.cross_entropy_loss(jnp.asarray(logits), jnp.asarray(lab)))
        got = TM.cross_entropy_loss(_t(logits), _t(lab))
        np.testing.assert_allclose(float(got), want, rtol=1e-6, atol=1e-7)
    assert float(TM.cross_entropy_loss(_t(logits), _t(np.full_like(labels, -100)))) == 0.0


@pytest.mark.parametrize("quant", QUANTS)
def test_grads_of_every_trainable_leaf_match_jax(quant):
    _, tp = _params(quant)
    jloss, _, jgrads = _jax_reference(quant)
    for rt in RTS:
        trainable, frozen = TT.partition_params(tp)
        params = TT.merge_params(trainable, frozen)
        loss, _ = TM.forward(params, TCFG, _t(IDS), _t(MASK), labels=_t(LABELS),
                             quant_type=quant, dtype=torch.float32, rt=rt)
        loss.backward()
        grads = {k: v.grad for k, v in _paths(trainable).items()}
        assert grads.keys() == jgrads.keys()
        np.testing.assert_allclose(loss.item(), jloss, rtol=1e-5)
        for k, g in grads.items():
            want = np.asarray(jgrads[k])
            assert g is not None and g.shape == want.shape, k
            assert np.abs(g.numpy() - want).max() <= 1e-4 * np.abs(want).max(), k


def test_partition_freezes_quantized_scales_and_bias():
    """A quantized linear's weight_scale and bias are frozen with its packed
    weight: one AdamW step with weight decay leaves them as they were and
    moves the norms (tests/test_parallel.py:345-383)."""
    _, tp = _params("int4g32")
    trainable, frozen = TT.partition_params(tp)
    assert trainable["layers"]["w_out"]["weight_scale"] is None
    assert trainable["layers"]["q_proj"]["bias"] is None
    assert frozen["layers"]["w_out"]["weight_scale"] is tp["layers"]["w_out"]["weight_scale"]
    assert trainable["word_embedding"]["weight_scale"] is None
    norm = trainable["layers"]["attn_ln"]["weight"]
    assert norm.dtype == torch.float32 and norm.requires_grad and norm.is_leaf
    assert TT.merge_params(trainable, frozen)["layers"]["w_out"]["weight"].dtype == torch.uint8
    assert set(_paths(trainable)) == {"layers.attn_ln.weight", "layers.ffn_ln.weight",
                                      "final_ln.weight"}

    before = {k: v.clone() for k, v in _paths(frozen).items()}
    start = norm.detach().clone()
    opt = torch.optim.AdamW(TT.trainable_leaves(trainable), lr=1e-2, weight_decay=0.1)
    step = TT.make_train_step(TCFG, "int4g32", opt, torch.float32)
    loss = step(trainable, frozen, torch.ones((2, 8), dtype=torch.long),
                torch.ones((2, 8), dtype=torch.long))
    assert torch.isfinite(loss)
    for k, v in _paths(frozen).items():
        assert torch.equal(v, before[k]), k
    assert not torch.equal(norm.detach(), start)
    assert all(t.grad is None for t in TT.trainable_leaves(trainable))  # zero_grad


@pytest.mark.parametrize("opt_name", ["sgd", "adamw"])
def test_one_train_step_matches_optax(opt_name):
    quant = "int8"
    jp, tp = _params(quant)
    hyper = dict(lr=1e-2, b1=0.9, b2=0.999, eps=1e-8, wd=0.05)
    if opt_name == "sgd":
        jopt = optax.sgd(hyper["lr"])
    else:
        jopt = optax.adamw(hyper["lr"], b1=hyper["b1"], b2=hyper["b2"], eps=hyper["eps"],
                           weight_decay=hyper["wd"])
    jtr, jfr = JT.partition_params(jp)
    jstep = jax.jit(JT.make_train_step(JCFG, quant, jopt, jnp.float32, JRT))
    jtr2, _, jloss = jstep(jtr, jfr, jopt.init(jtr), jnp.asarray(IDS), jnp.asarray(LABELS))
    want = _paths(jtr2)

    trainable, frozen = TT.partition_params(tp)
    leaves = TT.trainable_leaves(trainable)
    if opt_name == "sgd":
        opt = torch.optim.SGD(leaves, lr=hyper["lr"])
    else:
        opt = torch.optim.AdamW(leaves, lr=hyper["lr"], betas=(hyper["b1"], hyper["b2"]),
                                eps=hyper["eps"], weight_decay=hyper["wd"])
    step = TT.make_train_step(TCFG, quant, opt, torch.float32, TorchRuntimeConfig(use_kernels=False))
    loss = step(trainable, frozen, _t(IDS), _t(LABELS))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    got = _paths(trainable)
    assert got.keys() == want.keys()
    for k, v in got.items():
        np.testing.assert_allclose(v.detach().numpy(), np.asarray(want[k]), rtol=0, atol=1e-5)


def test_remat_grads_equal_plain_grads_with_dropout():
    """rt.remat_layers recomputes each layer in the backward pass; with
    dropout on, each layer's generator comes from a seed drawn up front, so
    the recomputation draws the same masks and the grads are bit-equal."""
    cfg = dataclasses.replace(TCFG, dropout_rate=0.2)
    _, tp = _params("int4g32")
    trainable, frozen = TT.partition_params(tp)
    out = {}
    for remat in (False, True):
        rt = TorchRuntimeConfig(remat_layers=remat)
        out[remat] = TT.loss_and_grads(cfg, "int4g32", trainable, frozen, _t(IDS), _t(LABELS),
                                       torch.float32, rt, torch.Generator().manual_seed(11))
    assert torch.equal(out[False][0], out[True][0])
    for a, b in zip(out[False][1], out[True][1]):
        assert torch.equal(a, b)
    # the same seed without remat is deterministic, another seed is not equal
    again = TT.loss_and_grads(cfg, "int4g32", trainable, frozen, _t(IDS), _t(LABELS),
                              torch.float32, None, torch.Generator().manual_seed(11))
    other = TT.loss_and_grads(cfg, "int4g32", trainable, frozen, _t(IDS), _t(LABELS),
                              torch.float32, None, torch.Generator().manual_seed(12))
    assert torch.equal(again[0], out[False][0]) and not torch.equal(other[0], out[False][0])


def test_dropout_statistics():
    x = torch.ones((400, 500))
    for rate in (0.1, 0.5):
        y = TM._dropout(x, rate, torch.Generator().manual_seed(1))
        dropped = (y == 0).float().mean().item()
        assert abs(dropped - rate) < 0.01
        assert abs(y.mean().item() - 1.0) < 0.02  # inverted dropout keeps the mean
        assert torch.allclose(y[y != 0], torch.full_like(y[y != 0], 1 / (1 - rate)))
        again = TM._dropout(x, rate, torch.Generator().manual_seed(1))
        assert torch.equal(y, again)
        assert not torch.equal(y, TM._dropout(x, rate, torch.Generator().manual_seed(2)))
    assert TM._dropout(x.to(torch.bfloat16), 0.3, torch.Generator()).dtype == torch.bfloat16


def test_forward_dropout_only_with_a_generator():
    """config.dropout_rate applies only when a generator is given (JAX:
    ``dropout_rng``); without one the forward equals the rate-0 forward."""
    _, tp = _params("none")
    dcfg = dataclasses.replace(TCFG, dropout_rate=0.5)
    _, base = TM.forward(tp, TCFG, _t(IDS), quant_type="none", dtype=torch.float32)
    _, det = TM.forward(tp, dcfg, _t(IDS), quant_type="none", dtype=torch.float32)
    torch.testing.assert_close(det, base, rtol=0, atol=0)
    _, a = TM.forward(tp, dcfg, _t(IDS), quant_type="none", dtype=torch.float32,
                      generator=torch.Generator().manual_seed(0))
    _, b = TM.forward(tp, dcfg, _t(IDS), quant_type="none", dtype=torch.float32,
                      generator=torch.Generator().manual_seed(0))
    _, c = TM.forward(tp, dcfg, _t(IDS), quant_type="none", dtype=torch.float32,
                      generator=torch.Generator().manual_seed(1))
    assert torch.equal(a, b) and not torch.allclose(a, base) and not torch.allclose(a, c)

"""The port's parity forward and training step over a (data, model) mesh
against the JAX package's, on the CPU.

The port's ranks are processes joined over gloo (``run_spmd``; the rank
functions are tests/torch_dist_workers.py, which imports no jax), each
holding its ``shard_params`` slice of one numpy tree from JAX's
``init_params``; the JAX side runs unsharded with ``use_pallas=False`` (its
GSPMD forward equals its single-device one, tests/test_parallel.py).  The
FFN width 1152 is stored as 1536 in int4g32 and int8, so the (1, 2) mesh's
rank 1 holds w_out's storage-padding rows and w_in's columns end where the
logical ones do.  The −100 labels fall unevenly over the data ranks.

Tolerances: logits rtol = atol = 2e-4 (tests/test_parallel.py:41-43), the
loss 1e-5 relative, grads rtol 3e-4 / atol 3e-5 (tests/test_pipeline.py),
leaves after two SGD(1e-2) steps rtol 1e-5 / atol 1e-6.  Each named
control (per-rank means averaged, no model-axis sum of kv_proj's grad, a
summing gather backward) must miss them.  Dropout draws from a
``torch.Generator``: the mesh is held to the single-process port with the
same generator.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

import torch_dist_workers as W  # noqa: E402
from chatglm_q_tpu.config import ChatGLM2Config as JConfig, TpuRuntimeConfig  # noqa: E402
from chatglm_q_tpu.models import chatglm2 as JM  # noqa: E402
from chatglm_q_tpu.utils import train as JT  # noqa: E402
from chatglm_q_tpu_torch import ChatGLM2Config, TorchRuntimeConfig  # noqa: E402
from chatglm_q_tpu_torch.convert import params_from_numpy  # noqa: E402
from chatglm_q_tpu_torch.parallel import sharding as SH  # noqa: E402
from chatglm_q_tpu_torch.utils import train as TT  # noqa: E402
from chatglm_q_tpu_torch.utils.distributed import run_spmd  # noqa: E402

CFG = dict(hidden_size=256, inner_hidden_size=1152, head_hidden_size=32,
           num_multi_query_groups=2, num_attention_heads=8, num_layers=2,
           vocab_size=1024, max_sequence_length=64)
JCFG = JConfig(**CFG)
JRT = TpuRuntimeConfig(use_pallas=False, use_flash_attention=False)
QUANTS = ["none", "int8", "int4g32"]
MESHES = [(1, 2), (2, 2)]
SGD = [("none", (1, 2)), ("int8", (1, 2)), ("int8", (2, 2))]
LR, STEPS = 1e-2, 2
DROPOUT, DROP_SEED = 0.1, 11
SPLIT = 9  # past_key_values: the prefix's length
SPAWN_TIMEOUT = 200
LOGITS_TOL = dict(rtol=2e-4, atol=2e-4)
GRAD_TOL = dict(rtol=3e-4, atol=3e-5)
LEAF_TOL = dict(rtol=1e-5, atol=1e-6)

_rng = np.random.default_rng(17)
IDS = _rng.integers(0, CFG["vocab_size"], (4, 16)).astype(np.int32)
LABELS = _rng.integers(0, CFG["vocab_size"], (4, 16)).astype(np.int32)
LABELS[:2, :11] = -100  # data rank 0 of a (2, ·) mesh: 8 valid labels
LABELS[2:, :2] = -100   # data rank 1: 26


def _paths(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_paths(v, prefix + k + "."))
        elif v is not None:
            out[prefix + k] = v
    return out


TREES = {q: jax.tree.map(np.asarray, jax.jit(lambda k, q=q: JM.init_params(
    k, JCFG, q, jnp.float32))(jax.random.PRNGKey(41))) for q in QUANTS}


def _jax_forward_and_grads(quant):
    tree = jax.tree.map(jnp.asarray, TREES[quant])
    tr, fr = JT.partition_params(tree)

    def loss_fn(t):
        return JM.forward(JT.merge_params(t, fr), JCFG, jnp.asarray(IDS),
                          labels=jnp.asarray(LABELS), quant_type=quant, rt=JRT)

    (loss, logits), g = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(tr)
    return float(loss), np.asarray(logits), {k: np.asarray(v) for k, v in _paths(g).items()}


def _jax_sgd(quant):
    tree = jax.tree.map(jnp.asarray, TREES[quant])
    tr, fr = JT.partition_params(tree)
    opt = optax.sgd(LR)
    state = opt.init(tr)
    step = jax.jit(JT.make_train_step(JCFG, quant, opt, jnp.float32, JRT))
    losses = []
    for _ in range(STEPS):
        tr, state, loss = step(tr, fr, state, jnp.asarray(IDS), jnp.asarray(LABELS))
        losses.append(float(loss))
    return losses, {k: np.asarray(v) for k, v in _paths(tr).items()}


@pytest.fixture(scope="module")
def jax_ref():
    return {"fwd": {q: _jax_forward_and_grads(q) for q in QUANTS},
            "sgd": {q: _jax_sgd(q) for q in {q for q, _ in SGD}}}


def _kw(quant, **kw):
    return dict(tree=TREES[quant], cfg=CFG, quant=quant, ids=IDS, **kw)


@pytest.fixture(scope="module")
def ranks():
    out = {}
    for nd, nm in MESHES:
        cases = {}
        for q in QUANTS:
            cases[("forward", q)] = ("forward", _kw(q, labels=LABELS))
            cases[("grads", q)] = ("grads", _kw(q, labels=LABELS))
        for q, shape in SGD:
            if shape == (nd, nm):
                cases[("sgd", q)] = ("sgd", _kw(q, labels=LABELS, steps=STEPS, lr=LR))
        cases["dropout"] = ("grads", _kw("none", labels=LABELS, seed=DROP_SEED,
                                         dropout_rate=DROPOUT))
        if (nd, nm) == (1, 2):
            cases["unsummed"] = ("grads_unsummed", _kw("none", labels=LABELS))
            cases["gather_summed"] = ("gather_summed", _kw("none", labels=LABELS))
            cases["remat"] = ("grads", _kw("int4g32", labels=LABELS, remat=True))
            cases["past"] = ("past", _kw("int4g32", split=SPLIT))
        out[(nd, nm)] = run_spmd(W.tp_train_cases, nd * nm, "gloo", SPAWN_TIMEOUT,
                                 args=(nd, nm, cases))
    return out


def _whole_rows(results, name, key):
    """The data ranks' rows side by side (model rank 0's of each)."""
    parts = {d: r[name][key] for d, m, r in results if m == 0}
    return np.concatenate([parts[d] for d in sorted(parts)])


def _rank_slice(quant, path, want, m, tp):
    """Model rank m's part of a whole gradient or leaf ``want``."""
    sl = SH.shard_slices(TREES[quant], ChatGLM2Config(**CFG), quant, tp, m)
    for k in path.split("."):
        sl = sl[k]
    return SH.take_slice(torch.from_numpy(np.array(want)), sl).numpy()


def _hold(results, name, quant, want, tp, tol, key="grads"):
    assert results
    for _, m, r in results:
        got = r[name][key]
        assert set(got) == set(want)
        for path, g in got.items():
            np.testing.assert_allclose(g, _rank_slice(quant, path, want[path], m, tp), **tol,
                                       err_msg=path)


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("quant", QUANTS)
def test_tp_forward_matches_jax(ranks, jax_ref, quant, mesh):
    loss, logits, _ = jax_ref["fwd"][quant]
    res = ranks[mesh]
    np.testing.assert_allclose(_whole_rows(res, ("forward", quant), "logits"), logits,
                               **LOGITS_TOL)
    for _, _, r in res:
        np.testing.assert_allclose(r[("forward", quant)]["loss"], loss, rtol=1e-5)


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("quant", QUANTS)
def test_tp_grads_of_every_trainable_leaf_match_jax(ranks, jax_ref, quant, mesh):
    loss, _, grads = jax_ref["fwd"][quant]
    _hold(ranks[mesh], ("grads", quant), quant, grads, mesh[1], GRAD_TOL)
    for _, _, r in ranks[mesh]:
        np.testing.assert_allclose(r[("grads", quant)]["loss"], loss, rtol=1e-5)


@pytest.mark.parametrize("quant,mesh", SGD)
def test_tp_sgd_steps_match_optax_and_keep_packed_weights(ranks, jax_ref, quant, mesh):
    losses, leaves = jax_ref["sgd"][quant]
    res = ranks[mesh]
    _hold(res, ("sgd", quant), quant, leaves, mesh[1], LEAF_TOL, key="leaves")
    for _, _, r in res:
        np.testing.assert_allclose(r[("sgd", quant)]["losses"], losses, rtol=1e-5)
        assert r[("sgd", quant)]["frozen_unchanged"]
    assert losses[1] < losses[0]


def test_loss_is_the_global_mean_over_uneven_labels(ranks, jax_ref):
    """Every rank's loss is JAX's mean over all valid labels; the control,
    the mean of the data ranks' own means, misses it (8 and 26 labels)."""
    want = jax_ref["fwd"]["none"][0]
    res = ranks[(2, 2)]
    own = [r[("forward", "none")]["own_mean"] for d, m, r in res if m == 0]
    assert len(own) == 2
    with pytest.raises(AssertionError):
        np.testing.assert_allclose(np.mean(own), want, rtol=1e-5)
    for _, _, r in res:
        np.testing.assert_allclose(r[("forward", "none")]["loss"], want, rtol=1e-5)


def test_kv_proj_grad_needs_its_model_axis_sum(ranks, jax_ref):
    """Under "none" kv_proj's weight and bias are whole on every rank but
    each rank's gradient covers its heads' groups: summed over the model
    axis it is JAX's; the control without that sum is not."""
    grads = jax_ref["fwd"]["none"][2]
    res = ranks[(1, 2)]
    for path in ("layers.kv_proj.weight", "layers.kv_proj.bias"):
        for _, m, r in res:
            np.testing.assert_allclose(r[("grads", "none")]["grads"][path], grads[path],
                                       **GRAD_TOL)
            with pytest.raises(AssertionError):
                np.testing.assert_allclose(r["unsummed"]["grads"][path], grads[path],
                                           **GRAD_TOL)


def test_a_summing_gather_backward_misses_the_grads(ranks, jax_ref):
    """The control: ``gather_from_model`` with a backward that sums over the
    model axis (``torch.distributed.nn``'s) gives tp times the gradient
    upstream of the lm_head."""
    grads = jax_ref["fwd"]["none"][2]
    for _, m, r in ranks[(1, 2)]:
        got = r["gather_summed"]["grads"]["final_ln.weight"]
        np.testing.assert_allclose(got, 2 * grads["final_ln.weight"], rtol=1e-3)
        with pytest.raises(AssertionError):
            _hold([(0, m, r)], "gather_summed", "none", grads, 2, GRAD_TOL)


@pytest.mark.parametrize("mesh", MESHES)
def test_dropout_on_the_mesh_equals_the_single_process_port(ranks, mesh):
    """Every rank draws each mask over the global activation and keeps its
    rows and heads or columns: the loss and grads are the single process's
    from the same generator."""
    cfg = ChatGLM2Config(**CFG, dropout_rate=DROPOUT)
    tr, fr = TT.partition_params(params_from_numpy(TREES["none"], "cpu"))
    loss, grads = TT.loss_and_grads(cfg, "none", tr, fr, torch.from_numpy(IDS).long(),
                                    torch.from_numpy(LABELS).long(), torch.float32,
                                    TorchRuntimeConfig(use_kernels=False),
                                    torch.Generator().manual_seed(DROP_SEED))
    want = {k: g.numpy() for k, g in zip(_paths(tr), grads)}
    no_drop = ranks[mesh][0][2][("grads", "none")]["loss"]
    assert abs(no_drop - loss.item()) / loss.item() > 1e-4  # the masks change the loss
    _hold(ranks[mesh], "dropout", "none", want, mesh[1], GRAD_TOL)
    for _, _, r in ranks[mesh]:
        np.testing.assert_allclose(r["dropout"]["loss"], loss.item(), rtol=1e-5)


def test_remat_layers_on_the_mesh_match_jax(ranks, jax_ref):
    _, _, grads = jax_ref["fwd"]["int4g32"]
    _hold(ranks[(1, 2)], "remat", "int4g32", grads, 2, GRAD_TOL)


def test_past_key_values_on_the_mesh_match_jax(ranks, jax_ref):
    """A prefix with ``return_kv``, then the rest over it: the logits of
    JAX's full forward at those positions (causal attention)."""
    logits = jax_ref["fwd"]["int4g32"][1]
    for _, _, r in ranks[(1, 2)]:
        np.testing.assert_allclose(r["past"], logits[:, SPLIT:], **LOGITS_TOL)

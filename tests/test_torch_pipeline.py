"""The port's GPipe pipeline (parallel/pipeline.py) against the JAX
package's, on the CPU: tests/test_pipeline.py's cases.

The port's stages are processes joined over gloo (``run_spmd``; the rank
functions are tests/torch_dist_workers.py, which imports no jax), each
holding its stage's layers of one numpy tree from JAX's ``init_params``;
the stage meshes are JAX's test meshes' layout, rank s · n_rep + r.  JAX
runs its ``pp_forward`` on its (stage, rep) mesh of the conftest's 8
virtual devices, and ``M.forward`` / ``jax.grad`` of it unsharded.

Tolerances (tests/test_pipeline.py's): logits rtol = atol = 2e-5, the loss
1e-5 relative, grads rtol 3e-4 / atol 3e-5.  The control, the pipeline's
output gradient summed over the stages before the last stage takes it,
must miss them.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

import torch_dist_workers as W  # noqa: E402
from chatglm_q_tpu.config import ChatGLM2Config as JConfig, TpuRuntimeConfig  # noqa: E402
from chatglm_q_tpu.models import chatglm2 as JM  # noqa: E402
from chatglm_q_tpu.parallel import pipeline as JPP  # noqa: E402
from chatglm_q_tpu.utils import train as JT  # noqa: E402
from chatglm_q_tpu_torch.utils.distributed import run_spmd  # noqa: E402

pytestmark = pytest.mark.skipif(jax.device_count() < 8, reason="needs 8 virtual devices")

CFG = dict(hidden_size=64, inner_hidden_size=128, head_hidden_size=16,
           num_multi_query_groups=2, num_attention_heads=4, num_layers=4,
           vocab_size=256, max_sequence_length=64)
JCFG = JConfig(**CFG)
RT = TpuRuntimeConfig(use_pallas=False)
FORWARD = [("none", 2, 2), ("int4g32", 2, 2), ("none", 4, 4), ("int4g32", 4, 4)]
JAX_PP = {("none", 2, 2), ("int4g32", 4, 4)}  # also held against JAX's pp_forward
SPAWN_TIMEOUT = 200
LOGITS_TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_TOL = dict(rtol=3e-4, atol=3e-5)

_rng = np.random.default_rng(23)
IDS = _rng.integers(0, CFG["vocab_size"], (4, 24)).astype(np.int32)
LABELS = _rng.integers(0, CFG["vocab_size"], (4, 24)).astype(np.int32)
LABELS[:, :3] = -100


def _paths(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_paths(v, prefix + k + "."))
        elif v is not None:
            out[prefix + k] = v
    return out


TREES = {q: jax.tree.map(np.asarray, jax.jit(lambda k, q=q: JM.init_params(
    k, JCFG, q, jnp.float32))(jax.random.PRNGKey(3))) for q in ("none", "int4g32")}


def _stage_mesh(n_stage):
    return Mesh(np.array(jax.devices()[:8]).reshape(n_stage, -1), (JPP.STAGE_AXIS, "rep"))


@pytest.fixture(scope="module")
def jax_ref():
    out = {}
    for quant in ("none", "int4g32"):
        tree = jax.tree.map(jnp.asarray, TREES[quant])
        tr, fr = JT.partition_params(tree)

        def loss_fn(t, quant=quant, fr=fr):
            return JM.forward(JT.merge_params(t, fr), JCFG, jnp.asarray(IDS),
                              labels=jnp.asarray(LABELS), quant_type=quant, rt=RT)

        (loss, logits), g = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(tr)
        out[quant] = (float(loss), np.asarray(logits),
                      {k: np.asarray(v) for k, v in _paths(g).items()})
    for quant, n_stage, n_micro in JAX_PP:
        mesh = _stage_mesh(n_stage)
        with mesh:
            sharded = JPP.shard_layers(jax.tree.map(jnp.asarray, TREES[quant]), mesh)
            loss, logits = jax.jit(lambda p, i, lab, q=quant, m=mesh, n=n_micro: JPP.pp_forward(
                p, JCFG, i, lab, q, jnp.float32, RT, m, n))(sharded, jnp.asarray(IDS),
                                                            jnp.asarray(LABELS))
        out[("pp", quant, n_stage, n_micro)] = (float(loss), np.asarray(logits))
    return out


def _kw(quant, n_micro):
    return dict(tree=TREES[quant], cfg=CFG, quant=quant, ids=IDS, labels=LABELS,
                n_micro=n_micro)


@pytest.fixture(scope="module")
def ranks():
    two = {(q, 2, n): ("forward", _kw(q, n)) for q, s, n in FORWARD if s == 2}
    two["grads"] = ("grads", _kw("none", 2))
    two["summed"] = ("summed", _kw("none", 2))
    two["step"] = ("step", _kw("int4g32", 2))
    four = {(q, 4, n): ("forward", _kw(q, n)) for q, s, n in FORWARD if s == 4}
    reps = {"reps": ("forward", _kw("none", 2))}
    return {2: run_spmd(W.pipeline_cases, 2, "gloo", SPAWN_TIMEOUT, args=([(1, 2, two)],)),
            4: run_spmd(W.pipeline_cases, 4, "gloo", SPAWN_TIMEOUT,
                        args=([(1, 4, four), (2, 2, reps)],))}


@pytest.mark.parametrize("quant,n_stage,n_micro", FORWARD)
def test_pp_forward_matches_jax(ranks, jax_ref, quant, n_stage, n_micro):
    want_loss, want_logits, _ = jax_ref[quant]
    for res in ranks[n_stage]:
        _, r = res[(quant, n_stage, n_micro)]
        np.testing.assert_allclose(r["logits"], want_logits, **LOGITS_TOL)
        np.testing.assert_allclose(r["loss"], want_loss, rtol=1e-5)
        if ("pp", quant, n_stage, n_micro) in jax_ref:
            pp_loss, pp_logits = jax_ref[("pp", quant, n_stage, n_micro)]
            np.testing.assert_allclose(r["logits"], pp_logits, **LOGITS_TOL)
            np.testing.assert_allclose(r["loss"], pp_loss, rtol=1e-5)


def test_pp_replicas_of_each_stage_match_jax(ranks, jax_ref):
    """Two stages of two replicas each (JAX's (2, 4) mesh's layout on four
    ranks): every rank gives the plain forward's logits."""
    want_loss, want_logits, _ = jax_ref["none"]
    assert sorted(res["reps"][0] for res in ranks[4]) == [0, 0, 1, 1]
    for res in ranks[4]:
        np.testing.assert_allclose(res["reps"][1]["logits"], want_logits, **LOGITS_TOL)
        np.testing.assert_allclose(res["reps"][1]["loss"], want_loss, rtol=1e-5)


def _gathered(ranks, name):
    """{leaf: grad} with the layer leaves' stage parts stacked in stage
    order; the other leaves from every stage, which must agree."""
    by_stage = dict(res[name] for res in ranks)
    out = {}
    for path in by_stage[0]["grads"]:
        parts = [by_stage[s]["grads"][path] for s in sorted(by_stage)]
        if path.startswith("layers."):
            out[path] = np.concatenate(parts)
        else:
            for p in parts[1:]:
                np.testing.assert_allclose(p, parts[0], **GRAD_TOL, err_msg=path)
            out[path] = parts[0]
    return out


def test_pp_grads_match_plain(ranks, jax_ref):
    """The backward pipeline: final_ln, word_embedding and lm_head whole on
    every stage, each stage's layer grads its layers' (every trainable
    leaf, layers.attn_ln among them), all equal to jax.grad of the plain
    forward."""
    _, _, want = jax_ref["none"]
    got = _gathered(ranks[2], "grads")
    assert set(got) == set(want)
    for path in ("final_ln.weight", "word_embedding.weight", "lm_head.weight",
                 "layers.attn_ln.weight"):
        assert path in got
    for path, g in got.items():
        np.testing.assert_allclose(g, want[path], **GRAD_TOL, err_msg=path)


def test_pp_summed_output_grad_misses(ranks, jax_ref):
    """The control: the last stage takes the output gradient summed over
    the stages (S copies of it); its layer grads come out S times too
    large."""
    _, _, want = jax_ref["none"]
    got = _gathered(ranks[2], "summed")
    with pytest.raises(AssertionError):
        for path, g in got.items():
            np.testing.assert_allclose(g, want[path], **GRAD_TOL, err_msg=path)
    np.testing.assert_allclose(got["layers.attn_ln.weight"][2:],
                               2 * want["layers.attn_ln.weight"][2:], rtol=1e-3, atol=1e-6)


def test_pp_train_step_through_quantized_layers(ranks):
    """One SGD step through int4g32 stages (B14's plain version in each
    stage's backward): a finite loss, final_ln moved, packed weights,
    scales and the embedding bit-unchanged."""
    for res in ranks[2]:
        _, r = res["step"]
        assert np.isfinite(r["loss"])
        assert r["final_ln_moved"] and r["frozen_unchanged"]

"""The port's distributed engines against the JAX package's engine, on the
CPU: token for token, as tests/test_dist_paged.py and tests/test_parallel.py
hold JAX's distributed engines against its single-device ``ServingEngine``.

The port's ranks are spawned once a world size (gloo; tests/torch_dist_workers.py,
which imports no jax) and run every case on their shard of the same JAX
tree, an f32 small config: ``DistributedServingEngine`` with ``kv_shard_t``
(whole-prompt admission through the ring, and chunked), head-sharded with
chunked admission; ``DistributedPagedServingEngine`` with
``shard_model_pages`` (chunked with the prefix cache, and whole-prompt) and
with the data-sharded pool; on a (2, 2) mesh the slot-group balancing, the
prefix affinity (a request follows the data group that holds its prefix)
and per-group page locality; on a (1, 4) mesh the T-sharded and
model-sharded engines again.  JAX's ``ServingEngine`` (its jnp path) gives
the reference tokens.  Every run ends with no page in use.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import torch_dist_workers as W  # noqa: E402
from chatglm_q_tpu.config import ChatGLM2Config as JConfig  # noqa: E402
from chatglm_q_tpu.config import GLMLoadConfig as JLoad, TpuRuntimeConfig  # noqa: E402
from chatglm_q_tpu.models import chatglm2 as JM  # noqa: E402
from chatglm_q_tpu.serving.engine import ServingEngine as JEngine  # noqa: E402
from chatglm_q_tpu_torch.utils.distributed import run_spmd  # noqa: E402

CFG = dict(hidden_size=256, inner_hidden_size=512, head_hidden_size=32,
           num_multi_query_groups=2, num_attention_heads=8, num_layers=2,
           vocab_size=1024, max_sequence_length=64)
QUANT = "int8"
SPAWN_TIMEOUT = 200
ENGINE = dict(max_batch=4, max_seq_len=64, decode_chunk=4)
PAGED = dict(num_pages=24, page_size=8)
SUBMIT = dict(max_new_tokens=5, temperature=0.0)


def _prompts():
    rng = np.random.RandomState(9)
    plain = [rng.randint(3, 900, size=n).tolist() for n in (19, 4, 26, 9)]
    head = rng.randint(3, 900, size=16).tolist()  # two pages of 8
    x = rng.randint(3, 900, size=12).tolist()
    a = head + rng.randint(3, 900, size=7).tolist()
    b = head + rng.randint(3, 900, size=5).tolist()
    return plain, x, a, b


PLAIN, X, A_, B_ = _prompts()
CASES_12 = {
    "dense kv_shard_t": ("dense", dict(ENGINE, rt=dict(kv_shard_t=True)), [PLAIN], SUBMIT),
    "dense kv_shard_t chunked": ("dense", dict(ENGINE, prefill_chunk_size=8,
                                               rt=dict(kv_shard_t=True)), [PLAIN], SUBMIT),
    "dense heads chunked": ("dense", dict(ENGINE, prefill_chunk_size=8), [PLAIN], SUBMIT),
    "paged shard_model_pages chunked prefix": (
        "paged", dict(ENGINE, **PAGED, shard_model_pages=True, prefill_chunk_size=8,
                      prefix_cache=True), [PLAIN[:2], [A_], [B_]], SUBMIT),
    "paged shard_model_pages whole": ("paged", dict(ENGINE, **PAGED, shard_model_pages=True),
                                      [PLAIN], SUBMIT),
    "paged data-sharded chunked": ("paged", dict(ENGINE, **PAGED, prefill_chunk_size=8),
                                   [PLAIN], SUBMIT),
}
CASES_14 = {  # a model axis of 4: each rank 2 of 8 heads, the T-shards and page phases of 4
    "dense kv_shard_t tp=4": ("dense", dict(ENGINE, rt=dict(kv_shard_t=True)), [PLAIN], SUBMIT),
    "paged shard_model_pages tp=4 chunked prefix": (
        "paged", dict(ENGINE, **PAGED, shard_model_pages=True, prefill_chunk_size=8,
                      prefix_cache=True), [PLAIN[:2], [A_], [B_]], SUBMIT),
}
CASES_22 = {
    "dense balanced": ("dense", dict(ENGINE, prefill_chunk_size=8), [PLAIN[:2], PLAIN[2:]],
                       SUBMIT),
    "paged shard_model_pages prefix affinity": (
        "paged", dict(ENGINE, **PAGED, shard_model_pages=True, prefill_chunk_size=8,
                      prefix_cache=True), [[X, A_], [B_]], SUBMIT),
}


@pytest.fixture(scope="module")
def tree():
    params = JM.init_params(jax.random.PRNGKey(21), JConfig(**CFG), QUANT, jnp.float32)
    return params, jax.tree.map(np.asarray, params)


@pytest.fixture(scope="module")
def jax_tokens(tree):
    """JAX's single-device engine's tokens for every prompt, by prompt."""
    prompts = PLAIN + [X, A_, B_]
    eng = JEngine(JLoad(model_config=JConfig(**CFG), quant_type=QUANT, torch_dtype="float32"),
                  tree[0], None, rt=TpuRuntimeConfig(use_pallas=False), **ENGINE)
    out = eng.run(prompts, **SUBMIT)
    return {tuple(p): o for p, o in zip(prompts, out)}


@pytest.fixture(scope="module")
def ranks_12(tree):
    return run_spmd(W.engine_cases, 2, "gloo", SPAWN_TIMEOUT,
                    args=(tree[1], CFG, QUANT, [(1, 2, CASES_12)]))


@pytest.fixture(scope="module")
def ranks_4(tree):
    """The four-rank meshes, (1, 4) then (2, 2), in one spawn."""
    return run_spmd(W.engine_cases, 4, "gloo", SPAWN_TIMEOUT,
                    args=(tree[1], CFG, QUANT, [(1, 4, CASES_14), (2, 2, CASES_22)]))


def _check(ranks, name, cases, jax_tokens):
    want = [jax_tokens[tuple(p)] for batch in cases[name][2] for p in batch]
    for r in ranks:
        got = r[name]
        assert got["tokens"] == want, (name, got["tokens"], want)
        assert got["pages_in_use"] in (None, 0)
        assert got["local"]
    return ranks[0][name]


@pytest.mark.parametrize("name", list(CASES_12))
def test_distributed_engine_token_exact(ranks_12, jax_tokens, name):
    res = _check(ranks_12, name, CASES_12, jax_tokens)
    if "prefix" in name:
        assert res["prefix_hits"] == 1


@pytest.mark.parametrize("name", list(CASES_14))
def test_distributed_engine_token_exact_at_tp_4(ranks_4, jax_tokens, name):
    """The (1, 4) mesh a four-card NCCL run takes (chip_smoke.py --nccl 4):
    heads split below a KV group (2 of a group's 4 on a rank), T-shards and
    page phases of 4."""
    res = _check(ranks_4, name, CASES_14, jax_tokens)
    if "prefix" in name:
        assert res["prefix_hits"] == 1


def test_slot_groups_balance_over_the_data_axis(ranks_4, jax_tokens):
    """Two requests on an idle (2, 2) mesh land in different data groups
    (each batch of two is drained before the next)."""
    _check(ranks_4, "dense balanced", CASES_22, jax_tokens)
    assert ranks_4[0]["dense balanced"]["groups"] == [0, 1]


def test_prefix_affinity_routes_to_the_group_holding_the_prefix(ranks_4, jax_tokens):
    """x and a run on groups 0 and 1; after both finish, b (sharing a's
    two-page head) goes to group 1, whose registry holds the head, though
    both groups are idle (the least-loaded rule alone picks group 0)."""
    res = _check(ranks_4, "paged shard_model_pages prefix affinity", CASES_22, jax_tokens)
    assert res["groups"] == [1] and res["prefix_hits"] == 1


def test_one_rank_mesh_engines_refuse_what_they_do_not_carry(tree, jax_tokens):
    """A (1, 1) mesh in this process (no process group): the distributed
    engines refuse lookahead and in-loop speculation, and otherwise serve
    JAX's tokens."""
    from chatglm_q_tpu_torch import ChatGLM2Config, GLMLoadConfig
    from chatglm_q_tpu_torch.convert import params_from_numpy
    from chatglm_q_tpu_torch.parallel import sharding as SH
    from chatglm_q_tpu_torch.serving import (DistributedPagedServingEngine,
                                             DistributedServingEngine)

    mesh = SH.make_mesh(1, 1)
    cfg = ChatGLM2Config(**CFG)
    load = GLMLoadConfig(model_config=cfg, quant_type=QUANT, torch_dtype="float32")
    params = SH.shard_params(params_from_numpy(tree[1], "cpu"), mesh, cfg, QUANT)
    with pytest.raises(ValueError, match="lookahead"):
        DistributedServingEngine(load, params, mesh=mesh, lookahead=True, device="cpu", **ENGINE)
    with pytest.raises(NotImplementedError, match="speculation"):
        DistributedPagedServingEngine(load, params, mesh=mesh, speculative_k=4, device="cpu",
                                      **ENGINE, **PAGED)
    eng = DistributedPagedServingEngine(load, params, mesh=mesh, shard_model_pages=True,
                                        device="cpu", **ENGINE, **PAGED)
    assert eng._n_phase == 1 and not eng.rt.paged_shard_model  # one model rank: one phase
    assert eng.run(PLAIN, **SUBMIT) == [jax_tokens[tuple(p)] for p in PLAIN]
    assert eng.pages_in_use == 0


def test_mesh_refuses_a_world_it_does_not_match():
    from chatglm_q_tpu_torch.parallel import sharding as SH

    with pytest.raises(ValueError, match="ranks"):
        SH.make_mesh(1, 2)

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
model-sharded engines again.  In-loop speculation on both pool layouts,
greedy (tests/test_dist_paged.py:175) and with sampled rows (token-equal
ranks, reproducible from a seed, also over two data groups); ``lookahead``
on the dense engine; the API server on rank 0 of a (1, 2) mesh with
``follow`` on rank 1 (chat, stream, stop, n = 2, a client disconnecting,
and a worker that fails in a step and still releases rank 1).
JAX's ``ServingEngine`` (its jnp path) gives the reference tokens.  Every
run ends with no page in use.
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
# tests/test_dist_paged.py:175's low-entropy prompts (n-gram drafts fire)
SPEC_PROMPTS = [np.random.RandomState(15).randint(3, 40, size=n).tolist() for n in (18, 7, 12, 9)]
SPEC = dict(ENGINE, num_pages=48, page_size=8, speculative_k=4, speculative_ngram=2)
SPEC_SUBMIT = dict(max_new_tokens=16, temperature=0.0)
# rows 0 and 2 greedy, rows 1 and 3 sampled
MIXED = [SPEC_SUBMIT, dict(max_new_tokens=16, temperature=1.0, top_p=0.95), SPEC_SUBMIT,
         dict(max_new_tokens=16, temperature=0.7, top_k=8)]
# staggered budgets over six requests on four slots: finishes inside an unread
# chunk, slot reuse and queued admissions under lookahead
LOOK_PROMPTS = PLAIN + [X, A_]
LOOK_SUBMIT = [dict(max_new_tokens=b, temperature=0.0) for b in (3, 9, 6, 11, 4, 7)]
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
SPEC_CASES_12 = {
    "paged shard_model_pages speculative": (
        "paged", dict(SPEC, shard_model_pages=True), [SPEC_PROMPTS], SPEC_SUBMIT),
    "paged data-sharded speculative": ("paged", SPEC, [SPEC_PROMPTS], SPEC_SUBMIT),
    "paged shard_model_pages speculative mixed": (
        "paged", dict(SPEC, shard_model_pages=True, speculative_sampled=True, seed=7),
        [SPEC_PROMPTS], MIXED),
    "paged data-sharded speculative mixed": (
        "paged", dict(SPEC, speculative_sampled=True, seed=7), [SPEC_PROMPTS], MIXED),
}
# the same seed again: sampled rows must reproduce
SPEC_CASES_12["paged shard_model_pages speculative mixed again"] = \
    SPEC_CASES_12["paged shard_model_pages speculative mixed"]
LOOK_CASES_12 = {
    "dense lookahead chunked": ("dense", dict(ENGINE, lookahead=True, prefill_chunk_size=8),
                                [LOOK_PROMPTS], LOOK_SUBMIT),
    "dense kv_shard_t lookahead": ("dense", dict(ENGINE, lookahead=True,
                                                 rt=dict(kv_shard_t=True)),
                                   [LOOK_PROMPTS], LOOK_SUBMIT),
}
# the API server on rank 0 over the model-sharded paged engine: a user
# message and the disconnecting client's budget; 12 tokens an answer
SERVER_CASE = {"server": ("server", dict(ENGINE, **PAGED, shard_model_pages=True,
                                         decode_chunk=1), ["hello", 40], dict(max_tokens=12))}
CASES_14 = {  # a model axis of 4: each rank 2 of 8 heads, the T-shards and page phases of 4
    "dense kv_shard_t tp=4": ("dense", dict(ENGINE, rt=dict(kv_shard_t=True)), [PLAIN], SUBMIT),
    "paged shard_model_pages tp=4 chunked prefix": (
        "paged", dict(ENGINE, **PAGED, shard_model_pages=True, prefill_chunk_size=8,
                      prefix_cache=True), [PLAIN[:2], [A_], [B_]], SUBMIT),
}
CASES_22 = {
    "dense balanced": ("dense", dict(ENGINE, prefill_chunk_size=8), [PLAIN[:2], PLAIN[2:]],
                       SUBMIT),
    # two data groups: their drafts, accepts and next tokens gathered, their
    # generators drawing alike
    "paged shard_model_pages speculative mixed (2, 2)": (
        "paged", dict(SPEC, shard_model_pages=True, speculative_sampled=True, seed=7),
        [SPEC_PROMPTS], MIXED),
    "dense lookahead (2, 2)": ("dense", dict(ENGINE, lookahead=True, prefill_chunk_size=8),
                               [LOOK_PROMPTS], LOOK_SUBMIT),
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
def jax_more(tree):
    """JAX's single-device engine (no speculation, no lookahead) on the
    speculation and lookahead prompts: {(prompt, budget): tokens}."""
    work = ([(p, SPEC_SUBMIT) for p in SPEC_PROMPTS]
            + list(zip(LOOK_PROMPTS, LOOK_SUBMIT)))
    eng = JEngine(JLoad(model_config=JConfig(**CFG), quant_type=QUANT, torch_dtype="float32"),
                  tree[0], None, rt=TpuRuntimeConfig(use_pallas=False), **ENGINE)
    ids = [eng.submit(p, **kw) for p, kw in work]
    while eng.has_work:
        eng.step()
    by_id = {r.req_id: r.generated for r in eng.finished}
    return {(tuple(p), kw["max_new_tokens"]): by_id[i] for (p, kw), i in zip(work, ids)}


@pytest.fixture(scope="module")
def ranks_12(tree):
    return run_spmd(W.engine_cases, 2, "gloo", SPAWN_TIMEOUT,
                    args=(tree[1], CFG, QUANT,
                          [(1, 2, {**CASES_12, **SPEC_CASES_12, **LOOK_CASES_12,
                                   **SERVER_CASE})]))


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


def _want(jax_more, prompts, kws):
    return [jax_more[(tuple(p), kw["max_new_tokens"])] for p, kw in zip(prompts, kws)]


@pytest.mark.parametrize("name", [n for n in SPEC_CASES_12 if "mixed" not in n])
def test_distributed_speculation_token_exact(ranks_12, jax_more, name):
    """In-loop speculation on a (1, 2) mesh, on the model-sharded pool (its
    unaligned verify writes on each rank's phase) and the data-sharded one:
    JAX's tokens without speculation (tests/test_dist_paged.py:175), drafts
    accepted, every page back."""
    want = _want(jax_more, SPEC_PROMPTS, [SPEC_SUBMIT] * 4)
    for r in ranks_12:
        got = r[name]
        assert got["tokens"] == want, (name, got["tokens"], want)
        assert got["pages_in_use"] == 0 and got["local"]
        assert got["spec_accepted"] > 0 and got["spec_steps"] > 0


@pytest.mark.parametrize("mesh,name", [
    ("12", "paged shard_model_pages speculative mixed"),
    ("12", "paged data-sharded speculative mixed"),
    ("22", "paged shard_model_pages speculative mixed (2, 2)")])
def test_distributed_sampled_speculation(ranks_12, ranks_4, jax_more, mesh, name):
    """Sampled rows in the speculation program on a mesh: the greedy rows
    give JAX's tokens, the ranks are token-equal (every rank of a data group
    draws the same samples), and on (1, 2) a second engine on the same seed
    draws the same tokens."""
    ranks = ranks_12 if mesh == "12" else ranks_4
    want = _want(jax_more, SPEC_PROMPTS, MIXED)
    r0 = ranks[0][name]
    for r in ranks:
        got = r[name]
        assert got["tokens"] == r0["tokens"]
        assert [got["tokens"][i] for i in (0, 2)] == [want[i] for i in (0, 2)]
        assert got["pages_in_use"] == 0 and got["local"] and got["spec_steps"] > 0
    for i in (1, 3):
        assert 0 < len(r0["tokens"][i]) <= 16
        assert all(0 <= t < CFG["vocab_size"] for t in r0["tokens"][i])
    if name == "paged shard_model_pages speculative mixed":
        assert r0["tokens"] == ranks_12[0][name + " again"]["tokens"]


@pytest.mark.parametrize("mesh,name", [("12", "dense lookahead chunked"),
                                       ("12", "dense kv_shard_t lookahead"),
                                       ("22", "dense lookahead (2, 2)")])
def test_distributed_lookahead_equals_jax_without_it(ranks_12, ranks_4, jax_more, mesh, name):
    """``lookahead`` on the dense distributed engine (each data rank chains
    its rows, the gather deferred a step): JAX's tokens without lookahead
    through staggered finishes, slot reuse and queued admissions
    (tests/test_lookahead.py:56)."""
    ranks = ranks_12 if mesh == "12" else ranks_4
    want = _want(jax_more, LOOK_PROMPTS, LOOK_SUBMIT)
    for r in ranks:
        assert r[name]["tokens"] == want, (name, r[name]["tokens"], want)


def test_api_server_over_two_ranks(ranks_12):
    """``GLMAPIServer`` on rank 0 of a (1, 2) mesh, ``follow`` on rank 1:
    the chat, its stream and n = 2 answer with the engine's own greedy
    text, a stop string truncates it (both forms), and every submission and
    cancel reaches rank 1 in order: the stop strings' cancels and the
    disconnected client's, which retires its request while it decodes.
    The ranks end with equal stats."""
    r0, r1 = (r["server"] for r in ranks_12)
    want = r0["want"]
    assert want == r1["want"] and len(want) >= 4
    assert r0["chat"]["choices"][0]["message"]["content"] == want
    assert "".join(r0["stream"][0]) == want and r0["stream"][1] == "length"
    stop = r0["stop_string"]
    cut = want[: want.find(stop)]
    assert r0["stop"]["choices"][0]["message"]["content"] == cut
    assert r0["stop"]["choices"][0]["finish_reason"] == "stop"
    assert "".join(r0["stop_stream"][0]) == cut and r0["stop_stream"][1] == "stop"
    assert [c["message"]["content"] for c in r0["n2"]["choices"]] == [want, want]
    submits = [res for kind, _, res in r1["events"] if kind == "submit"]
    cancels = {rid: live for kind, rid, live in r1["events"] if kind == "cancel"}
    assert len(submits) == 7  # chat, stream, two stops, n = 2, the disconnect
    assert submits[2] in cancels and submits[3] in cancels  # the stop strings
    assert cancels.get(submits[-1]) is True  # cancelled while decoding
    assert r0["stats"] == r1["stats"]


def test_a_failing_server_worker_releases_the_followers(ranks_12):
    """Rank 0's worker raises in a step (after the ranks stepped
    together): its stream ends with finish reason "error" and rank 1's
    ``follow`` gets the stop and returns, having applied the one
    submission, instead of waiting on the next turn's broadcast."""
    r0, r1 = (r["server"]["failed"] for r in ranks_12)
    assert r0 == {"reason": "error", "alive": False}
    assert r1 == {"events": ["submit"]}


def test_one_rank_mesh_engines_refuse_what_they_do_not_carry(tree, jax_tokens, jax_more):
    """A (1, 1) mesh in this process (no process group): the distributed
    engines serve JAX's tokens with ``lookahead`` (dense) and in-loop
    speculation (paged), and a one-phase pool."""
    from chatglm_q_tpu_torch import ChatGLM2Config, GLMLoadConfig, TorchRuntimeConfig
    from chatglm_q_tpu_torch.convert import params_from_numpy
    from chatglm_q_tpu_torch.parallel import sharding as SH
    from chatglm_q_tpu_torch.serving import (DistributedPagedServingEngine,
                                             DistributedServingEngine)

    mesh = SH.make_mesh(1, 1)
    cfg = ChatGLM2Config(**CFG)
    load = GLMLoadConfig(model_config=cfg, quant_type=QUANT, torch_dtype="float32")
    params = SH.shard_params(params_from_numpy(tree[1], "cpu"), mesh, cfg, QUANT)
    rt = TorchRuntimeConfig(use_kernels=True, use_flash_attention=True)
    eng = DistributedServingEngine(load, params, mesh=mesh, lookahead=True, device="cpu", rt=rt,
                                   **ENGINE)
    assert eng.run(PLAIN, **SUBMIT) == [jax_tokens[tuple(p)] for p in PLAIN]
    eng = DistributedPagedServingEngine(load, params, mesh=mesh, device="cpu", rt=rt, **SPEC)
    assert eng.run(SPEC_PROMPTS, **SPEC_SUBMIT) == _want(jax_more, SPEC_PROMPTS, [SPEC_SUBMIT] * 4)
    assert eng.stats["spec_accepted"] > 0 and eng.pages_in_use == 0
    eng = DistributedPagedServingEngine(load, params, mesh=mesh, shard_model_pages=True,
                                        device="cpu", **ENGINE, **PAGED)
    assert eng._n_phase == 1 and not eng.rt.paged_shard_model  # one model rank: one phase
    assert eng.run(PLAIN, **SUBMIT) == [jax_tokens[tuple(p)] for p in PLAIN]
    assert eng.pages_in_use == 0


def test_mesh_refuses_a_world_it_does_not_match():
    from chatglm_q_tpu_torch.parallel import sharding as SH

    with pytest.raises(ValueError, match="ranks"):
        SH.make_mesh(1, 2)

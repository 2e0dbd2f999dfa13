"""The port's ``PagedServingEngine`` against the JAX package's, on the CPU,
on a 2-layer tiny ChatGLM2 (tests/test_paged.py's config) fed the same tree.

Greedy tokens are equal to the JAX paged engine's on the same prompts in
each mode (whole-prompt admission; chunked admission with the prefix cache;
in-loop speculation), through both of the port's attention paths, and at
the wall (decode and speculative decode past max_seq_len, ported from
tests/test_paged.py).  The JAX engines run their jnp path, as the JAX paged
tests do, and each is built once per module.  The rest is host logic,
mirroring tests/test_paged.py: backpressure and page recycling, the prefix
cache's hits, sharing, eviction and release, ``submit`` refusing a request
that can never fit, no pointless prefix eviction, and mixed sampling falling
back from speculation."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from chatglm_q_tpu.config import ChatGLM2Config as JConfig, GLMLoadConfig as JLoad  # noqa: E402
from chatglm_q_tpu.config import TpuRuntimeConfig  # noqa: E402
from chatglm_q_tpu.models import chatglm2 as JM  # noqa: E402
from chatglm_q_tpu.serving.engine import ServingEngine as JEngine  # noqa: E402
from chatglm_q_tpu.serving.paged_engine import PagedServingEngine as JPaged  # noqa: E402
from chatglm_q_tpu_torch import ChatGLM2Config, GLMLoadConfig, TorchRuntimeConfig  # noqa: E402
from chatglm_q_tpu_torch.convert import params_from_numpy  # noqa: E402
from chatglm_q_tpu_torch.serving import PagedServingEngine, ServingEngine  # noqa: E402

TINY = dict(hidden_size=64, inner_hidden_size=64, head_hidden_size=16,
            num_multi_query_groups=2, num_attention_heads=4, num_layers=2,
            vocab_size=128, max_sequence_length=64)
JAX_RT = TpuRuntimeConfig(use_pallas=False, use_flash_attention=False)
PORT_RTS = {"masked": TorchRuntimeConfig(),
            "flash": TorchRuntimeConfig(use_kernels=True, use_flash_attention=True)}
ENGINE_KW = dict(max_batch=4, max_seq_len=64, decode_chunk=4)
PAGE = 8


def _workload():
    """Six requests over four slots; four share a 16-token (two-page) head,
    and the last two of those are admitted after the first has prefilled,
    so chunked admission with the prefix cache gets hits; two repeat a span,
    so speculation drafts."""
    rng = np.random.default_rng(11)
    head = rng.integers(3, 120, size=16).tolist()
    span = rng.integers(3, 120, size=5).tolist()
    shared = [head + rng.integers(3, 120, size=n).tolist() for n in (5, 3, 9, 12)]
    prompts = [shared[0], span * 4, [7, 9] + span * 3] + shared[1:]
    return list(zip(prompts, (6, 10, 7, 9, 5, 12)))


WORK = _workload()
MODES = {"whole": dict(num_pages=24),
         "chunked+prefix": dict(num_pages=24, prefill_chunk_size=PAGE, prefix_cache=True),
         "speculative": dict(num_pages=40, speculative_k=4, speculative_ngram=2)}


@pytest.fixture(scope="module")
def parts():
    jp = JM.init_params(jax.random.PRNGKey(0), JConfig(**TINY), "none", jnp.float32)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return (JLoad(model_config=JConfig(**TINY), torch_dtype="float32"), jp,
            GLMLoadConfig(model_config=ChatGLM2Config(**TINY), torch_dtype="float32"), tp)


def drain(engine, work=WORK, **kw):
    ids = [engine.submit(p, max_new_tokens=b, **{"temperature": 0.0, **kw}) for p, b in work]
    steps = 0
    while engine.has_work:
        engine.step()
        steps += 1
        assert steps < 300, "engine did not drain"
    by_id = {r.req_id: r.generated for r in engine.finished}
    return [by_id[i] for i in ids]


@pytest.fixture(scope="module")
def jax_runs(parts):
    """The JAX paged engine's tokens and stats in each mode, built once."""
    jl, jp = parts[:2]
    out = {}
    for mode, kw in MODES.items():
        eng = JPaged(jl, jp, None, rt=JAX_RT, page_size=PAGE, **ENGINE_KW, **kw)
        out[mode] = (drain(eng), dict(eng.stats))
    return out


def paged(parts, rt="masked", **kw):
    tl, tp = parts[2:]
    kw = {**ENGINE_KW, "page_size": PAGE, **kw}
    return PagedServingEngine(tl, tp, None, rt=PORT_RTS[rt], device="cpu", **kw)


@pytest.mark.parametrize("rt", list(PORT_RTS))
@pytest.mark.parametrize("mode", list(MODES))
def test_greedy_tokens_equal_jax(parts, jax_runs, mode, rt):
    eng = paged(parts, rt, **MODES[mode])
    got = drain(eng)
    want, jstats = jax_runs[mode]
    assert got == want, (got, want)
    for key in ("prefix_hits", "prefix_tokens_reused", "spec_accepted", "spec_steps"):
        assert eng.stats[key] == jstats[key], key
    if mode == "chunked+prefix":
        assert eng.stats["prefix_hits"] > 0
    if mode == "speculative":
        assert eng.stats["spec_accepted"] > 0
    assert eng.pages_in_use == 0
    eng.clear_prefix_cache()
    assert sorted(eng._free_pages) == list(range(1, MODES[mode]["num_pages"]))


WALL_PROMPT = [3, 17, 42, 99, 5, 8, 1, 9, 4, 11, 12, 13, 14, 15, 16, 17, 18]
WALL_SPEC_PROMPT = [5, 6, 7, 5, 6, 7, 5, 6, 7, 5, 6, 7, 5, 6]


@pytest.fixture(scope="module")
def jax_wall(parts):
    jl, jp = parts[:2]
    kw = dict(max_batch=1, max_seq_len=32, rt=JAX_RT)
    return {"dense": drain(JEngine(jl, jp, None, decode_chunk=8, **kw), [(WALL_PROMPT, 30)]),
            "spec": drain(JPaged(jl, jp, None, decode_chunk=4, num_pages=4, page_size=16,
                                 speculative_k=4, **kw), [(WALL_SPEC_PROMPT, 30)])}


@pytest.mark.parametrize("rt", list(PORT_RTS))
def test_decode_to_the_wall_matches_jax(parts, jax_wall, rt):
    """In-chunk over-generation past max_seq_len: the dense and the paged
    engine clamp their writes and lengths at the last slot and emit the JAX
    dense engine's tokens."""
    tl, tp = parts[2:]
    kw = dict(max_batch=1, max_seq_len=32, decode_chunk=8, rt=PORT_RTS[rt], device="cpu")
    dense = drain(ServingEngine(tl, tp, None, **kw), [(WALL_PROMPT, 30)])
    pg = drain(PagedServingEngine(tl, tp, None, num_pages=4, page_size=16, **kw),
               [(WALL_PROMPT, 30)])
    assert dense == pg == jax_wall["dense"]
    assert len(dense[0]) <= 30


@pytest.mark.parametrize("rt", list(PORT_RTS))
def test_spec_decode_to_the_wall(parts, jax_wall, rt):
    """Speculative chunks near the wall advance up to k + 1 per step:
    lengths and page writes clamp at capacity; tokens equal plain decoding
    and the JAX speculative engine."""
    tl, tp = parts[2:]
    kw = dict(max_batch=1, max_seq_len=32, decode_chunk=4, num_pages=4, page_size=16,
              rt=PORT_RTS[rt], device="cpu")
    plain = drain(PagedServingEngine(tl, tp, None, **kw), [(WALL_SPEC_PROMPT, 30)])
    spec = drain(PagedServingEngine(tl, tp, None, speculative_k=4, **kw),
                 [(WALL_SPEC_PROMPT, 30)])
    assert spec == plain == jax_wall["spec"]


def test_backpressure_and_page_recycling(parts, jax_runs):
    """Six usable pages cannot hold every request at once: admissions wait
    at the head of the queue, recycled pages serve later requests, and
    every output is still exact."""
    eng = paged(parts, num_pages=7, page_size=16)
    ids = [eng.submit(p, max_new_tokens=b, temperature=0.0) for p, b in WORK]
    eng.step()
    # the first two requests take 2 + 3 of the 6 usable pages: the third
    # (2 pages) waits at the head of the queue while slots are free
    assert eng.queue and any(s.request is None for s in eng.slots)
    while eng.has_work:
        eng.step()
    by_id = {r.req_id: r.generated for r in eng.finished}
    assert [by_id[i] for i in ids] == jax_runs["whole"][0]
    assert eng.pages_in_use == 0
    assert sorted(eng._free_pages) == list(range(1, 7))


def test_prefix_cache_hits_share_and_release(parts, jax_runs):
    """Sequential prompts sharing the two-page head: each later one reuses
    exactly those pages; clearing the cache frees every usable page."""
    eng = paged(parts, num_pages=24, prefill_chunk_size=PAGE, prefix_cache=True)
    shared = [WORK[i] for i in (0, 3, 4, 5)]
    got = [drain(eng, [w])[0] for w in shared]
    assert got == [jax_runs["whole"][0][i] for i in (0, 3, 4, 5)]
    assert eng.stats["prefix_hits"] == 3
    assert eng.stats["prefix_tokens_reused"] == 3 * 16
    assert eng.pages_in_use == 0 and eng.pages_cached > 0
    eng.clear_prefix_cache()
    assert eng.pages_cached == 0
    assert sorted(eng._free_pages) == list(range(1, 24))


def test_prefix_cache_eviction_under_pressure(parts, jax_runs):
    """A pool too small to keep the cached prefixes evicts them (LRU) to
    admit new work: no deadlock, exact outputs."""
    eng = paged(parts, num_pages=9, prefill_chunk_size=PAGE, prefix_cache=True, max_batch=2)
    assert drain(eng) == jax_runs["whole"][0]
    assert eng.pages_in_use == 0


def test_cancel_at_each_stage_releases_pages(parts):
    """Queued, mid-prefill and decoding requests cancel cleanly: their pages
    return to the free list (the prefix cache keeps its own references) and
    their table rows go back to the garbage page."""
    eng = paged(parts, num_pages=24, prefill_chunk_size=PAGE, prefix_cache=True, max_batch=2)
    for p, _ in WORK[:4]:
        eng.submit(p, max_new_tokens=32, temperature=0.0)
    for _ in range(10):  # until one slot decodes while the other prefills
        eng.step()
        decoding = [s.request.req_id for s in eng.slots if s.decoding]
        pending = [s.request.req_id for s in eng.slots if s.pending_ids is not None]
        if decoding and pending:
            break
    else:
        pytest.fail("no step with a decoding and a mid-prefill slot")
    queued = [r.req_id for r in eng.queue]
    assert queued
    assert all(eng.cancel(r) for r in queued + pending + decoding)
    assert not eng.cancel(decoding[0])  # no longer live
    assert not eng.has_work and eng.pages_in_use == 0
    eng.clear_prefix_cache()
    assert sorted(eng._free_pages) == list(range(1, 24))
    assert torch.equal(eng.cache.page_table, torch.zeros_like(eng.cache.page_table))
    r = eng.submit(WORK[0][0], max_new_tokens=4, temperature=0.0)
    while eng.has_work:
        eng.step()
    assert any(q.req_id == r and q.done for q in eng.finished)


def test_submit_rejects_impossible_request(parts):
    eng = paged(parts, num_pages=2, page_size=16, max_batch=2)
    # one usable page = 16 tokens; this request needs 64
    with pytest.raises(ValueError, match="KV pages"):
        eng.submit(list(range(40)), max_new_tokens=24)
    assert not eng.has_work


def test_alloc_no_pointless_prefix_eviction(parts):
    """When every cached page is also held by a slot, eviction frees
    nothing: _alloc fails without wiping the prefix registry."""
    eng = paged(parts, num_pages=4, page_size=16, max_batch=2, prefix_cache=True,
                prefill_chunk_size=16)
    eng.submit(list(range(3, 23)), max_new_tokens=20, temperature=0.0)  # holds all 3 pages
    while any(s.pending_ids is not None for s in eng.slots) or eng.queue:
        eng.step()
    assert eng.pages_cached > 0 and eng._slot_pages
    before = dict(eng._prefix_lru)
    assert eng._alloc(3) is None
    assert dict(eng._prefix_lru) == before


def test_mixed_sampling_falls_back_from_speculation(parts, jax_runs):
    """A sampling request among greedy ones: chunks that hold it decode
    plainly, the greedy requests stay exact, and speculation resumes once
    only greedy requests are left."""
    eng = paged(parts, **MODES["speculative"])
    hot = eng.submit(WORK[4][0], max_new_tokens=3, temperature=1.2, top_p=0.95)
    ids = [eng.submit(p, max_new_tokens=b, temperature=0.0) for p, b in WORK[:4]]
    eng.step()
    assert eng.stats["spec_steps"] == 0  # the first chunk holds the sampling request
    while eng.has_work:
        eng.step()
    by_id = {r.req_id: r.generated for r in eng.finished}
    assert [by_id[i] for i in ids] == jax_runs["speculative"][0][:4]
    assert len(by_id[hot]) <= 3


def test_sampled_runs_reproducible_from_seed(parts):
    def run():
        return drain(paged(parts, seed=3, **MODES["chunked+prefix"]), temperature=0.9,
                     top_p=0.9)

    assert run() == run()


def test_what_the_paged_engine_refuses(parts):
    with pytest.raises(ValueError, match="lookahead"):
        paged(parts, num_pages=8, lookahead=True)
    with pytest.raises(ValueError, match="page-aligned"):
        paged(parts, num_pages=8, prefill_chunk_size=12)
    with pytest.raises(ValueError, match="prefill_chunk_size"):
        paged(parts, num_pages=8, prefix_cache=True)

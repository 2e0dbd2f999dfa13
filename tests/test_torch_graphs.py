"""The port's step programs (``chatglm_q_tpu_torch.utils.graphs``) on the CPU.

On the card each decode program is a captured CUDA graph; on the CPU the same
body runs eagerly through the same static buffers, which is what these tests
hold on a 2-layer narrow f32 tree that the JAX package's ``init_params``
makes: ``multi_step_decode``, ``decode_paged_program`` at compact batches 1,
2 and 4, and in-loop speculation give the tokens of the eager loop they
replace (a Python loop of ``decode_step`` / ``decode_step_paged`` / the
verify step, written out here) and of the JAX package's jitted programs; the
engines' chunks (dense with and without ``lookahead``, paged, speculative)
give the JAX engines' greedy tokens; top-p draws from a program follow the
plain sampler's distribution.  Then the programs' own logic: keys and
reuse, the refusals, and the capture protocol (warm-up, capture, replay,
launch counts, a failed capture) with a stand-in for ``torch.cuda``'s graph."""
import contextlib

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
from chatglm_q_tpu_torch import ops  # noqa: E402
from chatglm_q_tpu_torch.convert import params_from_numpy  # noqa: E402
from chatglm_q_tpu_torch.models import chatglm2 as TM  # noqa: E402
from chatglm_q_tpu_torch.models import paged_kv as PK  # noqa: E402
from chatglm_q_tpu_torch.models import spec_decode as SD  # noqa: E402
from chatglm_q_tpu_torch.ops import quant_matmul as QM  # noqa: E402
from chatglm_q_tpu_torch.ops.sampling import (Sampling, greedy_sampling,  # noqa: E402
                                              sample_rows, top_p_filter)
from chatglm_q_tpu_torch.serving import GLMDecoder, PagedServingEngine, ServingEngine  # noqa: E402
from chatglm_q_tpu_torch.serving.chat import process_response  # noqa: E402
from chatglm_q_tpu_torch.utils import graphs as G  # noqa: E402

TINY = dict(hidden_size=64, inner_hidden_size=64, head_hidden_size=16,
            num_multi_query_groups=2, num_attention_heads=4, num_layers=2,
            vocab_size=128, max_sequence_length=64)
JCFG, TCFG = JConfig(**TINY), ChatGLM2Config(**TINY)
JAX_RT = TpuRuntimeConfig(use_pallas=False, use_flash_attention=False)
PORT_RTS = {"masked": TorchRuntimeConfig(),
            "flash": TorchRuntimeConfig(use_kernels=True, use_flash_attention=True)}
ENGINE_KW = dict(max_batch=4, max_seq_len=64, decode_chunk=4)
IDS = np.array([[5, 9, 100, 30, 77, 3, 25], [7, 8, 9, 0, 0, 0, 0]], np.int32)
LENGTHS = np.array([7, 3], np.int32)
F32 = torch.float32

_TREES = {}


def _trees(quant="none"):
    if quant not in _TREES:
        jp = JM.init_params(jax.random.PRNGKey(3), JCFG, quant, jnp.float32)
        _TREES[quant] = (jp, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu"))
    return _TREES[quant]


def _prefilled(tp, quant, rt, T=32):
    cache = TM.init_kv_cache(TCFG, 2, T, F32, device="cpu")
    logits, cache = TM.prefill(tp, TCFG, torch.from_numpy(IDS), torch.from_numpy(LENGTHS), cache,
                               quant, F32, rt)
    return greedy_sampling(logits), cache


def eager_multi_step(tp, first, cache, n, quant, rt):
    """The loop ``multi_step_decode`` replaces: decode_step, argmax, again."""
    tok, toks = first, []
    for _ in range(n):
        logits, cache = TM.decode_step(tp, TCFG, tok, cache, quant, F32, rt)
        tok = greedy_sampling(logits)
        toks.append(tok)
    return torch.stack(toks, dim=1), cache


@pytest.mark.parametrize("rt", list(PORT_RTS))
@pytest.mark.parametrize("quant", ["none", "int4g32"])
def test_multi_step_decode_equals_the_eager_loop_and_jax(quant, rt):
    jp, tp = _trees(quant)
    rt = PORT_RTS[rt]
    jc = JM.init_kv_cache(JCFG, 2, 32, jnp.float32)
    logits, jc = JM.prefill(jp, JCFG, jnp.asarray(IDS), jnp.asarray(LENGTHS), jc, quant,
                            jnp.float32, JAX_RT)
    want, _ = JM.multi_step_decode(jp, JCFG, jnp.argmax(logits, -1).astype(jnp.int32), jc, 12,
                                   None, quant, jnp.float32, JAX_RT)
    first, cache = _prefilled(tp, quant, rt)
    ref, ref_cache = eager_multi_step(tp, first, TM.KVCache(cache.k.clone(), cache.v.clone(),
                                                            cache.lengths), 12, quant, rt)
    got, out = TM.multi_step_decode(tp, TCFG, first, cache, 12, None, quant, F32, rt)
    assert got.dtype == torch.int32 and got.shape == (2, 12) and got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert torch.equal(got, ref)
    assert torch.equal(out.lengths, ref_cache.lengths)
    assert torch.equal(out.k, ref_cache.k) and torch.equal(out.v, ref_cache.v)
    # the caller's lengths stay as they were: the program advanced its own
    np.testing.assert_array_equal(cache.lengths.numpy(), LENGTHS)


def _pool_case(PB, seed=0):
    """A pool of 4-row pages, PB rows of ragged lengths on scattered pages,
    the padding rows (past 2) on the garbage page at length 0."""
    _, tp = _trees()
    P, MP = 4, 8
    pool = PK.init_paged_kv_cache(TCFG, PB, 1 + 4 * MP, MP * P, P, F32, device="cpu")
    rng = np.random.default_rng(seed)
    pages = rng.permutation(np.arange(1, 1 + 4 * MP))[: PB * MP].reshape(PB, MP)
    lengths = np.array([9, 3, 0, 0][:PB], np.int32)
    pages[2:] = 0
    pool.page_table.copy_(torch.from_numpy(pages.astype(np.int32)))
    pool.k_pool.copy_(torch.randn(pool.k_pool.shape, generator=torch.Generator().manual_seed(1)))
    pool.v_pool.copy_(torch.randn(pool.v_pool.shape, generator=torch.Generator().manual_seed(2)))
    return tp, pool.replace(lengths=torch.from_numpy(lengths)), torch.from_numpy(
        rng.integers(3, 120, size=PB).astype(np.int32))


@pytest.mark.parametrize("PB", [1, 2, 4])
def test_decode_paged_program_equals_the_eager_loop(PB):
    """The paged engine's compact chunk at each power-of-two batch: n steps
    of the program equal n ``decode_step_paged`` + sample steps, tokens,
    lengths and pool."""
    tp, pool, tok = _pool_case(PB)
    rt = PORT_RTS["flash"]
    ref = pool.replace(k_pool=pool.k_pool.clone(), v_pool=pool.v_pool.clone())
    t, want = tok, []
    for _ in range(5):
        logits, ref = PK.decode_step_paged(tp, TCFG, t, ref, "none", F32, rt)
        t = greedy_sampling(logits)
        want.append(t)
    prog = PK.decode_paged_program(tp, TCFG, pool, "none", F32, rt)
    prog.load(ids=tok, lengths=pool.lengths, page_table=pool.page_table)
    got = prog.run(5, tp, pool.k_pool, pool.v_pool, collect=("ids",))["ids"]
    assert torch.equal(got, torch.stack(want))
    assert torch.equal(prog.inputs["lengths"], ref.lengths)
    assert torch.equal(pool.k_pool, ref.k_pool) and torch.equal(pool.v_pool, ref.v_pool)


def eager_speculation(tp, first_tok, cache, tokbuf, n, k, ngram, rt):
    """The loop ``speculative_decode_paged`` replaces."""
    KT, tok = k + 1, first_tok
    full = torch.full((first_tok.shape[0],), KT, dtype=torch.int32)
    drafts, accepts, nexts = [], [], []
    for _ in range(n):
        l0 = cache.lengths
        SD._write_token_rows(tokbuf, tok[:, None], l0)
        draft = SD.find_drafts(tokbuf, l0 + 1, ngram, k)
        seq = torch.cat([tok[:, None], draft.clamp(min=0)], dim=1)
        SD._write_token_rows(tokbuf, seq[:, 1:], l0 + 1)
        logits, cache = PK.prefill_chunk_paged(tp, TCFG, seq, l0, full, cache, "none", F32, rt,
                                               return_all_logits=True, page_aligned=False)
        argm = logits.argmax(dim=-1).to(torch.int32)
        accept = (argm[:, :k] == draft).to(torch.int32).cumprod(dim=1).sum(dim=1)
        nxt = argm.gather(1, accept[:, None].long())[:, 0]
        cache = cache.replace(lengths=(l0 + 1 + accept).clamp(max=cache.max_length - 1)
                              .to(torch.int32))
        drafts.append(draft)
        accepts.append(accept)
        nexts.append(nxt)
        tok = nxt
    return torch.stack(drafts), torch.stack(accepts), torch.stack(nexts), cache, tokbuf


def test_speculation_program_equals_the_eager_loop():
    tp, pool, tok = _pool_case(2)
    rt = PORT_RTS["flash"]
    span = [11, 12, 13, 14]
    hist = torch.zeros((2, 32), dtype=torch.int32)
    hist[0, :9] = torch.tensor(span * 2 + [11])
    hist[1, :3] = torch.tensor([5, 6, 7])
    ref = pool.replace(k_pool=pool.k_pool.clone(), v_pool=pool.v_pool.clone())
    want = eager_speculation(tp, tok, ref, hist.clone(), 4, 3, 2, rt)
    got = SD.speculative_decode_paged(tp, TCFG, tok, pool, hist, 4, 3, 2, "none", F32, rt)
    for g, w in zip(got[:3], want[:3]):
        assert torch.equal(g, w)
    assert torch.equal(got[3].lengths, want[3].lengths)
    assert torch.equal(got[4], want[4]) and got[4] is hist  # the history, in place
    assert torch.equal(pool.k_pool, ref.k_pool)
    assert (got[1] > 0).any()  # the repeated span drafted and was accepted


def _work():
    rng = np.random.default_rng(17)
    lens, budgets = (3, 40, 2, 21, 9, 33), (6, 9, 3, 12, 5, 7)
    return [(rng.integers(3, 120, size=n).tolist(), b) for n, b in zip(lens, budgets)]


def drain(engine, work):
    ids = [engine.submit(p, max_new_tokens=b, temperature=0.0) for p, b in work]
    steps = 0
    while engine.has_work:
        engine.step()
        steps += 1
        assert steps < 300, "engine did not drain"
    by_id = {r.req_id: r.generated for r in engine.finished}
    return [by_id[i] for i in ids]


def _loads():
    return (JLoad(model_config=JCFG, torch_dtype="float32"),
            GLMLoadConfig(model_config=TCFG, torch_dtype="float32"))


def eager_decode_chunk(self, first_tok, active, free, sampling, n, top_k):
    """The loop ``ServingEngine._decode_chunk`` replaces."""
    orig = self.cache.lengths
    cache = TM.KVCache(self.cache.k, self.cache.v, torch.where(free, 0, orig))
    tok, toks = first_tok, []
    for _ in range(n):
        logits, cache = TM.decode_step(self.params, self.mc, tok, cache, self.config.quant_type,
                                       self.dtype, self.rt)
        tok = sample_rows(logits, *sampling, top_k, self._gen)
        toks.append(tok)
    self.cache = TM.KVCache(cache.k, cache.v, torch.where(active, cache.lengths, orig))
    return torch.stack(toks, dim=1)


@pytest.mark.parametrize("lookahead", [False, True])
def test_engine_chunk_equals_the_eager_loop_and_jax(lookahead, monkeypatch):
    jp, tp = _trees()
    jl, tl = _loads()
    work = _work()
    want = drain(JEngine(jl, jp, None, rt=JAX_RT, lookahead=lookahead, **ENGINE_KW), work)
    eng = ServingEngine(tl, tp, None, device="cpu", lookahead=lookahead, **ENGINE_KW)
    got = drain(eng, work)
    monkeypatch.setattr(ServingEngine, "_decode_chunk", eager_decode_chunk)
    eager = drain(ServingEngine(tl, tp, None, device="cpu", lookahead=lookahead, **ENGINE_KW),
                  work)
    assert got == want == eager
    reg = G.programs(tp)
    keys = [k for k in reg._programs if k[0] == "decode_step" and k[1] == G.tensor_key(eng.cache.k)]
    assert len(keys) == 1  # one program for every chunk of the run


def test_paged_engine_compact_batches_and_speculation_equal_jax():
    """Workloads that keep 1, 2 and 4 slots decoding: the compact chunk runs
    one program per power-of-two batch (1, 2, 4), and the greedy tokens are
    the JAX paged engine's; the same with in-loop speculation."""
    jp, tp = _trees()
    jl, tl = _loads()
    work = _work()
    span = [21, 22, 23, 24, 25]
    spec_work = [(span * 4, 10), ([7, 9] + span * 3, 8), (work[1][0], 6)]
    cases = [(work[:1], {}), (work[:2], {}), (work, {}),
             (spec_work, dict(speculative_k=3, speculative_ngram=2))]
    seen = {"decode_step_paged": set(), "spec_step": set()}
    for w, kw in cases:
        kw = dict(num_pages=40, page_size=8, **ENGINE_KW, **kw)
        want = drain(JPaged(jl, jp, None, rt=JAX_RT, **kw), w)
        eng = PagedServingEngine(tl, tp, None, device="cpu", **kw)
        assert drain(eng, w) == want
        for key in G.programs(tp)._programs:
            if key[0] in seen and key[1] == G.tensor_key(eng.cache.k_pool):
                seen[key[0]].add(key[3])  # the compact batch
        if kw.get("speculative_k"):
            assert eng.stats["spec_steps"] > 0
    assert seen["decode_step_paged"] == {1, 2, 4} and 4 in seen["spec_step"] <= {1, 2, 4}, seen


def test_top_p_draws_from_a_program_follow_the_plain_sampler():
    """A sampled program's first draw over 256 copies of one row, four calls
    (1024 draws): each token's frequency within 0.06 of ``top_p_filter``'s
    probability, and only tokens the filter keeps."""
    _, tp = _trees()
    rt = PORT_RTS["flash"]
    first, cache = _prefilled(tp, "none", rt)
    B = 256
    row = TM.KVCache(cache.k[:, :1].expand(-1, B, -1, -1, -1).contiguous(),
                     cache.v[:, :1].expand(-1, B, -1, -1, -1).contiguous(),
                     cache.lengths[:1].expand(B).contiguous())
    logits, _ = TM.decode_step(tp, TCFG, first[:1], TM.KVCache(cache.k[:, :1].clone(),
                               cache.v[:, :1].clone(), cache.lengths[:1]), "none", F32, rt)
    probs, idx = top_p_filter(logits, 8, 0.9, 2.0)
    want = torch.zeros(TINY["vocab_size"])
    want[idx[0]] = probs[0]
    gen = torch.Generator().manual_seed(11)
    draws = []
    for _ in range(4):
        toks, _ = TM.multi_step_decode(tp, TCFG, first[:1].expand(B), row, 1, gen, "none", F32,
                                       rt, top_k=8, top_p=0.9, temperature=2.0)
        draws.append(toks[:, 0])
    freq = torch.bincount(torch.cat(draws).long(), minlength=TINY["vocab_size"]).float() / 1024
    assert (want > 0).sum() >= 3  # the filter keeps several tokens
    assert ((freq > 0) <= (want > 0)).all()
    assert (freq - want).abs().max() <= 0.06


def test_programs_are_keyed_and_reused():
    """One program per (tensors, batch, sampler, static arguments); a second
    call reuses it and its buffers; the registry is the model's."""
    _, tp = _trees()
    rt = PORT_RTS["flash"]
    reg = G.programs(tp)
    assert G.programs(tp) is reg
    first, cache = _prefilled(tp, "none", rt)
    n0 = len(reg)
    a = TM.decode_program(tp, TCFG, cache, "none", F32, rt)
    assert len(reg) == n0 + 1
    assert TM.decode_program(tp, TCFG, TM.KVCache(cache.k, cache.v, cache.lengths.clone()),
                             "none", F32, rt) is a  # the same tensors: the same program
    ids_buf = a.inputs["ids"]
    TM.multi_step_decode(tp, TCFG, first, cache, 2, None, "none", F32, rt)
    TM.multi_step_decode(tp, TCFG, first, cache, 3, None, "none", F32, rt)
    assert len(reg) == n0 + 1 and a.inputs["ids"] is ids_buf and a.calls == 5
    gen = torch.Generator().manual_seed(0)
    others = [
        TM.decode_program(tp, TCFG, TM.init_kv_cache(TCFG, 2, 32, F32, "cpu"), "none", F32, rt),
        TM.decode_program(tp, TCFG, cache, "none", F32, rt, Sampling("rows", 100, True, gen)),
        TM.decode_program(tp, TCFG, cache, "none", F32, rt, Sampling("rows", 8, True, gen)),
        TM.decode_program(tp, TCFG, cache, "none", F32, TorchRuntimeConfig(decode_attn_v2=True,
                                                                          use_kernels=True,
                                                                          use_flash_attention=True)),
        TM.decode_program(tp, TCFG, cache, "none", torch.bfloat16, rt),
    ]
    assert len({id(p) for p in others + [a]}) == 6 and len(reg) == n0 + 6
    assert set(others[1].inputs) == {"ids", "lengths", "temperature", "top_p", "top_k_limit"}
    # one top-p program serves every temperature and top-p: they are buffers
    for temperature, top_p in ((0.5, 0.9), (2.0, 0.3)):
        TM.multi_step_decode(tp, TCFG, first, cache, 1, gen, "none", F32, rt, top_k=100,
                             top_p=top_p, temperature=temperature)
        assert len(reg) == n0 + 6 and others[1].inputs["temperature"][0] == temperature
    assert not any(p.capture for p in others + [a])  # the CPU never captures
    small = G.Programs(limit=2)
    made = [small.get((i,), "p", dict, lambda inp: {}, "cpu", rt) for i in range(3)]
    assert len(small) == 2 and small.get((0,), "p", dict, None, "cpu", rt) is not made[0]


def test_a_tree_differing_in_one_weight_gets_programs_of_its_own():
    """A graph bakes in every weight's address, so the registry is keyed by
    every leaf: a tree that shares ``final_ln`` but has another o_proj scale
    finds a registry and a program of its own, and decodes with its own
    weights (its tokens are the eager loop's over that tree)."""
    _, tp = _trees("int4g32")
    rt = PORT_RTS["flash"]
    o = dict(tp["layers"]["o_proj"])
    o["weight_scale"] = o["weight_scale"] * 3.0
    other = {**tp, "layers": {**tp["layers"], "o_proj": o}}
    assert other["final_ln"] is tp["final_ln"]
    assert G.programs(other) is not G.programs(tp)
    first, cache = _prefilled(tp, "int4g32", rt)
    a = TM.decode_program(tp, TCFG, cache, "int4g32", F32, rt)
    b = TM.decode_program(other, TCFG, cache, "int4g32", F32, rt)
    assert a is not b
    ref, _ = eager_multi_step(other, first, TM.KVCache(cache.k.clone(), cache.v.clone(),
                                                       cache.lengths), 6, "int4g32", rt)
    TM.multi_step_decode(tp, TCFG, first, TM.KVCache(cache.k.clone(), cache.v.clone(),
                                                     cache.lengths), 6, None, "int4g32", F32, rt)
    got, _ = TM.multi_step_decode(other, TCFG, first, cache, 6, None, "int4g32", F32, rt)
    assert torch.equal(got, ref)


def test_where_capture_is_refused():
    from chatglm_q_tpu_torch.parallel.sharding import Mesh

    cuda = torch.device("cuda")
    flash = TorchRuntimeConfig(use_kernels=True, use_flash_attention=True)
    assert G.capture_enabled(flash, cuda)
    assert not G.capture_enabled(flash, torch.device("cpu"))
    assert not G.capture_enabled(TorchRuntimeConfig(cuda_graphs=False), cuda)
    mesh = object.__new__(Mesh)
    assert G.refusal(TorchRuntimeConfig(mesh=mesh), cuda) == G.MESH_REFUSAL
    with pytest.warns(RuntimeWarning, match="gloo collectives"):
        G._SAID.discard(G.MESH_REFUSAL)
        assert not G.capture_enabled(TorchRuntimeConfig(mesh=mesh), cuda)
    masked = TorchRuntimeConfig(use_flash_attention=False)
    assert G.refusal(masked, cuda) == G.MASKED_REFUSAL
    with pytest.warns(RuntimeWarning, match="masked-softmax"):
        G._SAID.discard(G.MASKED_REFUSAL)
        assert not G.capture_enabled(masked, cuda)


class StandInGraph:
    """``torch.cuda.CUDAGraph``'s interface on the CPU: the capture runs the
    body (so a body that raises makes the capture fail), a replay counts."""

    def __init__(self):
        self.replays, self.generators = 0, []

    def register_generator_state(self, gen):
        self.generators.append(gen)

    def replay(self):
        self.replays += 1


@contextlib.contextmanager
def stand_in_capture(graph, pool=None, capture_error_mode="global"):
    assert capture_error_mode == "thread_local" and pool == "pool"
    yield


def _capturing(monkeypatch):
    monkeypatch.setattr(torch.cuda, "CUDAGraph", StandInGraph)
    monkeypatch.setattr(torch.cuda, "graph", stand_in_capture)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: "pool")


def test_capture_protocol_and_launch_counts(monkeypatch):
    """Call 1 runs eagerly (the warm-up), call 2 captures and replays, later
    calls replay; the capture's launches are taken back and added on each
    replay, so the counts are the kernels' real launches; the generator is
    registered with the graph."""
    _capturing(monkeypatch)
    ops.reset_launch_counts()

    def body(inp, scale):
        QM.int4g32_splitk.launches += 3  # what a step's wrapper calls count
        inp["x"].mul_(scale)
        return {"y": inp["x"] + 1}

    gen = torch.Generator()
    prog = G.StepProgram("t", body, {"x": torch.ones(2)}, True, G.Programs(), gen)
    prog.step(2.0)
    assert prog.graph is None and QM.int4g32_splitk.launches == 3
    prog.step(2.0)
    assert isinstance(prog.graph, StandInGraph) and prog.graph.replays == 1
    assert prog.graph.generators == [gen] and prog.launch_delta == {"int4g32_splitk": 3}
    assert QM.int4g32_splitk.launches == 6 and prog._registry.captures == 1
    prog.run(3, 2.0)
    assert QM.int4g32_splitk.launches == 15 and prog.graph.replays == 4 and prog.calls == 5
    ops.reset_launch_counts()


def test_the_collector_stays_off_during_a_capture(monkeypatch):
    """A dead cycle is collected before the capture and the collector is
    off while the body is captured (a graph freed then would invalidate
    the capture), on again after it, a failed capture too."""
    import gc
    import weakref

    _capturing(monkeypatch)
    seen = []

    class Cycle:
        pass

    def body(inp, fail):
        seen.append((gc.isenabled(), alive() is None))
        if fail:
            raise RuntimeError("operation not permitted when stream is capturing")
        return {}

    dead = Cycle()
    dead.me = dead
    alive = weakref.ref(dead)
    del dead
    prog = G.StepProgram("gc", body, {}, True, G.Programs())
    prog.step(False)  # eager: the collector as the process has it
    prog.step(False)  # the capture: collected first, then off
    assert seen[0][0] and seen[1] == (False, True) and gc.isenabled()
    prog = G.StepProgram("gc_fail", body, {}, True, G.Programs())
    prog.step(False)
    with pytest.raises(G.CaptureError):
        prog.step(True)
    assert seen[-1][0] is False and gc.isenabled()


def test_a_failed_capture_raises_and_runs_nothing(monkeypatch):
    """A body that syncs to the host cannot be captured: the capture raises
    ``CaptureError``, the step does not run eagerly in its place (the
    buffers and the counts stay as they were), and no graph is kept."""
    _capturing(monkeypatch)
    ops.reset_launch_counts()
    capturing = [False]

    def body(inp):
        QM.int4g32_splitk.launches += 1
        if capturing[0]:
            raise RuntimeError("operation not permitted when stream is capturing")
        inp["x"].add_(1)
        return {}

    prog = G.StepProgram("sync", body, {"x": torch.zeros(1)}, True, G.Programs())
    prog.step()
    capturing[0] = True
    with pytest.raises(G.CaptureError, match="sync: CUDA-graph capture failed"):
        prog.step()
    assert prog.graph is None and prog.calls == 1
    assert prog.inputs["x"].item() == 1 and QM.int4g32_splitk.launches == 1
    ops.reset_launch_counts()


class CharTokenizer:
    def encode(self, text):
        return [3 + ord(c) % 100 for c in text]

    def decode(self, ids):
        return "".join(chr(0x4E00 + int(i)) for i in ids)

    def __getitem__(self, piece):
        return 2


def test_decoder_programs_are_reused_across_calls():
    """``GLMDecoder.generate`` replays its decode program (and, speculating,
    its verify program) across calls on one kept cache: greedy text equals
    the eager loop's, speculation's equals plain greedy, and the second call
    builds no program."""
    _, tp = _trees()
    cfg = GLMLoadConfig(model_config=TCFG, torch_dtype="float32")
    dec = GLMDecoder(cfg, tp, CharTokenizer(), rt=PORT_RTS["flash"])
    prompt = "abcabcabcab"

    def text(**kw):
        gen = dec.generate(prompt, max_generated_tokens=10, temperature=0.0, **kw)
        while True:
            try:
                next(gen)
            except StopIteration as e:
                return e.value

    plain = text()
    n = len(G.programs(tp))
    assert text() == plain and len(G.programs(tp)) == n
    spec = text(speculative_k=3, speculative_ngram=2)
    assert spec == plain and dec.spec_stats["verify_steps"] > 0
    ids = CharTokenizer().encode(prompt)
    cache = TM.init_kv_cache(TCFG, 1, 64, F32, "cpu")
    logits, cache = TM.prefill(tp, TCFG, torch.tensor([ids]), torch.tensor([len(ids)]), cache,
                               "none", F32, PORT_RTS["flash"])
    first = greedy_sampling(logits)
    toks, _ = eager_multi_step(tp, first, cache, 9, "none", PORT_RTS["flash"])
    want = [int(first[0])] + toks[0].tolist()
    if 2 in want:
        want = want[:want.index(2)]
    assert plain == process_response(CharTokenizer().decode(want))


def test_interleaved_seeded_streams_draw_as_each_alone():
    """Each open ``generate`` stream keeps its own cache and generator: two
    seeded top-p streams stepped in turns give the texts each gives alone,
    and the pairs are reused by later calls."""
    _, tp = _trees()
    cfg = GLMLoadConfig(model_config=TCFG, torch_dtype="float32")
    dec = GLMDecoder(cfg, tp, CharTokenizer(), rt=PORT_RTS["flash"])
    kw = dict(max_generated_tokens=12, temperature=1.5, top_k=20, top_p=0.95)

    def alone(prompt, seed):
        gen = dec.generate(prompt, seed=seed, **kw)
        while True:
            try:
                next(gen)
            except StopIteration as e:
                return e.value

    want = [alone("abcab", 1), alone("zyxwv", 2)]
    assert want[0] != alone("abcab", 3)  # the draws depend on the seed
    n = len(G.programs(tp))
    streams = [dec.generate("abcab", seed=1, **kw), dec.generate("zyxwv", seed=2, **kw)]
    got, live = [None, None], [True, True]
    while any(live):
        for i, g in enumerate(streams):
            if live[i]:
                try:
                    next(g)
                except StopIteration as e:
                    got[i], live[i] = e.value, False
    assert got == want
    assert len(dec._free_caches) == 2 and len(G.programs(tp)) == n + 1

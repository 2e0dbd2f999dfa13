"""The port's ``ServingEngine`` against the JAX package's, on the CPU, on a
2-layer tiny ChatGLM2 (tests/test_engine.py's config) fed the same tree.

Greedy tokens are equal to the JAX engine's on the same prompts in each
admission mode (whole-prompt, chunked, lookahead), through both of the port's
attention paths; the JAX engines run their jnp path, as the JAX engine tests
do, and each is built once per module.  The rest mirrors the JAX engine
tests' host logic: cancel at each stage, ``run_stream``, ``max_new_tokens``,
mixed sampling, and sampled runs reproducible from ``seed`` (sampled tokens
cannot equal JAX's: the RNGs differ)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from chatglm_q_tpu.config import ChatGLM2Config as JConfig, GLMLoadConfig as JLoad  # noqa: E402
from chatglm_q_tpu.config import TpuRuntimeConfig  # noqa: E402
from chatglm_q_tpu.models import chatglm2 as JM  # noqa: E402
from chatglm_q_tpu.serving.engine import ServingEngine as JEngine  # noqa: E402
from chatglm_q_tpu_torch import ChatGLM2Config, GLMLoadConfig, TorchRuntimeConfig  # noqa: E402
from chatglm_q_tpu_torch.convert import params_from_numpy  # noqa: E402
from chatglm_q_tpu_torch.serving import ServingEngine  # noqa: E402

TINY = dict(hidden_size=64, inner_hidden_size=64, head_hidden_size=16,
            num_multi_query_groups=2, num_attention_heads=4, num_layers=2,
            vocab_size=128, max_sequence_length=64)
JAX_RT = TpuRuntimeConfig(use_pallas=False, use_flash_attention=False)
PORT_RTS = {"masked": TorchRuntimeConfig(),
            "flash": TorchRuntimeConfig(use_kernels=True, use_flash_attention=True)}
MODES = {"whole": {}, "chunked": {"prefill_chunk_size": 16}, "lookahead": {"lookahead": True},
         "chunked+lookahead": {"prefill_chunk_size": 16, "lookahead": True}}
ENGINE_KW = dict(max_batch=4, max_seq_len=64, decode_chunk=4)


def _workload():
    """Six requests over four slots: prompts of 2-40 tokens (chunked
    admission takes up to three chunks) and budgets that end mid-chunk."""
    rng = np.random.default_rng(17)
    lens, budgets = (3, 40, 2, 21, 9, 33), (6, 9, 3, 12, 5, 7)
    return [(rng.integers(3, 120, size=n).tolist(), b) for n, b in zip(lens, budgets)]


WORK = _workload()


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
def jax_tokens(parts):
    """The JAX engine's greedy tokens in each mode, built once."""
    jl, jp = parts[:2]
    return {m: drain(JEngine(jl, jp, None, rt=JAX_RT, **ENGINE_KW, **kw))
            for m, kw in MODES.items()}


def port_engine(parts, rt="masked", **kw):
    tl, tp = parts[2:]
    return ServingEngine(tl, tp, None, rt=PORT_RTS[rt], device="cpu", **{**ENGINE_KW, **kw})


@pytest.mark.parametrize("rt", list(PORT_RTS))
@pytest.mark.parametrize("mode", list(MODES))
def test_greedy_tokens_equal_jax(parts, jax_tokens, mode, rt):
    eng = port_engine(parts, rt, **MODES[mode])
    got = drain(eng)
    assert got == jax_tokens[mode], (got, jax_tokens[mode])
    assert eng.stats["admitted"] == eng.stats["finished"] == len(WORK)
    assert all(len(g) <= b for g, (_, b) in zip(got, WORK))


def test_cancel_at_each_stage(parts):
    """Queued (dropped), mid-prefill (abandoned), decoding (retired at the
    chunk boundary), unknown (False); the engine serves new work after."""
    eng = port_engine(parts, max_batch=2, prefill_chunk_size=16)
    r1 = eng.submit(list(range(3, 10)), max_new_tokens=32, temperature=0.0)
    r2 = eng.submit(list(range(3, 43)), max_new_tokens=32, temperature=0.0)  # 3 chunks
    r3 = eng.submit([5, 6, 7], max_new_tokens=32, temperature=0.0)  # queued
    eng.step()  # r1 decoding; r2 mid-prefill; r3 queued (two slots)
    assert eng.slots[1].pending_ids is not None
    assert eng.cancel(r3) is True
    assert eng.cancel(r2) is True
    assert eng.cancel(r1) is True
    assert eng.cancel(9999) is False
    assert not eng.has_work
    assert {r.req_id for r in eng.finished} == {r1, r2, r3}
    assert all(r.done for r in eng.finished)
    r4 = eng.submit([9, 10, 11], max_new_tokens=4, temperature=0.0)
    while eng.has_work:
        eng.step()
    assert any(r.req_id == r4 and len(r.generated) > 0 for r in eng.finished)


@pytest.mark.parametrize("lookahead", [False, True])
def test_run_stream_yields_all_tokens(parts, lookahead):
    """The stream carries every token of each request (an eos first token
    and over-generation past eos or budget included, so the finished tokens
    are a prefix), and no request exceeds max_new_tokens."""
    eng = port_engine(parts, lookahead=lookahead)
    acc = {}
    for rid, toks in eng.run_stream([p for p, _ in WORK[:3]], max_new_tokens=6,
                                    temperature=0.0):
        acc.setdefault(rid, []).extend(toks)
    assert len(eng.finished) == 3
    for req in eng.finished:  # (an eos first token leaves generated empty)
        assert len(req.generated) <= 6
        assert acc[req.req_id][: len(req.generated)] == req.generated
        assert len(acc[req.req_id]) >= 1


def test_run_returns_submission_order(parts, jax_tokens):
    eng = port_engine(parts)
    want = jax_tokens["whole"][:2]
    got = eng.run([WORK[0][0], WORK[1][0]], max_new_tokens=6, temperature=0.0)
    assert got == [w[:6] for w in want]


def test_mixed_sampling_keeps_greedy_rows_exact(parts, jax_tokens):
    """Sampling rows beside greedy rows in the same chunks: the greedy rows
    still equal the JAX engine's greedy tokens."""
    eng = port_engine(parts)
    ids = []
    for i, (p, b) in enumerate(WORK):
        kw = dict(temperature=1.5, top_p=0.95) if i % 2 else dict(temperature=0.0)
        ids.append(eng.submit(p, max_new_tokens=b, **kw))
    while eng.has_work:
        eng.step()
    by_id = {r.req_id: r.generated for r in eng.finished}
    for i in range(0, len(WORK), 2):
        assert by_id[ids[i]] == jax_tokens["whole"][i]
    assert all(len(by_id[ids[i]]) >= 1 for i in range(1, len(WORK), 2))


def test_sampled_runs_reproducible_from_seed(parts):
    def run(seed):
        eng = port_engine(parts, seed=seed)
        return drain(eng, temperature=1.0, top_p=0.9, top_k=50)

    a, b = run(5), run(5)
    assert a == b
    assert all(len(t) >= 1 for t in a)

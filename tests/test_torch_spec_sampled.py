"""The port's sampled in-loop speculation against the JAX package's, on the
CPU: ``spec_accept_next`` (models/spec_decode.py) and
``PagedServingEngine(speculative_sampled=True)``, as tests/test_spec_sampled.py
holds JAX's.

For a point-mass draft d, accepting d with probability p(d) and otherwise
drawing from p restricted to x ≠ d gives exactly p: the emitted tokens'
frequencies over 20,000 draws are held to p in total variation within
``TV_TOL`` (a binomial proportion at n = 20k has a standard deviation of at
most 0.0035, so the expected total variation over 8 tokens is ~0.006), and a
control that resamples from the whole p on a rejection must exceed it.  The
two RNGs differ, so sampled tokens are compared by distribution and by
reproducibility from a seed; greedy rows, and a top-k-of-1 sampled row
(its filter is a point mass at the argmax), give the JAX engine's greedy
tokens exactly."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from chatglm_q_tpu.config import ChatGLM2Config as JConfig, GLMLoadConfig as JLoad  # noqa: E402
from chatglm_q_tpu.config import TpuRuntimeConfig  # noqa: E402
from chatglm_q_tpu.models import chatglm2 as JM  # noqa: E402
from chatglm_q_tpu.models.spec_decode import spec_accept_next as j_accept  # noqa: E402
from chatglm_q_tpu.ops.sampling import top_p_filter as j_filter  # noqa: E402
from chatglm_q_tpu.serving.paged_engine import PagedServingEngine as JPaged  # noqa: E402
from chatglm_q_tpu_torch import ChatGLM2Config, GLMLoadConfig, TorchRuntimeConfig  # noqa: E402
from chatglm_q_tpu_torch.convert import params_from_numpy  # noqa: E402
from chatglm_q_tpu_torch.models.spec_decode import spec_accept_next  # noqa: E402
from chatglm_q_tpu_torch.ops.sampling import top_p_filter  # noqa: E402
from chatglm_q_tpu_torch.serving import PagedServingEngine  # noqa: E402

TV_TOL = 0.015
N_DRAWS = 20000
CFG = dict(hidden_size=128, inner_hidden_size=256, head_hidden_size=32,
           num_multi_query_groups=2, num_attention_heads=4, num_layers=2,
           vocab_size=256, max_sequence_length=128)
ENGINE_KW = dict(max_batch=4, max_seq_len=128, decode_chunk=4, num_pages=24, page_size=16)
FLASH = TorchRuntimeConfig(use_kernels=True, use_flash_attention=True)


def _filtered(logits, top_k, top_p):
    """The port's filter of ``logits`` (1, V), checked against JAX's, and
    the target p over the vocabulary."""
    tp, ti = top_p_filter(torch.from_numpy(logits), top_k, top_p)
    jp, ji = j_filter(jnp.asarray(logits), top_k, top_p)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-6, atol=1e-7)
    p = np.zeros(logits.shape[1])
    p[ti.numpy()[0]] = tp.numpy()[0]
    return tp, ti, p


def _draws(tp, ti, draft_tok, seed):
    n = N_DRAWS
    gen = torch.Generator().manual_seed(seed)
    accept, nxt = spec_accept_next(tp.expand(n, -1), ti.expand(n, -1),
                                   torch.full((n,), draft_tok, dtype=torch.int32),
                                   torch.zeros((n,), dtype=torch.int32),
                                   torch.zeros((n,), dtype=torch.bool), gen)
    return accept.numpy(), nxt.numpy()


@pytest.mark.parametrize("rank", [0, -1], ids=["mode", "lowest"])
def test_spec_accept_next_marginal_is_exact(rank):
    """(accept ? draft : residual draw) is distributed as the filtered p, for
    a draft at the mode and at the lowest rank the filter keeps; acceptance
    fires at rate p(draft).  The control (a rejection resampling from all of
    p) is off by p(d)(1 − p(d)) at the draft and exceeds the limit at the
    mode."""
    logits = (np.random.RandomState(0).randn(1, 8) * 2.0).astype(np.float32)
    tp, ti, p = _filtered(logits, 8, 0.9)
    kept = [int(i) for i, q in zip(ti.numpy()[0], tp.numpy()[0]) if q > 0]
    draft_tok = kept[rank]
    accept, nxt = _draws(tp, ti, draft_tok, seed=11 + rank)
    emitted = np.where(accept, draft_tok, nxt)
    freq = np.bincount(emitted, minlength=8) / N_DRAWS
    tv = 0.5 * np.abs(freq - p).sum()
    assert tv <= TV_TOL, (tv, freq, p)
    np.testing.assert_allclose(freq, p, atol=0.016)
    assert abs(accept.mean() - p[draft_tok]) <= 0.016
    assert (nxt[~accept] != draft_tok).all()  # the residual excludes the draft
    if rank == 0:
        gen = torch.Generator().manual_seed(3)
        plain = torch.multinomial(tp.expand(N_DRAWS, -1), 1, generator=gen)[:, 0]
        naive = np.where(accept, draft_tok, ti.numpy()[0][plain.numpy()])
        control = 0.5 * np.abs(np.bincount(naive, minlength=8) / N_DRAWS - p).sum()
        assert control > TV_TOL, control


def test_spec_accept_next_draft_outside_filter_never_accepts():
    """A draft the filter zeroed, or the −1 filler, is always rejected, and
    the residual is then the whole filtered p (its draws stay in the
    support)."""
    logits = (np.random.RandomState(1).randn(1, 16) * 3.0).astype(np.float32)
    tp, ti, p = _filtered(logits, 4, 0.5)
    zeroed = [int(i) for i, q in zip(ti.numpy()[0], tp.numpy()[0]) if q == 0.0]
    for draft_tok in zeroed[:1] + [-1]:
        accept, nxt = _draws(tp, ti, draft_tok, seed=5)
        assert not accept.any()
        assert (p[nxt] > 0).all()


def test_spec_accept_next_greedy_rows_equal_jax():
    logits = np.random.RandomState(2).randn(3, 8).astype(np.float32)
    tp, ti = top_p_filter(torch.from_numpy(logits), 8, 1.0)
    argm = logits.argmax(-1).astype(np.int32)
    draft = np.array([argm[0], (argm[1] + 1) % 8, -1], np.int32)
    greedy = np.array([True, True, True])
    accept, nxt = spec_accept_next(tp, ti, torch.from_numpy(draft), torch.from_numpy(argm),
                                   torch.from_numpy(greedy), torch.Generator().manual_seed(0))
    jp, ji = j_filter(jnp.asarray(logits), 8, 1.0)
    ja, jn = j_accept(jax.random.PRNGKey(0), jp, ji, jnp.asarray(draft), jnp.asarray(argm),
                      jnp.asarray(greedy))
    assert accept.tolist() == np.asarray(ja).tolist() == [True, False, False]
    assert nxt.tolist() == np.asarray(jn).tolist() == argm.tolist()


@pytest.fixture(scope="module")
def trees():
    jp = JM.init_params(jax.random.PRNGKey(0), JConfig(**CFG), "none", jnp.float32)
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def _drain(engine, work):
    ids = [engine.submit(p, **kw) for p, kw in work]
    steps = 0
    while engine.has_work:
        engine.step()
        steps += 1
        assert steps < 300, "engine did not drain"
    by_id = {r.req_id: r.generated for r in engine.finished}
    return [by_id[i] for i in ids]


def _jax_greedy(trees, prompts, budget):
    eng = JPaged(JLoad(model_config=JConfig(**CFG), torch_dtype="float32"), trees[0], None,
                 rt=TpuRuntimeConfig(use_pallas=False), **ENGINE_KW)
    return _drain(eng, [(p, dict(max_new_tokens=budget, temperature=0.0)) for p in prompts])


def _port(trees, **kw):
    return PagedServingEngine(GLMLoadConfig(model_config=ChatGLM2Config(**CFG),
                                            torch_dtype="float32"), trees[1], None, rt=FLASH,
                              device="cpu", **ENGINE_KW, **kw)


def test_engine_spec_sampled_mixed_batch(trees):
    """One sampled speculation program over a greedy row and two sampled
    ones: the greedy row gives the JAX engine's greedy tokens, the sampled
    rows valid ids, and a second engine on the same seed the same tokens."""
    rng = np.random.RandomState(4)
    rep = rng.randint(3, 12, size=4).tolist() * 5  # low entropy: drafts fire
    greedy_prompt = rng.randint(3, 250, size=13).tolist()
    work = [(greedy_prompt, dict(max_new_tokens=12, temperature=0.0)),
            (rep, dict(max_new_tokens=12, temperature=1.0, top_p=0.95)),
            (rep[::-1], dict(max_new_tokens=12, temperature=0.7, top_k=8))]

    def run():
        eng = _port(trees, speculative_k=4, speculative_ngram=2, speculative_sampled=True, seed=7)
        return _drain(eng, work), dict(eng.stats)

    (out1, stats1), (out2, _) = run(), run()
    assert out1 == out2, "the same seed must reproduce"
    assert out1[0] == _jax_greedy(trees, [greedy_prompt], 12)[0]
    assert stats1["spec_steps"] > 0 and stats1["decode_chunks"] > 0
    for toks in out1[1:]:
        assert 0 < len(toks) <= 12 and all(0 <= t < CFG["vocab_size"] for t in toks)


def test_engine_spec_sampled_acceptance_on_forced_repetition(trees):
    """Sampling with top_k = 1 is a point mass at the argmax: the sampled
    program accepts drafts as greedy speculation does (acceptance > 0 on a
    repetitive prompt) and emits the JAX engine's greedy tokens."""
    rep = np.random.RandomState(6).randint(3, 9, size=3).tolist() * 8
    eng = _port(trees, speculative_k=4, speculative_ngram=2, speculative_sampled=True, seed=3)
    out = _drain(eng, [(rep, dict(max_new_tokens=16, temperature=1.0, top_k=1))])
    assert len(out[0]) == 16
    assert eng.stats["spec_accepted"] > 0, eng.stats
    assert out[0] == _jax_greedy(trees, [rep], 16)[0]

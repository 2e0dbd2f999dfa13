"""The port's ``GLMDecoder`` against the JAX package's, on the CPU: a tiny
checkpoint (built as tests/test_decoder.py builds one) saved once and loaded
by both packages' ``from_pretrained``; greedy ``generate`` yields the same
text stream and returns the same final text, for none / int8 / int4g32.
Greedy ``generate(speculative_k=...)`` (prompt-lookup speculation) gives
JAX's text and the plain greedy text.  Also: a path that is not a directory,
and ``device=None`` without CUDA, raise."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from chatglm_q_tpu import loader as JLD  # noqa: E402
from chatglm_q_tpu.config import ChatGLM2Config as JConfig, GLMLoadConfig as JLoad  # noqa: E402
from chatglm_q_tpu.config import TpuRuntimeConfig  # noqa: E402
from chatglm_q_tpu.models import chatglm2 as JM  # noqa: E402
from chatglm_q_tpu.serving.decoder import GLMDecoder as JDecoder  # noqa: E402
from chatglm_q_tpu.tokenizer import ChatGLM2Tokenizer as JTok  # noqa: E402
from chatglm_q_tpu.tokenizer.build import build_unigram_model  # noqa: E402
from chatglm_q_tpu_torch import TorchRuntimeConfig  # noqa: E402
from chatglm_q_tpu_torch.models import chatglm2 as TM  # noqa: E402
from chatglm_q_tpu_torch.serving import GLMDecoder, chat_template, process_response  # noqa: E402

TINY = dict(hidden_size=64, inner_hidden_size=64, head_hidden_size=16,
            num_multi_query_groups=2, num_attention_heads=4, num_layers=2,
            vocab_size=320, max_sequence_length=64)
PROMPTS = ["hello world", chat_template([("hello", "world")], "hello é"), "hello " * 80]


def _run(gen):
    stream = []
    while True:
        try:
            stream.append(next(gen))
        except StopIteration as e:
            return stream, e.value


@pytest.fixture(scope="module", params=["none", "int8", "int4g32"])
def ckpt(request, tmp_path_factory):
    quant = request.param
    vocab = {f"tok{i}": -float(i) for i in range(40)}
    vocab.update({"hello": -0.5, "world": -0.6})
    root = tmp_path_factory.mktemp(f"ckpt_{quant}")
    (root / "sp.model").write_bytes(build_unigram_model(vocab))
    cfg = JConfig(**TINY)
    params = JM.init_params(jax.random.PRNGKey(0), cfg, quant, jnp.float32)
    JLD.save_model_and_tokenizer(root / "ckpt", JLoad(model_config=cfg, quant_type=quant,
                                                      torch_dtype="float32"),
                                 params, JTok(root / "sp.model"))
    return root / "ckpt"


def test_greedy_generate_equals_jax(ckpt, capsys):
    jd = JDecoder.from_pretrained(ckpt, rt=TpuRuntimeConfig(use_pallas=False))
    for rt in (TorchRuntimeConfig(), TorchRuntimeConfig(use_flash_attention=True,
                                                        use_kernels=True)):
        td = GLMDecoder.from_pretrained(ckpt, device="cpu", rt=rt, time_log=True)
        assert td.eos_token_id == jd.eos_token_id
        for prompt in PROMPTS:
            want = _run(jd.generate(prompt, max_generated_tokens=12, temperature=0.0))
            got = _run(td.generate(prompt, max_generated_tokens=12, temperature=0.0))
            assert got == want, prompt
    assert "tok/s" in capsys.readouterr().out  # the time_log report


def test_generate_equals_model_level_loop(ckpt):
    """generate's final text is process_response(decode) of prefill +
    multi_step_decode on the same ids (what the chip run checks at 6B)."""
    td = GLMDecoder.from_pretrained(ckpt, device="cpu")
    qt, mc = td.config.quant_type, td.config.model_config
    prompt = chat_template([], "hello world")
    _, final = _run(td.generate(prompt, max_generated_tokens=10, temperature=0.0))
    ids = td.tokenizer.encode(prompt)
    cache = TM.init_kv_cache(mc, 1, td.max_sequence_length, torch.float32, device="cpu")
    logits, cache = TM.prefill(td.params, mc, torch.tensor([ids]), torch.tensor([len(ids)]),
                               cache, qt, torch.float32, td.rt)
    first = torch.argmax(logits, -1).to(torch.int32)
    toks, _ = TM.multi_step_decode(td.params, mc, first, cache, 9, None, qt, torch.float32, td.rt)
    out = [int(first[0])] + toks[0].tolist()
    if td.eos_token_id in out:
        out = out[: out.index(td.eos_token_id) + 1]
    assert final == process_response(td.tokenizer.decode(out))


def test_sampled_generate_is_seeded(ckpt):
    td = GLMDecoder.from_pretrained(ckpt, device="cpu")
    a = _run(td.generate("hello", max_generated_tokens=6, seed=3))
    assert a == _run(td.generate("hello", max_generated_tokens=6, seed=3))


def test_save_pretrained_round_trips(ckpt, tmp_path):
    td = GLMDecoder.from_pretrained(ckpt, device="cpu")
    td.save_pretrained(tmp_path / "again")
    td2 = GLMDecoder.from_pretrained(tmp_path / "again", device="cpu")
    flat = lambda t, p="": [x for k, v in t.items() for x in (  # noqa: E731
        flat(v, p + k + ".") if isinstance(v, dict) else [(p + k, v)])]
    for (k1, a), (k2, b) in zip(flat(td.params), flat(td2.params)):
        assert k1 == k2 and a.dtype == b.dtype and torch.equal(a, b), k1
    assert _run(td.generate("hello", max_generated_tokens=5, temperature=0.0)) == \
        _run(td2.generate("hello", max_generated_tokens=5, temperature=0.0))


def test_speculative_generate_equals_jax(ckpt):
    """Greedy generation with k = 4 drafts: the same text stream as JAX's
    speculative decoder and as the port's own plain greedy run, with
    verify steps taken."""
    jd = JDecoder.from_pretrained(ckpt, rt=TpuRuntimeConfig(use_pallas=False))
    td = GLMDecoder.from_pretrained(ckpt, device="cpu")
    verified = 0
    for prompt in PROMPTS:
        kw = dict(max_generated_tokens=16, temperature=0.0)
        want = _run(jd.generate(prompt, speculative_k=4, speculative_ngram=2, **kw))
        got = _run(td.generate(prompt, speculative_k=4, speculative_ngram=2, **kw))
        stats = dict(td.spec_stats)
        assert stats == jd.spec_stats, prompt
        verified += stats["verify_steps"]
        assert got == want == _run(td.generate(prompt, **kw)), prompt
    assert verified > 0


def test_what_the_port_refuses(ckpt, tmp_path, monkeypatch):
    with pytest.raises(FileNotFoundError, match="local"):
        GLMDecoder.from_pretrained("THUDM/chatglm2-6b")  # a hub id: no network
    (tmp_path / "file").write_text("x")
    with pytest.raises(FileNotFoundError, match="local"):
        GLMDecoder.from_pretrained(tmp_path / "file", device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        GLMDecoder.from_pretrained(ckpt)


def test_params_land_on_the_device_asked_for(ckpt):
    td = GLMDecoder.from_pretrained(ckpt, device="cpu")
    assert td.device.type == "cpu"
    assert all(t.device.type == "cpu" for t in td.params["layers"]["q_proj"].values())
    assert np.isfinite(td.params["lm_head"]["weight"].float().numpy()).all()

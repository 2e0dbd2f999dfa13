"""The port's OpenAI-style API server (``chatglm_q_tpu_torch.serving.api_server``)
on the CPU, over a live socket.

tests/test_api_server.py's cases run over both of the port's engines
(``ServingEngine`` and ``PagedServingEngine``, on a 2-layer tiny tree that the
JAX package's ``init_params`` makes): routes, SSE streaming, stop strings,
usage, ``n``, ``/metrics``, the worker's crash handling and the incremental
detokenizer.  Then the two packages' servers side by side: a scripted stub
engine drives JAX's ``GLMAPIServer`` and the port's through the same
requests, and their response bodies are equal apart from ids and
timestamps; and the port's server over the port's engine answers with the
JAX server's text over the JAX engine on the same tree (greedy)."""
import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from chatglm_q_tpu.config import ChatGLM2Config as JConfig, GLMLoadConfig as JLoad  # noqa: E402
from chatglm_q_tpu.config import TpuRuntimeConfig  # noqa: E402
from chatglm_q_tpu.models import chatglm2 as JM  # noqa: E402
from chatglm_q_tpu.serving import api_server as JAPI  # noqa: E402
from chatglm_q_tpu.serving.engine import ServingEngine as JEngine  # noqa: E402
from chatglm_q_tpu_torch import ChatGLM2Config, GLMLoadConfig  # noqa: E402
from chatglm_q_tpu_torch.convert import params_from_numpy  # noqa: E402
from chatglm_q_tpu_torch.serving import api_server as API  # noqa: E402
from chatglm_q_tpu_torch.serving import PagedServingEngine, ServingEngine  # noqa: E402
from chatglm_q_tpu_torch.serving.api_server import (  # noqa: E402
    GLMAPIServer, _DONE, _messages_to_prompt, _StreamState, EngineWorker)
from chatglm_q_tpu_torch.serving.chat import process_response  # noqa: E402

TINY = dict(hidden_size=64, inner_hidden_size=64, head_hidden_size=16,
            num_multi_query_groups=2, num_attention_heads=4, num_layers=2,
            vocab_size=128, max_sequence_length=64)
ENGINE_KW = dict(max_batch=4, max_seq_len=64, decode_chunk=4, device="cpu")
PAGED_KW = dict(page_size=16, num_pages=16, prefix_cache=True, prefill_chunk_size=16)


class StubTokenizer:
    """Char-level codec over the tiny vocab (id = codepoint offset into a
    CJK page so decode is always valid text)."""

    BASE = 0x4E00

    def encode(self, text):
        return [ord(c) % 128 for c in text]

    def decode(self, ids):
        return "".join(chr(self.BASE + int(i)) for i in ids)

    def __getitem__(self, piece):
        assert piece == "</s>"
        return 2


@pytest.fixture(scope="module")
def trees():
    jp = JM.init_params(jax.random.PRNGKey(0), JConfig(**TINY), "none", jnp.float32)
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def _load_cfg():
    return GLMLoadConfig(model_config=ChatGLM2Config(**TINY), torch_dtype="float32")


def _engine(kind, params):
    if kind == "paged":
        return PagedServingEngine(_load_cfg(), params, tokenizer=StubTokenizer(), **ENGINE_KW,
                                  **PAGED_KW)
    return ServingEngine(_load_cfg(), params, tokenizer=StubTokenizer(), **ENGINE_KW)


@pytest.fixture(scope="module", params=["dense", "paged"])
def api(request, trees):
    server = GLMAPIServer(_engine(request.param, trees[1]), port=0, model_name="tiny-test")
    server.start()
    yield server
    server.shutdown()


def _url(server, path):
    return f"http://{server.host}:{server.port}{path}"


def _post(server, path, body):
    req = urllib.request.Request(_url(server, path), data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=300) as resp:
        return resp.status, json.loads(resp.read())


def _sse(server, path, body):
    """Every ``data:`` payload of an SSE response, parsed (``[DONE]`` kept)."""
    req = urllib.request.Request(_url(server, path), data=json.dumps(dict(body, stream=True))
                                 .encode(), headers={"Content-Type": "application/json"})
    out = []
    with urllib.request.urlopen(req, timeout=300) as resp:
        for raw in resp:
            line = raw.decode().strip()
            if line.startswith("data: "):
                payload = line[len("data: "):]
                out.append(payload if payload == "[DONE]" else json.loads(payload))
    return out


def _post_stream(server, path, body):
    """(deltas, finish_reason) of an SSE stream."""
    deltas, reason = [], None
    for obj in _sse(server, path, body):
        if obj == "[DONE]":
            break
        if not obj["choices"]:
            continue
        choice = obj["choices"][0]
        if choice.get("finish_reason"):
            reason = choice["finish_reason"]
        deltas.append(choice["delta"].get("content", "") if "delta" in choice
                      else choice.get("text", ""))
    return deltas, reason


BODY = {"model": "tiny-test", "max_tokens": 12, "temperature": 0.0,
        "messages": [{"role": "user", "content": "hello"}]}


def test_models_endpoint(api):
    with urllib.request.urlopen(_url(api, "/v1/models"), timeout=60) as resp:
        obj = json.loads(resp.read())
    assert obj["data"][0]["id"] == "tiny-test"


def test_chat_completion(api):
    status, obj = _post(api, "/v1/chat/completions", BODY)
    assert status == 200
    assert obj["object"] == "chat.completion"
    choice = obj["choices"][0]
    assert choice["message"]["role"] == "assistant"
    assert isinstance(choice["message"]["content"], str)
    assert choice["finish_reason"] in ("stop", "length")
    u = obj["usage"]
    assert u["prompt_tokens"] > 0
    assert u["total_tokens"] == u["prompt_tokens"] + u["completion_tokens"]
    assert u["completion_tokens"] <= 12


def test_stream_matches_non_stream(api):
    _, obj = _post(api, "/v1/chat/completions", BODY)
    full = obj["choices"][0]["message"]["content"]
    deltas, reason = _post_stream(api, "/v1/chat/completions", BODY)
    assert "".join(deltas) == full
    assert reason == obj["choices"][0]["finish_reason"]


def test_text_completion(api):
    body = {"model": "tiny-test", "prompt": "abc", "max_tokens": 8, "temperature": 0.0}
    status, obj = _post(api, "/v1/completions", body)
    assert status == 200
    assert obj["object"] == "text_completion"
    assert isinstance(obj["choices"][0]["text"], str)


def test_stop_sequence_truncates(api):
    _, obj = _post(api, "/v1/chat/completions", dict(BODY, max_tokens=16))
    full = obj["choices"][0]["message"]["content"]
    assert len(full) >= 4, full  # the tiny tree's greedy answer is 16 tokens long
    stop = full[2:4]
    _, obj2 = _post(api, "/v1/chat/completions", dict(BODY, max_tokens=16, stop=stop))
    text = obj2["choices"][0]["message"]["content"]
    assert stop not in text
    assert text == full[: full.find(stop)]
    assert obj2["choices"][0]["finish_reason"] == "stop"
    # the streaming path applies the same truncation
    deltas, reason = _post_stream(api, "/v1/chat/completions",
                                  dict(BODY, max_tokens=16, stop=stop))
    assert "".join(deltas) == text
    assert reason == "stop"


def test_concurrent_clients_share_engine(api):
    """Four clients in flight at once: continuous batching multiplexes them
    onto the 4 engine slots; greedy answers equal a serial run's."""
    _, ref = _post(api, "/v1/chat/completions", BODY)
    expected = ref["choices"][0]["message"]["content"]
    results = [None] * 4

    def call(i):
        _, obj = _post(api, "/v1/chat/completions", BODY)
        results[i] = obj["choices"][0]["message"]["content"]

    threads = [threading.Thread(target=call, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert results == [expected] * 4


def test_bad_json_is_400(api):
    req = urllib.request.Request(_url(api, "/v1/chat/completions"), data=b"{not json",
                                 headers={"Content-Type": "application/json"})
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(req, timeout=60)
    assert e.value.code == 400
    assert "error" in json.loads(e.value.read())


def test_messages_template_mapping():
    prompt = _messages_to_prompt([
        {"role": "system", "content": "sys"},
        {"role": "user", "content": "q1"},
        {"role": "assistant", "content": "a1"},
        {"role": "user", "content": "q2"},
    ])
    assert prompt == "[Round 1]\n\n问：q1\n\n答：a1\n\n[Round 2]\n\n问：sys\nq2\n\n答："
    with pytest.raises(ValueError):
        _messages_to_prompt([{"role": "assistant", "content": "a"}])


def test_metrics_endpoint(api):
    _post(api, "/v1/chat/completions", BODY)  # counters above 0
    with urllib.request.urlopen(_url(api, "/metrics"), timeout=60) as resp:
        assert resp.headers["Content-Type"].startswith("text/plain")
        text = resp.read().decode()
    assert 'glm_engine_total{stat="generated_tokens"}' in text
    assert 'glm_engine_gauge{stat="max_batch"} 4' in text
    gen = int(next(line for line in text.splitlines()
                   if 'stat="generated_tokens"' in line).rsplit(" ", 1)[1])
    assert gen > 0


def test_stream_include_usage(api):
    usage = None
    for obj in _sse(api, "/v1/chat/completions",
                    dict(BODY, stream_options={"include_usage": True})):
        if obj != "[DONE]" and obj.get("usage"):
            usage = obj["usage"]
            assert obj["choices"] == []
    assert usage is not None
    assert usage["completion_tokens"] <= 12
    assert usage["total_tokens"] == usage["prompt_tokens"] + usage["completion_tokens"]


def test_worker_crash_closes_streams():
    """An engine exception must not leave HTTP clients hanging: the worker
    closes every open event stream with finish_reason "error", and later
    submits fail fast."""

    class BoomEngine:
        eos_token_id = 2
        finished = []

        def __init__(self):
            self._n = 0

        @property
        def has_work(self):
            return self._n > 0

        def submit(self, ids, **kw):
            self._n += 1
            return self._n

        def step(self):
            raise RuntimeError("device fell over")

        def cancel(self, rid):
            pass

        sync_events = ServingEngine.sync_events  # the worker's way in

    w = EngineWorker(BoomEngine())
    w.start()
    rid, events = w.submit([1, 2, 3])
    assert events.get(timeout=30) is _DONE
    assert w.finish_reason(rid) == "error"
    w.join(timeout=30)
    assert not w.is_alive()
    t0 = time.monotonic()
    with pytest.raises(RuntimeError):
        w.submit([4, 5])
    assert time.monotonic() - t0 < 30


class PieceTok:
    def __init__(self, pieces):
        self.pieces = pieces

    def decode(self, ids):
        return "".join(self.pieces[i] for i in ids)


def test_stream_state_non_monotonic_rewrites():
    """``process_response`` rewrites chars already seen (halfwidth
    punctuation before a CJK char, the training-time placeholder): the
    deltas still add up to the final text however the tokens are chunked."""
    pieces = ["abc", ",", "中", "!", "x", "[[训练时", "间]]", "好", ":", "中", " ", " tail ", "�",
              "中"]
    tok = PieceTok(pieces)
    full = process_response(tok.decode(range(len(pieces))))
    for chunk_len in (1, 2, 3, len(pieces)):
        st = _StreamState(tok, eos_token_id=-1, stop=[])
        out = []
        for i in range(0, len(pieces), chunk_len):
            d = st.push(list(range(i, min(i + chunk_len, len(pieces)))))
            if d:
                out.append(d)
        tail = st.flush()
        if tail:
            out.append(tail)
        assert "".join(out) == full == st.text, (chunk_len, out, full)


def test_stream_state_stop_across_chunks():
    """A stop string split across pushes truncates exactly."""
    st = _StreamState(PieceTok(["中中", "ST", "OP", "中中"]), eos_token_id=-1, stop=["STOP"])
    out = []
    for i in range(4):
        d = st.push([i])
        if d:
            out.append(d)
    t = st.flush()
    if t:
        out.append(t)
    assert st.stopped
    assert "".join(out) == "中中" == st.text


def test_api_server_over_paged_engine(trees):
    """The server is engine-agnostic: the paged engine (page pool + prefix
    cache) answers with the dense engine's greedy text."""
    outs = []
    for kind in ("dense", "paged"):
        srv = GLMAPIServer(_engine(kind, trees[1]), port=0, model_name="t")
        srv.start()
        try:
            _, obj = _post(srv, "/v1/chat/completions", BODY)
            outs.append(obj["choices"][0]["message"]["content"])
        finally:
            srv.shutdown()
    assert outs[0] == outs[1]


def test_n_choices(api):
    """n > 1 fans out to n engine requests decoded together; greedy choices
    are identical, indices ordered, usage summed; streaming refuses n > 1."""
    _, ref = _post(api, "/v1/chat/completions", BODY)
    _, obj = _post(api, "/v1/chat/completions", dict(BODY, n=3))
    assert [c["index"] for c in obj["choices"]] == [0, 1, 2]
    expected = ref["choices"][0]["message"]["content"]
    assert [c["message"]["content"] for c in obj["choices"]] == [expected] * 3
    u = obj["usage"]
    assert u["prompt_tokens"] == ref["usage"]["prompt_tokens"] * 3
    assert u["completion_tokens"] == ref["usage"]["completion_tokens"] * 3
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(api, "/v1/chat/completions", dict(BODY, n=2, stream=True))
    assert e.value.code == 400


def test_port_server_over_port_engine_answers_as_jax_does(trees):
    """Greedy answers of the port's server over the port's engines equal the
    JAX server's over the JAX engine on the same tree (JAX's jnp path)."""
    jp, tp = trees
    jeng = JEngine(JLoad(model_config=JConfig(**TINY), torch_dtype="float32"), jp,
                   tokenizer=StubTokenizer(), max_batch=4, max_seq_len=64, decode_chunk=4,
                   rt=TpuRuntimeConfig(use_pallas=False, use_flash_attention=False))
    bodies = [BODY, dict(BODY, max_tokens=7, messages=[{"role": "user", "content": "abc"}])]
    answers = {}
    for name, server in (("jax", JAPI.GLMAPIServer(jeng, port=0, model_name="t")),
                         ("dense", GLMAPIServer(_engine("dense", tp), port=0, model_name="t")),
                         ("paged", GLMAPIServer(_engine("paged", tp), port=0, model_name="t"))):
        server.start()
        try:
            answers[name] = [_post(server, "/v1/chat/completions", b)[1]["choices"][0]
                             for b in bodies]
        finally:
            server.shutdown()
    assert answers["dense"] == answers["jax"] == answers["paged"]


# -- the two packages' servers on one scripted engine ------------------------

class _Req:
    def __init__(self, req_id, max_new_tokens):
        self.req_id, self.max_new_tokens, self.generated = req_id, max_new_tokens, []


class _Slot:
    request = None


class ScriptedEngine:
    """The engine interface the server uses, answering every request with
    ``SCRIPT`` (cut at its budget), three tokens a step, eos 2 at the end."""

    SCRIPT = [5, 1, 6, 5, 3, 7, 4, 6, 8, 2]
    eos_token_id = 2

    def __init__(self, tokenizer):
        self.tokenizer = tokenizer
        self.queue, self.finished, self.slots = [], [], [_Slot(), _Slot()]
        self.max_batch = 2
        self.stats = {"steps": 0, "generated_tokens": 0}
        self._live, self._next = {}, 0

    @property
    def has_work(self):
        return bool(self._live)

    def submit(self, prompt_ids, max_new_tokens=256, **_):
        rid = self._next
        self._next += 1
        self._live[rid] = (_Req(rid, max_new_tokens), 0)
        return rid

    def cancel(self, rid):
        if rid in self._live:
            self.finished.append(self._live.pop(rid)[0])

    sync_events = ServingEngine.sync_events  # the port's worker applies its mailbox so

    def step(self):
        self.stats["steps"] += 1
        out = []
        for rid, (req, pos) in list(self._live.items()):
            toks = self.SCRIPT[pos:min(pos + 3, req.max_new_tokens)]
            req.generated += toks
            self.stats["generated_tokens"] += len(toks)
            out.append((rid, toks))
            pos += len(toks)
            if 2 in toks or pos >= min(req.max_new_tokens, len(self.SCRIPT)):
                if req.generated[-1] == 2:
                    req.generated.pop()
                self.finished.append(self._live.pop(rid)[0])
            else:
                self._live[rid] = (req, pos)
        return out


PIECES = ["", "，", "</s>", "中", "x", "好", ",", "!", "ST"]
SCRIPTED_REQUESTS = [
    ("/v1/chat/completions", BODY, False),
    ("/v1/chat/completions", BODY, True),
    ("/v1/chat/completions", dict(BODY, stream_options={"include_usage": True}), True),
    ("/v1/completions", {"prompt": "abc", "max_tokens": 5}, False),
    ("/v1/completions", {"prompt": ["abc"], "max_tokens": 5}, True),
    ("/v1/chat/completions", dict(BODY, n=2), False),
    ("/v1/chat/completions", dict(BODY, stop="x,"), False),
    ("/v1/chat/completions", dict(BODY, stop=["x,"]), True),
    ("/v1/chat/completions", dict(BODY, max_tokens=4), False),
    ("/v1/chat/completions", {"messages": [{"role": "assistant", "content": "a"}]}, False),
]


def _scrub(obj):
    """A body without its ids and timestamps."""
    if isinstance(obj, dict):
        return {k: _scrub(v) for k, v in obj.items() if k not in ("id", "created")}
    if isinstance(obj, (list, tuple)):
        return [_scrub(v) for v in obj]
    return obj


def _bodies(module):
    tok = PieceTok(PIECES)
    tok.encode = lambda text: [3] * len(text)
    server = module.GLMAPIServer(ScriptedEngine(tok), port=0, model_name="stub")
    server.start()
    out = []
    try:
        for path, body, stream in SCRIPTED_REQUESTS:
            try:
                out.append(_sse(server, path, body) if stream else _post(server, path, body))
            except urllib.error.HTTPError as e:
                out.append((e.code, json.loads(e.read())))
        for path in ("/v1/models", "/metrics", "/health", "/nowhere"):
            try:
                with urllib.request.urlopen(_url(server, path), timeout=60) as resp:
                    data = resp.read().decode()
                    out.append((resp.status, data if path == "/metrics" else json.loads(data)))
            except urllib.error.HTTPError as e:
                out.append((e.code, json.loads(e.read())))
    finally:
        server.shutdown()
    return _scrub(out)


def test_scripted_engine_gives_jax_server_bodies():
    """One scripted engine behind each package's server: every response body
    (chat and text completions, SSE chunks with usage, n, stop strings, the
    error bodies, /v1/models, /metrics, /health, 404) is the same apart from
    ids and timestamps."""
    got, want = _bodies(API), _bodies(JAPI)
    assert got == want
    assert any(isinstance(b, list) for b in got)  # the streams were compared too

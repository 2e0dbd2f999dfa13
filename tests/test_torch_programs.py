"""The port's prefill, chunk and training programs (utils/graphs.py,
``chatglm2.prefill_program`` / ``chunk_program``, ``paged_kv.prefill_paged_program`` /
``chunk_paged_program``, ``utils/train.train_program``) on the CPU, where a
program's body runs eagerly through its static buffers.

The same numpy inputs go through the JAX package's functions and the port's
on a 2-layer narrow f32 tree made by JAX's ``init_params``: a prefill at
its power-of-two bucket against JAX's bucketed prefill (``GLMDecoder``'s
``_prefill``) at the model tests' tolerance (rtol/atol 2e-4), and against
the port's unbucketed prefill (logits and valid cache slots bit-equal on
the masked path, within 1e-6 on the plain flash path, which sums over the
call's keys in another order); the program paths
against the direct calls, padded chunk rows included; the training program
against JAX's ``make_train_step`` over 2 AdamW steps at
tests/test_torch_train.py's bounds.  Then the refusals: a gloo mesh, a
mesh's prefill programs, dropout, a non-capturable optimizer and a mesh's
training step; a scheduled lr reaching every step, and a program that
captures again where the optimizer changed."""
import copy
import dataclasses
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from chatglm_q_tpu.config import ChatGLM2Config as JConfig, TpuRuntimeConfig  # noqa: E402
from chatglm_q_tpu.models import chatglm2 as JM  # noqa: E402
from chatglm_q_tpu.serving.decoder import _bucket as jax_bucket  # noqa: E402
from chatglm_q_tpu.utils import train as JT  # noqa: E402
from chatglm_q_tpu_torch import ChatGLM2Config, GLMLoadConfig, TorchRuntimeConfig  # noqa: E402
from chatglm_q_tpu_torch.convert import params_from_numpy  # noqa: E402
from chatglm_q_tpu_torch.models import chatglm2 as TM  # noqa: E402
from chatglm_q_tpu_torch.models import paged_kv as PK  # noqa: E402
from chatglm_q_tpu_torch.parallel.sharding import Mesh  # noqa: E402
from chatglm_q_tpu_torch.serving import GLMDecoder  # noqa: E402
from chatglm_q_tpu_torch.tokenizer import ChatGLM2Tokenizer  # noqa: E402
from chatglm_q_tpu_torch.tokenizer.build import build_unigram_model  # noqa: E402
from chatglm_q_tpu_torch.utils import graphs as G  # noqa: E402
from chatglm_q_tpu_torch.utils import train as TT  # noqa: E402

TINY = dict(hidden_size=64, inner_hidden_size=128, head_hidden_size=16,
            num_multi_query_groups=2, num_attention_heads=4, num_layers=2,
            vocab_size=128, max_sequence_length=128)
JCFG, TCFG = JConfig(**TINY), ChatGLM2Config(**TINY)
JRT = TpuRuntimeConfig(use_pallas=False, use_flash_attention=False)
RTS = {"masked": TorchRuntimeConfig(),
       "flash": TorchRuntimeConfig(use_kernels=True, use_flash_attention=True)}
TOL = dict(rtol=2e-4, atol=2e-4)
F32 = torch.float32
T = 64  # cache slots

_rng = np.random.default_rng(5)
PROMPTS = [_rng.integers(1, 128, n).tolist() for n in (5, 17, 33)]
_TREES = {}


@pytest.fixture(autouse=True)
def one_thread():
    """Small models on one thread: under a run of parallel test workers an
    op split over every core's thread waits on all of them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _trees(quant):
    if quant not in _TREES:
        jp = JM.init_params(jax.random.PRNGKey(9), JCFG, quant, jnp.float32)
        _TREES[quant] = (jp, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu"))
    return _TREES[quant]


def _padded(rows, width):
    ids = np.zeros((len(rows), width), np.int32)
    for i, r in enumerate(rows):
        ids[i, :len(r)] = r
    return ids, np.array([len(r) for r in rows], np.int32)


def test_prompt_bucket_is_jax_bucket_clamped_to_the_cache():
    for n in (1, 15, 16, 17, 57, 64, 65, 129, 1000, 2049):
        assert TM.prompt_bucket(n, 8192) == jax_bucket(n)
        assert TM.prompt_bucket(n, 100) == min(jax_bucket(n), 100)


@pytest.mark.parametrize("quant", ["none", "int8", "int4g32"])
@pytest.mark.parametrize("rt_name", ["masked", "flash"])
def test_bucketed_prefill_matches_jax_and_the_unbucketed_prefill(quant, rt_name):
    """The prefill program at each prompt's bucket against JAX's prefill at
    the same bucket (GLMDecoder's), and against the port's prefill at the
    prompt's own length: logits and valid cache slots bit-equal on the
    masked path, within 1e-6 on the plain flash path."""
    jp, tp = _trees(quant)
    rt = RTS[rt_name]
    for prompt in PROMPTS:
        n = len(prompt)
        bucket = TM.prompt_bucket(n, T)
        ids, lengths = _padded([prompt], bucket)
        jc = JM.init_kv_cache(JCFG, 1, T, jnp.float32)
        want, jc = JM.prefill(jp, JCFG, jnp.asarray(ids), jnp.asarray(lengths), jc, quant,
                              jnp.float32, JRT)
        cache = TM.init_kv_cache(TCFG, 1, T, F32, device="cpu")
        prog = TM.prefill_program(tp, TCFG, cache, bucket, quant, F32, rt)
        prog.load(ids=torch.from_numpy(ids).long(), lengths=torch.from_numpy(lengths))
        got = prog.step(tp, cache.k, cache.v)["logits"]
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        for a, b in ((cache.k, jc.k), (cache.v, jc.v)):
            np.testing.assert_allclose(a[:, 0, :, :n].numpy(), np.asarray(b)[:, 0, :, :n], **TOL)
        own = TM.init_kv_cache(TCFG, 1, T, F32, device="cpu")
        ref, _ = TM.prefill(tp, TCFG, torch.tensor([prompt]), torch.tensor([n]), own, quant,
                            F32, rt)
        pairs = ((got, ref), (cache.k[:, :, :, :n], own.k[:, :, :, :n]),
                 (cache.v[:, :, :, :n], own.v[:, :, :, :n]))
        for a, b in pairs:
            if rt_name == "masked":  # scores over the cache's T slots either way
                assert torch.equal(a, b)
            else:
                # the plain flash prefill sums its softmax and PV over the
                # call's S keys (the padded ones weigh exactly 0): another f32
                # association from the first attention on
                np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6, atol=1e-6)


def _tokenizer():
    return ChatGLM2Tokenizer(build_unigram_model([f"w{i}" for i in range(100)]))


def test_decoder_prefills_one_program_a_bucket():
    """GLMDecoder.generate pads each prompt to its bucket: one prefill
    program a bucket used (a repeated bucket reuses its own),
    which the decode programs' registry does not count; the text equals the
    decoder's own on a second call (the program's buffers reloaded)."""
    tok = _tokenizer()
    cfg = dataclasses.replace(TCFG, vocab_size=512)  # the tokenizer's ids
    tp = TM.init_params(torch.Generator().manual_seed(0), cfg, "none", device="cpu")
    load = GLMLoadConfig(model_config=cfg, quant_type="none", torch_dtype="float32")
    dec = GLMDecoder(load, tp, tok, max_sequence_length=T, rt=RTS["flash"])
    before, n_decode = len(G.programs(tp, "prefill")), len(G.programs(tp))
    queries = ("w1 w2 w3", "w4 w5 w6 w7", " ".join(f"w{i}" for i in range(30)), "w1 w2 w3")
    texts = [list(dec.generate(q, max_generated_tokens=6, temperature=0.0)) for q in queries]
    buckets = {TM.prompt_bucket(len(tok.encode(q)), T) for q in queries}
    assert 2 <= len(buckets) < len(queries)
    assert len(G.programs(tp, "prefill")) - before == len(buckets)
    assert len(G.programs(tp)) == n_decode + 1  # one decode program over the kept cache
    assert texts[0] == texts[3] and all(texts)


def test_dense_engine_prefills_one_program_a_bucket_across_slots():
    """The dense engine's whole-prompt prefill is a one-row compact chunk:
    prompts of one bucket in four slots take one program, and each slot's
    greedy tokens equal those of the same prompt alone in a one-slot engine."""
    from chatglm_q_tpu_torch.serving import ServingEngine

    _, tp = _trees("none")
    load = GLMLoadConfig(model_config=TCFG, quant_type="none", torch_dtype="float32")
    prompts = [PROMPTS[0], PROMPTS[1][:12], PROMPTS[1][:9], PROMPTS[1]]  # buckets 16, 16, 16, 32
    buckets = {TM.prompt_bucket(len(p), T) for p in prompts}
    assert len(buckets) == 2

    def engine(n):
        return ServingEngine(load, tp, None, max_batch=n, max_seq_len=T, decode_chunk=4,
                             rt=RTS["flash"], device="cpu")

    before = len(G.programs(tp, "prefill"))
    got = engine(4).run(prompts, max_new_tokens=5, temperature=0.0)
    assert len(G.programs(tp, "prefill")) - before == len(buckets)
    want = [engine(1).run([p], max_new_tokens=5, temperature=0.0)[0] for p in prompts]
    assert got == want and all(len(g) == 5 for g in got)


@pytest.mark.parametrize("rt_name", ["masked", "flash"])
def test_dense_chunk_program_equals_the_direct_chunk(rt_name):
    _, tp = _trees("int4g32")
    rt = RTS[rt_name]
    ids, _ = _padded([PROMPTS[1][:8], PROMPTS[2][:8]], 8)
    starts, valid, slots = (torch.tensor(v, dtype=torch.int32) for v in ([0, 8], [8, 5], [2, 0]))
    caches = []
    for _ in range(2):
        c = TM.init_kv_cache(TCFG, 4, T, F32, device="cpu")
        c.k.normal_(generator=torch.Generator().manual_seed(1))
        c.v.normal_(generator=torch.Generator().manual_seed(2))
        c.lengths[:] = torch.tensor([8, 0, 0, 3], dtype=torch.int32)
        caches.append(c)
    want, wc = TM.prefill_chunk(tp, TCFG, torch.from_numpy(ids).long(), starts, valid, caches[0],
                                "int4g32", F32, rt, slot_map=slots)
    prog = TM.chunk_program(tp, TCFG, caches[1], 2, 8, "int4g32", F32, rt)
    prog.load(ids=torch.from_numpy(ids).long(), starts=starts, valid=valid, slot_map=slots,
              lengths=caches[1].lengths)
    out = prog.step(tp, caches[1].k, caches[1].v)
    assert torch.equal(out["logits"], want) and torch.equal(out["lengths"], wc.lengths)
    assert torch.equal(caches[0].k, caches[1].k) and torch.equal(caches[0].v, caches[1].v)


@pytest.mark.parametrize("rt_name", ["masked", "flash"])
def test_paged_programs_equal_the_direct_calls_padded_rows_included(rt_name):
    """The paged prefill program (one row through its table row) and the
    compact chunk program at 4 rows, the last a padding row on the garbage
    table at valid 0: equal to the direct calls, and the padding row writes
    the garbage page alone."""
    _, tp = _trees("int8")
    rt = RTS[rt_name]
    P, NP = 8, 16

    def pool():
        c = PK.init_paged_kv_cache(TCFG, 4, NP, T, P, F32, device="cpu")
        c.k_pool.normal_(generator=torch.Generator().manual_seed(3))
        c.v_pool.normal_(generator=torch.Generator().manual_seed(4))
        return c

    table = torch.zeros((4, T // P), dtype=torch.int32)
    table[0, :3], table[1, :3], table[2, :3] = (torch.tensor(v) for v in
                                                ([1, 2, 3], [4, 5, 6], [7, 8, 9]))
    # whole-prompt admission of row 1 at bucket 16
    ids, lengths = _padded([PROMPTS[0]], 16)
    a, b = pool(), pool()
    sub = PK.PagedKVCache(a.k_pool, a.v_pool, table[1:2], torch.zeros(1, dtype=torch.int32))
    want, _ = PK.prefill_paged(tp, TCFG, torch.from_numpy(ids).long(), torch.from_numpy(lengths),
                               sub, "int8", F32, rt)
    prog = PK.prefill_paged_program(tp, TCFG, b, 1, 16, "int8", F32, rt)
    prog.load(ids=torch.from_numpy(ids).long(), lengths=torch.from_numpy(lengths),
              page_table=table[1:2])
    got = prog.step(tp, b.k_pool, b.v_pool)["logits"]
    assert torch.equal(got, want)
    assert torch.equal(a.k_pool, b.k_pool) and torch.equal(a.v_pool, b.v_pool)
    # a compact chunk of three real rows and a padding row
    ids, _ = _padded([PROMPTS[2][:8], PROMPTS[1][:8], PROMPTS[0][:5], []], 8)
    starts = torch.tensor([0, 8, 0, 0], dtype=torch.int32)
    valid = torch.tensor([8, 8, 5, 0], dtype=torch.int32)
    a, b = pool(), pool()
    sub = PK.PagedKVCache(a.k_pool, a.v_pool, table, starts)
    want, wc = PK.prefill_chunk_paged(tp, TCFG, torch.from_numpy(ids).long(), starts, valid, sub,
                                      "int8", F32, rt)
    prog = PK.chunk_paged_program(tp, TCFG, b, 4, 8, "int8", F32, rt)
    before = b.k_pool.clone()
    prog.load(ids=torch.from_numpy(ids).long(), starts=starts, valid=valid, page_table=table)
    out = prog.step(tp, b.k_pool, b.v_pool)
    assert torch.equal(out["logits"], want) and torch.equal(out["lengths"], wc.lengths)
    assert torch.equal(a.k_pool, b.k_pool) and torch.equal(a.v_pool, b.v_pool)
    assert torch.isfinite(out["logits"]).all()
    touched = (b.k_pool != before).flatten(2).any(-1).any(0)  # pages written
    assert set(torch.nonzero(touched).flatten().tolist()) <= {0, 1, 4, 5, 7}


def _step_inputs():
    rng = np.random.default_rng(11)
    ids = rng.integers(0, TINY["vocab_size"], (2, 12)).astype(np.int32)
    labels = ids.copy()
    labels[:, :3] = -100
    return ids, labels


@pytest.mark.parametrize("quant", ["int8", "int4g32"])
def test_training_program_matches_jax_and_the_eager_step(quant):
    """Two AdamW steps of the training program (its body eager on the CPU,
    through static ids/labels) against JAX's jitted ``make_train_step`` (the
    loss 1e-5 relative, leaves 1e-5), and bit-equal to ``make_train_step``
    and to the step written out eagerly (``loss_and_grads``, the optimizer's
    step, ``zero_grad``)."""
    jp, tp = _trees(quant)
    ids, labels = _step_inputs()
    hyper = dict(lr=1e-2, b1=0.9, b2=0.999, eps=1e-8, wd=0.05)
    jopt = optax.adamw(hyper["lr"], b1=hyper["b1"], b2=hyper["b2"], eps=hyper["eps"],
                       weight_decay=hyper["wd"])
    jtr, jfr = JT.partition_params(jp)
    jstep = jax.jit(JT.make_train_step(JCFG, quant, jopt, jnp.float32, JRT))
    state = jopt.init(jtr)
    jlosses = []
    for _ in range(2):
        jtr, state, jl = jstep(jtr, jfr, state, jnp.asarray(ids), jnp.asarray(labels))
        jlosses.append(float(jl))
    rt = TorchRuntimeConfig(use_kernels=False)
    runs = {}
    for kind in ("program", "make_train_step", "eager"):
        tr, fr = TT.partition_params(tp)
        opt = torch.optim.AdamW(TT.trainable_leaves(tr), lr=hyper["lr"],
                                betas=(hyper["b1"], hyper["b2"]), eps=hyper["eps"],
                                weight_decay=hyper["wd"])
        losses = []
        if kind == "program":
            prog = TT.train_program(TCFG, quant, opt, tr, fr, ids.shape, torch.long, F32, rt)
            for _ in range(2):
                prog.load(ids=torch.from_numpy(ids), labels=torch.from_numpy(labels))
                losses.append(prog.step(tr, fr)["loss"].clone())
        elif kind == "make_train_step":
            step = TT.make_train_step(TCFG, quant, opt, F32, rt)
            losses = [step(tr, fr, torch.from_numpy(ids), torch.from_numpy(labels))
                      for _ in range(2)]
        else:
            losses = [_eager_step(TCFG, quant, opt, tr, fr, ids, labels, rt) for _ in range(2)]
        assert all(t.grad is None for t in TT.trainable_leaves(tr))  # zero_grad
        runs[kind] = (tr, losses)
    for got, want in zip(runs["program"][1], jlosses):
        np.testing.assert_allclose(float(got), want, rtol=1e-5)
    jleaves = dict(_dotted(jtr))
    for path, leaf in _dotted(runs["program"][0]):
        np.testing.assert_allclose(leaf.detach().numpy(), np.asarray(jleaves[path]), rtol=0,
                                   atol=1e-5)
    for kind in ("make_train_step", "eager"):
        assert [float(x) for x in runs["program"][1]] == [float(x) for x in runs[kind][1]]
        for a, b in zip(TT.trainable_leaves(runs["program"][0]),
                        TT.trainable_leaves(runs[kind][0])):
            assert torch.equal(a, b)


def _eager_step(cfg, quant, opt, tr, fr, ids, labels, rt, generator=None):
    """One training step written out eagerly: the reference of the step
    programs."""
    loss, grads = TT.loss_and_grads(cfg, quant, tr, fr, torch.from_numpy(ids),
                                    torch.from_numpy(labels), F32, rt, generator)
    for leaf, grad in zip(TT.trainable_leaves(tr), grads):
        leaf.grad = grad
    opt.step()
    opt.zero_grad(set_to_none=True)
    return loss


@pytest.mark.parametrize("lr", ["float", "tensor"])
def test_a_scheduled_lr_reaches_every_step(lr):
    """``make_train_step`` under a ``LambdaLR`` stepped between calls (a
    float lr, or a tensor one that the scheduler fills in place) equals the
    eager step under the same schedule over 4 steps, and the lr moved."""
    _, tp = _trees("int4g32")
    ids, labels = _step_inputs()
    rt = TorchRuntimeConfig(use_kernels=False)
    runs = {}
    for kind in ("make_train_step", "eager"):
        tr, fr = TT.partition_params(tp)
        opt = torch.optim.AdamW(TT.trainable_leaves(tr), weight_decay=0.05,
                                lr=1e-2 if lr == "float" else torch.tensor(1e-2))
        sched = torch.optim.lr_scheduler.LambdaLR(opt, lambda i: 1.0 / (1 + 3 * i))
        step = TT.make_train_step(TCFG, "int4g32", opt, F32, rt)
        losses = []
        for _ in range(4):
            if kind == "eager":
                losses.append(float(_eager_step(TCFG, "int4g32", opt, tr, fr, ids, labels, rt)))
            else:
                losses.append(float(step(tr, fr, torch.from_numpy(ids),
                                         torch.from_numpy(labels))))
            sched.step()
        runs[kind] = (losses, TT.trainable_leaves(tr))
        assert float(opt.param_groups[0]["lr"]) == pytest.approx(1e-2 / 13)
    assert runs["make_train_step"][0] == runs["eager"][0]
    for a, b in zip(runs["make_train_step"][1], runs["eager"][1]):
        assert torch.equal(a, b)


def test_the_optimizer_guard_sees_what_a_capture_bakes_in():
    """``optimizer_guard`` reads otherwise after a scheduler sets a float
    lr or ``load_state_dict`` swaps the state, and the same after a step
    (the state updates in place) or a tensor lr filled in place."""
    w = torch.zeros(3, requires_grad=True)  # (capturable=True wants the card)
    opt = torch.optim.AdamW([w], lr=1e-2)
    w.grad = torch.ones(3)
    opt.step()
    g0 = TT.optimizer_guard(opt)
    opt.step()
    assert TT.optimizer_guard(opt) == g0
    sched = torch.optim.lr_scheduler.LambdaLR(opt, lambda i: 0.5 ** i)
    g1 = TT.optimizer_guard(opt)  # the scheduler adds initial_lr
    opt.step()
    assert TT.optimizer_guard(opt) == g1
    sched.step()
    assert TT.optimizer_guard(opt) != g1
    g2 = TT.optimizer_guard(opt)
    opt.load_state_dict(copy.deepcopy(opt.state_dict()))  # as a resumed run loads it
    assert TT.optimizer_guard(opt) != g2  # new state tensors
    t = torch.optim.AdamW([w], lr=torch.tensor(1e-2))
    sched = torch.optim.lr_scheduler.LambdaLR(t, lambda i: 0.5 ** i)
    t.step()
    g3 = TT.optimizer_guard(t)
    sched.step()
    assert t.param_groups[0]["lr"].item() == pytest.approx(5e-3)
    assert TT.optimizer_guard(t) == g3


def test_a_step_program_captures_again_where_its_guard_reads_otherwise(monkeypatch):
    """The program logic on the CPU, with a stand-in for the CUDA graph: a
    guard that changes drops the capture, says why once, and captures
    again before the replay; an unchanged guard replays."""
    seen = {"v": 0}

    class Graph:
        def __init__(self, v):
            self.v = v

        def replay(self):
            seen.setdefault("replayed", []).append(self.v)

    def capture(prog, args):
        seen.setdefault("dropped_after", []).append(prog.graph)  # the old graph lives on
        prog.guarded = prog.guard()
        prog.graph = Graph(prog.guarded)
        prog._registry.captures += 1

    monkeypatch.setattr(G.StepProgram, "_capture", capture)
    reg = G.Programs()
    prog = G.StepProgram("guarded", lambda inp: {}, {}, True, reg, guard=lambda: seen["v"])
    G._SAID.discard(G.RECAPTURE_NOTE)
    prog.step()  # eager warm-up
    prog.step()  # capture, replay
    prog.step()  # replay
    assert reg.captures == 1 and seen["replayed"] == [0, 0]
    seen["v"] = 1
    with pytest.warns(RuntimeWarning, match="captured again"):
        prog.step()
    assert reg.captures == 2 and seen["replayed"] == [0, 0, 1]
    seen["v"] = 2
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # said once
        prog.step()
    assert reg.captures == 3 and seen["replayed"] == [0, 0, 1, 2]
    assert [g and g.v for g in seen["dropped_after"]] == [None, 0, 1]


def _dotted(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _dotted(v, prefix + k + ".")
        elif v is not None:
            yield prefix + k, v


def test_where_the_new_programs_refuse_capture():
    cuda = torch.device("cuda")
    gloo, nccl = object.__new__(Mesh), object.__new__(Mesh)
    nccl.backend = "nccl"
    flash = RTS["flash"]
    # a gloo mesh refuses every program; NCCL's decode programs capture
    assert G.refusal(TorchRuntimeConfig(mesh=gloo), cuda) == G.MESH_REFUSAL
    assert G.refusal(TorchRuntimeConfig(mesh=nccl), cuda) is None
    assert G.mesh_prefill_refusal(TorchRuntimeConfig(mesh=nccl)) == G.MESH_PREFILL_REFUSAL
    assert G.mesh_prefill_refusal(flash) is None
    with pytest.warns(RuntimeWarning, match="prefill and chunk programs run eagerly"):
        G._SAID.discard(G.MESH_PREFILL_REFUSAL)
        assert not G.capture_enabled(TorchRuntimeConfig(mesh=nccl), cuda,
                                     G.mesh_prefill_refusal(TorchRuntimeConfig(mesh=nccl)))
    # the training step: dropout and a non-capturable optimizer run eagerly
    w = torch.zeros(3, requires_grad=True)
    drop = dataclasses.replace(TCFG, dropout_rate=0.1)
    capt = torch.optim.AdamW([w], capturable=True)
    assert TT.step_refusal(TCFG, capt, None) is None
    assert TT.step_refusal(drop, capt, torch.Generator()) == G.DROPOUT_REFUSAL
    assert TT.step_refusal(drop, capt, None) is None  # no generator: no dropout
    assert TT.step_refusal(TCFG, torch.optim.AdamW([w]), None) == G.OPTIMIZER_REFUSAL
    assert TT.step_refusal(TCFG, capt, None, gloo) == G.MESH_TRAIN_REFUSAL
    with pytest.warns(RuntimeWarning, match="dropout runs eagerly"):
        G._SAID.discard(G.DROPOUT_REFUSAL)
        assert not G.capture_enabled(flash, cuda, G.DROPOUT_REFUSAL)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert G.capture_enabled(flash, cuda, TT.step_refusal(TCFG, capt, None))


def test_a_dropout_training_program_runs_eagerly_with_the_eager_masks():
    """With dropout the program is refused capture and its body draws the
    masks from the generator as the eager step does: the same losses from
    the same seed."""
    _, tp = _trees("int4g32")
    cfg = dataclasses.replace(TCFG, dropout_rate=0.2)
    ids, labels = _step_inputs()
    rt = TorchRuntimeConfig(use_kernels=False)
    out = []
    for kind in ("program", "eager"):
        tr, fr = TT.partition_params(tp)
        opt = torch.optim.AdamW(TT.trainable_leaves(tr), lr=1e-2, capturable=False)
        gen = torch.Generator().manual_seed(21)
        if kind == "program":
            prog = TT.train_program(cfg, "int4g32", opt, tr, fr, ids.shape, torch.long, F32, rt,
                                    gen)
            assert not prog.capture
            losses = []
            for _ in range(2):
                prog.load(ids=torch.from_numpy(ids), labels=torch.from_numpy(labels))
                losses.append(float(prog.step(tr, fr)["loss"]))
        else:
            step = TT.make_train_step(cfg, "int4g32", opt, F32, rt)
            losses = [float(step(tr, fr, torch.from_numpy(ids), torch.from_numpy(labels), gen))
                      for _ in range(2)]
        out.append(losses)
    assert out[0] == out[1]

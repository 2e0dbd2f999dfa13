"""Rank functions of the port's tensor-parallel CPU tests.

``chatglm_q_tpu_torch.utils.distributed.run_spmd`` spawns the ranks and
runs one of these on each; they import torch and the port only (never jax,
nor a test module, which imports jax), take their inputs as numpy arrays
and return numpy arrays.  Each runs every case of one test module in one
process group, so a module spawns its ranks once.
"""
import time

import numpy as np
import torch


def _mesh(nd, nm):
    from chatglm_q_tpu_torch.parallel import sharding as SH

    torch.set_num_threads(2)
    return SH.make_mesh(nd, nm)


def _t(a):
    from chatglm_q_tpu_torch.convert import tensor_from_numpy

    return tensor_from_numpy(a, "cpu")


def _np(t):
    return t.detach().float().numpy() if t.is_floating_point() else t.numpy()


def _rt(mesh, **kw):
    from chatglm_q_tpu_torch import TorchRuntimeConfig

    return TorchRuntimeConfig(use_kernels=True, use_flash_attention=True, mesh=mesh, **kw)


# ---------------------------------------------------------------------------
# tests/test_torch_parallel.py
# ---------------------------------------------------------------------------

def _linear(mesh, x, p, quant, mode, dyn=False):
    """The rank's part of a tp_quant_linear: col → its output columns (an
    equal split of N), row → the whole output from its K slice, rep → the
    whole output; a refused call → its message."""
    from chatglm_q_tpu_torch.parallel import sharding as SH
    from chatglm_q_tpu_torch.parallel.tp_linear import tp_quant_linear

    tp, m = mesh.n_model, mesh.model_index
    p = {k: _t(v) for k, v in p.items()}
    x = _t(x)
    if mode == "col":
        N = p["weight"].shape[-1]
        p = SH.shard_cols(p, m * N // tp, (m + 1) * N // tp)
    elif mode == "row":
        b = SH.row_bounds(p, quant, tp)
        p = SH.shard_rows(p, b[m], b[m + 1], quant)
        x = x[:, min(b[m], x.shape[1]):min(b[m + 1], x.shape[1])]
    try:
        return _np(tp_quant_linear(x, p, quant, _rt(mesh, dynamic_int8=dyn), mode))
    except ValueError as e:
        return str(e)


def _ring(mesh, q, k, v, lengths):
    from chatglm_q_tpu_torch.parallel.ring_attention import ring_attention

    S_loc = q.shape[1] // mesh.n_model
    mine = slice(mesh.model_index * S_loc, (mesh.model_index + 1) * S_loc)
    return _np(ring_attention(_t(q)[:, mine], _t(k)[:, mine], _t(v)[:, mine], _t(lengths),
                              mesh))


def _kv_tsharded(mesh, q, k, v, lengths, sm_scale):
    from chatglm_q_tpu_torch.ops import attention as A

    Tl = k.shape[2] // mesh.n_model
    mine = slice(mesh.model_index * Tl, (mesh.model_index + 1) * Tl)
    return _np(A.flash_attention_decode_kv_tsharded(
        _t(q), _t(k)[:, :, mine].contiguous(), _t(v)[:, :, mine].contiguous(), _t(lengths),
        sm_scale, mesh))


def _paged_msharded(mesh, q, k_pool, v_pool, page_table, lengths, layer, sm_scale):
    from chatglm_q_tpu_torch.ops import attention as A

    n = mesh.n_data * mesh.n_model
    sp = k_pool.shape[1] // n
    base = (mesh.data_index * mesh.n_model + mesh.model_index) * sp
    kp = _t(k_pool)[:, base:base + sp].contiguous()
    vp = _t(v_pool)[:, base:base + sp].contiguous()
    rows = slice(mesh.data_index * q.shape[0] // mesh.n_data,
                 (mesh.data_index + 1) * q.shape[0] // mesh.n_data)
    table = A.msharded_page_table(_t(page_table)[rows], mesh, sp)
    return _np(A.flash_attention_decode_paged_msharded(
        _t(q)[rows], kp, vp, layer, table, _t(lengths)[rows], sm_scale, mesh))


def _model(mesh, tree, cfg, quant, ids, lengths, tokens, kv_shard_t):
    """The tensor-parallel model's logits (steps + 1, B / n_data, V): prefill
    of ``ids`` (B, S), then a decode step on each row of ``tokens`` (steps,
    B), on the rank's shard of the tree and of the cache (the data rank's
    rows)."""
    from chatglm_q_tpu_torch import ChatGLM2Config
    from chatglm_q_tpu_torch.convert import params_from_numpy
    from chatglm_q_tpu_torch.models import chatglm2 as M
    from chatglm_q_tpu_torch.parallel import sharding as SH

    cfg = ChatGLM2Config(**cfg)
    params = SH.shard_params(params_from_numpy(tree, "cpu"), mesh, cfg, quant)
    rt = _rt(mesh, kv_shard_t=kv_shard_t)
    B = ids.shape[0]
    rows = slice(mesh.data_index * B // mesh.n_data, (mesh.data_index + 1) * B // mesh.n_data)
    shape = SH.kv_cache_shape(cfg, mesh, B, cfg.max_sequence_length, kv_shard_t)
    cache = M.KVCache(torch.zeros(shape), torch.zeros(shape),
                      torch.zeros((shape[1],), dtype=torch.int32))
    logits, cache = M.prefill(params, cfg, _t(ids)[rows].long(), _t(lengths)[rows], cache,
                              quant, torch.float32, rt)
    out = [_np(logits)]
    for tok in tokens:
        logits, cache = M.decode_step(params, cfg, _t(tok)[rows], cache, quant, torch.float32,
                                      rt)
        out.append(_np(logits))
    return np.stack(out)


def _collectives(mesh, x):
    """Each collective of the mesh on a bf16 and an int32 tensor that differ
    by rank (the engines move bf16 logits, q and K/V, int32 tokens)."""
    r = mesh.rank
    out = {}
    for name, t in (("bf16", (_t(x) + r).to(torch.bfloat16)),
                    ("int32", torch.arange(6, dtype=torch.int32).reshape(2, 3) + 10 * r)):
        out[name] = dict(gather=_np(mesh.all_gather(t, "model")),
                         broadcast=_np(mesh.broadcast(t, mesh.n_model - 1, "model")),
                         ring=_np(mesh.ring_shift(t, "model")),
                         sum=_np(mesh.all_reduce(t, "model")),
                         max=_np(mesh.all_reduce(t, "model", "max")),
                         dtypes=[str(mesh.all_gather(t, "model").dtype),
                                 str(mesh.all_reduce(t, "model").dtype)])
    return out


PARALLEL = {"collectives": _collectives, "linear": _linear, "ring": _ring,
            "kv_tsharded": _kv_tsharded, "paged_msharded": _paged_msharded, "model": _model}


def parallel_cases(rank, nd, nm, cases):
    """{name: (kind, kwargs)} → {name: this rank's result}."""
    mesh = _mesh(nd, nm)
    return {name: PARALLEL[kind](mesh, **kw) for name, (kind, kw) in cases.items()}


# ---------------------------------------------------------------------------
# tests/test_torch_dist_engine.py
# ---------------------------------------------------------------------------

def _pages_local(eng):
    """Every admitted slot's page j lies in its group's sub-pool of phase
    j % n_phase, and none is a garbage page."""
    for slot, pages in eng._slot_pages.items():
        g = eng._slot_group(slot)
        for jj, p in enumerate(pages):
            if p // eng._sub_pages != g * eng._n_phase + jj % eng._n_phase or \
                    p % eng._sub_pages == 0:
                return False
    return True


def engine_cases(rank, tree, cfg, quant, meshes):
    """``meshes``: [(n_data, n_model, cases)], every mesh of the same world
    built in turn over one process group; cases {name: (engine, kwargs,
    batches of prompts, submit kwargs)} → {name: {tokens per request in
    submission order, pages in use after the drain, the data groups of the
    last batch's admitted slots, page locality, speculation stats}}: each
    distributed engine on the rank's shard, each batch submitted through
    rank 0's ``sync_submissions`` (one kwargs dict) or ``sync_events`` (a
    list: each prompt its own kwargs) and drained before the next.  Engine
    "server": ``_server_case``."""
    out = {}
    for nd, nm, cases in meshes:
        out.update(_engine_cases(rank, _mesh(nd, nm), tree, cfg, quant, cases))
    return out


def _engine_cases(rank, mesh, tree, cfg, quant, cases):
    from chatglm_q_tpu_torch import ChatGLM2Config, GLMLoadConfig
    from chatglm_q_tpu_torch.convert import params_from_numpy
    from chatglm_q_tpu_torch.parallel import sharding as SH
    from chatglm_q_tpu_torch.serving import (DistributedPagedServingEngine,
                                             DistributedServingEngine)

    cfg = ChatGLM2Config(**cfg)
    load = GLMLoadConfig(model_config=cfg, quant_type=quant, torch_dtype="float32")
    params = SH.shard_params(params_from_numpy(tree, "cpu"), mesh, cfg, quant)
    out = {}
    for name, (engine, kw, batches, sub_kw) in cases.items():
        kw = dict(kw)
        rt = _rt(None, **kw.pop("rt", {}))
        if engine == "server":
            out[name] = _server_case(rank, load, params, mesh, rt, kw, batches, sub_kw)
            continue
        cls = DistributedPagedServingEngine if engine == "paged" else DistributedServingEngine
        eng = cls(load, params, mesh=mesh, rt=rt, device="cpu", **kw)
        res = {"local": True}
        for batch in batches:
            if isinstance(sub_kw, list):
                eng.sync_events([("submit", p, k) for p, k in zip(batch, sub_kw)]
                                if rank == 0 else None)
            else:
                eng.sync_submissions(batch if rank == 0 else None, **sub_kw)
            eng._admit()
            res["groups"] = sorted(eng._shard_of(i) for i, s in enumerate(eng.slots)
                                   if s.request)
            steps = 0
            while eng.has_work:
                eng.step()
                if engine == "paged":
                    res["local"] &= _pages_local(eng)
                steps += 1
                if steps > 300:
                    raise RuntimeError(f"{name}: the engine did not drain")
        by_id = {r.req_id: r.generated for r in eng.finished}
        res["tokens"] = [by_id[i] for i in sorted(by_id)]
        res["pages_in_use"] = getattr(eng, "pages_in_use", None)
        res["prefix_hits"] = eng.stats.get("prefix_hits")
        res["spec_accepted"] = eng.stats.get("spec_accepted")
        res["spec_steps"] = eng.stats.get("spec_steps")
        res["dtypes"] = (str(eng.dtype), str(eng.kv_dtype))
        out[name] = res
    return out


class StubTokenizer:
    """Char-level codec over a small vocabulary: ids are codepoints mod the
    vocabulary, decoded onto a CJK page (so every id is valid text)."""

    BASE = 0x4E00

    def __init__(self, vocab):
        self.vocab = vocab

    def encode(self, text):
        return [ord(c) % self.vocab for c in text]

    def decode(self, ids):
        return "".join(chr(self.BASE + int(i)) for i in ids)

    def __getitem__(self, piece):
        assert piece == "</s>"
        return 2


def _http(server, path, body, stream=False):
    """A POST's parsed JSON body, or the SSE stream's (deltas, finish
    reason)."""
    import json
    import urllib.request

    req = urllib.request.Request(f"http://{server.host}:{server.port}{path}",
                                 data=json.dumps(dict(body, stream=stream)).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as resp:
        if not stream:
            return json.loads(resp.read())
        deltas, reason = [], None
        for raw in resp:
            line = raw.decode().strip()
            if not line.startswith("data: {"):
                continue
            choice = json.loads(line[6:])["choices"][0]
            reason = choice.get("finish_reason") or reason
            deltas.append(choice["delta"].get("content", ""))
        return deltas, reason


def _disconnect(server, body):
    """Open an SSE chat, read until its first token's chunk, and close the
    socket: the server's next writes fail and it cancels the request."""
    import json
    import socket

    data = json.dumps(dict(body, stream=True)).encode()
    with socket.create_connection((server.host, server.port), timeout=60) as sock:
        sock.sendall(b"POST /v1/chat/completions HTTP/1.1\r\nHost: x\r\n"
                     b"Content-Type: application/json\r\nContent-Length: "
                     + str(len(data)).encode() + b"\r\n\r\n" + data)
        seen = b""
        while seen.count(b"data: ") < 2:  # the role chunk, then a token's
            chunk = sock.recv(4096)
            if not chunk:
                break
            seen += chunk


def _server_case(rank, load, params, mesh, rt, kw, batches, sub_kw):
    """The API server over a distributed engine: on rank 0 ``GLMAPIServer``
    (rank ≥ 1 runs ``follow``).  First the engine's own greedy text of the
    chat prompt (every rank, in lockstep), then over HTTP: a chat, the same
    streamed, a stop string, n = 2 and a client that disconnects
    mid-stream.  Rank 0 returns the answers and its stats, the other ranks
    the events they applied and their stats."""
    from chatglm_q_tpu_torch.serving import DistributedPagedServingEngine, GLMAPIServer
    from chatglm_q_tpu_torch.serving.api_server import _messages_to_prompt, follow
    from chatglm_q_tpu_torch.serving.chat import process_response

    tok = StubTokenizer(load.model_config.vocab_size)
    eng = DistributedPagedServingEngine(load, params, tok, mesh=mesh, rt=rt, device="cpu", **kw)
    messages = [{"role": "user", "content": batches[0]}]
    greedy = dict(max_new_tokens=sub_kw["max_tokens"], temperature=0.0)
    eng.sync_submissions([_messages_to_prompt(messages)] if rank == 0 else None, **greedy)
    while eng.has_work:
        eng.step()
    want = process_response(tok.decode(eng.finished[-1].generated))
    eng.finished.clear()
    if rank != 0:
        events = follow(eng)
        return {"want": want, "stats": dict(eng.stats),
                "events": [(e[0], int(e[1]) if e[0] == "cancel" else None, res)
                           for e, res in events],
                "failed": _failing_worker(rank, eng, tok.encode(batches[0]), greedy)}
    server = GLMAPIServer(eng, port=0, model_name="tiny")
    body = dict(sub_kw, model="tiny", messages=messages, temperature=0.0)
    server.start()
    try:
        res = {"want": want, "chat": _http(server, "/v1/chat/completions", body)}
        res["stream"] = _http(server, "/v1/chat/completions", body, stream=True)
        stop = want[2:4]
        res["stop_string"] = stop
        res["stop"] = _http(server, "/v1/chat/completions", dict(body, stop=stop))
        res["stop_stream"] = _http(server, "/v1/chat/completions", dict(body, stop=stop),
                                   stream=True)
        res["n2"] = _http(server, "/v1/chat/completions", dict(body, n=2))
        _disconnect(server, dict(body, max_tokens=batches[1]))
        for _ in range(600):  # until the server has retired the request
            if not eng.has_work and not server.worker._events:
                break
            time.sleep(0.05)
    finally:
        server.shutdown()
        server.worker.join(timeout=60)
    res["stats"] = dict(eng.stats)
    res["failed"] = _failing_worker(rank, eng, tok.encode(batches[0]), greedy)
    return res


def _failing_worker(rank, eng, prompt, greedy):
    """Rank 0's ``EngineWorker`` whose first step raises after the ranks
    stepped together, rank 1 ``follow``-ing it: the worker closes its
    stream and hands the followers the stop, so ``follow`` returns.
    Returns rank 0's stream end and finish reason, rank 1's events."""
    from chatglm_q_tpu_torch.serving.api_server import _DONE, EngineWorker, follow

    if rank != 0:
        return {"events": [e[0] for e, _ in follow(eng)]}
    step = eng.step

    def failing():
        step()
        raise RuntimeError("rank 0 fell over")

    eng.step = failing
    worker = EngineWorker(eng)
    worker.start()
    rid, events = worker.submit(prompt, **greedy)
    while events.get(timeout=60) is not _DONE:
        pass
    worker.join(timeout=60)
    return {"reason": worker.finish_reason(rid), "alive": worker.is_alive()}


# ---------------------------------------------------------------------------
# tests/test_torch_tp_train.py
# ---------------------------------------------------------------------------

def _dotted(tree, prefix=""):
    """{dotted key path: leaf} of a nested dict, None leaves left out, in
    ``utils.train.trainable_leaves`` order."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_dotted(v, prefix + k + "."))
        elif v is not None:
            out[prefix + k] = v
    return out


def _train_setup(mesh, tree, cfg, quant, **cfg_kw):
    from chatglm_q_tpu_torch import ChatGLM2Config
    from chatglm_q_tpu_torch.convert import params_from_numpy
    from chatglm_q_tpu_torch.parallel import sharding as SH
    from chatglm_q_tpu_torch.utils import train as T

    cfg = ChatGLM2Config(**{**cfg, **cfg_kw})
    params = SH.shard_params(params_from_numpy(tree, "cpu"), mesh, cfg, quant)
    return (cfg,) + T.partition_params(params)


def _train_rt(**kw):
    from chatglm_q_tpu_torch import TorchRuntimeConfig

    return TorchRuntimeConfig(use_kernels=True, **kw)


def _rows(mesh, a):
    from chatglm_q_tpu_torch.utils.distributed import local_batch_slice

    return _t(a)[local_batch_slice(a.shape[0], mesh.n_data, mesh.data_index)].long()


def _tp_forward(mesh, tree, cfg, quant, ids, labels):
    """The mesh's parity forward on the data rank's rows: the loss (the
    global mean), the rows' logits, and the control: the mean over this
    rank's valid labels alone."""
    import dataclasses

    from chatglm_q_tpu_torch.models import chatglm2 as M
    from chatglm_q_tpu_torch.utils import train as T

    cfg, tr, fr = _train_setup(mesh, tree, cfg, quant)
    rt = dataclasses.replace(_train_rt(), mesh=mesh)
    loss, logits = M.forward(T.merge_params(tr, fr), cfg, _rows(mesh, ids),
                             labels=_rows(mesh, labels), quant_type=quant, rt=rt)
    own_mean = M.cross_entropy_loss(logits, _rows(mesh, labels))
    return {"loss": float(loss), "logits": _np(logits), "own_mean": float(own_mean)}


def _tp_grads(mesh, tree, cfg, quant, ids, labels, remat=False, seed=None, **cfg_kw):
    """``loss_and_grads`` over the mesh (the rank's part of each trainable
    leaf's gradient); with ``seed`` under dropout from that generator."""
    from chatglm_q_tpu_torch.utils import train as T

    cfg, tr, fr = _train_setup(mesh, tree, cfg, quant, **cfg_kw)
    gen = None if seed is None else torch.Generator().manual_seed(seed)
    loss, grads = T.loss_and_grads(cfg, quant, tr, fr, _t(ids).long(), _t(labels).long(),
                                   torch.float32, _train_rt(remat_layers=remat), gen, mesh)
    return {"loss": float(loss), "grads": dict(zip(_dotted(tr), [_np(g) for g in grads]))}


def _tp_grads_unsummed(mesh, tree, cfg, quant, ids, labels):
    """The control: the gradients with no sum over the model axis."""
    from chatglm_q_tpu_torch.utils import train as T

    keep, T.MODEL_PARTIAL = T.MODEL_PARTIAL, ()
    try:
        return _tp_grads(mesh, tree, cfg, quant, ids, labels)
    finally:
        T.MODEL_PARTIAL = keep


def _tp_gather_summed(mesh, tree, cfg, quant, ids, labels):
    """The control: ``gather_from_model`` whose backward sums the gradient
    over the model axis before it takes the rank's columns (what
    ``torch.distributed.nn``'s all-gather does)."""
    from chatglm_q_tpu_torch.parallel import autograd_ops as AO

    keep = AO.own_columns
    AO.own_columns = lambda m, g: keep(m, m.all_reduce(g.contiguous(), "model"))
    try:
        return _tp_grads(mesh, tree, cfg, quant, ids, labels)
    finally:
        AO.own_columns = keep


def _tp_sgd(mesh, tree, cfg, quant, ids, labels, steps=2, lr=1e-2):
    """``steps`` SGD steps of ``make_train_step`` over the mesh: the losses,
    the rank's updated trainable leaves, and whether every frozen leaf is
    bit-unchanged."""
    from chatglm_q_tpu_torch.utils import train as T

    cfg, tr, fr = _train_setup(mesh, tree, cfg, quant)
    before = {k: v.clone() for k, v in _dotted(fr).items()}
    opt = torch.optim.SGD(T.trainable_leaves(tr), lr=lr)
    step = T.make_train_step(cfg, quant, opt, torch.float32, _train_rt(), mesh)
    losses = [float(step(tr, fr, _t(ids).long(), _t(labels).long())) for _ in range(steps)]
    return {"losses": losses, "leaves": {k: _np(v) for k, v in _dotted(tr).items()},
            "frozen_unchanged": all(torch.equal(v, before[k]) for k, v in _dotted(fr).items())}


def _tp_past(mesh, tree, cfg, quant, ids, split):
    """The data rank's rows: a prefix with ``return_kv``, then the rest over
    ``past_key_values``; the second call's logits."""
    import dataclasses

    from chatglm_q_tpu_torch.models import chatglm2 as M
    from chatglm_q_tpu_torch.utils import train as T

    cfg, tr, fr = _train_setup(mesh, tree, cfg, quant)
    rt = dataclasses.replace(_train_rt(), mesh=mesh)
    params, x = T.merge_params(tr, fr), _rows(mesh, ids)
    _, _, kv = M.forward(params, cfg, x[:, :split], quant_type=quant, rt=rt, return_kv=True)
    _, logits, _ = M.forward(params, cfg, x[:, split:], quant_type=quant, rt=rt,
                             past_key_values=kv)
    return _np(logits)


TP_TRAIN = {"forward": _tp_forward, "grads": _tp_grads, "grads_unsummed": _tp_grads_unsummed,
            "gather_summed": _tp_gather_summed, "sgd": _tp_sgd, "past": _tp_past}


def tp_train_cases(rank, nd, nm, cases):
    """{name: (kind, kwargs)} → (data index, model index, {name: result})."""
    mesh = _mesh(nd, nm)
    return (mesh.data_index, mesh.model_index,
            {name: TP_TRAIN[kind](mesh, **kw) for name, (kind, kw) in cases.items()})


# ---------------------------------------------------------------------------
# tests/test_torch_pipeline.py
# ---------------------------------------------------------------------------

def _pp_setup(mesh, tree, cfg):
    from chatglm_q_tpu_torch import ChatGLM2Config
    from chatglm_q_tpu_torch.convert import params_from_numpy
    from chatglm_q_tpu_torch.parallel import pipeline as PP

    return ChatGLM2Config(**cfg), PP.shard_layers(params_from_numpy(tree, "cpu"), mesh)


def _pp_forward(mesh, tree, cfg, quant, ids, labels, n_micro):
    from chatglm_q_tpu_torch.parallel import pipeline as PP

    cfg, params = _pp_setup(mesh, tree, cfg)
    with torch.no_grad():
        loss, logits = PP.pp_forward(params, cfg, _t(ids).long(), _t(labels).long(), quant,
                                     torch.float32, _train_rt(), mesh, n_micro)
    return {"loss": float(loss), "logits": _np(logits)}


def _pp_grads(mesh, tree, cfg, quant, ids, labels, n_micro):
    """The gradient of pp_forward's loss for every trainable leaf of the
    rank's tree (a layer leaf: its stage's layers)."""
    from chatglm_q_tpu_torch.parallel import pipeline as PP
    from chatglm_q_tpu_torch.utils import train as T

    cfg, params = _pp_setup(mesh, tree, cfg)
    tr, fr = T.partition_params(params)
    loss, _ = PP.pp_forward(T.merge_params(tr, fr), cfg, _t(ids).long(), _t(labels).long(),
                            quant, torch.float32, _train_rt(), mesh, n_micro)
    grads = torch.autograd.grad(loss, T.trainable_leaves(tr))
    return {"loss": float(loss), "grads": dict(zip(_dotted(tr), [_np(g) for g in grads]))}


def _pp_last_stage_summed(mesh, tree, cfg, quant, ids, labels, n_micro):
    """The control: the pipeline's output gradient summed over the stages
    (each stage's copy of it) before the last stage takes it."""
    from chatglm_q_tpu_torch.parallel import pipeline as PP

    keep = PP.last_stage_grad
    PP.last_stage_grad = lambda g, m: m.all_reduce(g, "stage")
    try:
        return _pp_grads(mesh, tree, cfg, quant, ids, labels, n_micro)
    finally:
        PP.last_stage_grad = keep


def _pp_step(mesh, tree, cfg, quant, ids, labels, n_micro, lr=1e-2):
    """One SGD step through the pipeline: the loss, whether final_ln moved,
    whether every frozen leaf is bit-unchanged."""
    from chatglm_q_tpu_torch.parallel import pipeline as PP
    from chatglm_q_tpu_torch.utils import train as T

    cfg, params = _pp_setup(mesh, tree, cfg)
    tr, fr = T.partition_params(params)
    before = {k: v.clone() for k, v in _dotted(fr).items()}
    ln = tr["final_ln"]["weight"].detach().clone()
    opt = torch.optim.SGD(T.trainable_leaves(tr), lr=lr)
    loss, _ = PP.pp_forward(T.merge_params(tr, fr), cfg, _t(ids).long(), _t(labels).long(),
                            quant, torch.float32, _train_rt(), mesh, n_micro)
    loss.backward()
    opt.step()
    return {"loss": float(loss),
            "final_ln_moved": not torch.equal(ln, tr["final_ln"]["weight"].detach()),
            "frozen_unchanged": all(torch.equal(v, before[k]) for k, v in _dotted(fr).items())}


PIPELINE = {"forward": _pp_forward, "grads": _pp_grads, "summed": _pp_last_stage_summed,
            "step": _pp_step}


def pipeline_cases(rank, meshes):
    """``meshes``: [(n_rep, n_stage, cases)], each mesh built in turn over
    one process group; cases {name: (kind, kwargs)} → {name: (stage index,
    result)}."""
    from chatglm_q_tpu_torch.parallel import sharding as SH

    torch.set_num_threads(1)
    out = {}
    for n_rep, n_stage, cases in meshes:
        mesh = SH.make_mesh(n_rep, 1, n_stage)
        for name, (kind, kw) in cases.items():
            out[name] = (mesh.stage_index, PIPELINE[kind](mesh, **kw))
    return out


# ---------------------------------------------------------------------------
# tests/test_torch_dist_ckpt.py
# ---------------------------------------------------------------------------

def ckpt_cases(rank, tree, cfg, quant, whole_dir, mesh_dir):
    """Save the (1, 2) mesh's slices to ``mesh_dir``; load them onto a (2, 1)
    mesh and the whole save ``whole_dir`` onto the (1, 2) mesh.  Returns,
    per load, the keys whose tensor is not ``shard_params``' slice bit for
    bit (dtype included)."""
    from chatglm_q_tpu_torch import ChatGLM2Config
    from chatglm_q_tpu_torch.convert import params_from_numpy
    from chatglm_q_tpu_torch.parallel import sharding as SH
    from chatglm_q_tpu_torch.utils import dist_ckpt as C

    cfg = ChatGLM2Config(**cfg)
    full = params_from_numpy(tree, "cpu")

    def differ(got, mesh):
        want = _dotted(SH.shard_params(full, mesh, cfg, quant))
        got = _dotted(got)
        return sorted(k for k in want if k not in got or got[k].dtype != want[k].dtype
                      or not torch.equal(got[k], want[k]))

    m12 = _mesh(1, 2)
    C.save_params(mesh_dir, SH.shard_params(full, m12, cfg, quant), m12, cfg, quant)
    m21 = _mesh(2, 1)
    on_21 = C.load_params(mesh_dir, mesh=m21, config=cfg, quant_type=quant, device="cpu")
    on_12 = C.load_params(whole_dir, mesh=m12, config=cfg, quant_type=quant, device="cpu")
    return {"mesh_to_21": differ(on_21, m21), "whole_to_12": differ(on_12, m12)}


# ---------------------------------------------------------------------------
# tests/test_torch_sharded_writes.py
# ---------------------------------------------------------------------------

def _nonzero_rows_sharded(cache_layer, new, start, shard, rows=None):
    """The T-sharded write as it selected its positions with ``nonzero``
    (a host sync) before it became a masked accumulate."""
    B, G, S, D = new.shape
    pos = start.long().clamp(0, shard.total - S)[:, None] + torch.arange(S)
    t = pos - shard.offset
    b, s = ((t >= 0) & (t < cache_layer.shape[2])).nonzero(as_tuple=True)
    r = b if rows is None else rows.long()[b]
    cache_layer[r, :, t[b, s]] = new[b, :, s].to(cache_layer.dtype)


def _nonzero_pages_sharded(pool, new, layer, table, start, shard, aligned=True):
    """The model-sharded paged write, likewise, as it was."""
    B, G, S, D = new.shape
    P = pool.shape[3]
    pos = start.long()[:, None] + torch.arange(S)[None, :]
    if S == 1 or not aligned:
        pos = pos.clamp(max=shard.total - 1)
        blk = pos // P
    else:
        blk = (pos // P).clamp(max=shard.total // P - 1)
    col = blk // shard.stride
    b, s = ((blk % shard.stride == shard.phase) & (col < table.shape[1])).nonzero(as_tuple=True)
    page = table.long()[b, col[b, s]]
    pool[layer][page, :, pos[b, s] % P] = new[b, :, s].to(pool.dtype)


def sharded_write_cases(rank, nd, nm, cases):
    """{name: (kind, kwargs)} → {name: (the masked write's cache bits, the
    nonzero write's, the cache's bits before)} on this rank's shard: "rows"
    a T-shard of ``T_local`` slots at offset rank · T_local, "pages" the
    pool of phase rank of a strided table."""
    from chatglm_q_tpu_torch.models import chatglm2 as M
    from chatglm_q_tpu_torch.models import paged_kv as PK
    from chatglm_q_tpu_torch.ops.attention import KVShard

    mesh = _mesh(nd, nm)
    m = mesh.model_index
    out = {}
    for name, (kind, kw) in cases.items():
        before = _t(kw["cache"]).to(torch.bfloat16)
        new = _t(kw["new"]).to(torch.bfloat16)
        start = _t(kw["start"])
        got, want = before.clone(), before.clone()
        if kind == "rows":
            T_local = before.shape[2]
            shard = KVShard(offset=m * T_local, total=T_local * mesh.n_model)
            rows = None if kw.get("rows") is None else _t(kw["rows"])
            M.write_rows_sharded(got, new, start, shard, rows)
            _nonzero_rows_sharded(want, new, start, shard, rows)
        else:
            shard = KVShard(stride=mesh.n_model, phase=m, total=kw["total"])
            table = _t(kw["tables"][m])
            PK.write_pages_sharded(got, new, kw["layer"], table, start, shard, kw["aligned"])
            _nonzero_pages_sharded(want, new, kw["layer"], table, start, shard, kw["aligned"])
        out[name] = tuple(x.view(torch.int16).numpy() for x in (got, want, before))
    return out

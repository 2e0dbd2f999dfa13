"""Rank functions of the port's tensor-parallel CPU tests.

``chatglm_q_tpu_torch.utils.distributed.run_spmd`` spawns the ranks and
runs one of these on each; they import torch and the port only (never jax,
nor a test module, which imports jax), take their inputs as numpy arrays
and return numpy arrays.  Each runs every case of one test module in one
process group, so a module spawns its ranks once.
"""
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
    last batch's admitted slots, page locality}}: each distributed engine on
    the rank's shard, each batch submitted through rank 0's
    ``sync_submissions`` and drained before the next."""
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
        cls = DistributedPagedServingEngine if engine == "paged" else DistributedServingEngine
        eng = cls(load, params, mesh=mesh, rt=rt, device="cpu", **kw)
        res = {"local": True}
        for batch in batches:
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
        out[name] = res
    return out

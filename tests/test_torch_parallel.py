"""The port's tensor-parallel layer against the JAX package's on the CPU.

The port's ranks are processes joined over gloo (``run_spmd``, spawned; the
rank functions are tests/torch_dist_workers.py, which imports no jax); the
JAX side runs here on its 8-virtual-device CPU mesh (tests/conftest.py),
its Pallas kernels in interpret mode.  Both take the same numpy inputs from
a seed.  Each mesh's ranks are spawned once a module, for all its cases:
``tp_quant_linear`` in int8 and int4g32, col / row / rep (row over a
storage-padded K), the dynamic-int8 col form and its row refusal; ring
attention; the T-sharded decode (K1 + merge) and the model-sharded paged
decode (K2 + merge); the f32 model's prefill and decode logits under the
same mesh with ``kv_shard_t`` and head-sharded, on (1, 2) and once on a
(2, 2) mesh.  Host-side placement (head split, row bounds, the mesh shape)
is checked without processes.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec as P  # noqa: E402

import torch_dist_workers as W  # noqa: E402
from chatglm_q_tpu.config import ChatGLM2Config as JConfig, TpuRuntimeConfig  # noqa: E402
from chatglm_q_tpu.models import chatglm2 as JM  # noqa: E402
from chatglm_q_tpu.ops import pallas_attention as JPA  # noqa: E402
from chatglm_q_tpu.ops.linear import quant_linear as j_quant_linear  # noqa: E402
from chatglm_q_tpu.ops.quant import quantize_linear_int4, quantize_linear_int8  # noqa: E402
from chatglm_q_tpu.parallel import sharding as JS  # noqa: E402
from chatglm_q_tpu.parallel.ring_attention import ring_attention as j_ring  # noqa: E402
from chatglm_q_tpu_torch import ChatGLM2Config  # noqa: E402
from chatglm_q_tpu_torch.parallel import sharding as SH  # noqa: E402
from chatglm_q_tpu_torch.utils.distributed import run_spmd  # noqa: E402

pytestmark = pytest.mark.skipif(jax.device_count() < 8, reason="needs 8 virtual devices")

CFG = dict(hidden_size=256, inner_hidden_size=512, head_hidden_size=32,
           num_multi_query_groups=2, num_attention_heads=8, num_layers=2,
           vocab_size=1024, max_sequence_length=64)
SPAWN_TIMEOUT = 150  # seconds for one mesh's ranks to run every case
TOL = 1e-5  # of max|JAX output|: f32 sums in another order


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= tol, err


# ---------------------------------------------------------------------------
# inputs and the JAX twins
# ---------------------------------------------------------------------------

def _linear_inputs():
    rng = np.random.RandomState(3)
    out = {}
    for quant, quantize in (("int8", quantize_linear_int8), ("int4g32", quantize_linear_int4)):
        for mode, K, N in (("col", 256, 512), ("row", 1152, 128), ("rep", 256, 512)):
            w = jnp.asarray(rng.randn(K, N).astype(np.float32) * 0.1)
            out[(quant, mode, False)] = (rng.randn(4, K).astype(np.float32), _np(quantize(w)))
    w = jnp.asarray(rng.randn(256, 512).astype(np.float32) * 0.1)
    p8 = _np(quantize_linear_int8(w))
    x8 = rng.randn(4, 256).astype(np.float32)
    out[("int8", "col", True)] = (x8, p8)
    out[("int8", "row", True)] = (x8, p8)
    return out


LINEAR = _linear_inputs()


def _pspecs(quant, mode):
    m = JS.MODEL_AXIS
    if mode == "col":
        return {"weight": P(None, m), "weight_scale": P(m) if quant == "int8" else P(None, m)}
    if mode == "row":
        return {"weight": P(m, None), "weight_scale": P(None) if quant == "int8" else P(m, None)}
    return {"weight": P(None, None), "weight_scale": P(None) if quant == "int8" else P(None, None)}


def jax_linear(key, mesh):
    quant, mode, dyn = key
    x, p = LINEAR[key]
    specs = _pspecs(quant, mode)
    p_sh = {k: jax.device_put(jnp.asarray(v), NamedSharding(mesh, specs[k])) for k, v in p.items()}
    rt = TpuRuntimeConfig(use_pallas=True, tp_pallas=True, dynamic_int8=dyn, mesh=mesh)
    with mesh:
        return np.asarray(jax.jit(lambda a, b: j_quant_linear(a, b, quant, rt, tp_mode=mode))(
            jnp.asarray(x), p_sh))


def _attn_inputs():
    rng = np.random.RandomState(7)
    ring = dict(q=rng.randn(2, 16, 2, 4, 32).astype(np.float32),
                k=rng.randn(2, 16, 2, 32).astype(np.float32),
                v=rng.randn(2, 16, 2, 32).astype(np.float32),
                lengths=np.array([16, 11], np.int32))
    # one row confined to shard 0, one across both, one ending at the edge
    tsh = dict(q=rng.randn(4, 2, 4, 128).astype(np.float32),
               k=rng.randn(4, 2, 64, 128).astype(np.float32),
               v=rng.randn(4, 2, 64, 128).astype(np.float32),
               lengths=np.array([3, 60, 31, 32], np.int32), sm_scale=1 / np.sqrt(128))
    return ring, tsh


RING, TSH = _attn_inputs()
COLLECTIVE_X = np.arange(12, dtype=np.float32).reshape(3, 4) / 4


def paged_inputs(nd, tp, seed):
    """A pool in the phase layout: row r of data group g holds logical block
    j in sub-pool (g, j % tp); lengths 0, within a page, across pages and
    past the table's capacity (clamped)."""
    rng = np.random.RandomState(seed)
    L, G, Pg, D, Hg, B, MP = 2, 2, 8, 32, 4, 4, 4
    per = B // nd  # rows of a data group
    sp = per * (-(-MP // tp)) + 1  # a sub-pool: its garbage page, then the rows'
    NP = nd * tp * sp
    pt = np.zeros((B, MP), np.int32)
    for r in range(B):
        g = r // per
        for j in range(MP):
            pt[r, j] = (g * tp + j % tp) * sp + 1 + (r % per) * (-(-MP // tp)) + j // tp
    return dict(q=rng.randn(B, G, Hg, D).astype(np.float32),
                k_pool=rng.randn(L, NP, G, Pg, D).astype(np.float32),
                v_pool=rng.randn(L, NP, G, Pg, D).astype(np.float32), page_table=pt,
                lengths=np.array([5, 17, 0, MP * Pg + 3], np.int32), layer=1,
                sm_scale=1 / np.sqrt(D))


PAGED = {(1, 2): paged_inputs(1, 2, 13), (2, 2): paged_inputs(2, 2, 14)}


def model_inputs(quant, seed):
    tree = _np(JM.init_params(jax.random.PRNGKey(seed), JConfig(**CFG), quant, jnp.float32))
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, CFG["vocab_size"], (2, 8)).astype(np.int32)
    return tree, ids, np.array([8, 5], np.int32)


MODELS = {("none", True): model_inputs("none", 30), ("none", False): model_inputs("none", 31),
          ("int4g32", False): model_inputs("int4g32", 32)}


def jax_model(key, mesh_shape, steps=3):
    """JAX's model under the same mesh: logits of the prefill and of each
    decode step, and the tokens fed (its own greedy choices)."""
    quant, shard_t = key
    tree, ids, lengths = MODELS[key]
    cfg = JConfig(**CFG)
    mesh = JS.make_mesh(*mesh_shape)
    params = JS.shard_params(jax.tree.map(jnp.asarray, tree), mesh, cfg, quant)
    rt = TpuRuntimeConfig(use_pallas=False, use_flash_attention=True, mesh=mesh,
                          kv_shard_t=shard_t)
    with mesh:
        cache = JM.init_kv_cache(cfg, 2, CFG["max_sequence_length"], jnp.float32)
        cache = jax.tree.map(lambda x, s: jax.device_put(x, NamedSharding(mesh, s)), cache,
                             JS.kv_cache_pspecs(shard_t=shard_t))
        logits, cache = JM.prefill(params, cfg, jnp.asarray(ids), jnp.asarray(lengths), cache,
                                   quant, jnp.float32, rt)
        out, toks = [np.asarray(logits)], []
        for _ in range(steps):
            tok = jnp.argmax(logits, -1).astype(jnp.int32)
            toks.append(np.asarray(tok))
            logits, cache = JM.decode_step(params, cfg, tok, cache, quant, jnp.float32, rt)
            out.append(np.asarray(logits))
    return np.stack(out), np.stack(toks)


# ---------------------------------------------------------------------------
# the port's ranks, once a mesh
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_models():
    return {(key, shape): jax_model(key, shape)
            for key, shape in ((("none", True), (1, 2)), (("none", False), (1, 2)),
                               (("int4g32", False), (2, 2)))}


def _model_case(key, toks):
    tree, ids, lengths = MODELS[key]
    return ("model", dict(tree=tree, cfg=CFG, quant=key[0], ids=ids, lengths=lengths,
                          tokens=toks, kv_shard_t=key[1]))


@pytest.fixture(scope="module")
def ranks_12(jax_models):
    cases = {("linear",) + k: ("linear", dict(x=x, p=p, quant=k[0], mode=k[1], dyn=k[2]))
             for k, (x, p) in LINEAR.items()}
    cases["collectives"] = ("collectives", dict(x=COLLECTIVE_X))
    cases["ring"] = ("ring", RING)
    cases["kv_tsharded"] = ("kv_tsharded", TSH)
    cases["paged_msharded"] = ("paged_msharded", PAGED[(1, 2)])
    for key in (("none", True), ("none", False)):
        cases[("model",) + key] = _model_case(key, jax_models[(key, (1, 2))][1])
    return run_spmd(W.parallel_cases, 2, "gloo", SPAWN_TIMEOUT, args=(1, 2, cases))


@pytest.fixture(scope="module")
def ranks_22(jax_models):
    key = ("int4g32", False)
    cases = {"paged_msharded": ("paged_msharded", PAGED[(2, 2)]),
             ("model",) + key: _model_case(key, jax_models[(key, (2, 2))][1])}
    return run_spmd(W.parallel_cases, 4, "gloo", SPAWN_TIMEOUT, args=(2, 2, cases))


@pytest.mark.parametrize("key", [k for k in LINEAR if k != ("int8", "row", True)],
                         ids=lambda k: "-".join(map(str, k)))
def test_tp_quant_linear_matches_jax(ranks_12, key):
    got = [r[("linear",) + key] for r in ranks_12]
    want = jax_linear(key, JS.make_mesh(1, 2))
    if key[1] == "col":  # each rank holds its columns
        close(np.concatenate(got, axis=1), want)
    else:  # every rank holds the whole output
        for g in got:
            close(g, want)


def test_tp_quant_linear_refuses_dynamic_int8_row(ranks_12):
    for r in ranks_12:
        msg = r[("linear", "int8", "row", True)]
        assert isinstance(msg, str) and "row-parallel" in msg, msg


@pytest.mark.parametrize("kind", ["bf16", "int32"])
def test_mesh_collectives_move_16_and_32_bit_tensors(ranks_12, kind):
    """all_gather, broadcast, ring_shift and all_reduce over gloo keep the
    dtype and the values (bf16 moves as its bytes; gloo has no int16)."""
    def own(r):
        if kind == "bf16":
            return torch.tensor(COLLECTIVE_X + r).to(torch.bfloat16).float().numpy()
        return np.arange(6, dtype=np.float32).reshape(2, 3) + 10 * r

    for r, res in enumerate(ranks_12):
        got = res["collectives"][kind]
        np.testing.assert_array_equal(got["gather"], np.stack([own(0), own(1)]))
        np.testing.assert_array_equal(got["broadcast"], own(1))
        np.testing.assert_array_equal(got["ring"], own(1 - r))
        np.testing.assert_array_equal(got["max"], own(1))
        want_sum = torch.tensor(own(0) + own(1)).to(torch.bfloat16).float().numpy() \
            if kind == "bf16" else own(0) + own(1)
        np.testing.assert_array_equal(got["sum"], want_sum)
        assert got["dtypes"] == [f"torch.{'bfloat16' if kind == 'bf16' else 'int32'}"] * 2


def test_ring_attention_matches_jax(ranks_12):
    mesh = JS.make_mesh(1, 2)
    with mesh:
        want = np.asarray(j_ring(*(jnp.asarray(RING[k]) for k in ("q", "k", "v", "lengths")),
                                 mesh, "model"))
    close(np.concatenate([r["ring"] for r in ranks_12], axis=1), want)


def test_decode_kv_tsharded_matches_jax(ranks_12):
    mesh = JS.make_mesh(1, 2)
    args = [jnp.asarray(TSH[k]) for k in ("q", "k", "v", "lengths")]
    with mesh:
        want = np.asarray(JPA.flash_attention_decode_kv_tsharded(
            *args, TSH["sm_scale"], mesh, 16, interpret=True))
    for r in ranks_12:
        close(r["kv_tsharded"], want)


@pytest.mark.parametrize("shape", [(1, 2), (2, 2)])
def test_decode_paged_msharded_matches_jax(ranks_12, ranks_22, shape):
    d = PAGED[shape]
    mesh = JS.make_mesh(*shape)
    with mesh:
        want = np.asarray(JPA.flash_attention_decode_paged_msharded(
            jnp.asarray(d["q"]), jnp.asarray(d["k_pool"]), jnp.asarray(d["v_pool"]),
            jnp.int32(d["layer"]), jnp.asarray(d["page_table"]), jnp.asarray(d["lengths"]),
            d["sm_scale"], mesh, interpret=True))
    ranks = ranks_12 if shape == (1, 2) else ranks_22
    per = want.shape[0] // shape[0]
    for i, r in enumerate(ranks):
        di = i // shape[1]
        close(r["paged_msharded"], want[di * per:(di + 1) * per])


@pytest.mark.parametrize("key,shape", [(("none", True), (1, 2)), (("none", False), (1, 2)),
                                       (("int4g32", False), (2, 2))],
                         ids=["kv_shard_t", "heads", "int4g32-heads-2x2"])
def test_tp_model_logits_match_jax(ranks_12, ranks_22, jax_models, key, shape):
    """Prefill and three decode steps (JAX's greedy tokens fed to both):
    every rank's logits within 1e-5 · max|logits| of JAX's under the same
    mesh; the ranks of a data group agree exactly."""
    want = jax_models[(key, shape)][0]  # (steps + 1, B, V)
    ranks = ranks_12 if shape == (1, 2) else ranks_22
    per = want.shape[1] // shape[0]
    for i, r in enumerate(ranks):
        di = i // shape[1]
        got = r[("model",) + key]
        close(got, want[:, di * per:(di + 1) * per])
        np.testing.assert_array_equal(got, ranks[di * shape[1]][("model",) + key])


# ---------------------------------------------------------------------------
# placement, without processes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tp", [1, 2, 4, 8])
@pytest.mark.parametrize("quant", ["none", "int8", "int4g32"])
def test_tp_divisibility_and_mesh_shape_match_jax(tp, quant):
    for kw in (CFG, {}):
        jc, tc = JConfig(**kw), ChatGLM2Config(**kw)
        assert SH.tp_divisibility_ok(tc, tp, quant) == JS.tp_divisibility_ok(jc, tp, quant)
        assert SH.default_mesh_shape(tp, tc, quant) == JS.default_mesh_shape(tp, jc, quant)


@pytest.mark.parametrize("tp", [1, 2, 4, 8])
def test_head_split_covers_heads_in_order(tp):
    cfg = ChatGLM2Config()
    G, nH = cfg.num_multi_query_groups, cfg.num_attention_heads
    heads = []
    for m in range(tp):
        g0, Gl, Hgl = SH.head_split(cfg, tp, m)
        first = m * (nH // tp)
        assert g0 == first // (nH // G) and Gl * Hgl == nH // tp
        heads += list(range(first, first + Gl * Hgl))
    assert heads == list(range(nH))


def test_shard_params_splits_the_6b_layout():
    """At the 6B widths (int4g32, one layer): q_proj by heads, w_in at
    w_out's row bounds (13824 storage rows: 6912 a rank, the last rank's
    columns ending at 13696), lm_head in halves, kv_proj whole."""
    cfg = ChatGLM2Config(num_layers=1)
    from chatglm_q_tpu_torch.bench import random_quantized_params

    tree = random_quantized_params(cfg, "int4g32", torch.Generator().manual_seed(0), "cpu")

    class M2:
        n_data, n_model, data_index = 1, 2, 0

    parts = []
    for m in range(2):
        mesh = M2()
        mesh.model_index = m
        parts.append(SH.shard_params(tree, mesh, cfg, "int4g32"))
    lay = [p["layers"] for p in parts]
    assert [x["q_proj"]["weight"].shape[-1] for x in lay] == [2048, 2048]
    assert [x["w_in_h"]["weight"].shape[-1] for x in lay] == [6912, 13696 - 6912]
    assert [x["w_out"]["weight"].shape[-2] for x in lay] == [3456, 3456]
    assert [x["w_out"]["weight_scale"].shape[-2] for x in lay] == [216, 216]
    assert [p["lm_head"]["weight"].shape[-1] for p in parts] == [32768, 32768]
    assert all(x["kv_proj"]["weight"].shape == tree["layers"]["kv_proj"]["weight"].shape
               for x in lay)
    torch.testing.assert_close(torch.cat([x["w_out"]["weight"] for x in lay], dim=-2),
                               tree["layers"]["w_out"]["weight"], rtol=0, atol=0)

"""The port's paged cache (models/paged_kv.py), dense ``prefill_chunk``,
in-loop speculation (models/spec_decode.py) and the dense KV write at the
cache wall, against the JAX package on a 2-layer tiny ChatGLM2 (the
tests/test_paged.py config), f32.

Logits agree at rtol/atol 2e-4 (tests/test_torch_model.py's tolerance) with
JAX through its Pallas kernels in interpret mode (the flash path) and through
its jnp fallback (the masked-softmax path); token histories, drafts and
accept counts are equal."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from chatglm_q_tpu.config import ChatGLM2Config as JConfig, TpuRuntimeConfig  # noqa: E402
from chatglm_q_tpu.models import chatglm2 as JM  # noqa: E402
from chatglm_q_tpu.models import paged_kv as JPK  # noqa: E402
from chatglm_q_tpu.models import spec_decode as JSD  # noqa: E402
from chatglm_q_tpu_torch import ChatGLM2Config, TorchRuntimeConfig  # noqa: E402
from chatglm_q_tpu_torch.convert import params_from_numpy  # noqa: E402
from chatglm_q_tpu_torch.models import chatglm2 as TM  # noqa: E402
from chatglm_q_tpu_torch.models import paged_kv as TPK  # noqa: E402
from chatglm_q_tpu_torch.models import spec_decode as TSD  # noqa: E402

TINY = dict(hidden_size=64, inner_hidden_size=64, head_hidden_size=16,
            num_multi_query_groups=2, num_attention_heads=4, num_layers=2,
            vocab_size=128, max_sequence_length=64)
JCFG, TCFG = JConfig(**TINY), ChatGLM2Config(**TINY)
PAGE = 16
TOL = dict(rtol=2e-4, atol=2e-4)
# (JAX runtime, port runtime): the flash paths, and the masked-softmax paths
PATHS = {"flash": (TpuRuntimeConfig(use_pallas=True, use_flash_attention=True),
                   TorchRuntimeConfig(use_kernels=True, use_flash_attention=True)),
         "masked": (TpuRuntimeConfig(use_pallas=False, use_flash_attention=False),
                    TorchRuntimeConfig(use_kernels=False, use_flash_attention=False))}
PT = np.array([[5, 2, 7, 3], [8, 1, 6, 4]], np.int32)  # shuffled pages, 2 rows


@pytest.fixture(scope="module")
def params():
    jp = JM.init_params(jax.random.PRNGKey(0), JCFG, "none", jnp.float32)
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(a, copy=True))
    return t if dtype is None else t.to(dtype)


def _paged_pair(num_pages=9):
    jc = JPK.init_paged_kv_cache(JCFG, 2, num_pages, 64, PAGE, jnp.float32)
    jc = jc.replace(page_table=jnp.asarray(PT))
    tc = TPK.init_paged_kv_cache(TCFG, 2, num_pages, 64, PAGE, torch.float32, device="cpu")
    tc.page_table.copy_(_t(PT))
    return jc, tc


def test_write_gather_roundtrip_matches_jax():
    """A 13-token prefill write across two pages, one decode write at 13 and
    a write past capacity, through each package's write_pages; gather_layer
    reassembles the same dense view."""
    rng = np.random.default_rng(0)
    L, NP, G, P, D = 2, 9, 2, 8, 16
    pt = np.array([[3, 5, 1], [7, 2, 8]], np.int32)
    new = rng.standard_normal((2, G, 13, D)).astype(np.float32)
    tok = rng.standard_normal((2, G, 1, D)).astype(np.float32)
    jpool = jnp.zeros((L, NP, G, P, D), jnp.float32)
    tpool = torch.zeros((L, NP, G, P, D))
    writes = [(new, [0, 0], True), (tok, [13, 13], True), (tok * 2, [30, 40], True),
              (new[:, :, :4], [20, 22], False)]
    for layer in range(L):
        for x, start, aligned in writes:
            jpool = JPK.write_pages(jpool, jnp.asarray(x), jnp.int32(layer), jnp.asarray(pt),
                                    jnp.asarray(start, jnp.int32), aligned=aligned)
            out = TPK.write_pages(tpool, _t(x), layer, _t(pt), _t(np.array(start)), aligned)
            assert out is tpool
    np.testing.assert_array_equal(tpool.numpy(), np.asarray(jpool))
    for layer in range(L):
        want = np.asarray(JPK.gather_layer(jpool, jnp.int32(layer), jnp.asarray(pt)))
        np.testing.assert_array_equal(TPK.gather_layer(tpool, layer, _t(pt)).numpy(), want)


@pytest.mark.parametrize("path", list(PATHS))
def test_paged_prefill_and_decode_match_jax(params, path):
    """prefill_paged (ragged rows 18 and 5), then 6 decode_step_paged steps
    fed JAX's greedy tokens; the last steps cross a page edge."""
    jrt, trt = PATHS[path]
    jp, tp = params
    ids = np.zeros((2, 18), np.int32)
    ids[0] = np.arange(3, 21)
    ids[1, :5] = [7, 9, 11, 13, 15]
    lengths = np.array([18, 5], np.int32)
    jc, tc = _paged_pair()
    jl, jc = JPK.prefill_paged(jp, JCFG, jnp.asarray(ids), jnp.asarray(lengths), jc, "none",
                               jnp.float32, jrt)
    tl, tc = TPK.prefill_paged(tp, TCFG, _t(ids), _t(lengths), tc, "none", torch.float32, trt)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    step = jax.jit(lambda p, t, c: JPK.decode_step_paged(p, JCFG, t, c, "none", jnp.float32,
                                                         jrt))
    for _ in range(6):
        tok = jnp.argmax(jl, -1).astype(jnp.int32)
        jl, jc = step(jp, tok, jc)
        tl, tc = TPK.decode_step_paged(tp, TCFG, _t(np.asarray(tok)), tc, "none",
                                       torch.float32, trt)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    np.testing.assert_array_equal(tc.lengths.numpy(), np.asarray(jc.lengths))


@pytest.mark.parametrize("path", list(PATHS))
@pytest.mark.parametrize("aligned", [True, False], ids=["aligned", "unaligned"])
def test_paged_chunked_prefill_matches_jax(params, path, aligned):
    """Two chunks per row, the second with all logits: page-aligned 16-token
    chunks (the gathered flash-prefill path at S·Hg = 32), or 5-token chunks
    at unaligned starts (the chunk kernel)."""
    jrt, trt = PATHS[path]
    jp, tp = params
    Sc = 16 if aligned else 5
    rng = np.random.default_rng(1)
    jc, tc = _paged_pair()
    starts = np.array([0, 0], np.int32) if aligned else np.array([3, 0], np.int32)
    for i, all_logits in enumerate((False, True)):
        ids = rng.integers(3, 120, size=(2, Sc)).astype(np.int32)
        valid = np.array([Sc, Sc - 2], np.int32)
        jl, jc = JPK.prefill_chunk_paged(jp, JCFG, jnp.asarray(ids), jnp.asarray(starts),
                                         jnp.asarray(valid), jc, "none", jnp.float32, jrt,
                                         return_all_logits=all_logits, page_aligned=aligned)
        tl, tc = TPK.prefill_chunk_paged(tp, TCFG, _t(ids), _t(starts), _t(valid), tc, "none",
                                         torch.float32, trt, return_all_logits=all_logits,
                                         page_aligned=aligned)
        want = np.asarray(jl)
        if all_logits:  # padded positions past a row's valid tokens are never read
            tl, want = tl[0].numpy(), want[0]
        else:
            tl = tl.numpy()
        np.testing.assert_allclose(tl, want, **TOL)
        np.testing.assert_array_equal(tc.lengths.numpy(), np.asarray(jc.lengths))
        starts = starts + Sc


@pytest.mark.parametrize("path", list(PATHS))
def test_dense_prefill_chunk_slot_map_matches_jax(params, path):
    """A compact chunk batch: rows 0 and 1 of the chunk go to cache rows 2
    and 0 of a 3-row cache, over two chunks (the second with all logits);
    cache row 1's length stays 0."""
    jrt, trt = PATHS[path]
    jp, tp = params
    rng = np.random.default_rng(2)
    jc = JM.init_kv_cache(JCFG, 3, 32, jnp.float32)
    tc = TM.init_kv_cache(TCFG, 3, 32, torch.float32, device="cpu")
    slots = np.array([2, 0], np.int32)
    starts = np.zeros(2, np.int32)
    for all_logits in (False, True):
        ids = rng.integers(3, 120, size=(2, 8)).astype(np.int32)
        valid = np.array([8, 6], np.int32)
        jl, jc = JM.prefill_chunk(jp, JCFG, jnp.asarray(ids), jnp.asarray(starts),
                                  jnp.asarray(valid), jc, "none", jnp.float32, jrt,
                                  slot_map=jnp.asarray(slots), return_all_logits=all_logits)
        tl, tc = TM.prefill_chunk(tp, TCFG, _t(ids), _t(starts), _t(valid), tc, "none",
                                  torch.float32, trt, slot_map=_t(slots),
                                  return_all_logits=all_logits)
        want = np.asarray(jl)
        got = tl.numpy()
        if all_logits:
            got, want = got[0], want[0]
        np.testing.assert_allclose(got, want, **TOL)
        np.testing.assert_array_equal(tc.lengths.numpy(), np.asarray(jc.lengths))
        starts = starts + valid
    # the written rows hold the same K/V (valid slots only)
    for b, n in ((2, 16), (0, 12)):
        np.testing.assert_allclose(tc.k[:, b, :, :n].numpy(), np.asarray(jc.k)[:, b, :, :n],
                                   **TOL)


@pytest.mark.parametrize("path", list(PATHS))
def test_dense_decode_at_the_cache_wall_matches_jax(params, path):
    """A dense decode_step at lengths == T (and one past it): JAX's reference
    (jnp) path writes the token at slot T - 1 (dynamic_update_slice clamps);
    the port's plain KV write used to raise IndexError there.  Both of the
    port's paths are held against that path: JAX's Pallas KV write has no
    clamp (its window index runs past the cache)."""
    jrt, trt = PATHS["masked"][0], PATHS[path][1]
    jp, tp = params
    T = 16
    ids = np.arange(3, 3 + T, dtype=np.int32)[None]
    lengths = np.array([T], np.int32)
    jc = JM.init_kv_cache(JCFG, 1, T, jnp.float32)
    tc = TM.init_kv_cache(TCFG, 1, T, torch.float32, device="cpu")
    jl, jc = JM.prefill(jp, JCFG, jnp.asarray(ids), jnp.asarray(lengths), jc, "none",
                        jnp.float32, jrt)
    tl, tc = TM.prefill(tp, TCFG, _t(ids), _t(lengths), tc, "none", torch.float32, trt)
    for _ in range(2):
        tok = jnp.argmax(jl, -1).astype(jnp.int32)
        jl, jc = JM.decode_step(jp, JCFG, tok, jc, "none", jnp.float32, jrt)
        tl, tc = TM.decode_step(tp, TCFG, _t(np.asarray(tok)), tc, "none", torch.float32, trt)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        np.testing.assert_allclose(tc.k.numpy(), np.asarray(jc.k), **TOL)
    assert tc.lengths.tolist() == [T + 2]


def test_find_drafts_matches_jax():
    rng = np.random.default_rng(3)
    T = 32
    for _ in range(20):
        buf = rng.integers(0, 5, size=(3, T)).astype(np.int32)  # small alphabet: repeats
        lengths = rng.integers(0, T + 1, size=3).astype(np.int32)
        for ngram, k in ((2, 4), (3, 8)):
            want = np.asarray(JSD.find_drafts(jnp.asarray(buf), jnp.asarray(lengths), ngram, k))
            got = TSD.find_drafts(_t(buf), _t(lengths), ngram, k)
            np.testing.assert_array_equal(got.numpy(), want)


def test_write_token_rows_drops_past_the_end():
    buf = np.arange(24, dtype=np.int32).reshape(2, 12)
    seq = np.array([[90, 91, 92, 93], [80, 81, 82, 83]], np.int32)
    starts = np.array([3, 10], np.int32)
    want = np.asarray(JSD._write_token_rows(jnp.asarray(buf), jnp.asarray(seq),
                                            jnp.asarray(starts)))
    got = _t(buf)
    TSD._write_token_rows(got, _t(seq), _t(starts))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("path", list(PATHS))
def test_speculative_decode_paged_matches_jax(params, path):
    """Four verify steps at k = 4 on two rows whose prompts repeat (and whose
    pending tokens continue the repeat, so the first step drafts), the
    second row near the table's capacity (its lengths clamp): drafts,
    accept counts, next tokens, lengths and the token history equal JAX's."""
    jrt, trt = PATHS[path]
    jp, tp = params
    prompts = [[5, 6, 7, 8] * 4, [9, 10, 11] * 18 + [9, 10]]
    ids = np.zeros((2, 56), np.int32)
    lengths = np.array([len(p) for p in prompts], np.int32)
    tokbuf = np.zeros((2, 64), np.int32)
    for b, p in enumerate(prompts):
        ids[b, :len(p)] = p
        tokbuf[b, :len(p)] = p
    jc, tc = _paged_pair()
    jl, jc = JPK.prefill_paged(jp, JCFG, jnp.asarray(ids), jnp.asarray(lengths), jc, "none",
                               jnp.float32, jrt)
    tl, tc = TPK.prefill_paged(tp, TCFG, _t(ids), _t(lengths), tc, "none", torch.float32, trt)
    first = jnp.asarray([5, 11], jnp.int32)  # pending tokens that continue the repeats
    want = JSD.speculative_decode_paged(jp, JCFG, first, jc, jnp.asarray(tokbuf), 4, 4, 2,
                                        "none", jnp.float32, jrt)
    got = TSD.speculative_decode_paged(tp, TCFG, _t(np.asarray(first)), tc, _t(tokbuf), 4, 4, 2,
                                       "none", torch.float32, trt)
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_array_equal(got[3].lengths.numpy(), np.asarray(want[3].lengths))
    np.testing.assert_array_equal(got[4].numpy(), np.asarray(want[4]))
    assert (got[0] >= 0).any()  # the repeats were drafted

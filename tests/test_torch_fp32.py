"""float32 activations in the port's attention kernels (a float32
checkpoint, the loaders' default dtype) against the JAX package, on the
CPU, fed the same numpy inputs.

* Routing: on tensors that say they are on CUDA, every attention entry
  receives form 4 (f32 over an f32 cache) or 5 (f32 over float8_e4m3fn) and
  counts it apart (``<wrapper>_f32``, ``<wrapper>_fp8_f32``); the pairs
  still unported (f32 over a 16-bit cache, bf16 over f16, K and V of two
  dtypes) raise ``TypeError`` naming them.
* The f32 kernels' arithmetic emulated in torch, against JAX's kernels in
  interpret mode within 1e-5 of max|out|: the lane layout of the CUDA-core
  products (csrc/attention.cu ``qk_16keys`` and ``pv_16keys_f32``: which
  scores and output columns a lane computes, p shuffled across the quad);
  the decode kernel's split into spans at the spans ``decode_span`` /
  ``decode_paged_span`` pick, its one-span rule and its in-launch merge
  (B4, B12, B10, over an f32 cache and over an fp8 one upcast); the chunk
  kernel's span merge at ``chunk_span``'s spans (B11).
* The f32 append emulated per operation (``rope_vec``: two pairs a 16-byte
  vector, each product and sum the f32 op; ``store_vec``: one rounding to
  e4m3) bit-equal to JAX's ``apply_rotary_emb`` and its Pallas writes B3 /
  B9, into an f32 and an fp8 cache; a contracted (FMA) rotation differs.
* The f32 -> e4m3 store: ``kv_store_cast`` rounds once from f32, bit-equal
  to JAX's ``astype(float8_e4m3fn)`` wherever JAX's cast is finite, over a
  sweep of every e4m3 binade and its rounding midpoints; a bf16 hop first
  (two roundings) gives other bytes on some of them.
* A float32 checkpoint written by JAX's ``save_pretrained`` through the
  port's ``GLMDecoder.from_pretrained`` (the kernels' plain versions) gives
  JAX's decoder's greedy text, over an f32 and an fp8 cache.

The f32 plain versions over an fp8 cache, the f32 writes into fp8 and the
model and engines in f32 over fp8 are held in tests/test_torch_fp8_kv.py
(its ``float32`` cases).
"""
import math

import ml_dtypes
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from chatglm_q_tpu import loader as JLD  # noqa: E402
from chatglm_q_tpu.config import ChatGLM2Config as JConfig, GLMLoadConfig as JLoad  # noqa: E402
from chatglm_q_tpu.config import TpuRuntimeConfig  # noqa: E402
from chatglm_q_tpu.models import chatglm2 as JM  # noqa: E402
from chatglm_q_tpu.ops import pallas_attention as PA  # noqa: E402
from chatglm_q_tpu.serving.decoder import GLMDecoder as JDecoder  # noqa: E402
from chatglm_q_tpu.tokenizer import ChatGLM2Tokenizer as JTok  # noqa: E402
from chatglm_q_tpu.tokenizer.build import build_unigram_model  # noqa: E402
from chatglm_q_tpu_torch import TorchRuntimeConfig, ops  # noqa: E402
from chatglm_q_tpu_torch.ops import _build  # noqa: E402
from chatglm_q_tpu_torch.ops import attention as A  # noqa: E402
from chatglm_q_tpu_torch.serving import GLMDecoder  # noqa: E402
from test_torch_attention import _chunk_split_emulation, _decode_split_emulation  # noqa: E402

F32, FP8, JFP8 = torch.float32, torch.float8_e4m3fn, jnp.float8_e4m3fn
TOL = 1e-5  # of max|JAX|: f32 sums in another order (tests/test_torch_attention.py's)


def _randn(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _fp8_bytes(x):
    """f32 values through the port's store, as bytes."""
    return A.kv_store_cast(_t(x), FP8).view(torch.uint8).numpy()


def _fp8_pair(b):
    """The same fp8 bytes as a JAX array and a torch tensor."""
    return (jnp.asarray(b.view(ml_dtypes.float8_e4m3fn)), _t(b).view(FP8))


# ---------------------------------------------------------------------------
# (a) Routing: the entries and form codes of f32 and f32 over fp8
# ---------------------------------------------------------------------------

class _Launched(Exception):
    pass


class _FakeCuda(torch.Tensor):
    @property
    def is_cuda(self):
        return True


@pytest.fixture
def fake_launch(monkeypatch):
    def call(name, *args):
        raise _Launched(name, args)

    monkeypatch.setattr(_build, "call", call)
    monkeypatch.setattr(_build, "stream_ptr", lambda t: 0)
    monkeypatch.setattr(_build, "scratch",
                        lambda kind, device, n, dtype: torch.zeros(max(n, 1), dtype=dtype))


def _fake(t):
    return t.as_subclass(_FakeCuda)


def _attention_calls(kv_dtype):
    """One call of each attention wrapper on f32 activations over a cache
    (and pool) of ``kv_dtype``: (entry, counter of the form's launches)."""
    def z(*shape, dtype=F32):
        return _fake(A.kv_zeros(shape, dtype, "cpu"))

    q, qs = z(2, 2, 4, 128), z(2, 3, 2, 4, 128)
    k, cache, pool = z(2, 2, 64, 128, dtype=kv_dtype), z(2, 2, 2, 64, 128, dtype=kv_dtype), \
        z(2, 6, 2, 16, 128, dtype=kv_dtype)
    pt = z(2, 3, dtype=torch.int32)
    lens = _fake(torch.ones((2,), dtype=torch.int32))
    kv, fr, new = z(2, 512), z(2, 128), z(2, 2, 128)
    return {
        "chatglm_decode_attention": (A.flash_attention_decode,
                                     lambda: A.flash_attention_decode(q, k, k, lens, 0.1)),
        "chatglm_decode_attention v2": (A.flash_attention_decode_v2,
                                        lambda: A.flash_attention_decode_v2(q, k, k, lens, 0.1)),
        "chatglm_decode_attention lse": (
            A.flash_attention_decode_lse, lambda: A.flash_attention_decode_lse(q, k, k, lens, 0.1)),
        "chatglm_prefill_attention": (A.flash_attention_prefill,
                                      lambda: A.flash_attention_prefill(qs, k, k, lens, 0.1)),
        "chatglm_prefill_attention chunk": (A.flash_attention_prefill_chunk,
                                            lambda: A.flash_attention_prefill_chunk(
                                                qs, k, k, lens, lens, 0.1)),
        "chatglm_decode_paged": (A.flash_attention_decode_paged,
                                 lambda: A.flash_attention_decode_paged(q, pool, pool, 1, pt, lens,
                                                                        0.1)),
        "chatglm_decode_paged lse": (A.flash_attention_decode_paged_lse,
                                     lambda: A.flash_attention_decode_paged_lse(
                                         q, pool, pool, 1, pt, lens, 0.1, 2, 1)),
        "chatglm_chunk_paged": (A.flash_attention_chunk_paged,
                                lambda: A.flash_attention_chunk_paged(qs, pool, pool, 1, pt, lens,
                                                                      0.1)),
        "chatglm_rope_kv_append": (A.rope_kv_append,
                                   lambda: A.rope_kv_append(q, kv, fr, cache, cache, 1, lens)),
        "chatglm_rope_kv_append sharded": (A.rope_kv_append_sharded,
                                           lambda: A.rope_kv_append_sharded(
                                               q, kv, fr, cache, cache, 1, lens,
                                               A.KVShard(offset=64, total=128))),
        "chatglm_kv_append": (A.kv_cache_write_idx,
                              lambda: A.kv_cache_write_idx(cache, new, 1, lens)),
        "chatglm_kv_append pool": (A.kv_pool_write_idx,
                                   lambda: A.kv_pool_write_idx(pool, new, 1, pt, lens)),
    }


@pytest.mark.parametrize("kv_dtype", [F32, FP8], ids=["f32", "fp8"])
@pytest.mark.parametrize("key", list(_attention_calls(F32)))
def test_attention_entries_receive_the_f32_forms(fake_launch, key, kv_dtype):
    """f32 activations reach every attention entry with form 4 over an f32
    cache and 5 over an fp8 one (the code before the stream)."""
    wrapper, call = _attention_calls(kv_dtype)[key]
    with pytest.raises(_Launched) as launched:
        call()
    name, args = launched.value.args
    assert name == key.split()[0]
    assert args[-2] == A.FORM_CODES[(F32, kv_dtype)] == (4 if kv_dtype == F32 else 5)
    assert A.FORM_SUFFIX[args[-2]] == ("f32" if kv_dtype == F32 else "fp8_f32")


@pytest.mark.parametrize("form", ["f32", "fp8_f32"])
def test_every_cache_wrapper_counts_the_f32_forms(form):
    """Each wrapper of ``CACHE_FORMS`` has a counter of each f32 form, which
    ``ops.launch_counts`` reads and ``reset_launch_counts`` zeroes."""
    counts = ops.launch_counts()
    for name in A.CACHE_FORMS:
        assert f"{name}_{form}" in counts
        getattr(getattr(A, name), form).launches = 3
    assert all(ops.launch_counts()[f"{n}_{form}"] == 3 for n in A.CACHE_FORMS)
    ops.reset_launch_counts()
    assert not any(ops.launch_counts()[f"{n}_{form}"] for n in A.CACHE_FORMS)


@pytest.mark.parametrize("act,kv,named", [
    (F32, torch.bfloat16, "bfloat16"), (F32, torch.float16, "float16"),
    (torch.bfloat16, torch.float16, "float16"), (torch.bfloat16, F32, "float32"),
    (torch.float16, F32, "float32")])
def test_unported_pairs_raise_naming_them(fake_launch, act, kv, named):
    q = _fake(torch.zeros((2, 2, 4, 128), dtype=act))
    k = _fake(torch.zeros((2, 2, 64, 128), dtype=kv))
    lens = _fake(torch.zeros((2,), dtype=torch.int32))
    with pytest.raises(TypeError, match=named):
        A.flash_attention_decode(q, k, k, lens, 0.1)
    with pytest.raises(TypeError, match=named):
        A.flash_attention_prefill(q[:, None], k, k, lens, 0.1)


def test_k_and_v_of_two_dtypes_raise(fake_launch):
    q = _fake(torch.zeros((2, 2, 4, 128)))
    k = _fake(torch.zeros((2, 2, 64, 128)))
    lens = _fake(torch.zeros((2,), dtype=torch.int32))
    with pytest.raises(TypeError, match="float8_e4m3fn"):
        A.flash_attention_decode(q, k, _fake(A.kv_zeros((2, 2, 64, 128), FP8, "cpu")), lens, 0.1)


# ---------------------------------------------------------------------------
# (b) The f32 kernels' arithmetic, emulated
# ---------------------------------------------------------------------------

def _lane_scores(q, k, n0):
    """qk_16keys in f32: lane (gid, tig) computes s[j][e] = q row gid + 8 (e
    >> 1) . K row n0 + 8 j + 2 tig + (e & 1), d ascending four at a time;
    returns the per-lane registers (32, 2, 4)."""
    s = torch.zeros((32, 2, 4))
    for lane in range(32):
        gid, tig = lane >> 2, lane & 3
        rows = (q[gid], q[gid + 8])
        keys = (k[n0 + 2 * tig], k[n0 + 2 * tig + 1], k[n0 + 8 + 2 * tig], k[n0 + 9 + 2 * tig])
        for h in range(2):
            for c in range(4):
                acc = torch.zeros(())
                for d in range(0, q.shape[1], 4):
                    acc = acc + (rows[h][d:d + 4] * keys[c][d:d + 4]).sum()
                s[lane, c >> 1, 2 * h + (c & 1)] = acc
    return s


def _lane_pv(p, v, k0):
    """pv_16keys_f32: lane (gid, tig) takes the p of keys 8 j + 2 t + {0, 1}
    from lane quad | t (its registers p[j][0..3]: rows gid, gid + 8) and adds
    p . V into acc[n][e], column n * 8 + 2 tig + (e & 1) of row gid + 8 (e >>
    1); returns the per-lane acc (32, D / 8, 4)."""
    D = v.shape[1]
    acc = torch.zeros((32, D // 8, 4))
    for lane in range(32):
        tig, quad = lane & 3, lane & ~3
        for j in range(2):
            for t in range(4):
                pj = p[quad | t, j]
                for u in range(2):
                    row = v[k0 + 8 * j + 2 * t + u]
                    cols = torch.arange(D // 8) * 8 + 2 * tig
                    acc[lane, :, 0] += pj[u] * row[cols]
                    acc[lane, :, 1] += pj[u] * row[cols + 1]
                    acc[lane, :, 2] += pj[2 + u] * row[cols]
                    acc[lane, :, 3] += pj[2 + u] * row[cols + 1]
    return acc


def test_f32_lane_layout_covers_the_score_and_output_tiles():
    """One warp's 16 query rows against 16 keys of a tile at D = 128: the
    lanes' score registers are q . K^T (each (row, key) once, in the m16n8
    C layout the softmax and the merges read), and the lanes' acc after the
    quad shuffle of p is p . V, both within 1e-6 of max|ref|."""
    q, k, v = _t(_randn((16, 128), 1)), _t(_randn((64, 128), 2)), _t(_randn((64, 128), 3))
    n0 = 16
    s = _lane_scores(q, k, n0)
    S = torch.zeros((16, 16))
    for lane in range(32):
        gid, tig = lane >> 2, lane & 3
        for j in range(2):
            for e in range(4):
                S[gid + 8 * (e >> 1), 8 * j + 2 * tig + (e & 1)] = s[lane, j, e]
    ref = q @ k[n0:n0 + 16].T
    assert _rel(S.numpy(), ref.numpy()) <= 1e-6
    p = torch.softmax(s, dim=-1)  # any f32 values in the score registers' layout
    P = torch.zeros((16, 16))
    for lane in range(32):
        gid, tig = lane >> 2, lane & 3
        for j in range(2):
            for e in range(4):
                P[gid + 8 * (e >> 1), 8 * j + 2 * tig + (e & 1)] = p[lane, j, e]
    acc = _lane_pv(p, v, n0)
    O = torch.zeros((16, 128))
    for lane in range(32):
        gid, tig = lane >> 2, lane & 3
        for n in range(16):
            for e in range(4):
                O[gid + 8 * (e >> 1), n * 8 + 2 * tig + (e & 1)] = acc[lane, n, e]
    assert _rel(O.numpy(), (P @ v[n0:n0 + 16]).numpy()) <= 1e-6


DECODE_CASES = [(5, 200), (7, 1000)]  # (B, T): every row one span; spans of 64 merged


@pytest.mark.parametrize("fp8", [False, True], ids=["f32", "fp8"])
@pytest.mark.parametrize("B,T", DECODE_CASES)
@pytest.mark.parametrize("v2", [False, True], ids=["b4", "b12"])
def test_f32_decode_split_emulation_at_the_picked_spans_matches_jax(v2, B, T, fp8):
    """B4 / B12 in f32 at 6B's heads (G = 2, Hg = 16, D = 128), split as the
    kernel splits them: the span ``decode_span`` picks (64 rows here), one
    span for a row of at most DECODE_SOLO_ROWS valid slots, warps of 16 rows
    of each tile, the warps' and the spans' merges; against JAX's kernel in
    interpret mode on the same f32 cache (an fp8 cache: the same bytes
    upcast, as the kernels land each tile)."""
    G, Hg, D = 2, 16, 128
    q = _randn((B, G, Hg, D), 30 + B)
    k, v = _randn((B, G, T, D), 31 + B), _randn((B, G, T, D), 32 + B)
    if fp8:
        k, v = (A.kv_store_cast(_t(x), FP8).float().numpy() for x in (k, v))
    lengths = np.array([-1, 0, 63, min(255, T - 50), min(256, T - 1), T - 1, 700][:B],
                       np.int32)
    sm = 1.0 / math.sqrt(D)
    span = A.decode_span(B * G, T, A.DECODE_BLOCK_K)
    assert span == 64
    fn = PA.flash_attention_decode_v2 if v2 else PA.flash_attention_decode
    want = np.asarray(fn(*(jnp.asarray(a) for a in (q, k, v)), jnp.asarray(lengths), sm, 64,
                         interpret=True))
    got = _decode_split_emulation(*(_t(a) for a in (q, k, v)), _t(lengths), sm, span, v2,
                                  A.DECODE_SOLO_ROWS).numpy()
    assert not got[0].any() and not want[0].any()
    assert _rel(got, want) <= TOL


@pytest.mark.parametrize("P,MP", [(16, 48), (256, 3)])
def test_f32_paged_decode_split_emulation_matches_jax(P, MP):
    """B10 in f32: B12's split and merge over the gathered pages at the span
    ``decode_paged_span`` picks, against JAX's paged kernel in interpret
    mode (lengths -1, 0, a page edge, the one-span bound, the capacity)."""
    L, G, Hg, D, B = 2, 2, 16, 128, 5
    NP = B * MP + 1
    cap = MP * P
    kp, vp = _randn((L, NP, G, P, D), 40), _randn((L, NP, G, P, D), 41)
    pt = (np.random.default_rng(42).permutation(NP - 1)[: B * MP].reshape(B, MP) + 1
          ).astype(np.int32)
    q = _randn((B, G, Hg, D), 43)
    lengths = np.array([-1, 0, P, 256, cap - 1], np.int32)
    sm = 1.0 / math.sqrt(D)
    want = np.asarray(PA.flash_attention_decode_paged(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.int32(1), jnp.asarray(pt),
        jnp.asarray(lengths), sm, interpret=True))
    k = A.gather_pages(_t(kp)[1], _t(pt))
    v = A.gather_pages(_t(vp)[1], _t(pt))
    span = A.decode_paged_span(B * G, P, MP)
    got = _decode_split_emulation(_t(q), k, v, _t(lengths), sm, span, True,
                                  A.DECODE_SOLO_ROWS).numpy()
    assert not got[0].any()
    assert _rel(got, want) <= TOL


@pytest.mark.parametrize("S", [1, 9])
def test_f32_chunk_split_emulation_at_the_picked_spans_matches_jax(S):
    """B11 in f32 at 6B's heads over a 1024-slot table: split into the spans
    ``chunk_span`` picks (256 rows: four spans), each merged by its (m, l);
    starts 0, across a page edge, mid-table and at the capacity less S,
    against JAX's chunk kernel in interpret mode."""
    L, G, Hg, D, P, MP, B = 2, 2, 16, 128, 16, 64, 4
    NP = B * MP + 1
    cap = MP * P
    kp, vp = _randn((L, NP, G, P, D), 50), _randn((L, NP, G, P, D), 51)
    pt = (np.random.default_rng(52).permutation(NP - 1)[: B * MP].reshape(B, MP) + 1
          ).astype(np.int32)
    q = _randn((B, S, G, Hg, D), 53)
    starts = np.array([0, 14, 600, cap - S], np.int32)
    sm = 1.0 / math.sqrt(D)
    span = A.chunk_span(A.chunk_units(B, G, S, Hg), cap)
    assert span == 256
    want = np.asarray(PA.flash_attention_chunk_paged(
        *(jnp.asarray(a) for a in (q, kp, vp)), jnp.asarray(1), jnp.asarray(pt),
        jnp.asarray(starts), sm, interpret=True))
    got = _chunk_split_emulation(*(_t(a) for a in (q, kp, vp)), 1, _t(pt), _t(starts), sm,
                                 span).numpy()
    assert _rel(got, want) <= TOL


# ---------------------------------------------------------------------------
# (c) The f32 append, emulated per operation
# ---------------------------------------------------------------------------

G6, HG6, D6 = 2, 16, 128
TABLE = JM.precompute_freqs_cis(D6, 2049)
POSITIONS = [5, 700, 1500, 2048]


def _rope_vec(x, f):
    """rope_vec<float> on a 16-byte vector (4 floats, 2 interleaved pairs):
    every product and sum the f32 op, rounded at once (no FMA)."""
    x0, x1, f0, f1 = x[0::2], x[1::2], f[0::2], f[1::2]
    return torch.stack([x0 * f0 - x1 * f1, x0 * f1 + x1 * f0], dim=-1).reshape(-1)


def _store_vec(x, fp8):
    """store_vec<float, T>: the vector as it is, or its 4 e4m3 bytes (one
    rounding from f32)."""
    return A.kv_store_cast(x, FP8).view(torch.uint8) if fp8 else x


def _emulate_append(q, kv, freqs, k_cache, v_cache, layer, starts, page_table=None):
    """rope_kv_append_kernel<DenseKV / PagedKV, true, float>, one thread's
    16-byte vector (4 floats) at a time over flat memory: q, then the kv row
    (k rotated, then v), each vector stored at the slot its view addresses
    (the caches' bytes for fp8)."""
    B, V = q.shape[0], 4
    fp8 = k_cache.dtype == FP8
    nq, nkv = G6 * HG6 * D6 // V, G6 * D6 // V
    qf, kvf, ff = q.reshape(B, -1), kv.reshape(B, -1), freqs.reshape(B, -1)
    out = torch.empty_like(qf)
    kl, vl = (A.kv_bytes(c)[layer].reshape(-1) for c in (k_cache, v_cache))
    cap = k_cache.shape[3] * (1 if page_table is None else page_table.shape[1])
    for b in range(B):
        pos = min(max(int(starts[b]), 0), cap - 1)
        for i in range(nq + 2 * nkv):
            if i < nq:
                e = i * V
                out[b, e:e + V] = _rope_vec(qf[b, e:e + V], ff[b, e % D6:e % D6 + V])
                continue
            j = i - nq
            is_k = j < nkv
            e = (j if is_k else j - nkv) * V
            x = kvf[b, j * V:(j + 1) * V]
            if is_k:
                x = _rope_vec(x, ff[b, e % D6:e % D6 + V])
            g = e // D6
            if page_table is None:
                row = ((b * G6 + g) * cap + pos) * D6
            else:
                P = k_cache.shape[3]
                row = ((int(page_table[b, pos // P]) * G6 + g) * P + pos % P) * D6
            (kl if is_k else vl)[row + e % D6:row + e % D6 + V] = _store_vec(x, fp8)
    return out.reshape(q.shape)


def _jax_append(q, kv, freqs, jk, jv, starts, page_table):
    """JAX's sequence in f32: apply_rotary_emb on q and k, then B3 (or B9)
    for k and v, which cast new to the cache's dtype."""
    B = q.shape[0]
    jq, jkv, jf = (jnp.asarray(a) for a in (q, kv, freqs))
    f = jf[:, None, None, :]
    qr = JM.apply_rotary_emb(jq, f)
    k = JM.apply_rotary_emb(jkv[:, : G6 * D6].reshape(B, G6, 1, D6), f).reshape(B, G6, D6)
    v = jkv[:, G6 * D6:].reshape(B, G6, D6)
    st = jnp.asarray(starts)
    if page_table is None:
        return (qr, PA.kv_cache_write_idx(jk, k, jnp.asarray(1), st, interpret=True),
                PA.kv_cache_write_idx(jv, v, jnp.asarray(1), st, interpret=True))
    pt = jnp.asarray(page_table)
    return (qr, PA.kv_pool_write_idx(jk, k, jnp.asarray(1), pt, st, interpret=True),
            PA.kv_pool_write_idx(jv, v, jnp.asarray(1), pt, st, interpret=True))


@pytest.mark.parametrize("fp8", [False, True], ids=["f32", "fp8"])
@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_f32_append_emulation_is_bit_equal_to_jax(paged, fp8):
    """B3 / B9 with the RoPE of q and k in f32, into an f32 or an fp8 cache:
    the kernel's per-vector arithmetic and addressing give JAX's rotated q
    and JAX's cache, bit for bit (byte for byte), and so does the plain
    version; k and v scaled so that some values saturate at 448 and every
    binade is hit (none past 464, where JAX's cast gives NaN)."""
    B, L, T = 4, 3, 24
    rng = np.random.default_rng(60)
    q = rng.standard_normal((B, G6, HG6, D6)).astype(np.float32)
    kv = (rng.standard_normal((B, 2 * G6 * D6)) * 60).clip(-460, 460).astype(np.float32)
    freqs = TABLE[POSITIONS[:B]]
    starts = np.array([3, 17, 0, 23], np.int32)
    if paged:
        pt = np.array([[5, 2], [8, 1], [6, 4], [7, 3]], np.int32)
        shape = (L, 9, G6, 16, D6)
    else:
        pt, shape = None, (L, B, G6, T, D6)
    kc, vc = _randn(shape, 61), _randn(shape, 62)
    if fp8:
        (jk, tk), (jv, tv) = _fp8_pair(_fp8_bytes(kc)), _fp8_pair(_fp8_bytes(vc))
    else:
        (jk, tk), (jv, tv) = (jnp.asarray(kc), _t(kc)), (jnp.asarray(vc), _t(vc))
    wq, wk, wv = _jax_append(q, kv, freqs, jk, jv, starts, pt)

    def raw(x):
        return np.asarray(x).view(np.uint8)

    table = None if pt is None else _t(pt)
    for fn in (_emulate_append, A.rope_kv_append_plain):
        ck, cv = A.kv_bytes(tk).clone().view(tk.dtype), A.kv_bytes(tv).clone().view(tv.dtype)
        got = fn(_t(q), _t(kv), _t(freqs), ck, cv, 1, _t(starts), table)
        np.testing.assert_array_equal(got.numpy().view(np.uint32), raw(wq).view(np.uint32))
        np.testing.assert_array_equal(A.kv_bytes(ck).numpy().view(np.uint8).reshape(-1),
                                      raw(wk).reshape(-1))
        np.testing.assert_array_equal(A.kv_bytes(cv).numpy().view(np.uint8).reshape(-1),
                                      raw(wv).reshape(-1))


def test_contracted_f32_rotation_is_not_the_plain_rope():
    """The control: the rotation with its products contracted into an FMA
    (x0·f0 − x1·f1 with x0·f0 exact) differs from the per-op f32 rotation
    (PyTorch's, JAX's) in a share of q's elements, so the bit-equal
    comparisons above tell a kernel that contracts from one that rounds
    each op."""
    q = _t(np.random.default_rng(63).standard_normal((4, G6, HG6, D6)).astype(np.float32))
    f = _t(TABLE[POSITIONS])[:, None, None, :]
    plain = A.apply_rotary_emb(q, f)
    x, ff = q.double(), f.double()
    x0, x1, f0, f1 = x[..., 0::2], x[..., 1::2], ff[..., 0::2], ff[..., 1::2]
    fma = torch.stack([x0 * f0 - (x1 * f1).float().double(),
                       x0 * f1 + (x1 * f0).float().double()], dim=-1).reshape(x.shape).float()
    differ = (fma != plain).float().mean().item()
    assert differ > 0.05, differ


# ---------------------------------------------------------------------------
# (d) The f32 -> e4m3 store, one rounding
# ---------------------------------------------------------------------------

def _sweep():
    """f32 values over every e4m3 binade (subnormals included) at 64 points
    a binade, each nudged just below, onto and just above (2^-9 relative:
    across the e4m3 rounding midpoints), random values, ±448 .. 464, their
    negatives, and ±0; all under 464, where JAX's cast is finite."""
    e = np.arange(-12, 9, dtype=np.float32)
    m = np.linspace(1, 2, 64, dtype=np.float32)
    grid = (m[None, :] * np.exp2(e)[:, None]).reshape(-1)
    nudge = np.array([1 - 2 ** -9, 1, 1 + 2 ** -9], np.float32)
    x = np.concatenate([(grid[:, None] * nudge).reshape(-1), _randn((8192,), 64, 40.0),
                        np.array([448, 449, 455, 463.9, 0.0], np.float32)]).astype(np.float32)
    x = x[np.abs(x) < 464]  # from 464 on JAX's cast gives NaN, the port saturates (ROADMAP C)
    return np.concatenate([x, -x])


def test_f32_store_rounds_once_bit_equal_to_jax():
    """``kv_store_cast`` from f32 (the plain writes' store, and the f32
    append's store_vec) equals JAX's ``astype(float8_e4m3fn)`` wherever
    JAX's cast is finite; the control, the same values through bf16 first,
    gives other bytes on some of them (two roundings)."""
    x = _sweep()
    got = _fp8_bytes(x)
    want = np.asarray(jnp.asarray(x).astype(JFP8)).view(np.uint8)
    finite = (want & 0x7F) != 0x7F
    assert finite.all()  # the sweep stays under 464
    np.testing.assert_array_equal(got, want)
    hop = A.kv_store_cast(_t(x).to(torch.bfloat16), FP8).view(torch.uint8).numpy()
    assert (hop != want).sum() > 100, (hop != want).sum()


def test_f32_write_only_stores_into_fp8_equal_jax_bytes():
    """The write-only B3 / B9 of f32 values over the sweep into fp8 caches:
    JAX's Pallas writes cast new from f32 once; the port's bytes equal
    them."""
    x = _sweep()
    x = np.concatenate([x, np.zeros(-x.size % 256, np.float32)]).reshape(-1, 2, 128)
    B = x.shape[0]
    starts = np.full((B,), 2, np.int32)
    jc, tc = _fp8_pair(np.zeros((1, B, 2, 4, 128), np.uint8))
    want = PA.kv_cache_write_idx(jc, jnp.asarray(x), jnp.asarray(0), jnp.asarray(starts),
                                 interpret=True)
    A.kv_cache_write_idx(tc, _t(x), 0, _t(starts))
    np.testing.assert_array_equal(tc.view(torch.uint8).numpy(), np.asarray(want).view(np.uint8))
    pt = np.arange(1, B + 1, dtype=np.int32)[:, None]
    jp, tp = _fp8_pair(np.zeros((1, B + 1, 2, 8, 128), np.uint8))  # JAX's window: 8 rows
    want = PA.kv_pool_write_idx(jp, jnp.asarray(x), jnp.asarray(0), jnp.asarray(pt),
                                jnp.asarray(starts), interpret=True)
    A.kv_pool_write_idx(tp, _t(x), 0, _t(pt), _t(starts))
    np.testing.assert_array_equal(tp.view(torch.uint8).numpy(), np.asarray(want).view(np.uint8))


# ---------------------------------------------------------------------------
# (e) A float32 checkpoint written by JAX, served by the port
# ---------------------------------------------------------------------------

TINY = dict(hidden_size=64, inner_hidden_size=64, head_hidden_size=16,
            num_multi_query_groups=2, num_attention_heads=4, num_layers=2,
            vocab_size=320, max_sequence_length=64)
PROMPTS = ["hello world", "hello " * 20]


def _run(gen):
    stream = []
    while True:
        try:
            stream.append(next(gen))
        except StopIteration as e:
            return stream, e.value


@pytest.fixture(scope="module", params=["int8", "int4g32"])
def f32_ckpt(request, tmp_path_factory):
    """A tiny float32 checkpoint saved by JAX's ``GLMDecoder.save_pretrained``."""
    quant = request.param
    vocab = {f"tok{i}": -float(i) for i in range(40)}
    vocab.update({"hello": -0.5, "world": -0.6})
    root = tmp_path_factory.mktemp(f"f32_{quant}")
    (root / "sp.model").write_bytes(build_unigram_model(vocab))
    cfg = JConfig(**TINY)
    params = JM.init_params(jax.random.PRNGKey(4), cfg, quant, jnp.float32)
    load = JLoad(model_config=cfg, quant_type=quant, torch_dtype="float32")
    JDecoder(load, params, JTok(root / "sp.model")).save_pretrained(root / "ckpt")
    assert JLD.load_model_and_tokenizer(root / "ckpt")[0].torch_dtype == "float32"
    return root / "ckpt"


@pytest.mark.parametrize("kv", ["float32", "float8_e4m3fn"])
def test_float32_checkpoint_from_jax_serves_as_jax(f32_ckpt, kv):
    """``GLMDecoder.from_pretrained`` with no dtype serves the checkpoint's
    float32 (activations and, by default, the cache; or an fp8 cache)
    through the kernels' plain versions, and its greedy text stream is
    JAX's decoder's on the same files with the same cache dtype."""
    tkv, jkv = (None, None) if kv == "float32" else (FP8, JFP8)
    rt = TorchRuntimeConfig(use_kernels=True, use_flash_attention=True)
    td = GLMDecoder.from_pretrained(f32_ckpt, device="cpu", rt=rt, kv_dtype=tkv)
    assert td.config.torch_dtype == "float32" and td.dtype == F32
    assert td.kv_dtype == (tkv or F32)
    jd = JDecoder.from_pretrained(f32_ckpt, rt=TpuRuntimeConfig(use_pallas=False), kv_dtype=jkv)
    for prompt in PROMPTS:
        want = _run(jd.generate(prompt, max_generated_tokens=12, temperature=0.0))
        got = _run(td.generate(prompt, max_generated_tokens=12, temperature=0.0))
        assert got == want, prompt
        assert len(got[1]) > 0
    assert td._free_caches[0][0].k.dtype == (tkv or F32)

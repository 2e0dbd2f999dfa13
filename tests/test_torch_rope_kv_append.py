"""The decode step's fused RoPE + KV append (``ops/attention.py``:
``rope_kv_append`` and its plain version) against the JAX package: its
``apply_rotary_emb`` (chatglm_q_tpu/models/chatglm2.py) followed by the
Pallas KV writes B3 / B9 in interpret mode, on the same numpy inputs.

bf16 at the 6B head layout (G = 2, Hg = 16, D = 128), bit-equal for the
rotated q, the cache and the pool.  A torch emulation of the CUDA kernel
(its 16-byte vectors, its slot addressing, each product and sum in f32
rounded to bf16 at once) must be bit-equal to the plain version, and an f32
rotation rounded once (the control) must not.  End to end, ``decode_step``
and ``decode_step_paged`` at depth 2 go through the fused dispatch and agree
with JAX's at the tolerance of tests/test_torch_model.py (f32, 2e-4).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from chatglm_q_tpu.config import ChatGLM2Config as JConfig, TpuRuntimeConfig  # noqa: E402
from chatglm_q_tpu.models import chatglm2 as JM  # noqa: E402
from chatglm_q_tpu.models import paged_kv as JPK  # noqa: E402
from chatglm_q_tpu.ops import pallas_attention as PA  # noqa: E402
from chatglm_q_tpu_torch import ChatGLM2Config, TorchRuntimeConfig, ops  # noqa: E402
from chatglm_q_tpu_torch.convert import params_from_numpy  # noqa: E402
from chatglm_q_tpu_torch.models import chatglm2 as TM  # noqa: E402
from chatglm_q_tpu_torch.models import paged_kv as TPK  # noqa: E402
from chatglm_q_tpu_torch.ops import attention as TA  # noqa: E402

G, HG, D = 2, 16, 128      # ChatGLM2-6B's heads
L, T = 3, 24               # cache layers and slots
LAYER = 1
POSITIONS = (5, 700, 1500, 2048)  # RoPE rows (1-based positions), the last the table's end
TABLE = JM.precompute_freqs_cis(D, 2049)


def _bf16(a):
    """numpy f32 → the same bf16 values in both packages."""
    return (jnp.asarray(a, jnp.bfloat16),
            torch.from_numpy(np.ascontiguousarray(a)).to(torch.bfloat16))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _inputs(B, seed):
    """q (B, G, Hg, D), kv (B, 2·G·D) and freqs (B, D) rows, bf16."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, G, HG, D)).astype(np.float32)
    kv = rng.standard_normal((B, 2 * G * D)).astype(np.float32)
    freqs = TABLE[[POSITIONS[b % len(POSITIONS)] for b in range(B)]]
    return q, kv, freqs


def _jax_rope_write(q, kv, freqs, k_dst, v_dst, starts, page_table=None):
    """JAX's sequence: apply_rotary_emb on q and k, then B3 (or B9) for k and v."""
    B = q.shape[0]
    jq, jkv, jf = (_bf16(a)[0] for a in (q, kv, freqs))
    f = jf[:, None, None, :]
    qr = JM.apply_rotary_emb(jq, f)
    k = JM.apply_rotary_emb(jkv[:, : G * D].reshape(B, G, 1, D), f).reshape(B, G, D)
    v = jkv[:, G * D:].reshape(B, G, D)
    layer, st = jnp.asarray(LAYER, jnp.int32), jnp.asarray(starts)
    if page_table is None and (starts >= k_dst.shape[3]).any():
        k_dst = _jax_reference_write(k_dst, k, starts)
        v_dst = _jax_reference_write(v_dst, v, starts)
    elif page_table is None:
        k_dst = PA.kv_cache_write_idx(k_dst, k, layer, st, interpret=True)
        v_dst = PA.kv_cache_write_idx(v_dst, v, layer, st, interpret=True)
    else:
        pt = jnp.asarray(page_table)
        k_dst = PA.kv_pool_write_idx(k_dst, k, layer, pt, st, interpret=True)
        v_dst = PA.kv_pool_write_idx(v_dst, v, layer, pt, st, interpret=True)
    return qr, k_dst, v_dst


def _jax_reference_write(cache, new, starts):
    """JAX's decode write past the cache's wall: B3's Pallas window has no
    clamp there, so JAX's reference path (chatglm_q_tpu/models/chatglm2.py,
    ``upd_all``) is the oracle: a per-row ``dynamic_update_slice``, which
    clamps the slot to T − 1."""
    for b, s in enumerate(starts):
        cache = jax.lax.dynamic_update_slice(cache, new[None, b:b + 1, :, None],
                                             (LAYER, b, 0, int(s), 0))
    return cache


def _starts(B, where, capacity, seed):
    rng = np.random.default_rng(seed)
    if where == "middle":
        s = rng.integers(1, capacity - 1, B)
    elif where == "wall":
        s = np.full(B, capacity - 1)
    else:  # past the wall: the engines decode past it and roll the tokens back
        s = capacity + np.array([0, 5, 100, 2047])[:B]
    return s.astype(np.int32)


@pytest.mark.parametrize("where", ["middle", "wall", "past"])
@pytest.mark.parametrize("B", [1, 4])
def test_plain_dense_is_bit_equal_to_jax(B, where):
    q, kv, freqs = _inputs(B, seed=B)
    rng = np.random.default_rng(10 + B)
    kc, vc = (rng.standard_normal((L, B, G, T, D)).astype(np.float32) for _ in range(2))
    starts = _starts(B, where, T, seed=B)
    wq, wk, wv = _jax_rope_write(q, kv, freqs, _bf16(kc)[0], _bf16(vc)[0], starts)
    tk, tv = _bf16(kc)[1], _bf16(vc)[1]
    got = TA.rope_kv_append_plain(_bf16(q)[1], _bf16(kv)[1], _bf16(freqs)[1], tk, tv, LAYER,
                                  torch.from_numpy(starts))
    assert got.shape == (B, G, HG, D) and got.dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(got), _np(wq))
    np.testing.assert_array_equal(_np(tk), _np(wk))
    np.testing.assert_array_equal(_np(tv), _np(wv))
    # the slot the write landed on holds the rotated k (the clamp to T − 1)
    rows, slot = np.arange(B), np.clip(starts, 0, T - 1)
    assert not np.array_equal(_np(tk)[LAYER, rows, :, slot], kc[LAYER, rows, :, slot])


def _pool_case(B, P, where, seed):
    MP = 2
    NP = B * MP + 1
    rng = np.random.default_rng(seed)
    kp, vp = (rng.standard_normal((L, NP, G, P, D)).astype(np.float32) for _ in range(2))
    pt = (rng.permutation(NP - 1)[: B * MP].reshape(B, MP) + 1).astype(np.int32)
    return kp, vp, pt, _starts(B, where, MP * P, seed)


@pytest.mark.parametrize("where", ["middle", "wall", "past"])
@pytest.mark.parametrize("P", [16, 256])
@pytest.mark.parametrize("B", [1, 4])
def test_plain_paged_is_bit_equal_to_jax(B, P, where):
    q, kv, freqs = _inputs(B, seed=20 + B)
    kp, vp, pt, starts = _pool_case(B, P, where, seed=P + B)
    wq, wk, wv = _jax_rope_write(q, kv, freqs, _bf16(kp)[0], _bf16(vp)[0], starts, pt)
    tk, tv = _bf16(kp)[1], _bf16(vp)[1]
    got = TA.rope_kv_append_plain(_bf16(q)[1], _bf16(kv)[1], _bf16(freqs)[1], tk, tv, LAYER,
                                  torch.from_numpy(starts), torch.from_numpy(pt))
    np.testing.assert_array_equal(_np(got), _np(wq))
    np.testing.assert_array_equal(_np(tk), _np(wk))
    np.testing.assert_array_equal(_np(tv), _np(wv))


def _r(x):
    """Round f32 to bf16 and back (RNE), as __float2bfloat16_rn does."""
    return x.to(torch.bfloat16).float()


def _rope8(x, f):
    """The kernel's rope_vec<bf16> on 16-byte vectors (8 bf16, 4 interleaved pairs):
    each product and each sum in f32, rounded to bf16 at once (no FMA)."""
    x, f = x.float(), f.float()
    x0, x1, f0, f1 = x[..., 0::2], x[..., 1::2], f[..., 0::2], f[..., 1::2]
    o_r = _r(_r(x0 * f0) - _r(x1 * f1))
    o_i = _r(_r(x0 * f1) + _r(x1 * f0))
    return torch.stack([o_r, o_i], dim=-1).reshape(x.shape).to(torch.bfloat16)


def _emulate_kernel(q, kv, freqs, k_cache, v_cache, layer, starts, page_table=None):
    """rope_kv_append_kernel<DenseKV / PagedKV, true>, one thread's vector at
    a time over flat memory: q's G·Hg·D elements, then the kv row (k, then
    v), each 16-byte vector to the slot the cache view's slab addresses."""
    B = q.shape[0]
    nq, nkv, VEC = G * HG * D // 8, G * D // 8, 8
    qf, kvf, ff = q.reshape(B, -1), kv.reshape(B, -1), freqs.reshape(B, -1)
    out = torch.empty_like(qf)
    kl, vl = k_cache[layer].reshape(-1), v_cache[layer].reshape(-1)  # layer views, in place
    cap = k_cache.shape[3] * (1 if page_table is None else page_table.shape[1])
    for b in range(B):
        pos = min(max(int(starts[b]), 0), cap - 1)
        for i in range(nq + 2 * nkv):
            if i < nq:
                e = i * VEC
                out[b, e:e + VEC] = _rope8(qf[b, e:e + VEC], ff[b, e % D:e % D + VEC])
                continue
            j = i - nq
            is_k = j < nkv
            e = (j if is_k else j - nkv) * VEC
            x = kvf[b, j * VEC:(j + 1) * VEC]
            if is_k:
                x = _rope8(x, ff[b, e % D:e % D + VEC])
            g = e // D
            if page_table is None:
                row = ((b * G + g) * cap + pos) * D
            else:
                P = k_cache.shape[3]
                page = int(page_table[b, pos // P])
                row = ((page * G + g) * P + pos % P) * D
            (kl if is_k else vl)[row + e % D:row + e % D + VEC] = x
    return out.reshape(q.shape)


@pytest.mark.parametrize("paged", [False, True])
def test_kernel_emulation_is_bit_equal_to_plain(paged):
    """B = 4 at the wall and past it; the kv row read through a row stride
    (a view of a wider row, as kv_proj's output is)."""
    B = 4
    q, kv, freqs = _inputs(B, seed=7)
    wide = np.concatenate([kv, np.zeros((B, 8), np.float32)], axis=1)
    kv_t = _bf16(wide)[1][:, : 2 * G * D]
    assert kv_t.stride(0) == 2 * G * D + 8
    if paged:
        kp, vp, pt, _ = _pool_case(B, 16, "middle", seed=3)
        caches = [(_bf16(kp)[1], _bf16(vp)[1]) for _ in range(2)]
        starts, table = np.array([3, 16, 31, 90], np.int32), torch.from_numpy(pt)
    else:
        kc, vc = (np.random.default_rng(s).standard_normal((L, B, G, T, D)).astype(np.float32)
                  for s in (4, 5))
        caches = [(_bf16(kc)[1], _bf16(vc)[1]) for _ in range(2)]
        starts, table = np.array([0, 9, T - 1, T + 40], np.int32), None
    args = (_bf16(q)[1], kv_t, _bf16(freqs)[1])
    want = TA.rope_kv_append_plain(*args, *caches[0], LAYER, torch.from_numpy(starts), table)
    got = _emulate_kernel(*args, *caches[1], LAYER, torch.from_numpy(starts), table)
    assert torch.equal(got, want)
    assert torch.equal(caches[1][0], caches[0][0]) and torch.equal(caches[1][1], caches[0][1])


def test_rounding_once_in_f32_is_not_the_plain_rope():
    """The control: the same rotation in f32, rounded to bf16 once, differs
    from the plain per-op bf16 version in a large share of q's elements (the
    bypass half always agrees), so the bit-equal comparisons above can tell a
    kernel that contracts its products from one that rounds each."""
    q, _, freqs = _inputs(4, seed=1)
    tq, tf = _bf16(q)[1], _bf16(freqs)[1]
    plain = TA.apply_rotary_emb(tq, tf[:, None, None, :])
    x, f = tq.float(), tf.float()[:, None, None, :]
    x0, x1, f0, f1 = x[..., 0::2], x[..., 1::2], f[..., 0::2], f[..., 1::2]
    once = torch.stack([x0 * f0 - x1 * f1, x0 * f1 + x1 * f0], dim=-1).reshape(x.shape)
    differ = (once.to(torch.bfloat16) != plain).float().mean().item()
    assert differ > 0.05, differ
    assert torch.equal(_rope8(tq, tf[:, None, None, :].expand_as(tq)), plain)


def test_wrappers_on_cpu_tensors_are_the_plain_version():
    """rope_kv_append and the write-only B3 / B9 APIs run their plain
    versions on CPU tensors and count no launch."""
    B = 4
    q, kv, freqs = _inputs(B, seed=2)
    kc = np.random.default_rng(6).standard_normal((L, B, G, T, D)).astype(np.float32)
    starts = torch.tensor([1, 2, T - 1, T + 3], dtype=torch.int32)
    ops.reset_launch_counts()
    caches = [(_bf16(kc)[1], _bf16(kc)[1].clone()) for _ in range(2)]
    args = (_bf16(q)[1], _bf16(kv)[1], _bf16(freqs)[1])
    got = TA.rope_kv_append(*args, *caches[0], LAYER, starts)
    want = TA.rope_kv_append_plain(*args, *caches[1], LAYER, starts)
    assert torch.equal(got, want) and all(torch.equal(a, b) for a, b in zip(*caches))
    assert ops.launch_counts()["rope_kv_append"] == 0


# the 6B head layout at depth 2 with narrow hidden and FFN widths
TINY = dict(hidden_size=128, inner_hidden_size=256, head_hidden_size=D,
            num_multi_query_groups=G, num_attention_heads=G * HG, num_layers=2,
            vocab_size=256, max_sequence_length=128)
JCFG, TCFG = JConfig(**TINY), ChatGLM2Config(**TINY)
IDS = np.array([[5, 9, 100, 201, 77, 3, 250], [7, 8, 9, 0, 0, 0, 0]], np.int32)
LENGTHS = np.array([7, 3], np.int32)
TOL = dict(rtol=2e-4, atol=2e-4)  # tests/test_torch_model.py's
JRT = TpuRuntimeConfig(use_pallas=True, use_flash_attention=True)
TRT = TorchRuntimeConfig(use_kernels=True, use_flash_attention=True)
STEPS = 3


@pytest.fixture(scope="module")
def params():
    jp = JM.init_params(jax.random.PRNGKey(3), JCFG, "none", jnp.float32)
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


@pytest.fixture
def appends(monkeypatch):
    """Counts the decode steps' calls of the fused op; ``refuse`` stands in
    for the B3 / B9 wrappers that the decode step called before it."""
    calls = []
    fused = TA.rope_kv_append

    def spy(*args, **kw):
        calls.append(args[5])
        return fused(*args, **kw)

    def refuse(*args, **kw):
        raise AssertionError("the decode step wrote K/V apart from its RoPE")

    monkeypatch.setattr(TA, "rope_kv_append", spy)
    return calls, refuse


def test_decode_step_through_the_fused_op_matches_jax(params, appends, monkeypatch):
    jp, tp = params
    calls, refuse = appends
    jc = JM.init_kv_cache(JCFG, 2, 32, jnp.float32)
    jl, jc = JM.prefill(jp, JCFG, jnp.asarray(IDS), jnp.asarray(LENGTHS), jc, "none",
                        jnp.float32, JRT)
    tc = TM.init_kv_cache(TCFG, 2, 32, torch.float32, device="cpu")
    tl, tc = TM.prefill(tp, TCFG, torch.from_numpy(IDS), torch.from_numpy(LENGTHS), tc, "none",
                        torch.float32, TRT)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    monkeypatch.setattr(TA, "kv_cache_write_idx", refuse)
    step = jax.jit(lambda p, t, c: JM.decode_step(p, JCFG, t, c, "none", jnp.float32, JRT))
    for _ in range(STEPS):
        tok = jnp.argmax(jl, -1).astype(jnp.int32)
        jl, jc = step(jp, tok, jc)
        tl, tc = TM.decode_step(tp, TCFG, torch.from_numpy(np.array(tok)), tc, "none",
                                torch.float32, TRT)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    assert calls == list(range(TCFG.num_layers)) * STEPS
    np.testing.assert_array_equal(tc.lengths.numpy(), np.asarray(jc.lengths))
    for a, b in ((tc.k, jc.k), (tc.v, jc.v)):
        for row, n in enumerate(np.asarray(jc.lengths)):
            np.testing.assert_allclose(a[:, row, :, :n].numpy(), np.asarray(b)[:, row, :, :n],
                                       **TOL)


def test_decode_step_paged_through_the_fused_op_matches_jax(params, appends, monkeypatch):
    """Rows of 18 and 5 tokens on pages of 16: the steps cross a page edge."""
    jp, tp = params
    calls, refuse = appends
    pt = np.array([[5, 2, 7, 3], [8, 1, 6, 4]], np.int32)
    ids = np.zeros((2, 18), np.int32)
    ids[0] = np.arange(3, 21)
    ids[1, :5] = [7, 9, 11, 13, 15]
    lengths = np.array([18, 5], np.int32)
    jc = JPK.init_paged_kv_cache(JCFG, 2, 9, 64, 16, jnp.float32).replace(
        page_table=jnp.asarray(pt))
    tc = TPK.init_paged_kv_cache(TCFG, 2, 9, 64, 16, torch.float32, device="cpu")
    tc.page_table.copy_(torch.from_numpy(pt))
    jl, jc = JPK.prefill_paged(jp, JCFG, jnp.asarray(ids), jnp.asarray(lengths), jc, "none",
                               jnp.float32, JRT)
    tl, tc = TPK.prefill_paged(tp, TCFG, torch.from_numpy(ids), torch.from_numpy(lengths), tc,
                               "none", torch.float32, TRT)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    monkeypatch.setattr(TA, "kv_pool_write_idx", refuse)
    step = jax.jit(lambda p, t, c: JPK.decode_step_paged(p, JCFG, t, c, "none", jnp.float32,
                                                         JRT))
    for _ in range(STEPS):
        tok = jnp.argmax(jl, -1).astype(jnp.int32)
        jl, jc = step(jp, tok, jc)
        tl, tc = TPK.decode_step_paged(tp, TCFG, torch.from_numpy(np.array(tok)), tc, "none",
                                       torch.float32, TRT)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    assert calls == list(range(TCFG.num_layers)) * STEPS
    np.testing.assert_array_equal(tc.lengths.numpy(), np.asarray(jc.lengths))
    # the valid positions of each row agree, read through the page table
    for a, b in ((tc.k_pool, jc.k_pool), (tc.v_pool, jc.v_pool)):
        for layer in range(TCFG.num_layers):
            got = TPK.gather_layer(a, layer, tc.page_table).numpy()
            want = np.asarray(JPK.gather_layer(b, jnp.int32(layer), jc.page_table))
            for row, n in enumerate(np.asarray(jc.lengths)):
                np.testing.assert_allclose(got[row, :, :n], want[row, :, :n], **TOL)

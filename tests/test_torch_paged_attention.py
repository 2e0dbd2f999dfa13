"""The port's paged-pool attention and B5's chunked form against the JAX
package's Pallas kernels in interpret mode: the pool write (B9), paged ragged
decode (B10), chunk attention over the pool (B11) and flash prefill with
``q_starts`` / ``kv_row_map`` (B5's chunked form).

f32 at rtol/atol 1e-5 (tests/test_attention.py's tolerance); bf16 within one
bf16 rounding of the output (2^-8 of max|JAX|), with ``sm_scale`` = 0.3 so
that B10's and B11's scaling of q in q's dtype rounds.  The writes are exact.
Edges: length 0, lengths and starts exactly at and past the table's
capacity, scattered page tables, a garbage-table padding row and a row map.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from chatglm_q_tpu.ops import pallas_attention as PA  # noqa: E402
from chatglm_q_tpu_torch.ops import attention as TA  # noqa: E402

F32_TOL = dict(rtol=1e-5, atol=1e-5)
DTYPES = ["float32", "bfloat16"]
L, NP, G, P, D, Hg, MP = 3, 33, 2, 16, 16, 4, 4   # capacity MP·P = 64


def _rng(seed):
    return np.random.default_rng(seed)


def _pool(seed):
    r = _rng(seed)
    return (r.standard_normal((L, NP, G, P, D)).astype(np.float32),
            r.standard_normal((L, NP, G, P, D)).astype(np.float32))


def _tables(seed, B):
    """Distinct scattered pages per row (page 0 is the garbage page)."""
    return (_rng(seed).permutation(NP - 1)[: B * MP].reshape(B, MP) + 1).astype(np.int32)


def _cmp(got, want, dtype):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(jnp.asarray(want, jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(got, want, **F32_TOL)
    else:
        bf = 2.0 ** -8
        np.testing.assert_allclose(got, want, rtol=bf, atol=bf * np.abs(want).max())


def _to(a, dtype):
    return jnp.asarray(a, getattr(jnp, dtype)), torch.from_numpy(a).to(getattr(torch, dtype))


@pytest.mark.parametrize("dtype", DTYPES)
def test_pool_write_matches_pallas(dtype):
    """Starts inside a page, at a page edge, at capacity − 1 and past it."""
    B = 4
    kp, _ = _pool(0)
    pt = _tables(1, B)
    new = _rng(2).standard_normal((B, G, D)).astype(np.float32)
    starts = np.array([5, 16, MP * P - 1, MP * P + 7], np.int32)
    jpool, tpool = _to(kp, dtype)
    want = PA.kv_pool_write_idx(jpool, jnp.asarray(new), jnp.asarray(2), jnp.asarray(pt),
                                jnp.asarray(starts), interpret=True)
    want = np.asarray(want.astype(jnp.float32))
    for fn in (TA.kv_pool_write_idx_plain, TA.kv_pool_write_idx):
        pool = tpool.clone()
        out = fn(pool, torch.from_numpy(new), 2, torch.from_numpy(pt), torch.from_numpy(starts))
        assert out is pool  # in place
        np.testing.assert_array_equal(pool.float().numpy(), want)


@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_paged_matches_pallas(dtype):
    """Lengths 0, mid-page, at a page edge, at capacity − 1 and past it (the
    page loop clamps to MP), plus a length-0 padding row on the garbage
    table; read from layer 1."""
    B = 6
    kp, vp = _pool(3)
    pt = _tables(4, B)
    pt[5] = 0  # padding row: every block on the garbage page
    lengths = np.array([0, 7, 31, MP * P - 1, MP * P + 9, 0], np.int32)
    q = _rng(5).standard_normal((B, G, Hg, D)).astype(np.float32)
    sm = 0.3
    (jq, tq), (jk, tk), (jv, tv) = _to(q, dtype), _to(kp, dtype), _to(vp, dtype)
    want = PA.flash_attention_decode_paged(jq, jk, jv, jnp.asarray(1), jnp.asarray(pt),
                                           jnp.asarray(lengths), sm, interpret=True)
    args = (tq, tk, tv, 1, torch.from_numpy(pt), torch.from_numpy(lengths), sm)
    plain = TA.flash_attention_decode_paged_plain(*args)
    assert plain.dtype == tq.dtype
    _cmp(plain, want, dtype)
    assert torch.equal(TA.flash_attention_decode_paged(*args), plain)


@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_paged_outputs_zero_for_a_row_with_no_valid_slot(dtype):
    """A row of length −1 has no valid slot: JAX's B10 reads no page and its
    l == 0 guard outputs 0, and so must the plain version (it once averaged
    V over the masked slots, max|out| 0.381 against 0.0 on this input).
    L = 2, P = 16, MP = 3, read from layer 1, the other rows at 0, 10, 40."""
    Lx, NPx, MPx, Dx = 2, 14, 3, 128
    r = _rng(8)
    kp = r.standard_normal((Lx, NPx, G, P, Dx)).astype(np.float32)
    vp = r.standard_normal((Lx, NPx, G, P, Dx)).astype(np.float32)
    q = r.standard_normal((4, G, Hg, Dx)).astype(np.float32)
    pt = (r.permutation(NPx - 1)[: 4 * MPx].reshape(4, MPx) + 1).astype(np.int32)
    lengths = np.array([-1, 0, 10, 40], np.int32)
    sm = 1.0 / np.sqrt(Dx)
    (jq, tq), (jk, tk), (jv, tv) = _to(q, dtype), _to(kp, dtype), _to(vp, dtype)
    want = PA.flash_attention_decode_paged(jq, jk, jv, jnp.asarray(1), jnp.asarray(pt),
                                           jnp.asarray(lengths), sm, interpret=True)
    args = (tq, tk, tv, 1, torch.from_numpy(pt), torch.from_numpy(lengths), sm)
    plain = TA.flash_attention_decode_paged_plain(*args)
    assert not np.asarray(want.astype(jnp.float32))[0].any()
    assert not plain[0].float().any()
    _cmp(plain, want, dtype)
    assert torch.equal(TA.flash_attention_decode_paged(*args), plain)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("S", [1, 5])
def test_chunk_paged_matches_pallas(dtype, S):
    """Starts 0, across a page edge, ending at capacity and running past it;
    row_map reads the table rows in another order."""
    Bt, B = 5, 4
    kp, vp = _pool(6)
    pt = _tables(7, Bt)
    starts = np.array([0, 14, MP * P - S, MP * P - 2], np.int32)
    row_map = np.array([3, 0, 4, 1], np.int32)
    q = _rng(8).standard_normal((B, S, G, Hg, D)).astype(np.float32)
    sm = 0.3
    (jq, tq), (jk, tk), (jv, tv) = _to(q, dtype), _to(kp, dtype), _to(vp, dtype)
    for rmap in (None, row_map):
        table = pt[:B] if rmap is None else pt
        want = PA.flash_attention_chunk_paged(
            jq, jk, jv, jnp.asarray(2), jnp.asarray(table), jnp.asarray(starts), sm,
            row_map=None if rmap is None else jnp.asarray(rmap), interpret=True)
        targs = (tq, tk, tv, 2, torch.from_numpy(table), torch.from_numpy(starts), sm,
                 None if rmap is None else torch.from_numpy(rmap))
        plain = TA.flash_attention_chunk_paged_plain(*targs)
        _cmp(plain, want, dtype)
        assert torch.equal(TA.flash_attention_chunk_paged(*targs), plain)


@pytest.mark.parametrize("dtype", DTYPES)
def test_prefill_chunk_form_matches_pallas(dtype):
    """A compact chunk batch over a 4-row cache: row b of the chunk reads
    cache row kv_row_map[b], its queries sit at q_starts[b] + r, and lengths
    count the whole valid cache (0 for a padding row)."""
    Bc, B, S, T = 4, 3, 8, 32
    r = _rng(9)
    q = r.standard_normal((B, S, G, Hg, D)).astype(np.float32)
    k = r.standard_normal((Bc, G, T, D)).astype(np.float32)
    v = r.standard_normal((Bc, G, T, D)).astype(np.float32)
    starts = np.array([16, 0, 24], np.int32)
    lengths = np.array([16 + 8, 5, 0], np.int32)
    rmap = np.array([2, 0, 3], np.int32)
    sm = 0.3
    (jq, tq), (jk, tk), (jv, tv) = _to(q, dtype), _to(k, dtype), _to(v, dtype)
    want = PA.flash_attention_prefill(jq, jk, jv, jnp.asarray(lengths), sm, 8, 16,
                                      interpret=True, q_starts=jnp.asarray(starts),
                                      kv_row_map=jnp.asarray(rmap))
    targs = (tq, tk, tv, torch.from_numpy(lengths), sm, torch.from_numpy(starts),
             torch.from_numpy(rmap))
    plain = TA.flash_attention_prefill_plain(*targs)
    _cmp(plain, want, dtype)
    assert not plain[2].float().any()  # the length-0 row outputs 0
    assert torch.equal(TA.flash_attention_prefill(*targs), plain)
    assert torch.equal(TA.flash_attention_prefill_chunk(tq, tk, tv, targs[3], targs[5], sm,
                                                        targs[6]), plain)


def test_gather_pages_reassembles_the_pool():
    kp, _ = _pool(10)
    pt = _tables(11, 2)
    dense = TA.gather_pages(torch.from_numpy(kp)[1], torch.from_numpy(pt))
    assert dense.shape == (2, G, MP * P, D)
    for b in range(2):
        for j in range(MP):
            np.testing.assert_array_equal(dense[b, :, j * P:(j + 1) * P].numpy(), kp[1, pt[b, j]])

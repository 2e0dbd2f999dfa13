"""The port's attention plain versions (and the kernel wrappers' CPU paths)
against the JAX package's Pallas kernels in interpret mode: flash prefill,
ragged decode over the stacked cache, and the in-place KV write.  f32,
rtol/atol 1e-5 (the tests/test_attention.py tolerance)."""
import math
import pathlib
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from chatglm_q_tpu.ops import pallas_attention as PA  # noqa: E402
from chatglm_q_tpu_torch.ops import attention as TA  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)


def _randn(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def test_prefill_matches_pallas_ragged():
    """Ragged lengths with a 0-length row; S = 20 is no multiple of the
    requested blocks; the cache view is longer than the prompt."""
    B, S, G, Hg, D, T = 3, 20, 2, 4, 16, 32
    q, k, v = _randn((B, S, G, Hg, D), 0), _randn((B, G, T, D), 1), _randn((B, G, T, D), 2)
    lengths = np.array([20, 7, 0], np.int32)
    sm = 1.0 / math.sqrt(D)
    want = np.asarray(PA.flash_attention_prefill(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lengths), sm, 8, 16,
        interpret=True))
    args = [torch.from_numpy(a) for a in (q, k, v, lengths)]
    plain = TA.flash_attention_prefill_plain(*args, sm)
    np.testing.assert_allclose(plain.numpy(), want, **TOL)
    assert not plain[2].any()  # the 0-length row outputs 0
    np.testing.assert_array_equal(TA.flash_attention_prefill(*args, sm).numpy(), plain.numpy())


def test_decode_matches_pallas_idx_stacked_cache():
    """Lengths 0, mid and T-1 (slots 0..lengths inclusive), read from layer
    1 of a stacked (L, B, G, T, D) cache through its view."""
    L, B, G, Hg, D, T = 2, 3, 2, 4, 16, 64
    q = _randn((B, G, Hg, D), 3)
    k, v = _randn((L, B, G, T, D), 4), _randn((L, B, G, T, D), 5)
    lengths = np.array([0, 29, T - 1], np.int32)
    sm = 1.0 / math.sqrt(D)
    want = np.asarray(PA.flash_attention_decode_idx(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(1, jnp.int32),
        jnp.asarray(lengths), sm, 16, interpret=True))
    qt, kt, vt, lt = (torch.from_numpy(a) for a in (q, k, v, lengths))
    plain = TA.flash_attention_decode_plain(qt, kt[1], vt[1], lt, sm)
    np.testing.assert_allclose(plain.numpy(), want, **TOL)
    np.testing.assert_array_equal(TA.flash_attention_decode(qt, kt[1], vt[1], lt, sm).numpy(),
                                  plain.numpy())


def test_decode_plain_outputs_zero_for_a_row_with_no_valid_slot():
    """A row of length −1 has no valid slot: JAX's B4 outputs 0 there (its
    l == 0 guard), and so must the plain version (it once averaged V over
    the masked slots, 0.383 against 0.0 on this input)."""
    B, G, Hg, D, T = 4, 2, 4, 128, 64
    q, k, v = _randn((B, G, Hg, D), 8), _randn((B, G, T, D), 9), _randn((B, G, T, D), 10)
    lengths = np.array([-1, 0, 10, T - 1], np.int32)
    sm = 1.0 / math.sqrt(D)
    want = np.asarray(PA.flash_attention_decode(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lengths), sm, 16,
        interpret=True))
    args = [torch.from_numpy(a) for a in (q, k, v, lengths)]
    plain = TA.flash_attention_decode_plain(*args, sm)
    assert not want[0].any() and not plain[0].any()
    np.testing.assert_allclose(plain.numpy(), want, **TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kv_write_matches_pallas(dtype):
    L, B, G, T, D = 3, 2, 2, 16, 8
    cache = _randn((L, B, G, T, D), 6)
    new = _randn((B, G, D), 7)
    starts = np.array([0, 13], np.int32)
    jd = getattr(jnp, dtype)
    want = PA.kv_cache_write_idx(jnp.asarray(cache, jd), jnp.asarray(new), jnp.asarray(2),
                                 jnp.asarray(starts), interpret=True)
    want = np.asarray(want.astype(jnp.float32))
    td = getattr(torch, dtype)
    for fn in (TA.kv_cache_write_idx_plain, TA.kv_cache_write_idx):
        c = torch.from_numpy(cache).to(td)
        out = fn(c, torch.from_numpy(new), 2, torch.from_numpy(starts))
        assert out is c  # in place
        np.testing.assert_array_equal(c.float().numpy(), want)


@pytest.mark.parametrize("batch_groups", [1, 2, 8, 132])
@pytest.mark.parametrize("T", [40, 200, 1024, 32768])
@pytest.mark.parametrize("block_k", [64, 512, 1000])
def test_decode_span_is_whole_tiles_and_fills_the_card(batch_groups, T, block_k):
    """The decode kernel's span: whole 64-row tiles, at most ``block_k``
    rounded up to one, and shrunk only while the grid has fewer blocks than
    the H100 has SMs; where the rows allow, the grid reaches 132 blocks."""
    span = TA.decode_span(batch_groups, T, block_k)
    tile = TA.DECODE_TILE
    assert span % tile == 0 and tile <= span <= max(tile, -(-min(block_k, T) // tile) * tile)
    blocks = batch_groups * -(-T // span)
    if span > tile:
        assert blocks >= TA.DECODE_TARGET_BLOCKS
    assert blocks >= min(TA.DECODE_TARGET_BLOCKS, batch_groups * -(-T // tile))


@pytest.mark.parametrize("name,kernel_name", [
    ("HEAD_DIM", "ATT_D"), ("MAX_DECODE_HG", "MMA_HEADS"), ("DECODE_TILE", "KV_TK"),
    ("DECODE_SOLO_ROWS", "DA_SOLO_ROWS")])
def test_decode_constants_match_the_kernel_source(name, kernel_name):
    """The wrapper's copies of the decode kernel's compile-time constants
    (spans, checks, when the partials are needed) equal csrc/attention.cu's."""
    src = (pathlib.Path(TA.__file__).parents[1] / "csrc" / "attention.cu").read_text()
    found = re.search(rf"constexpr int {kernel_name} = (\d+);", src)
    assert found and int(found.group(1)) == getattr(TA, name)


def _decode_split_emulation(q, k, v, lengths, sm_scale, span, v2, solo_rows):
    """The CUDA decode kernel's arithmetic, in torch: per (b, g), spans of
    ``span`` rows (one span for a row of at most ``solo_rows`` valid slots);
    in a span, 64-row tiles of which each of 4 warps takes 16 rows with its
    own online softmax (f32 m, l, acc; p rounded to v's dtype per tile for
    B4, f32 for B12); the warps merge at the end of the span, and the spans
    that ran merge in span order.  A row with no valid slot outputs 0."""
    B, G, Hg, D = q.shape
    T = k.shape[2]
    qf = ((q.float() * sm_scale).to(q.dtype).float() if v2 else q.float())
    kf, vf = k.float(), v.float()
    out = torch.zeros((B, G, Hg, D), dtype=torch.float32)
    for b in range(B):
        n_valid = min(int(lengths[b]) + 1, T)
        span_b = max(span, -(-n_valid // 64) * 64) if n_valid <= solo_rows else span
        for g in range(G):
            spans = []
            for t_begin in range(0, max(n_valid, 0), span_b):
                t_end = min(t_begin + span_b, n_valid)
                warps = []
                for w in range(4):
                    m = torch.full((Hg,), -math.inf)
                    l, acc = torch.zeros(Hg), torch.zeros(Hg, D)
                    for t0 in range(t_begin + 16 * w, t_end, 64):
                        rows = torch.arange(t0, t0 + 16)
                        s = qf[b, g] @ kf[b, g, rows.clamp(max=T - 1)].T
                        s = s if v2 else s * sm_scale
                        s = s.masked_fill(rows[None, :] >= t_end, TA.MASK_VALUE)
                        m_next = torch.maximum(m, s.max(1).values)
                        alpha = torch.exp(m - m_next)
                        p = torch.exp(s - m_next[:, None])
                        l = alpha * l + p.sum(1)
                        pv = p if v2 else p.to(v.dtype).float()
                        vt = vf[b, g, rows.clamp(max=T - 1)] * (rows < t_end)[:, None]
                        acc = acc * alpha[:, None] + pv @ vt
                        m = m_next
                    warps.append((m, l, acc))
                mx = torch.stack([w[0] for w in warps]).max(0).values
                wts = [torch.exp(w[0] - mx) for w in warps]
                spans.append((mx, sum(w[1] * a for w, a in zip(warps, wts)),
                              sum(w[2] * a[:, None] for w, a in zip(warps, wts))))
            if not spans:
                continue
            mx = torch.stack([s[0] for s in spans]).max(0).values
            l = sum(s[1] * torch.exp(s[0] - mx) for s in spans)
            acc = sum(s[2] * torch.exp(s[0] - mx)[:, None] for s in spans)
            out[b, g] = acc / l[:, None]
    return out.to(q.dtype)


@pytest.mark.parametrize("solo_rows", [0, TA.DECODE_SOLO_ROWS])
@pytest.mark.parametrize("span", [64, 128])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("v2", [False, True])
def test_decode_split_emulation_matches_pallas(v2, dtype, span, solo_rows):
    """The split-T merge algebra of the decode kernel, held on the CPU
    against JAX's B4 / B12 in interpret mode: T = 200, Hg = 4, lengths −1,
    0, 63, 64 and 199; spans merged across blocks (solo_rows 0: the merge
    the kernel runs for rows longer than its one-span bound) and the
    kernel's rule for short rows; f32 within 1e-5, bf16 within 1e-2 of
    max|ref| (the per-warp bf16 rounding of p against JAX's per-block
    one)."""
    B, G, Hg, D, T = 5, 2, 4, 32, 200
    q, k, v = _randn((B, G, Hg, D), 11), _randn((B, G, T, D), 12), _randn((B, G, T, D), 13)
    lengths = np.array([-1, 0, 63, 64, 199], np.int32)
    sm = 0.3
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    fn = PA.flash_attention_decode_v2 if v2 else PA.flash_attention_decode
    want = np.asarray(fn(*(jnp.asarray(a, jd) for a in (q, k, v)), jnp.asarray(lengths), sm, 64,
                         interpret=True).astype(jnp.float32))
    got = _decode_split_emulation(*(torch.from_numpy(a).to(td) for a in (q, k, v)),
                                  torch.from_numpy(lengths), sm, span, v2,
                                  solo_rows).float().numpy()
    assert not got[0].any() and not want[0].any()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, **TOL)
    else:
        assert np.abs(got - want).max() <= 1e-2 * np.abs(want).max()

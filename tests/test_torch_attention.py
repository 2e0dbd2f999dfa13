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


@pytest.mark.parametrize("batch_groups", [2, 8, 24, 132])
@pytest.mark.parametrize("P,MP", [(16, 64), (96, 11), (256, 8), (8, 3)])
def test_decode_paged_span_is_decodes_rule_over_the_capacity(batch_groups, P, MP):
    """B10 splits the table's capacity MP·P as B4 splits T: whole tiles, the
    grid filled where the rows allow; at the engines' shape (B = 4, G = 2,
    P = 256, MP = 8) that is one 64-row tile a block."""
    span = TA.decode_paged_span(batch_groups, P, MP)
    assert span == TA.decode_span(batch_groups, MP * P, TA.DECODE_BLOCK_K)
    assert span % TA.DECODE_TILE == 0
    blocks = batch_groups * -(-(MP * P) // span)
    assert blocks >= min(TA.DECODE_TARGET_BLOCKS, batch_groups * -(-(MP * P) // TA.DECODE_TILE))
    assert TA.decode_paged_span(8, 256, 8) == TA.DECODE_TILE


@pytest.mark.parametrize("B,S,Hg", [(4, 9, 16), (4, 32, 16), (1, 128, 4), (1, 1, 16),
                                    (64, 32, 16)])
@pytest.mark.parametrize("T", [64, 200, 1056, 2048, 65536])
def test_chunk_span_fills_the_card_within_bounded_partials(B, S, Hg, T):
    """B11's span: whole tiles, at least CHUNK_MIN_SPAN rows (or the whole
    capacity), at most CHUNK_MAX_SPANS spans, halved only while the grid
    has fewer blocks than the H100 has SMs, so that the f32 partials stay
    within about 2·132 blocks' worth (17.6 MB) whatever S·Hg is; one span
    needs none."""
    G = 2
    units = TA.chunk_units(B, G, S, Hg)
    assert units == B * G * -(-S // (TA.PREFILL_ROWS // Hg))
    span = TA.chunk_span(units, T)
    nspan = -(-T // span)
    assert span % TA.DECODE_TILE == 0
    assert span >= min(TA.CHUNK_MIN_SPAN, -(-T // TA.DECODE_TILE) * TA.DECODE_TILE)
    assert nspan <= TA.CHUNK_MAX_SPANS
    if span > max(TA.CHUNK_MIN_SPAN, -(-T // TA.CHUNK_MAX_SPANS)):  # stopped by the grid
        assert nspan == 1 or units * nspan >= TA.DECODE_TARGET_BLOCKS
    floats = TA.chunk_partial_floats(units, T)
    per_block = TA.PREFILL_ROWS * (TA.HEAD_DIM + 2)
    assert floats == (0 if nspan == 1 else units * nspan * per_block)
    assert floats * 4 <= 2 * TA.DECODE_TARGET_BLOCKS * per_block * 4 or nspan == TA.CHUNK_MAX_SPANS


def test_chunk_spans_fit_the_merge_in_shared_memory():
    """The merging block holds every span's (m, l) and weight of its rows
    (12 bytes a row a span, then 4 a row for the l-sum) in the bytes of the
    prefill tile's shared memory; the wrapper's CHUNK_MAX_SPANS keeps
    within them, and its PREFILL_ROWS is the kernel's PF_ROWS."""
    src = (pathlib.Path(TA.__file__).parents[1] / "csrc" / "attention.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    rows = const("PF_WARPS") * 16
    assert rows == TA.PREFILL_ROWS
    smem = (rows + 2 * const("PF_STAGES") * const("KV_TK")) * (const("ATT_D") + 8) * 2
    assert TA.CHUNK_MAX_SPANS * rows * 12 + rows * 4 <= smem


def _chunk_split_emulation(q, k_pool, v_pool, layer, page_table, starts, sm_scale, span):
    """The CUDA chunk kernel's arithmetic (B11), in torch: per (b, g), query
    blocks of PREFILL_ROWS folded rows (position r // Hg, head r % Hg); per
    block the K/V positions below its last causal bound (and the capacity)
    in spans of ``span`` rows; in a span, 64-row tiles, each warp of 16 rows
    with its own online softmax (q pre-scaled in its dtype, f32 p), skipping
    a tile wholly above its rows and masking at MASK_VALUE past a row's
    position or the span; the spans then merge by their (m, l)."""
    B, S, G, Hg, D = q.shape
    cap = page_table.shape[1] * k_pool.shape[3]
    k = TA.gather_pages(k_pool[layer], page_table).float()
    v = TA.gather_pages(v_pool[layer], page_table).float()
    qf = TA._prescaled(q, sm_scale)
    qt = TA.PREFILL_ROWS // Hg
    out = torch.zeros((B, S, G, Hg, D), dtype=torch.float32)
    for b in range(B):
        start = int(starts[b])
        for g in range(G):
            for q0 in range(0, S, qt):
                rows = min(qt, S - q0) * Hg
                qpos = start + q0 + torch.arange(rows) // Hg
                qrows = qf[b, q0:q0 + rows // Hg, g].reshape(rows, D)
                n_read = min(start + q0 + rows // Hg, cap)
                spans = []
                for t_begin in range(0, n_read, span):
                    t_end = min(t_begin + span, n_read)
                    m = torch.full((rows,), -math.inf)
                    l, acc = torch.zeros(rows), torch.zeros(rows, D)
                    for r0 in range(0, rows, 16):
                        w = slice(r0, min(r0 + 16, rows))
                        for t0 in range(t_begin, t_end, 64):
                            if t0 > int(qpos[w].max()):
                                continue
                            pos = torch.arange(t0, t0 + 64)
                            s = qrows[w] @ k[b, g, pos.clamp(max=cap - 1)].T
                            ok = (pos[None, :] <= qpos[w, None]) & (pos[None, :] < t_end)
                            s = s.masked_fill(~ok, TA.MASK_VALUE)
                            m_next = torch.maximum(m[w], s.max(1).values)
                            alpha = torch.exp(m[w] - m_next)
                            p = torch.exp(s - m_next[:, None])
                            vt = v[b, g, pos.clamp(max=cap - 1)] * (pos < t_end)[:, None]
                            l[w] = alpha * l[w] + p.sum(1)
                            acc[w] = acc[w] * alpha[:, None] + p @ vt
                            m[w] = m_next
                    spans.append((m, l, acc))
                mx = torch.stack([s[0] for s in spans]).max(0).values
                lsum = sum(s[1] * torch.exp(s[0] - mx) for s in spans)
                a = sum(s[2] * torch.exp(s[0] - mx)[:, None] for s in spans)
                out[b, q0:q0 + rows // Hg, g] = (a / lsum[:, None]).reshape(rows // Hg, Hg, D)
    return out.to(q.dtype)


@pytest.mark.parametrize("span", [64, 128])
@pytest.mark.parametrize("Hg", [4, 64])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chunk_split_emulation_matches_pallas(dtype, Hg, span):
    """B11's split over K/V spans and its merge, held on the CPU against
    JAX's B11 in interpret mode: capacity 192 (12 pages of 16), S = 5,
    starts 0, 14 (across a page edge), 100, capacity − S and past it, so
    that spans hold none, some or all of a query's positions (a span above a
    query weighs 0 in the merge); Hg = 64 puts two positions in a block.
    f32 within 1e-5, bf16 within 1e-2 of max|ref|."""
    L, NP, G, P, D, MP, S = 2, 61, 2, 16, 16, 12, 5
    cap = MP * P
    r = np.random.default_rng(21)
    kp = r.standard_normal((L, NP, G, P, D)).astype(np.float32)
    vp = r.standard_normal((L, NP, G, P, D)).astype(np.float32)
    q = r.standard_normal((5, S, G, Hg, D)).astype(np.float32)
    pt = (r.permutation(NP - 1)[: 5 * MP].reshape(5, MP) + 1).astype(np.int32)
    starts = np.array([0, 14, 100, cap - S, cap - 2], np.int32)
    sm = 0.3
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = np.asarray(PA.flash_attention_chunk_paged(
        *(jnp.asarray(a, jd) for a in (q, kp, vp)), jnp.asarray(1), jnp.asarray(pt),
        jnp.asarray(starts), sm, interpret=True).astype(jnp.float32))
    got = _chunk_split_emulation(*(torch.from_numpy(a).to(td) for a in (q, kp, vp)), 1,
                                 torch.from_numpy(pt), torch.from_numpy(starts), sm,
                                 span).float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, **TOL)
    else:
        assert np.abs(got - want).max() <= 1e-2 * np.abs(want).max()

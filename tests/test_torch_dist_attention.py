"""The port's sharded attention forms against the JAX package's, on the CPU,
in one process: the same numpy inputs from a seed, the JAX kernels in
interpret mode.

* K1: ``flash_attention_decode_lse_plain`` (B4's ``return_lse`` form on a
  T-shard) against JAX ``flash_attention_decode(return_lse=True)`` on the
  shard's slice with its local lengths (pallas_attention.py:1246-1254),
  f32 and bf16, with rows whose shard holds no slot;
* K2: ``flash_attention_decode_paged_lse_plain`` against JAX
  ``flash_attention_decode_paged(stride, phase, return_lse=True)`` at
  stride 2 and 4, every phase, lengths −1, within a page, across pages and
  past the capacity, and the strided local table against JAX's
  (:1176-1183), its tail columns clamped;
* ``merge_lse_partials`` against JAX ``_merge_lse_partials`` under
  ``shard_map``, and the row empty on every shard: 0 here, NaN there;
* K3: ``rope_kv_append_sharded_plain`` on every shard against the plain
  RoPE + writes on the whole cache (``rope_kv_append_plain``, held against
  JAX in tests/test_torch_rope_kv_append.py), a rank that does not hold the
  slot writing nothing; q against JAX's ``apply_rotary_emb``;
* chip_smoke.py's ``hold_merge`` on the plain partials: the merge within
  the design's bound beyond the unsharded function in f32, an equal-weight
  merge beyond it.
"""
import importlib.util
import math
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from chatglm_q_tpu.models.chatglm2 import apply_rotary_emb as j_rope  # noqa: E402
from chatglm_q_tpu.ops import pallas_attention as JPA  # noqa: E402
from chatglm_q_tpu.parallel import sharding as JS  # noqa: E402
from chatglm_q_tpu_torch.models.chatglm2 import precompute_freqs_cis  # noqa: E402
from chatglm_q_tpu_torch.ops import attention as A  # noqa: E402

DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}
# (out of max|out|, m and l relative): f32 sums in another order; in bf16 the
# kernel rounds p to bf16 against its running max, the plain version against
# the final max, one bf16 rounding of the output apart
TOLS = {"float32": (1e-5, 1e-6), "bfloat16": (1e-2, 1e-5)}


def t(a, dtype=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dtype)


def j(a, dtype=jnp.float32):
    return jnp.asarray(a, dtype)


def hold(got, want, dtype):
    """(out, m, l) of the port against JAX's: out within its tolerance of
    max|out|, m and l relative; −inf m and 0 l at the same places."""
    out_tol, lse_tol = TOLS[dtype]
    (o, m, l), (jo, jm, jl) = got, [np.asarray(x, np.float64) for x in want]
    o, m, l = (x.double().numpy() for x in (o, m, l))
    assert np.abs(o - jo).max() <= out_tol * max(np.abs(jo).max(), 1e-30)
    np.testing.assert_array_equal(np.isinf(m), np.isinf(jm))
    fin = np.isfinite(jm)
    assert np.all(np.abs(m[fin] - jm[fin]) <= lse_tol * np.maximum(np.abs(jm[fin]), 1.0))
    np.testing.assert_array_equal(l == 0, jl == 0)
    pos = jl > 0
    assert np.all(np.abs(l[pos] - jl[pos]) <= lse_tol * jl[pos])
    assert not o[~fin].any()


# ---------------------------------------------------------------------------
# K1
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shard", [0, 1, 3])
def test_decode_lse_matches_jax_on_a_t_shard(dtype, shard):
    """Shard ``shard`` of a 4-way T split of a 128-slot cache (32 slots):
    rows ending before it (empty: 0, −inf, 0), inside it, at its last slot
    and past it, and a length −1 row."""
    rng = np.random.RandomState(20 + shard)
    B, G, Hg, D, T, tp = 6, 2, 4, 128, 128, 4
    Tl, off = T // tp, shard * (T // tp)
    q, k, v = rng.randn(B, G, Hg, D), rng.randn(B, G, T, D), rng.randn(B, G, T, D)
    lengths = np.array([-1, 5, 40, 63, 95, 127], np.int32)
    td, jd = DTYPES[dtype]
    sm = 1 / np.sqrt(D)
    ks, vs = k[:, :, off:off + Tl], v[:, :, off:off + Tl]
    got = A.flash_attention_decode_lse_plain(t(q, td), t(ks, td), t(vs, td), t(lengths), sm, off)
    local = np.clip(lengths + 1 - off, 0, Tl) - 1
    want = JPA.flash_attention_decode(j(q, jd), j(ks, jd), j(vs, jd), j(local, jnp.int32), sm,
                                      16, interpret=True, return_lse=True)
    hold(got, want, dtype)


def test_decode_lse_at_offset_zero_is_b4():
    """The whole cache (offset 0): K1's output is B4's plain output."""
    rng = np.random.RandomState(3)
    q, k, v = (t(rng.randn(*s)) for s in ((3, 2, 4, 32), (3, 2, 40, 32), (3, 2, 40, 32)))
    lengths = t(np.array([-1, 17, 45], np.int32))
    out, m, l = A.flash_attention_decode_lse_plain(q, k, v, lengths, 0.2)
    torch.testing.assert_close(out, A.flash_attention_decode_plain(q, k, v, lengths, 0.2),
                               rtol=1e-6, atol=1e-6)
    assert torch.isinf(m[0]).all() and not l[0].any()


# ---------------------------------------------------------------------------
# K2 and the strided local table
# ---------------------------------------------------------------------------

def _paged(seed, stride, MPl=3, P_=8):
    rng = np.random.RandomState(seed)
    L, NP, G, Hg, D, B = 2, 13, 2, 4, 32, 7
    cap = MPl * stride * P_  # the logical capacity the table's columns reach
    pool_k, pool_v = rng.randn(L, NP, G, P_, D), rng.randn(L, NP, G, P_, D)
    table = rng.randint(0, NP, (B, MPl)).astype(np.int32)
    lengths = np.array([-1, 0, P_ - 1, P_, 3 * P_ + 2, cap - 1, cap + 20], np.int32)
    return rng.randn(B, G, Hg, D), pool_k, pool_v, table, lengths


@pytest.mark.parametrize("stride,phase", [(2, 0), (2, 1), (4, 0), (4, 1), (4, 2), (4, 3)])
def test_decode_paged_lse_matches_jax(stride, phase):
    q, kp, vp, table, lengths = _paged(30 + 4 * stride + phase, stride)
    sm = 1 / np.sqrt(q.shape[-1])
    got = A.flash_attention_decode_paged_lse_plain(t(q), t(kp), t(vp), 1, t(table), t(lengths),
                                                   sm, stride, phase)
    want = JPA.flash_attention_decode_paged(
        j(q), j(kp), j(vp), jnp.int32(1), j(table, jnp.int32), j(lengths, jnp.int32), sm,
        interpret=True, stride=stride, phase=jnp.full((1,), phase, jnp.int32), return_lse=True)
    hold(got, want, "float32")


def test_decode_paged_lse_matches_jax_in_bf16():
    q, kp, vp, table, lengths = _paged(41, 2)
    sm = 1 / np.sqrt(q.shape[-1])
    got = A.flash_attention_decode_paged_lse_plain(
        t(q, torch.bfloat16), t(kp, torch.bfloat16), t(vp, torch.bfloat16), 0, t(table),
        t(lengths), sm, 2, 1)
    want = JPA.flash_attention_decode_paged(
        j(q, jnp.bfloat16), j(kp, jnp.bfloat16), j(vp, jnp.bfloat16), jnp.int32(0),
        j(table, jnp.int32), j(lengths, jnp.int32), sm, interpret=True, stride=2,
        phase=jnp.full((1,), 1, jnp.int32), return_lse=True)
    hold(got, want, "bfloat16")


class _MeshAt:
    def __init__(self, nd, tp, d, m):
        self.n_data, self.n_model, self.data_index, self.model_index = nd, tp, d, m


@pytest.mark.parametrize("MP,tp", [(8, 2), (7, 2), (9, 4), (6, 4)])
def test_msharded_page_table_matches_jax(MP, tp):
    """JAX's local strided view (:1176-1183): column i ← logical block
    i·tp + r, columns past MP clamped to the last, ids made local to the
    rank's sub-pool and clipped."""
    rng = np.random.RandomState(MP * tp)
    nd, sp = 2, 5
    pt = rng.randint(0, nd * tp * sp, (4, MP)).astype(np.int32)
    for d in range(nd):
        for r in range(tp):
            idx = jnp.minimum(r + tp * jnp.arange(-(-MP // tp)), MP - 1)
            want = jnp.clip(jnp.take(j(pt, jnp.int32), idx, axis=1) - (d * tp + r) * sp, 0,
                            sp - 1)
            got = A.msharded_page_table(t(pt, torch.int32), _MeshAt(nd, tp, d, r), sp)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
            got = A.sharded_page_table(t(pt, torch.int32), _MeshAt(nd, tp, d, r), sp * tp)
            want = np.clip(pt - d * sp * tp, 0, sp * tp - 1)  # JAX :1117-1122
            np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# the merge
# ---------------------------------------------------------------------------

def _partials(seed, tp, empty_rows=()):
    rng = np.random.RandomState(seed)
    B, G, Hg, D = 3, 2, 4, 16
    out = rng.randn(tp, B, G, Hg, D).astype(np.float32)
    m = (rng.randn(tp, B, G, Hg) * 3).astype(np.float32)
    l = rng.uniform(0.5, 20, (tp, B, G, Hg)).astype(np.float32)
    m[0, 1] = -np.inf  # one shard empty for row 1
    l[0, 1] = 0
    out[0, 1] = 0
    for b in empty_rows:
        m[:, b], l[:, b], out[:, b] = -np.inf, 0, 0
    return out, m, l


def _jax_merge(out, m, l, tp):
    mesh = JS.make_mesh(1, tp)

    def local(o, mm, ll):
        return JPA._merge_lse_partials(o[0], mm[0], ll[0], "model", jnp.float32)[None]

    fn = jax.shard_map(local, mesh=mesh, in_specs=(P("model"),) * 3, out_specs=P("model"),
                       check_vma=False)
    return np.asarray(fn(j(out), j(m), j(l)))[0]


@pytest.mark.parametrize("tp", [2, 4])
def test_merge_lse_partials_matches_jax(tp):
    out, m, l = _partials(50 + tp, tp)
    got = A.merge_lse_partials(t(out), t(m), t(l), torch.float32)
    np.testing.assert_allclose(got.numpy(), _jax_merge(out, m, l, tp), rtol=1e-6, atol=1e-6)


def test_merge_lse_partials_gives_zero_where_jax_gives_nan():
    """A row with no valid slot on any shard (length −1): every shard has m
    = −inf and l = 0; JAX's exp(m − max m) is exp(−inf + inf) = NaN, the
    port's 0, as the unsharded kernels give (ROADMAP §C)."""
    out, m, l = _partials(60, 2, empty_rows=(2,))
    got = A.merge_lse_partials(t(out), t(m), t(l), torch.float32).numpy()
    want = _jax_merge(out, m, l, 2)
    assert np.isnan(want[2]).all() and not np.isnan(want[:2]).any()
    assert (got[2] == 0).all()
    np.testing.assert_allclose(got[:2], want[:2], rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# K3
# ---------------------------------------------------------------------------

def _append_inputs(seed, B, G, Hg, D, cap):
    rng = np.random.RandomState(seed)
    q = t(rng.randn(B, G, Hg, D), torch.bfloat16)
    kv = t(rng.randn(B, 2 * G * D), torch.bfloat16)
    table = t(precompute_freqs_cis(D, cap + 1), torch.bfloat16)
    return q, kv, table


@pytest.mark.parametrize("tp", [2, 4])
def test_rope_kv_append_sharded_dense_matches_the_whole_cache(tp):
    """Each T-shard's write against the unsharded append on the whole cache:
    starts in every shard, at a shard's last slot, at the wall and past it
    (clamped to T − 1, on the last shard), and q rotated on every rank as
    JAX rotates it; a shard not holding a row's slot writes nothing."""
    L, B, G, Hg, D, T = 2, 6, 2, 4, 16, 64
    Tl = T // tp
    q, kv, table = _append_inputs(tp, B, G, Hg, D, T)
    starts = torch.tensor([0, Tl - 1, Tl, T - 1, T, T + 9], dtype=torch.int32)
    freqs = table[(starts.long() + 1).clamp(max=T)]
    rng = np.random.RandomState(5)
    k, v = (t(rng.randn(L, B, G, T, D), torch.bfloat16) for _ in range(2))
    kw, vw = k.clone(), v.clone()
    rot = A.rope_kv_append_plain(q, kv, freqs, kw, vw, 1, starts)
    np.testing.assert_array_equal(
        rot.float().numpy(),
        np.asarray(j_rope(j(q.float().numpy(), jnp.bfloat16),
                          j(freqs.float().numpy(), jnp.bfloat16)[:, None, None, :]),
                   np.float32))
    for r in range(tp):
        ks, vs = k[..., r * Tl:(r + 1) * Tl, :].clone(), v[..., r * Tl:(r + 1) * Tl, :].clone()
        before = ks.clone()
        got = A.rope_kv_append_sharded(q, kv, freqs, ks, vs, 1, starts,
                                       A.KVShard(offset=r * Tl, total=T))
        assert torch.equal(got, rot)
        assert torch.equal(ks, kw[..., r * Tl:(r + 1) * Tl, :])
        assert torch.equal(vs, vw[..., r * Tl:(r + 1) * Tl, :])
        holds = [(min(int(s), T - 1) // Tl) == r for s in starts]
        for b, own in enumerate(holds):  # a row whose slot is elsewhere: unchanged
            if not own:
                assert torch.equal(ks[:, b], before[:, b])


@pytest.mark.parametrize("tp", [2, 4])
def test_rope_kv_append_sharded_paged_matches_the_whole_pool(tp):
    """Each phase's writes through its strided local table against the
    unsharded append through the whole table: logical block j on phase
    j % tp, positions past the capacity clamped to its last slot."""
    L, B, G, Hg, D, P_, MP = 2, 5, 2, 4, 16, 8, 8
    sp = B * MP // tp + 1
    cap = MP * P_
    pt = torch.tensor([[(j % tp) * sp + 1 + b * (MP // tp) + j // tp for j in range(MP)]
                       for b in range(B)], dtype=torch.int32)
    q, kv, table = _append_inputs(10 + tp, B, G, Hg, D, cap)
    starts = torch.tensor([0, P_ - 1, P_, 3 * P_ + 5, cap + 3], dtype=torch.int32)
    freqs = table[(starts.long() + 1).clamp(max=cap)]
    rng = np.random.RandomState(7)
    kp, vp = (t(rng.randn(L, tp * sp, G, P_, D), torch.bfloat16) for _ in range(2))
    kw, vw = kp.clone(), vp.clone()
    rot = A.rope_kv_append_plain(q, kv, freqs, kw, vw, 0, starts, pt)
    for r in range(tp):
        ks, vs = kp[:, r * sp:(r + 1) * sp].clone(), vp[:, r * sp:(r + 1) * sp].clone()
        table_r = A.msharded_page_table(pt, _MeshAt(1, tp, 0, r), sp)
        got = A.rope_kv_append_sharded(q, kv, freqs, ks, vs, 0, starts,
                                       A.KVShard(stride=tp, phase=r, total=cap), table_r)
        assert torch.equal(got, rot)
        assert torch.equal(ks, kw[:, r * sp:(r + 1) * sp])
        assert torch.equal(vs, vw[:, r * sp:(r + 1) * sp])


def _chip_smoke():
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("kernel", ["K1", "K2"])
def test_hold_merge_passes_the_merge_and_fails_equal_weights(kernel):
    """The phase-2 merge check of chip_smoke.py on the plain partials of two
    shards (bf16, lengths across both, within one, −1): the merge reads 0
    beyond the design's roundings (K1 with its p term, K2 with p in f32),
    a merge with equal shard weights beyond B12_TOL / B10_TOL."""
    CS = _chip_smoke()
    g = torch.Generator().manual_seed(5)
    B, G, Hg, D, tp = 4, 2, 16, 128, 2
    sm = 1.0 / math.sqrt(D)

    def bf(*shape):
        return torch.randn(shape, generator=g).to(torch.bfloat16)

    q = bf(B, G, Hg, D)
    if kernel == "K1":
        T = 1024
        Tl = T // tp
        k, v = bf(B, G, T, D), bf(B, G, T, D)
        lens = torch.tensor([1000, 700, 300, -1], dtype=torch.int32)
        parts = [A.flash_attention_decode_lse_plain(
            q, k[:, :, r * Tl:(r + 1) * Tl].contiguous(), v[:, :, r * Tl:(r + 1) * Tl].contiguous(),
            lens, sm, r * Tl) for r in range(tp)]
        qf, kf, vf = q.float(), k.float(), v.float()
        want32 = A.flash_attention_decode_lse_plain(qf, kf, vf, lens, sm)[0]
        abs32 = A.flash_attention_decode_lse_plain(qf, kf, vf.abs(), lens, sm)[0]
        limit = CS.B12_TOL
    else:
        P, MP = 64, 16
        sp = B * MP // tp + 1
        pt = torch.tensor([[(j % tp) * sp + 1 + b * (MP // tp) + j // tp for j in range(MP)]
                           for b in range(B)], dtype=torch.int32)
        kp, vp = bf(1, tp * sp, G, P, D), bf(1, tp * sp, G, P, D)
        lens = torch.tensor([900, 500, 63, -1], dtype=torch.int32)
        parts = []
        for r in range(tp):
            table = A.msharded_page_table(pt, CS._MeshAt(tp, r), sp)
            parts.append(A.flash_attention_decode_paged_lse_plain(
                q, kp[:, r * sp:(r + 1) * sp].contiguous(), vp[:, r * sp:(r + 1) * sp].contiguous(),
                0, table, lens, sm, tp, r))
        want32 = CS.decode_v2_f32(torch, q, A.gather_pages(kp[0], pt), A.gather_pages(vp[0], pt),
                                  lens, sm)
        abs32, limit = None, CS.B10_TOL
    merged, err, ctrl = CS.hold_merge(torch, kernel, tuple(torch.stack(x) for x in zip(*parts)),
                                      want32, abs32, limit, "cpu")
    assert err <= limit < ctrl
    assert not merged[3].float().any()

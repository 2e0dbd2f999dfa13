"""B1's and B6's f32 forms (f32 x as its three bf16 pieces on the tensor
cores) on the CPU: what can be checked without the card.

* ``split_bf16x3`` (ops/quant.py), the plain version of the kernels' split
  (csrc/common.cuh): hi + mid + lo equals x bit for bit over random f32 in
  every binade from 2^-110 to f32's largest, and ±0; below 2^-110 within
  2^-134 absolute (lo among bf16's subnormals); above bf16's largest finite
  value hi truncated toward zero, still exact; a non-finite x as hi, with
  mid = lo = 0.
* The f32 forms' arithmetic emulated in torch: the split-K kernel's (the
  pieces staged as three rows an x row, each summed over K on its own, the
  warps' sums in warp order and the splits' in the plan's split order) and
  the Hopper kernel's (lo's, mid's, then hi's products of each 32-element
  half into a fresh partial a group, B1, or a 64-element stage, B6, the
  splits' sums in split order),
  each group's partial times its scale (int4g32), against the JAX
  package's f32 path on the same numpy inputs
  (``chatglm_q_tpu.ops.linear``'s jnp fallback; for int4 also the decode-M
  kernel ``int4_matmul_pallas_pipelined`` in interpret mode): within 1e-5
  of max|y| and within F32_SUM_C · 2^-24 · Σ_k |x_k·w_k| of each output.
  The same emulation without lo, on inputs whose lo pieces add up, must
  exceed that limit.
* Routes, plans and plan-table keys of the f32 forms.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from chatglm_q_tpu.ops import linear as JL  # noqa: E402
from chatglm_q_tpu.ops import pallas_matmul as PM  # noqa: E402
from chatglm_q_tpu_torch.ops import autotune as AT  # noqa: E402
from chatglm_q_tpu_torch.ops import int8_matmul as I8  # noqa: E402
from chatglm_q_tpu_torch.ops import quant_matmul as QM  # noqa: E402
from chatglm_q_tpu_torch.ops.quant import split_bf16x3, unpack_int4_tpu_q  # noqa: E402

F32 = torch.float32
# chip_smoke.py's: 1.5x the largest reading of |kernel - plain| / (2^-24
# Σ|x_k w_k|) over its seeds; a control without lo exceeds it
F32_SUM_C = 25.0
KW = QM.SPLITK_KW
# (K, N) at storage sizes: q_proj, kv_proj, w_in_h / w_in_gate, w_out, lm_head
LINEARS = [(4096, 4096), (4096, 512), (4096, 13824), (13824, 4096), (4096, 65536)]


# ---------------------------------------------------------------------------
# The split
# ---------------------------------------------------------------------------

def _f32(bits):
    return torch.tensor(bits, dtype=torch.int64).to(torch.int32).view(F32)


def _binade_values(rng, e0, e1, per=64):
    """``per`` random f32 of each sign in every binade [2^e, 2^(e+1)), e0 ≤ e ≤ e1."""
    e = np.repeat(np.arange(e0, e1 + 1), per)
    mant = rng.integers(0, 1 << 23, e.size)
    sign = rng.integers(0, 2, e.size)
    return _f32(((sign << 31) | ((e + 127) << 23) | mant).tolist())


def _pieces_f64(x):
    hi, mid, lo = split_bf16x3(x)
    for p in (hi, mid, lo):
        assert p.dtype == torch.bfloat16
    return hi.double(), mid.double(), lo.double()


def test_split_is_exact_in_every_binade_from_2_to_the_minus_110():
    x = torch.cat([_binade_values(np.random.default_rng(0), -110, 127),
                   torch.tensor([0.0, -0.0, 2.0 ** -110, -(2.0 ** -110)]),
                   _f32([0x7F7FFFFF, 0xFF7FFFFF])])  # f32's largest
    hi, mid, lo = _pieces_f64(x)
    assert torch.equal(hi + mid + lo, x.double())
    # the f32 sum, smallest first, is x bit for bit (but -0: its residual
    # pieces are +0, and +0 + -0 is +0)
    s = (lo.float() + mid.float()) + hi.float()
    nz = x != 0
    assert torch.equal(s[nz].view(torch.int32), x[nz].view(torch.int32))
    assert (s[~nz] == 0).all() and torch.equal(hi[~nz].view(torch.int64),
                                               x[~nz].double().view(torch.int64))
    # each piece holds about 8 bits below the previous one's (7 below a
    # truncated hi)
    assert (lo.abs() <= 2.0 ** -15 * x.double().abs()).all()
    assert (mid.abs() <= 2.0 ** -7 * x.double().abs()).all()


def test_split_above_bf16_max_truncates_hi():
    # bf16's largest finite value is 0x7F7F: (2 - 2^-7) · 2^127 ≈ 3.3895e38;
    # from (2 - 2^-8) · 2^127 on, bf16(x) rounds to inf
    x = torch.cat([_f32(list(range(0x7F7F8000, 0x7F800000, 97)) + [0x7F7FFFFF]),
                   torch.tensor([3.3895e38, 3.39e38, 3.4e38])])
    x = torch.cat([x, -x])
    hi, mid, lo = _pieces_f64(x)
    assert torch.isfinite(hi).all()
    assert torch.equal(hi + mid + lo, x.double())
    big = torch.isinf(x.to(torch.bfloat16))  # where round-to-nearest overflows
    assert big.sum() > 4 and not big.all()
    assert (x.abs()[big] >= 3.3961e38).all()
    assert (hi.abs()[big] == float(torch.finfo(torch.bfloat16).max)).all()
    assert (hi.abs()[big] <= x.double().abs()[big]).all()  # toward zero


def test_split_below_2_to_the_minus_110_is_within_2_to_the_minus_134():
    rng = np.random.default_rng(1)
    x = torch.cat([_binade_values(rng, -126, -111),
                   _f32(rng.integers(1, 1 << 23, 512).tolist()),  # f32 subnormals
                   _f32((rng.integers(1, 1 << 23, 512) | (1 << 31)).tolist())])
    hi, mid, lo = _pieces_f64(x)
    err = (hi + mid + lo - x.double()).abs()
    assert err.max() <= 2.0 ** -134
    assert err.max() > 0  # the bound is reached in kind: lo does lose bits here


def test_split_of_non_finite_values():
    x = torch.tensor([float("inf"), float("-inf"), float("nan")])
    hi, mid, lo = split_bf16x3(x)
    assert torch.isposinf(hi[0]) and torch.isneginf(hi[1]) and torch.isnan(hi[2])
    assert (mid == 0).all() and (lo == 0).all()
    # inf · q and NaN propagate as the f32 product does: each piece's product
    # with a finite nonzero weight, summed smallest first
    for q in (3.0, -5.0):
        y = (lo.float() * q + mid.float() * q) + hi.float() * q
        ref = x * q
        assert torch.equal(torch.isnan(y), torch.isnan(ref))
        assert torch.equal(y[:2], ref[:2])


# ---------------------------------------------------------------------------
# The split-K arithmetic against JAX's f32 path
# ---------------------------------------------------------------------------

def _body(M, N, K, plan, part_of_group, scale_group):
    """sk_body's sums: per split, per warp (groups g0 + w, g0 + w + 4, ...)
    acc = fold(acc, group partial); the warps' sums in warp order, the
    splits' in split order."""
    _, _, nsplit, gps, _ = plan
    G = K // 32
    y = torch.zeros((M, N), dtype=F32)
    for sp in range(nsplit):
        g0, g1 = sp * gps, min(G, (sp + 1) * gps)
        block = None
        for w in range(KW):
            acc = torch.zeros((M, N), dtype=F32)
            for g in range(g0 + w, g1, KW):
                acc = scale_group(acc, part_of_group(g), g)
            block = acc if block is None else block + acc
        y = y + block
    return y


def f32_emulate(x, w, scale, kind, form, drop_lo=False):
    """B1's or B6's f32 arithmetic in torch for f32 x (M, K) and int4g32
    (``kind`` "int4g32": packed, group scales) or int8 (w, column scale)
    weights: x's pieces (split_bf16x3; ``drop_lo`` the control without lo),
    each k16 step's products exact and added to an f32 partial (one mma).
    ``form`` "splitk": each piece summed over K on its own (a staged row)
    and the three added lo, mid, hi at the end, split order from
    ``splitk_f32_plan``; "hopper": both k16 steps of lo, then of mid, then
    of hi of each 32-element group into a fresh partial a group (int4g32)
    or a 64-element stage (int8), split order from the f32 Hopper plan.
    int4g32: acc = fma(partial, scale, acc) per group; int8: acc +=
    partial, times the column scale at the end."""
    M, K = x.shape
    N = w.shape[1]
    int8 = kind == "int8"
    q = (w if int8 else unpack_int4_tpu_q(w)).double()
    hi, mid, lo = (p.double() for p in split_bf16x3(x))
    if drop_lo:
        lo = torch.zeros_like(lo)
    s = scale.double()

    def step(p, g, h):  # one k16 step's exact products: (M, N) in f64
        k0 = 32 * g + 16 * h
        return p[:, k0:k0 + 16] @ q[k0:k0 + 16]

    def fold(acc, part, g):
        if int8:
            return acc + part
        return (acc.double() + part.double() * s[g]).float()  # fmaf: one rounding

    def partial(pieces, groups):  # per group both k16 steps of each piece, smallest first
        part = torch.zeros((M, N), dtype=F32)
        for g in groups:
            for p in pieces:
                for h in range(2):
                    part = (part.double() + step(p, g, h)).float()
        return part

    if form == "splitk":
        plan = QM.splitk_f32_plan(M, K, N, int8_weights=int8)
        sums = [_body(M, N, K, plan, lambda g, p=p: partial([p], [g]), fold)
                for p in (lo, mid, hi)]
        y = (sums[0] + sums[1]) + sums[2]
    else:
        _, nsplit, per_split, _ = (I8.int8_mma_plan(M, K, N, True) if int8
                                   else QM.mma_plan(M, K, N, True))
        # a partial's groups: B1 one, B6 a 64-element stage's two (its
        # splits count stages)
        span = 2 if int8 else 1
        G = K // 32
        y = torch.zeros((M, N), dtype=F32)
        for sp in range(nsplit):
            acc = torch.zeros((M, N), dtype=F32)
            for g in range(sp * per_split * span, min(G, (sp + 1) * per_split * span), span):
                acc = fold(acc, partial([lo, mid, hi], range(g, g + span)), g)
            y = y + acc
    return y * scale if int8 else y


def _weights(rng, kind, K, N, positive=False):
    if kind == "int8":
        w = rng.integers(0 if positive else -128, 128, (K, N)).astype(np.int8)
        scale = ((0.5 + rng.random(N, dtype=np.float32)) * 0.01).astype(np.float32)
        return w, scale
    packed = rng.integers(0, 256, (K // 2, N)).astype(np.uint8)
    if positive:  # both nibbles 0..7: q ≥ 0 (sign-extended nibbles)
        packed = packed & 0x77
    scale = (rng.random((K // 32, N), dtype=np.float32) * 0.02).astype(jnp.bfloat16)
    return packed, scale


def _torch_weights(kind, w, scale):
    if kind == "int8":
        return torch.from_numpy(w), torch.from_numpy(scale)
    return (torch.from_numpy(w),
            torch.from_numpy(np.asarray(scale).astype(np.float32)).to(torch.bfloat16))


def _jax_f32(kind, x, w, scale, decode_kernel=False):
    """JAX's f32 path on the same inputs: the linear's jnp fallback, or (int4)
    the decode-M kernel in interpret mode."""
    xj, wj, sj = jnp.asarray(x), jnp.asarray(w), jnp.asarray(scale)
    if kind == "int8":
        return np.asarray(JL._int8_matmul_fallback(xj, wj, sj))
    if decode_kernel:
        out = PM.int4_matmul_pallas_pipelined(xj, wj, sj, interpret=True)
        assert out is not None and out.dtype == jnp.float32
        return np.asarray(out)
    return np.asarray(JL._int4_matmul_fallback(xj, wj, sj))


def _terms(kind, x, w, scale):
    """Σ_k |x_k · w_k| of each output, f64."""
    tw, ts = _torch_weights(kind, w, scale)
    xd = torch.from_numpy(x).double().abs()
    if kind == "int8":
        return (xd @ tw.double().abs()) * ts.double()
    return xd @ (unpack_int4_tpu_q(tw).double().abs()
                 * ts.double().repeat_interleave(32, 0))


def _reading(got, want, terms):
    return ((torch.from_numpy(want).double() - got.double()).abs() / (2.0 ** -24 * terms)).max()


def lo_coherent(rng, M, K):
    """Positive f32 x whose lo pieces are positive, 63 · 2^-23 of x's binade
    (chip_smoke.py's ``lo_coherent``): mantissa bit 15 clear, bit 14 set,
    bit 6 clear and bits 5-0 set; with positive weights the lo dropped by
    the control adds up instead of cancelling."""
    e = rng.integers(-3, 3, (M, K))
    m = rng.integers(0, 1 << 23, (M, K))
    m = (m & ~((1 << 15) | (1 << 6))) | (1 << 14) | 63
    return (((127 + e) << 23) | m).astype(np.int32).view(np.float32)


# (K, N): the narrow N splits K; the short K takes one split (16 columns a
# lane where the split-K form has one m-tile)
ARITH = [(1024, 256), (256, 4096)]
# (form, M): the split-K form's rows up to F32_SPLITK_MAX, the Hopper form's above
FORM_M = [("splitk", 1), ("splitk", 4), ("splitk", QM.F32_SPLITK_MAX),
          ("hopper", QM.F32_SPLITK_MAX + 1), ("hopper", 9), ("hopper", 57)]


@pytest.mark.parametrize("form,M", FORM_M)
@pytest.mark.parametrize("K,N", ARITH)
@pytest.mark.parametrize("kind", ["int4g32", "int8"])
def test_f32_splitk_arithmetic_matches_jax_f32(kind, M, K, N, form):
    rng = np.random.default_rng(10 * M + K + N + (form == "hopper"))
    w, scale = _weights(rng, kind, K, N)
    x = rng.standard_normal((M, K)).astype(np.float32)
    x[0, :: 7] *= 2.0 ** 20  # a wide range inside each group: hi alone is not enough
    got = f32_emulate(torch.from_numpy(x), *_torch_weights(kind, w, scale), kind, form)
    terms = _terms(kind, x, w, scale)
    refs = [_jax_f32(kind, x, w, scale)]
    if kind == "int4g32":
        refs.append(_jax_f32(kind, x, w, scale, decode_kernel=True))
    for want in refs:
        assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()
        assert _reading(got, want, terms) <= F32_SUM_C
    # hi alone (bf16 x) is far off: the pieces carry x's low bits
    hi_only = f32_emulate(torch.from_numpy(x).to(torch.bfloat16).float(),
                          *_torch_weights(kind, w, scale), kind, form)
    assert _reading(hi_only, refs[0], terms) > 100 * F32_SUM_C


def test_f32_arithmetic_shapes_split():
    """Both forms' emulations meet plans that split K and plans that do not."""
    for form in ("splitk", "hopper"):
        nsplits = []
        for K, N in ARITH:
            for f, M in FORM_M:
                if f != form:
                    continue
                for int8 in (False, True):
                    if form == "splitk":
                        nsplits.append(QM.splitk_f32_plan(M, K, N, int8)[2])
                    else:
                        nsplits.append((I8.int8_mma_plan(M, K, N, True) if int8
                                        else QM.mma_plan(M, K, N, True))[1])
        assert any(n > 1 for n in nsplits) and any(n == 1 for n in nsplits), (form, nsplits)


@pytest.mark.parametrize("form,M", [("splitk", 4), ("hopper", 57)])
@pytest.mark.parametrize("kind", ["int4g32", "int8"])
def test_f32_drop_lo_control_exceeds_the_limit(kind, form, M):
    """On lo-coherent x and positive weights the emulation stays within the
    limit and the emulation without lo (about 2^-17 of each term) does not."""
    K, N = 1024, 256
    rng = np.random.default_rng(7 + (form == "hopper"))
    w, scale = _weights(rng, kind, K, N, positive=True)
    x = lo_coherent(rng, M, K)
    tw, ts = _torch_weights(kind, w, scale)
    assert (unpack_int4_tpu_q(tw) >= 0).all() if kind == "int4g32" else (tw >= 0).all()
    terms = _terms(kind, x, w, scale)
    want = _jax_f32(kind, x, w, scale)
    got = f32_emulate(torch.from_numpy(x), tw, ts, kind, form)
    control = f32_emulate(torch.from_numpy(x), tw, ts, kind, form, drop_lo=True)
    assert _reading(got, want, terms) <= F32_SUM_C < _reading(control, want, terms)


def test_lo_coherent_pieces():
    x = torch.from_numpy(lo_coherent(np.random.default_rng(3), 4, 256))
    hi, mid, lo = (p.double() for p in split_bf16x3(x))
    assert (hi + mid + lo == x.double()).all()
    assert (lo > 0).all() and (mid > 0).all()
    rel = lo / x.double()  # 63 · 2^-23 of the binade [2^e, 2^(e+1))
    assert (rel > 63 * 2.0 ** -24).all() and (rel <= 63 * 2.0 ** -23).all()


# ---------------------------------------------------------------------------
# Routes, plans and plan-table keys
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["int4g32", "int8"])
def test_f32_routes(kind):
    route = QM.int4_route if kind == "int4g32" else I8.int8_route
    top = QM.F32_SPLITK_MAX
    assert 1 <= top and 3 * top <= 16  # x's pieces fit the split-K kernels' two m-tiles
    for M in range(1, top + 1):
        for N in (4096, 512, 264):  # the split-K kernel takes N % 8 == 0
            assert route(M, N, F32) == "splitk"
    for M in (top + 1, 57, 128, 512, 4096):
        assert route(M, 4096, F32) == "mma" and route(M, 65536, F32) == "mma"
        assert route(M, 264, F32) == "gemv"  # the Hopper kernel needs N % 16 == 0
    # the bf16 routes are their own
    assert route(QM.MMA_MIN_M, 4096, torch.bfloat16) == "splitk"
    assert route(QM.SMALL_M_MAX + 1, 4096, torch.bfloat16) == "mma"


@pytest.mark.parametrize("int8", [False, True], ids=["int4g32", "int8"])
@pytest.mark.parametrize("K,N", LINEARS)
def test_f32_splitk_plans(K, N, int8):
    """The bf16 plan at 3M staged rows, at most two m-tiles, up to
    F32_SPLITK_MAX; each plan covers K's groups once, in order, and fits."""
    G = K // 32
    for M in range(1, QM.F32_SPLITK_MAX + 1):
        plan = QM.splitk_f32_plan(M, K, N, int8_weights=int8)
        assert QM.splitk_problem(3 * M, K, N, plan, 2, 2) is None
        assert plan == QM.builtin_splitk_plan(3 * M, K, N, 2, int8)
        mt, cols, nsplit, gps, cg = plan
        assert 3 * M <= 8 * mt <= 16
        covered = [g for s in range(nsplit) for g in range(s * gps, min(G, (s + 1) * gps))]
        assert covered == list(range(G))
        assert QM.splitk_smem(3 * M, cg, cols, 2) <= QM.SPLITK_SMEM_MAX
    for M in (0, QM.F32_SPLITK_MAX + 1):
        with pytest.raises(ValueError):
            QM.splitk_f32_plan(M, K, N, int8)


@pytest.mark.parametrize("kind", ["int4g32_f32", "int8_f32"])
def test_f32_hopper_ring_fits(kind):
    """The f32 ring (three activation tiles a stage) holds as many stages
    as fit the opt-in limit, at most bf16's, at least two."""
    base = kind.removesuffix("_f32")
    assert QM.MMA_TILE_BYTES[kind] == QM.MMA_TILE_BYTES[base] and QM.MMA_PIECES[kind] == 3
    for bm in (64, 128):
        stages = QM.mma_stages(bm, kind)
        assert 2 <= stages <= QM.mma_stages(bm, base) == QM.MMA_STAGES
        assert QM.mma_smem(bm, kind) <= QM.MMA_SMEM_MAX
        wbytes, sbytes = QM.MMA_TILE_BYTES[kind]
        per_stage = 3 * bm * 128 + wbytes + sbytes + 16
        assert stages == QM.MMA_STAGES or \
            QM.mma_smem(bm, kind) + per_stage > QM.MMA_SMEM_MAX  # one more would not fit


def test_f32_plans_have_keys_of_their_own():
    """A bf16 plan-table entry never plans an f32 launch, and the other way
    round: the f32 forms' kernel names are their own."""
    M, K, N = 128, 4096, 4096
    bucket = QM.mma_bucket(M)
    odd = (64, 1, K // 32, 7)  # valid, and unlike any built-in plan here
    assert QM.mma_plan(M, K, N) != odd and QM.mma_plan(M, K, N, True) != odd
    with AT.override("int4_mma", bucket, K, N, odd):
        assert QM.mma_plan(M, K, N) == odd and QM.mma_plan(M, K, N, True) != odd
    with AT.override("int4_mma_f32", bucket, K, N, odd):
        assert QM.mma_plan(M, K, N, True) == odd and QM.mma_plan(M, K, N) != odd
    odd8 = (64, 1, K // 64, 7)
    with AT.override("int8_mma", bucket, K, N, odd8):
        assert I8.int8_mma_plan(M, K, N) == odd8 and I8.int8_mma_plan(M, K, N, True) != odd8
    with AT.override("int8_mma_f32", bucket, K, N, odd8):
        assert I8.int8_mma_plan(M, K, N, True) == odd8 and I8.int8_mma_plan(M, K, N) != odd8
    # the split-K forms: the bf16 kernel's entry and the f32 form's, each
    # keyed by its staged rows (an f32 x row is three)
    for int8, name in ((False, "int4"), (True, "int8")):
        M = 2
        f32_plan = QM.splitk_f32_plan(M, K, N, int8)
        bf16_plan = QM.splitk_plan(3 * M, K, N, int8_weights=int8)
        alt = (1, 8, 2, K // 64, 8)
        assert alt not in (f32_plan, bf16_plan)
        with AT.override(f"{name}_splitk", 8, K, N, alt):
            assert QM.splitk_f32_plan(M, K, N, int8) == f32_plan
            assert QM.splitk_plan(3 * M, K, N, int8_weights=int8) == alt
        with AT.override(f"{name}_splitk_f32", 8, K, N, alt):
            assert QM.splitk_f32_plan(M, K, N, int8) == alt
            assert QM.splitk_plan(3 * M, K, N, int8_weights=int8) == bf16_plan


def test_f32_wrappers_on_cpu_tensors_are_the_plain_versions():
    """On the CPU the f32 matmuls are their plain versions (no kernel, no
    launch counted)."""
    g = torch.Generator().manual_seed(5)
    x = torch.randn((3, 256), generator=g)
    packed = torch.randint(0, 256, (128, 64), dtype=torch.uint8, generator=g)
    scale = (torch.rand((8, 64), generator=g) * 0.02).to(torch.bfloat16)
    w8 = torch.randint(-128, 128, (256, 64), dtype=torch.int8, generator=g)
    s8 = torch.rand(64, generator=g) * 0.01
    before = (QM.int4g32_splitk.f32.launches, I8.int8_splitk.f32.launches,
              QM.split_bf16x3_pass.launches)
    assert torch.equal(QM.int4g32_matmul(x, packed, scale),
                       QM.int4g32_matmul_plain(x, packed, scale))
    assert torch.equal(I8.int8_matmul(x, w8, s8), I8.int8_matmul_plain(x, w8, s8))
    assert (QM.int4g32_splitk.f32.launches, I8.int8_splitk.f32.launches,
            QM.split_bf16x3_pass.launches) == before

"""The port's whole-model quantizers (quant/rtn.py, quant/calibrate.py), the
taps they calibrate on (``block_forward(collect_taps=True)``) and the
random init (``init_params``) against the JAX package's, on the CPU, at tiny
widths (tests/test_quant_model.py's), from one float tree carried with
``convert.params_from_numpy``.

Tolerances:

* ``rtn_quantize_model``: bit-equal, every leaf;
* the taps: rtol/atol 1e-5 (f32, the same operations summed in another
  order);
* ``gptq_quantize_model`` at 2 layers: the same tree structure, keys, shapes
  and dtypes as JAX's and as RTN's; at most 2% of each linear's integer grid
  points apart from JAX's (tests/test_gptq.py's limit); the logits of the
  port's tree within 2e-2 of max|logits| of JAX's tree's, both through the
  port's forward (a grid point that flips moves a logit by about one
  quantization step); the 13 ``print_loss`` lines with JAX's tags and
  format, each loss within 2e-2 of JAX's.
"""
import io
import re
from contextlib import redirect_stdout

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from chatglm_q_tpu.config import ChatGLM2Config as JConfig, TpuRuntimeConfig  # noqa: E402
from chatglm_q_tpu.models import chatglm2 as JM  # noqa: E402
from chatglm_q_tpu.quant.calibrate import gptq_quantize_model as j_gptq  # noqa: E402
from chatglm_q_tpu.quant.rtn import rtn_quantize_model as j_rtn  # noqa: E402
from chatglm_q_tpu_torch import ChatGLM2Config, TorchRuntimeConfig  # noqa: E402
from chatglm_q_tpu_torch.convert import params_from_numpy  # noqa: E402
from chatglm_q_tpu_torch.models import chatglm2 as TM  # noqa: E402
from chatglm_q_tpu_torch.ops import quant as TQ  # noqa: E402
from chatglm_q_tpu_torch.quant import gptq_quantize_model, rtn_quantize_model  # noqa: E402

TINY = dict(hidden_size=64, inner_hidden_size=64, head_hidden_size=16,
            num_multi_query_groups=2, num_attention_heads=4, num_layers=2,
            vocab_size=128, max_sequence_length=64)
# w_in's N and w_out's K padded (544 → 1024), the lm_head's N (2176 → 4096)
PADDED = dict(TINY, inner_hidden_size=544, vocab_size=2176)
JRT = TpuRuntimeConfig(use_pallas=False)
PLAIN = TorchRuntimeConfig(use_kernels=False)
QUANTS = ["int8", "int4g32"]

_TREES = {}


def _float_tree(cfg=TINY):
    key = tuple(sorted(cfg.items()))
    if key not in _TREES:
        jp = JM.init_params(jax.random.PRNGKey(0), JConfig(**cfg), "none", jnp.float32)
        _TREES[key] = (jp, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu"))
    return _TREES[key]


def _batches():
    r = np.random.default_rng(1)
    ids = [r.integers(0, TINY["vocab_size"], (2, 12)).astype(np.int32) for _ in range(3)]
    mask = np.ones((2, 12), np.int32)
    mask[1, :4] = 0  # a left-padded row
    return ([(jnp.asarray(i), None if n else jnp.asarray(mask)) for n, i in enumerate(ids)],
            [(torch.from_numpy(i), None if n else torch.from_numpy(mask))
             for n, i in enumerate(ids)])


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + k + ".")
        else:
            yield prefix + k, v


def _np(x):
    if isinstance(x, torch.Tensor):
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype.name == "bfloat16" else x


def _schema(tree):
    """key → (shape, dtype name) of every leaf."""
    return {k: (tuple(v.shape), str(v.dtype).removeprefix("torch.") if isinstance(
        v, torch.Tensor) else np.asarray(v).dtype.name) for k, v in _leaves(tree)}


def _q(p):
    """The integer grid of a stacked linear (L, K, N)."""
    w = p["weight"]
    if w.dtype == torch.uint8:
        return torch.stack([TQ.unpack_int4_tpu_q(w[i]) for i in range(w.shape[0])]).numpy()
    return w.numpy()


@pytest.mark.parametrize("quant", ["none", "int8", "int4g32"])
def test_init_params_schema_matches_jax(quant):
    jp = JM.init_params(jax.random.PRNGKey(0), JConfig(**PADDED), quant, jnp.float32)
    tp = TM.init_params(torch.Generator().manual_seed(0), ChatGLM2Config(**PADDED), quant,
                        torch.float32, device="cpu")
    assert _schema(tp) == _schema(jp)
    w = tp["layers"]["q_proj"]["weight"]
    if quant == "none":  # N(0, 0.02²) draws, each layer its own
        assert 0.015 < float(w.std()) < 0.025 and not torch.equal(w[0], w[1])


def test_block_forward_taps_match_jax():
    jp, tp = _float_tree()
    jcfg, tcfg = JConfig(**TINY), ChatGLM2Config(**TINY)
    r = np.random.default_rng(2)
    x = r.standard_normal((2, 9, 64)).astype(np.float32)
    mask = np.ones((2, 9), np.int32)
    mask[0, :3] = 0
    jbias, jpos = JM.build_parity_mask_and_positions(jnp.asarray(mask), 9)
    table = jnp.asarray(JM.precompute_freqs_cis(16, 65))
    jl = jax.tree.map(lambda a: a[1], jp["layers"])
    jout, _, jtaps = JM.block_forward(jl, jnp.asarray(x), table[jpos], jbias[:, None, None],
                                      jcfg, "none", JRT, kv_write=None, collect_taps=True)
    tbias, tpos = TM.build_parity_mask_and_positions(torch.from_numpy(mask), 9)
    tout, _, ttaps = TM.block_forward(TM._layer(tp["layers"], 1), torch.from_numpy(x),
                                      TM._serving_freqs(tcfg, tpos, torch.float32),
                                      tbias[:, None, None], tcfg, "none", PLAIN,
                                      collect_taps=True)
    assert sorted(ttaps) == sorted(jtaps) == ["o_in", "qkv_in", "w_in_in", "w_out_in"]
    for name in jtaps:
        assert tuple(ttaps[name].shape) == jtaps[name].shape, name
        np.testing.assert_allclose(ttaps[name].numpy(), np.asarray(jtaps[name]), rtol=1e-5,
                                   atol=1e-5, err_msg=name)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=1e-5, atol=1e-5)
    # without taps the parity block returns (x, kv) as before
    assert len(TM.block_forward(TM._layer(tp["layers"], 1), torch.from_numpy(x),
                                TM._serving_freqs(tcfg, tpos, torch.float32),
                                tbias[:, None, None], tcfg, "none", PLAIN)) == 2


@pytest.mark.parametrize("cfg", [TINY, PADDED], ids=["tiny", "padded"])
@pytest.mark.parametrize("quant", QUANTS)
def test_rtn_quantize_model_bit_equal_to_jax(quant, cfg):
    jp, tp = _float_tree(cfg)
    want = dict(_leaves(j_rtn(jp, JConfig(**cfg), quant)))
    got = dict(_leaves(rtn_quantize_model(tp, ChatGLM2Config(**cfg), quant)))
    assert got.keys() == want.keys()
    for k in want:
        a, b = np.asarray(want[k]), got[k]
        assert tuple(b.shape) == a.shape, k
        assert str(b.dtype).removeprefix("torch.") == a.dtype.name, k
        np.testing.assert_array_equal(_np(b), _np(a), err_msg=k)


_LINE = re.compile(r"^(layer \d+ \w+|lm_head): quant_losses=(\d+\.\d{8}) "
                   r"debug_loss=(\d+\.\d{8})$")


@pytest.mark.parametrize("quant", QUANTS)
def test_gptq_quantize_model_matches_jax(quant):
    jp, tp = _float_tree()
    jcfg, tcfg = JConfig(**TINY), ChatGLM2Config(**TINY)
    jb, tb = _batches()
    out = io.StringIO()
    with redirect_stdout(out):
        jq = j_gptq(jp, jcfg, jb, quant, print_loss=True)
    jlines = out.getvalue().splitlines()
    out = io.StringIO()
    stats = {}
    with redirect_stdout(out):
        tq = gptq_quantize_model(tp, tcfg, tb, quant, rt=PLAIN, print_loss=True, stats=stats)
    tlines = out.getvalue().splitlines()

    # structure: JAX's tree and RTN's
    assert _schema(tq) == _schema(jq)
    assert _schema(tq) == _schema(rtn_quantize_model(tp, tcfg, quant))
    # the grids
    for k in ("q_proj", "kv_proj", "o_proj", "w_in_h", "w_in_gate", "w_out"):
        want = _q(params_from_numpy(jax.tree.map(np.asarray, jq["layers"][k]), "cpu"))
        assert np.mean(_q(tq["layers"][k]) != want) < 0.02, k
    # the print_loss lines
    assert len(tlines) == len(jlines) == 13
    for t, j in zip(tlines, jlines):
        mt, mj = _LINE.match(t), _LINE.match(j)
        assert mt and mj, (t, j)
        assert mt.group(1) == mj.group(1)
        for g in (2, 3):
            np.testing.assert_allclose(float(mt.group(g)), float(mj.group(g)), rtol=2e-2,
                                       atol=1e-8, err_msg=t)
    assert sorted(stats) == sorted(_LINE.match(t).group(1) for t in tlines)
    assert all(set(s) == {"quant_loss", "debug_mse", "rtn_debug_mse"} for s in stats.values())
    # logits of the two trees through the port's forward
    ids = torch.from_numpy(np.array(jb[0][0]))
    jq_t = params_from_numpy(jax.tree.map(np.asarray, jq), "cpu")
    _, want = TM.forward(jq_t, tcfg, ids, quant_type=quant, rt=PLAIN)
    _, got = TM.forward(tq, tcfg, ids, quant_type=quant, rt=PLAIN)
    assert float((got - want).abs().max() / want.abs().max()) < 2e-2


def test_gptq_beats_rtn_on_the_calibration_activations():
    """Per linear, GPTQ's output MSE on the last batch's activations is
    below RTN's (the condition chip_smoke.py's phase 10 holds at full
    width), and the GPTQ tree decodes."""
    _, tp = _float_tree()
    tcfg = ChatGLM2Config(**TINY)
    _, tb = _batches()
    stats = {}
    qp = gptq_quantize_model(tp, tcfg, tb, "int4g32", rt=PLAIN, stats=stats)
    assert len(stats) == 13
    for tag, s in stats.items():
        assert s["debug_mse"] < s["rtn_debug_mse"], (tag, s)
    cache = TM.init_kv_cache(tcfg, 1, 16, torch.float32, device="cpu")
    logits, cache = TM.prefill(qp, tcfg, torch.tensor([[3, 17, 42]]), torch.tensor([3]), cache,
                               "int4g32", torch.float32, PLAIN)
    toks, _ = TM.multi_step_decode(qp, tcfg, torch.argmax(logits, -1).to(torch.int32), cache, 3,
                                   None, "int4g32", torch.float32, PLAIN)
    assert toks.shape == (1, 3)

"""The port's scripts (chatglm_q_tpu_torch/examples/) on a tiny float
checkpoint, on the CPU, beside the JAX package's scripts on the same files:

* ``quantize_naive``: the checkpoint it writes loads in the JAX package's
  loader with the tensors the port's loader reads, and equals the one JAX's
  own script writes, tensor for tensor (RTN is bit-equal); JAX's loads in
  the port likewise;
* ``quantize_gptq``: its checkpoint (13 loss lines at 2 layers) loads in
  both loaders with equal tensors;
* ``ppl``: within rtol 1e-4 of JAX's script on the same checkpoint (f32
  activations; the forwards differ in the order of f32 sums);
* ``ceval``: the same ``overall:`` line as JAX's script over a C-Eval
  directory made here; ``--cot`` runs through ``GLMDecoder``.
"""
import json
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from chatglm_q_tpu import loader as JLD  # noqa: E402
from chatglm_q_tpu_torch import loader as TLD  # noqa: E402
from chatglm_q_tpu_torch.config import ChatGLM2Config, GLMLoadConfig  # noqa: E402
from chatglm_q_tpu_torch.examples import ceval, ppl, quantize_gptq, quantize_naive  # noqa: E402
from chatglm_q_tpu_torch.models import chatglm2 as TM  # noqa: E402
from chatglm_q_tpu_torch.tokenizer import ChatGLM2Tokenizer  # noqa: E402
from chatglm_q_tpu_torch.tokenizer.build import build_unigram_model  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def tiny_float_ckpt(tmp_path_factory):
    """tests/test_examples.py's tiny checkpoint, written by the port."""
    d = tmp_path_factory.mktemp("ex")
    vocab = {f"tok{i}": -float(i) for i in range(40)}
    vocab.update({"hello": -0.5, "world": -0.6, "A": -1.0, "B": -1.1, "C": -1.2, "D": -1.3})
    tok_file = d / "sp.model"
    tok_file.write_bytes(build_unigram_model(vocab))
    tok = ChatGLM2Tokenizer(tok_file)
    V = ((len(tok) + 63) // 64) * 64
    cfg = ChatGLM2Config(hidden_size=64, inner_hidden_size=64, head_hidden_size=16,
                         num_multi_query_groups=2, num_attention_heads=4, num_layers=2,
                         vocab_size=V, max_sequence_length=128)
    params = TM.init_params(torch.Generator().manual_seed(0), cfg, "none", torch.float32, "cpu")
    ckpt = d / "fp"
    TLD.save_model_and_tokenizer(ckpt, GLMLoadConfig(model_config=cfg, torch_dtype="float32"),
                                 params, tok)
    calib = d / "calib.txt"
    calib.write_text("hello world\nworld hello hello\ntok1 tok2\nhello tok3\n")
    cdir = d / "ceval"
    (cdir / "val").mkdir(parents=True)
    rows = [{"id": i, "question": f"q {i} hello", "A": "hello", "B": "world", "C": "tok1",
             "D": "tok2", "answer": "ABCD"[i % 4]} for i in range(8)]
    (cdir / "val" / "demo_val.jsonl").write_text("\n".join(json.dumps(r) for r in rows))
    return d, ckpt, calib, cdir


def _run_jax_script(rel, argv):
    script = ROOT / rel
    old_argv = sys.argv
    sys.argv = [script.name] + argv
    try:
        exec(compile(script.read_text(), str(script), "exec"), {"__name__": "__main__"})
    finally:
        sys.argv = old_argv


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + k + ".")
        else:
            yield prefix + k, v


def _bits(a):
    """A leaf as (dtype name, shape, raw bytes)."""
    if isinstance(a, torch.Tensor):
        a = a.cpu()
        raw = a.contiguous().view(torch.uint8).numpy().tobytes() if a.numel() else b""
        return str(a.dtype).removeprefix("torch."), tuple(a.shape), raw
    a = np.asarray(a)
    return a.dtype.name, a.shape, a.tobytes()


def _same_in_both_loaders(path):
    """Load ``path`` in the JAX package and in the port: equal tensors.
    Returns the port's config and tree."""
    jcfg, jparams, _ = JLD.load_model_and_tokenizer(path)
    tcfg, tparams, _ = TLD.load_model_and_tokenizer(path, device="cpu")
    assert tcfg.quant_type == jcfg.quant_type
    t, j = dict(_leaves(tparams)), dict(_leaves(jparams))
    assert t.keys() == j.keys()
    for k in j:
        assert _bits(t[k]) == _bits(j[k]), k
    return tcfg, tparams


@pytest.mark.parametrize("quant", ["int8", "int4g32"])
def test_quantize_naive_matches_jax_script(tiny_float_ckpt, quant, capsys):
    d, ckpt, _, _ = tiny_float_ckpt
    quantize_naive.main(["--quant", quant, "--source", str(ckpt), "--target", str(d / f"n{quant}"),
                         "--device", "cpu"])
    _run_jax_script(f"examples/quantize_naive/{quant}.py",
                    ["--source", str(ckpt), "--target", str(d / f"jn{quant}")])
    assert "saved →" in capsys.readouterr().out
    cfg, port = _same_in_both_loaders(d / f"n{quant}")
    assert cfg.quant_type == quant and cfg.torch_dtype == "float16"
    _, jax_made = _same_in_both_loaders(d / f"jn{quant}")
    a, b = dict(_leaves(port)), dict(_leaves(jax_made))
    assert a.keys() == b.keys()
    for k in a:
        assert _bits(a[k]) == _bits(b[k]), k


@pytest.mark.parametrize("quant", ["int8", "int4g32"])
def test_quantize_gptq_script(tiny_float_ckpt, quant, capsys):
    d, ckpt, calib, _ = tiny_float_ckpt
    quantize_gptq.main(["--quant", quant, "--source", str(ckpt), "--target", str(d / f"g{quant}"),
                        "--calib-file", str(calib), "--num-prompts", "4", "--batch-size", "2",
                        "--device", "cpu"])
    out = capsys.readouterr().out
    assert sum("quant_losses=" in line for line in out.splitlines()) == 13
    cfg, _ = _same_in_both_loaders(d / f"g{quant}")
    assert cfg.quant_type == quant


def _float_from(capsys, key):
    out = capsys.readouterr().out
    return out, float(out.split(key)[1].split()[0])


def test_ppl_matches_jax_script(tiny_float_ckpt, capsys):
    d, ckpt, calib, _ = tiny_float_ckpt
    quantize_gptq.main(["--quant", "int4g32", "--source", str(ckpt), "--target", str(d / "p4"),
                        "--calib-file", str(calib), "--device", "cpu"])
    capsys.readouterr()
    args = ["--model", str(d / "p4"), "--batch-size", "2", "--calib-file", str(calib),
            "--dtype", "float32"]
    got = ppl.main(args + ["--device", "cpu"])
    _, printed = _float_from(capsys, "ppl:")
    _run_jax_script("examples/evaluations/ppl.py", args)
    _, want = _float_from(capsys, "ppl:")
    assert np.isfinite(got) and got > 1
    np.testing.assert_allclose(printed, got, rtol=1e-6)
    np.testing.assert_allclose(got, want, rtol=1e-4)


def test_ceval_matches_jax_script(tiny_float_ckpt, capsys):
    d, ckpt, _, cdir = tiny_float_ckpt
    quantize_naive.main(["--quant", "int8", "--source", str(ckpt), "--target", str(d / "c8"),
                         "--device", "cpu"])
    capsys.readouterr()
    args = ["--model", str(d / "c8"), "--ceval-dir", str(cdir), "--dtype", "float32"]
    acc = ceval.main(args + ["--device", "cpu"])
    got = capsys.readouterr().out
    _run_jax_script("examples/evaluations/ceval.py", args)
    want = capsys.readouterr().out
    overall = [line for line in got.splitlines() if line.startswith("overall:")]
    assert overall and overall == [line for line in want.splitlines()
                                   if line.startswith("overall:")]
    assert 0.0 <= acc <= 1.0 and "  demo: " in got


def test_ceval_cot_runs_through_the_decoder(tiny_float_ckpt, tmp_path, capsys):
    _, ckpt, _, cdir = tiny_float_ckpt
    rows = [json.loads(line) for line in
            (cdir / "val" / "demo_val.jsonl").read_text().splitlines()[:2]]
    (tmp_path / "two_val.jsonl").write_text("\n".join(json.dumps(r) for r in rows))
    ceval.main(["--model", str(ckpt), "--ceval-dir", str(tmp_path), "--dtype", "float32",
                "--cot", "--device", "cpu"])
    assert "overall: " in capsys.readouterr().out

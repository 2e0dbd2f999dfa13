"""The port's checkpoint loader against the JAX package's, for none / int8 /
int4g32, on the CPU:

* a checkpoint saved by JAX loads in the port with tensors identical to
  what JAX loads from it;
* a checkpoint saved by the port loads in JAX with the tensors the port
  loads from it, holding exactly the port's values;
* the port's own safetensors reader and writer agree with
  ``safetensors.numpy`` both ways;
* a sharded save (a small shard limit) round-trips; unknown keys are
  reported and missing ones raise.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from safetensors.numpy import load_file, save_file  # noqa: E402

from chatglm_q_tpu import loader as JLD  # noqa: E402
from chatglm_q_tpu.config import ChatGLM2Config as JConfig, GLMLoadConfig as JLoad  # noqa: E402
from chatglm_q_tpu.models import chatglm2 as JM  # noqa: E402
from chatglm_q_tpu.tokenizer import ChatGLM2Tokenizer as JTok  # noqa: E402
from chatglm_q_tpu_torch import loader as TLD  # noqa: E402
from chatglm_q_tpu_torch.config import ChatGLM2Config, GLMLoadConfig  # noqa: E402
from chatglm_q_tpu_torch.convert import params_from_numpy  # noqa: E402
from chatglm_q_tpu_torch.tokenizer import ChatGLM2Tokenizer  # noqa: E402
from chatglm_q_tpu_torch.tokenizer.build import build_unigram_model  # noqa: E402

# inner 96: K 96 of w_out stays unpadded, and 2*96 = 192 splits h|gate
TINY = dict(hidden_size=64, inner_hidden_size=96, head_hidden_size=16,
            num_multi_query_groups=2, num_attention_heads=4, num_layers=2,
            vocab_size=128, max_sequence_length=64)
QUANTS = ["none", "int8", "int4g32"]


def _tok_file(tmp_path):
    p = tmp_path / "sp.model"
    p.write_bytes(build_unigram_model({"hello": -1.0, "world": -2.0}))
    return p


def _jax_params(quant, seed=0):
    return JM.init_params(jax.random.PRNGKey(seed), JConfig(**TINY), quant, jnp.float32)


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + k + ".")
        else:
            yield prefix + k, v


def _bits(a):
    """A leaf as (dtype name, shape, raw bytes): identical means identical."""
    if isinstance(a, torch.Tensor):
        a = a.cpu()
        name = str(a.dtype).removeprefix("torch.")
        raw = a.contiguous().view(torch.uint8).numpy().tobytes() if a.numel() else b""
        return name, tuple(a.shape), raw
    a = np.asarray(a)
    return a.dtype.name, a.shape, a.tobytes()


def _assert_identical(torch_tree, jax_tree):
    t, j = dict(_leaves(torch_tree)), dict(_leaves(jax_tree))
    assert t.keys() == j.keys()
    for k in j:
        assert _bits(t[k]) == _bits(j[k]), k


@pytest.mark.parametrize("quant", QUANTS)
def test_jax_checkpoint_loads_in_the_port(tmp_path, quant):
    jcfg = JLoad(model_config=JConfig(**TINY), quant_type=quant, torch_dtype="float32")
    JLD.save_model_and_tokenizer(tmp_path / "ckpt", jcfg, _jax_params(quant),
                                 JTok(_tok_file(tmp_path)))
    _, want, jtok = JLD.load_model_and_tokenizer(tmp_path / "ckpt")
    cfg, got, tok = TLD.load_model_and_tokenizer(tmp_path / "ckpt", device="cpu")
    assert cfg.quant_type == quant and cfg.model_config == ChatGLM2Config(**TINY)
    _assert_identical(got, want)
    assert tok.encode("hello world") == jtok.encode("hello world")


@pytest.mark.parametrize("quant", QUANTS)
def test_port_checkpoint_loads_in_jax(tmp_path, quant):
    params = params_from_numpy(jax.tree.map(np.asarray, _jax_params(quant, 1)), "cpu")
    cfg = GLMLoadConfig(model_config=ChatGLM2Config(**TINY), quant_type=quant,
                        torch_dtype="float32")
    TLD.save_model_and_tokenizer(tmp_path / "ckpt", cfg, params,
                                 ChatGLM2Tokenizer(_tok_file(tmp_path)))
    jcfg, jparams, _ = JLD.load_model_and_tokenizer(tmp_path / "ckpt")
    assert jcfg.quant_type == quant
    _, again, _ = TLD.load_model_and_tokenizer(tmp_path / "ckpt", device="cpu")
    _assert_identical(again, jparams)
    # the values saved are the port's own: exact (an int4 bf16 scale comes
    # back f32 from a float32 checkpoint, in both packages)
    t, j = dict(_leaves(params)), dict(_leaves(jparams))
    for k in j:
        np.testing.assert_array_equal(t[k].double().numpy(), np.asarray(j[k], np.float64), k)


@pytest.mark.parametrize("quant", QUANTS)
def test_bfloat16_checkpoint_round_trips(tmp_path, quant):
    """A bf16 checkpoint (the torch_dtype the chip run saves): float leaves
    cast to bf16 on save, and both packages load the same bytes."""
    jp = jax.tree.map(np.asarray, _jax_params(quant, 2))
    params = params_from_numpy(jp, "cpu")
    cfg = GLMLoadConfig(model_config=ChatGLM2Config(**TINY), quant_type=quant,
                        torch_dtype="bfloat16")
    TLD.save_model_and_tokenizer(tmp_path / "ckpt", cfg, params, shard=False)
    assert cfg.weight_files == ["model_weights.safetensors"]
    _, jparams, _ = JLD.load_model_and_tokenizer(tmp_path / "ckpt", load_tokenizer=False)
    _, got, _ = TLD.load_model_and_tokenizer(tmp_path / "ckpt", device="cpu",
                                             load_tokenizer=False)
    _assert_identical(got, jparams)
    assert got["final_ln"]["weight"].dtype == torch.bfloat16


def test_sharded_save_round_trips(tmp_path):
    params = params_from_numpy(jax.tree.map(np.asarray, _jax_params("int8", 3)), "cpu")
    cfg = GLMLoadConfig(model_config=ChatGLM2Config(**TINY), quant_type="int8",
                        torch_dtype="float32")
    TLD.save_model_and_tokenizer(tmp_path / "ckpt", cfg, params, max_shard_bytes=20_000)
    assert len(cfg.weight_files) > 2
    _, again, _ = TLD.load_model_and_tokenizer(tmp_path / "ckpt", device="cpu",
                                               load_tokenizer=False)
    _assert_identical(again, params)
    # JAX shards the same tensors into the same files
    jcfg = JLoad(model_config=JConfig(**TINY), quant_type="int8", torch_dtype="float32")
    JLD.save_model_and_tokenizer(tmp_path / "jax", jcfg, _jax_params("int8", 3), None,
                                 max_shard_bytes=20_000)
    assert jcfg.weight_files == cfg.weight_files
    for f in cfg.weight_files:
        assert sorted(load_file(tmp_path / "jax" / f)) == sorted(load_file(tmp_path / "ckpt" / f))


def test_safetensors_format_both_ways(tmp_path):
    rng = np.random.default_rng(0)
    arrays = {
        "f32": rng.standard_normal((3, 5)).astype(np.float32),
        "f16": rng.standard_normal((7,)).astype(np.float16),
        "f64": rng.standard_normal((2, 2, 2)),
        "i8": rng.integers(-128, 128, (4, 3), dtype=np.int8),
        "u8": rng.integers(0, 256, (9,), dtype=np.uint8),
        "i32": rng.integers(-9, 9, (2, 3), dtype=np.int32),
        "i64": rng.integers(-9, 9, (1,), dtype=np.int64),
        "bool": rng.integers(0, 2, (5,)).astype(bool),
        "scalar": np.asarray(2.5, np.float32),
        "empty": np.zeros((0, 4), np.float32),
    }
    tensors = {k: torch.from_numpy(v.copy()) for k, v in arrays.items()}
    TLD.write_safetensors(tmp_path / "ours.safetensors", tensors, {"format": "pt"})
    back = load_file(tmp_path / "ours.safetensors")
    assert back.keys() == arrays.keys()
    for k, v in arrays.items():
        assert back[k].dtype == v.dtype and back[k].shape == v.shape, k
        np.testing.assert_array_equal(back[k], v)
    save_file(arrays, tmp_path / "theirs.safetensors", metadata={"k": "v"})
    got = TLD.read_safetensors(tmp_path / "theirs.safetensors")
    assert got.keys() == arrays.keys()
    for k, v in arrays.items():
        assert got[k].numpy().dtype == v.dtype and tuple(got[k].shape) == v.shape, k
        np.testing.assert_array_equal(got[k].numpy(), v)
    # bf16, which numpy lacks: through the port's own reader, bit for bit
    bf = torch.randn(6, 3).to(torch.bfloat16)
    TLD.write_safetensors(tmp_path / "bf.safetensors", {"w": bf})
    assert torch.equal(TLD.read_safetensors(tmp_path / "bf.safetensors")["w"], bf)


def test_ignored_and_missing_keys(tmp_path, capsys):
    params = params_from_numpy(jax.tree.map(np.asarray, _jax_params("none", 4)), "cpu")
    cfg = GLMLoadConfig(model_config=ChatGLM2Config(**TINY), torch_dtype="float32")
    TLD.save_model_and_tokenizer(tmp_path / "ok", cfg, params)
    f = tmp_path / "ok" / cfg.weight_files[0]
    sd = TLD.read_safetensors(f)
    sd["mystery.weight"] = torch.zeros(2, 2)
    TLD.write_safetensors(f, sd)
    _, p2, _ = TLD.load_model_and_tokenizer(tmp_path / "ok", device="cpu", load_tokenizer=False)
    assert "mystery.weight" in capsys.readouterr().out and p2 is not None
    sd.pop("final_ln.weight")
    TLD.write_safetensors(f, sd)
    with pytest.raises(KeyError, match="final_ln"):
        TLD.load_model_and_tokenizer(tmp_path / "ok", device="cpu", load_tokenizer=False)

"""The port's launchers (``python -m chatglm_q_tpu_torch.examples.<name>``),
the counterparts of the root examples/ scripts, on the CPU at a tiny size:
``convert_weight`` writes byte for byte the safetensors of the JAX
package's examples/convert_weight.py on the same synthetic HF checkpoint
and refuses a hub id; ``engine_demo`` gives every engine variant the dense
engine's greedy tokens; ``cli_chat`` answers piped questions; the
``api_server`` launcher answers one HTTP chat request over a checkpoint with
its real tokenizer (tests/test_examples.py's case), dense and paged;
``web_ui`` raises naming streamlit; ``demo_mlp`` and ``export`` round-trip
through ``torch.export``."""
import filecmp
import io
import json
import os
import subprocess
import sys
import urllib.request
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from chatglm_q_tpu_torch import ChatGLM2Config, GLMLoadConfig  # noqa: E402
from chatglm_q_tpu_torch.examples import api_server, cli_chat, convert_weight  # noqa: E402
from chatglm_q_tpu_torch.examples import demo_mlp, engine_demo, web_ui  # noqa: E402
from chatglm_q_tpu_torch.examples import export as export_script  # noqa: E402
from chatglm_q_tpu_torch.loader import (load_model_and_tokenizer,  # noqa: E402
                                        save_model_and_tokenizer)
from chatglm_q_tpu_torch.models import chatglm2 as TM  # noqa: E402
from chatglm_q_tpu_torch.tokenizer import ChatGLM2Tokenizer  # noqa: E402
from chatglm_q_tpu_torch.tokenizer.build import build_unigram_model  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
H = 64


@pytest.fixture(autouse=True)
def one_thread():
    """Small models on one thread: under a run of parallel test workers an
    op split over every core's thread waits on all of them (the engine
    tour took minutes that way, seconds alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _hf_checkpoint(d: Path) -> dict:
    """A 2-layer HF-named state dict in two ``.bin`` shards with the index
    and a tokenizer file."""
    g = torch.Generator().manual_seed(0)
    sd = {"transformer.embedding.word_embeddings.weight": torch.randn((128, H), generator=g),
          "transformer.encoder.final_layernorm.weight": torch.randn((H,), generator=g),
          "transformer.output_layer.weight": torch.randn((128, H), generator=g),
          "transformer.rotary_pos_emb.inv_freq": torch.randn((8,), generator=g)}
    for i in range(2):
        p = f"transformer.encoder.layers.{i}."
        sd.update({p + "input_layernorm.weight": torch.randn((H,), generator=g),
                   p + "self_attention.query_key_value.weight": torch.randn((3 * H, H),
                                                                            generator=g),
                   p + "self_attention.query_key_value.bias": torch.randn((3 * H,), generator=g),
                   p + "self_attention.dense.weight": torch.randn((H, H), generator=g),
                   p + "post_attention_layernorm.weight": torch.randn((H,), generator=g),
                   p + "mlp.dense_h_to_4h.weight": torch.randn((4 * H, H), generator=g),
                   p + "mlp.dense_4h_to_h.weight": torch.randn((H, 2 * H), generator=g)})
    sd = {k: v.half() for k, v in sd.items()}
    d.mkdir()
    shards = {f"pytorch_model-0000{j}-of-00002.bin":
              {k: v for k, v in sd.items() if ("layers.1." in k) == (j == 2)} for j in (1, 2)}
    for name, part in shards.items():
        torch.save(part, d / name)
    (d / "pytorch_model.bin.index.json").write_text(json.dumps(
        {"weight_map": {k: name for name, part in shards.items() for k in part}}))
    (d / "tokenizer.model").write_bytes(build_unigram_model([f"w{i}" for i in range(50)]))
    return sd


def test_convert_weight_is_byte_equal_to_the_jax_script(tmp_path):
    _hf_checkpoint(tmp_path / "hf")
    res = subprocess.run([sys.executable, str(ROOT / "examples" / "convert_weight.py"),
                          "--source", str(tmp_path / "hf"), "--target", str(tmp_path / "jax")],
                         cwd=tmp_path, capture_output=True, text=True, timeout=300,
                         env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert res.returncode == 0, res.stderr[-2000:]
    files = convert_weight.convert(tmp_path / "hf", tmp_path / "port")
    assert files == ["pytorch_model-00001-of-00002.safetensors",
                     "pytorch_model-00002-of-00002.safetensors"]
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port"))
    for name in names:
        assert filecmp.cmp(tmp_path / "jax" / name, tmp_path / "port" / name, shallow=False), name


def test_converted_checkpoint_loads_and_a_hub_id_is_refused(tmp_path):
    sd = _hf_checkpoint(tmp_path / "hf")
    convert_weight.main(["--source", str(tmp_path / "hf"), "--target", str(tmp_path / "safe")])
    conf = json.loads((tmp_path / "safe" / "config.json").read_text())
    assert conf["model_config"]["num_layers"] == 28  # ChatGLM2-6B's, as the JAX script writes
    conf["model_config"].update(hidden_size=H, inner_hidden_size=2 * H, head_hidden_size=16,
                                num_multi_query_groups=1, num_attention_heads=4, num_layers=2,
                                vocab_size=128)
    (tmp_path / "safe" / "config.json").write_text(json.dumps(conf))
    _, params, tok = load_model_and_tokenizer(tmp_path / "safe", "float32", device="cpu")
    assert torch.equal(params["word_embedding"]["weight"],
                       sd["transformer.embedding.word_embeddings.weight"].float())
    assert params["layers"]["attn_ln"]["weight"].shape == (2, H) and len(tok) > 0
    with pytest.raises(FileNotFoundError, match="local paths only"):
        convert_weight.convert("THUDM/chatglm2-6b", tmp_path / "x")


def test_engine_demo_variants_give_the_dense_tokens(capsys):
    assert engine_demo.main(["--device", "cpu", "--requests", "3", "--new-tokens", "6",
                             "--strict"]) == 0
    out = capsys.readouterr().out
    assert "all engine variants token-exact vs dense" in out and out.count("tokens in") == 5


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """A 2-layer int4g32 checkpoint of a tiny config with a real tokenizer."""
    d = tmp_path_factory.mktemp("ckpt")
    tok = ChatGLM2Tokenizer(build_unigram_model([f"w{i}" for i in range(100)]))
    cfg = ChatGLM2Config(hidden_size=64, inner_hidden_size=128, head_hidden_size=16,
                         num_multi_query_groups=2, num_attention_heads=4, num_layers=2,
                         vocab_size=512, max_sequence_length=128)
    params = TM.init_params(torch.Generator().manual_seed(1), cfg, "int4g32", device="cpu")
    save_model_and_tokenizer(d, GLMLoadConfig(model_config=cfg, quant_type="int4g32",
                                              torch_dtype="float32"), params, tok)
    return d


def test_cli_chat_answers_piped_questions(checkpoint, capsys, monkeypatch):
    monkeypatch.setattr(sys, "stdin", io.StringIO("w1 w2 w3\n/clear\nw1 w2 w3\n\n"))
    cli_chat.main(["--model", str(checkpoint), "--device", "cpu", "--max-tokens", "5",
                   "--temperature", "0"])
    out = capsys.readouterr().out
    answers = [line.split("答：", 1)[1] for line in out.splitlines() if "答：" in line]
    assert len(answers) == 2 and answers[0] == answers[1]


@pytest.mark.parametrize("extra", [[], ["--paged", "--page-size", "16", "--num-pages", "24",
                                        "--prefill-chunk", "16"]])
def test_api_server_launcher_answers_a_chat(checkpoint, extra):
    args = api_server.parse_args(["--model", str(checkpoint), "--device", "cpu", "--port", "0",
                                  "--max-batch", "2", "--max-seq-len", "64", "--decode-chunk",
                                  "4", "--name", "tiny-ckpt", *extra])
    server = api_server.build_server(args)
    server.start()
    try:
        req = urllib.request.Request(
            f"http://{server.host}:{server.port}/v1/chat/completions",
            data=json.dumps({"messages": [{"role": "user", "content": "w1 w2 w3"}],
                             "max_tokens": 6, "temperature": 0.0}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=300) as resp:
            obj = json.loads(resp.read())
        assert obj["model"] == "tiny-ckpt"
        assert obj["choices"][0]["finish_reason"] in ("stop", "length")
        assert isinstance(obj["choices"][0]["message"]["content"], str)
    finally:
        server.shutdown()


def test_web_ui_names_streamlit_when_it_is_missing(monkeypatch):
    monkeypatch.setitem(sys.modules, "streamlit", None)
    with pytest.raises(ImportError, match="'streamlit' package"):
        web_ui.main([])


def test_demo_mlp_gptq_beats_rtn_and_round_trips(tmp_path):
    res = demo_mlp.run(torch.device("cpu"), str(tmp_path / "mlp.pt2"))
    assert res["mse_gptq"] < res["mse_rtn"] and res["export_equal"] and res["ops"] == []


def test_export_script_round_trips_on_the_cpu(tmp_path, capsys):
    assert export_script.main(["--device", "cpu", "--out", str(tmp_path / "d.pt2"),
                               "--cache-len", "64", "--batch", "2"]) == 0
    assert "'logits': True" in capsys.readouterr().out

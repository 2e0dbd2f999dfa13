"""The port stands alone: no module of chatglm_q_tpu_torch (nor the root
chip_smoke.py that drives it) imports jax or chatglm_q_tpu, nor the
``safetensors`` and ``ml_dtypes`` packages the JAX loader needs (the machine
with the card has neither), nor the root ``examples`` scripts (the port
keeps its own copies), and its entry points run on CUDA unless the caller
asks for the CPU."""
import ast
import pathlib
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "chatglm_q_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "chatglm_q_tpu", "flax", "safetensors", "ml_dtypes", "examples")


def _port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_no_port_module_imports_jax_or_the_jax_package():
    files = _port_files()
    assert len(files) > 10
    bad = [(str(f.relative_to(ROOT)), name) for f in files
           for name in _imported_roots(f) if name in FORBIDDEN]
    assert not bad, bad


def _port_modules():
    return sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
        for p in PORT.rglob("*.py"))


def test_port_imports_with_jax_blocked():
    mods = _port_modules()
    assert {"chatglm_q_tpu_torch.loader", "chatglm_q_tpu_torch.serving.decoder",
            "chatglm_q_tpu_torch.tokenizer.sp_core", "chatglm_q_tpu_torch.ops.dyn_matmul",
            "chatglm_q_tpu_torch.ops.int8_matmul", "chatglm_q_tpu_torch.serving.engine",
            "chatglm_q_tpu_torch.serving.paged_engine", "chatglm_q_tpu_torch.serving.speculative",
            "chatglm_q_tpu_torch.models.paged_kv", "chatglm_q_tpu_torch.models.spec_decode",
            "chatglm_q_tpu_torch.utils.logging", "chatglm_q_tpu_torch.utils.train",
            "chatglm_q_tpu_torch.parallel.sharding", "chatglm_q_tpu_torch.parallel.tp_linear",
            "chatglm_q_tpu_torch.parallel.ring_attention",
            "chatglm_q_tpu_torch.serving.dist_engine",
            "chatglm_q_tpu_torch.utils.distributed", "chatglm_q_tpu_torch.utils.graphs",
            "chatglm_q_tpu_torch.serving.api_server", "chatglm_q_tpu_torch.quant.rtn",
            "chatglm_q_tpu_torch.quant.gptq", "chatglm_q_tpu_torch.quant.calibrate",
            "chatglm_q_tpu_torch.ops.gptq_sweep", "chatglm_q_tpu_torch.examples.quantize_gptq",
            "chatglm_q_tpu_torch.examples.quantize_naive", "chatglm_q_tpu_torch.examples.ppl",
            "chatglm_q_tpu_torch.examples.ceval", "chatglm_q_tpu_torch.examples.data"} <= set(mods)
    code = ("import sys\n"
            f"for name in {FORBIDDEN!r}:\n"
            "    sys.modules[name] = None\n"
            "import importlib\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr


@pytest.mark.parametrize("module", ["chatglm_q_tpu_torch.loader",
                                    "chatglm_q_tpu_torch.serving.decoder",
                                    "chatglm_q_tpu_torch.serving.paged_engine",
                                    "chatglm_q_tpu_torch.tokenizer",
                                    "chatglm_q_tpu_torch.ops.linear",
                                    "chatglm_q_tpu_torch.utils.train",
                                    "chatglm_q_tpu_torch.serving.dist_engine",
                                    "chatglm_q_tpu_torch.parallel.ring_attention",
                                    "chatglm_q_tpu_torch.quant",
                                    "chatglm_q_tpu_torch.examples.quantize_gptq",
                                    "chatglm_q_tpu_torch.examples.ceval"])
def test_no_forbidden_package_in_sys_modules_after_import(module):
    """Imported unblocked in a fresh interpreter, a module pulls in none of
    the forbidden packages."""
    code = ("import importlib, sys\n"
            f"importlib.import_module({module!r})\n"
            f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
            "print(bad)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0 and res.stdout.strip() == "[]", (res.stdout, res.stderr)


def test_spawned_rank_functions_import_no_jax():
    """tests/torch_dist_workers.py runs in the ranks that run_spmd spawns:
    it imports the port and torch only, never jax or a test module (which
    would import jax into every rank)."""
    path = ROOT / "tests" / "torch_dist_workers.py"
    roots = set(_imported_roots(path))
    assert not roots & set(FORBIDDEN), roots
    assert not any(r.startswith("test_") for r in roots), roots


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    from chatglm_q_tpu_torch import ChatGLM2Config
    from chatglm_q_tpu_torch.bench import random_quantized_params
    from chatglm_q_tpu_torch.convert import params_from_numpy
    from chatglm_q_tpu_torch import GLMLoadConfig
    from chatglm_q_tpu_torch.examples import quantize_naive
    from chatglm_q_tpu_torch.models.chatglm2 import init_kv_cache, init_params
    from chatglm_q_tpu_torch.models.paged_kv import init_paged_kv_cache
    from chatglm_q_tpu_torch.serving import PagedServingEngine, ServingEngine

    import numpy as np

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = ChatGLM2Config(hidden_size=64, inner_hidden_size=64, head_hidden_size=16,
                         num_attention_heads=4, num_layers=1, vocab_size=64,
                         max_sequence_length=16)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_kv_cache(cfg, 1, 8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        params_from_numpy({"w": np.zeros(3, np.float32)})
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        random_quantized_params(cfg, "int4g32", torch.Generator())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_paged_kv_cache(cfg, 1, 4, 16, 8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_params(torch.Generator(), cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        quantize_naive.main(["--source", "nowhere", "--target", "nowhere"])
    # asked for explicitly, the CPU works
    assert init_kv_cache(cfg, 1, 8, device="cpu").k.device.type == "cpu"
    assert init_paged_kv_cache(cfg, 1, 4, 16, 8, device="cpu").k_pool.device.type == "cpu"
    params = random_quantized_params(cfg, "int4g32", torch.Generator().manual_seed(0), "cpu")
    assert params["layers"]["q_proj"]["weight"].shape == (1, 32, 64)
    # the engines: device=None means CUDA and raises without it; params on
    # another device than the one asked for raise
    load = GLMLoadConfig(model_config=cfg, quant_type="int4g32")
    for engine, kw in ((ServingEngine, {}), (PagedServingEngine, dict(num_pages=4, page_size=8))):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            engine(load, params, max_batch=1, max_seq_len=16, **kw)
        with pytest.raises(ValueError, match="params live on cpu"):
            engine(load, params, max_batch=1, max_seq_len=16, device="meta", **kw)
        eng = engine(load, params, max_batch=1, max_seq_len=16, device="cpu", **kw)
        assert eng.device.type == "cpu"


def test_chip_smoke_refuses_to_run_without_cuda(tmp_path):
    """Without a card the smoke test exits non-zero and prints no result;
    alone in a directory (no port to import) likewise."""
    script = (ROOT / "chip_smoke.py").read_text()
    (tmp_path / "chip_smoke.py").write_text(script)
    for cwd in (ROOT, tmp_path):
        res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, capture_output=True,
                             text=True, timeout=120)
        assert res.returncode != 0
        assert '"ok"' not in res.stdout

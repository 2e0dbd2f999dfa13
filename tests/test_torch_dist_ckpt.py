"""The port's sharded checkpoints (utils/dist_ckpt.py) on the CPU:
tests/test_orbax_io.py's plain and sharded round trips, on trees from the
JAX package's ``init_params``.

A whole save loads back bit for bit with every dtype.  A save from a (1, 2)
mesh of gloo ranks (``run_spmd``; tests/torch_dist_workers.py) loads onto a
(2, 1) mesh and into one process, and a whole save onto the (1, 2) mesh:
each rank's tensors are ``shard_params``' slice bit for bit.  No rank's
file holds a whole tensor of a leaf the mesh splits.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import torch_dist_workers as W  # noqa: E402
from chatglm_q_tpu.config import ChatGLM2Config as JConfig  # noqa: E402
from chatglm_q_tpu.models import chatglm2 as JM  # noqa: E402
from chatglm_q_tpu_torch import ChatGLM2Config  # noqa: E402
from chatglm_q_tpu_torch.convert import params_from_numpy  # noqa: E402
from chatglm_q_tpu_torch.loader import read_safetensors  # noqa: E402
from chatglm_q_tpu_torch.parallel import sharding as SH  # noqa: E402
from chatglm_q_tpu_torch.utils import dist_ckpt as C  # noqa: E402
from chatglm_q_tpu_torch.utils.distributed import run_spmd  # noqa: E402

SMALL = dict(hidden_size=64, inner_hidden_size=64, head_hidden_size=16,
             num_multi_query_groups=2, num_attention_heads=4, num_layers=2,
             vocab_size=128, max_sequence_length=64)
# FFN 1152 is stored as 1536: the (1, 2) mesh splits w_out's storage rows
# 768 / 768 and w_in's columns 768 / 384
SHARDED = dict(hidden_size=256, inner_hidden_size=1152, head_hidden_size=32,
               num_multi_query_groups=2, num_attention_heads=8, num_layers=2,
               vocab_size=1024, max_sequence_length=64)


def _tree(cfg, quant, seed):
    return jax.tree.map(np.asarray, jax.jit(lambda k: JM.init_params(
        k, JConfig(**cfg), quant, jnp.float32))(jax.random.PRNGKey(seed)))


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        out.update(_leaves(v, prefix + k + ".") if isinstance(v, dict) else {prefix + k: v})
    return out


def _bit_equal(got, want):
    got, want = _leaves(got), _leaves(want)
    assert set(got) == set(want)
    for k, w in want.items():
        assert got[k].dtype == w.dtype, k
        assert torch.equal(got[k], w), k


@pytest.mark.parametrize("quant", ["none", "int8", "int4g32"])
def test_roundtrip_plain(tmp_path, quant):
    params = params_from_numpy(_tree(SMALL, quant, 0), "cpu")
    params["final_ln"]["weight"] = params["final_ln"]["weight"].to(torch.bfloat16)
    C.save_params(tmp_path / "ckpt", params)
    _bit_equal(C.load_params(tmp_path / "ckpt", like=params, device="cpu"), params)
    dtypes = {t.dtype for t in _leaves(params).values()}
    assert torch.bfloat16 in dtypes and torch.float32 in dtypes
    with pytest.raises(ValueError, match="like"):
        C.load_params(tmp_path / "ckpt", like={"final_ln": params["final_ln"]}, device="cpu")


@pytest.fixture(scope="module")
def sharded_run(tmp_path_factory):
    quant = "int4g32"
    tree = _tree(SHARDED, quant, 1)
    root = tmp_path_factory.mktemp("ckpt")
    C.save_params(root / "whole", params_from_numpy(tree, "cpu"))
    res = run_spmd(W.ckpt_cases, 2, "gloo", 150,
                   args=(tree, SHARDED, quant, str(root / "whole"), str(root / "mesh")))
    return quant, tree, root, res


def test_roundtrip_sharded_restore(sharded_run):
    """A whole save onto the (1, 2) mesh, and the (1, 2) mesh's save onto a
    (2, 1) mesh: every rank's tensors are shard_params' slice."""
    _, _, _, res = sharded_run
    for r in res:
        assert r == {"mesh_to_21": [], "whole_to_12": []}


def test_mesh_save_loads_whole_in_one_process(sharded_run):
    quant, tree, root, _ = sharded_run
    cfg = ChatGLM2Config(**SHARDED)
    want = SH.shard_params(params_from_numpy(tree, "cpu"), SH.make_mesh(1, 1), cfg, quant)
    _bit_equal(C.load_params(root / "mesh", device="cpu"), want)
    _bit_equal(C.load_params(root / "mesh", mesh=SH.make_mesh(1, 1), config=cfg,
                             quant_type=quant, device="cpu"), want)


def test_no_rank_file_holds_a_whole_split_tensor(sharded_run):
    """Each model rank wrote its own slices: every tensor the mesh splits
    is in both files, each a strict part of its global shape, and the
    parts tile it; every leaf held whole is in rank 0's file alone."""
    quant, _, root, _ = sharded_run
    index = json.loads((root / "mesh" / C.INDEX).read_text())
    files = [read_safetensors(root / "mesh" / f"model{r}.safetensors") for r in range(2)]
    n_split = 0
    for key, info in index.items():
        path = tuple(key.split("/"))
        dim = SH.split_dim(path, quant)
        shape = tuple(info["shape"])
        if dim is None:
            assert key in files[0] and key not in files[1], key
            assert tuple(files[0][key].shape) == shape
            continue
        n_split += 1
        parts = [f[key] for f in files]
        for p in parts:
            assert tuple(p.shape) != shape and p.shape[dim] < shape[dim], key
        assert sum(p.shape[dim] for p in parts) == shape[dim], key
    # weight and scale of q_proj (and its bias), w_in_h, w_in_gate, lm_head,
    # o_proj and w_out
    assert n_split == 13

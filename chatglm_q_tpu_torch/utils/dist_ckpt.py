"""Sharded checkpoints of the param tree: the counterpart of
chatglm_q_tpu/utils/orbax_io.py.

JAX saves a (possibly GSPMD-sharded) tree with Orbax, each host writing its
shards.  Here a mesh rank holds its ``shard_params`` slice
(parallel/sharding.py), and ``torch.distributed.checkpoint``'s metadata
describes DTensor placements, even ``Shard`` splits of a dim: the mesh's
w_in column split (ending where the logical columns do) and its int4
storage-row split are not of that kind.  So the port writes its own
safetensors files (loader.py's writer) beside an index of each leaf's
global shape and dtype and of the pieces that hold it (file, tensor name,
offset in the global tensor):

* ``save_params(path, params)`` writes the tree whole, one file: a
  bit-equal round trip of every dtype (uint8, int8, bf16, f32, ...);
* ``save_params(path, params, mesh, config, quant_type)`` from a mesh:
  each model rank of data rank 0 writes its own slices, one file a rank
  (a leaf every rank holds whole, by model rank 0 alone); no rank gathers
  a whole tensor.  The global tree is the one whose ``shard_params``
  slices the ranks hold (w_in's storage-padding columns, which no rank
  holds, are not in it);
* ``load_params(path, mesh=..., config=..., quant_type=...)`` gives each
  rank of a mesh of any shape exactly ``shard_params``' slice of that
  tree, reading from each file only the bytes of the pieces it overlaps
  (memory-mapped); without a mesh, the whole tree.

A pipeline's stage-sharded tree (parallel/pipeline.py) is saved whole.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Optional, Union

import numpy as np
import torch

from ..config import ChatGLM2Config, resolve_device
from ..loader import ST_DTYPES, write_safetensors
from ..parallel import sharding as SH

INDEX = "index.json"
_NP = {torch.float64: np.float64, torch.float32: np.float32, torch.float16: np.float16,
       torch.bfloat16: np.int16, torch.int64: np.int64, torch.int32: np.int32,
       torch.int16: np.int16, torch.int8: np.int8, torch.uint8: np.uint8, torch.bool: np.bool_}
_ST_NAMES = {v: k for k, v in ST_DTYPES.items()}


def _nest(flat: dict) -> dict:
    tree = {}
    for path, v in flat.items():
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = v
    return tree


def _key(path: tuple) -> str:
    return "/".join(path)


def save_params(path: Union[str, Path], params: dict, mesh=None,
                config: Optional[ChatGLM2Config] = None, quant_type: Optional[str] = None):
    """Save a param tree: whole (``mesh`` None), or the ranks' slices of a
    (data, model) mesh (every rank calls it; ``config`` and ``quant_type``
    say the placement).  See the module note."""
    path = Path(path)
    leaves = SH.leaf_paths(params)
    if mesh is None:
        path.mkdir(parents=True, exist_ok=True)
        write_safetensors(path / "whole.safetensors", {_key(p): t for p, t in leaves})
        index = {_key(p): {"shape": list(t.shape), "dtype": _ST_NAMES[t.dtype],
                           "pieces": [{"file": "whole.safetensors", "start": [0] * t.dim()}]}
                 for p, t in leaves}
        (path / INDEX).write_text(json.dumps(index, indent=1))
        return
    if config is None or quant_type is None:
        raise ValueError("a save from a mesh needs the config and quant_type of its placement")
    if mesh.n_stage != 1:
        raise ValueError("a pipeline's stage-sharded tree is saved whole")
    m, tp = mesh.model_index, mesh.n_model
    dims = [SH.split_dim(p, quant_type) for p, _ in leaves]
    # every model rank's extent of each split leaf: the offsets of its piece
    ext = torch.tensor([t.shape[d] for (_, t), d in zip(leaves, dims) if d is not None],
                       dtype=torch.int64, device=leaves[0][1].device)
    ext = mesh.all_gather(ext, SH.MODEL_AXIS).cpu()  # (tp, n_split)
    index, mine, j = {}, {}, 0
    for (p, t), d in zip(leaves, dims):
        shape = list(t.shape)
        if d is None:
            pieces = [{"file": "model0.safetensors", "start": [0] * t.dim()}]
            if m == 0:
                mine[_key(p)] = t
        else:
            d %= t.dim()
            offs = [0] + ext[:, j].cumsum(0).tolist()
            shape[d] = offs[-1]
            pieces = []
            for r in range(tp):
                start = [0] * t.dim()
                start[d] = offs[r]
                pieces.append({"file": f"model{r}.safetensors", "start": start})
            mine[_key(p)] = t
            j += 1
        index[_key(p)] = {"shape": shape, "dtype": _ST_NAMES[t.dtype], "pieces": pieces}
    if mesh.data_index == 0:  # the data ranks hold the same slices
        path.mkdir(parents=True, exist_ok=True)
        write_safetensors(path / f"model{m}.safetensors", mine)
        if m == 0:
            (path / INDEX).write_text(json.dumps(index, indent=1))
    import torch.distributed as dist

    if dist.is_initialized():  # every file written before any rank reads
        dist.barrier()


class _Piece:
    """One tensor of a safetensors file, memory-mapped: ``read(box)`` reads
    the bytes of a box of it alone."""

    def __init__(self, file: Path, name: str):
        with open(file, "rb") as f:
            n = int.from_bytes(f.read(8), "little")
            info = json.loads(f.read(n))[name]
        self.dtype = ST_DTYPES[info["dtype"]]
        self.shape = tuple(info["shape"])
        begin, end = info["data_offsets"]
        self.mm = (np.memmap(file, dtype=np.uint8, mode="r", offset=8 + n + begin,
                             shape=(end - begin,)).view(_NP[self.dtype]).reshape(self.shape)
                   if end > begin else np.zeros(self.shape, _NP[self.dtype]))

    def read(self, box) -> torch.Tensor:
        t = torch.from_numpy(np.array(self.mm[box]))
        return t.view(torch.bfloat16) if self.dtype == torch.bfloat16 else t


def load_params(path: Union[str, Path], like: Optional[dict] = None, mesh=None,
                config: Optional[ChatGLM2Config] = None, quant_type: Optional[str] = None,
                device=None) -> dict:
    """Load a tree saved by ``save_params``: whole, or with ``mesh`` (and
    the ``config`` and ``quant_type`` of its placement) the rank's
    ``shard_params`` slice, on ``device`` (None means CUDA, and raises
    without it).  ``like``, a tree of tensors, must then have the loaded
    tree's keys, shapes and dtypes (a check; nothing is taken from it)."""
    path = Path(path)
    device = resolve_device(device)
    index = json.loads((path / INDEX).read_text())
    paths = [tuple(k.split("/")) for k in index]
    slices = {p: None for p in paths}
    if mesh is not None:
        if config is None or quant_type is None:
            raise ValueError("a load onto a mesh needs the config and quant_type of its placement")
        shapes = _nest({p: tuple(index[_key(p)]["shape"]) for p in paths})
        sl_tree = SH.shard_slices(shapes, config, quant_type, mesh.n_model, mesh.model_index)
        slices = {p: _get(sl_tree, p) for p in paths}
    files: dict = {}
    out = {}
    for p in paths:
        info = index[_key(p)]
        shape, sl = list(info["shape"]), slices[p]
        lo, hi = [0] * len(shape), list(shape)
        if sl is not None:
            d = sl[0] % len(shape)
            lo[d], hi[d] = sl[1], sl[2]
        t = torch.empty([b - a for a, b in zip(lo, hi)], dtype=ST_DTYPES[info["dtype"]])
        filled = 0
        for piece in info["pieces"]:
            key = (piece["file"], _key(p))
            if key not in files:
                files[key] = _Piece(path / piece["file"], _key(p))
            src = files[key]
            start = piece["start"]
            a = [max(x, s) for x, s in zip(lo, start)]
            b = [min(y, s + n) for y, s, n in zip(hi, start, src.shape)]
            if any(x >= y for x, y in zip(a, b)) and t.numel():
                continue
            part = src.read(tuple(slice(x - s, y - s) for x, y, s in zip(a, b, start)))
            t[tuple(slice(x - o, y - o) for x, y, o in zip(a, b, lo))] = part
            filled += part.numel()
        if filled != t.numel():
            raise ValueError(f"{_key(p)}: the checkpoint's pieces cover {filled} of "
                             f"{t.numel()} elements")
        out[p] = t.to(device)
    tree = _nest(out)
    if like is not None:
        want = {p: t for p, t in SH.leaf_paths(like)}
        if set(want) != set(out):
            raise ValueError(f"the checkpoint's keys differ from like's: "
                             f"{sorted(set(want) ^ set(out))}")
        for p, t in want.items():
            if tuple(t.shape) != tuple(out[p].shape) or t.dtype != out[p].dtype:
                raise ValueError(f"{_key(p)}: {tuple(out[p].shape)} {out[p].dtype} in the "
                                 f"checkpoint, {tuple(t.shape)} {t.dtype} in like")
    return tree


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree

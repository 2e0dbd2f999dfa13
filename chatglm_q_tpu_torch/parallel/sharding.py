"""The (data, model) mesh of tensor-parallel serving and the placement of
the param tree and the KV cache on it: the counterpart of
chatglm_q_tpu/parallel/sharding.py.

JAX describes the placement with ``PartitionSpec``s and leaves the
collectives to GSPMD; here every rank is a process that holds its own
slice, and the collectives are explicit calls (``Mesh`` below, through
utils/distributed.py).  Rank ``d · n_model + m`` is data rank d, model
rank m.  Its model group is the ranks of its data rank, its data group the
ranks of its model rank.

Placement (``param_pspecs``, :108-136):

* q_proj, w_in_h, w_in_gate and lm_head split their output columns N over
  the model axis (column parallel): q_proj by whole heads (rank m holds
  heads m·nH/tp ..), lm_head in equal parts, w_in_h and w_in_gate at the
  boundaries of w_out's row split (below);
* o_proj and w_out split their input rows K (row parallel, in storage rows:
  the int4 nibble pairs and group-32 scales along), into tp equal parts of
  the storage K.  The storage padding of an int4 K (13696 → 13824) sits at
  the global end of K, in the last part, so the column split of w_in ends
  where the logical columns do and the last rank's activations are padded
  at their end: the activations of w_in's columns line up with w_out's rows
  with no exchange (JAX pads x globally before it slices it, :77-84);
* kv_proj, the embedding and the norms stay whole on every rank.

The KV cache (``kv_cache_pspecs``, ``paged_kv_pspecs``, :139-176): the
batch rows split over the data axis (a data rank holds its slot group's
rows), and over the model axis

* by KV group, where each rank attends its own heads (the default):
  rank m's cache holds the groups its heads read;
* by T (``kv_shard_t``): every group, T / tp slots a rank;
* by page phase (``shard_model_pages``): every group, the pages of the
  logical blocks j with j % tp == m.
"""
from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass
from typing import Optional

import torch

from ..config import ChatGLM2Config
from ..ops.quant import GROUP_K
from ..utils import distributed as dist_utils

DATA_AXIS = "data"
MODEL_AXIS = "model"
STAGE_AXIS = "stage"  # a pipeline's stages (parallel/pipeline.py)
BACKENDS = ("gloo", "nccl")


@dataclass(eq=False)
class Mesh:
    """This rank's place in an (n_data, n_model) mesh of processes, the
    process groups of its axes and the collectives over them.
    ``backend`` "gloo" stages CUDA tensors through pinned host memory (ranks
    that share a card; CPU runs), "nccl" hands them to NCCL (a GPU a rank).

    A pipeline's mesh (parallel/pipeline.py) has a leading ``stage`` axis
    of ``n_stage`` ranks: rank ``s · n_data · n_model + d · n_model + m``.
    With ``n_stage`` 1 that is the (data, model) layout above."""
    n_data: int
    n_model: int
    rank: int
    backend: str = "gloo"
    groups: dict = dataclasses.field(default_factory=dict)  # axis -> (group, global ranks)
    n_stage: int = 1
    # collectives run and the host seconds spent in them (copies and waits
    # included): what a step pays for the mesh
    calls: int = 0
    seconds: float = 0.0

    @property
    def data_index(self) -> int:
        return self.rank // self.n_model % self.n_data

    @property
    def model_index(self) -> int:
        return self.rank % self.n_model

    @property
    def stage_index(self) -> int:
        return self.rank // (self.n_data * self.n_model)

    @property
    def shape(self) -> tuple:
        return (self.n_data, self.n_model)

    def size(self, axis: str) -> int:
        return {MODEL_AXIS: self.n_model, DATA_AXIS: self.n_data, STAGE_AXIS: self.n_stage}[axis]

    def ranks(self, axis: str) -> list:
        return self.groups[axis][1]

    def _host(self) -> bool:
        return self.backend == "gloo"

    def _run(self, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        self.calls += 1
        self.seconds += time.perf_counter() - t0
        return out

    def all_reduce(self, t: torch.Tensor, axis: str = MODEL_AXIS, op: str = "sum"):
        if self.size(axis) == 1:
            return t
        return self._run(dist_utils.all_reduce, t, self.groups[axis][0], op, self._host())

    def all_gather(self, t: torch.Tensor, axis: str = MODEL_AXIS):
        """(size(axis), *t.shape): the axis' ranks' t in rank order."""
        if self.size(axis) == 1:
            return t[None]
        return self._run(dist_utils.all_gather, t, self.groups[axis][0], self._host())

    def broadcast(self, t: torch.Tensor, src_index: int, axis: str = DATA_AXIS):
        """Rank ``src_index`` of the axis' t on every rank of the axis."""
        if self.size(axis) == 1:
            return t
        group, ranks = self.groups[axis]
        return self._run(dist_utils.broadcast, t, ranks[src_index], group, self._host())

    def ring_shift(self, t: torch.Tensor, axis: str = MODEL_AXIS):
        """Pass t to the next rank of the axis; returns the previous one's."""
        if self.size(axis) == 1:
            return t
        return self._run(dist_utils.ring_shift, t, self.ranks(axis), self._host())

    def send(self, t: torch.Tensor, dst_index: int, axis: str = STAGE_AXIS) -> None:
        """Send t to rank ``dst_index`` of the axis (its ``recv`` takes it)."""
        self._run(dist_utils.send, t, self.ranks(axis)[dst_index], self._host())

    def recv(self, like: torch.Tensor, src_index: int, axis: str = STAGE_AXIS):
        """A tensor of like's shape and dtype from rank ``src_index`` of the
        axis."""
        return self._run(dist_utils.recv, like, self.ranks(axis)[src_index], self._host())


def make_mesh(n_data: int, n_model: int, n_stage: int = 1) -> Mesh:
    """The mesh over the default process group, whose world must be
    n_stage · n_data · n_model (one process: a (1, 1) mesh with no group),
    and whose backend the mesh takes.  Every rank must call it: each builds
    every axis group, in the same order."""
    import torch.distributed as dist

    backend = dist.get_backend() if dist.is_initialized() else "gloo"
    if backend not in BACKENDS:
        raise ValueError(f"mesh backend {backend!r}: one of {BACKENDS}")
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != n_stage * n_data * n_model:
        raise ValueError(f"a ({n_data}, {n_model}) mesh of {n_stage} stages needs "
                         f"{n_stage * n_data * n_model} ranks, the process group has {world}")
    rank = dist.get_rank() if dist.is_initialized() else 0
    mesh = Mesh(n_data, n_model, rank, backend, n_stage=n_stage)
    per = n_data * n_model

    def at(s, d, m):
        return s * per + d * n_model + m

    axes = (
        (MODEL_AXIS, [[at(s, d, m) for m in range(n_model)]
                      for s in range(n_stage) for d in range(n_data)]),
        (DATA_AXIS, [[at(s, d, m) for d in range(n_data)]
                     for s in range(n_stage) for m in range(n_model)]),
        (STAGE_AXIS, [[at(s, d, m) for s in range(n_stage)]
                      for d in range(n_data) for m in range(n_model)]),
    )
    for axis, sets in axes:
        for ranks in sets:
            group = dist.new_group(ranks) if len(ranks) > 1 else None
            if rank in ranks:
                mesh.groups[axis] = (group, ranks)
    return mesh


def tp_divisibility_ok(config: ChatGLM2Config, tp: int, quant_type: str) -> bool:
    """Every sharded dim divides by tp (int4: K shards stay nibble-pair and
    group-32 aligned) — the JAX package's check (:187-196)."""
    qs, I, V = config.q_size, config.inner_hidden_size, config.vocab_size
    if any(d % tp for d in (qs, I, V, config.num_attention_heads)):
        return False
    if quant_type == "int4g32" and ((qs // tp) % 32 or (I // tp) % 32):
        return False
    return True


def default_mesh_shape(n_devices: int, config: Optional[ChatGLM2Config] = None,
                       quant_type: str = "none") -> tuple:
    """(data, model) for n devices: model parallel up to the head count
    where every sharded dim divides, then data parallel (:49-64)."""
    config = config or ChatGLM2Config()
    for cand in (8, 4, 2, 1):
        if (n_devices % cand == 0 and config.num_attention_heads % cand == 0
                and tp_divisibility_ok(config, cand, quant_type)):
            return n_devices // cand, cand
    return n_devices, 1


# ---------------------------------------------------------------------------
# Heads and KV groups of a rank
# ---------------------------------------------------------------------------

def head_split(config: ChatGLM2Config, tp: int, m: int) -> tuple:
    """(g0, Gl, Hgl): model rank m of tp holds the query heads m·nH/tp ..
    (m + 1)·nH/tp − 1 in the flattened (group, head) order: Gl whole groups
    of Hgl = Hg heads from group g0, or Hgl < Hg heads of group g0."""
    G, nH = config.num_multi_query_groups, config.num_attention_heads
    Hg, Hl = nH // G, nH // tp
    if nH % tp or (Hl % Hg and Hg % Hl):
        raise ValueError(f"{nH} heads in {G} groups do not split over tp = {tp}")
    if Hl >= Hg:
        return m * Hl // Hg, Hl // Hg, Hg
    return m * Hl // Hg, 1, Hl


# ---------------------------------------------------------------------------
# The param tree
# ---------------------------------------------------------------------------

def leaf_paths(tree: dict, prefix: tuple = ()) -> list:
    """[(key path, leaf)] of a nested dict, in key order."""
    out = []
    for k, v in tree.items():
        out.extend(leaf_paths(v, prefix + (k,)) if isinstance(v, dict) else [(prefix + (k,), v)])
    return out


def _shape(x) -> tuple:
    return tuple(x.shape) if hasattr(x, "shape") else tuple(x)


def storage_k(p: dict, quant_type: str) -> int:
    """A linear's K as stored (int4: two rows a byte)."""
    k = _shape(p["weight"])[-2]
    return 2 * k if quant_type == "int4g32" else k


def row_bounds(p: dict, quant_type: str, tp: int) -> list:
    """The row split of a row-parallel linear: tp + 1 storage-K boundaries,
    each part group-32 aligned for int4g32."""
    Ks = storage_k(p, quant_type)
    unit = GROUP_K if quant_type == "int4g32" else 1
    if Ks % (tp * unit):
        raise ValueError(f"storage K {Ks} does not split over tp = {tp} in units of {unit}")
    return [r * Ks // tp for r in range(tp + 1)]


def shard_cols(p: dict, n0: int, n1: int) -> dict:
    """Output columns n0 .. n1 - 1 of a linear (weight, scale and bias)."""
    out = {"weight": p["weight"][..., n0:n1]}
    if "weight_scale" in p:
        out["weight_scale"] = p["weight_scale"][..., n0:n1]
    if "bias" in p:
        out["bias"] = p["bias"][..., n0:n1]
    return out


def shard_rows(p: dict, k0: int, k1: int, quant_type: str) -> dict:
    """Storage rows k0 .. k1 - 1 of a linear's K (int4: its nibble pairs
    and group scales along; the int8 scale and any bias stay whole)."""
    out = dict(p)
    if quant_type == "int4g32":
        out["weight"] = p["weight"][..., k0 // 2:k1 // 2, :]
        out["weight_scale"] = p["weight_scale"][..., k0 // GROUP_K:k1 // GROUP_K, :]
    else:
        out["weight"] = p["weight"][..., k0:k1, :]
    return out


COL_LINEARS = ("q_proj", "w_in_h", "w_in_gate", "lm_head")
ROW_LINEARS = ("o_proj", "w_out")


def split_dim(path: tuple, quant_type: str) -> Optional[int]:
    """The dim of leaf ``path`` (its keys, e.g. ("layers", "o_proj",
    "weight")) that the model axis splits, or None where every rank holds
    it whole."""
    owner, leaf = (path[-2] if len(path) > 1 else None), path[-1]
    if owner in COL_LINEARS:
        return -1
    if owner in ROW_LINEARS and (leaf == "weight" or
                                 (leaf == "weight_scale" and quant_type == "int4g32")):
        return -2
    return None


def shard_slices(params: dict, config: ChatGLM2Config, quant_type: str, tp: int,
                 m: int) -> dict:
    """Model rank m's part of every leaf of a full tree (tensors, or their
    shapes): a tree of the same keys whose leaves are (dim, start, stop)
    or None (whole).  ``shard_params`` takes these slices; a sharded
    checkpoint (utils/dist_ckpt.py) reads them.  See the module note."""
    layers = params["layers"]
    o_b = row_bounds(layers["o_proj"], quant_type, tp)
    w_b = row_bounds(layers["w_out"], quant_type, tp)
    qs, I = config.q_size, config.inner_hidden_size
    if o_b[-1] != qs or qs % tp or (qs // tp) % config.head_hidden_size:
        raise ValueError(f"q_proj's {qs} columns (o_proj's storage K {o_b[-1]}) do not split "
                         f"into whole heads over tp = {tp}")
    head_split(config, tp, m)  # raises where the heads do not split
    V = _shape(params["lm_head"]["weight"])[-1]
    if V % tp:
        raise ValueError(f"lm_head's {V} columns do not split over tp = {tp}")
    ranges = {"q_proj": (o_b[m], o_b[m + 1]), "o_proj": (o_b[m], o_b[m + 1]),
              # w_in's columns end where w_out's rows of real (unpadded) K do
              "w_in_h": (min(w_b[m], I), min(w_b[m + 1], I)),
              "w_in_gate": (min(w_b[m], I), min(w_b[m + 1], I)),
              "w_out": (w_b[m], w_b[m + 1]), "lm_head": (m * V // tp, (m + 1) * V // tp)}

    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        dim = split_dim(path, quant_type)
        if dim is None:
            return None
        r0, r1 = ranges[path[-2]]
        if dim == -2 and quant_type == "int4g32":  # nibble pairs, group-32 scale rows
            unit = 2 if path[-1] == "weight" else GROUP_K
            r0, r1 = r0 // unit, r1 // unit
        return (dim, r0, r1)

    return walk(params, ())


def take_slice(t: torch.Tensor, sl) -> torch.Tensor:
    """``t`` narrowed to ``sl`` (a ``shard_slices`` leaf), a view."""
    return t if sl is None else t.narrow(sl[0], sl[1], sl[2] - sl[1])


def shard_params(params: dict, mesh: Mesh, config: ChatGLM2Config, quant_type: str,
                 device=None) -> dict:
    """This rank's slice of the full tree (``convert.params_from_numpy``'s,
    or ``bench.random_quantized_params``', on any device or memory-mapped),
    copied to ``device`` (default: where the tree lies).  See the module
    note for the placement."""
    slices = shard_slices(params, config, quant_type, mesh.n_model, mesh.model_index)

    def walk(node, sl):
        if isinstance(node, dict):
            return {k: walk(v, sl[k]) for k, v in node.items()}
        t = take_slice(node, sl).contiguous()
        return t if device is None else t.to(device)

    return walk(params, slices)


# ---------------------------------------------------------------------------
# The KV cache
# ---------------------------------------------------------------------------

def kv_cache_shape(config: ChatGLM2Config, mesh: Mesh, batch: int, max_length: int,
                   shard_t: bool = False) -> tuple:
    """This rank's (L, B / n_data, G', T', D) dense cache: the data rank's
    rows; every group over T / tp slots with ``shard_t``, else the groups
    of the rank's heads over all T."""
    tp = mesh.n_model
    if batch % mesh.n_data:
        raise ValueError(f"batch {batch} does not split over {mesh.n_data} data ranks")
    if shard_t:
        if max_length % tp:
            raise ValueError(f"a cache of {max_length} slots does not split over tp = {tp}")
        groups, T = config.num_multi_query_groups, max_length // tp
    else:
        groups, T = head_split(config, tp, mesh.model_index)[1], max_length
    return (config.num_layers, batch // mesh.n_data, groups, T, config.head_hidden_size)


def pool_pages(num_pages: int, mesh: Mesh, shard_model: bool = False) -> int:
    """Pages of this rank's part of a pool of ``num_pages``: the data rank's
    group, and with ``shard_model`` its model rank's phase of it."""
    n = mesh.n_data * (mesh.n_model if shard_model else 1)
    if num_pages % n:
        raise ValueError(f"{num_pages} pages do not split over {n} ranks")
    return num_pages // n


def pool_groups(config: ChatGLM2Config, mesh: Mesh, shard_model: bool = False) -> int:
    """KV groups of this rank's pool: every group under ``shard_model``,
    else those of its heads."""
    if shard_model:
        return config.num_multi_query_groups
    return head_split(config, mesh.n_model, mesh.model_index)[1]

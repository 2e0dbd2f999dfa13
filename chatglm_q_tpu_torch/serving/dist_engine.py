"""Continuous batching over a (data, model) mesh of ranks: the counterpart of
chatglm_q_tpu/serving/dist_engine.py.

JAX runs the engine as one global program over the mesh; here every rank
is a process that runs the same engine on its shard (``shard_params``'
slice of the weights, its part of the cache), and the host schedulers stay
in lockstep because every rank sees the same submissions and the same
tokens:

* **slot → group**: slots split into ``n_data`` equal groups; group d's
  rows live and run on data rank d's ranks (``local_batch_slice``);
  admission fills the group with the fewest active slots first;
* **admission**: only the slot's data rank prefills it; the prompt's last
  logits are broadcast over the data axis (a chunk's rows are summed over
  it, each row from its owner), so every rank samples the same first token;
* **decode**: each data rank decodes its group's rows (the paged engine all
  of them, padding rows on their garbage pages: JAX's full-batch decode)
  and ``_fetch`` all-gathers a chunk's tokens over the data axis; the
  sampling settings, the sort width and the choice between a plain and a
  speculative chunk are taken over every slot, so every rank draws from
  its generator (seeded alike) in the same order and the ranks stay
  token-equal;
* **submissions and cancels**: ``sync_events`` broadcasts rank 0's events
  (each submission with its own sampling settings, each cancel) to every
  rank, which applies them in the same order; ``sync_submissions`` submits
  a list of prompts through it.  The API server (serving/api_server.py)
  runs on rank 0 and ``follow`` on the others.

``DistributedServingEngine(rt.kv_shard_t)`` splits the dense cache over T
(ring prefill, K1 decode), and takes ``lookahead``: chunk N+1 is enqueued on
chunk N's device tokens (each data rank chains its own rows) before chunk N
is all-gathered, so the gather is deferred by one step on every rank alike.
``DistributedPagedServingEngine(shard_model_pages=True)`` splits the pool
by page phase (K2 decode) with the phase-aware allocator (paged_engine.py)
and prefix-affinity admission: a request goes to the group whose registry
holds its longest prefix.  It takes in-loop speculation (``speculative_k``,
``speculative_sampled``) on either pool layout: the verify step writes
through the rank's local table (on a model-sharded pool only its phase's
blocks), and a step's drafts, accepts and next tokens are all-gathered as a
plain chunk's tokens are.

The decode chunks are the single-process engines' decode programs over
the rank's rows and cache (utils/graphs.py): over NCCL they are captured,
each rank capturing the same collectives in the same order (the ranks run
in lockstep); over gloo they run eagerly through the same buffers (gloo's
collectives cannot be captured: ``MESH_REFUSAL``, warned once).  The
prefills and chunks of a mesh run eagerly (``MESH_PREFILL_REFUSAL``).
"""
from __future__ import annotations

import dataclasses
import json
from typing import Optional

import numpy as np
import torch

from ..config import GLMLoadConfig, TorchRuntimeConfig
from ..models import chatglm2 as M
from ..models import paged_kv as PK
from ..ops import attention as A
from ..parallel import sharding as SH
from ..utils import distributed as dist_utils
from .engine import ServingEngine
from .paged_engine import PagedServingEngine


def _mesh_rt(rt: Optional[TorchRuntimeConfig], mesh, **flags) -> TorchRuntimeConfig:
    rt = rt or TorchRuntimeConfig()
    return dataclasses.replace(rt, mesh=mesh, **flags)


class _MeshEngine:
    """What both distributed engines share: groups, the broadcasts and the
    gathers over the data axis."""

    def _init_mesh(self, mesh, max_batch: int):
        self.mesh = mesh
        self.n_data = mesh.n_data
        if max_batch % self.n_data:
            raise ValueError(f"max_batch {max_batch} does not split over {self.n_data} "
                             "data ranks")
        self._rows = dist_utils.local_batch_slice(max_batch, self.n_data, mesh.data_index)

    @property
    def _group_size(self) -> int:
        return self.max_batch // self.n_data

    def _shard_of(self, slot_idx: int) -> int:
        return slot_idx // self._group_size

    def _mine(self, slot_idx: int) -> bool:
        return self._shard_of(slot_idx) == self.mesh.data_index

    def _fetch(self, x) -> np.ndarray:
        """A chunk's tokens of this rank's rows, all-gathered over the data
        axis: (max_batch, ...) on every rank."""
        return self.mesh.all_gather(x, "data").reshape(self.max_batch, *x.shape[1:]).cpu().numpy()

    def _logits_from(self, owner: int, logits: Optional[torch.Tensor]) -> torch.Tensor:
        """The owner data rank's last logits (V,) on every rank."""
        if logits is None:
            logits = torch.zeros((self.mc.vocab_size,), dtype=self.dtype, device=self.device)
        return self.mesh.broadcast(logits, owner, "data")

    def _chunk_rows(self, slots) -> list:
        return [i for i, b in enumerate(slots) if self._mine(b)]

    def _sum_rows(self, logits_mine: Optional[torch.Tensor], mine: list, n: int) -> torch.Tensor:
        """(n, V) logits of a chunk's rows, each from its owner's data rank."""
        out = torch.zeros((n, self.mc.vocab_size), dtype=self.dtype, device=self.device)
        if mine:
            out[torch.tensor(mine, device=self.device)] = logits_mine.to(self.dtype)
        return self.mesh.all_reduce(out, "data")

    def sync_submissions(self, requests: Optional[list] = None, **kwargs):
        """Rank 0's prompts (strings or token-id lists) submitted on every
        rank in the same order, each with rank 0's ``kwargs``; the other
        ranks' arguments are ignored."""
        events = None
        if dist_utils.is_primary():
            events = []
            for p in requests or []:
                if isinstance(p, str):
                    if self.tokenizer is None:
                        raise ValueError("string prompts need an engine tokenizer")
                    p = self.tokenizer.encode(p)
                events.append(("submit", [int(t) for t in p], kwargs))
        self.sync_events(events)

    def sync_events(self, events: Optional[list] = None, stop: bool = False) -> tuple:
        """Rank 0's ``events`` and ``stop`` applied on every rank, in order
        (``ServingEngine.sync_events``), after one broadcast of them (JSON;
        floats round-trip exactly); the other ranks pass None."""
        if dist_utils.process_count() > 1:
            host = self.mesh.backend == "gloo"
            dev = torch.device("cpu") if host else self.device
            payload = b""
            if dist_utils.is_primary():
                payload = json.dumps([list(events or []), bool(stop)]).encode()
            size = torch.tensor([len(payload)], dtype=torch.int64, device=dev)
            size = int(dist_utils.broadcast(size, 0, None, host)[0])
            buf = torch.zeros((size,), dtype=torch.uint8)
            if dist_utils.is_primary():
                buf.copy_(torch.frombuffer(bytearray(payload), dtype=torch.uint8))
            buf = dist_utils.broadcast(buf.to(dev), 0, None, host).cpu()
            events, stop = json.loads(buf.numpy().tobytes().decode())
        return super().sync_events(events, stop)


class DistributedServingEngine(_MeshEngine, ServingEngine):
    """``ServingEngine`` on a rank of ``mesh`` (see the module note); params
    are the rank's ``shard_params`` slice.  ``rt.kv_shard_t`` splits the
    cache's T slots over the model axis."""

    def __init__(self, config: GLMLoadConfig, params: dict, tokenizer=None, *, mesh,
                 max_batch: int = 8, rt: Optional[TorchRuntimeConfig] = None, **kwargs):
        self._init_mesh(mesh, max_batch)
        super().__init__(config, params, tokenizer, max_batch=max_batch,
                         rt=_mesh_rt(rt, mesh), **kwargs)

    def _make_cache(self):
        shape = SH.kv_cache_shape(self.mc, self.mesh, self.max_batch, self.max_seq_len,
                                  self.rt.kv_shard_t)
        return M.KVCache(A.kv_zeros(shape, self.kv_dtype, self.device),
                         A.kv_zeros(shape, self.kv_dtype, self.device),
                         torch.zeros((shape[1],), dtype=torch.int32, device=self.device))

    def _local(self, slot: int) -> int:
        return slot - self._rows.start

    def _admit(self):
        """Fill the group with the fewest active slots first (the base class
        fills slots in order, which piles work onto data rank 0)."""
        while self.queue:
            active = [0] * self.n_data
            free: list = [[] for _ in range(self.n_data)]
            for idx, slot in enumerate(self.slots):
                g = self._shard_of(idx)
                if slot.request is not None:
                    active[g] += 1
                else:
                    free[g].append(idx)
            candidates = [g for g in range(self.n_data) if free[g]]
            if not candidates:
                return
            g = min(candidates, key=lambda g: active[g])
            if self.prefill_chunk_size is not None:
                self._assign_chunked(free[g][0], self.queue.pop(0))
            else:
                self._admit_into_slot(free[g][0], self.queue.pop(0))

    def _prefill_into_slot(self, ids: list, slot: int, bucket: int) -> torch.Tensor:
        logits = None
        if self._mine(slot):
            r = self._local(slot)
            padded = np.zeros((1, bucket), np.int32)
            padded[0, : len(ids)] = ids
            view = M.KVCache(self.cache.k[:, r:r + 1], self.cache.v[:, r:r + 1],
                             self.cache.lengths[r:r + 1])
            logits, _ = M.prefill(self.params, self.mc, self._ids(padded).long(),
                                  self._ids([len(ids)]), view, self.config.quant_type,
                                  self.dtype, self.rt)
            self.cache.lengths[r] = len(ids)
            logits = logits[0]
        return self._logits_from(self._shard_of(slot), logits)

    def _prefill_chunk_compact(self, ids, starts, valids, slots) -> torch.Tensor:
        mine = self._chunk_rows(slots)
        logits = None
        if mine:
            logits, self.cache = M.prefill_chunk(
                self.params, self.mc, self._ids(ids[mine]).long(), self._ids(starts[mine]),
                self._ids(valids[mine]), self.cache, self.config.quant_type, self.dtype,
                self.rt, slot_map=self._ids([self._local(slots[i]) for i in mine]))
        return self._sum_rows(logits, mine, len(slots))

    def _decode_chunk(self, first_tok, active, free, sampling, n: int, top_k: int):
        """The group's rows of the base engine's chunk; returns their tokens
        (B / n_data, n), which ``_fetch`` gathers."""
        rows = self._rows
        temperature, top_p, top_k_limit, any_sampled = sampling
        local_sampling = (temperature[rows], top_p[rows], top_k_limit[rows], any_sampled)
        # the cache holds the group's rows: the base engine's program over it
        return super()._decode_chunk(first_tok[rows], active[rows], free[rows], local_sampling,
                                     n, top_k)

    def _chain(self, first, prev_toks, prev_active):
        """Lookahead: the group's rows continue from their own last device
        token of the unread chunk (``prev_toks`` holds the group's rows)."""
        rows = self._rows
        first = first.clone()
        first[rows] = torch.where(prev_active[rows], prev_toks[:, -1], first[rows])
        return first

    def _roll_back(self, b: int, extra: int):
        if self._mine(b):
            self.cache.lengths[self._local(b)] -= extra


class DistributedPagedServingEngine(_MeshEngine, PagedServingEngine):
    """``PagedServingEngine`` on a rank of ``mesh`` (see the module note).
    The pool splits its pages over the data axis, a data rank's group's
    pages on it; with ``shard_model_pages`` also over the model axis by
    phase: logical page j of a row on model rank j % tp.  Each rank keeps
    the whole page table (the allocator's, the same on every rank) and its
    group's rows' lengths."""

    def __init__(self, config: GLMLoadConfig, params: dict, tokenizer=None, *, mesh,
                 max_batch: int = 8, rt: Optional[TorchRuntimeConfig] = None,
                 shard_model_pages: bool = False, **kwargs):
        self._init_mesh(mesh, max_batch)
        shard = shard_model_pages and mesh.n_model > 1
        self.n_phase = mesh.n_model if shard else 1
        super().__init__(config, params, tokenizer, max_batch=max_batch,
                         rt=_mesh_rt(rt, mesh, paged_shard_model=shard), **kwargs)

    def _make_cache(self):
        shard = self.rt.paged_shard_model
        pages = SH.pool_pages(self.num_pages, self.mesh, shard)
        groups = SH.pool_groups(self.mc, self.mesh, shard)
        mp = -(-self.max_seq_len // self.page_size)
        shape = (self.mc.num_layers, pages, groups, self.page_size, self.mc.head_hidden_size)
        dev = self.device
        return PK.PagedKVCache(
            A.kv_zeros(shape, self.kv_dtype, dev),
            A.kv_zeros(shape, self.kv_dtype, dev),
            torch.zeros((self.max_batch, mp), dtype=torch.int32, device=dev),
            torch.zeros((self.max_batch,), dtype=torch.int32, device=dev))

    def _admit(self):
        """Prefix affinity: each queued request goes to the group whose
        registry holds its longest prompt prefix, ties to the one with the
        fewest active slots; a group that cannot allocate is skipped, and
        admission waits when none can."""
        while self.queue:
            req = self.queue[0]
            ids = self._sliced_prompt(req)
            active = [0] * self.n_data
            free: list = [[] for _ in range(self.n_data)]
            for idx, slot in enumerate(self.slots):
                g = self._slot_group(idx)
                if slot.request is not None:
                    active[g] += 1
                else:
                    free[g].append(idx)
            ranked = []
            for g in range(self.n_data):
                if free[g]:
                    shared = self._match_prefix(ids, g, peek=True)[1] if self.prefix_cache else 0
                    ranked.append((-shared, active[g], g))
            if not ranked:
                return
            if not any(self._try_admit(free[g][0], req) for _, _, g in sorted(ranked)):
                return
            self.queue.pop(0)

    def _prefill_into_slot(self, ids: list, slot: int, bucket: int) -> torch.Tensor:
        logits = None
        if self._mine(slot):
            logits = super()._prefill_into_slot(ids, slot, bucket)
        self.cache.lengths[slot] = len(ids)
        return self._logits_from(self._shard_of(slot), logits)

    def _prefill_chunk_compact(self, ids, starts, valids, slots) -> torch.Tensor:
        mine = self._chunk_rows(slots)
        logits = None
        if mine:
            logits = super()._prefill_chunk_compact(ids[mine], starts[mine], valids[mine],
                                                    [slots[i] for i in mine])
        return self._sum_rows(logits, mine, len(slots))

    def _decode_batch(self, active: list) -> tuple[list, list]:
        """The group's rows: free and mid-prefill ones are not real (they run
        on their garbage pages at length 0)."""
        slots = list(range(self._rows.start, self._rows.stop))
        return slots, [self.slots[b].decoding for b in slots]

    def _fetch_rows(self, slots: list, real: list) -> dict:
        return {b: b for b in range(self.max_batch)}  # gathered in slot order

    def _chunk_sampling(self, slots: list, real: list):
        """Every slot's sampling settings and sort width, sliced to the
        group's rows: every data rank draws the same number of values."""
        (temperature, top_p, top_k_limit, any_sampled), sort_k = self._row_params(
            [b if s.decoding else None for b, s in enumerate(self.slots)])
        r = self._rows
        return (temperature[r], top_p[r], top_k_limit[r], any_sampled), sort_k

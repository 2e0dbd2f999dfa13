"""Continuous batching over a paged KV pool: the counterpart of
chatglm_q_tpu/serving/paged_engine.py (``PagedServingEngine``).

The scheduler and slot semantics are ``ServingEngine``'s (greedy tokens
equal the dense engine's), but KV lives in a shared page pool
(models/paged_kv.py) instead of per-slot max-length rows:

* admission allocates ``ceil(tokens_needed / page_size)`` pages from a free
  list into the slot's page-table row; a request whose pages do not fit
  waits at the head of the queue until finishes free pages (backpressure,
  not an out-of-memory error);
* physical page 0 is a reserved garbage page: padding rows of a compact
  decode write there, and a finished slot's table row is reset to it, so a
  recycled page is never written through a stale table;
* allocation is per group and phase: the distributed engine
  (serving/dist_engine.py) sets ``n_data`` slot groups, each with its own
  pages (a data rank's), and with a model-sharded pool ``n_phase`` phase
  sub-pools in each: logical page j of a row comes from sub-pool j % n_phase
  (the model rank that holds it).  Every sub-pool's first page is its
  garbage page, and a free slot's table points at its own sub-pools' (JAX
  :47-76, 92-225).  This engine alone is one group of one phase;
* pages are refcounted: slots and prefix-cache entries each hold one
  reference, and a page returns to the free list at zero;
* ``prefix_cache``: every page-aligned prefix of a prefilled prompt is
  registered in an LRU; a later prompt that shares one reuses its pages and
  resumes its chunked prefill after them; entries are evicted under
  pressure, but only when eviction can cover the shortage;
* decode is compact: only the decoding slots' rows run, bucketed to a power
  of two, padding rows on the garbage table at length 0; each bucket's
  decode step is a program of its own (``paged_kv.decode_paged_program``,
  captured: utils/graphs.py), the compact view copied into its buffers;
* ``speculative_k``: the decode chunk runs in-loop prompt-lookup
  speculation (models/spec_decode.py, its step captured likewise) when every
  decoding request is greedy, or always with ``speculative_sampled``, where
  sampled rows accept by exact rejection sampling (``spec_accept_next``) in
  the same program as the greedy ones; otherwise a chunk with a sampling
  request decodes plainly.  Padding rows stay greedy.

JAX's ``full_batch_decode`` switch is a TPU backend workaround, left out
of the port: this engine decodes compact, the distributed one its group's
rows.  ``lookahead`` is a dense-engine option.
"""
from __future__ import annotations

from collections import Counter, OrderedDict
from typing import Optional

import numpy as np
import torch

from ..models import chatglm2 as M
from ..models import paged_kv as PK
from ..models import spec_decode as SD
from .engine import ServingEngine


class PagedServingEngine(ServingEngine):
    def __init__(self, config, params, tokenizer=None, *, num_pages: int = 64,
                 page_size: int = 256, prefix_cache: bool = False, speculative_k: int = 0,
                 speculative_ngram: int = 3, speculative_sampled: bool = False, **kwargs):
        if kwargs.get("lookahead"):
            raise ValueError("lookahead is a dense-engine option; speculative_k is the paged "
                             "engine's way to amortize the host round trip")
        # page groups (the distributed engine sets n_data and n_phase first)
        self._n_groups = getattr(self, "n_data", 1)
        self._n_phase = getattr(self, "n_phase", 1)
        n_subs = self._n_groups * self._n_phase
        if num_pages % n_subs or num_pages // n_subs < 2:
            raise ValueError(f"{num_pages} pages: each of the {n_subs} sub-pools needs a garbage "
                             "page and one usable page")
        self._sub_pages = num_pages // n_subs
        # read by _make_cache, which ServingEngine.__init__ calls
        self.num_pages = num_pages
        self.page_size = page_size
        self.prefix_cache = prefix_cache
        self.speculative_k = speculative_k
        self.speculative_ngram = speculative_ngram
        self.speculative_sampled = speculative_sampled
        super().__init__(config, params, tokenizer, **kwargs)
        if self.prefill_chunk_size is not None and self.prefill_chunk_size % page_size:
            raise ValueError("chunked prefill over pages needs page-aligned chunks")
        if prefix_cache and self.prefill_chunk_size is None:
            # a prefix hit resumes the prefill at a page-aligned offset: the
            # chunked-prefill entry point
            raise ValueError("prefix_cache needs prefill_chunk_size")
        # free pages per (group, phase); each sub-pool's first page is its garbage page
        sp, nph = self._sub_pages, self._n_phase
        self._free = [[list(range((g * nph + m) * sp + 1, (g * nph + m + 1) * sp))
                       for m in range(nph)] for g in range(self._n_groups)]
        self._slot_pages: dict[int, list[int]] = {}
        self._page_refs: dict[int, int] = {}
        # per group: page-aligned token prefix -> its pages, in LRU order
        self._prefix_lrus = [OrderedDict() for _ in range(self._n_groups)]
        # a free slot's table row: block j on the garbage page of its own
        # (group, j % n_phase) sub-pool
        mp = self.cache.page_table.shape[1]
        self._garbage = np.array([[(self._slot_group(b) * nph + j % nph) * sp for j in range(mp)]
                                  for b in range(self.max_batch)], np.int32)
        self._garbage_t = self._ids(self._garbage)
        self.cache.page_table.copy_(self._garbage_t)
        self.stats.update(prefix_hits=0, prefix_tokens_reused=0, spec_accepted=0,
                          spec_steps=0)
        # device token history per slot (valid below the lengths) for n-gram
        # drafting; the prompt is written at admission
        self._tokbuf = torch.zeros((self.max_batch, self.max_seq_len), dtype=torch.int32,
                                   device=self.device)

    def _make_cache(self):
        return PK.init_paged_kv_cache(self.mc, self.max_batch, self.num_pages, self.max_seq_len,
                                      self.page_size, self.kv_dtype, self.device)

    @property
    def pages_in_use(self) -> int:
        return sum(len(p) for p in self._slot_pages.values())

    @property
    def pages_cached(self) -> int:
        return sum(len(p) for lru in self._prefix_lrus for p in lru.values())

    @property
    def _free_pages(self) -> list:
        """Every free page, over groups and phases."""
        return [p for g in self._free for fl in g for p in fl]

    @property
    def _prefix_lru(self):
        """Group 0's registry: the whole registry of a one-group engine."""
        return self._prefix_lrus[0]

    def _slot_group(self, slot_idx: int) -> int:
        return slot_idx // (self.max_batch // self._n_groups)

    # -- page refcounting ----------------------------------------------------

    def _retain(self, pages):
        for p in pages:
            self._page_refs[p] = self._page_refs.get(p, 0) + 1

    def _release(self, pages):
        for p in pages:
            self._page_refs[p] -= 1
            if self._page_refs[p] == 0:
                del self._page_refs[p]
                g, m = divmod(p // self._sub_pages, self._n_phase)
                self._free[g][m].append(p)

    def _alloc(self, n: int, group: int = 0, start_block: int = 0):
        """Take n fresh pages (one reference each) of ``group`` for a row's
        logical blocks start_block .. start_block + n − 1 (block j from phase
        sub-pool j % n_phase), evicting the group's LRU prefix entries under
        pressure; None if the group cannot supply them.  A page that a slot
        also holds stays allocated when its registry reference drops, so
        eviction runs only if the registry-only pages cover the shortage:
        emptying the LRU for nothing would wipe the prefixes the next
        requests need."""
        frees, lru, nph = self._free[group], self._prefix_lrus[group], self._n_phase
        phases = [(start_block + i) % nph for i in range(n)]
        need = [phases.count(m) for m in range(nph)]

        def short():
            return any(len(frees[m]) < need[m] for m in range(nph))

        if short():
            if not lru:
                return None
            reg_refs = Counter()
            for pages in lru.values():
                reg_refs.update(pages)
            potential = [0] * nph
            for p, r in reg_refs.items():
                if self._page_refs.get(p, 0) == r:  # held by the registry only
                    potential[(p // self._sub_pages) % nph] += 1
            if any(len(frees[m]) + potential[m] < need[m] for m in range(nph)):
                return None
            while short() and lru:
                key, pages = lru.popitem(last=False)
                self._release(pages)
                if self.logger:
                    self.logger.log("prefix_evict", tokens=len(key), pages=len(pages))
            if short():
                return None
        pages = [frees[m].pop() for m in phases]
        self._retain(pages)
        return pages

    # -- prefix cache --------------------------------------------------------

    def _match_prefix(self, ids: list, group: int = 0, peek: bool = False):
        """The longest prefix registered in ``group`` that is page-aligned
        and strictly shorter than the prompt (its last token must prefill,
        for its logits).  ``peek`` leaves the LRU order as it is (the
        distributed admission's scoring)."""
        P, lru = self.page_size, self._prefix_lrus[group]
        for k in range((len(ids) - 1) // P, 0, -1):
            key = tuple(ids[: k * P])
            if key in lru:
                if not peek:
                    lru.move_to_end(key)
                return list(lru[key]), k * P
        return [], 0

    def _start_decoding(self, slot_idx, req, logits, n_ids):
        if self.prefix_cache:
            # the prompt's KV is written: publish every page-aligned prefix,
            # so a prompt sharing only the head (a system prompt) matches the
            # shared pages; the registry holds one reference per entry per
            # page, in the slot's own group (its pages live there)
            ids = self._sliced_prompt(req)
            lru = self._prefix_lrus[self._slot_group(slot_idx)]
            for k in range(1, (len(ids) - 1) // self.page_size + 1):
                key = tuple(ids[: k * self.page_size])
                if key not in lru:
                    pages = self._slot_pages[slot_idx][:k]
                    self._retain(pages)
                    lru[key] = pages
        super()._start_decoding(slot_idx, req, logits, n_ids)

    def clear_prefix_cache(self):
        for lru in self._prefix_lrus:
            while lru:
                _, pages = lru.popitem(last=False)
                self._release(pages)

    # -- device programs -----------------------------------------------------

    def _prefill_into_slot(self, ids: list, slot: int, bucket: int) -> torch.Tensor:
        """Whole-prompt admission: a one-row view of the pool through the
        slot's table row; attention runs on the fresh K/V."""
        padded = np.zeros((1, bucket), np.int32)
        padded[0, : len(ids)] = ids
        # the bucket's program (one for every slot: the table row is an input)
        prog = PK.prefill_paged_program(self.params, self.mc, self.cache, 1, bucket,
                                        self.config.quant_type, self.dtype, self.rt)
        prog.load(ids=self._ids(padded).long(), lengths=self._ids([len(ids)]),
                  page_table=self.cache.page_table[slot:slot + 1])
        logits = prog.step(self.params, self.cache.k_pool, self.cache.v_pool)["logits"]
        self.cache.lengths[slot] = len(ids)
        return logits[0]

    def _prefill_chunk_compact(self, ids, starts, valids, slots) -> torch.Tensor:
        """A compact chunk, a program of its (rows, chunk) shape: only the
        mid-prefill slots' rows run, through their own table rows (loaded
        into the program's); no pool copies.  The rows are a power of two
        (``_advance_prefills``)."""
        slots_t = self._ids(slots).long()
        prog = PK.chunk_paged_program(self.params, self.mc, self.cache, *ids.shape,
                                      self.config.quant_type, self.dtype, self.rt)
        prog.load(ids=self._ids(ids).long(), starts=self._ids(starts), valid=self._ids(valids),
                  page_table=self.cache.page_table[slots_t])
        out = prog.step(self.params, self.cache.k_pool, self.cache.v_pool)
        self.cache.lengths[slots_t] = out["lengths"]
        return out["logits"]

    def _decode_batch(self, active: list) -> tuple[list, list]:
        """The rows of a decode chunk: (slots, real).  Compact: the decoding
        slots, then padding rows (slot 0's, not real) up to a power of two."""
        PB = min(1 << (len(active) - 1).bit_length(), self.max_batch)
        pad = PB - len(active)
        return active + [0] * pad, [True] * len(active) + [False] * pad

    def _fetch_rows(self, slots: list, real: list) -> dict:
        """A real row's slot → its row in the chunk's fetched tokens."""
        return {b: i for i, (b, r) in enumerate(zip(slots, real)) if r}

    def _chunk_sampling(self, slots: list, real: list):
        """The chunk rows' sampling tensors and sort width (``_row_params``;
        padding rows greedy)."""
        return self._row_params([b if r else None for b, r in zip(slots, real)])

    def _view(self, slots: list, real: list) -> PK.PagedKVCache:
        """The chunk's rows of the pool: real rows through their slot's table
        row and length, the others on their slot's garbage row at length 0,
        so their writes land on a garbage page."""
        slots_t, real_t = self._ids(slots).long(), self._to_device(np.array(real))
        pt = torch.where(real_t[:, None], self.cache.page_table[slots_t], self._garbage_t[slots_t])
        lens = torch.where(real_t, self.cache.lengths[slots_t], 0)
        return PK.PagedKVCache(self.cache.k_pool, self.cache.v_pool, pt, lens)

    def _store_rows(self, slots: list, real: list, lengths: torch.Tensor,
                    tokbuf: Optional[torch.Tensor] = None):
        """The real rows' advanced lengths (and token history) back into the
        slots."""
        idx = [i for i, r in enumerate(real) if r]
        rows_t, slots_t = self._ids(idx).long(), self._ids([slots[i] for i in idx]).long()
        self.cache.lengths[slots_t] = lengths[rows_t]
        if tokbuf is not None:
            self._tokbuf[slots_t] = tokbuf[rows_t]

    def step(self) -> list:
        """Admit, advance prefill chunks, then one decode chunk over the
        decoding slots (compact; the distributed engine: its group's rows)."""
        self._admit()
        self._advance_prefills()
        started, self._started_events = self._started_events, []
        active = [b for b, s in enumerate(self.slots) if s.decoding]
        self.stats["steps"] += 1
        if not active:
            return started
        n = self.chunk
        slots, real = self._decode_batch(active)
        self.stats["decode_chunks"] += 1
        sub = self._view(slots, real)
        sampling, sort_k = self._chunk_sampling(slots, real)
        if self.speculative_k and (self.speculative_sampled or all(
                self.slots[b].request.temperature == 0 for b in active)):
            return self._spec_step(started, active, slots, real, sub, sampling, sort_k, n)

        # one program per batch shape (JAX's jitted chunk), its page table and
        # lengths copied in from the view
        prog = PK.decode_paged_program(self.params, self.mc, sub, self.config.quant_type,
                                       self.dtype, self.rt, self._row_sampler(sampling, sort_k))
        prog.load(ids=self._ids([self._last_tok[b] for b in slots]), lengths=sub.lengths,
                  page_table=sub.page_table)
        self._load_rows(prog, sampling)
        toks = prog.run(n, self.params, sub.k_pool, sub.v_pool, collect=("ids",))["ids"]
        self._store_rows(slots, real, prog.inputs["lengths"])
        toks, at = self._fetch(toks.t()), self._fetch_rows(slots, real)  # (rows, n)
        out = started
        for b in active:
            prev_pending = int(self._last_tok[b])
            res = self._consume_slot_tokens(b, toks[at[b]], n)
            out.append(res)
            if self.speculative_k:
                # keep the token history in step for later speculative
                # chunks: the positions gained hold the previous pending token
                # and all but the last emitted one (the new pending token is
                # not placed yet)
                placed = [prev_pending] + res[1][:-1]
                l_after = int(self._host_lengths[b])
                SD._write_token_rows(self._tokbuf[b:b + 1], self._ids([placed]),
                                     self._ids([l_after - len(placed)]))
        return out

    def _spec_step(self, started, active, slots, real, sub, sampling, sort_k, n):
        """``n`` in-loop speculation steps over the chunk's rows; sampled
        rows (where any row samples) by rejection sampling, padding rows
        greedy."""
        extra = {}
        if sampling[3]:
            extra = dict(generator=self._gen, sampling=sampling[:3], top_k=sort_k)
        tb = self._tokbuf[self._ids(slots).long()]
        drafts, accepts, nexts, sub, tb = SD.speculative_decode_paged(
            self.params, self.mc, self._ids([self._last_tok[b] for b in slots]), sub, tb, n,
            self.speculative_k, self.speculative_ngram, self.config.quant_type, self.dtype,
            self.rt, **extra)
        self._store_rows(slots, real, sub.lengths, tb)
        # row-major for the fetch: (rows, n, k), (rows, n)
        drafts, accepts, nexts = map(self._fetch, (drafts.transpose(0, 1), accepts.t(),
                                                   nexts.t()))
        at = self._fetch_rows(slots, real)
        out = started
        for b in active:
            i, row = at[b], []
            for s in range(n):
                a = int(accepts[i, s])
                row += drafts[i, s, :a].tolist() + [int(nexts[i, s])]
                self.stats["spec_accepted"] += a
            out.append(self._consume_slot_tokens(b, row, len(row)))
        self.stats["spec_steps"] += n
        return out

    # -- page allocation -----------------------------------------------------

    def _pages_needed(self, req) -> int:
        n_ids = len(self._sliced_prompt(req))
        # + slack: in-chunk over-generation past the budget writes before the
        # host rolls it back, and must stay inside owned pages (a speculative
        # step advances up to k + 1 positions)
        slack = self.chunk * (self.speculative_k + 1 if self.speculative_k else 1)
        bucket = M.prompt_bucket(n_ids, self.max_seq_len)
        tokens = min(max(bucket, n_ids + req.max_new_tokens + slack), self.max_seq_len)
        return -(-tokens // self.page_size)

    def submit(self, prompt_ids: list, **kwargs) -> int:
        """Reject a request that can never fit the pool: it would wait at the
        head of the queue forever while ``has_work`` stayed True."""
        rid = super().submit(prompt_ids, **kwargs)
        need = self._pages_needed(self.queue[-1])
        per_phase = -(-need // self._n_phase)
        usable = self._sub_pages - 1  # one garbage page a sub-pool
        if per_phase > usable:
            self.queue.pop()
            raise ValueError(f"request needs {need} KV pages ({per_phase} a phase) but a "
                             f"sub-pool holds only {usable} usable pages: raise num_pages or "
                             "lower max_new_tokens / the prompt length")
        return rid

    def _admit(self):
        for slot_idx, slot in enumerate(self.slots):
            if slot.request is not None or not self.queue:
                continue
            if not self._try_admit(slot_idx, self.queue[0]):
                return  # backpressure: wait for finishes to free pages
            self.queue.pop(0)

    def _try_admit(self, slot_idx: int, req) -> bool:
        """Allocate pages and start ``req`` in ``slot_idx``; False (nothing
        changed) if the pool cannot supply them."""
        group = self._slot_group(slot_idx)
        ids = self._sliced_prompt(req)
        shared, shared_tokens = (self._match_prefix(ids, group) if self.prefix_cache
                                 else ([], 0))
        fresh_needed = self._pages_needed(req) - len(shared)
        # retain before _alloc: its eviction could free the pages just matched
        self._retain(shared)
        fresh = self._alloc(max(fresh_needed, 0), group, start_block=len(shared))
        if fresh is None:
            self._release(shared)
            if self.logger:
                self.logger.log("admit_wait", req_id=req.req_id, group=group,
                                pages_needed=fresh_needed,
                                pages_free=sum(len(f) for f in self._free[group]))
            return False
        pages = shared + fresh
        self._slot_pages[slot_idx] = pages
        row = self._garbage[slot_idx].copy()
        row[: len(pages)] = pages
        self.cache.page_table[slot_idx] = self._ids(row)
        if self.speculative_k:
            hist = np.zeros((self.max_seq_len,), np.int32)
            hist[: len(ids)] = ids
            self._tokbuf[slot_idx] = self._ids(hist)
        if shared_tokens:
            self.stats["prefix_hits"] += 1
            self.stats["prefix_tokens_reused"] += shared_tokens
            if self.logger:
                self.logger.log("prefix_hit", req_id=req.req_id, tokens=shared_tokens,
                                pages=len(shared))
        if self.prefill_chunk_size is not None:
            self._assign_chunked(slot_idx, req)
            # resume the prefill after the reused (page-aligned) prefix
            self.slots[slot_idx].pending_pos = shared_tokens
            self._host_lengths[slot_idx] = shared_tokens
            self.cache.lengths[slot_idx] = shared_tokens
        else:
            self._admit_into_slot(slot_idx, req)
        return True

    def _maybe_finish(self, slot_idx: int):
        super()._maybe_finish(slot_idx)
        if self.slots[slot_idx].request is None and self._slot_pages.get(slot_idx):
            self._release(self._slot_pages.pop(slot_idx))
            # reset the table row: a recycled page must not be written
            # through a stale mapping
            self.cache.page_table[slot_idx] = self._garbage_t[slot_idx]

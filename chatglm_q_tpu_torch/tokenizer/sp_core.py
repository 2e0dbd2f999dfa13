"""SentencePiece-compatible tokenizer core (pure Python reference engine).

A copy of chatglm_q_tpu/tokenizer/sp_core.py (the port imports nothing of
the JAX package).

Replaces the ``sentencepiece`` C++ runtime the reference wraps
(its chatglm_q/tokenizer.py:30): parses the same ``.model``
protobuf (sp_proto.py) and implements both encoding algorithms:

* **Unigram**: Viterbi best-path segmentation maximizing the sum of piece
  log-probs, with unknown-character fallback (unk penalty) and optional
  byte fallback to ``<0xXX>`` pieces.
* **BPE**: greedy highest-score merge of adjacent symbol pairs (the spm
  BPE convention: scores encode merge priority; ties break to the
  leftmost pair).

Normalization implements the spm pipeline: the model's precompiled
charsmap (darts-trie longest-prefix replacement, ``charsmap.py``) when
present, then whitespace escape to ``▁`` (U+2581), optional dummy prefix,
optional extra-whitespace collapsing.

A faster C++ implementation with the same semantics lives in
``native/sptok`` and is used automatically when its shared library is
built; this module is the oracle it is tested against.
"""
from __future__ import annotations

import heapq
from pathlib import Path
from typing import Iterable, Optional, Union

from .charsmap import PrecompiledCharsmap
from .sp_proto import (
    MODEL_BPE,
    MODEL_CHAR,
    MODEL_UNIGRAM,
    MODEL_WORD,
    PIECE_BYTE,
    PIECE_CONTROL,
    PIECE_NORMAL,
    PIECE_UNKNOWN,
    PIECE_UNUSED,
    PIECE_USER_DEFINED,
    SpModelProto,
    parse_model,
)

WS = "▁"  # ▁
_UNK_PENALTY = 10.0


class SpTokenizer:
    """Loaded SentencePiece model with encode/decode.

    API mirrors the subset of ``SentencePieceProcessor`` the reference uses
    (tokenizer.py:30-44): ``__len__``, ``encode``, ``decode``,
    ``piece_to_id``/``__getitem__``, ``bos_id``, ``eos_id``, ``unk_id``.
    """

    def __init__(self, model: Union[SpModelProto, bytes, str, Path], use_native: Optional[bool] = None):
        if isinstance(model, (str, Path)):
            model = Path(model).read_bytes()
        if isinstance(model, bytes):
            model = parse_model(model)
        self.proto = model
        # native C++ encode core (native/sptok) when built; None = auto
        self._native = None
        if use_native is not False:
            try:
                from .native import NativeEncoder, native_available

                if native_available():
                    self._native = NativeEncoder(model)
                elif use_native:
                    raise RuntimeError(
                        "native tokenizer core requested but not built "
                        "(make -C native/sptok)")
            except Exception:
                if use_native:
                    raise
        self.pieces = model.pieces
        self._charsmap = (
            PrecompiledCharsmap(model.precompiled_charsmap)
            if model.precompiled_charsmap else None
        )
        self._piece_to_id = {p.piece: i for i, p in enumerate(self.pieces)}
        self._scores = [p.score for p in self.pieces]
        self._byte_id = {}
        if model.byte_fallback:
            for i, p in enumerate(self.pieces):
                if p.type == PIECE_BYTE:
                    self._byte_id[int(p.piece[1:-1], 16)] = i
        # prefix trie as nested dicts {char: [id|None, children]}
        self._trie = {}
        for i, p in enumerate(self.pieces):
            if p.type in (PIECE_NORMAL, PIECE_USER_DEFINED):
                node = self._trie
                entry = None
                for ch in p.piece:
                    entry = node.setdefault(ch, [None, {}])
                    node = entry[1]
                if entry is not None:
                    entry[0] = i
        # BPE merge vocabulary: pieces raw text may match — NORMAL /
        # USER_DEFINED / UNUSED (intermediate merges); never CONTROL /
        # BYTE / UNKNOWN (text must not inject reserved ids)
        self._merge_id = {
            p.piece: i for i, p in enumerate(self.pieces)
            if p.type in (PIECE_NORMAL, PIECE_USER_DEFINED, PIECE_UNUSED)
        }
        # constant of the model: min SCORED piece score minus the unk
        # penalty (sentencepiece's min_score ranges over normal pieces —
        # control/byte pieces carry placeholder scores)
        scored = [p.score for p in self.pieces
                  if p.type in (PIECE_NORMAL, PIECE_USER_DEFINED)]
        self._unk_score = (min(scored) if scored else 0.0) - _UNK_PENALTY

    # -- identity ----------------------------------------------------------

    def __len__(self) -> int:
        return len(self.pieces)

    def bos_id(self) -> int:
        return self.proto.bos_id

    def eos_id(self) -> int:
        return self.proto.eos_id

    def unk_id(self) -> int:
        return self.proto.unk_id

    def pad_id(self) -> int:
        return self.proto.pad_id

    def piece_to_id(self, piece: str) -> int:
        return self._piece_to_id.get(piece, self.proto.unk_id)

    def id_to_piece(self, idx: int) -> str:
        return self.pieces[idx].piece

    def __getitem__(self, piece: str) -> int:
        return self.piece_to_id(piece)

    # -- normalization -----------------------------------------------------

    def normalize(self, text: str) -> str:
        m = self.proto
        if self._charsmap is not None:
            text = self._charsmap.normalize(text)
        if m.remove_extra_whitespaces:
            text = " ".join(s for s in text.split(" ") if s != "")
        if m.add_dummy_prefix and text:
            text = " " + text
        if m.escape_whitespaces:
            text = text.replace(" ", WS)
        return text

    # -- encoding ----------------------------------------------------------

    def encode(self, text: str) -> list[int]:
        text = self.normalize(text)
        if not text:
            return []
        if self._native is not None:
            return self._native.encode_normalized(text)
        if self.proto.model_type == MODEL_BPE:
            return self._encode_bpe(text)
        if self.proto.model_type in (MODEL_UNIGRAM, MODEL_WORD, MODEL_CHAR):
            return self._encode_unigram(text)
        raise NotImplementedError(f"model_type={self.proto.model_type}")

    def _char_fallback(self, ch: str) -> list[int]:
        if self.proto.byte_fallback and self._byte_id:
            return [self._byte_id[b] for b in ch.encode("utf-8")]
        return [self.proto.unk_id]

    def _encode_unigram(self, text: str) -> list[int]:
        """Viterbi over the piece lattice (max sum of scores)."""
        n = len(text)
        NEG = -1e18
        best = [NEG] * (n + 1)
        back: list[Optional[tuple[int, object]]] = [None] * (n + 1)
        best[0] = 0.0
        unk_score = self._unk_score
        for i in range(n):
            if best[i] == NEG:
                continue
            node = self._trie
            j = i
            matched = False
            while j < n:
                entry = node.get(text[j])
                if entry is None:
                    break
                j += 1
                pid, node = entry
                if pid is not None:
                    sc = best[i] + self._scores[pid]
                    if sc > best[j]:
                        best[j] = sc
                        back[j] = (i, pid)
                    if j - i == 1:
                        matched = True
            if not matched:
                # single-char fallback edge (unk or byte pieces)
                sc = best[i] + unk_score
                if sc > best[i + 1]:
                    best[i + 1] = sc
                    back[i + 1] = (i, ("fallback", text[i]))
        # backtrack
        out: list[int] = []
        pos = n
        while pos > 0:
            prev, tok = back[pos]
            if isinstance(tok, tuple):
                out.extend(reversed(self._char_fallback(tok[1])))
            else:
                out.append(tok)
            pos = prev
        out.reverse()
        return out

    def _encode_bpe(self, text: str) -> list[int]:
        """Greedy best-scoring merge of adjacent symbols (spm BPE).

        Only NORMAL / USER_DEFINED / UNUSED pieces participate in matching
        (``_merge_id``): raw text must never produce CONTROL/BYTE/UNKNOWN
        ids (sentencepiece semantics — otherwise user text containing e.g.
        "</s>" would inject the eos id).  A merged symbol whose piece is
        UNUSED resegments into its merge constituents via the recorded
        merge history, like sentencepiece's bpe_model resegmentation."""
        syms = list(text)
        n = len(syms)
        nxt = list(range(1, n + 1))
        prv = list(range(-1, n))
        alive = [True] * n
        # merge history: leaf = its character; node = (left, right, string)
        tree: list = [("leaf", ch, ch) for ch in syms]
        mid = self._merge_id

        def push(i: int):
            j = nxt[i]
            if j >= n:
                return
            merged = syms[i] + syms[j]
            pid = mid.get(merged)
            if pid is not None:
                heapq.heappush(heap, (-self._scores[pid], i, pid, merged))

        heap: list[tuple[float, int, int, str]] = []
        for i in range(n - 1):
            push(i)

        while heap:
            negscore, i, pid, merged = heapq.heappop(heap)
            if not alive[i] or nxt[i] >= n or not alive[nxt[i]]:
                continue
            if syms[i] + syms[nxt[i]] != merged:
                continue  # stale entry
            j = nxt[i]
            tree[i] = ("node", tree[i], tree[j], merged)
            syms[i] = merged
            alive[j] = False
            nxt[i] = nxt[j]
            if nxt[i] < n:
                prv[nxt[i]] = i
            push(i)
            if prv[i] >= 0:
                push(prv[i])

        out: list[int] = []

        def emit(t):
            s = t[3] if t[0] == "node" else t[1]
            pid = mid.get(s)
            if pid is not None and self.pieces[pid].type in (
                    PIECE_NORMAL, PIECE_USER_DEFINED):
                out.append(pid)
            elif t[0] == "node":  # UNUSED (or unemittable): resegment
                emit(t[1])
                emit(t[2])
            else:
                out.extend(self._char_fallback(s))

        i = 0
        while i < n:
            if alive[i]:
                emit(tree[i])
            i = nxt[i] if nxt[i] > i else i + 1
        return out

    # -- decoding ----------------------------------------------------------

    def decode(self, ids: Iterable[int]) -> str:
        chunks: list[bytes] = []
        for idx in ids:
            if not 0 <= idx < len(self.pieces):
                continue
            p = self.pieces[idx]
            if p.type == PIECE_BYTE:
                chunks.append(bytes([int(p.piece[1:-1], 16)]))
            elif p.type == PIECE_CONTROL:
                continue
            elif p.type == PIECE_UNKNOWN:
                chunks.append(" ⁇ ".encode("utf-8"))
            else:
                chunks.append(p.piece.encode("utf-8"))
        text = b"".join(chunks).decode("utf-8", errors="replace")
        text = text.replace(WS, " ")
        if self.proto.add_dummy_prefix and text.startswith(" "):
            text = text[1:]
        return text

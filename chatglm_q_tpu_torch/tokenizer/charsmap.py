"""Precompiled-charsmap normalization (sentencepiece ``NormalizerSpec``).

A copy of chatglm_q_tpu/tokenizer/charsmap.py.

SentencePiece models carry their text normalization (NFKC variants) as a
``precompiled_charsmap`` blob: a serialized darts-clone double-array trie
mapping UTF-8 source prefixes to replacement strings, followed by the
replacement-string pool.  This module implements

* parsing + longest-match prefix normalization (the runtime side the
  reference gets from the ``sentencepiece`` C++ library — behavioral spec:
  ``normalizer.cc Normalizer::Normalize/NormalizePrefix`` and
  ``DecodePrecompiledCharsMap``),
* a builder producing the same format from an arbitrary mapping (used by
  the model-building utilities and the tests; sentencepiece itself builds
  these offline from ICU data),
* an NFKC mapping derived from Python's ``unicodedata`` (single-codepoint
  approximation of spm's ``nfkc`` rule set — see ``nfkc_mapping``).

Blob layout (DecodePrecompiledCharsMap): ``uint32le trie_size`` then
``trie_size`` bytes of little-endian uint32 double-array units, then the
normalized-string pool of NUL-terminated UTF-8 strings; a trie hit's value
is a byte offset into that pool.

Double-array unit encoding (darts-clone ``DoubleArrayUnit``):
``has_leaf = (u >> 8) & 1``, ``value = u & 0x7fffffff`` (bit31 marks a
value unit), ``label = u & (0x80000000 | 0xff)``,
``offset = (u >> 10) << ((u & 0x200) >> 6)``.
"""
from __future__ import annotations

import struct
import sys
import unicodedata
from typing import Dict, Iterable, Optional, Tuple


def _unit_offset(u: int) -> int:
    return (u >> 10) << ((u & 0x200) >> 6)


class PrecompiledCharsmap:
    """Parsed charsmap blob with longest-prefix-match normalization."""

    def __init__(self, blob: bytes):
        if len(blob) < 4:
            raise ValueError("charsmap blob too short")
        (trie_size,) = struct.unpack("<I", blob[:4])
        if 4 + trie_size > len(blob) or trie_size % 4:
            raise ValueError("corrupt charsmap blob")
        trie = blob[4 : 4 + trie_size]
        self._units = list(struct.unpack(f"<{trie_size // 4}I", trie))
        self._pool = blob[4 + trie_size :]

    def _replacement(self, value: int) -> bytes:
        end = self._pool.index(b"\0", value)
        return self._pool[value:end]

    def longest_match(self, data: bytes, pos: int) -> Optional[Tuple[int, bytes]]:
        """Longest trie match starting at data[pos]; (consumed, replacement)."""
        units = self._units
        if not units:
            return None
        unit_pos = _unit_offset(units[0])
        best = None
        for i in range(pos, len(data)):
            unit_pos ^= data[i]
            if unit_pos >= len(units):
                break
            u = units[unit_pos]
            if (u & 0x800000FF) != data[i]:
                break
            unit_pos ^= _unit_offset(u)
            # NOTE: unit_pos here is the child's BASE, which may legally lie
            # past the array when only its base^label slots are materialized
            # — bounds-check only where it is actually read (the leaf value)
            if (u >> 8) & 1:  # has_leaf
                if unit_pos >= len(units):  # truncated/corrupt blob
                    break
                value = units[unit_pos] & 0x7FFFFFFF
                best = (i + 1 - pos, self._replacement(value))
        return best

    def normalize_bytes(self, data: bytes) -> bytes:
        """sentencepiece ``Normalize`` charsmap pass over raw UTF-8 bytes:
        repeated longest-prefix replacement; unmatched input is copied one
        UTF-8 character (or one invalid byte) at a time."""
        out = bytearray()
        pos = 0
        n = len(data)
        while pos < n:
            m = self.longest_match(data, pos)
            if m is not None:
                consumed, rep = m
                out += rep
                pos += consumed
                continue
            b0 = data[pos]
            step = 1 if b0 < 0x80 else 2 if b0 < 0xE0 else 3 if b0 < 0xF0 else 4
            step = min(step, n - pos)
            out += data[pos : pos + step]
            pos += step
        return bytes(out)

    def normalize(self, text: str) -> str:
        return self.normalize_bytes(text.encode("utf-8")).decode(
            "utf-8", errors="replace"
        )


# ---------------------------------------------------------------------------
# Builder
# ---------------------------------------------------------------------------

def _build_double_array(keys_values: Dict[bytes, int]) -> list[int]:
    """Darts-clone-compatible double array for the given byte-string keys.

    Not the space-optimal darts packing — but unit semantics are identical,
    so any conforming reader (including sentencepiece's) traverses it.
    """
    VAL = object()
    root: dict = {}
    for key, val in keys_values.items():
        if not key:
            raise ValueError("empty charsmap key")
        node = root
        for b in key:
            node = node.setdefault(b, {})
        node[VAL] = val

    units = [0]
    used = [True]  # pos 0 = root
    # every node's base must be UNIQUE, not merely its child slots: two
    # nodes sharing a base make traversal from one falsely descend into the
    # other's children (slot = base ^ label and the slot's own-label check
    # passes for both parents) — darts-clone reserves used offsets for the
    # same reason
    used_base: set[int] = set()

    def ensure(n: int) -> None:
        while len(units) <= n:
            units.append(0)
            used.append(False)

    hint = 1
    pending = [(0, 0, root)]  # (pos, own_label, node)
    while pending:
        pos, own_label, node = pending.pop()
        labels = sorted(k for k in node if k is not VAL)
        has_leaf = VAL in node
        slots = ([0] if has_leaf else []) + labels
        offset = hint
        while True:
            base = pos ^ offset
            cand = [base ^ c for c in slots]
            ensure(max(cand, default=0))
            if (base not in used_base
                    and all(not used[c] for c in cand)
                    and offset < (1 << 21)):
                break
            offset += 1
            if offset >= (1 << 21):
                raise ValueError("charsmap trie too large for direct offsets")
        base = pos ^ offset
        used_base.add(base)
        for c in cand:
            used[c] = True
        units[pos] = (offset << 10) | (int(has_leaf) << 8) | own_label
        if has_leaf:
            units[base] = (1 << 31) | node[VAL]
        for c in labels:
            child_pos = base ^ c
            units[child_pos] = c  # offset/leaf bits filled when processed
            pending.append((child_pos, c, node[c]))
    return units


def build_charsmap(mapping: Dict[str, str]) -> bytes:
    """Serialize a {source: replacement} mapping as a precompiled charsmap."""
    pool = bytearray()
    keys_values: Dict[bytes, int] = {}
    pool_index: Dict[bytes, int] = {}
    for src, dst in sorted(mapping.items()):
        rep = dst.encode("utf-8")
        if rep not in pool_index:
            pool_index[rep] = len(pool)
            pool += rep + b"\0"
        keys_values[src.encode("utf-8")] = pool_index[rep]
    units = _build_double_array(keys_values)
    trie = struct.pack(f"<{len(units)}I", *units)
    return struct.pack("<I", len(trie)) + trie + bytes(pool)


def nfkc_mapping(max_codepoint: int = sys.maxunicode) -> Dict[str, str]:
    """Single-codepoint NFKC replacement map from ``unicodedata``.

    Approximates sentencepiece's ``nfkc`` normalizer: spm's rule set is
    generated offline from ICU and additionally covers multi-codepoint
    sequences (e.g. combining-mark recompositions) that a per-codepoint
    table cannot express.  Sufficient for compatibility folds (full-width
    forms, ligatures, compatibility ideographs).
    """
    out: Dict[str, str] = {}
    for cp in range(0x20, max_codepoint + 1):
        if 0xD800 <= cp <= 0xDFFF:
            continue
        ch = chr(cp)
        norm = unicodedata.normalize("NFKC", ch)
        if norm != ch:
            out[ch] = norm
    return out

"""Build small SentencePiece-compatible model files (for tests/demos).

A copy of chatglm_q_tpu/tokenizer/build.py.

The reference's tokenizer tests require the real 6B model's 1 MB+
``sentencepiece.model`` on disk (tests/test_tokenizer.py:7-9); this package
additionally supports *constructing* small models so tokenizer behavior is
testable hermetically.
"""
from __future__ import annotations

from collections import Counter
from typing import Iterable

from .sp_proto import (
    MODEL_BPE,
    MODEL_UNIGRAM,
    PIECE_BYTE,
    PIECE_CONTROL,
    PIECE_UNKNOWN,
    SentencePieceEntry,
    SpModelProto,
    serialize_model,
)
from .sp_core import WS
from .charsmap import build_charsmap


def _base_pieces(byte_fallback: bool) -> list[SentencePieceEntry]:
    pieces = [
        SentencePieceEntry("<unk>", 0.0, PIECE_UNKNOWN),
        SentencePieceEntry("<s>", 0.0, PIECE_CONTROL),
        SentencePieceEntry("</s>", 0.0, PIECE_CONTROL),
    ]
    if byte_fallback:
        pieces += [
            SentencePieceEntry(f"<0x{b:02X}>", 0.0, PIECE_BYTE) for b in range(256)
        ]
    return pieces


def build_unigram_model(
    vocab: dict[str, float] | Iterable[str],
    byte_fallback: bool = True,
    add_dummy_prefix: bool = True,
    charsmap: dict[str, str] | None = None,
) -> bytes:
    """vocab: {piece: score} (or iterable of pieces scored by −index).
    ``charsmap``: optional {source: replacement} normalization mapping,
    serialized as a precompiled charsmap (charsmap.py)."""
    if not isinstance(vocab, dict):
        vocab = {p: -float(i) for i, p in enumerate(vocab)}
    pieces = _base_pieces(byte_fallback)
    for p, score in vocab.items():
        pieces.append(SentencePieceEntry(p, float(score)))
    m = SpModelProto(
        pieces=pieces,
        model_type=MODEL_UNIGRAM,
        byte_fallback=byte_fallback,
        unk_id=0, bos_id=1, eos_id=2, pad_id=-1,
        add_dummy_prefix=add_dummy_prefix,
    )
    if charsmap:
        m.normalizer_name = "custom"
        m.precompiled_charsmap = build_charsmap(charsmap)
    return serialize_model(m)


def build_bpe_model(
    merges: Iterable[str],
    alphabet: Iterable[str] = (),
    byte_fallback: bool = True,
    add_dummy_prefix: bool = True,
) -> bytes:
    """merges: pieces in merge-priority order (earliest = highest score)."""
    pieces = _base_pieces(byte_fallback)
    merges = list(merges)
    alphabet = list(alphabet)
    for i, ch in enumerate(alphabet):
        pieces.append(SentencePieceEntry(ch, -1000.0 - i))
    for rank, p in enumerate(merges):
        pieces.append(SentencePieceEntry(p, -float(rank)))
    m = SpModelProto(
        pieces=pieces,
        model_type=MODEL_BPE,
        byte_fallback=byte_fallback,
        unk_id=0, bos_id=1, eos_id=2, pad_id=-1,
        add_dummy_prefix=add_dummy_prefix,
    )
    return serialize_model(m)


def train_unigram_from_corpus(corpus: Iterable[str], vocab_size: int = 2000) -> bytes:
    """Toy 'trainer': word+substring frequency vocabulary (good enough for
    demo/calibration text; NOT the real unigram EM trainer)."""
    counts = Counter()
    for line in corpus:
        for word in line.split():
            token = WS + word
            counts[token] += 1
            for i in range(len(token)):
                for j in range(i + 1, min(i + 8, len(token)) + 1):
                    counts[token[i:j]] += 0.01
    most = [p for p, _ in counts.most_common(vocab_size) if p]
    vocab = {p: float(-i) for i, p in enumerate(most)}
    return build_unigram_model(vocab)

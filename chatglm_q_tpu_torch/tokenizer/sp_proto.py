"""Minimal protobuf wire-format codec for SentencePiece ``.model`` files.

A copy of chatglm_q_tpu/tokenizer/sp_proto.py.

The ``sentencepiece`` library is not a dependency of this package (the
reference depends on it, in its setup.py:24); instead this module
reads and writes the subset of the public ``sentencepiece_model.proto``
schema needed for tokenization:

  ModelProto:      pieces = 1 (repeated SentencePiece),
                   trainer_spec = 2, normalizer_spec = 3
  SentencePiece:   piece = 1 (string), score = 2 (float), type = 3 (enum)
                   type: NORMAL=1 UNKNOWN=2 CONTROL=3 USER_DEFINED=4
                         UNUSED=5 BYTE=6
  TrainerSpec:     model_type = 3 (UNIGRAM=1 BPE=2 WORD=3 CHAR=4),
                   byte_fallback = 35, unk_id = 40, bos_id = 41,
                   eos_id = 42, pad_id = 43
  NormalizerSpec:  name = 1, precompiled_charsmap = 2,
                   add_dummy_prefix = 3, remove_extra_whitespaces = 4,
                   escape_whitespaces = 5

Unknown fields are preserved opaquely on read and re-emitted on write, so a
model file loaded and re-saved through this codec keeps byte-compatible
metadata it does not interpret (e.g. the precompiled charsmap).
"""
from __future__ import annotations

import struct
from dataclasses import dataclass, field


# ---------------------------------------------------------------------------
# Wire primitives
# ---------------------------------------------------------------------------

def _read_varint(buf: bytes, pos: int) -> tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift > 63:
            raise ValueError("varint too long")


def _write_varint(out: bytearray, value: int) -> None:
    if value < 0:
        value &= (1 << 64) - 1
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            out.append(b | 0x80)
        else:
            out.append(b)
            return


def _iter_fields(buf: bytes):
    """Yield (field_number, wire_type, value, raw_bytes) over a message."""
    pos = 0
    n = len(buf)
    while pos < n:
        tag, pos = _read_varint(buf, pos)
        fnum, wtype = tag >> 3, tag & 7
        start = pos
        if wtype == 0:  # varint
            value, pos = _read_varint(buf, pos)
        elif wtype == 1:  # 64-bit
            value = buf[pos : pos + 8]
            pos += 8
        elif wtype == 2:  # length-delimited
            length, pos = _read_varint(buf, pos)
            value = buf[pos : pos + length]
            pos += length
        elif wtype == 5:  # 32-bit
            value = buf[pos : pos + 4]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wtype}")
        yield fnum, wtype, value


def _emit(out: bytearray, fnum: int, wtype: int, value) -> None:
    _write_varint(out, (fnum << 3) | wtype)
    if wtype == 0:
        _write_varint(out, value)
    elif wtype in (1, 5):
        out.extend(value)
    elif wtype == 2:
        _write_varint(out, len(value))
        out.extend(value)
    else:
        raise ValueError(wtype)


# ---------------------------------------------------------------------------
# Schema subset
# ---------------------------------------------------------------------------

PIECE_NORMAL = 1
PIECE_UNKNOWN = 2
PIECE_CONTROL = 3
PIECE_USER_DEFINED = 4
PIECE_UNUSED = 5
PIECE_BYTE = 6

MODEL_UNIGRAM = 1
MODEL_BPE = 2
MODEL_WORD = 3
MODEL_CHAR = 4


@dataclass
class SentencePieceEntry:
    piece: str = ""
    score: float = 0.0
    type: int = PIECE_NORMAL


@dataclass
class SpModelProto:
    pieces: list = field(default_factory=list)  # list[SentencePieceEntry]
    model_type: int = MODEL_UNIGRAM
    byte_fallback: bool = False
    unk_id: int = 0
    bos_id: int = 1
    eos_id: int = 2
    pad_id: int = -1
    add_dummy_prefix: bool = True
    remove_extra_whitespaces: bool = True
    escape_whitespaces: bool = True
    normalizer_name: str = ""
    precompiled_charsmap: bytes = b""  # darts trie + replacement blob
    # opaque unparsed fields, re-emitted on serialize
    _unknown_model: list = field(default_factory=list)
    _unknown_trainer: list = field(default_factory=list)
    _unknown_normalizer: list = field(default_factory=list)


def _parse_piece(buf: bytes) -> SentencePieceEntry:
    p = SentencePieceEntry()
    for fnum, wtype, value in _iter_fields(buf):
        if fnum == 1 and wtype == 2:
            p.piece = value.decode("utf-8")
        elif fnum == 2 and wtype == 5:
            p.score = struct.unpack("<f", value)[0]
        elif fnum == 3 and wtype == 0:
            p.type = value
    return p


def _serialize_piece(p: SentencePieceEntry) -> bytes:
    out = bytearray()
    _emit(out, 1, 2, p.piece.encode("utf-8"))
    _emit(out, 2, 5, struct.pack("<f", p.score))
    if p.type != PIECE_NORMAL:
        _emit(out, 3, 0, p.type)
    return bytes(out)


def _zigzag_int(v: int) -> int:
    """Decode a negative-capable int32 stored as plain varint.

    protoc sign-extends negative int32 to 10 bytes (64-bit two's complement),
    so reduce modulo 2^64 first; a 32-bit-truncated encoding (5 bytes) then
    still needs the 2^32 wrap.  Both forms decode to the same int32.
    """
    if v >= 1 << 63:
        v -= 1 << 64
    elif v >= 1 << 31:
        v -= 1 << 32
    return v


def parse_model(data: bytes) -> SpModelProto:
    m = SpModelProto()
    m.add_dummy_prefix = True
    for fnum, wtype, value in _iter_fields(data):
        if fnum == 1 and wtype == 2:
            m.pieces.append(_parse_piece(value))
        elif fnum == 2 and wtype == 2:  # TrainerSpec
            for tf, tw, tv in _iter_fields(value):
                if tf == 3 and tw == 0:
                    m.model_type = tv
                elif tf == 35 and tw == 0:
                    m.byte_fallback = bool(tv)
                elif tf == 40 and tw == 0:
                    m.unk_id = _zigzag_int(tv)
                elif tf == 41 and tw == 0:
                    m.bos_id = _zigzag_int(tv)
                elif tf == 42 and tw == 0:
                    m.eos_id = _zigzag_int(tv)
                elif tf == 43 and tw == 0:
                    m.pad_id = _zigzag_int(tv)
                else:
                    m._unknown_trainer.append((tf, tw, tv))
        elif fnum == 3 and wtype == 2:  # NormalizerSpec
            for nf, nw, nv in _iter_fields(value):
                if nf == 1 and nw == 2:
                    m.normalizer_name = nv.decode("utf-8")
                elif nf == 2 and nw == 2:
                    m.precompiled_charsmap = bytes(nv)
                elif nf == 3 and nw == 0:
                    m.add_dummy_prefix = bool(nv)
                elif nf == 4 and nw == 0:
                    m.remove_extra_whitespaces = bool(nv)
                elif nf == 5 and nw == 0:
                    m.escape_whitespaces = bool(nv)
                else:
                    m._unknown_normalizer.append((nf, nw, nv))
        else:
            m._unknown_model.append((fnum, wtype, value))
    return m


def serialize_model(m: SpModelProto) -> bytes:
    out = bytearray()
    for p in m.pieces:
        _emit(out, 1, 2, _serialize_piece(p))

    trainer = bytearray()
    _emit(trainer, 3, 0, m.model_type)
    if m.byte_fallback:
        _emit(trainer, 35, 0, 1)
    for fid, v in ((40, m.unk_id), (41, m.bos_id), (42, m.eos_id), (43, m.pad_id)):
        _emit(trainer, fid, 0, v)  # _write_varint sign-extends to 64-bit
    for tf, tw, tv in m._unknown_trainer:
        _emit(trainer, tf, tw, tv)
    _emit(out, 2, 2, bytes(trainer))

    norm = bytearray()
    if m.normalizer_name:
        _emit(norm, 1, 2, m.normalizer_name.encode("utf-8"))
    if m.precompiled_charsmap:
        _emit(norm, 2, 2, m.precompiled_charsmap)
    _emit(norm, 3, 0, int(m.add_dummy_prefix))
    _emit(norm, 4, 0, int(m.remove_extra_whitespaces))
    _emit(norm, 5, 0, int(m.escape_whitespaces))
    for nf, nw, nv in m._unknown_normalizer:
        _emit(norm, nf, nw, nv)
    _emit(out, 3, 2, bytes(norm))

    for fnum, wtype, value in m._unknown_model:
        _emit(out, fnum, wtype, value)
    return bytes(out)

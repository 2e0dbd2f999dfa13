"""ctypes binding for the native sptok tokenizer core (native/sptok).

A copy of chatglm_q_tpu/tokenizer/native.py.

Loads ``libsptok.so`` when available (build: ``make -C native/sptok``) and
exposes :class:`NativeEncoder` with the same encode semantics as the pure
Python :class:`~.sp_core.SpTokenizer` — which remains the oracle and
fallback.  Normalization and decoding stay in Python (cold paths).
"""
from __future__ import annotations

import ctypes
import os
from pathlib import Path
from typing import Optional

import numpy as np

_LIB_CANDIDATES = [
    Path(__file__).resolve().parents[2] / "native" / "sptok" / "libsptok.so",
    Path(os.environ.get("SPTOK_LIB", "")),
]

_lib = None


def _load_lib():
    global _lib
    if _lib is not None:
        return _lib
    for cand in _LIB_CANDIDATES:
        if cand and cand.is_file():
            lib = ctypes.CDLL(str(cand))
            lib.sptok_create.restype = ctypes.c_void_p
            lib.sptok_create.argtypes = [
                ctypes.c_char_p,
                ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_float),
                ctypes.POINTER(ctypes.c_int32),
                ctypes.c_int32,
                ctypes.c_int32,
                ctypes.c_int32,
            ]
            lib.sptok_destroy.argtypes = [ctypes.c_void_p]
            lib.sptok_encode.restype = ctypes.c_int32
            lib.sptok_encode.argtypes = [
                ctypes.c_void_p,
                ctypes.c_char_p,
                ctypes.c_int32,
                ctypes.POINTER(ctypes.c_int32),
                ctypes.c_int32,
            ]
            _lib = lib
            return lib
    return None


def native_available() -> bool:
    return _load_lib() is not None


class NativeEncoder:
    """Native encode core for a parsed SpModelProto."""

    def __init__(self, proto):
        lib = _load_lib()
        if lib is None:
            raise RuntimeError("libsptok.so not built (make -C native/sptok)")
        self._lib = lib
        blob = b"".join(p.piece.encode("utf-8") for p in proto.pieces)
        lens = np.asarray(
            [len(p.piece.encode("utf-8")) for p in proto.pieces], np.int32
        )
        scores = np.asarray([p.score for p in proto.pieces], np.float32)
        types = np.asarray([p.type for p in proto.pieces], np.int32)
        self._handle = lib.sptok_create(
            blob,
            lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            scores.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            types.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            len(proto.pieces),
            proto.model_type,
            proto.unk_id,
        )
        # keep arrays alive for the duration of create (copied inside C++)
        del blob, lens, scores, types

    def __del__(self):
        if getattr(self, "_handle", None) and self._lib:
            self._lib.sptok_destroy(self._handle)
            self._handle = None

    def encode_normalized(self, text: str) -> list[int]:
        """Encode already-normalized text (see SpTokenizer.normalize)."""
        raw = text.encode("utf-8")
        cap = max(64, len(raw) * 2)
        while True:
            out = np.empty(cap, np.int32)
            n = self._lib.sptok_encode(
                self._handle, raw, len(raw),
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), cap,
            )
            if n >= 0:
                return out[:n].tolist()
            cap = -n

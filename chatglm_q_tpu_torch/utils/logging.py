"""Structured logging: human-readable lines on stderr and optional JSONL.

A copy of chatglm_q_tpu/utils/logging.py (stdlib only).  The JAX package's
logger writes on host 0 only, asking ``jax.process_index()``; the port runs
one process, so every call logs.
"""
from __future__ import annotations

import json
import sys
import time
from pathlib import Path
from typing import Optional


class StructuredLogger:
    def __init__(self, name: str, jsonl_path: Optional[str] = None, quiet: bool = False):
        self.name = name
        self.quiet = quiet
        self._jsonl = Path(jsonl_path).open("a") if jsonl_path else None
        self._t0 = time.time()

    def log(self, event: str, **fields):
        rec = {"t": round(time.time() - self._t0, 3), "event": event, **fields}
        if not self.quiet:
            kv = " ".join(f"{k}={v}" for k, v in fields.items())
            print(f"[{self.name} {rec['t']:9.3f}s] {event} {kv}", file=sys.stderr, flush=True)
        if self._jsonl:
            self._jsonl.write(json.dumps(rec) + "\n")
            self._jsonl.flush()

    def metric(self, name: str, value: float, unit: str = "", **fields):
        self.log("metric", metric=name, value=value, unit=unit, **fields)

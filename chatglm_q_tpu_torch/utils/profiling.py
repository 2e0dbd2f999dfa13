"""Profiling helpers: the counterpart of chatglm_q_tpu/utils/profiling.py.

The reference's only observability is the decoder's ``time_log`` wall-clock
report (serving/decoder.py keeps it); ``DecodeStats`` is the same
accumulator.  ``trace`` records a block with ``torch.profiler`` (host
activity, and the card's kernels where CUDA is present) and writes a Chrome
trace, where JAX writes an XLA profile for TensorBoard.
"""
from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass, field


@contextlib.contextmanager
def trace(log_dir: str):
    """Record the block with ``torch.profiler`` and write its Chrome trace
    to ``<log_dir>/trace.json`` (open it in chrome://tracing or Perfetto).
    Yields the profiler (``key_averages()`` and the rest)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


@dataclass
class DecodeStats:
    """tok/s accumulator matching the reference time_log semantics."""

    step_times: list = field(default_factory=list)
    _t0: float = 0.0

    def start(self):
        self._t0 = time.perf_counter()

    def lap(self):
        now = time.perf_counter()
        self.step_times.append(now - self._t0)
        self._t0 = now

    @property
    def prefill_latency(self) -> float:
        return self.step_times[0] if self.step_times else 0.0

    @property
    def decode_tps(self) -> float:
        rest = self.step_times[1:]
        return len(rest) / sum(rest) if rest else 0.0

    @property
    def avg_tps(self) -> float:
        return (
            len(self.step_times) / sum(self.step_times) if self.step_times else 0.0
        )

    def report(self, prefix_len: int, gen_len: int) -> str:
        return (
            f"Decoder:\n  len: {prefix_len}(prefix) + {gen_len}(gen)\n"
            f" init: {self.prefill_latency:.6f} s\n"
            f"  sum: {sum(self.step_times):.6f} s\n"
            f"  gen: {self.decode_tps:.6f} tok/s\n"
            f"  avg: {self.avg_tps:.6f} tok/s"
        )

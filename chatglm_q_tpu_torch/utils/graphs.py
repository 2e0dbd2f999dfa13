"""Step programs: the port's counterpart of the JAX package's jitted decode
programs (``multi_step_decode``'s ``lax.scan``, ``GLMDecoder``'s ``_decode``
and ``_verify``, the engines' decode and speculation chunks), as CUDA graphs.

A step program is one step of a decode loop over static buffers:

* static inputs, owned by the program: the step's ids, lengths, page table,
  per-row sampling settings, token history;
* a body: ``decode_step`` / ``decode_step_paged`` and the sampler, a
  speculative verify, or an in-loop speculation step.  It reads the static
  inputs and writes its results back into them in place (the sampled token
  becomes the next step's ids, the lengths advance), so n steps are n
  replays with nothing copied in between;
* outputs: whatever the body returns (the static outputs of the graph).

The big tensors a body touches (params, the KV cache or page pool) are
passed on each call, never held: a program is keyed by the addresses and
shapes of the cache's tensors (``tensor_key``) and by what JAX would take as
static arguments (batch, cache shape, quant mode, runtime flags, the
sampler), in the registry of the params it was made for: ``programs(params)``
is keyed by every leaf of the tree (``params_key``), so a call with other
tensors, or a tree that differs in any one weight, finds another program.
A registry's programs share one graph memory pool, and at most
``MAX_PROGRAMS`` are kept (least recently used first out).  Under that
shared pool a program's outputs are valid only until the next replay of
any program of the registry: read (or copy) them before that.

On CUDA a program runs its first step eagerly (the warm-up: every kernel
built and loaded, every scratch buffer and table sized), captures the body
on its second call and replays from then on.  A capture that fails raises
``CaptureError``: the step never falls back to eager launches.  The kernel
wrappers count launches in Python, which a replay does not run: the counts
a capture made are added back on every replay.  On a CPU tensor, and where
``TorchRuntimeConfig.cuda_graphs`` is False or capture is refused (a mesh,
the masked-softmax path), the body runs eagerly through the same buffers.
"""
from __future__ import annotations

import collections
import dataclasses
import warnings
import weakref
from typing import Callable, Optional

import torch

from .. import ops

MAX_PROGRAMS = 32
MESH_REFUSAL = ("a mesh decodes eagerly: gloo collectives cannot be captured in a CUDA graph, "
                "and the sharded KV writes sync on nonzero")
MASKED_REFUSAL = ("the masked-softmax path (use_flash_attention=False) decodes eagerly: it is "
                  "not the kernel path, and it copies a host scalar each step")


class CaptureError(RuntimeError):
    """A step program's capture failed; the step did not run."""


def refusal(rt, device) -> Optional[str]:
    """Why capture is refused for ``rt`` on a CUDA ``device``, or None."""
    if rt.mesh is not None:
        return MESH_REFUSAL
    if not rt.flash_enabled(device):
        return MASKED_REFUSAL
    return None


_SAID: set = set()


def capture_enabled(rt, device) -> bool:
    """Whether programs on ``device`` capture under ``rt``: on CUDA unless
    ``rt.cuda_graphs`` is False or capture is refused, which is said once
    (a warning)."""
    device = torch.device(device)
    if device.type != "cuda" or not rt.cuda_graphs:
        return False
    reason = refusal(rt, device)
    if reason is None:
        return True
    if reason not in _SAID:
        _SAID.add(reason)
        warnings.warn(reason, RuntimeWarning, stacklevel=3)
    return False


def tensor_key(t: torch.Tensor) -> tuple:
    """What a graph bakes in of a tensor it does not own."""
    return (t.data_ptr(), tuple(t.shape), t.stride(), t.dtype, str(t.device))


def static_key(config, quant_type, dtype, rt) -> tuple:
    """The static arguments every decode program shares."""
    return (dataclasses.astuple(config), quant_type, dtype,
            dataclasses.replace(rt, mesh=None), id(rt.mesh))


class StepProgram:
    """One step of a decode loop over static buffers (see the module note).

    ``inputs``: name → static tensor; ``body(inputs, *args)`` runs one step
    and returns its outputs (name → tensor); ``args`` are the big tensors,
    passed on every call.  ``capture``: capture on the second call (CUDA).
    ``generator``: the generator the sampler draws from, registered with
    the graph so that every replay draws anew.  ``outputs`` live in the
    registry's shared graph pool: they hold until the next replay of any
    program of the registry, when another graph's temporaries may reuse
    their memory."""

    def __init__(self, name: str, body: Callable, inputs: dict, capture: bool,
                 registry: "Programs", generator: Optional[torch.Generator] = None):
        self.name = name
        self.body = body
        self.inputs = inputs
        self.capture = capture
        self.generator = generator
        self._registry = registry
        self.outputs: dict = {}
        self.graph = None
        self.calls = 0
        self.replays = 0
        self.launch_delta: dict = {}

    def load(self, **tensors) -> None:
        """Copy values into static inputs (a buffer passed as itself stays)."""
        for name, t in tensors.items():
            buf = self.inputs[name]
            if t is not buf:
                buf.copy_(t)

    def step(self, *args) -> dict:
        """One step: eager (the first call, or a program that does not
        capture), the capture and its first replay, or a replay."""
        if self.graph is None and self.capture and self.calls > 0:
            self._capture(args)
        if self.graph is not None:
            self.graph.replay()
            self.replays += 1
            ops.add_launch_counts(self.launch_delta)
        else:
            self.outputs = self.body(self.inputs, *args)
        self.calls += 1
        return self.outputs

    def run(self, n: int, *args, collect=()) -> dict:
        """``n`` steps; returns, for each name in ``collect`` (an output or a
        static input), its value after every step, stacked (n, ...)."""
        out = {}
        for i in range(n):
            res = self.step(*args)
            for name in collect:
                t = res[name] if name in res else self.inputs[name]
                if i == 0:
                    out[name] = torch.empty((n, *t.shape), dtype=t.dtype, device=t.device)
                out[name][i].copy_(t)
        return out

    def _capture(self, args) -> None:
        before = ops.launch_counts()
        graph = torch.cuda.CUDAGraph()
        if self.generator is not None:
            graph.register_generator_state(self.generator)
        try:
            with torch.cuda.graph(graph, pool=self._registry.pool(),
                                  capture_error_mode="thread_local"):
                outputs = self.body(self.inputs, *args)
        except Exception as e:
            raise CaptureError(
                f"{self.name}: CUDA-graph capture failed ({type(e).__name__}: {e}); the step "
                "did not run.  TorchRuntimeConfig(cuda_graphs=False) decodes eagerly") from e
        finally:
            after = ops.launch_counts()
            ops.set_launch_counts(before)  # the capture launched nothing
        self.launch_delta = {k: n - before[k] for k, n in after.items() if n != before[k]}
        self.graph, self.outputs = graph, outputs
        self._registry.captures += 1


class Programs:
    """A model's step programs by key, sharing one graph memory pool."""

    def __init__(self, limit: int = MAX_PROGRAMS):
        self.limit = limit
        self.captures = 0
        self._programs: collections.OrderedDict = collections.OrderedDict()
        self._pool = None

    def __len__(self) -> int:
        return len(self._programs)

    def pool(self):
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        return self._pool

    def get(self, key: tuple, name: str, make_inputs: Callable[[], dict], body: Callable,
            device, rt, generator: Optional[torch.Generator] = None) -> StepProgram:
        """The program of ``key``, built on first use (``make_inputs()`` its
        static inputs; ``body`` as ``StepProgram`` takes it)."""
        prog = self._programs.get(key)
        if prog is not None:
            self._programs.move_to_end(key)
            return prog
        prog = StepProgram(name, body, make_inputs(), capture_enabled(rt, device), self,
                           generator)
        self._programs[key] = prog
        while len(self._programs) > self.limit:
            self._programs.popitem(last=False)
        return prog


_REGISTRIES: dict = {}


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)


def params_key(params: dict) -> tuple:
    """Every weight a graph over ``params`` bakes in, by ``tensor_key``."""
    return tuple(tensor_key(t) for t in _leaves(params))


def programs(params: dict) -> Programs:
    """The registry of the tree ``params``, keyed by all its leaves: two
    trees that differ in any leaf have registries of their own.  It is
    dropped when any of its leaves is freed (a program never holds the
    params)."""
    key = params_key(params)
    reg = _REGISTRIES.get(key)
    if reg is None:
        reg = _REGISTRIES[key] = Programs()
        for leaf in _leaves(params):
            weakref.finalize(leaf, _REGISTRIES.pop, key, None)
    return reg

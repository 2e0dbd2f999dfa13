"""Step programs: the port's counterpart of the JAX package's jitted decode
programs (``multi_step_decode``'s ``lax.scan``, ``GLMDecoder``'s ``_decode``
and ``_verify``, the engines' decode and speculation chunks), as CUDA graphs.

A step program is one step of a decode loop, or one prefill, prefill
chunk or training step, over static buffers:

* static inputs, owned by the program: the step's ids, lengths, page table,
  per-row sampling settings, token history;
* a body: ``decode_step`` / ``decode_step_paged`` and the sampler, a
  speculative verify, an in-loop speculation step, a prefill of one
  (batch, bucket) shape (JAX's jitted prefill per power-of-two bucket), a
  compact prefill chunk of one (rows, chunk) shape, or a whole training
  step (forward, backward, the optimizer's step).  It reads the static
  inputs and writes its results back into them in place (the sampled token
  becomes the next step's ids, the lengths advance), so n steps are n
  replays with nothing copied in between;
* outputs: whatever the body returns (the static outputs of the graph).

The big tensors a body touches (params, the KV cache or page pool) are
passed on each call, never held: a program is keyed by the addresses and
shapes of the cache's tensors (``tensor_key``) and by what JAX would take as
static arguments (batch, cache shape, quant mode, runtime flags, the
sampler), in the registry of the params it was made for: ``programs(params,
family)`` is keyed by every leaf of the tree (``params_key``), so a call
with other tensors, or a tree that differs in any one weight, finds another
program.  A tree's programs share one graph memory pool, and each family
(decode, prefill, train) keeps at most ``MAX_PROGRAMS`` (least recently
used first out).  Under that shared pool a program's outputs are valid only
until the next replay of any program of the tree: read (or copy) them
before that.

On CUDA a program runs its first step eagerly (the warm-up: every kernel
built and loaded, every scratch buffer and table sized), captures the body
on its second call and replays from then on.  A capture that fails raises
``CaptureError``: the step never falls back to eager launches.  The kernel
wrappers count launches in Python, which a replay does not run: the counts
a capture made are added back on every replay.  On a CPU tensor, and where
``TorchRuntimeConfig.cuda_graphs`` is False or capture is refused (a gloo
mesh, the masked-softmax path, a training step with dropout or on a mesh),
the body runs eagerly through the same buffers (and so does a training
step over an optimizer that is not capturable).  A training step's
capture bakes in its optimizer's float hyperparameters and state tensors:
where they change (a float lr under a scheduler, ``load_state_dict``), the
step is captured again before it replays.  An NCCL mesh captures: NCCL's
collectives are captured into the graph, and every rank of a model group
takes the same programs in the same order, so the ranks capture together.
"""
from __future__ import annotations

import collections
import dataclasses
import gc
import warnings
import weakref
from typing import Callable, Optional

import torch

from .. import ops

MAX_PROGRAMS = 32
MESH_REFUSAL = ("a gloo mesh runs its programs eagerly: gloo collectives cannot be captured "
                "in a CUDA graph")
MASKED_REFUSAL = ("the masked-softmax path (use_flash_attention=False) decodes eagerly: it is "
                  "not the kernel path, and it copies a host scalar each step")
DROPOUT_REFUSAL = ("a training step with dropout runs eagerly: the forward draws one seed a "
                   "layer and reads them on the host (.tolist()), which a capture cannot hold")
OPTIMIZER_REFUSAL = ("a training step over a non-capturable optimizer runs eagerly: build it "
                     "with capturable=True (e.g. torch.optim.AdamW(..., capturable=True)) so "
                     "that its step count stays on the device")
MESH_PREFILL_REFUSAL = ("under a mesh the prefill and chunk programs run eagerly: only the "
                        "decode chunks are captured over NCCL, and the ring prefill's "
                        "point-to-point exchanges are not")
MESH_TRAIN_REFUSAL = ("under a mesh the training step runs eagerly: only the decode chunks are "
                      "captured over NCCL, not the gradients' all-reduces")
RECAPTURE_NOTE = ("a captured training step's optimizer changed (a hyperparameter that is not a "
                  "tensor, such as a float lr under a scheduler, or its state tensors after "
                  "load_state_dict): the step is captured again at each change.  To change lr "
                  "inside one graph, pass it as a tensor (torch.optim.AdamW(..., "
                  "lr=torch.tensor(1e-3, device='cuda'), capturable=True))")


class CaptureError(RuntimeError):
    """A step program's capture failed; the step did not run."""


def refusal(rt, device) -> Optional[str]:
    """Why capture is refused for ``rt`` on a CUDA ``device``, or None.  A
    mesh is refused by its transport: gloo's collectives stage through
    host memory, NCCL's are captured."""
    if rt.mesh is not None and rt.mesh.backend != "nccl":
        return MESH_REFUSAL
    if not rt.flash_enabled(device):
        return MASKED_REFUSAL
    return None


def mesh_prefill_refusal(rt) -> Optional[str]:
    """The prefill and chunk programs' own refusal: under a mesh they run
    eagerly (the decode programs alone capture over NCCL)."""
    return None if rt.mesh is None else MESH_PREFILL_REFUSAL


_SAID: set = set()


def say_once(reason: str) -> None:
    """Warn ``reason`` the first time it is given."""
    if reason not in _SAID:
        _SAID.add(reason)
        warnings.warn(reason, RuntimeWarning, stacklevel=3)


def capture_enabled(rt, device, reason: Optional[str] = None) -> bool:
    """Whether programs on ``device`` capture under ``rt``: on CUDA unless
    ``rt.cuda_graphs`` is False or capture is refused (``refusal``, or the
    caller's own ``reason``), which is said once (a warning)."""
    device = torch.device(device)
    if device.type != "cuda" or not rt.cuda_graphs:
        return False
    reason = reason or refusal(rt, device)
    if reason is None:
        return True
    say_once(reason)
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
    their memory.  ``capture_mode``: ``torch.cuda.graph``'s
    ``capture_error_mode`` ("global" where the body's backward runs on
    autograd's device threads).  ``guard``: what else the capture bakes in
    (a training step's optimizer settings and state tensors); where it reads
    otherwise before a replay, the body is captured again (``RECAPTURE_NOTE``,
    said once)."""

    def __init__(self, name: str, body: Callable, inputs: dict, capture: bool,
                 registry: "Programs", generator: Optional[torch.Generator] = None,
                 capture_mode: str = "thread_local", guard: Optional[Callable[[], tuple]] = None):
        self.name = name
        self.capture_mode = capture_mode
        self.guard = guard
        self.guarded = None
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
        if self.graph is not None and self.guard is not None and self.guard() != self.guarded:
            say_once(RECAPTURE_NOTE)
            # captured again over what the guard reads now, before the old
            # graph goes: a pool whose last graph is freed takes no capture
            self._capture(args)
        elif self.graph is None and self.capture and self.calls > 0:
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
        self.guarded = None if self.guard is None else self.guard()
        graph = torch.cuda.CUDAGraph()
        if self.generator is not None:
            graph.register_generator_state(self.generator)
        # A collection inside the capture may free a dead cycle that holds
        # another graph (or a tree whose registry does): a graph freed while a
        # stream captures invalidates the capture (seen on an H100 in the
        # global mode of a training step).  So collect now, and keep the
        # collector off until the capture ends.
        gc.collect()
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, pool=self._registry.pool(),
                                  capture_error_mode=self.capture_mode):
                outputs = self.body(self.inputs, *args)
        except Exception as e:
            raise CaptureError(
                f"{self.name}: CUDA-graph capture failed ({type(e).__name__}: {e}); the step "
                "did not run.  TorchRuntimeConfig(cuda_graphs=False) decodes eagerly") from e
        finally:
            if collecting:
                gc.enable()
            after = ops.launch_counts()
            ops.set_launch_counts(before)  # the capture launched nothing
        self.launch_delta = {k: n - before[k] for k, n in after.items() if n != before[k]}
        self.graph, self.outputs = graph, outputs
        self._registry.captures += 1


class Programs:
    """A model's step programs of one family by key, sharing one graph
    memory pool with the model's other families (``shares``)."""

    def __init__(self, limit: int = MAX_PROGRAMS, shares: Optional["Programs"] = None):
        self.limit = limit
        self.captures = 0
        self._programs: collections.OrderedDict = collections.OrderedDict()
        self._pool = None
        self._shares = shares

    def __len__(self) -> int:
        return len(self._programs)

    def pool(self):
        if self._shares is not None:
            return self._shares.pool()
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        return self._pool

    def get(self, key: tuple, name: str, make_inputs: Callable[[], dict], body: Callable,
            device, rt, generator: Optional[torch.Generator] = None,
            refused: Optional[str] = None, capture_mode: str = "thread_local",
            guard: Optional[Callable[[], tuple]] = None) -> StepProgram:
        """The program of ``key``, built on first use (``make_inputs()`` its
        static inputs; ``body``, ``capture_mode`` and ``guard`` as
        ``StepProgram`` takes them).  ``refused``: the caller's own reason to
        run this program eagerly."""
        prog = self._programs.get(key)
        if prog is not None:
            self._programs.move_to_end(key)
            return prog
        prog = StepProgram(name, body, make_inputs(), capture_enabled(rt, device, refused),
                           self, generator, capture_mode, guard)
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


FAMILIES = ("decode", "prefill", "train")


def programs(params: dict, family: str = "decode") -> Programs:
    """The registry of the tree ``params`` for one program ``family``
    (FAMILIES: the decode-loop programs, the prefill and chunk programs,
    the training step), keyed by all the tree's leaves: two trees that
    differ in any leaf have registries of their own.  A family keeps its own
    ``MAX_PROGRAMS`` (a prefill of a new bucket never evicts a decode
    program); the families of a tree share one graph pool.  Dropped when any
    leaf of the tree is freed (a program never holds the params)."""
    if family not in FAMILIES:
        raise ValueError(f"program family {family!r}: one of {FAMILIES}")
    key = params_key(params)
    regs = _REGISTRIES.get(key)
    if regs is None:
        regs = _REGISTRIES[key] = {}
        for leaf in _leaves(params):
            weakref.finalize(leaf, _REGISTRIES.pop, key, None)
    reg = regs.get(family)
    if reg is None:
        reg = regs[family] = Programs(shares=next(iter(regs.values()), None))
    return reg

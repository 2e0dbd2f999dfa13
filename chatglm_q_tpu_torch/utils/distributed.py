"""The process runtime of tensor-parallel serving, on ``torch.distributed``.

The counterpart of chatglm_q_tpu/utils/distributed.py.  JAX runs one
global program and its compiler inserts the collectives; the port is
explicit SPMD: one process per rank, each holding its shard, and every
collective an explicit call to the functions below (the one place the port
talks to ``torch.distributed``).

* ``initialize``, ``is_primary``, ``primary_only``, ``local_batch_slice``:
  as in the JAX package, over the default process group;
* ``all_reduce`` (sum, max), ``all_gather``, ``broadcast``, ``ring_shift``
  within a process group, and ``send`` / ``recv`` between two ranks.  With
  ``host=True`` a CUDA tensor goes through a pinned host buffer and back:
  the gloo backend's path, for ranks that share one card (NCCL refuses two
  ranks on one GPU) and for CPU runs.  The caller chooses it by the mesh's
  backend (parallel/sharding.py), never by catching a failure.  NCCL (one
  GPU per rank) takes the tensors as they are;
* ``run_spmd(fn, world, backend, timeout)`` starts ``world`` ranks with the
  ``spawn`` start method (CUDA may already be initialised in the caller),
  each in a process group of its own address (with NCCL each on GPU rank
  mod the card count), runs ``fn(rank, *args)`` on each and returns their
  results in rank order.  Every rank has the same
  deadline: a rank that fails or a collective that hangs ends the run with
  an error, and every process it started is stopped.
"""
from __future__ import annotations

import datetime
import functools
import queue as queue_mod
import socket
import time
import traceback
from typing import Optional

import torch
import torch.distributed as dist


def initialize(coordinator_address: Optional[str] = None, num_processes: Optional[int] = None,
               process_id: Optional[int] = None, backend: str = "gloo",
               timeout_s: float = 300.0):
    """Join the process group (a no-op for a single process): the address is
    ``host:port`` of rank 0, given explicitly — nothing here discovers a
    cluster."""
    if (num_processes or 1) > 1 and not dist.is_initialized():
        dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                                world_size=num_processes, rank=process_id,
                                timeout=datetime.timedelta(seconds=timeout_s))


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_primary() -> bool:
    """True on the rank that schedules and logs (rank 0)."""
    return process_index() == 0


def primary_only(fn):
    """Run fn only on rank 0 (logging, checkpoint writes)."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        if is_primary():
            return fn(*args, **kwargs)
        return None

    return wrapper


def local_batch_slice(global_batch: int, n: Optional[int] = None,
                      i: Optional[int] = None) -> slice:
    """The rows of a global batch that process (or data rank) ``i`` of ``n``
    owns: contiguous equal groups, as the engines' slot groups are."""
    n = process_count() if n is None else n
    i = process_index() if i is None else i
    per = global_batch // n
    return slice(i * per, (i + 1) * per)


# ---------------------------------------------------------------------------
# Collectives
# ---------------------------------------------------------------------------

def _wire(t: torch.Tensor, host: bool) -> torch.Tensor:
    """The buffer a collective works on: a pinned host copy of a CUDA tensor
    when ``host``, else the tensor itself (contiguous)."""
    t = t.contiguous()
    if host and t.is_cuda:
        buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        buf.copy_(t)
        return buf
    return t


def _back(buf: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return buf.to(like.device, non_blocking=True) if buf.device != like.device else buf


def _bits(t: torch.Tensor) -> torch.Tensor:
    """A 16-bit or 8-bit float tensor moved as its bytes (exact, whatever
    the backend's support for the type: gloo takes no int16 and no fp8).
    Contiguous."""
    if t.element_size() == 2 or (t.element_size() == 1 and t.is_floating_point()):
        return t.view(torch.uint8)
    return t


def all_reduce(t: torch.Tensor, group, op: str = "sum", host: bool = False) -> torch.Tensor:
    """The elementwise sum (or max) of ``t`` over the group's ranks, as a new
    tensor of t's dtype on t's device.  16-bit floats are reduced in f32 and
    rounded once."""
    work = t.float() if t.dtype in (torch.bfloat16, torch.float16) else t
    buf = _wire(work, host)
    if buf is t:
        buf = buf.clone()
    dist.all_reduce(buf, op=dist.ReduceOp.SUM if op == "sum" else dist.ReduceOp.MAX,
                    group=group)
    return _back(buf, t).to(t.dtype)


def all_gather(t: torch.Tensor, group, host: bool = False) -> torch.Tensor:
    """Every rank's ``t`` stacked on a new leading axis in group-rank order."""
    buf = _bits(_wire(t, host))
    outs = [torch.empty_like(buf) for _ in range(dist.get_world_size(group))]
    dist.all_gather(outs, buf, group=group)
    return _back(torch.stack(outs).view(t.dtype), t)


def broadcast(t: torch.Tensor, src: int, group, host: bool = False) -> torch.Tensor:
    """Global rank ``src``'s ``t`` on every rank of the group (a new tensor;
    every rank passes a tensor of the same shape and dtype)."""
    buf = _wire(t, host)
    if buf is t:
        buf = buf.clone()
    dist.broadcast(_bits(buf), src=src, group=group)
    return _back(buf, t)


def ring_shift(t: torch.Tensor, ranks: list, host: bool = False) -> torch.Tensor:
    """Send ``t`` to the next rank of the ring ``ranks`` (global ranks, in
    ring order) and return the previous rank's: the send and the receive
    issued as one batch, which NCCL needs (a lone send waits for its
    receive)."""
    me = ranks.index(dist.get_rank())
    n = len(ranks)
    buf = _bits(_wire(t, host))
    recv = torch.empty_like(buf)
    for req in dist.batch_isend_irecv([dist.P2POp(dist.isend, buf, ranks[(me + 1) % n]),
                                       dist.P2POp(dist.irecv, recv, ranks[(me - 1) % n])]):
        req.wait()
    return _back(recv.view(t.dtype), t)


def send(t: torch.Tensor, dst: int, host: bool = False) -> None:
    """Send ``t`` to global rank ``dst``, whose ``recv`` takes it (a
    pipeline's stage-to-stage pass)."""
    req = dist.isend(_bits(_wire(t, host)), dst)
    req.wait()


def recv(like: torch.Tensor, src: int, host: bool = False) -> torch.Tensor:
    """Receive a tensor of ``like``'s shape and dtype from global rank
    ``src``, on like's device."""
    buf = torch.empty(like.shape, dtype=like.dtype,
                      pin_memory=host and like.is_cuda, device="cpu" if host else like.device)
    req = dist.irecv(_bits(buf), src)
    req.wait()
    return _back(buf, like)


# ---------------------------------------------------------------------------
# Launching ranks
# ---------------------------------------------------------------------------

def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(rank, world, port, backend, timeout, fn, args, results):
    try:
        if backend == "nccl":  # one GPU a rank
            torch.cuda.set_device(rank % torch.cuda.device_count())
        dist.init_process_group(backend, init_method=f"tcp://localhost:{port}",
                                world_size=world, rank=rank,
                                timeout=datetime.timedelta(seconds=timeout))
        try:
            results.put((rank, True, fn(rank, *args)))
        finally:
            dist.destroy_process_group()
    except BaseException:
        results.put((rank, False, traceback.format_exc()))  # the parent raises with it
        raise


def run_spmd(fn, world: int, backend: str = "gloo", timeout: float = 300.0, args=()):
    """Run ``fn(rank, *args)`` on ``world`` spawned ranks joined in one
    process group (``backend``, a free localhost port); return the results
    in rank order.  ``fn`` and ``args`` must pickle (``fn`` a module-level
    function).  Raises with the rank's traceback if a rank fails, and
    ``TimeoutError`` if the ranks are not done within ``timeout`` seconds;
    either way every rank is stopped."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world, port, backend, timeout, fn, args, results),
                         daemon=True) for r in range(world)]
    for p in procs:
        p.start()
    got, deadline = {}, time.monotonic() + timeout
    try:
        while len(got) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"run_spmd: {world - len(got)} of {world} ranks not done "
                                   f"within {timeout} s")
            try:
                rank, ok, res = results.get(timeout=min(left, 1.0))
            except queue_mod.Empty:
                dead = [p for p in procs if p.exitcode not in (None, 0)]
                if dead and len(got) < world:
                    # a rank died without reporting (killed, or out of memory)
                    time.sleep(0.5)
                    if results.empty():
                        raise RuntimeError(f"run_spmd: a rank exited with code "
                                           f"{dead[0].exitcode} without a result")
                continue
            if not ok:
                raise RuntimeError(f"run_spmd: rank {rank} failed:\n{res}")
            got[rank] = res
        return [got[r] for r in range(world)]
    finally:
        for p in procs:
            p.join(timeout=max(0.0, min(10.0, deadline - time.monotonic())))
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        results.close()

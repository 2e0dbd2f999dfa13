"""Measured plan table: the counterpart of chatglm_q_tpu/ops/autotune.py.

The matmul kernels' plans (tiles, K splits, staging; ops/quant_matmul.py
``splitk_plan``, ``mma_plan``, ``int8_mma_plan``, ``t_mma_plan``,
ops/dyn_matmul.py ``dyn_plan``) are built-in rules.  A plan measured on a
card can take their place, per kernel and shape:

* ``utils/autotune_sweep.py`` times candidate plans of each linear on the
  card and records the fastest one that is as exact as the built-in plan;
* the plan functions consult the table at launch time (a captured program
  bakes in the plan it was captured with, as JAX bakes it at trace time);
* precedence: an explicit ``override`` > the user's table > the packaged
  table > the built-in plan.  An entry is checked like a built-in plan (the
  shared memory, split counts and tile counts the kernel takes); an invalid
  one raises, naming its key.

The user's table is JSON at ``$CHATGLM_Q_TPU_TORCH_AUTOTUNE`` (default
``~/.cache/chatglm_q_tpu_torch/autotune.json``); the packaged one is
``chatglm_q_tpu_torch/data/autotune_defaults.json``.  Keys are
``{device_kind}|{kernel}|m{bucket}k{K}n{N}``: ``bucket`` is the row count
that selects one plan, the m-tiles' rows (8 a tile) of a split-K kernel or
M padded to 64 rows for a Hopper kernel, so every M that shares a plan
shares an entry.  An entry is ``{"plan": [...], "us": t}``.
"""
from __future__ import annotations

import contextlib
import json
import os
import threading
from typing import Callable, Optional

ENV = "CHATGLM_Q_TPU_TORCH_AUTOTUNE"
_PACKAGED = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "data",
                         "autotune_defaults.json")

_lock = threading.Lock()
_table: Optional[dict] = None
_device_kind: Optional[str] = None
_overrides: dict = {}


def table_path() -> str:
    """The user's table: ``$CHATGLM_Q_TPU_TORCH_AUTOTUNE``, else
    ``~/.cache/chatglm_q_tpu_torch/autotune.json``."""
    return os.environ.get(ENV) or os.path.expanduser("~/.cache/chatglm_q_tpu_torch/autotune.json")


def packaged_path() -> str:
    return _PACKAGED


def _read(path: str) -> dict:
    """A table file's entries; a missing file is empty, one that is not a
    JSON object raises (never ignored)."""
    try:
        with open(path) as f:
            table = json.load(f)
    except FileNotFoundError:
        return {}
    except ValueError as e:
        raise ValueError(f"autotune table {path}: not JSON ({e})") from e
    if not isinstance(table, dict):
        raise ValueError(f"autotune table {path}: not a JSON object")
    return table


def _load() -> dict:
    global _table
    if _table is None:
        with _lock:
            merged = _read(_PACKAGED)
            merged.update(_read(table_path()))
            _table = merged
    return _table


def reload() -> None:
    """Drop the in-memory table: the next lookup reads the files again."""
    global _table
    with _lock:
        _table = None


def device_kind() -> str:
    """``torch.cuda.get_device_name()`` with spaces replaced ("cpu" without
    a card)."""
    global _device_kind
    if _device_kind is None:
        import torch

        name = torch.cuda.get_device_name() if torch.cuda.is_available() else "cpu"
        _device_kind = name.replace(" ", "_")
    return _device_kind


def key(kernel: str, bucket: int, k: int, n: int) -> str:
    return f"{device_kind()}|{kernel}|m{bucket}k{k}n{n}"


def lookup(kernel: str, bucket: int, k: int, n: int) -> Optional[dict]:
    """The entry of this kernel and shape (an override first), or None."""
    name = key(kernel, bucket, k, n)
    if name in _overrides:
        return _overrides[name]
    return _load().get(name)


def record(kernel: str, bucket: int, k: int, n: int, plan, us: Optional[float] = None) -> str:
    """Write ``plan`` into the user's table (an atomic rewrite that keeps
    the other keys); returns the key.  Never the packaged table."""
    name = key(kernel, bucket, k, n)
    entry = {"plan": [int(v) for v in plan]}
    if us is not None:
        entry["us"] = round(float(us), 3)
    with _lock:
        path = table_path()
        on_disk = _read(path)
        on_disk[name] = entry
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        tmp = f"{path}.tmp{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(on_disk, f, indent=1, sort_keys=True)
        os.replace(tmp, path)
    reload()
    return name


@contextlib.contextmanager
def override(kernel: str, bucket: int, k: int, n: int, plan):
    """Within the block, this kernel and shape launch ``plan`` (checked like
    a table entry): the sweep's candidates, and tests."""
    name = key(kernel, bucket, k, n)
    _overrides[name] = {"plan": [int(v) for v in plan]}
    try:
        yield
    finally:
        _overrides.pop(name, None)


def plan(kernel: str, bucket: int, k: int, n: int, builtin: Callable[[], tuple],
         problem: Callable[[tuple], Optional[str]]) -> tuple:
    """The plan a launch takes: an override's or table entry's, checked by
    ``problem`` (None, or what is wrong with it), else ``builtin()``."""
    if not _overrides and not _load():
        return builtin()
    entry = lookup(kernel, bucket, k, n)
    if entry is None:
        return builtin()
    name = key(kernel, bucket, k, n)
    try:
        got = tuple(int(v) for v in entry["plan"])
    except (KeyError, TypeError, ValueError) as e:
        raise ValueError(f"autotune entry {name}: no plan list ({entry!r})") from e
    wrong = problem(got)
    if wrong is not None:
        raise ValueError(f"autotune entry {name}: plan {list(got)} refused: {wrong}")
    return got

"""Build the CUDA kernels at first use and bind them with ctypes.

Every ``csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a`` (one process per
source, all started together), and the objects are linked into one shared
library with a plain C interface.  The library lands in ``_build/`` next to
this package (gitignored), named by a hash of the sources and flags, so an
edit rebuilds and an unchanged tree reuses the last build.  Nothing here runs
at import: the CPU tests import every module without ``nvcc``.

PyTorch's headers are kept out of the build on purpose: a source that
includes ``torch/extension.h`` takes minutes to compile, a plain C interface
seconds.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

_PKG_DIR = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG_DIR / "csrc"
BUILD_DIR = _PKG_DIR / "_build"

ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-lineinfo"]

P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

# The activation dtype codes of the matmul entry points (csrc/common.cuh:
# DT_F32, DT_BF16, DT_F16).  Each entry checks the code it is given and
# refuses one it has no kernel for.
DTYPE_NAMES = ("float32", "bfloat16", "float16")


def dtype_code(dtype) -> int:
    """The entry points' code of a torch dtype: 0 f32, 1 bf16, 2 f16."""
    return DTYPE_NAMES.index(str(dtype).split(".")[-1])


# C entry points (csrc/*.cu) and their argument types.  Pointers and the
# stream are c_void_p: a default ctypes int would cut them to 32 bits.
SIGNATURES = {
    # x, packed, scale, y, workspace, M, K, N, x dtype code, nsplit, groups_per_split, stream
    "chatglm_int4_gemv": [P, P, P, P, P, I, I, I, I, I, I, P],
    # the split-K kernels: x, weights, scale, y, workspace, arrivals, M, K, N, x dtype code
    # (bf16, f16 or f32), mt, cols, nsplit, groups_per_split, groups_per_chunk, stream
    "chatglm_int4_splitk_mma": [P, P, P, P, P, P, I, I, I, I, I, I, I, I, I, P],
    "chatglm_int8_splitk_mma": [P, P, P, P, P, P, I, I, I, I, I, I, I, I, I, P],
    # xq, sx, weights, scale, y, workspace, arrivals, M, K, N, y dtype code (f32, bf16 or
    # f16), mt, cols, nsplit, groups_per_split, groups_per_chunk, stream
    "chatglm_int8_dyn_splitk": [P, P, P, P, P, P, P, I, I, I, I, I, I, I, I, I, P],
    "chatglm_int4_dyn_splitk": [P, P, P, P, P, P, P, I, I, I, I, I, I, I, I, I, P],
    # the Hopper kernels: activations, weights, scale, out, workspace, arrivals, M, K, N,
    # activation dtype code (bf16 or f16; B1 and B6 also f32, the activations then x's
    # (3, M, K) bf16 pieces), bm, nsplit, per split
    # (B1: groups, the others: 64-element stages), ctas, stream
    "chatglm_int4_wgmma": [P, P, P, P, P, P, I, I, I, I, I, I, I, I, P],
    "chatglm_int8_mma": [P, P, P, P, P, P, I, I, I, I, I, I, I, I, P],
    "chatglm_int8_t_mma": [P, P, P, P, P, P, I, I, I, I, I, I, I, I, P],
    "chatglm_int4_t_mma": [P, P, P, P, P, P, I, I, I, I, I, I, I, I, P],
    # the transposed split-K kernels (B13 / B14 at M <= 16): g, weights, scale, out,
    # workspace, arrivals, M, K, N, g dtype code (bf16 or f16), mt, nsplit, chunks_per_split,
    # chunks_per_stage, stream
    "chatglm_int8_t_splitk": [P, P, P, P, P, P, I, I, I, I, I, I, I, I, P],
    "chatglm_int4_t_splitk": [P, P, P, P, P, P, I, I, I, I, I, I, I, I, P],
    # x, w, scale, y, workspace, M, K, N, x dtype code, nsplit, chunks_per_split, stream
    "chatglm_int8_gemv": [P, P, P, P, P, I, I, I, I, I, I, P],
    # x, pieces, n (elements, as a 64-bit int), stream: the f32 forms' split pass
    "chatglm_split_bf16x3": [P, P, ctypes.c_longlong, P],
    # g, w (or packed), scale, out, M, K, N, g dtype code (f32), stream (B13 / B14 in f32)
    "chatglm_int8_t_gemv": [P, P, P, P, I, I, I, I, P],
    "chatglm_int4_t_gemv": [P, P, P, P, I, I, I, I, P],
    # xq, sx, w, scale, y, workspace, arrivals, M, K, N, y dtype code (f32, bf16 or f16), bm,
    # nsplit, 128-element stages per split, ctas, stream
    "chatglm_int8_dyn_mma": [P, P, P, P, P, P, P, I, I, I, I, I, I, I, I, P],
    "chatglm_int4_dyn_mma": [P, P, P, P, P, P, P, I, I, I, I, I, I, I, I, P],
    # q, q_out, kv, kv_stride, freqs, k_layer, v_layer, page_table, starts, B, G, Hq, D, T
    # (the pool's P), MP, offset, stride, phase, total (page_table null for the dense cache;
    # a shard's offset / stride, phase and global capacity, or 0, 1, 0, 0), form, stream.
    # The attention entries' form (ops/attention.py: FORM_CODES): 0 for bf16 activations
    # over a bf16 cache or pool, 1 for bf16 over a float8_e4m3fn one, 2 for f16 over f16,
    # 3 for f16 over float8_e4m3fn, 4 for f32 over f32, 5 for f32 over float8_e4m3fn
    "chatglm_rope_kv_append": [P, P, P, I, P, P, P, P, P, I, I, I, I, I, I, I, I, I, I, I, P],
    # dst_layer, src, page_table, starts, B, G, D, T (or P), MP, form, stream (the
    # write-only form; src in the form's activation dtype)
    "chatglm_kv_append": [P, P, P, P, I, I, I, I, I, I, P],
    # q, k, v, lengths, part, arrivals, out, B, G, Hg, T, D, span, v2, sm_scale, m_out, l_out,
    # offset, form, stream (B4, B12 and K1; part, m_out and l_out may be null)
    "chatglm_decode_attention": [P, P, P, P, P, P, P, I, I, I, I, I, I, I, F, P, P, I, I, P],
    # q, k, v, lengths, q_starts, kv_row_map, out, B, S, G, Hg, T, D, sm_scale, form,
    # stream (q_starts / kv_row_map may be null)
    "chatglm_prefill_attention": [P, P, P, P, P, P, P, I, I, I, I, I, I, F, I, P],
    # q, k_layer, v_layer, page_table, lengths, part, arrivals, out, B, G, Hg, P, D, MP,
    # span, sm_scale, m_out, l_out, stride, phase, form, stream (B10 and K2; part, m_out
    # and l_out may be null)
    "chatglm_decode_paged": [P, P, P, P, P, P, P, P, I, I, I, I, I, I, I, F, P, P, I, I, I, P],
    # q, k_layer, v_layer, page_table, row_map, starts, part, arrivals, out, B, S, G, Hg,
    # P, D, MP, span, sm_scale, form, stream (row_map and part may be null)
    "chatglm_chunk_paged": [P, P, P, P, P, P, P, P, P, I, I, I, I, I, I, I, I, F, I, P],
    # w, ld_w, hinv, ld_h, scale_n, q_out, err_out, loss_out, scales_out, N, bs, groupsize,
    # stream (GPTQ's column sweep; scale_n null for int4, scales_out null for int8)
    "chatglm_gptq_sweep": [P, I, P, I, P, P, P, P, P, I, I, I, P],
}

_LIB = None
_SCRATCH: dict = {}
# (kind, device) whose current buffer a CUDA graph captured, and the buffers
# replaced since then: a graph keeps the address it captured, so such a
# buffer is never freed (its memory would go to another tensor that the
# graph's replays then write into)
_IN_GRAPH: set = set()
_HELD: list = []


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return found


def _sources() -> list[Path]:
    return sorted(SRC_DIR.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256()
    for path in sorted(SRC_DIR.glob("*.cu*")):  # .cu and .cuh
        h.update(path.name.encode())
        h.update(path.read_bytes())
    h.update(" ".join(ARCH_FLAGS + NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the kernels if this tree's build is missing; return the .so."""
    lib_path = BUILD_DIR / f"libchatglm_kernels_{_digest()}.so"
    if lib_path.exists():
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for src in _sources():
            obj = Path(tmp) / (src.stem + ".o")
            cmd = [nvcc, *ARCH_FLAGS, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        failed = []
        for src, _, proc in procs:
            out, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"{src.name}:\n{out}")
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        tmp_lib = Path(tmp) / lib_path.name
        link = [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp_lib),
                *[str(obj) for _, obj, _ in procs]]
        res = subprocess.run(link, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{res.stdout}{res.stderr}")
        os.replace(tmp_lib, lib_path)  # atomic: a concurrent reader never
        # sees a half-written library
    return lib_path


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _LIB
    if _LIB is None:
        handle = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        handle.chatglm_error_string.argtypes = [ctypes.c_int]
        handle.chatglm_error_string.restype = ctypes.c_char_p
        _LIB = handle
    return _LIB


def call(name: str, *args) -> None:
    """Launch C entry ``name``; raise on the cudaError_t it returns (a
    refused launch never runs, and a later synchronize would not say so)."""
    handle = lib()
    code = getattr(handle, name)(*args)
    if code != 0:
        msg = handle.chatglm_error_string(code).decode()
        raise RuntimeError(f"{name}: CUDA error {code} ({msg})")


def scratch(kind: str, device, n: int, dtype):
    """A kernel family's device buffer ``kind`` on ``device``, kept across
    calls and grown when smaller than ``n``: the split kernels' 4-byte
    partials and their arrival counters (zeroed once and left at zero by
    every launch: the merging block resets its counter).  One stream at a
    time per device: launches on it run in order.

    Under a CUDA-graph capture the buffer must be large enough already (the
    step's eager warm-up sizes it): growing it there would allocate from the
    graph's pool and zero it only on replay.  A buffer a graph captured is
    kept alive when a larger one replaces it."""
    import torch

    key = (kind, device)
    buf = _SCRATCH.get(key)
    capturing = torch.cuda.is_available() and torch.cuda.is_current_stream_capturing()
    if buf is None or buf.numel() < n:
        if capturing:
            raise RuntimeError(
                f"scratch {kind!r}: {n} elements asked during a CUDA-graph capture, "
                f"{0 if buf is None else buf.numel()} held: run the step eagerly once before "
                "capturing it, so that its buffers are sized")
        if key in _IN_GRAPH:
            _HELD.append(buf)
            _IN_GRAPH.discard(key)
        buf = torch.zeros((max(n, 1024),), dtype=dtype, device=device)
        _SCRATCH[key] = buf
    if capturing:
        _IN_GRAPH.add(key)
    return buf


# Debugging switches, set by utils/debug.py: ``INTERPRET`` makes every
# kernel wrapper run its plain version (``interpret_kernels``), and
# ``NAN_CHECKS`` makes every launch check its output (``enable_nan_checks``).
INTERPRET = False
NAN_CHECKS = False


def on_card(t) -> bool:
    """Whether a kernel wrapper given ``t`` launches its kernel: t lies on
    the card and ``INTERPRET`` is off (else it runs its plain version)."""
    return t.is_cuda and not INTERPRET


def exporting(t) -> bool:
    """Whether a wrapper given ``t`` hands it to its custom op instead of
    launching (ops/export_ops.py): t lies on the card and ``torch.export``
    is tracing."""
    import torch

    return t.is_cuda and torch.compiler.is_exporting()


def export_op(name: str):
    """The custom op of wrapper ``name`` (ops/export_ops.py)."""
    from . import export_ops

    return export_ops.op(name)


class Form:
    """The launch count of one form of a wrapper's kernel (its float8 cache
    or its float16 activations: ``<wrapper>_fp8``, ``<wrapper>_f16``).  A
    form's launches count in the wrapper's own ``launches`` too; this count
    says which of them took that form (ops.kernel_wrappers lists it)."""

    def __init__(self, name: str):
        self.__name__ = name
        self.launches = 0


def with_forms(wrapper, *suffixes):
    """Give ``wrapper`` a ``Form`` counter attribute for each suffix ("fp8",
    "f16"), named ``<wrapper>_<suffix>``; returns the wrapper."""
    for suffix in suffixes:
        setattr(wrapper, suffix, Form(f"{wrapper.__name__}_{suffix}"))
    return wrapper


def launched(wrapper, out, form: str = ""):
    """Count a launch of ``wrapper``'s kernel (and of its ``form``, a suffix
    that ``with_forms`` gave it, where one is named) and return its output.  Under
    ``NAN_CHECKS`` the output (a tuple's first tensor: an lse form's m is
    −inf by design on a row with no valid slot) must be finite, or this
    raises naming the kernel; that check syncs, so a CUDA-graph capture
    refuses it."""
    import torch

    wrapper.launches += 1
    if form:
        getattr(wrapper, form).launches += 1
    if NAN_CHECKS:
        if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
            raise RuntimeError(f"{wrapper.__name__}: NaN checks sync with the host, which a "
                               "CUDA-graph capture refuses; capture with them off")
        t = out[0] if isinstance(out, tuple) else out
        if t.is_floating_point() and not bool(torch.isfinite(t).all()):
            raise FloatingPointError(f"{wrapper.__name__}: its kernel gave a non-finite value")
    return out


def stream_ptr(t) -> int:
    """The current CUDA stream of ``t``'s device, as an int for ctypes."""
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream

"""Ops of the port: quantization, linears, sampling, and the kernel wrappers.

Every kernel wrapper carries a ``launches`` count, raised by one where it
launches its CUDA kernel and nowhere else; ``launch_counts`` reads them and
``reset_launch_counts`` sets them to 0, so a run can show which kernels its
main path went through.  A CUDA graph launches its kernels without running
the wrappers: a step program (utils/graphs.py) records each wrapper's count
during its capture and adds it back on every replay (``add_launch_counts``),
so the counts stay the kernels' real launches.  Launches in a form of a
kernel also count apart: the attention wrappers' over a float8_e4m3fn cache
as ``<name>_fp8``, and theirs and the matmuls' on float16 activations as
``<name>_f16``, the attention wrappers' on float16 activations over a
float8_e4m3fn cache as ``<name>_fp8_f16``, theirs and B1's / B6's on
float32 activations as ``<name>_f32`` and the attention wrappers' on
float32 over float8_e4m3fn as ``<name>_fp8_f32``.
"""


def kernel_wrappers() -> dict:
    """name → wrapper function, for every CUDA kernel of the port."""
    from . import attention as A
    from . import dyn_matmul as D
    from . import gptq_sweep as GS
    from . import int8_matmul as I8
    from . import quant_matmul as QM

    wrappers = {
        "int4g32_splitk": QM.int4g32_splitk,
        "int4g32_gemv": QM.int4g32_gemv,
        "int4g32_mma": QM.int4g32_mma,
        "int8_splitk": I8.int8_splitk,
        "int8_gemv": I8.int8_gemv,
        "int8_mma": I8.int8_mma,
        "split_bf16x3_pass": QM.split_bf16x3_pass,
        "int4g32_t_splitk": QM.int4g32_t_splitk,
        "int4g32_t_gemv": QM.int4g32_t_gemv,
        "int4g32_t_mma": QM.int4g32_t_mma,
        "int8_t_splitk": I8.int8_t_splitk,
        "int8_t_gemv": I8.int8_t_gemv,
        "int8_t_mma": I8.int8_t_mma,
        "int8_dyn_splitk": D.int8_dyn_splitk,
        "int8_dyn_mma": D.int8_dyn_mma,
        "int4_dyn_splitk": D.int4_dyn_splitk,
        "int4_dyn_mma": D.int4_dyn_mma,
        "rope_kv_append": A.rope_kv_append,
        "kv_cache_write_idx": A.kv_cache_write_idx,
        "flash_attention_decode": A.flash_attention_decode,
        "flash_attention_decode_v2": A.flash_attention_decode_v2,
        "flash_attention_prefill": A.flash_attention_prefill,
        "flash_attention_prefill_chunk": A.flash_attention_prefill_chunk,
        "kv_pool_write_idx": A.kv_pool_write_idx,
        "flash_attention_decode_paged": A.flash_attention_decode_paged,
        "flash_attention_chunk_paged": A.flash_attention_chunk_paged,
        "flash_attention_decode_lse": A.flash_attention_decode_lse,
        "flash_attention_decode_paged_lse": A.flash_attention_decode_paged_lse,
        "rope_kv_append_sharded": A.rope_kv_append_sharded,
        "gptq_sweep_int8": GS.gptq_sweep_int8,
        "gptq_sweep_int4": GS.gptq_sweep_int4,
    }
    forms = [(name, form) for name, fn in wrappers.items()
             for form in A.CACHE_FORM_SUFFIXES if hasattr(fn, form)]
    wrappers.update({f"{name}_{form}": getattr(wrappers[name], form) for name, form in forms})
    return wrappers


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in kernel_wrappers().items()}


def reset_launch_counts() -> None:
    for fn in kernel_wrappers().values():
        fn.launches = 0


def set_launch_counts(counts: dict) -> None:
    wrappers = kernel_wrappers()
    for name, n in counts.items():
        wrappers[name].launches = n


def add_launch_counts(delta: dict) -> None:
    wrappers = kernel_wrappers()
    for name, n in delta.items():
        wrappers[name].launches += n

"""Model, load-time and runtime configuration.

``ChatGLM2Config`` and ``GLMLoadConfig`` keep the JSON schema of the JAX
package's config (chatglm_q_tpu/config.py), so one ``config.json`` loads in
both.  ``TorchRuntimeConfig`` replaces ``TpuRuntimeConfig`` with the knobs
that mean something on a GPU; it is never serialized.
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Literal, Optional

import torch

QuantType = Literal["none", "int8", "int4g32"]
DTypeName = Literal["float32", "float16", "bfloat16"]

DEFAULT_GROUP_SIZE = 32


@dataclass
class ChatGLM2Config:
    """ChatGLM2-6B architecture hyperparameters."""

    hidden_size: int = 4096
    inner_hidden_size: int = 13696
    head_hidden_size: int = 128

    num_multi_query_groups: int = 2
    num_attention_heads: int = 32
    num_layers: int = 28

    vocab_size: int = 65024
    dropout_rate: float = 0.0
    layernorm_epsilon: float = 1e-05
    max_sequence_length: int = 8192

    @property
    def qkv_out_size(self) -> int:
        return self.head_hidden_size * (
            self.num_attention_heads + 2 * self.num_multi_query_groups
        )

    @property
    def q_size(self) -> int:
        return self.head_hidden_size * self.num_attention_heads

    @property
    def kv_size(self) -> int:
        return self.head_hidden_size * self.num_multi_query_groups


def dtype_from_name(name: DTypeName) -> torch.dtype:
    return {
        "float32": torch.float32,
        "float16": torch.float16,
        "bfloat16": torch.bfloat16,
    }[name]


@dataclass
class GLMLoadConfig:
    """Serialization config, JSON-compatible with the JAX package's."""

    model_type: str = "ChatGLM2Model"
    model_config: ChatGLM2Config = field(default_factory=ChatGLM2Config)
    quant_type: QuantType = "none"
    weight_files: list = field(default_factory=list)
    tokenizer_file: str = "sentencepiece.model"
    torch_dtype: DTypeName = "float32"

    def __post_init__(self):
        # checks that raise (not asserts): a config.json comes from outside
        if self.model_type != "ChatGLM2Model":
            raise ValueError(f"Only 'ChatGLM2Model' is supported, not {self.model_type!r}")
        if not isinstance(self.model_config, ChatGLM2Config):
            self.model_config = ChatGLM2Config(**self.model_config)
        if self.quant_type not in ("none", "int8", "int4g32"):
            raise ValueError(f"quant_type {self.quant_type!r}")
        if self.torch_dtype not in ("float32", "float16", "bfloat16"):
            raise ValueError(f"torch_dtype {self.torch_dtype!r}")

    @property
    def activation_dtype(self) -> torch.dtype:
        return dtype_from_name(self.torch_dtype)

    @staticmethod
    def from_json(json_str) -> "GLMLoadConfig":
        return GLMLoadConfig(**json.loads(json_str))

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), ensure_ascii=False, indent=2)


@dataclass(frozen=True)
class TorchRuntimeConfig:
    """GPU runtime knobs — never serialized to a checkpoint's config.json.

    use_kernels: call the kernel wrappers (ops/quant_matmul.py,
        ops/attention.py).  None = on for CUDA tensors.  False runs the plain
        PyTorch versions on any device: the reference path the kernels are
        held against.  On a CPU tensor a wrapper always runs its plain
        version, so True on CPU equals False up to the launch counts.
    use_flash_attention: the flash prefill / ragged decode attention (with
        the in-place KV write) in the serving paths.  None = follow
        use_kernels.  False takes the masked-softmax path
        (``models/chatglm2.py``), which is plain PyTorch.
    dynamic_int8: dynamic per-row int8 activation quantization
        (chatglm_q_tpu/config.py:139-145): every int8 linear runs s8×s8 dots
        with int32 accumulation (ops/dyn_matmul.py, B7), and every int4g32
        linear at M ≤ 64 rows widens its nibbles to s8 for group-32 s8×s8
        dots (B8).  A different numerics mode from weight-only (about
        0.3–1% activation quantization error), so opt-in.  Unlike the JAX
        package, where the flag lives in its Pallas path only, it also
        selects the dynamic plain versions under ``use_kernels=False``: the
        reference path the kernels are held against.
    decode_attn_v2: the dense decode step attends through B12
        (``ops/attention.py::flash_attention_decode_v2``: the cache split
        over T across blocks, q prescaled in its dtype, f32 probabilities)
        instead of B4.  Read by ``decode_step``, ``multi_step_decode``,
        ``GLMDecoder`` and ``ServingEngine``; the paged engine ignores it,
        as in the JAX package (chatglm_q_tpu/config.py:164).
    remat_layers: ``models/chatglm2.py::forward`` recomputes each layer in
        the backward pass (``torch.utils.checkpoint``) instead of keeping
        its activations: training memory drops from O(layers) to O(1)
        layers for one more forward (chatglm_q_tpu/config.py:180).

    mesh: a ``parallel.sharding.Mesh``: the model runs tensor parallel
        over its ranks (chatglm_q_tpu/config.py:149-188), each rank a
        process holding its shard of the params (``shard_params``) and of
        the cache.  Under a mesh the serving paths take the flash
        structure (the kernels, or their plain versions on the CPU) and
        every linear runs per shard (parallel/tp_linear.py).
    kv_shard_t: the dense cache splits its T slots over the model axis:
        prefill through ring attention, decode through K1 and an exact
        merge (``ops/attention.py::flash_attention_decode_kv_tsharded``).
    paged_shard_model: the paged pool splits its pages over the model axis
        by logical-block phase (``DistributedPagedServingEngine(
        shard_model_pages=True)`` sets it): decode through K2 and the merge.
    cuda_graphs: the step programs (``utils/graphs.py``: a decode step
        and its sampler, a speculative verify or in-loop speculation step,
        a prefill of one bucket, a compact prefill chunk, a training step)
        run as CUDA graphs, the counterpart of the JAX package's jitted
        programs.  True (the default) captures them on the kernel path;
        False runs each step's launches from Python (an A/B against the
        graphs, debugging).  A gloo mesh refuses capture (its collectives
        cannot be captured; an NCCL mesh captures its decode chunks and
        runs its prefills eagerly), and so does the masked-softmax path on
        CUDA: both run eagerly and say so once (a warning).  On the CPU the
        programs run eagerly through the same static buffers.
    The JAX package's block sizes (attn_block_q/k, decode_block_k) have no
    counterpart: the CUDA kernels' tiles are compile-time constants in
    csrc/, and ``sync_prefill_chunks`` belongs to the TPU alone.
    """

    use_kernels: Optional[bool] = None
    use_flash_attention: Optional[bool] = None
    dynamic_int8: bool = False
    decode_attn_v2: bool = False
    remat_layers: bool = False
    mesh: object = None  # Optional[parallel.sharding.Mesh]
    kv_shard_t: bool = False
    paged_shard_model: bool = False
    cuda_graphs: bool = True

    def kernels_enabled(self, device: torch.device) -> bool:
        if self.use_kernels is not None:
            return self.use_kernels
        return torch.device(device).type == "cuda"

    def flash_enabled(self, device: torch.device) -> bool:
        if self.mesh is not None:
            return True
        if self.use_flash_attention is not None:
            return self.use_flash_attention
        return self.kernels_enabled(device)


def resolve_device(device) -> torch.device:
    """The entry points' device rule: None means CUDA, and raises where CUDA
    is absent — never a silent fall back to the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' explicitly to run "
                "on the CPU")
        return torch.device("cuda")
    return torch.device(device)

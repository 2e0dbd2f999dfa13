"""chatglm_q_tpu_torch — the PyTorch/CUDA port of chatglm_q_tpu.

The JAX package (``chatglm_q_tpu``) stays the reference; this package mirrors
its module names (config, loader, tokenizer, ops/quant, ops/linear,
ops/sampling, models/chatglm2, models/paged_kv, models/spec_decode,
serving/chat, serving/decoder, serving/engine, serving/paged_engine,
serving/speculative, serving/dist_engine, parallel/sharding,
parallel/tp_linear, parallel/ring_attention, utils/distributed,
utils/logging) so each counterpart is easy to find.  The hot-path kernels
are hand-written CUDA C++ for Hopper (``csrc/*.cu``), built with ``nvcc`` at
first use and bound with ctypes (``ops/_build.py``).  On CPU tensors every
kernel wrapper runs its plain PyTorch version instead.

This package never imports ``jax`` or ``chatglm_q_tpu``.
"""

from .config import ChatGLM2Config, GLMLoadConfig, TorchRuntimeConfig

__version__ = "0.1.0"

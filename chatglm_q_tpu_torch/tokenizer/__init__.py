"""The ChatGLM2 tokenizer: a copy of chatglm_q_tpu/tokenizer/ (jax-free
there too), so the port imports nothing of the JAX package."""
from .chatglm2 import ChatGLM2Tokenizer, BatchEncoding
from .sp_core import SpTokenizer

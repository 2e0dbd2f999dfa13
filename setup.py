"""Packaging for chatglm_q_tpu (reference analog: /root/reference/setup.py).

Dependencies are the TPU-native equivalents of the reference's
(setup.py:22-27): jax replaces torch+triton; safetensors and tqdm are kept;
sentencepiece is NOT required — this package ships its own
sentencepiece-compatible tokenizer core (see chatglm_q_tpu/tokenizer/).
"""
from setuptools import setup, find_packages

setup(
    name="chatglm_q_tpu",
    version="0.1.0",
    description="TPU-native weight-only-quantized inference engine for ChatGLM2-style models (JAX/Pallas)",
    packages=find_packages(include=["chatglm_q_tpu", "chatglm_q_tpu.*",
                                    "chatglm_q_tpu_torch", "chatglm_q_tpu_torch.*"]),
    package_data={"chatglm_q_tpu": ["data/*.json"],
                  # the PyTorch/CUDA port builds its kernels from these at first use
                  "chatglm_q_tpu_torch": ["csrc/*.cu", "csrc/*.cuh", "data/*.json"]},
    python_requires=">=3.10",
    install_requires=[
        "jax",
        "flax",
        "numpy",
        "safetensors",
        "tqdm",
    ],
    extras_require={
        "hub": ["huggingface_hub"],
        # the PyTorch/CUDA port (chatglm_q_tpu_torch); its kernels need nvcc
        "torch": ["torch"],
    },
)

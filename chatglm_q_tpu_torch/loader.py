"""Checkpoint load/save, in the reference's on-disk format.

The counterpart of chatglm_q_tpu/loader.py: ``config.json`` (the
``GLMLoadConfig`` schema), safetensors shards with the reference's tensor
names and layouts, greedy ≤ 2 GiB sharding on save, lenient load (unknown
keys reported and skipped, missing keys raised together).  A checkpoint
saved by either package loads in the other with identical tensors.

  on disk (reference layout)                 in memory (both packages)
  ------------------------------------       ---------------------------------
  layers.{i}.attn.qkv_proj.weight (N,K)*  →  layers.q_proj/kv_proj, K-major,
                                             stacked on a leading L axis
  layers.{i}.ffn.w_in.weight (2I,K)*      →  layers.w_in_h / w_in_gate
  int8 weight (out,in) + scale (out,)     →  weight (K,N) int8 + scale (N,)
  int4 weight (in/2,out) offset-8 nibbles →  same shape, two's-complement
                                             nibbles (byte XOR 0x88)
  (*) float checkpoints store torch Linear (out,in); quantized int4 ones are
      already K-major.

Quantized weights are zero-padded to their storage K (and the w_in halves
and the lm_head on N) on load and stripped on save (ops/quant.py).

The JAX loader reads and writes through the ``safetensors`` package and
``ml_dtypes``; the port needs neither: ``read_safetensors`` /
``write_safetensors`` handle the format (an 8-byte little-endian header
length, a JSON header of ``dtype`` / ``shape`` / ``data_offsets`` per tensor
plus ``__metadata__``, then the raw little-endian bytes), and PyTorch has
bfloat16 natively.
"""
from __future__ import annotations

import json
import shutil
import struct
from pathlib import Path
from typing import Optional, Union

import torch

from .config import ChatGLM2Config, GLMLoadConfig, dtype_from_name, resolve_device
from .ops import quant as Q
from .tokenizer import ChatGLM2Tokenizer

# safetensors dtype names (the format's own spelling)
ST_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
    "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8, "BOOL": torch.bool,
}
_ST_NAMES = {v: k for k, v in ST_DTYPES.items()}


# ---------------------------------------------------------------------------
# The safetensors file format
# ---------------------------------------------------------------------------

def read_safetensors(path: Union[str, Path]) -> dict:
    """name → CPU tensor, in the file's header order."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        data = bytearray(f.read())
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dtype = ST_DTYPES[info["dtype"]]
        begin, end = info["data_offsets"]
        shape = info["shape"]
        if end == begin:
            out[name] = torch.empty(shape, dtype=dtype)
            continue
        t = torch.frombuffer(data, dtype=torch.uint8, count=end - begin, offset=begin)
        out[name] = t.view(dtype).reshape(shape)
    return out


def write_safetensors(path: Union[str, Path], tensors: dict,
                      metadata: Optional[dict] = None) -> None:
    """Write name → tensor (any device) as one safetensors file."""
    flat, header, offset = [], {}, 0
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    for name, t in tensors.items():
        t = t.detach().cpu().contiguous()
        nbytes = t.numel() * t.element_size()
        header[name] = {"dtype": _ST_NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + nbytes]}
        flat.append(t.reshape(-1).view(torch.uint8))
        offset += nbytes
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * (-len(blob) % 8)  # the format pads its header to 8 bytes
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for t in flat:
            if t.numel():
                f.write(t.numpy().data)


# ---------------------------------------------------------------------------
# state dict (reference names) ↔ param tree
# ---------------------------------------------------------------------------

def _linear_from_sd(sd, prefix, quant_type, dtype):
    """One linear from reference-named tensors: float and int8 weights are
    torch's (out, in), transposed to K-major; int4g32 is (in/2, out) packed,
    repacked to tpu order, its f16 scales cast to bf16."""
    out = {}
    w = sd.pop(prefix + ".weight")
    if quant_type == "none":
        out["weight"] = w.t().contiguous().to(dtype)
    elif quant_type == "int8":
        out["weight"] = Q.pad_int8_weight(w.t().contiguous())
        out["weight_scale"] = sd.pop(prefix + ".weight_scale").float()
    elif quant_type == "int4g32":
        scale = sd.pop(prefix + ".weight_scale")
        if scale.dtype == torch.float16:
            scale = scale.float().to(Q.SCALE_DTYPE)
        out["weight"], out["weight_scale"] = Q.pad_packed_int4(Q.repack_ref_to_tpu(w), scale)
    else:
        raise NotImplementedError(quant_type)
    bias = sd.pop(prefix + ".bias", None)
    if bias is not None:
        out["bias"] = bias.to(dtype)
    return out


def _split_cols(p: dict, at: int) -> tuple[dict, dict]:
    """Split a K-major linear's leaves along the output (N, last) axis."""
    left = {k: v[..., :at].contiguous() for k, v in p.items()}
    right = {k: v[..., at:].contiguous() for k, v in p.items()}
    return left, right


def expected_state_dict_keys(config: ChatGLM2Config, quant_type: str) -> list:
    """Every tensor name :func:`params_from_state_dict` requires."""
    scale = [".weight_scale"] if quant_type != "none" else []
    keys = (["word_embedding.weight"] + ["word_embedding" + s for s in scale]
            + ["final_ln.weight", "lm_head.weight"] + ["lm_head" + s for s in scale])
    for i in range(config.num_layers):
        keys += [f"layers.{i}.attn_ln.weight", f"layers.{i}.ffn_ln.weight"]
        for lin in ("attn.qkv_proj", "attn.o_proj", "ffn.w_in", "ffn.w_out"):
            keys.append(f"layers.{i}.{lin}.weight")
            keys += [f"layers.{i}.{lin}" + s for s in scale]
    return keys


def _stack(trees: list) -> dict:
    return {k: _stack([t[k] for t in trees]) if isinstance(trees[0][k], dict)
            else torch.stack([t[k] for t in trees]) for k in trees[0]}


def params_from_state_dict(sd: dict, config: ChatGLM2Config, quant_type: str,
                           dtype: torch.dtype) -> dict:
    """The stacked param tree (CPU tensors) from reference-named tensors.
    Consumes entries of ``sd``; what is left over the caller reports as
    ignored.  A missing tensor raises, all of them named together."""
    missing = [k for k in expected_state_dict_keys(config, quant_type) if k not in sd]
    if missing:
        raise KeyError(
            f"checkpoint is missing {len(missing)} required tensors "
            f"(quant_type={quant_type}): {missing[:8]}{' …' if len(missing) > 8 else ''}")

    if quant_type == "none":
        emb = {"weight": sd.pop("word_embedding.weight").to(dtype)}
    else:
        emb = {"weight": sd.pop("word_embedding.weight"),
               "weight_scale": sd.pop("word_embedding.weight_scale").float()}

    def layer_parts(i):
        qkv = _linear_from_sd(sd, f"layers.{i}.attn.qkv_proj", quant_type, dtype)
        q_proj, kv_proj = _split_cols(qkv, config.q_size)
        w_in = _linear_from_sd(sd, f"layers.{i}.ffn.w_in", quant_type, dtype)
        w_in_h, w_in_gate = _split_cols(w_in, config.inner_hidden_size)
        if quant_type != "none":
            # N-pad to the w_out K storage (kernel alignment; exact no-op)
            w_in_h = Q.pad_linear_n(w_in_h, quant_type)
            w_in_gate = Q.pad_linear_n(w_in_gate, quant_type)
        return {
            "attn_ln": {"weight": sd.pop(f"layers.{i}.attn_ln.weight").to(dtype)},
            "ffn_ln": {"weight": sd.pop(f"layers.{i}.ffn_ln.weight").to(dtype)},
            "q_proj": q_proj,
            "kv_proj": kv_proj,
            "o_proj": _linear_from_sd(sd, f"layers.{i}.attn.o_proj", quant_type, dtype),
            "w_in_h": w_in_h,
            "w_in_gate": w_in_gate,
            "w_out": _linear_from_sd(sd, f"layers.{i}.ffn.w_out", quant_type, dtype),
        }

    return {
        "word_embedding": emb,
        "layers": _stack([layer_parts(i) for i in range(config.num_layers)]),
        "final_ln": {"weight": sd.pop("final_ln.weight").to(dtype)},
        "lm_head": Q.lmhead_pad(_linear_from_sd(sd, "lm_head", quant_type, dtype), quant_type),
    }


def params_to_state_dict(params: dict, config: ChatGLM2Config, quant_type: str) -> dict:
    """Inverse of :func:`params_from_state_dict`: reference names and
    layouts, CPU tensors, the storage padding stripped."""
    sd = {}

    def cpu(t):
        return t.detach().cpu()

    def put_linear(prefix, d, k_logical):
        w = cpu(d["weight"])
        if quant_type == "none":
            sd[prefix + ".weight"] = w.t().contiguous()
        elif quant_type == "int8":
            sd[prefix + ".weight"] = w[:k_logical].t().contiguous()
            sd[prefix + ".weight_scale"] = cpu(d["weight_scale"])
        else:
            sd[prefix + ".weight"] = Q.repack_tpu_to_ref(w[: k_logical // 2]).contiguous()
            sd[prefix + ".weight_scale"] = cpu(d["weight_scale"])[: k_logical // 32].contiguous()
        if "bias" in d:
            sd[prefix + ".bias"] = cpu(d["bias"])

    def merge_cols(a, b):
        return {k: torch.cat([cpu(a[k]), cpu(b[k])], dim=-1) for k in a}

    def slice_n(d, n):  # strip the N storage padding
        return {k: v[..., :n] for k, v in d.items()}

    sd["word_embedding.weight"] = cpu(params["word_embedding"]["weight"])
    if quant_type != "none":
        sd["word_embedding.weight_scale"] = cpu(params["word_embedding"]["weight_scale"])
    layers = params["layers"]
    I = config.inner_hidden_size
    for i in range(config.num_layers):
        li = {k: {kk: vv[i] for kk, vv in v.items()} for k, v in layers.items()}
        sd[f"layers.{i}.attn_ln.weight"] = cpu(li["attn_ln"]["weight"])
        sd[f"layers.{i}.ffn_ln.weight"] = cpu(li["ffn_ln"]["weight"])
        put_linear(f"layers.{i}.attn.qkv_proj", merge_cols(li["q_proj"], li["kv_proj"]),
                   config.hidden_size)
        put_linear(f"layers.{i}.attn.o_proj", li["o_proj"], config.q_size)
        put_linear(f"layers.{i}.ffn.w_in",
                   merge_cols(slice_n(li["w_in_h"], I), slice_n(li["w_in_gate"], I)),
                   config.hidden_size)
        put_linear(f"layers.{i}.ffn.w_out", li["w_out"], I)
    sd["final_ln.weight"] = cpu(params["final_ln"]["weight"])
    put_linear("lm_head", slice_n(params["lm_head"], config.vocab_size), config.hidden_size)
    return sd


# ---------------------------------------------------------------------------
# Files
# ---------------------------------------------------------------------------

def _to_device(tree, device):
    return {k: _to_device(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in tree.items()}


def load_model_and_tokenizer(model_path: Union[str, Path], dtype_name: Optional[str] = None,
                             device=None, load_model: bool = True,
                             load_tokenizer: bool = True):
    """(GLMLoadConfig, params on ``device`` | None, ChatGLM2Tokenizer | None)
    from a local checkpoint directory.  ``device=None`` means CUDA, and
    raises where CUDA is absent."""
    model_path = Path(model_path)
    config = GLMLoadConfig.from_json((model_path / "config.json").read_bytes())
    dtype = dtype_from_name(dtype_name or config.torch_dtype)

    params = None
    if load_model:
        device = resolve_device(device)
        sd = {}
        for file in config.weight_files:
            sd.update(read_safetensors(model_path / file))
        try:
            params = params_from_state_dict(sd, config.model_config, config.quant_type, dtype)
        except KeyError as e:
            raise KeyError(f"model weight missing from checkpoint: {e}") from e
        if sd:
            print(f'checkpoint keys ignored: {", ".join(sorted(sd))}')
        params = _to_device(params, device)

    tokenizer = None
    if load_tokenizer:
        tokenizer = ChatGLM2Tokenizer(model_path / config.tokenizer_file)
    return config, params, tokenizer


def save_model_and_tokenizer(path: Union[str, Path], config: GLMLoadConfig, params: dict,
                             tokenizer: Optional[ChatGLM2Tokenizer] = None,
                             shard: bool = True, max_shard_bytes: int = 2 * 1024**3) -> None:
    """Greedy ≤ ``max_shard_bytes`` shards, ``config.json`` and a copy of the
    tokenizer file; float tensors are cast to ``config.torch_dtype``."""
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)

    if tokenizer is not None:
        dst = path / config.tokenizer_file
        if isinstance(tokenizer.vocab_file, (str, Path)) and Path(tokenizer.vocab_file) != dst:
            shutil.copy(tokenizer.vocab_file, dst)
        elif isinstance(tokenizer.vocab_file, bytes):
            dst.write_bytes(tokenizer.vocab_file)

    sd = params_to_state_dict(params, config.model_config, config.quant_type)
    tgt = dtype_from_name(config.torch_dtype)
    sd = {k: v.to(tgt) if v.is_floating_point() else v for k, v in sd.items()}

    if not shard:
        config.weight_files = ["model_weights.safetensors"]
        write_safetensors(path / config.weight_files[0], sd)
    else:
        mapping, index, size = {}, 0, 0
        for name, w in sd.items():
            nbytes = w.numel() * w.element_size()
            if size + nbytes > max_shard_bytes:
                index += 1
                size = 0
            size += nbytes
            mapping[name] = f"model_weights_{index}.safetensors"
        config.weight_files = sorted(set(mapping.values()))
        for file in config.weight_files:
            write_safetensors(path / file, {n: sd[n] for n, f in mapping.items() if f == file})

    (path / "config.json").write_text(config.to_json())

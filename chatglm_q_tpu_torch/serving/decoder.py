"""Streaming autoregressive decoder: the counterpart of
chatglm_q_tpu/serving/decoder.py (``GLMDecoder``).

``GLMDecoder.from_pretrained(local_dir).generate(prompt)`` loads a checkpoint
(loader.py) and streams the response.  As in JAX:

* a prompt longer than the cache keeps its most recent tokens;
* each yield is the re-decoded response so far, held back while it ends in
  a partial UTF-8 character (U+FFFD); eos ends the stream;
* the prefill and decode steps run on a preallocated KV cache with on-device
  sampling; ``time_log`` prints the reference's report.

What differs:

* PyTorch runs eagerly, so the JAX package's power-of-two prompt buckets
  (which bound the number of ``jax.jit`` programs) are dropped: the prompt
  is prefilled at its own length.  Right padding changes no output.
* Sampling draws from a ``torch.Generator`` on the params' device, seeded
  from ``seed``; its draws differ from ``jax.random``'s.
* Only a local directory loads: the hub download needs a network.
* ``speculative_k > 0`` raises: prompt-lookup speculation needs the chunked
  prefill (``prefill_chunk``), which the port does not have yet.
"""
from __future__ import annotations

import random
import time
from pathlib import Path
from typing import Optional, Union

import torch

from ..config import GLMLoadConfig, TorchRuntimeConfig
from ..models import chatglm2 as M
from ..ops.sampling import greedy_sampling, top_p_sampling
from .chat import process_response

_DEFAULT_RT = TorchRuntimeConfig()


class GLMDecoder:
    def __init__(
        self,
        config: GLMLoadConfig,
        params: dict,
        tokenizer,
        eos_token: str = "</s>",
        max_sequence_length: Optional[int] = None,
        time_log: bool = False,
        rt: TorchRuntimeConfig = _DEFAULT_RT,
        dtype=None,
        kv_dtype=None,
    ):
        self.config = config
        self.params = params
        self.tokenizer = tokenizer
        self.eos_token_id = tokenizer[eos_token]
        self.max_sequence_length = max_sequence_length or config.model_config.max_sequence_length
        self.time_log = time_log
        self.rt = rt
        self.dtype = dtype or config.activation_dtype
        self.kv_dtype = kv_dtype or self.dtype
        self.device = params["final_ln"]["weight"].device

    # -- persistence -------------------------------------------------------

    @staticmethod
    def from_pretrained(path: Union[str, Path], dtype_name: Optional[str] = None,
                        device=None, **kwargs) -> "GLMDecoder":
        """Load a local checkpoint directory onto ``device`` (None = CUDA,
        raising where CUDA is absent)."""
        from ..loader import load_model_and_tokenizer

        path = Path(path)
        if not path.is_dir():
            raise FileNotFoundError(
                f"{str(path)!r} is not a local checkpoint directory; the port loads "
                "local paths only (no hub download: it needs a network)")
        config, params, tokenizer = load_model_and_tokenizer(path, dtype_name, device)
        return GLMDecoder(config, params, tokenizer, **kwargs)

    def save_pretrained(self, path: Union[str, Path], shard: bool = True):
        from ..loader import save_model_and_tokenizer

        save_model_and_tokenizer(path, self.config, self.params, self.tokenizer, shard=shard)

    # -- generation --------------------------------------------------------

    def generate(
        self,
        prefix_text: str,
        max_generated_tokens: int = 400,
        top_k: int = 100,
        top_p: float = 0.8,
        temperature: float = 1.0,
        seed: Optional[int] = None,
        speculative_k: int = 0,
    ):
        """Streaming generator: yields the re-decoded response after each
        token (suppressing a trailing partial-UTF8 U+FFFD); returns the
        final processed response.  ``temperature == 0`` is greedy.

        ``speculative_k > 0`` raises here, at the call, rather than decoding
        without speculation."""
        if speculative_k > 0:
            raise NotImplementedError(
                "speculative_k > 0: prompt-lookup speculation needs the chunked "
                "prefill (prefill_chunk), which the port does not have yet")
        return self._generate(prefix_text, max_generated_tokens, top_k, top_p, temperature,
                              seed)

    def _generate(self, prefix_text, max_generated_tokens, top_k, top_p, temperature, seed):
        tokenizer = self.tokenizer
        qt = self.config.quant_type
        mc = self.config.model_config
        prefix_ids = tokenizer.encode(prefix_text)
        # keep the most recent context when the prompt exceeds the cache
        max_prefix = self.max_sequence_length - max(1, min(max_generated_tokens, 64))
        if len(prefix_ids) > max_prefix:
            prefix_ids = prefix_ids[-max_prefix:]
        gen = torch.Generator(device=self.device)
        gen.manual_seed(random.randrange(1 << 30) if seed is None else seed)

        prompt = torch.tensor([prefix_ids], dtype=torch.long, device=self.device)
        lengths = torch.tensor([len(prefix_ids)], dtype=torch.int32, device=self.device)
        cache = M.init_kv_cache(mc, 1, self.max_sequence_length, self.kv_dtype, self.device)

        generated: list[int] = []
        generate_time: list[float] = []
        start = time.perf_counter()
        logits, cache = M.prefill(self.params, mc, prompt, lengths, cache, qt, self.dtype, self.rt)
        while (len(generated) < max_generated_tokens
               and len(generated) + len(prefix_ids) < self.max_sequence_length):
            if temperature == 0.0:
                tok = greedy_sampling(logits)
            else:
                tok = top_p_sampling(logits, top_k, top_p, temperature, generator=gen)
            next_token = int(tok[0])
            generate_time.append(time.perf_counter() - start)
            start = time.perf_counter()

            generated.append(next_token)
            if next_token == self.eos_token_id:
                break

            response_text = process_response(tokenizer.decode(generated))
            if response_text and response_text[-1] != "�":
                yield response_text
            logits, cache = M.decode_step(self.params, mc, tok, cache, qt, self.dtype, self.rt)

        if self.time_log and generate_time:
            init_time, *rest_time = generate_time
            print("Decoder:")
            print(f"  len: {len(prefix_ids)}(prefix) + {len(generated)}(gen)")
            print(f" init: {init_time:.6f} s")
            print(f"  sum: {sum(generate_time):.6f} s")
            if rest_time:
                print(f"  gen: {len(rest_time) / sum(rest_time):.6f} tok/s")
            print(f"  avg: {len(generate_time) / sum(generate_time):.6f} tok/s")

        return process_response(tokenizer.decode(generated))

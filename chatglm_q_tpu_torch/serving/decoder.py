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

``speculative_k > 0`` turns on prompt-lookup speculation for greedy
generation (serving/speculative.py): drafts from the sequence's own n-gram
repeats are verified k + 1 at a time by one ``prefill_chunk`` with all
logits; the output is token-for-token the plain greedy output.
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
from .speculative import find_draft, greedy_accept

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
        speculative_ngram: int = 3,
    ):
        """Streaming generator: yields the re-decoded response after each
        token (suppressing a trailing partial-UTF8 U+FFFD); returns the
        final processed response.  ``temperature == 0`` is greedy.

        ``speculative_k > 0`` verifies up to k drafted tokens per device step
        when decoding greedily (identical output, fewer weight passes); it is
        ignored when sampling.  ``self.spec_stats`` counts the steps."""
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
        speculate = speculative_k > 0 and temperature == 0.0
        self.spec_stats = {"verify_steps": 0, "decode_steps": 0, "accepted_tokens": 0}
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

            draft = None
            if speculate:
                # the cache holds prefix + generated[:-1]
                cur_len = len(prefix_ids) + len(generated) - 1
                room = min(self.max_sequence_length - cur_len - 1,
                           max_generated_tokens - len(generated))
                # the verify step writes a whole (k+1)-wide window at cur_len:
                # near the end of the cache the write would clamp down over
                # valid KV, so decode plainly there
                if room >= 1 and cur_len + speculative_k + 1 <= self.max_sequence_length:
                    draft = find_draft(prefix_ids + generated, speculative_ngram,
                                       min(speculative_k, room))
            if not draft:
                logits, cache = M.decode_step(self.params, mc, tok, cache, qt, self.dtype,
                                              self.rt)
                self.spec_stats["decode_steps"] += 1
                continue
            seq = [next_token] + draft
            ids = torch.zeros((1, speculative_k + 1), dtype=torch.long, device=self.device)
            ids[0, : len(seq)] = torch.tensor(seq)
            all_logits, cache = M.prefill_chunk(
                self.params, mc, ids, torch.tensor([cur_len], device=self.device),
                torch.tensor([len(seq)], device=self.device), cache, qt, self.dtype, self.rt,
                return_all_logits=True)
            self.spec_stats["verify_steps"] += 1
            accepted = greedy_accept(draft, all_logits[0, : len(seq)].argmax(-1).tolist())
            if self.eos_token_id in draft[:accepted]:
                # nothing after an accepted eos counts
                accepted = draft[:accepted].index(self.eos_token_id) + 1
            stop = False
            for d in draft[:accepted]:
                generated.append(d)
                generate_time.append(time.perf_counter() - start)
                start = time.perf_counter()
                if d == self.eos_token_id:
                    stop = True
                    break
                response_text = process_response(tokenizer.decode(generated))
                if response_text and response_text[-1] != "�":
                    yield response_text
            self.spec_stats["accepted_tokens"] += accepted
            # keep the pending token and the accepted drafts; the rejected
            # positions' KV sits above the length and is overwritten later
            cache = M.KVCache(cache.k, cache.v,
                              torch.tensor([cur_len + 1 + accepted], dtype=torch.int32,
                                           device=self.device))
            if stop:
                break
            # row `accepted` is the distribution after the accepted prefix:
            # exactly the next greedy step's logits
            logits = all_logits[:, accepted]

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

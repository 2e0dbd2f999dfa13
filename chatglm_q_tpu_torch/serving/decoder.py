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

* The prompt is right-padded to a power-of-two bucket, as in JAX, and
  each bucket's prefill is a step program over the decoder's cache
  (``chatglm2.prefill_program``), as are the decode step with its sampler
  and the speculative verify step (JAX's jitted ``_prefill``, ``_decode``
  and ``_verify``): replayed from CUDA graphs (utils/graphs.py).  The cache
  is kept across calls (a stream still open when another starts gets its
  own).
* Sampling draws from a ``torch.Generator`` on the params' device that is
  kept with the cache and reseeded from ``seed`` each call; its draws
  differ from ``jax.random``'s.
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
from ..ops.sampling import GREEDY, fill_rows, greedy_sampling, top_p_rows
from ..utils import graphs as G
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
        # (cache, sampling generator) pairs kept across calls: a decode
        # program is captured over the cache and draws from the generator
        self._free_caches: list = []

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
        mc = self.config.model_config
        prefix_ids = self.tokenizer.encode(prefix_text)
        # keep the most recent context when the prompt exceeds the cache
        max_prefix = self.max_sequence_length - max(1, min(max_generated_tokens, 64))
        if len(prefix_ids) > max_prefix:
            prefix_ids = prefix_ids[-max_prefix:]
        # the bucket clamps to the cache (a max_sequence_length that is not a
        # power of two)
        bucket = M.prompt_bucket(len(prefix_ids), self.max_sequence_length)
        prompt = torch.zeros((1, bucket), dtype=torch.long)
        prompt[0, : len(prefix_ids)] = torch.tensor(prefix_ids, dtype=torch.long)
        lengths = torch.tensor([len(prefix_ids)], dtype=torch.int32, device=self.device)
        # a kept cache and its generator; a stream still open elsewhere keeps
        # its own pair, so interleaved streams draw independently
        cache, gen = self._free_caches.pop() if self._free_caches else (
            M.init_kv_cache(mc, 1, self.max_sequence_length, self.kv_dtype, self.device),
            torch.Generator(device=self.device))
        gen.manual_seed(random.randrange(1 << 30) if seed is None else seed)
        sampling = GREEDY if temperature == 0.0 else top_p_rows(top_k, gen)
        try:
            return (yield from self._generate(prefix_ids, prompt, lengths, cache, sampling,
                                              (top_k, top_p, temperature),
                                              max_generated_tokens, speculative_k,
                                              speculative_ngram))
        finally:
            self._free_caches.append((cache, gen))

    def _generate(self, prefix_ids, prompt, lengths, cache, sampling, setting,
                  max_generated_tokens, speculative_k, speculative_ngram):
        tokenizer = self.tokenizer
        qt = self.config.quant_type
        mc = self.config.model_config
        generated: list[int] = []
        generate_time: list[float] = []
        speculate = speculative_k > 0 and sampling.mode == "greedy"
        self.spec_stats = {"verify_steps": 0, "decode_steps": 0, "accepted_tokens": 0}
        start = time.perf_counter()
        prefill = M.prefill_program(self.params, mc, cache, prompt.shape[1], qt, self.dtype,
                                    self.rt)
        prefill.load(ids=prompt, lengths=lengths)
        # the logits live in the programs' pool: sampled before the decode
        # program replays
        logits = prefill.step(self.params, cache.k, cache.v)["logits"]
        cache = M.KVCache(cache.k, cache.v, lengths)
        step = M.decode_program(self.params, mc, cache, qt, self.dtype, self.rt, sampling)
        if sampling.mode == "rows":
            fill_rows(step.inputs, *setting)
        tok = sampling(logits, step.inputs)
        while (len(generated) < max_generated_tokens
               and len(generated) + len(prefix_ids) < self.max_sequence_length):
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
                # JAX's _decode: the step and its sampler, replayed
                step.load(ids=tok, lengths=cache.lengths)
                step.step(self.params, cache.k, cache.v)
                tok = step.inputs["ids"]
                cache = M.KVCache(cache.k, cache.v, step.inputs["lengths"])
                self.spec_stats["decode_steps"] += 1
                continue
            seq = [next_token] + draft
            # JAX's _verify: a fixed (1, k + 1) window, the host's values
            # copied into its buffers
            verify = self._verify_program(cache, speculative_k)
            ids = torch.zeros((1, speculative_k + 1), dtype=torch.long)
            ids[0, : len(seq)] = torch.tensor(seq)
            verify.load(ids=ids, starts=torch.tensor([cur_len], dtype=torch.int32),
                        valid=torch.tensor([len(seq)], dtype=torch.int32))
            out = verify.step(self.params, cache.k, cache.v)
            self.spec_stats["verify_steps"] += 1
            accepted = greedy_accept(draft, out["argmax"][0, : len(seq)].tolist())
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
            tok = greedy_sampling(out["logits"][:, accepted])

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

    def _verify_program(self, cache, k: int):
        """The speculative verify step (JAX's ``_verify``) as a step program:
        ``prefill_chunk`` of a static (1, k + 1) window "ids" at "starts"
        with "valid" tokens, all its logits and their argmax."""
        mc, qt = self.config.model_config, self.config.quant_type
        dtype, rt, dev = self.dtype, self.rt, self.device
        key = ("verify", G.tensor_key(cache.k), G.tensor_key(cache.v), k,
               G.static_key(mc, qt, dtype, rt))

        def inputs():
            return {"ids": torch.zeros((1, k + 1), dtype=torch.long, device=dev),
                    "starts": torch.zeros((1,), dtype=torch.int32, device=dev),
                    "valid": torch.zeros((1,), dtype=torch.int32, device=dev)}

        def body(inp, params, ck, cv):
            logits, _ = M.prefill_chunk(params, mc, inp["ids"], inp["starts"], inp["valid"],
                                        M.KVCache(ck, cv, inp["starts"]), qt, dtype, rt,
                                        return_all_logits=True)
            return {"logits": logits, "argmax": logits.argmax(-1)}

        return G.programs(self.params).get(key, "verify", inputs, body, dev, rt)

"""Chip smoke test of the PyTorch/CUDA port (chatglm_q_tpu_torch) on one GPU.

Run from the root of a checkout, on a machine with an NVIDIA H100:

    python3 chip_smoke.py    # all phases, a few minutes with the build
    python3 chip_smoke.py --gap-seeds 61,71,81    # phase 6's greedy readings alone, per seed
    python3 chip_smoke.py --short-seeds 71,72,73    # phase 7's 16-token grad readings, per seed
    python3 chip_smoke.py --sharded    # phase 2's sharded rows (K1, K2, K3) and phase 8 alone
    python3 chip_smoke.py --nccl 4    # phases 8 and 11 alone over NCCL on 4 cards, one a rank
    python3 chip_smoke.py --train-mesh    # phase 2's tp = 2 rows and phase 11 alone
    python3 chip_smoke.py --serving    # phases 4, 5, 6 and 9 alone (the captured decode)
    python3 chip_smoke.py --quant    # phase 10 alone, then GPTQ int4g32 of the 28-layer model
    python3 chip_smoke.py --programs    # phase 4's captured prefill, phase 7 and phase 12 alone
    python3 chip_smoke.py --phase12    # phase 12 alone (the plan table, the export, the launchers)
    python3 chip_smoke.py --fp8    # the fp8 KV cache: phase 2's fp8 rows, its runs in phases 5,
                                   # 6 and 8, the long-context step
    python3 chip_smoke.py --fp16    # float16 activations: phase 2's f16 rows, the f16 runs of
                                    # phases 5, 6 and 7, the float16-checkpoint launcher run
    python3 chip_smoke.py --fp16-seeds 17,27,37    # phase 2's f16 readings per seed (F16_*)
    python3 chip_smoke.py --fp32    # float32 activations: phase 2's f32 rows (B1's and B6's
                                    # f32 forms, the attention kernels'), the f32 runs of
                                    # phases 5, 6 and 8
    python3 chip_smoke.py --fp32-readings    # B1's and B6's f32 rows and their readings
                                             # (F32_SUM_C), unheld, and the crossover sweep
    python3 chip_smoke.py --f16-train-seeds 41,71,72,73,74,75    # phase 7's f16 grad readings

Phases (any failure raises and exits non-zero):

1. Card and build: the card's name and power limit, torch/CUDA versions,
   the kernels built from csrc/ (build seconds), and the device-to-device
   copy bandwidth (for comparison with the published rate the bounds use).
2. Each CUDA kernel against its plain PyTorch version on the card, at the
   shapes of the ChatGLM2-6B main paths (B1 at M = 1, 4, 16, 20, 32, 36, 48,
   128, 512 and 1024 in bf16, and B1's and B6's f32 forms at M = 1, 4, 16,
   36, 57, 128 and 512 beside the CUDA-core gemvs in turns, with the
   split-K / Hopper crossover sweep; the paged kernels at a 64-page pool
   of 256-row pages, 2048-slot rows): error, kernel time (CUDA events),
   plain time, the bound (the least time for the same work: bytes over the
   published HBM rate, or operations over the tensor-core peak of their
   type, whichever is larger) and, where one PyTorch call computes the same
   function, that call's time (``library_ms``, a yardstick only: SDPA for
   the attentions, a page or row gather + SDPA for the paged and chunked
   attentions, ``index_put_`` for the KV writes,
   ``torch._weight_int4pack_mm`` for the int4 matmul on the same weights
   repacked into its layout, ``torch._weight_int8pack_mm`` for the int8
   matmul and ``torch._int_mm`` for the dynamic int8 accumulator).  The
   int4 matmul with dynamic int8 activations (B8) has no such call.  B6 at
   B1's M in bf16, its bf16 rows (the split-K kernel at M
   <= 16, the Hopper kernel above) also within ``SUM_TOL`` of their exact
   value beyond the bf16 rounding.  B7 at M = 1, 4, 64, 128, 512, 1024 and
   B8 at M = 1, 4, 32, 48, 64, 512, each with ``call_ms`` (the wrapper with
   its per-row quantize prologue) beside the kernel's ms and its plan
   (``dyn_splitk_mma_kernel`` at M <= 16, ``dyn_wgmma_kernel`` above, with
   ``dense_ms``), B7 bit for bit, B8 also within ``SUM_TOL`` of its exact
   value beyond its bf16 rounding.  B1's
   rows above 64 (its Hopper kernel) also carry ``dense_ms``, ``x @ w_deq``
   in cuBLAS on weights dequantized to bf16 beforehand: another function,
   never called by the port, a yardstick of the tensor cores only.  Then
   B1's split-K tensor-core kernel against its prefill kernel, both forced,
   at M = 16, 32, 64 (the crossover ``SMALL_M_MAX`` stands for), and B8
   against B1 at M = 32, 64, 128: the crossover that ``_INT4_DYN_M_MAX``
   (64) stands for.  The backward matmuls B13 (``int8_matmul_t``; library
   ``_weight_int8pack_mm`` on g · s) and B14 (``int4g32_matmul_t``; no
   library call, the dense ``g @ w_deq.T`` time as a reference) at the six
   shapes transposed, M = 512 and 1024 bf16, M = 1, 4 and 16 bf16 (the
   split-K tensor-core kernel; 16: phase 7's 16-token step) and M = 8 f32
   (the CUDA-core kernel), the Hopper and split-K rows of B1, B6, B13 and B14
   also within
   ``SUM_TOL`` of their exact value beyond its bf16 rounding and beside a
   cuBLAS dense product on bf16 weights (``dense_ms``); B12
   (``flash_attention_decode_v2``) beside B4's row, held also to its own
   limit on the error beyond the output's bf16 rounding (``B12_TOL``), with
   a control that rounds p to bf16 and must exceed it, and B10 / B11 (the
   paged decode and chunk attention) likewise to ``B10_TOL`` / ``B11_TOL``,
   each called twice for a bit-equal result; B4 at the decoder's
   batch-1 shape (lengths 140 of 1024), B5 (both forms), and the decode and
   prefill kernels at the edge cases their main-path shapes miss
   (``check_attention_edges``).  The dynamic row quantizer (B7 / B8's
   prologue) on rows where max|x| / 127 and max|x| · (1/127) round apart:
   its sx and xq bit-equal to the CPU's, a Python-number divisor (the
   control) not.  B1, B6, B13 and B14 at phase 11's tp = 2 shard shapes (M
   = 512: q_proj's 2048 columns, o_proj's 2048 storage rows, w_in's 6912 /
   6784 columns on rank 0 / 1, w_out's 6912 storage rows with rank 1's 128
   rows of padding, the lm_head's 32768 columns), each within KERNEL_TOL
   and SUM_TOL (``check_shard_matmuls``).  Every attention kernel's
   float8_e4m3fn-cache form (``check_fp8_attention``: B3 / B9 at B = 4 and
   1, B4 at B = 4 and 1, B12, B5 both forms, B10, B11 at S = 9, K1, K2, K3
   dense and paged) at its bf16 row's shape: bit-equal to its bf16 form on
   the upcast cache (the appends: to their plain versions), within
   KERNEL_TOL of its plain version, timed beside its bf16 form, its plain
   version and the cache cast to bf16 + SDPA, its bound counting K/V at one
   byte; and the store: all 65,536 bf16 patterns through the write-only
   append byte-equal to ``kv_store_cast`` on the card and on the CPU.  The
   float16 forms (``check_f16_kernels``): B1 at M = 1, 4, 36 (split-K) and
   512 (wgmma) and B6 at M = 1, 4 and 512 on the six linears, within
   ``F16_KERNEL_TOL`` of the plain version and ``SUM_TOL`` beyond half an
   f16 ulp; every attention kernel's f16 form over an f16 cache at its bf16
   row's shape (the appends bit-equal to plain, B4 / B12 / B10 / B11 also
   beyond the output's f16 rounding against a bf16-p control); each timed
   beside its bf16 form on the same shapes, its plain version and the
   library call in f16.  Also B7 / B8 with f16 outputs at B6's
   / B1's f16 rows (B7 bit-equal to plain) and B13 / B14 on f16 g at M = 1,
   16 and 512, each counted in its f16 form; and every attention kernel's
   f16 form over an fp8 cache (``check_fp8_attention`` in f16, the same
   caches as the fp8 rows): bit-equal to its f16 form on the upcast cache,
   within ``F16_KERNEL_TOL`` of plain, the store over all 65,536 f16
   patterns.  Then the float32 forms (``check_f32_kernels``, TF32 off and
   printed): every attention kernel's f32 form (the CUDA-core kernels) over
   an f32 cache at its bf16 row's shapes (and B4 at B = 1, the write-only
   B3 / B9) within ``F32_TOL`` of its plain version, the appends and writes
   bit-equal, each timed beside its bf16 form, its plain version and SDPA in
   f32; over an fp8 cache (``check_fp8_attention`` in f32), each bit-equal
   to its f32 form on the upcast cache, and the f32 -> e4m3 store over a
   sweep of every binade's rounding midpoints, one rounding from f32 (a
   bf16 hop, the control, changes some bytes); and the edge cases in f32.
3. End to end at full width and depth 2: the kernel path against the plain
   path on the same random weights, prefill then 8 teacher-forced decode
   steps, for int4g32, int8, int8 with dynamic int8 activations and
   int4g32 with dynamic int8 activations, and int4g32 with
   ``decode_attn_v2`` (B12, never B4), with control bugs that must fail
   the same limit; then the f32 parity forward (``models.chatglm2.forward``)
   in int4g32 and in int8, whose linears take B1's and B6's f32 forms (the
   Hopper kernels on x's three bf16 pieces), within ``F32_E2E_TOL`` of the
   plain path, and its f32 loss and
   grads, whose backward takes B14's and B13's CUDA-core t_gemv_kernel,
   within ``F32_GRAD_TOL`` of the plain path's (the launches of those
   kernels' lines).
3b. Gradients at full width and depth 2, bf16, 2 x 128 tokens: the loss and
   every trainable leaf's grad of the kernel path against the plain path
   for int4g32, int8 and int8 with dynamic int8 activations over three
   seeds, and a planted backward bug (B14 reading the next group's scale,
   B13 its neighbour column's) that must exceed the limit.
4. The first slice at full size: ChatGLM2-6B (28 layers) int4g32 with
   random weights built on the card, 4 right-padded requests through
   prefill and 32 greedy decode steps plus one top-p request, with every
   kernel's launch count from that run (a decode step: 169 launches of B1's
   split-K kernel, none of its gemv), the decode replayed from a captured
   CUDA graph (``decode_program``) with greedy and top-p tokens equal to the
   eager loop's (``cuda_graphs=False``); then prefill and decode timings at
   batch 1 and 4 in turns: eager, captured, captured ``decode_attn_v2``
   (B12) twice, captured, eager; and where a batch-1 decode step's time goes
   (torch.profiler's device time by kernel, ``decode_attn_kernel``'s and
   ``int4_splitk_mma_kernel``'s apart, no ``splitk_reduce_kernel``;
   cProfile's host time by function), and a 1 x 128 and a 4 x 128 prefill
   traced the same way, ``int4_wgmma_kernel``'s 168 launches apart.  Then
   the prefill program of a bucket (``prefill_program``) captured against
   the same program run eagerly (``cuda_graphs=False``) at 1 x 128, 4 x 128
   and a 57-token prompt (bucket 64), in turns: logits and valid cache
   slots bit-equal, launches equal; ms a call (warm-up, capture, replays)
   and the device ms of an eager call and a replay.
5. The chat entry point at full size: ChatGLM2-6B (28 layers) int8, then
   int8 with dynamic int8 activations, then int4g32 with dynamic int8
   activations, then int4g32, each through ``GLMDecoder.generate`` (greedy,
   a chat prompt, 32 tokens) with a tokenizer built in process whose every id
   below 65024 is a text piece or a special token; the text must equal
   the model-level text of ``prefill`` + ``multi_step_decode`` on the same
   ids and the eager decoder's (``cuda_graphs=False``), its decode step
   replayed from a graph; the decoder's ms a token and decode ms/step at
   batch 1, each in turns (eager, captured, captured, eager); in int4g32
   also ``speculative_k=4``, its verify step captured, with the eager
   speculative decoder's text (a verify step attends through B5's chunked
   form, so its greedy tokens may leave the plain decode's at a near-tie:
   the characters they share are printed).  A traced batch-1
   decode step: its split-K matmul kernel's device ms (``DECODE_KERNELS``:
   169 launches a step) apart, no ``splitk_reduce_kernel``; in int8 a
   traced 4 x 128 prefill, ``int8_wgmma_kernel``'s 168 launches apart; in
   int8+dyn and int4g32+dyn a traced prefill of the chat prompt (and in
   int8+dyn a 4 x 128 one), ``dyn_wgmma_kernel``'s 168 launches and the
   quantize prologue's device ms apart.  Then a round trip at 6B widths,
   depth 2: ``save_pretrained`` → ``GLMDecoder.from_pretrained``
   for int8 and int4g32, with identical tensors and equal logits.  Each
   mode's time to first token (its bucket's prefill program replayed)
   against the eager decoder's, in turns.  After int4g32, the same decoder
   over a float8_e4m3fn cache (``chat_fp8``): captured = eager text; every
   token within ``GREEDY_GAP_TOL`` of the plain path (``use_kernels=False``)
   over an fp8 cache; the first decode step's logits within JAX's 0.15 of
   max|logits| of the bf16 cache's; ms a token beside the bf16 decoder's, in
   turns.  After int8 and int4g32, the same tree as a float16 checkpoint
   loads it (``chat_f16``, ``f16_tree``) under a float16 config: captured =
   eager text, the f16 forms launched, every token within
   ``GREEDY_GAP_TOL`` (dynamic int8: ``F16_DYN_GAP_TOL``) of the plain path
   in f16, the first decode step's
   logits against the bf16 model's (a reading), ms a token beside the bf16
   decoder's in turns, and (int4g32) one f16 step through B12; the same
   under dynamic int8 (int8 + dyn, int4g32 + dyn) and int4g32
   over an fp8 cache, ``F16_NEW_TOKENS`` tokens each.  Last, the
   launch path (``launcher_f16``): a 2-layer float tree at 6B widths saved
   as a float16 checkpoint, ``examples/quantize_naive`` to int4g32, and
   ``GLMDecoder.from_pretrained`` generating through the f16 kernels.
   And the tree as a float32 checkpoint loads it under a float32 config
   (``chat_f32``): int4g32 and int8 over an f32 cache, int4g32 over fp8,
   ``F32_NEW_TOKENS`` tokens each: captured = eager = ``prefill`` +
   ``multi_step_decode`` text, the f32 attention forms launched and one f32
   step through B12, every token within ``GREEDY_GAP_TOL`` of the plain
   path in f32, ms a token and the prompt's prefill ms beside the bf16
   decoder's in turns.
6. The serving engines at full size: ChatGLM2-6B (28 layers) int4g32 with
   random weights, no tokenizer (eos id 2), token-id prompts from a seeded
   generator.  (a) ``PagedServingEngine`` with 256-token chunked admission
   and the prefix cache: six greedy requests of 300-1100 tokens, four
   sharing a 512-token head, and one top-p request, 64 new tokens each;
   (b) the paged engine with whole-prompt admission and in-loop speculation
   (k = 8) on three prompts repeating a 40-token span, and the same without
   speculation (the tokens they share are reported); (d) the paged engine
   with ``speculative_k=8`` and ``speculative_sampled`` on a mixed batch of
   (b)'s prompts, two greedy rows and two at temperature 0.8 / top-p 0.8,
   captured then eager: the greedy rows must give (b)'s tokens and the
   captured sampled rows the eager run's on the same seed, tokens/s and
   accepted drafts beside (b) and (b'); (c) the dense ``ServingEngine`` with
   chunked admission and lookahead on four of (a)'s prompts.  Checks: every request finishes within its budget; no page in
   use after the drain and every usable page free after
   ``clear_prefix_cache()``; prefix hits in (a); each kernel launched by the
   run that should drive it, and B3/B4 never by the paged runs; every
   emitted greedy token is within ``GREEDY_GAP_TOL`` of the argmax of the
   dense, unpaged, unchunked ``prefill_chunk`` over prompt + stream (its
   logits in f32; the bf16 readings are printed beside), and the stream
   shifted by one token is not.  Printed per run: time to first
   token per request, aggregate tokens/s, and the device's busy share of
   one decode chunk, with its device ms a decode step (in (b) a verify
   step), the paged attention kernels' and B1's split-K kernel's share and
   the three largest kernels; in (a) also one chunk step (four 256-token
   prompt chunks, 1024 rows) split into device and host time, with B1's
   Hopper kernel apart.  Every decode chunk replays captured programs (one
   a compact batch; (b)'s speculation steps too), and so do the prefill
   chunks of (a) and (c) (a program a (rows, chunk) shape); each run is
   driven again from eager launches (``cuda_graphs=False``), its greedy
   tokens equal, with its tokens/s, time to first token and (a), (c) busy
   share, and (a), (c) one chunk step's (captured and eager).  Then over an
   fp8 pool (``engines_fp8``): (a8) run (a)'s engine and requests, (b8) the
   speculative engine with chunked admission on (b)'s prompts (its verify
   through B11): page accounting, the fp8 forms launched, the greedy rule
   against the dense ``prefill_chunk`` over an fp8 cache, tok/s and the
   busy share.  Last, the long-context step (``long_context_fp8``): batch 32
   over an 8192-slot cache at lengths near 8000, random K/V written through
   the store, the captured step over a bf16 cache, an fp8 cache and an fp8
   cache under ``decode_attn_v2``, timed in turns, each traced for its device
   ms and the decode attention's share.  Then (a16) (``engines_f16``): (a)'s
   engine and requests under a float16 config over an f16 pool, its greedy
   tokens against the dense ``prefill_chunk`` in f16; and (a16f8), the same
   over an fp8 pool, ``F16_NEW_TOKENS`` a request.  Then the float32 runs
   (``engines_f32``: 40-72-token prompts, 16-row pages, ``F32_NEW_TOKENS``
   a request): (a32) chunked admission through the prefix cache and (b32)
   in-loop speculation (k = 4, the verify through B11) over an f32 pool,
   (a32f8) and (b32f8) the same over an fp8 pool: page accounting, prefix
   hits, the f32 forms launched, every greedy token against the dense
   ``prefill_chunk`` in f32.
7. Fine-tuning at full size through the frozen quantized weights
   (``utils/train.py``): ChatGLM2-6B (28 layers) int4g32, AdamW (lr 1e-3)
   over the 233,472 f32 norm values, 4 steps on one seeded batch of 2 x 512
   tokens (the first 64 labels ignored): a falling loss, 169 B1 and 169 B14
   launches a step, the first step's loss and grads again with
   ``remat_layers`` within phase 3b's limits, a 16-token sample (the
   split-K B14: its grads against the plain path within SHORT_LOSS_TOL /
   SHORT_GRAD_TOL, then 4 steps eager, captured and replayed, a replay
   traced by kernel),
   every frozen leaf bit-unchanged; then the int8 tree for 3 steps (B6 and
   B13) and its 16-token sample (the split-K B13).  ms and tokens/s a step, peak device memory, and
   for each tree a traced step's device time by kernel, with its forward
   and backward Hopper kernels' shares (B1 and B14, B6 and B13).  Then the
   training step as a program captured on its second call against the same
   program run eagerly, both with capturable AdamW from the same start, 4
   steps in turns: losses and leaves bit-equal, ms a step, peak memory.
   Then each tree in float16 (``f16_fine_tune``, the frozen leaves as a
   float16 checkpoint loads them): at 2 x 512 tokens (the Hopper B13 / B14
   in f16) and 1 x 16 (the split-K ones) the loss and grads against the
   plain path within ``F16_TRAIN_TOL`` and, the forward fixed, against the
   plain backward within ``F16_BWD_TOL``, and the step
   program captured against eager over ``F16_TRAIN_STEPS`` steps, losses
   and leaves bit-equal.

8. Tensor-parallel serving at full width: an 8-layer int4g32 tree (28 layers
   under ``--nccl``; ``SHARD_LAYERS``) built
   once, saved under the build directory and memory-mapped by two spawned
   ranks of a (1, 2) mesh (gloo, both on this card), each taking its slice
   (``shard_params``).  (a) ``DistributedServingEngine`` with ``kv_shard_t``
   (an 8192-slot cache, 4096 a rank): five prompts of 512-4200 tokens
   through ring prefill, the longest crossing into rank 1's slots; (b) ``DistributedPagedServingEngine(
   shard_model_pages=True)``, pages of 256 split by phase, chunked
   admission with the prefix cache: phase 6 (a)'s six greedy prompts; 32
   greedy tokens each.  Checks: the ranks token-equal, every request within
   its budget, K1 / K2 and K3 launched once a layer a decode step on each rank
   and the unsharded decode forms never, every shard the traffic reaches
   live in the decode merges on every rank, every greedy token within
   ``GREEDY_GAP_TOL`` of the single-device dense ``prefill_chunk``
   reference (phase 6's ``greedy_gaps``) and the shifted stream not.  Then
   decode-only steps on four 256-token prompts: ms a decode step, the
   collectives it runs and the host ms in them, per rank (gloo through the
   host on one card: a correctness run, not a multi-GPU speed figure).
   Then 8 tokens a request of: in-loop speculation (k = 8) on phase 6
   (b)'s prompts and two short cycles (32 tokens, rows whose drafts the
   random tree accepts: each run must accept some), greedy (c, e) and a
   mixed batch with two sampled rows (d, f), on the model-sharded pool (c,
   d) and the data-sharded one (e, f); (g)
   the dense engine with ``lookahead`` on a T-sharded cache; and the API
   server on rank 0 (``follow`` on the others) answering a chat, its SSE
   stream and a stop string (12 tokens) with the engine's own greedy text.
   The ranks token-equal in every run, the verify steps through the
   attention their pool takes, every greedy token within ``GREEDY_GAP_TOL``
   of the same reference.
   (a8) and (b8): (a) and (b) over an fp8 cache and pool with chunked
   admission, 16 tokens a request: the ranks token-equal, K1 / K2 and K3 fp8
   forms once a layer a decode step, the greedy rule against the fp8-cache
   reference; (a32), (b32), (a32f8), (b32f8): the same under a float32
   config (48-80-token prompts) over an f32 and an fp8 cache and pool, the
   f32 (fp8_f32) forms once a layer a decode step.
   Phase 2 holds K1 (a T-shard), K2 (each phase of a strided table) and K3
   (dense and paged, bit for bit) against their plain versions, the
   shards merged against the unsharded function in f32 within the
   roundings the design allows (``hold_merge``).  Over gloo the mesh
   decodes from eager launches (gloo's collectives cannot be captured);
   under ``--nccl`` each run's decode chunks are captured, and the run is
   driven again from eager launches: the same tokens on every rank, ms a
   decode step of both.
9. The OpenAI-style API server at full size: ``GLMAPIServer`` on a 28-layer
   int4g32 ``PagedServingEngine`` (whole-prompt admission) with phase 5's
   tokenizer, on localhost: a chat completion, the same streamed, a text
   completion, a stop string, ``n = 2`` and ``/metrics``; every greedy
   text equals the engine's own
   ``run`` of the same prompts, and the decode chunks replay captured
   programs.
10. The quantizers at 6B widths, depth 2, on a random float32 tree that
   ``models.chatglm2.init_params`` builds on the card, calibrated on 8
   prompts of the synthetic corpus (examples/data.py) of at most 128
   tokens, tokenized by phase 5's tokenizer.  GPTQ's column-sweep kernel
   (``csrc/gptq.cu``, int8 and int4g32 forms) against its plain version
   (the per-column loop) at the seven linears (layer 0's six, on their
   calibration Hessians, and the lm_head at N = 65024): the fraction of
   integer grid points apart, max |Δscale| and the relative Δloss, each
   within ``SWEEP_*_TOL`` (0: bit-equal), and a control without the
   in-block error feedback beyond them; per linear the kernel's and the
   plain loop's sweep seconds, the Cholesky / H⁻¹ and the Hessian
   accumulation, one block's kernel ms against its bound, and the estimate
   for 28 layers.  Then ``gptq_quantize_model`` (one sweep launch a
   128-column block) and ``rtn_quantize_model`` in int8 and int4g32:
   GPTQ's output MSE on the calibration activations below RTN's at all 13
   linears; each tree saved as a float16 checkpoint and loaded back, every
   tensor the tree's value as float16 stores it; the ppl protocol
   (examples/ppl.py) on 8 other texts for the float tree and the four
   quantized ones, through the kernels and the plain path, their logits
   within ``E2E_TOL``; and 16 greedy tokens of the GPTQ int4g32 checkpoint
   through ``GLMDecoder`` from a captured decode step, the eager decoder's
   text.  ``--quant`` runs this phase alone, then GPTQ int4g32 of a random
   float32 ChatGLM2-6B at 28 layers, its wall seconds: the offline cost a
   user pays.

11. Training across ranks at ChatGLM2-6B widths, 4 layers, bf16, 2 x 256
   tokens (labels -100 on each row's first 32 / 96), int4g32 and int8 over
   three seeds, each tree built from its seed on every card: (a) the
   sharded training step (``utils/train.py`` with a mesh) on a (1, 2) mesh
   of two gloo ranks sharing the card: the first pass's loss and grads and
   two AdamW steps (lr 1e-3) against the single-process port's on the same
   tree and batch (``TM_TOL``), with a control (a ``gather_from_model``
   whose backward sums over the model axis) beyond the limit; (b) the
   int4g32 trees through 2 GPipe stages of 2 micro-batches
   (``parallel/pipeline.py``) over the same ranks, likewise, with a control
   (the output gradient summed over the stages); (c) the first int4g32
   tree's slices saved from the mesh (``utils/dist_ckpt.py``), loaded onto
   the mesh and whole in this process, both bit-equal to ``shard_params``.
   Every rank the same loss; each rank's B1 / B6 forward and B13 / B14
   backward launches (6 a layer and the lm_head's, a pass); step ms,
   collectives and their host ms per rank, peak device memory.  Under
   ``--nccl 4`` phase 11 runs on four cards: a (2, 2) mesh and 4 stages.

12. The plan table, the export and the launchers: (a) with the packaged
   table (``{}``) every plan at the main path's shapes is the built-in one;
   a sweep of B1's q_proj at M = 1 and 128 (``utils/autotune_sweep.py``)
   recorded into a table of its own, the recorded plan and another exact
   one reaching the launch (the launch's arguments read), within
   ``KERNEL_TOL`` and ``SUM_TOL``; an invalid entry raising.  (b)
   ``torch.export`` of the decode step at 6B widths, depth 2, int4g32 and
   int8: the reloaded program's logits, lengths and caches bit-equal to the
   eager step's, through the kernels' custom ops.  (c) ``engine_demo``,
   ``cli_chat`` (questions piped in) and ``api_server`` (one chat over
   HTTP) each in a process of their own, over a saved 2-layer checkpoint.
   (d) ``convert_weight`` on a synthetic 2-layer HF checkpoint, the result
   loaded.

The last lines are ``detail:`` and every measured row as one JSON object,
the ``kernels`` JSON object (the matmul entries also name their CUDA kernel), the
nvidia-smi line of the card, and ``{"ok": true, "device": {...}}``.
"""
import json
import math
import pathlib
import subprocess
import sys
import time

# H100 SXM published peaks (NVIDIA data sheet; dense, at the 700 W limit)
PEAK_BF16_FLOPS = 989e12
PEAK_INT8_OPS = 1979e12
PEAK_HBM_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12  # outside the tensor cores: the CUDA-core kernels' f32 rows

# bf16 output tolerance of a kernel against its plain version, as a fraction
# of max|plain|: both sum exact products in f32 and differ only in order, so
# the outputs differ by about one bf16 rounding (2^-8 = 3.9e-3 relative).
KERNEL_TOL = 1e-2
F32_TOL = 1e-5  # f32 outputs: the order of f32 sums alone
# The Hopper matmuls (B1 above 64 rows, B6, B13, B14) are also held to the
# card tests' bound on B1's kernels: every output within SUM_TOL of the sum
# of its terms' magnitudes (f64) of its exact value beyond half a bf16 ulp,
# i.e. an f32 sum of exact products, one rounding to bf16.
SUM_TOL = 2.0 ** -23
# The f32 parity forward (phase 3) at depth 2 through B1's f32 form (the
# CUDA-core gemv before the split-bf16 Hopper form) against the plain
# path: f32 sums in another order, carried through two layers of norms,
# attention and six linears.  On an H100 it read 1.35e-6 through the gemv,
# the wrong-scale control 2.0e-1.
F32_E2E_TOL = 1e-5
# The same forward's f32 loss and grads (every trainable leaf; the backward
# through B13's / B14's CUDA-core t_gemv_kernel) against the plain path's,
# |Δloss| / |loss| and max |Δgrad| / max |grad|: f32 sums in another order.
# On an H100 int4g32 read 8.2e-8 / 2.66e-6, int8 0 / 2.73e-6.
F32_GRAD_TOL = 1e-5
# B12 keeps p in f32 through PV (two bf16 fragments, ~16 bits of p), which
# KERNEL_TOL cannot tell from B4's p rounded to bf16: both sit under one
# bf16 rounding of the output.  So B12 is also held to the error beyond
# that rounding (``beyond_rounding``) against its plain version in f32, and a
# control on the same inputs, B12's function with p rounded to bf16 (what
# the kernel gives without its second fragment), must exceed the limit.  On
# an H100 the kernel read 3.3e-8 to 4.2e-7 over the main shape and the edge
# cases, the control 1.6e-4 to 4.4e-4, and the kernel with its second
# fragment deleted 1.7e-4 to 3.7e-4; the limit sits about 20x from each side.
B12_TOL = 1e-5
# B10 (paged decode) and B11 (chunk attention over the pool) keep p in f32
# the same way, and are held the same way, each to a limit of its own near
# the geometric mean of its two sides.  On an H100 B10 read 4.6e-8 to
# 4.3e-7 over the main shape and the edge cases, its control 1.29e-4 to
# 1.70e-4 (about 17x from each side); B11 read 7.3e-7 to 1.34e-6, its
# control 1.55e-4 to 8.9e-4 (about 11x and 10x: its sums over spans leave
# less room).
B10_TOL = 7.5e-6
B11_TOL = 1.5e-5
# End-to-end tolerance (phase 3), as a fraction of max|logits| over two
# layers of bf16 activations, on the unit-gain random tree of
# ``bench.random_quantized_params``.  Weight-only: about 3x one kernel
# output's bf16 rounding carried through norms, attention and seven linears
# per layer.  Under dynamic int8 every linear's input is rounded to 8 bits
# per row (a step of 1/127 of the row's max|x|), and a one-ulp bf16
# difference upstream can move an activation by a whole step, so two
# correct paths sit about 4x further apart.  The largest
# readings over seeds 21-23 on an H100 were 9.95e-3 and 4.04e-2; each limit
# is about 1.5x that.  Each mode's run also plants a control bug that must
# exceed its limit (readings 2.7e-2 to 2.0e-1).
E2E_TOL = 1.5e-2
E2E_DYN_TOL = 6e-2
# Phase 3b (gradient parity, 6B widths, depth 2, bf16): |Δloss| / |loss| and,
# over the trainable leaves, max |Δgrad| / max |grad| of the kernel path
# against the plain path.  The forward kernels round each linear's output to
# bf16 at another place than the plain path, and the backward carries that
# through two layers: the largest readings over GRAD_SEEDS on an H100 were
# 3.9e-5 (loss) and 1.21e-2 (grads); each limit is about 1.5x that.  The
# planted backward bugs read 3.2e+2 to 2.2e+3.
GRAD_LOSS_TOL = 6e-5
GRAD_TOL = 1.8e-2
# Phase 7's 16-token sample at 28 layers, the same readings: the kernel
# path's bf16 roundings, at other places than the plain path's, carried
# through 28 layers instead of 2.  Over seeds 71-73 of a 28-layer tree
# (``--short-seeds``) the largest on an H100 were 4.656e-4 (loss, int4g32
# seed 72) and 3.830e-2 (grads, int8 seed 72); each limit is about 1.5x
# that.
SHORT_LOSS_TOL = 7e-4
SHORT_GRAD_TOL = 5.8e-2

MATMUL_SHAPES = [  # (name, K, N) at storage sizes; kv_proj outputs 2 * kv_size
    ("q_proj", 4096, 4096), ("kv_proj", 4096, 512), ("o_proj", 4096, 4096),
    ("w_in_h/w_in_gate", 4096, 13824), ("w_out", 13824, 4096), ("lm_head", 4096, 65536),
]
# decode at batch 1 and 4; the split-K kernel's 2-, 3-, 4-, 5- and 6-tile forms
# (36: a verify step, 4 rows x (k + 1) = 9); the Hopper kernel at a 1 x 128
# prefill, a 4 x 128 prefill and a 4 x 256 engine chunk or 2 x 512 training
# step.  The split-K kernel's 8-tile form: M = 64 in SPLITK_CROSSOVER_M.
MATMUL_M = (1, 4, 16, 20, 32, 36, 48, 128, 512, 1024)
SPLITK_CROSSOVER_M = (16, 32, 64)  # B1's split-K kernel against its prefill kernel: SMALL_M_MAX
# B7 rows: decode, batch 4 (the split-K gemv), then its Hopper kernel at the
# int4-dyn ceiling (M = 57-64: a chat prompt), a 1 x 128 prefill, a 4 x 128
# prefill and a 4 x 256 chunk step; B8 rows: decode, batch 4, then its Hopper
# kernel at 32, 48 and 64 rows (where int4g32 + dyn takes it) and 512 for the
# record (above the ceiling the main path takes B1)
B7_M = (1, 4, 64, 128, 512, 1024)
B8_M = (1, 4, 32, 48, 64, 512)
CROSSOVER_M = (32, 64, 128)  # B8 against B1 around _INT4_DYN_M_MAX = 64
# B13/B14 rows: the Hopper kernel at a 4 x 128 batch and at training's M =
# 1024; the split-K tensor-core kernel at a 1- and a 4-token step and at
# phase 7's 16-token step (bf16, M = 16: the row the kernels line reports);
# the CUDA-core kernel in f32
T_ROWS = ((512, "bfloat16"), (1024, "bfloat16"), (1, "bfloat16"), (4, "bfloat16"),
          (16, "bfloat16"), (8, "float32"))
PROMPT_LENGTHS = (128, 77, 33, 5)
INT4_PATH_KERNELS = ("int4g32_splitk", "int4g32_mma", "rope_kv_append",
                     "flash_attention_decode", "flash_attention_prefill")
# phase 5: each mode and the kernels its GLMDecoder.generate run must launch
# (the chat prompt has 16 < S <= 64 tokens: the tensor-core kernels run in
# prefill, the split-K ones in decode, and int4g32 + dyn stays on B8)
CHAT_MODES = [("int8", False, ("int8_splitk", "int8_mma")),
              ("int8", True, ("int8_dyn_splitk", "int8_dyn_mma")),
              ("int4g32", True, ("int4_dyn_splitk", "int4_dyn_mma")),
              ("int4g32", False, ("int4g32_splitk",))]  # its 57-token prefill: split-K too
SPEC_K = 4  # phase 5's speculative GLMDecoder run (int4g32)
# each decode mode's split-K matmul kernel, as the profiler names it: (label,
# substrings of its name)
DECODE_KERNELS = {
    "int4g32": ("B1 int4_splitk_mma_kernel", ("int4_splitk_mma_kernel",)),
    "int8": ("B6 int8_splitk_mma_kernel", ("int8_splitk_mma_kernel",)),
    "int8+dyn": ("B7 dyn_splitk_mma_kernel<Int8DynSkView>", ("dyn_splitk_mma_kernel",
                                                              "Int8DynSkView")),
    "int4g32+dyn": ("B8 dyn_splitk_mma_kernel<Int4DynSkView>", ("dyn_splitk_mma_kernel",
                                                                 "Int4DynSkView")),
}
CHAT_QUESTION = "Hello, who are you?"
CHAT_TOKENS = 32
CACHE_LEN = 1024


def log(msg):
    print(msg, flush=True)


class SmokeFailure(RuntimeError):
    pass


def require(cond, msg):
    """A check that stays under ``python -O`` (unlike ``assert``)."""
    if not cond:
        raise SmokeFailure(msg)


def nvidia_smi_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True)
    return res.stdout.strip().splitlines()[0]


def rel_err(a, b) -> tuple[float, float]:
    """(max |a - b|, that over max |b|)."""
    d = (a.float() - b.float()).abs().max().item()
    return d, d / max(b.float().abs().max().item(), 1e-30)


def copy_bandwidth(torch) -> float:
    """Bytes/s of a 2 GiB device-to-device copy (read + write counted)."""
    from chatglm_q_tpu_torch.utils.timing import cuda_event_ms

    n = 2 << 30
    src = torch.empty(n, dtype=torch.uint8, device="cuda")
    dst = torch.empty_like(src)
    ms = cuda_event_ms(lambda i: dst.copy_(src), iters=10, warmup=2)
    del src, dst
    return 2 * n / (ms * 1e-3)


def bound_ms(nbytes, ops, peak=PEAK_BF16_FLOPS):
    """The least time for the work: each input byte read once and each
    output byte written once over the HBM peak, or the operations over the
    tensor-core peak of their type (bf16 by default, ``PEAK_INT8_OPS`` for
    s8 products), whichever is larger; and which of the two it is."""
    t_bytes = nbytes / PEAK_HBM_BYTES_PER_S * 1e3
    t_ops = ops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def beyond_sum(torch, got, exact, terms, bits=8) -> float:
    """The largest error of a bf16 output (``bits`` significant bits: bf16
    8, f16 11) beyond half an ulp of its exact value (f64), over the sum of
    its terms' magnitudes (f64)."""
    half_ulp = torch.ldexp(torch.ones_like(exact), torch.frexp(exact).exponent - (bits + 1))
    excess = ((got.double() - exact).abs() - half_ulp).clamp_min(0.0)
    return (excess / terms.clamp_min(1e-300)).max().item()


def hold_sum(torch, name, got, exact, terms, bits=8) -> float:
    b = beyond_sum(torch, got, exact, terms, bits)
    require(b <= SUM_TOL, f"{name}: error beyond the output's rounding {b:.3e} of sum|terms| "
                          f"> {SUM_TOL:.3e}")
    return b


def weight_copies(wbytes):
    """Enough copies of one weight to exceed the 50 MB L2: decode reads the
    weights cold."""
    return max(2, min(64, math.ceil(160e6 / wbytes)))


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def tinygemm_weights(torch, packed, scale):
    """One int4g32 weight (packed (K/2, N) tpu order, scale (K/32, N)) in the
    layout of ``torch._weight_int4pack_mm``, which dequantizes an unsigned
    nibble q as (q - 8) * scale + zero.  A two's-complement nibble s is
    q = s + 8 = s ^ 8, and zero = 0; its input packs (N, K/2) bytes with the
    even K row in the high nibble."""
    K2, N = packed.shape
    q = torch.stack((packed & 0xF, packed >> 4), dim=1).reshape(2 * K2, N) ^ 8  # (K, N)
    qt = q.t().contiguous()
    w = torch.ops.aten._convert_weight_to_int4pack((qt[:, ::2] << 4) | qt[:, 1::2], 8)
    return w, torch.stack((scale, torch.zeros_like(scale)), dim=-1).contiguous()


def library_weights(torch, packed, scale):
    """The rotated copies of one weight in tinygemm's layout, or None (and a
    line that says why) where this torch build has no such call for them."""
    if not hasattr(torch.ops.aten, "_weight_int4pack_mm"):
        log("    library: this torch has no _weight_int4pack_mm")
        return None
    try:  # the yardstick only: the port never calls it
        return [tinygemm_weights(torch, p, s) for p, s in zip(packed, scale)]
    except RuntimeError as e:
        log(f"    library: _convert_weight_to_int4pack refused {tuple(packed.shape[1:])}: "
            f"{str(e)[:200]}")
        return None


def int4_library(torch, x, lib_w, want):
    """ms of ``torch._weight_int4pack_mm`` over the rotated weights ``lib_w``,
    after checking that it computes the plain version's function; None where
    there are no such weights or it refuses this M."""
    from chatglm_q_tpu_torch.utils.timing import cuda_event_ms

    if lib_w is None:
        return None
    mm = torch.ops.aten._weight_int4pack_mm
    try:
        got = mm(x, lib_w[0][0], 32, lib_w[0][1])
    except RuntimeError as e:
        log(f"    library: _weight_int4pack_mm refused M={x.shape[0]}: {str(e)[:200]}")
        return None
    rel = rel_err(got, want)[1]
    require(rel <= KERNEL_TOL, f"_weight_int4pack_mm disagrees with the plain version: {rel}")
    n = len(lib_w)
    return cuda_event_ms(lambda i: mm(x, lib_w[i % n][0], 32, lib_w[i % n][1]), iters=30)


def dyn_hopper_extras(torch, r, x, w_deq, plan):
    """A dynamic-int8 Hopper row's plan and cuBLAS's dense bf16 product on
    the dequantized weights (a yardstick of the tensor cores, another
    function); logged by log_row."""
    from chatglm_q_tpu_torch.utils.timing import cuda_event_ms

    r["plan"] = plan
    r["dense_ms"] = cuda_event_ms(lambda i: x @ w_deq, iters=30)


def log_row(fn, r):
    lib_s = "none" if r["library_ms"] is None else f"{r['library_ms']:.4f} ms"
    call_s = f"  call {r['call_ms']:.4f} ms" if "call_ms" in r else ""
    x_s = f" {r['x_dtype']}" if "x_dtype" in r else ""
    log(f"  {fn:15s} {r['linear']:17s} M={r['M']:4d}{x_s} K={r['K']:5d} N={r['N']:5d} "
        f"[{r['kernel']}] rel_err {r['rel_err']:.2e}  {r['ms']:.5f} ms{call_s}  bound "
        f"{r['bound_ms']:.5f} ms ({r['bound_by']})  plain {r['plain_ms']:.3f} ms  library {lib_s}")
    beyond = (f"; beyond the bf16 rounding {r['beyond_sum']:.2e} of sum|terms|"
              if "beyond_sum" in r else "")
    if r["kernel"] in ("int8_dyn_mma", "int4_dyn_mma"):
        log(f"    plan (bm, nsplit, stages/split, blocks) {r['plan']}; dense x @ w_deq (cuBLAS, "
            f"bf16 weights, a yardstick) {r['dense_ms']:.5f} ms{beyond}")
    elif r["kernel"] in ("int8_dyn_splitk", "int4_dyn_splitk"):
        log(f"    plan (m-tiles, cols, nsplit, groups/split, groups/chunk) {r['plan']}{beyond}")


B1_KERNELS = {"splitk": "int4g32_splitk", "mma": "int4g32_mma", "gemv": "int4g32_gemv"}
# the CUDA kernels behind the matmul wrappers of B1, B6, B7, B8, B13 and
# B14, named in the kernels line (the split-K kernels' body, sk_body, and
# t_wgmma_kernel's are csrc/common.cuh's)
CUDA_KERNEL = {"int4g32_splitk": "int4_splitk_mma_kernel", "int4g32_mma": "int4_wgmma_kernel",
               "int4g32_gemv": "int4_gemv_kernel", "int8_mma": "int8_wgmma_kernel",
               "int8_gemv": "int8_gemv_kernel", "int8_splitk": "int8_splitk_mma_kernel",
               "int8_dyn_mma": "dyn_wgmma_kernel<Int8DynView>",
               "int4_dyn_mma": "dyn_wgmma_kernel<Int4DynView>",
               "int8_dyn_splitk": "dyn_splitk_mma_kernel<Int8DynSkView>",
               "int4_dyn_splitk": "dyn_splitk_mma_kernel<Int4DynSkView>",
               "int4g32_t_splitk": "t_splitk_mma_kernel<Int4TView> (csrc/common.cuh)",
               "int8_t_splitk": "t_splitk_mma_kernel<Int8TView> (csrc/common.cuh)",
               "int4g32_t_mma": "t_wgmma_kernel<Int4TView> (csrc/common.cuh)",
               "int4g32_t_gemv": "t_gemv_kernel<Int4TView> (csrc/common.cuh)",
               "int8_t_mma": "t_wgmma_kernel<Int8TView> (csrc/common.cuh)",
               "int8_t_gemv": "t_gemv_kernel<Int8TView> (csrc/common.cuh)",
               "rope_kv_append": "rope_kv_append_kernel<DenseKV, true>",
               "rope_kv_append paged": "rope_kv_append_kernel<PagedKV, true>",
               "gptq_sweep_int8": "gptq_sweep_kernel<false>",
               "gptq_sweep_int4": "gptq_sweep_kernel<true>",
               "split_bf16x3_pass": "split_bf16x3_kernel"}


def check_matmul(torch):
    """B1/B2 (int4g32 weight-only: bf16 rows, and an f32 M = 1 row for the
    CUDA-core gemv) and B8 (int4g32 with dynamic int8 activations) on the
    same int4 weights; B1's split-K kernel against its prefill kernel at
    SPLITK_CROSSOVER_M (the crossover SMALL_M_MAX stands for); the B8/B1
    crossover."""
    from chatglm_q_tpu_torch.ops import dyn_matmul as D
    from chatglm_q_tpu_torch.ops import quant_matmul as QM
    from chatglm_q_tpu_torch.ops.quant import unpack_int4_tpu
    from chatglm_q_tpu_torch.utils.timing import cuda_event_ms

    gen = torch.Generator(device="cuda").manual_seed(11)
    rows, crossover, splitk_crossover = [], [], []
    log("    B8 library: none (no PyTorch call quantizes activations per row and takes "
        "s8 dots with int4 group-32 weights)")
    for name, K, N in MATMUL_SHAPES:
        wbytes = K // 2 * N + K // 32 * N * 2
        copies = weight_copies(wbytes)
        packed = torch.randint(0, 256, (copies, K // 2, N), dtype=torch.uint8,
                               device="cuda", generator=gen)
        scale = (torch.rand((copies, K // 32, N), device="cuda", generator=gen) * 0.02
                 ).to(torch.bfloat16)
        lib_w = library_weights(torch, packed, scale)
        w_deq = unpack_int4_tpu(packed[0], scale[0]).to(torch.bfloat16)  # dense_ms only
        for M, dtype in [(m, torch.bfloat16) for m in MATMUL_M]:
            x = torch.randn((M, K), device="cuda", generator=gen).to(dtype)
            kernel = B1_KERNELS[QM.int4_route(M, N, dtype)]
            fn = getattr(QM, kernel)
            launched = fn.launches
            got = QM.int4g32_matmul(x, packed[0], scale[0])
            torch.cuda.synchronize()
            require(fn.launches == launched + 1, f"int4g32_matmul {name} M={M}: not one {kernel}")
            want = QM.int4g32_matmul_plain(x, packed[0], scale[0])
            err, rel = rel_err(got, want)
            tol = KERNEL_TOL if dtype == torch.bfloat16 else F32_TOL
            require(torch.isfinite(got).all(), f"int4g32_matmul {name} M={M}: non-finite output")
            require(rel <= tol, f"int4g32_matmul {name} M={M} {dtype}: rel err {rel} > {tol}")
            ms = cuda_event_ms(lambda i: QM.int4g32_matmul(x, packed[i % copies],
                                                           scale[i % copies]), iters=30)
            plain = cuda_event_ms(lambda i: QM.int4g32_matmul_plain(x, packed[0], scale[0]),
                                  iters=3, warmup=1)
            lib = int4_library(torch, x, lib_w, want) if dtype == torch.bfloat16 else None
            xb = x.element_size()
            b, by = bound_ms(M * K * xb + wbytes + M * N * xb, 2.0 * M * K * N,
                             PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_F32_FLOPS)
            rows.append({"kernel": kernel, "linear": name, "M": M, "K": K, "N": N,
                         "x_dtype": str(dtype).split(".")[-1], "max_abs_err": err,
                         "rel_err": rel, "ms": ms, "plain_ms": plain, "bound_ms": b,
                         "bound_by": by, "library_ms": lib})
            if kernel == "int4g32_mma":
                rows[-1]["dense_ms"] = cuda_event_ms(lambda i: x @ w_deq, iters=30)
                rows[-1]["plan"] = QM.mma_plan(M, K, N)
                w64 = unpack_int4_tpu(packed[0], scale[0]).double()  # q·s, exact in f32
                rows[-1]["beyond_sum"] = hold_sum(torch, f"int4g32_matmul {name} M={M}", got,
                                                  x.double() @ w64, x.double().abs() @ w64.abs())
                del w64
            log_row("int4g32_matmul", rows[-1])
            if kernel == "int4g32_mma":
                log(f"    plan (bm, nsplit, groups/split, blocks) {rows[-1]['plan']}; dense "
                    f"x @ w_deq (cuBLAS, bf16 weights, a yardstick) {rows[-1]['dense_ms']:.5f} ms; "
                    f"beyond the bf16 rounding {rows[-1]['beyond_sum']:.2e} of sum|terms|")
        del lib_w
        for M in SPLITK_CROSSOVER_M:  # both kernels forced on checked inputs
            x = torch.randn((M, K), device="cuda", generator=gen).to(torch.bfloat16)
            want = QM.int4g32_matmul_plain(x, packed[0], scale[0])
            times = {}
            for kernel in ("int4g32_splitk", "int4g32_mma"):
                fn = getattr(QM, kernel)
                rel = rel_err(fn(x, packed[0], scale[0]), want)[1]
                require(rel <= KERNEL_TOL, f"{kernel} {name} M={M}: rel err {rel} > {KERNEL_TOL}")
                times[kernel] = cuda_event_ms(lambda i: fn(x, packed[i % copies],
                                                           scale[i % copies]), iters=30)
            splitk_crossover.append({"linear": name, "M": M, "K": K, "N": N,
                                     "splitk_ms": times["int4g32_splitk"],
                                     "mma_ms": times["int4g32_mma"]})
            log(f"  B1 crossover {name:17s} M={M:4d}: split-K {times['int4g32_splitk']:.5f} ms, "
                f"int4_wgmma_kernel {times['int4g32_mma']:.5f} ms, split-K/wgmma "
                f"{times['int4g32_splitk'] / times['int4g32_mma']:.2f}")
        for M in B8_M:
            x = torch.randn((M, K), device="cuda", generator=gen).to(torch.bfloat16)
            got = D.int4_dyn_matmul(x, packed[0], scale[0])
            torch.cuda.synchronize()
            want = D.int4_dyn_matmul_plain(x, packed[0], scale[0])
            err, rel = rel_err(got, want)
            require(torch.isfinite(got).all(), f"int4_dyn_matmul {name} M={M}: non-finite")
            require(rel <= KERNEL_TOL,
                    f"int4_dyn_matmul {name} M={M}: rel err {rel} > {KERNEL_TOL}")
            xq, sx = D.dyn_quantize_rows(x)
            kfn = D.int4_dyn_mma if D.uses_mma(M, N) else D.int4_dyn_splitk
            ms = cuda_event_ms(lambda i: kfn(xq, sx, packed[i % copies], scale[i % copies],
                                             x.dtype), iters=30)
            call = cuda_event_ms(lambda i: D.int4_dyn_matmul(x, packed[i % copies],
                                                             scale[i % copies]), iters=30)
            plain = cuda_event_ms(lambda i: D.int4_dyn_matmul_plain(x, packed[0], scale[0]),
                                  iters=3, warmup=1)
            b, by = bound_ms(M * K + 4 * M + wbytes + M * N * 2, 2.0 * M * K * N, PEAK_INT8_OPS)
            rows.append({"kernel": kfn.__name__, "linear": name, "M": M, "K": K, "N": N,
                         "max_abs_err": err, "rel_err": rel, "ms": ms, "call_ms": call,
                         "plain_ms": plain, "bound_ms": b, "bound_by": by, "library_ms": None})
            # the exact function: (xq @ q·s) · sx in f64
            w64, s64 = unpack_int4_tpu(packed[0], scale[0]).double(), sx.double()
            rows[-1]["beyond_sum"] = hold_sum(torch, f"int4_dyn_matmul {name} M={M}", got,
                                              (xq.double() @ w64) * s64,
                                              (xq.double().abs() @ w64.abs()) * s64)
            del w64
            if kfn is D.int4_dyn_mma:
                dyn_hopper_extras(torch, rows[-1], x, w_deq, D.dyn_plan(M, K, N))
            else:
                rows[-1]["plan"] = QM.splitk_plan(M, K, N, xbytes=1)
            log_row("int4_dyn_matmul", rows[-1])
        for M in CROSSOVER_M:
            x = torch.randn((M, K), device="cuda", generator=gen).to(torch.bfloat16)
            b8 = cuda_event_ms(lambda i: D.int4_dyn_matmul(x, packed[i % copies],
                                                           scale[i % copies]), iters=30)
            b1 = cuda_event_ms(lambda i: QM.int4g32_matmul(x, packed[i % copies],
                                                           scale[i % copies]), iters=30)
            crossover.append({"linear": name, "M": M, "K": K, "N": N, "b8_ms": b8, "b1_ms": b1})
            log(f"  crossover {name:17s} M={M:4d}: B8 (with its quantize prologue) {b8:.4f} ms, "
                f"B1 {b1:.4f} ms, B8/B1 {b8 / b1:.2f}")
        del packed, scale, w_deq
    return rows, crossover, splitk_crossover


def int8_library(torch, x, w_t, scale_bf16, want, refusal=None, iters=30):
    """ms of ``torch._weight_int8pack_mm`` (x @ w_t (N, K) int8ᵀ · scales in
    x's dtype) over the rotated transposed weights, after checking it
    computes the plain version's function; None where this torch has no
    CUDA implementation for it (its message appended to ``refusal``)."""
    from chatglm_q_tpu_torch.utils.timing import cuda_event_ms

    mm = getattr(torch.ops.aten, "_weight_int8pack_mm", None)
    if mm is None:
        return None
    try:
        got = mm(x, w_t[0], scale_bf16[0])
    except (RuntimeError, NotImplementedError) as e:
        log(f"    library: _weight_int8pack_mm refused M={x.shape[0]} {x.dtype}: {str(e)[:160]}")
        if refusal is not None:
            refusal.append(str(e)[:300])
        return None
    rel = rel_err(got, want)[1]
    require(rel <= KERNEL_TOL, f"_weight_int8pack_mm disagrees with the plain version: {rel}")
    n = len(w_t)
    return cuda_event_ms(lambda i: mm(x, w_t[i % n], scale_bf16[i % n]), iters=iters)


def int_mm_library(torch, xq, w, want_acc):
    """ms of ``torch._int_mm`` (the s8 × s8 → s32 accumulator alone, B7's
    core; it takes more than 16 rows, so xq is zero-padded to 32 rows at
    least), after checking its accumulator is exact; None if it refuses."""
    from chatglm_q_tpu_torch.utils.timing import cuda_event_ms

    M, K = xq.shape
    xp = torch.zeros((max(32, -(-M // 8) * 8), K), dtype=torch.int8, device=xq.device)
    xp[:M] = xq
    try:
        acc = torch._int_mm(xp, w[0])
    except (RuntimeError, NotImplementedError) as e:
        log(f"    library: _int_mm refused M={M}: {str(e)[:160]}")
        return None
    require(torch.equal(acc[:M].double(), want_acc), "_int_mm accumulator differs from plain")
    n = len(w)
    return cuda_event_ms(lambda i: torch._int_mm(xp, w[i % n]), iters=30)


def check_int8_matmul(torch):
    """B6 (int8 weight-only) and B7 (int8 with dynamic int8 activations) on
    the same int8 weights."""
    from chatglm_q_tpu_torch.ops import dyn_matmul as D
    from chatglm_q_tpu_torch.ops import int8_matmul as I8
    from chatglm_q_tpu_torch.ops import quant_matmul as QM
    from chatglm_q_tpu_torch.utils.timing import cuda_event_ms

    gen = torch.Generator(device="cuda").manual_seed(14)
    rows = []
    for name, K, N in MATMUL_SHAPES:
        wbytes = K * N + 4 * N
        copies = weight_copies(wbytes)
        w = torch.randint(-128, 128, (copies, K, N), dtype=torch.int8, device="cuda",
                          generator=gen)
        scale = (0.5 + torch.rand((copies, N), device="cuda", generator=gen)) * 0.01
        w_t = w.transpose(1, 2).contiguous()
        scale_bf16 = scale.to(torch.bfloat16)
        w64 = w[0].double()  # the exact function of the Hopper rows
        w_deq = (w[0].float() * scale[0]).to(torch.bfloat16)  # dense_ms only
        for M, dtype in [(m, torch.bfloat16) for m in MATMUL_M]:
            x = torch.randn((M, K), device="cuda", generator=gen).to(dtype)
            kernel = "int8_" + I8.int8_route(M, N, dtype)
            fn = getattr(I8, kernel)
            launched = fn.launches
            got = I8.int8_matmul(x, w[0], scale[0])
            torch.cuda.synchronize()
            require(fn.launches == launched + 1, f"int8_matmul {name} M={M}: not one {kernel}")
            want = I8.int8_matmul_plain(x, w[0], scale[0])
            err, rel = rel_err(got, want)
            tol = KERNEL_TOL if dtype == torch.bfloat16 else F32_TOL
            require(torch.isfinite(got).all(), f"int8_matmul {name} M={M}: non-finite output")
            require(rel <= tol, f"int8_matmul {name} M={M} {dtype}: rel err {rel} > {tol}")
            ms = cuda_event_ms(lambda i: I8.int8_matmul(x, w[i % copies], scale[i % copies]),
                               iters=30)
            plain = cuda_event_ms(lambda i: I8.int8_matmul_plain(x, w[0], scale[0]),
                                  iters=3, warmup=1)
            refusal = []  # f32: the scales in f32, as the library takes x's dtype
            lib = int8_library(torch, x, w_t, scale_bf16 if dtype == torch.bfloat16 else scale,
                               want, refusal)
            xb = x.element_size()
            b, by = bound_ms(M * K * xb + wbytes + M * N * xb, 2.0 * M * K * N,
                             PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_F32_FLOPS)
            rows.append({"kernel": kernel, "linear": name, "M": M, "K": K, "N": N,
                         "x_dtype": str(dtype).split(".")[-1], "max_abs_err": err,
                         "rel_err": rel, "ms": ms, "plain_ms": plain, "bound_ms": b,
                         "bound_by": by, "library_ms": lib})
            if refusal:
                rows[-1]["library_refusal"] = refusal[0]
            if dtype == torch.bfloat16:  # the split-K and Hopper kernels: exact products
                s64 = scale[0].double()
                rows[-1]["beyond_sum"] = hold_sum(torch, f"int8_matmul {name} M={M}", got,
                                                  (x.double() @ w64) * s64,
                                                  (x.double().abs() @ w64.abs()) * s64)
            if kernel == "int8_mma":
                rows[-1]["dense_ms"] = cuda_event_ms(lambda i: x @ w_deq, iters=30)
                rows[-1]["plan"] = QM.wg_plan(M, K, N)
            elif kernel == "int8_splitk":
                rows[-1]["plan"] = QM.splitk_plan(M, K, N, int8_weights=True)
            log_row("int8_matmul", rows[-1])
            if kernel == "int8_mma":
                log(f"    plan (bm, nsplit, stages/split, blocks) {rows[-1]['plan']}; dense "
                    f"x @ w_deq (cuBLAS, bf16 weights, a yardstick) {rows[-1]['dense_ms']:.5f} ms; "
                    f"beyond the bf16 rounding {rows[-1]['beyond_sum']:.2e} of sum|terms|")
            elif kernel == "int8_splitk":
                log(f"    plan (m-tiles, cols, nsplit, groups/split, groups/chunk) "
                    f"{rows[-1]['plan']}; beyond the bf16 rounding {rows[-1]['beyond_sum']:.2e} "
                    f"of sum|terms|")
        del w_t, scale_bf16, w64
        for M in B7_M:
            x = torch.randn((M, K), device="cuda", generator=gen).to(torch.bfloat16)
            got = D.int8_dyn_matmul(x, w[0], scale[0])
            torch.cuda.synchronize()
            want = D.int8_dyn_matmul_plain(x, w[0], scale[0])
            err, rel = rel_err(got, want)
            require(torch.equal(got, want),
                    f"int8_dyn_matmul {name} M={M}: not bit-exact (max abs err {err})")
            xq, sx = D.dyn_quantize_rows(x)
            kfn = D.int8_dyn_mma if D.uses_mma(M, N) else D.int8_dyn_splitk
            ms = cuda_event_ms(lambda i: kfn(xq, sx, w[i % copies], scale[i % copies],
                                             x.dtype), iters=30)
            call = cuda_event_ms(lambda i: D.int8_dyn_matmul(x, w[i % copies],
                                                             scale[i % copies]), iters=30)
            plain = cuda_event_ms(lambda i: D.int8_dyn_matmul_plain(x, w[0], scale[0]),
                                  iters=3, warmup=1)
            lib = int_mm_library(torch, xq, w, D.int8_dyn_acc_plain(xq, w[0]))
            b, by = bound_ms(M * K + 4 * M + wbytes + M * N * 2, 2.0 * M * K * N, PEAK_INT8_OPS)
            rows.append({"kernel": kfn.__name__, "linear": name, "M": M, "K": K, "N": N,
                         "max_abs_err": err, "rel_err": rel, "ms": ms, "call_ms": call,
                         "plain_ms": plain, "bound_ms": b, "bound_by": by, "library_ms": lib})
            if kfn is D.int8_dyn_mma:
                dyn_hopper_extras(torch, rows[-1], x, w_deq, D.dyn_plan(M, K, N))
            else:
                rows[-1]["plan"] = QM.splitk_plan(M, K, N, xbytes=1, int8_weights=True)
            log_row("int8_dyn_matmul", rows[-1])
        del w, scale, w_deq
    return rows


def reciprocal_split_rows(rows=64, K=4096, seed=5):
    """(rows, K) f32 rows whose max|x| divided by 127 rounds apart from
    max|x| times the f32 reciprocal of 127 (found on the host): on each row
    one element of that magnitude, the rest below it (tests/test_torch_cuda.py
    takes them from here)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    cand = rng.uniform(0.5, 8.0, size=200 * rows).astype(np.float32)  # ~4.6% split
    split = cand[cand * (np.float32(1) / np.float32(127)) != cand / np.float32(127)][:rows]
    x = rng.uniform(-0.4, 0.4, size=(rows, K)).astype(np.float32)
    x[np.arange(rows), rng.integers(0, K, size=rows)] = split * np.where(
        rng.random(rows) < 0.5, -1, 1).astype(np.float32)
    return x


def check_dyn_division(torch, smi):
    """The dynamic row quantizer (B7 / B8's prologue) on the card against the
    CPU, on rows where max|x| / 127 and max|x| · (1/127) round apart: sx and
    xq bit-equal (f32 and bf16 rows); the control, a Python-number divisor
    on the card (a reciprocal product), must differ on them."""
    from chatglm_q_tpu_torch.ops import dyn_matmul as D

    x = torch.from_numpy(reciprocal_split_rows())
    for dtype in (torch.float32, torch.bfloat16):
        xq, sx = D.dyn_quantize_rows(x.to(dtype).cuda())
        xq_cpu, sx_cpu = D.dyn_quantize_rows(x.to(dtype))
        require(torch.equal(sx.cpu(), sx_cpu) and torch.equal(xq.cpu(), xq_cpu),
                f"dyn_quantize_rows {dtype}: the card's sx or xq differ from the CPU's")
    want = x.abs().amax(dim=1, keepdim=True) / 127.0
    control = ((x.cuda().abs().amax(dim=1, keepdim=True) / 127.0).cpu() != want).float().mean()
    require(control > 0.5, f"dyn division control: only {control:.2f} of the rows split")
    log(f"  dyn_quantize_rows on the card equals the CPU bit for bit on {x.shape[0]} rows "
        f"where the reciprocal product rounds apart (the control differs on "
        f"{100 * control:.0f}% of them)  [{smi}]")
    return {"rows": x.shape[0], "control_split_share": control.item()}


def int8_t_library(torch, g, w, scale, want, iters=30):
    """ms of ``torch._weight_int8pack_mm(g * s, w, ones(K))`` over the
    rotated (K, N) weights — its (out, in) layout — with the fold of the
    scale into g timed along with it, after checking it computes the plain
    version's function; None where this torch refuses it."""
    from chatglm_q_tpu_torch.utils.timing import cuda_event_ms

    mm = getattr(torch.ops.aten, "_weight_int8pack_mm", None)
    if mm is None:
        return None
    ones = torch.ones((w.shape[1],), dtype=g.dtype, device=g.device)
    try:
        got = mm(g * scale[0].to(g.dtype), w[0], ones)
    except (RuntimeError, NotImplementedError) as e:
        log(f"    library: _weight_int8pack_mm refused g {tuple(g.shape)} {g.dtype}: "
            f"{str(e)[:160]}")
        return None
    rel = rel_err(got, want)[1]
    require(rel <= KERNEL_TOL, f"_weight_int8pack_mm (B13 yardstick) disagrees: {rel}")
    n = len(w)
    return cuda_event_ms(lambda i: mm(g * scale[i % n].to(g.dtype), w[i % n], ones),
                         iters=iters)


def check_transposed(torch):
    """B13 (``int8_matmul_t``) and B14 (``int4g32_matmul_t``), the backward
    matmuls, at the six main-path shapes transposed (g (M, N) → (M, K)), at
    M = 512 and 1024 bf16 (the Hopper kernel), M = 1, 4 and 16 bf16 (the
    split-K tensor-core kernel; both held to SUM_TOL, with their plans) and
    M = 8 f32 (the CUDA-core kernel).  Library: ``_weight_int8pack_mm`` for
    B13; none for B14 (no PyTorch call takes group scales along the output
    dimension).  Every row carries the dense ``g @ w_deq.T`` time on
    weights dequantized beforehand, a cuBLAS yardstick (``dense_ms``)."""
    from chatglm_q_tpu_torch import ops
    from chatglm_q_tpu_torch.ops import int8_matmul as I8
    from chatglm_q_tpu_torch.ops import quant_matmul as QM
    from chatglm_q_tpu_torch.ops.quant import unpack_int4_tpu
    from chatglm_q_tpu_torch.utils.timing import cuda_event_ms

    gen = torch.Generator(device="cuda").manual_seed(15)
    rows = []
    log("    B14 library: none (no PyTorch call takes int4 group scales along the output "
        "dimension); dense_ms is g @ w_deq.T on the dequantized weights, a reference only")

    def row(fn, plain, kernel, name, M, K, N, g, wts, wbytes, lib=None, dense=None,
            exact=None):
        copies = len(wts[0])
        wrapper = ops.kernel_wrappers()[kernel]
        before = wrapper.launches
        got = fn(g, wts[0][0], wts[1][0])
        torch.cuda.synchronize()
        require(wrapper.launches == before + 1, f"{fn.__name__} {name} M={M}: no {kernel} launch")
        want = plain(g, wts[0][0], wts[1][0])
        err, rel = rel_err(got, want)
        tol = KERNEL_TOL if g.dtype == torch.bfloat16 else F32_TOL
        require(torch.isfinite(got).all(), f"{fn.__name__} {name} M={M}: non-finite output")
        require(rel <= tol, f"{fn.__name__} {name} M={M} {g.dtype}: rel err {rel} > {tol}")
        ms = cuda_event_ms(lambda i: fn(g, wts[0][i % copies], wts[1][i % copies]), iters=30)
        plain_ms = cuda_event_ms(lambda i: plain(g, wts[0][0], wts[1][0]), iters=3, warmup=1)
        es = g.element_size()
        peak = PEAK_BF16_FLOPS if g.dtype == torch.bfloat16 else PEAK_F32_FLOPS
        b, by = bound_ms(M * N * es + wbytes + M * K * es, 2.0 * M * K * N, peak)
        r = {"kernel": kernel, "linear": name, "M": M, "K": K, "N": N,
             "dtype": str(g.dtype).replace("torch.", ""), "max_abs_err": err, "rel_err": rel,
             "ms": ms, "plain_ms": plain_ms, "bound_ms": b, "bound_by": by,
             "library_ms": lib(want) if lib else None}
        if dense is not None:
            r["dense_ms"] = dense
        if kernel.endswith("_mma"):  # the Hopper kernel: its plan and the sum bound
            r["plan"] = QM.t_mma_plan(M, K, N, "int8" if kernel.startswith("int8") else "int4g32")
            plan_s = "(bm, nsplit, stages/split, blocks)"
        elif kernel.endswith("_splitk"):  # the split-K tensor-core kernel
            r["plan"] = QM.t_splitk_plan(M, K, N)
            plan_s = "(m-tiles, nsplit, chunks/split, chunks/stage)"
        if "plan" in r:
            r["beyond_sum"] = hold_sum(torch, f"{fn.__name__} {name} M={M}", got, *exact())
        rows.append(r)
        log_row(fn.__name__, r)
        if dense is not None:
            log(f"    dense g @ w_deq.T (cuBLAS, bf16 weights, a yardstick) {dense:.4f} ms"
                + (f"; plan {plan_s} {r['plan']}; beyond the bf16 rounding "
                   f"{r['beyond_sum']:.2e} of sum|terms|" if "plan" in r else ""))

    for name, K, N in MATMUL_SHAPES:
        wbytes = K * N + 4 * N
        copies = weight_copies(wbytes)
        w = torch.randint(-128, 128, (copies, K, N), dtype=torch.int8, device="cuda",
                          generator=gen)
        scale = (0.5 + torch.rand((copies, N), device="cuda", generator=gen)) * 0.01
        w64 = w[0].double()
        for M, dname in T_ROWS:
            dtype = getattr(torch, dname)
            g = torch.randn((M, N), device="cuda", generator=gen).to(dtype)
            kernel = "int8_t_" + QM.t_route(M, N, dtype)
            w_deq = (w[0].float() * scale[0]).to(dtype)
            dense = cuda_event_ms(lambda i: g @ w_deq.T, iters=30)
            del w_deq
            gs = (g * scale[0].to(dtype)).double()  # the fold of the plain version, exact
            row(I8.int8_matmul_t, I8.int8_matmul_t_plain, kernel, name, M, K, N, g, (w, scale),
                wbytes, lib=lambda want, g=g: int8_t_library(torch, g, w, scale, want),
                dense=dense, exact=lambda gs=gs: (gs @ w64.T, gs.abs() @ w64.abs().T))
        del w, scale, w64
        wbytes = K // 2 * N + K // 32 * N * 2
        copies = weight_copies(wbytes)
        packed = torch.randint(0, 256, (copies, K // 2, N), dtype=torch.uint8, device="cuda",
                               generator=gen)
        scale = (torch.rand((copies, K // 32, N), device="cuda", generator=gen) * 0.02
                 ).to(torch.bfloat16)
        w64 = unpack_int4_tpu(packed[0], scale[0]).to(torch.bfloat16).double()  # bf16(q·s)
        for M, dname in T_ROWS:
            dtype = getattr(torch, dname)
            g = torch.randn((M, N), device="cuda", generator=gen).to(dtype)
            w_deq = unpack_int4_tpu(packed[0], scale[0]).to(dtype)
            dense = cuda_event_ms(lambda i: g @ w_deq.T, iters=30)
            del w_deq
            kernel = "int4g32_t_" + QM.t_route(M, N, dtype)
            row(QM.int4g32_matmul_t, QM.int4g32_matmul_t_plain, kernel, name, M, K, N, g,
                (packed, scale), wbytes, dense=dense,
                exact=lambda g=g: (g.double() @ w64.T, g.double().abs() @ w64.abs().T))
        del w64
        del packed, scale
    return rows


def decode_v2_f32(torch, q, k, v, lengths, sm_scale, p_bf16=False):
    """B12's function in f32, before the output's bf16 rounding: the plain
    version's steps (``flash_attention_decode_v2_plain``), with l summed
    from f32 p; with ``p_bf16`` p is rounded to bf16 before PV (the control:
    B4's rounding of p in B12's function)."""
    from chatglm_q_tpu_torch.ops import attention as A

    T = k.shape[2]
    s = torch.einsum("bghd,bgtd->bght", A._prescaled(q, sm_scale), k.float())
    valid = torch.arange(T, device=q.device)[None, :] <= lengths.long()[:, None]
    s = s.masked_fill(~valid[:, None, None, :], A.MASK_VALUE)
    p = torch.exp(s - s.amax(-1, keepdim=True)) * (lengths >= 0).float()[:, None, None, None]
    l = p.sum(-1, keepdim=True)
    pv = p.to(torch.bfloat16).float() if p_bf16 else p
    return torch.einsum("bght,bgtd->bghd", pv, v.float()) / torch.where(l > 0, l, 1.0)


def beyond_rounding(torch, got, want32, bits=8) -> float:
    """max(|got - want32| - half an ulp of want32) over max|want32|: the
    error of a bf16 output (``bits`` significant bits; f16: 11) beyond its
    own rounding of the f32 result."""
    half_ulp = torch.ldexp(torch.ones_like(want32), torch.frexp(want32).exponent - (bits + 1))
    half_ulp = torch.where(want32 == 0, 0.0, half_ulp)
    excess = ((got.float() - want32).abs() - half_ulp).clamp_min(0.0).max().item()
    return excess / max(want32.abs().max().item(), 1e-30)


def hold_beyond(torch, name, got, want32, control32, limit, where, hold=True
                ) -> tuple[float, float]:
    """A kernel held to its own limit beyond the output's rounding: its
    error beyond the output's rounding of ``want32`` (its function in f32)
    within ``limit``, and the control's (``control32``: the same function
    with p rounded to bf16) beyond it, each in the output's dtype (bf16, or
    f16).  Returns (kernel, control); ``hold`` False only reads them."""
    bits = 11 if got.dtype == torch.float16 else 8
    err = beyond_rounding(torch, got, want32, bits)
    ctrl = beyond_rounding(torch, control32.to(got.dtype), want32, bits)
    require(not hold or err <= limit < ctrl,
            f"{name} {where}: error beyond the output's rounding {err} (limit {limit}), "
            f"control {ctrl}")
    return err, ctrl


def hold_b12(torch, got, q, k, v, lengths, sm, where) -> tuple[float, float]:
    """B12 held to B12_TOL against ``decode_v2_f32``."""
    return hold_beyond(torch, "flash_attention_decode_v2", got,
                       decode_v2_f32(torch, q, k, v, lengths, sm),
                       decode_v2_f32(torch, q, k, v, lengths, sm, p_bf16=True), B12_TOL, where)


def hold_b10(torch, got, q, kp, vp, layer, pt, lengths, sm, where) -> tuple[float, float]:
    """B10 held to B10_TOL: B12's function in f32 over the gathered pages."""
    from chatglm_q_tpu_torch.ops import attention as A

    k, v = A.gather_pages(kp[layer], pt), A.gather_pages(vp[layer], pt)
    return hold_beyond(torch, "flash_attention_decode_paged", got,
                       decode_v2_f32(torch, q, k, v, lengths, sm),
                       decode_v2_f32(torch, q, k, v, lengths, sm, p_bf16=True), B10_TOL, where)


def chunk_paged_f32(torch, q, kp, vp, layer, pt, starts, sm_scale, row_map=None, p_bf16=False):
    """B11's function in f32, before the output's bf16 rounding: the plain
    version's steps (``flash_attention_chunk_paged_plain``), with l summed
    from f32 p; with ``p_bf16`` p is rounded to bf16 before PV (the
    control)."""
    from chatglm_q_tpu_torch.ops import attention as A

    if row_map is not None:
        pt = pt[row_map.long()]
    k, v = A.gather_pages(kp[layer], pt).float(), A.gather_pages(vp[layer], pt).float()
    S, T = q.shape[1], k.shape[2]
    s = torch.einsum("bsghd,bgtd->bghst", A._prescaled(q, sm_scale), k)
    qpos = starts.long()[:, None] + torch.arange(S, device=q.device)[None, :]
    mask = torch.arange(T, device=q.device)[None, None, :] <= qpos[:, :, None]
    s = s.masked_fill(~mask[:, None, None], A.MASK_VALUE)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    l = p.sum(-1, keepdim=True)
    pv = p.to(torch.bfloat16).float() if p_bf16 else p
    return (torch.einsum("bghst,bgtd->bghsd", pv, v) / l).permute(0, 3, 1, 2, 4)


def hold_b11(torch, got, q, kp, vp, layer, pt, starts, sm, row_map, where) -> tuple[float, float]:
    """B11 held to B11_TOL against ``chunk_paged_f32``."""
    args = (torch, q, kp, vp, layer, pt, starts, sm, row_map)
    return hold_beyond(torch, "flash_attention_chunk_paged", got, chunk_paged_f32(*args),
                       chunk_paged_f32(*args, p_bf16=True), B11_TOL, where)


def check_attention_edges(torch, act=None):
    """B4, B12, B5 (both forms), B10 and B11 against their plain versions at
    the edges the main-path shapes miss: decode at lengths -1 (outputs 0),
    0, span - 1, span, span + 1, T - 1 (and T + 5 for B12), 255 and 256 (the
    last row of one span and the first of the cross-block merge), T = 1000
    (no multiple of the 64-row tile), spans of 128 and 512 rows, Hg 16 and
    4; prefill at S = 130 (no multiple of the tile), a length-0 row,
    q_starts on and off the tiles, a kv_row_map, Hg 16, 4 and 64; B10 at
    page sizes 16, 96 and 256, Hg 16 and 4, lengths -1 (outputs 0), 0,
    P - 1, P, P + 1, 255, 256, MP·P - 1 and past capacity, and a padding row
    on the garbage page; B11 at S = 1, 9, 32 (Hg 16) and 128 (Hg 4: S·Hg
    512), starts 0, across a page edge, at capacity - S and past it, and 700
    (split over spans), with and without a row map.  Each within KERNEL_TOL
    of max|plain| and finite; B12, B10 and B11 also within their own limits
    beyond the output's rounding, with their controls above them.  With
    ``act`` float32: the same cases in f32 (the CUDA-core forms), each
    within F32_TOL, and no rounding to read beyond."""
    from chatglm_q_tpu_torch.ops import attention as A

    gen = torch.Generator(device="cuda").manual_seed(14)
    G, D = 2, 128
    sm = 1.0 / math.sqrt(D)
    worst = {}
    act = act or torch.bfloat16
    f32 = act == torch.float32
    tol = F32_TOL if f32 else KERNEL_TOL

    def bf(*shape):
        return torch.randn(shape, device="cuda", generator=gen).to(act)

    def hold(name, got, want, zero_rows):
        torch.cuda.synchronize()
        _, rel = rel_err(got, want)
        require(got.dtype == act and torch.isfinite(got.float()).all() and rel <= tol,
                f"{name} edge case ({str(act)[6:]}): rel err {rel}")
        for r in zero_rows:
            require(not got[r].float().any(), f"{name} edge case: row {r} is not 0")
        worst[name] = max(worst.get(name, 0.0), rel)

    solo = A.DECODE_SOLO_ROWS
    b12 = [0.0, math.inf]  # B12's largest error beyond rounding, the control's least
    for Hg in (16, 4):
        for B, T in ((10, 1000), (70, 1000)):  # spans of 128 and of 512 rows
            q, k, v = bf(B, G, Hg, D), bf(B, G, T, D), bf(B, G, T, D)
            for name, fn, plain, v2 in (
                    ("flash_attention_decode", A.flash_attention_decode,
                     A.flash_attention_decode_plain, False),
                    ("flash_attention_decode_v2", A.flash_attention_decode_v2,
                     A.flash_attention_decode_v2_plain, True)):
                span = A.decode_span(B * G, T, 512)
                edges = [-1, 0, span - 1, span, span + 1, solo - 1, solo, T - 1] + (
                    [T + 5] if v2 else [])
                lengths = torch.tensor(edges + [(37 * i) % T for i in range(B - len(edges))],
                                       dtype=torch.int32, device="cuda")
                got = fn(q, k, v, lengths, sm)
                hold(name, got, plain(q, k, v, lengths, sm), [0])
                if v2 and not f32:
                    err, ctrl = hold_b12(torch, got, q, k, v, lengths, sm,
                                         f"edge case B={B} Hg={Hg}")
                    b12 = [max(b12[0], err), min(b12[1], ctrl)]
    for Hg in (16, 4, 64):
        S, T = 130, 192
        q, k, v = bf(4, S, G, Hg, D), bf(4, G, T, D), bf(4, G, T, D)
        lengths = torch.tensor([S, 0, 12, 77], dtype=torch.int32, device="cuda")
        hold("flash_attention_prefill", A.flash_attention_prefill(q, k, v, lengths, sm),
             A.flash_attention_prefill_plain(q, k, v, lengths, sm), [1])
        S, T = 64, 512
        q, k, v = bf(4, S, G, Hg, D), bf(5, G, T, D), bf(5, G, T, D)
        starts = torch.tensor([256, 3, 447, 0], dtype=torch.int32, device="cuda")
        lengths = starts + torch.tensor([40, 64, 0, 64], dtype=torch.int32, device="cuda")
        lengths[2] = 0
        rmap = torch.tensor([3, 1, 0, 4], dtype=torch.int32, device="cuda")
        hold("flash_attention_prefill_chunk",
             A.flash_attention_prefill_chunk(q, k, v, lengths, starts, sm, rmap),
             A.flash_attention_prefill_plain(q, k, v, lengths, sm, starts, rmap), [2])
    # B10 and B11 through scattered pages: P = 16 (four pages a tile), 96 (no
    # multiple of the tile: tiles straddle pages) and 256 (the engines'), at
    # capacities of about 1024 rows, so that long rows span several blocks
    b10, b11 = [0.0, math.inf], [0.0, math.inf]
    for P, MP in ((16, 64), (96, 11), (256, 4)):
        cap, Bd, Bc = MP * P, 12, 5
        NP = Bd * MP + 1
        kp, vp = bf(2, NP, G, P, D), bf(2, NP, G, P, D)
        pt = (torch.randperm(NP - 1, device="cuda", generator=gen)[: Bd * MP] + 1
              ).reshape(Bd, MP).to(torch.int32)
        pt[9] = 0  # a padding row: every page the garbage page
        edges = [-1, 0, P - 1, P, P + 1, solo - 1, solo, cap - 1, cap + 30, 0]
        lengths = torch.tensor(edges + [(371 * i) % cap for i in range(1, Bd - len(edges) + 1)],
                               dtype=torch.int32, device="cuda")
        for Hg in (16, 4):
            q = bf(Bd, G, Hg, D)
            got = A.flash_attention_decode_paged(q, kp, vp, 1, pt, lengths, sm)
            hold("flash_attention_decode_paged", got,
                 A.flash_attention_decode_paged_plain(q, kp, vp, 1, pt, lengths, sm), [0])
            if f32:
                continue
            err, ctrl = hold_b10(torch, got, q, kp, vp, 1, pt, lengths, sm,
                                 f"edge case P={P} Hg={Hg}")
            b10 = [max(b10[0], err), min(b10[1], ctrl)]
        for S, Hg in ((1, 16), (9, 16), (32, 16), (128, 4)):  # S·Hg up to the engines' 512
            q = bf(Bc, S, G, Hg, D)
            starts = torch.tensor([0, P - 2, cap - S, cap - S + 5, 700], dtype=torch.int32,
                                  device="cuda")
            rmap = torch.tensor([5, 0, 3, 1, 2], dtype=torch.int32, device="cuda")
            for table, row_map in ((pt[:Bc].contiguous(), None), (pt[:6].contiguous(), rmap)):
                got = A.flash_attention_chunk_paged(q, kp, vp, 1, table, starts, sm, row_map)
                hold("flash_attention_chunk_paged", got, A.flash_attention_chunk_paged_plain(
                    q, kp, vp, 1, table, starts, sm, row_map), [])
                if f32:
                    continue
                err, ctrl = hold_b11(torch, got, q, kp, vp, 1, table, starts, sm, row_map,
                                     f"edge case P={P} S={S} Hg={Hg} "
                                     f"row_map={row_map is not None}")
                b11 = [max(b11[0], err), min(b11[1], ctrl)]
        del kp, vp
    for name, (err, ctrl) in (("flash_attention_decode_v2", b12),
                              ("flash_attention_decode_paged", b10),
                              ("flash_attention_chunk_paged", b11)):
        if f32:
            continue
        worst[f"{name} beyond rounding"] = err
        worst[f"{name} control beyond rounding"] = ctrl
    log(f"  attention edge cases{' (f32)' if f32 else ''}: max rel err {json.dumps(worst)}")
    return worst


def rope_append_row(torch, gen, k, v, pt, starts_sets):
    """The decode step's fused RoPE + KV append (B3 with ``pt`` None, B9 with
    a page table) at 6B's heads, one row per starts: bit-equal to its plain
    version for every set of starts, then timed over the 28 layers at the
    first set: the kernel, its plain version, and the path it replaced as a
    yardstick (``old_path_ms``: two plain RoPEs, then B3's / B9's write-only
    launches for k and for v, a strided view of the kv row that the wrapper
    copies, as ``block_forward`` ran them).  No one PyTorch call computes
    the same function: ``library_ms`` is None."""
    from chatglm_q_tpu_torch.models.chatglm2 import precompute_freqs_cis
    from chatglm_q_tpu_torch.ops import attention as A
    from chatglm_q_tpu_torch.utils.timing import cuda_event_ms

    L, G, D, Hg = k.shape[0], k.shape[2], k.shape[4], 16
    B = starts_sets[0].shape[0]
    q = torch.randn((B, G, Hg, D), device="cuda", generator=gen).to(torch.bfloat16)
    kv = torch.randn((B, 2 * G * D), device="cuda", generator=gen).to(torch.bfloat16)
    table = torch.from_numpy(precompute_freqs_cis(D, 2049)).to("cuda", torch.bfloat16)
    freqs = table[torch.tensor([5, 700, 1500, 2048], device="cuda")[:B]]
    for st in starts_sets:
        kr, vr = k.clone(), v.clone()
        got = A.rope_kv_append(q, kv, freqs, k, v, 3, st, pt)
        torch.cuda.synchronize()
        want = A.rope_kv_append_plain(q, kv, freqs, kr, vr, 3, st, pt)
        require(torch.equal(got, want) and torch.equal(k, kr) and torch.equal(v, vr),
                f"rope_kv_append (B={B}, starts {st.tolist()}) differs from its plain version")
        del kr, vr
    st = starts_sets[0]
    ms = cuda_event_ms(lambda i: A.rope_kv_append(q, kv, freqs, k, v, i % L, st, pt), iters=56)
    plain = cuda_event_ms(lambda i: A.rope_kv_append_plain(q, kv, freqs, k, v, i % L, st, pt),
                          iters=14)

    def old_path(i):
        kk, vv = kv.split(G * D, dim=-1)
        f = freqs[:, None, None, :]
        A.apply_rotary_emb(q, f)
        kk = A.apply_rotary_emb(kk.reshape(B, G, 1, D), f).reshape(B, G, D)
        if pt is None:
            A.kv_cache_write_idx(k, kk, i % L, st)
            A.kv_cache_write_idx(v, vv.reshape(B, G, D), i % L, st)
        else:
            A.kv_pool_write_idx(k, kk, i % L, pt, st)
            A.kv_pool_write_idx(v, vv.reshape(B, G, D), i % L, pt, st)

    old = cuda_event_ms(old_path, iters=14)
    # q read and written, the kv row and the freqs row read, k and v written,
    # starts (and a page id) read; 6 f32 operations a rotated pair
    nbytes = B * (2 * q[0].numel() * 2 + 2 * kv[0].numel() * 2 + D * 2 + 4) \
        + (0 if pt is None else B * 4)
    b, by = bound_ms(nbytes, 6.0 * B * (G * Hg + G) * D / 2, PEAK_F32_FLOPS)
    where = (f"cache (L={L}, B={B}, G={G}, T={k.shape[3]}, D={D})" if pt is None else
             f"pool (L={L}, NP={k.shape[1]}, G={G}, P={k.shape[3]}, D={D}), MP={pt.shape[1]}")
    return dict(max_abs_err=0.0, rel_err=0.0, ms=ms, plain_ms=plain, bound_ms=b, bound_by=by,
                library_ms=None, old_path_ms=old,
                shape=f"q (B={B}, G={G}, Hg={Hg}, D={D}), {where}, "
                      f"starts {[x.tolist() for x in starts_sets]}")


def log_attention_rows(out, width):
    for k, r in out.items():
        lib = "none" if r["library_ms"] is None else f"{r['library_ms']:.4f} ms"
        old = f"  old path {r['old_path_ms']:.4f} ms" if "old_path_ms" in r else ""
        log(f"  {k:{width}s} rel_err {r['rel_err']:.2e}  {r['ms']:.4f} ms  bound "
            f"{r['bound_ms']:.6f} ms ({r['bound_by']})  plain {r['plain_ms']:.4f} ms  "
            f"library {lib}{old}  [{r['shape']}]")


def check_attention(torch):
    import torch.nn.functional as F

    from chatglm_q_tpu_torch.ops import attention as A
    from chatglm_q_tpu_torch.utils.timing import cuda_event_ms

    gen = torch.Generator(device="cuda").manual_seed(12)
    L, B, G, Hg, D, T = 28, len(PROMPT_LENGTHS), 2, 16, 128, CACHE_LEN
    sm = 1.0 / math.sqrt(D)
    # one (B, G, T, D) slab per layer: the timed loop walks the layers, as
    # decode does, so K/V come from memory rather than the L2
    kc = torch.randn((L, B, G, T, D), device="cuda", generator=gen).to(torch.bfloat16)
    vc = torch.randn((L, B, G, T, D), device="cuda", generator=gen).to(torch.bfloat16)
    out = {}

    # ragged decode
    q = torch.randn((B, G, Hg, D), device="cuda", generator=gen).to(torch.bfloat16)
    lens = torch.tensor([1000, 600, 200, 0], dtype=torch.int32, device="cuda")
    got = A.flash_attention_decode(q, kc[0], vc[0], lens, sm)
    torch.cuda.synchronize()
    want = A.flash_attention_decode_plain(q, kc[0], vc[0], lens, sm)
    err, rel = rel_err(got, want)
    require(rel <= KERNEL_TOL, f"flash_attention_decode rel err {rel}")
    ms = cuda_event_ms(lambda i: A.flash_attention_decode(q, kc[i % L], vc[i % L], lens, sm),
                       iters=56)
    plain = cuda_event_ms(lambda i: A.flash_attention_decode_plain(q, kc[0], vc[0], lens, sm),
                          iters=5)
    valid = torch.arange(T, device="cuda")[None, :] <= lens[:, None]
    mask = valid[:, None, None, :]  # (B, 1, 1, T)
    qs = q.reshape(B, G * Hg, 1, D)
    lib = cuda_event_ms(lambda i: F.scaled_dot_product_attention(
        qs, kc[i % L], vc[i % L], attn_mask=mask, scale=sm, enable_gqa=True), iters=56)
    n = [min(int(x) + 1, T) for x in lens.tolist()]
    nbytes = 2 * q.numel() * 2 + sum(n) * G * D * 2 * 2 + B * 4
    b, by = bound_ms(nbytes, 4.0 * sum(n) * G * Hg * D)
    out["flash_attention_decode"] = dict(max_abs_err=err, rel_err=rel, ms=ms, plain_ms=plain,
                                         bound_ms=b, bound_by=by, library_ms=lib,
                                         shape=f"B={B} G={G} Hg={Hg} D={D} T={T} "
                                               f"lengths={lens.tolist()} "
                                               f"span={A.decode_span(B * G, T, A.DECODE_BLOCK_K)}")

    # B4 at the decoder's own batch-1 shape: GLMDecoder.generate after a
    # 128-token prompt reads 141 slots of a 1024-slot cache
    q1, l1 = q[:1].contiguous(), torch.tensor([140], dtype=torch.int32, device="cuda")
    got = A.flash_attention_decode(q1, kc[0][:1], vc[0][:1], l1, sm)
    torch.cuda.synchronize()
    want = A.flash_attention_decode_plain(q1, kc[0][:1], vc[0][:1], l1, sm)
    err1, rel1 = rel_err(got, want)
    require(torch.isfinite(got).all() and rel1 <= KERNEL_TOL,
            f"flash_attention_decode B=1 rel err {rel1}")
    ms1 = cuda_event_ms(lambda i: A.flash_attention_decode(q1, kc[i % L][:1], vc[i % L][:1], l1,
                                                           sm), iters=56)
    plain1 = cuda_event_ms(lambda i: A.flash_attention_decode_plain(q1, kc[0][:1], vc[0][:1], l1,
                                                                    sm), iters=5)
    mask1 = (torch.arange(T, device="cuda") <= 140)[None, None, None, :]
    lib1 = cuda_event_ms(lambda i: F.scaled_dot_product_attention(
        q1.reshape(1, G * Hg, 1, D), kc[i % L][:1], vc[i % L][:1], attn_mask=mask1, scale=sm,
        enable_gqa=True), iters=56)
    b1, by1 = bound_ms(2 * q1.numel() * 2 + 141 * G * D * 2 * 2 + 4, 4.0 * 141 * G * Hg * D)
    out["flash_attention_decode B=1"] = dict(
        max_abs_err=err1, rel_err=rel1, ms=ms1, plain_ms=plain1, bound_ms=b1, bound_by=by1,
        library_ms=lib1, shape=f"B=1 G={G} Hg={Hg} D={D} T={T} lengths=[140] "
                               f"span={A.decode_span(G, T, A.DECODE_BLOCK_K)}")
    # the fused span merge is deterministic: a second call is bit-equal
    require(torch.equal(A.flash_attention_decode(q, kc[0], vc[0], lens, sm),
                        A.flash_attention_decode(q, kc[0], vc[0], lens, sm)),
            "flash_attention_decode: two calls on the same inputs differ")

    # B12: the same decode split over T, with its own numerics; the same
    # SDPA call (timed just above on the same inputs) is its yardstick
    got = A.flash_attention_decode_v2(q, kc[0], vc[0], lens, sm)
    torch.cuda.synchronize()
    want = A.flash_attention_decode_v2_plain(q, kc[0], vc[0], lens, sm)
    err, rel = rel_err(got, want)
    require(torch.isfinite(got).all() and rel <= KERNEL_TOL,
            f"flash_attention_decode_v2 rel err {rel}")
    beyond, ctrl = hold_b12(torch, got, q, kc[0], vc[0], lens, sm, "main shape")
    ms = cuda_event_ms(lambda i: A.flash_attention_decode_v2(q, kc[i % L], vc[i % L], lens, sm),
                       iters=56)
    plain = cuda_event_ms(lambda i: A.flash_attention_decode_v2_plain(q, kc[0], vc[0], lens, sm),
                          iters=5)
    out["flash_attention_decode_v2"] = dict(
        max_abs_err=err, rel_err=rel, ms=ms, plain_ms=plain, bound_ms=b, bound_by=by,
        library_ms=lib, beyond_rounding=beyond, control_beyond_rounding=ctrl,
        shape=f"B={B} G={G} Hg={Hg} D={D} T={T} lengths={lens.tolist()} "
              f"span={A.decode_span(B * G, T, 512)}")

    # flash prefill
    S = max(PROMPT_LENGTHS)
    qp = torch.randn((B, S, G, Hg, D), device="cuda", generator=gen).to(torch.bfloat16)
    lp = torch.tensor(PROMPT_LENGTHS, dtype=torch.int32, device="cuda")
    got = A.flash_attention_prefill(qp, kc[0], vc[0], lp, sm)
    torch.cuda.synchronize()
    want = A.flash_attention_prefill_plain(qp, kc[0], vc[0], lp, sm)
    err, rel = rel_err(got, want)
    require(rel <= KERNEL_TOL, f"flash_attention_prefill rel err {rel}")
    ms = cuda_event_ms(lambda i: A.flash_attention_prefill(qp, kc[i % L], vc[i % L], lp, sm),
                       iters=56)
    plain = cuda_event_ms(lambda i: A.flash_attention_prefill_plain(qp, kc[0], vc[0], lp, sm),
                          iters=5)
    pos = torch.arange(S, device="cuda")
    pmask = ((pos[None, :] <= pos[:, None])[None] & (pos[None, None, :] < lp[:, None, None]))
    qsp = qp.permute(0, 2, 3, 1, 4).reshape(B, G * Hg, S, D)
    lib = cuda_event_ms(lambda i: F.scaled_dot_product_attention(
        qsp, kc[i % L][:, :, :S], vc[i % L][:, :, :S], attn_mask=pmask[:, None], scale=sm,
        enable_gqa=True), iters=56)
    pairs = sum(min(s + 1, lb) for lb in PROMPT_LENGTHS for s in range(S))
    nbytes = 2 * qp.numel() * 2 + sum(min(S, lb) for lb in PROMPT_LENGTHS) * G * D * 2 * 2 + B * 4
    b, by = bound_ms(nbytes, 4.0 * pairs * G * Hg * D)
    out["flash_attention_prefill"] = dict(max_abs_err=err, rel_err=rel, ms=ms, plain_ms=plain,
                                          bound_ms=b, bound_by=by, library_ms=lib,
                                          shape=f"B={B} S={S} G={G} Hg={Hg} D={D} "
                                                f"lengths={list(PROMPT_LENGTHS)}")

    # in-place KV write: exact
    new = torch.randn((B, G, D), device="cuda", generator=gen).to(torch.bfloat16)
    starts = torch.tensor(PROMPT_LENGTHS, dtype=torch.int32, device="cuda")
    ref = kc.clone()
    A.kv_cache_write_idx(kc, new, 3, starts)
    torch.cuda.synchronize()
    A.kv_cache_write_idx_plain(ref, new, 3, starts)
    err, rel = rel_err(kc, ref)
    require(err == 0.0, f"kv_cache_write_idx differs from plain: {err}")
    del ref
    ms = cuda_event_ms(lambda i: A.kv_cache_write_idx(kc, new, i % L, starts), iters=56)
    plain = cuda_event_ms(lambda i: A.kv_cache_write_idx_plain(kc, new, i % L, starts),
                          iters=56)
    bidx = torch.arange(B, device="cuda")[:, None]
    gidx = torch.arange(G, device="cuda")[None, :]
    sidx = starts.long()[:, None]
    lib = cuda_event_ms(lambda i: kc[i % L].index_put_((bidx, gidx, sidx), new), iters=56)
    b, by = bound_ms(2 * new.numel() * 2 + B * 4, 0.0)
    out["kv_cache_write_idx"] = dict(max_abs_err=err, rel_err=rel, ms=ms, plain_ms=plain,
                                     bound_ms=b, bound_by=by, library_ms=lib,
                                     shape=f"cache (L={L}, B={B}, G={G}, T={T}, D={D}) "
                                           f"starts={list(PROMPT_LENGTHS)}")

    # B3 with the RoPE (the decode step's launch): exact at B = 4 on this
    # cache and at B = 1 on a 1-row cache, in the middle, at the wall, past it
    def i32(*xs):
        return torch.tensor(xs, dtype=torch.int32, device="cuda")

    out["rope_kv_append"] = rope_append_row(torch, gen, kc, vc, None,
                                            [starts, i32(T - 1, T, T + 5, 2)])
    k1, v1 = (torch.randn((L, 1, G, T, D), device="cuda", generator=gen).to(torch.bfloat16)
              for _ in range(2))
    out["rope_kv_append B=1"] = rope_append_row(torch, gen, k1, v1, None,
                                                [i32(140), i32(T - 1), i32(T + 7)])
    log_attention_rows(out, 26)
    del kc, vc, k1, v1
    return out


# paged-pool shapes of phase 2 and 6: 64 pages of 256 rows, 2048-slot rows
POOL_PAGES, PAGE, SEQ = 64, 256, 2048
PAGED_LENGTHS = (1000, 600, 200, 0)


def check_paged_attention(torch):
    """B9 (pool write), B10 (paged decode), B11 (chunk attention over the
    pool, S = 9 and 32) and B5's chunked form (Sc = 256 against a 2048-slot
    cache with a row map) against their plain versions; each timed with
    CUDA events over the 28 layers, beside the bytes bound and a library
    yardstick the port never calls (``index_put_`` for B9; a page gather +
    SDPA for B10/B11; a row gather + SDPA for B5's chunked form)."""
    import torch.nn.functional as F

    from chatglm_q_tpu_torch.ops import attention as A
    from chatglm_q_tpu_torch.utils.timing import cuda_event_ms

    gen = torch.Generator(device="cuda").manual_seed(13)
    L, G, Hg, D, B = 28, 2, 16, 128, len(PAGED_LENGTHS)
    MP, sm = SEQ // PAGE, 1.0 / math.sqrt(D)
    shape = (L, POOL_PAGES, G, PAGE, D)
    kp = torch.randn(shape, device="cuda", generator=gen).to(torch.bfloat16)
    vp = torch.randn(shape, device="cuda", generator=gen).to(torch.bfloat16)
    # scattered pages, distinct per row, page 0 (the garbage page) unused
    pt = (torch.randperm(POOL_PAGES - 1, device="cuda", generator=gen)[: B * MP] + 1
          ).reshape(B, MP).to(torch.int32)
    out = {}

    def put(name, err, rel, ms, plain, nbytes, ops, lib, shape_s):
        b, by = bound_ms(nbytes, ops)
        out[name] = dict(max_abs_err=err, rel_err=rel, ms=ms, plain_ms=plain, bound_ms=b,
                         bound_by=by, library_ms=lib, shape=shape_s)

    # B9: one token per row into the pool, exact
    new = torch.randn((B, G, D), device="cuda", generator=gen).to(torch.bfloat16)
    starts = torch.tensor(PAGED_LENGTHS, dtype=torch.int32, device="cuda")
    ref = kp.clone()
    A.kv_pool_write_idx(kp, new, 3, pt, starts)
    torch.cuda.synchronize()
    A.kv_pool_write_idx_plain(ref, new, 3, pt, starts)
    err, rel = rel_err(kp, ref)
    require(err == 0.0, f"kv_pool_write_idx differs from plain: {err}")
    del ref
    ms = cuda_event_ms(lambda i: A.kv_pool_write_idx(kp, new, i % L, pt, starts), iters=56)
    plain = cuda_event_ms(lambda i: A.kv_pool_write_idx_plain(kp, new, i % L, pt, starts),
                          iters=56)
    pos = starts.long()
    page = pt.long()[torch.arange(B, device="cuda"), pos // PAGE]
    lib = cuda_event_ms(lambda i: kp[i % L].index_put_(
        (page[:, None], torch.arange(G, device="cuda")[None, :], (pos % PAGE)[:, None]), new),
        iters=56)
    put("kv_pool_write_idx", err, rel, ms, plain, 2 * new.numel() * 2 + 2 * B * 4, 0.0, lib,
        f"pool (L={L}, NP={POOL_PAGES}, G={G}, P={PAGE}, D={D}), B={B}, "
        f"starts={list(PAGED_LENGTHS)}")
    # B9 with the RoPE (the paged decode step's launch): exact at B = 4 and 1,
    # in the middle, at the capacity's last position and past it
    cap = MP * PAGE

    def i32(*xs):
        return torch.tensor(xs, dtype=torch.int32, device="cuda")

    out["rope_kv_append paged"] = rope_append_row(torch, gen, kp, vp, pt,
                                                  [starts, i32(cap - 1, cap, cap + 100, 5)])
    out["rope_kv_append paged B=1"] = rope_append_row(torch, gen, kp, vp, pt[:1].contiguous(),
                                                      [i32(1000), i32(cap - 1), i32(cap + 3)])

    # B10: paged ragged decode
    q = torch.randn((B, G, Hg, D), device="cuda", generator=gen).to(torch.bfloat16)
    lens = torch.tensor(PAGED_LENGTHS, dtype=torch.int32, device="cuda")
    got = A.flash_attention_decode_paged(q, kp, vp, 0, pt, lens, sm)
    torch.cuda.synchronize()
    want = A.flash_attention_decode_paged_plain(q, kp, vp, 0, pt, lens, sm)
    err, rel = rel_err(got, want)
    require(torch.isfinite(got).all() and rel <= KERNEL_TOL,
            f"flash_attention_decode_paged rel err {rel}")
    beyond, ctrl = hold_b10(torch, got, q, kp, vp, 0, pt, lens, sm, "main shape")
    require(torch.equal(A.flash_attention_decode_paged(q, kp, vp, 0, pt, lens, sm),
                        A.flash_attention_decode_paged(q, kp, vp, 0, pt, lens, sm)),
            "flash_attention_decode_paged: two calls on the same inputs differ")
    ms = cuda_event_ms(lambda i: A.flash_attention_decode_paged(q, kp, vp, i % L, pt, lens, sm),
                       iters=56)
    plain = cuda_event_ms(lambda i: A.flash_attention_decode_paged_plain(q, kp, vp, i % L, pt,
                                                                         lens, sm), iters=5)
    dmask = (torch.arange(MP * PAGE, device="cuda")[None, :] <= lens[:, None])[:, None, None]

    def lib_decode(i):
        kd, vd = A.gather_pages(kp[i % L], pt), A.gather_pages(vp[i % L], pt)
        return F.scaled_dot_product_attention(q.reshape(B, G * Hg, 1, D), kd, vd,
                                              attn_mask=dmask, scale=sm, enable_gqa=True)

    lib = cuda_event_ms(lib_decode, iters=56)
    n = [min(x + 1, MP * PAGE) for x in PAGED_LENGTHS]
    put("flash_attention_decode_paged", err, rel, ms, plain,
        2 * q.numel() * 2 + sum(n) * G * D * 2 * 2 + B * MP * 4 + B * 4,
        4.0 * sum(n) * G * Hg * D, lib,
        f"B={B} G={G} Hg={Hg} D={D} P={PAGE} MP={MP} lengths={list(PAGED_LENGTHS)} "
        f"span={A.decode_paged_span(B * G, PAGE, MP)}")
    out["flash_attention_decode_paged"].update(beyond_rounding=beyond,
                                               control_beyond_rounding=ctrl)

    # B11: chunk attention over the pool, S = 9 (a k = 8 verify step) and 32
    for S in (9, 32):
        qc = torch.randn((B, S, G, Hg, D), device="cuda", generator=gen).to(torch.bfloat16)
        got = A.flash_attention_chunk_paged(qc, kp, vp, 0, pt, starts, sm)
        torch.cuda.synchronize()
        want = A.flash_attention_chunk_paged_plain(qc, kp, vp, 0, pt, starts, sm)
        err, rel = rel_err(got, want)
        require(torch.isfinite(got).all() and rel <= KERNEL_TOL,
                f"flash_attention_chunk_paged S={S} rel err {rel}")
        beyond, ctrl = hold_b11(torch, got, qc, kp, vp, 0, pt, starts, sm, None,
                                f"main shape S={S}")
        require(torch.equal(A.flash_attention_chunk_paged(qc, kp, vp, 0, pt, starts, sm),
                            A.flash_attention_chunk_paged(qc, kp, vp, 0, pt, starts, sm)),
                f"flash_attention_chunk_paged S={S}: two calls on the same inputs differ")
        ms = cuda_event_ms(lambda i: A.flash_attention_chunk_paged(qc, kp, vp, i % L, pt,
                                                                   starts, sm), iters=56)
        plain = cuda_event_ms(lambda i: A.flash_attention_chunk_paged_plain(
            qc, kp, vp, i % L, pt, starts, sm), iters=5)
        qpos = starts.long()[:, None] + torch.arange(S, device="cuda")[None, :]
        cmask = (torch.arange(MP * PAGE, device="cuda")[None, None, :] <= qpos[:, :, None])

        def lib_chunk(i, qc=qc, cmask=cmask):
            kd, vd = A.gather_pages(kp[i % L], pt), A.gather_pages(vp[i % L], pt)
            qs = qc.permute(0, 2, 3, 1, 4).reshape(B, G * Hg, qc.shape[1], D)
            return F.scaled_dot_product_attention(qs, kd, vd, attn_mask=cmask[:, None],
                                                  scale=sm, enable_gqa=True)

        lib = cuda_event_ms(lib_chunk, iters=56)
        rows = [min(st + S, MP * PAGE) for st in PAGED_LENGTHS]
        pairs = sum(min(st + t + 1, MP * PAGE) for st in PAGED_LENGTHS for t in range(S))
        units = A.chunk_units(B, G, S, Hg)
        put(f"flash_attention_chunk_paged S={S}", err, rel, ms, plain,
            2 * qc.numel() * 2 + sum(rows) * G * D * 2 * 2 + B * MP * 4 + B * 4,
            4.0 * pairs * G * Hg * D, lib,
            f"B={B} S={S} G={G} Hg={Hg} D={D} P={PAGE} starts={list(PAGED_LENGTHS)} "
            f"span={A.chunk_span(units, MP * PAGE)} "
            f"partials={4 * A.chunk_partial_floats(units, MP * PAGE)} B")
        out[f"flash_attention_chunk_paged S={S}"].update(beyond_rounding=beyond,
                                                         control_beyond_rounding=ctrl)
    del kp, vp

    # B5's chunked form: 256-token chunks of 4 compact rows against a 4-row,
    # 2048-slot cache, rows mapped in another order
    Sc = 256
    kc = torch.randn((L, B, G, SEQ, D), device="cuda", generator=gen).to(torch.bfloat16)
    vc = torch.randn((L, B, G, SEQ, D), device="cuda", generator=gen).to(torch.bfloat16)
    qp = torch.randn((B, Sc, G, Hg, D), device="cuda", generator=gen).to(torch.bfloat16)
    cstarts = torch.tensor([768, 512, 256, 0], dtype=torch.int32, device="cuda")
    clens = cstarts + torch.tensor([256, 256, 200, 256], dtype=torch.int32, device="cuda")
    rmap = torch.tensor([2, 0, 3, 1], dtype=torch.int32, device="cuda")
    got = A.flash_attention_prefill_chunk(qp, kc[0], vc[0], clens, cstarts, sm, rmap)
    torch.cuda.synchronize()
    want = A.flash_attention_prefill_plain(qp, kc[0], vc[0], clens, sm, cstarts, rmap)
    err, rel = rel_err(got, want)
    require(torch.isfinite(got).all() and rel <= KERNEL_TOL,
            f"flash_attention_prefill_chunk rel err {rel}")
    ms = cuda_event_ms(lambda i: A.flash_attention_prefill_chunk(qp, kc[i % L], vc[i % L], clens,
                                                                 cstarts, sm, rmap), iters=56)
    plain = cuda_event_ms(lambda i: A.flash_attention_prefill_plain(
        qp, kc[i % L], vc[i % L], clens, sm, cstarts, rmap), iters=5)
    qpos = cstarts.long()[:, None] + torch.arange(Sc, device="cuda")[None, :]
    cols = torch.arange(SEQ, device="cuda")[None, None, :]
    pmask = (cols <= qpos[:, :, None]) & (cols < clens.long()[:, None, None])
    qsp = qp.permute(0, 2, 3, 1, 4).reshape(B, G * Hg, Sc, D)

    def lib_prefill_chunk(i):
        kd = kc[i % L].index_select(0, rmap.long())
        vd = vc[i % L].index_select(0, rmap.long())
        return F.scaled_dot_product_attention(qsp, kd, vd, attn_mask=pmask[:, None], scale=sm,
                                              enable_gqa=True)

    lib = cuda_event_ms(lib_prefill_chunk, iters=56)
    kv_rows = sum(min(int(ln), int(st) + Sc) for st, ln in zip(cstarts.tolist(), clens.tolist()))
    pairs = sum(min(st + t + 1, ln) for st, ln in zip(cstarts.tolist(), clens.tolist())
                for t in range(Sc))
    put("flash_attention_prefill_chunk", err, rel, ms, plain,
        2 * qp.numel() * 2 + kv_rows * G * D * 2 * 2 + 3 * B * 4, 4.0 * pairs * G * Hg * D,
        lib, f"B={B} Sc={Sc} G={G} Hg={Hg} D={D} T={SEQ} starts={cstarts.tolist()} "
             f"lengths={clens.tolist()} kv_row_map={rmap.tolist()}")
    del kc, vc
    log_attention_rows(out, 32)
    return out


# ---------------------------------------------------------------------------
# Phases 3 and 4: the model
# ---------------------------------------------------------------------------

def make_prompts(torch, cfg, gen):
    B, S = len(PROMPT_LENGTHS), max(PROMPT_LENGTHS)
    ids = torch.randint(0, cfg.vocab_size, (B, S), device="cuda", generator=gen)
    lengths = torch.tensor(PROMPT_LENGTHS, dtype=torch.int32, device="cuda")
    pad = torch.arange(S, device="cuda")[None, :] >= lengths[:, None]
    return ids.masked_fill(pad, 0), lengths  # right-padded


PARITY_MODES = [("int4g32", False), ("int8", False), ("int8", True), ("int4g32", True)]


def mode_name(quant, dyn):
    return quant + ("+dyn" if dyn else "")


def wrong_scale_tree(params):
    """``params`` with an indexing bug planted: layer 1's o_proj reads each
    group's (int4g32) or column's (int8) scale from its neighbour."""
    o = dict(params["layers"]["o_proj"])
    scale = o["weight_scale"].clone()
    scale[1] = scale[1].roll(1, dims=0)
    o["weight_scale"] = scale
    return {**params, "layers": {**params["layers"], "o_proj": o}}


def end_to_end_parity(torch, quant, dyn, seed=21, v2=False):
    """Kernel path vs plain path and vs the masked-softmax path at 6B widths
    and depth 2: max |Δlogits| / max|logits| over prefill and 8
    teacher-forced decode steps, each within the mode's limit; and two
    controls that must exceed it: the plain path on a tree with a wrong
    scale index, and (weight-only modes) the plain path in the other
    numerics mode, a wrong dispatch.  With ``v2`` every path's decode
    attends through B12 (``decode_attn_v2``): the kernel path must launch
    it and never B4."""
    from chatglm_q_tpu_torch import ops
    from chatglm_q_tpu_torch import ChatGLM2Config, TorchRuntimeConfig
    from chatglm_q_tpu_torch.bench import random_quantized_params
    from chatglm_q_tpu_torch.models import chatglm2 as M

    cfg = ChatGLM2Config(num_layers=2)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = random_quantized_params(cfg, quant, gen)
    ids, lengths = make_prompts(torch, cfg, gen)
    B, bf16 = ids.shape[0], torch.bfloat16
    tol = E2E_DYN_TOL if dyn else E2E_TOL

    def plain(d, flash=True):
        return TorchRuntimeConfig(use_kernels=False, use_flash_attention=flash, dynamic_int8=d,
                                  decode_attn_v2=v2)

    paths = {"kernel": (params, TorchRuntimeConfig(dynamic_int8=dyn, decode_attn_v2=v2)),
             "plain": (params, plain(dyn)), "masked": (params, plain(dyn, flash=False)),
             "wrong scale": (wrong_scale_tree(params), plain(dyn))}
    if not dyn:
        paths["wrong numerics"] = (params, plain(True))
    caches = {k: M.init_kv_cache(cfg, B, 256, bf16) for k in paths}
    ops.reset_launch_counts()
    logits = {}
    for k, (p, rt) in paths.items():
        logits[k], caches[k] = M.prefill(p, cfg, ids, lengths, caches[k], quant, bf16, rt)
    worst = dict.fromkeys(list(paths)[1:], 0.0)
    for step in range(9):
        require(torch.isfinite(logits["kernel"]).all(), f"non-finite logits at step {step}")
        for ref in worst:
            worst[ref] = max(worst[ref], rel_err(logits["kernel"], logits[ref])[1])
        if step == 8:
            break
        tok = torch.argmax(logits["kernel"], -1).to(torch.int32)  # teacher forcing
        for k, (p, rt) in paths.items():
            logits[k], caches[k] = M.decode_step(p, cfg, tok, caches[k], quant, bf16, rt)
    name = mode_name(quant, dyn) + (" v2" if v2 else "")
    if v2:
        counts = ops.launch_counts()
        require(counts["flash_attention_decode_v2"] > 0 and counts["flash_attention_decode"] == 0,
                f"{name}: decode_attn_v2 launched B12 {counts['flash_attention_decode_v2']}, "
                f"B4 {counts['flash_attention_decode']} times")
    log(f"  {name:12s} 6B widths, 2 layers, batch {B}, max rel logits err of "
        f"the kernel path vs: " + ", ".join(f"{k} {v:.3e}" for k, v in worst.items())
        + f" (limit {tol:.1e}; the controls, after masked, must exceed it)")
    for ref, v in worst.items():
        if ref in ("plain", "masked"):
            require(v <= tol, f"{name}: kernel path vs {ref} path: {v} > {tol}")
        else:
            require(v > tol, f"{name}: the {ref} control passes ({v} <= {tol})")
    return worst


# the f32 form each quantization's f32 forward takes at its 128 rows (the
# Hopper kernel's, after the split pass), and the kernels of the same
# matmul it must not launch
F32_KERNELS = {"int4g32": ("int4g32_mma_f32", ("int4g32_splitk", "int4g32_gemv")),
               "int8": ("int8_mma_f32", ("int8_splitk", "int8_gemv"))}
# and the backward's: the CUDA-core t_gemv, never the bf16 forms
F32_T_KERNELS = {"int4g32": ("int4g32_t_gemv", ("int4g32_t_splitk", "int4g32_t_mma")),
                 "int8": ("int8_t_gemv", ("int8_t_splitk", "int8_t_mma"))}


def f32_forward_parity(torch, quant, seed=24):
    """The parity forward (``models.chatglm2.forward``, the reference's
    semantics; f32 activations by default) at 6B widths, depth 2, in
    ``quant``, 2 x 64 tokens: the kernel path, whose linears take B1's or
    B6's f32 form (the Hopper kernel after the split pass), against the
    plain path, max
    |Δlogits| / max|logits| within F32_E2E_TOL, and the plain path on a tree
    with a wrong scale index (the control) outside it; then the f32 loss
    and grads of the same tree through the kernels (the backward's t_gemv)
    against the plain path's within F32_GRAD_TOL.  Returns the readings and
    the kernel runs' launch counts."""
    from chatglm_q_tpu_torch import ops
    from chatglm_q_tpu_torch import ChatGLM2Config, TorchRuntimeConfig
    from chatglm_q_tpu_torch.bench import random_quantized_params
    from chatglm_q_tpu_torch.models import chatglm2 as M
    from chatglm_q_tpu_torch.utils.train import loss_and_grads, partition_params

    cfg = ChatGLM2Config(num_layers=2)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = random_quantized_params(cfg, quant, gen)
    ids = torch.randint(0, cfg.vocab_size, (2, 64), device="cuda", generator=gen)
    ops.reset_launch_counts()
    _, got = M.forward(params, cfg, ids, quant_type=quant, dtype=torch.float32,
                       rt=TorchRuntimeConfig())
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    plain_rt = TorchRuntimeConfig(use_kernels=False)
    _, want = M.forward(params, cfg, ids, quant_type=quant, dtype=torch.float32, rt=plain_rt)
    _, wrong = M.forward(wrong_scale_tree(params), cfg, ids, quant_type=quant,
                         dtype=torch.float32, rt=plain_rt)
    require(got.dtype == torch.float32 and torch.isfinite(got).all(), "f32 forward: bad logits")
    rel, control = rel_err(got, want)[1], rel_err(got, wrong)[1]
    form, others = F32_KERNELS[quant]
    log(f"  {quant} f32 parity forward, 6B widths, 2 layers, 2 x 64 tokens: max rel logits err "
        f"of the kernel path vs plain {rel:.3e}, vs the wrong-scale control {control:.3e} (limit "
        f"{F32_E2E_TOL:.0e}); launches: {json.dumps({k: counts[k] for k in (form,) + others})}")
    require(rel <= F32_E2E_TOL, f"{quant} f32 forward: kernel path vs plain {rel} > {F32_E2E_TOL}")
    require(control > F32_E2E_TOL,
            f"{quant} f32 forward: the wrong-scale control passes ({control})")
    require(counts[form] == counts["split_bf16x3_pass"] == 6 * cfg.num_layers + 1
            and not any(counts[k] for k in others), f"{quant} f32 forward: launches {counts}")
    trainable, frozen = partition_params(params)
    labels = ids.clone()
    labels[:, :8] = -100
    ops.reset_launch_counts()
    kern = loss_and_grads(cfg, quant, trainable, frozen, ids, labels, torch.float32,
                          TorchRuntimeConfig())
    torch.cuda.synchronize()
    t_counts = ops.launch_counts()
    plain = loss_and_grads(cfg, quant, trainable, frozen, ids, labels, torch.float32, plain_rt)
    dl, dg = grad_rel(torch, kern, plain)
    t_gemv, t_others = F32_T_KERNELS[quant]
    log(f"  {quant} f32 loss and grads: kernel path vs plain |Δloss|/|loss| {dl:.3e}, grads "
        f"{dg:.3e} (limit {F32_GRAD_TOL:.0e}); launches: "
        f"{json.dumps({k: t_counts[k] for k in (t_gemv,) + t_others})}")
    require(dl <= F32_GRAD_TOL and dg <= F32_GRAD_TOL,
            f"{quant} f32 grads: kernel path vs plain loss {dl}, grads {dg} > {F32_GRAD_TOL}")
    require(t_counts[t_gemv] == 6 * cfg.num_layers + 1
            and not any(t_counts[k] for k in t_others), f"{quant} f32 grads: launches {t_counts}")
    for k, v in t_counts.items():
        counts[k] += v
    return {"rel_err": rel, "wrong_scale_control": control, "grads_vs_plain": [dl, dg]}, counts


GRAD_MODES = [("int4g32", False), ("int8", False), ("int8", True)]
GRAD_SEEDS = (91, 92, 93)


def wrong_backward(torch, quant):
    """A planted bug in the backward's kernel call: B14 reading each group's
    scale from the next group, or B13 folding each column's scale from its
    neighbour.  Returns the name in ``ops.linear`` it replaces, and the
    function to put there."""
    from chatglm_q_tpu_torch.ops import int8_matmul as I8
    from chatglm_q_tpu_torch.ops import quant_matmul as QM

    if quant == "int4g32":
        return "int4g32_matmul_t", lambda g, p, s: QM.int4g32_matmul_t(g, p, s.roll(-1, dims=0))
    return "int8_matmul_t", lambda g, w, s: I8.int8_matmul_t(g, w, s.roll(1))


def grad_rel(torch, a, b):
    """(|Δloss| / |loss|, the largest over leaves of max |Δgrad| / max |grad|)
    of run ``a`` against run ``b``, each a (loss, grads) pair."""
    dl = abs(a[0].item() - b[0].item()) / abs(b[0].item())
    dg = max(rel_err(x, y)[1] for x, y in zip(a[1], b[1]))
    return dl, dg


def grad_parity(torch, quant, dyn, seed):
    """Phase 3b: at 6B widths and depth 2, bf16, batch 2 × 128 tokens, the
    loss and every trainable leaf's grad (the f32 norm masters) of the
    kernel path against the plain path on the same tree, and of the kernel
    path with a planted backward bug."""
    from chatglm_q_tpu_torch import ChatGLM2Config, TorchRuntimeConfig
    from chatglm_q_tpu_torch.bench import random_quantized_params
    from chatglm_q_tpu_torch.ops import linear as TL
    from chatglm_q_tpu_torch.utils.train import loss_and_grads, partition_params

    cfg = ChatGLM2Config(num_layers=2)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = random_quantized_params(cfg, quant, gen)
    ids = torch.randint(0, cfg.vocab_size, (2, 128), device="cuda", generator=gen)
    labels = ids.clone()
    labels[:, :16] = -100
    trainable, frozen = partition_params(params)

    def run(use_kernels):
        rt = TorchRuntimeConfig(use_kernels=use_kernels, dynamic_int8=dyn)
        return loss_and_grads(cfg, quant, trainable, frozen, ids, labels, torch.bfloat16, rt)

    kern, plain = run(True), run(False)
    name, bug = wrong_backward(torch, quant)
    good = getattr(TL, name)
    setattr(TL, name, bug)
    try:
        control = run(True)
    finally:
        setattr(TL, name, good)
    for lo, gr in (kern, plain):
        require(math.isfinite(lo.item()) and all(torch.isfinite(g).all() for g in gr),
                f"{mode_name(quant, dyn)} seed {seed}: non-finite loss or grads")
    return {"kernel_vs_plain": grad_rel(torch, kern, plain),
            "control_vs_plain": grad_rel(torch, control, plain)}


def check_grad_parity(torch):
    """Phase 3b over GRAD_MODES × GRAD_SEEDS: each reading within
    (GRAD_LOSS_TOL, GRAD_TOL), each planted control's grads above GRAD_TOL."""
    out = {}
    for quant, dyn in GRAD_MODES:
        name = mode_name(quant, dyn)
        for seed in GRAD_SEEDS:
            r = grad_parity(torch, quant, dyn, seed)
            out[f"{name} seed {seed}"] = r
            (dl, dg), (_, cg) = r["kernel_vs_plain"], r["control_vs_plain"]
            log(f"  {name:12s} seed {seed}: kernel vs plain |Δloss|/|loss| {dl:.3e}, grads "
                f"{dg:.3e}; control grads {cg:.3e} (limits {GRAD_LOSS_TOL:.1e}, {GRAD_TOL:.1e})")
            require(dl <= GRAD_LOSS_TOL and dg <= GRAD_TOL,
                    f"{name} seed {seed}: kernel vs plain path loss {dl}, grads {dg}")
            require(cg > GRAD_TOL, f"{name} seed {seed}: the planted backward bug passes ({cg})")
    return out


def full_slice(torch, smi):
    from chatglm_q_tpu_torch import ChatGLM2Config, TorchRuntimeConfig
    from chatglm_q_tpu_torch import ops
    from chatglm_q_tpu_torch.bench import decode_rate, random_quantized_params, \
        weight_bytes_per_token
    from chatglm_q_tpu_torch.models import chatglm2 as M
    from chatglm_q_tpu_torch.utils import graphs as G

    cfg = ChatGLM2Config()
    rt = TorchRuntimeConfig()
    bf16 = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(31)
    t0 = time.perf_counter()
    params = random_quantized_params(cfg, "int4g32", gen)
    torch.cuda.synchronize()
    wbytes = weight_bytes_per_token(params)
    log(f"  ChatGLM2-6B int4g32 random weights on the card in {time.perf_counter() - t0:.1f} s; "
        f"{wbytes / 1e9:.3f} GB of weights per decode token")
    ids, lengths = make_prompts(torch, cfg, gen)
    B = ids.shape[0]
    cache = M.init_kv_cache(cfg, B, CACHE_LEN, bf16)
    cache1 = M.init_kv_cache(cfg, 1, CACHE_LEN, bf16)
    sample_gen = torch.Generator(device="cuda").manual_seed(32)

    ops.reset_launch_counts()
    logits, cache = M.prefill(params, cfg, ids, lengths, cache, "int4g32", bf16, rt)
    first = torch.argmax(logits, -1).to(torch.int32)
    toks, cache = M.multi_step_decode(params, cfg, first, cache, 32, None, "int4g32", bf16, rt)
    logits1, cache1 = M.prefill(params, cfg, ids[:1], lengths[:1], cache1, "int4g32", bf16, rt)
    first1 = torch.argmax(logits1, -1).to(torch.int32)
    toks1, cache1 = M.multi_step_decode(params, cfg, first1, cache1, 16, sample_gen,
                                        "int4g32", bf16, rt, top_k=100, top_p=0.8)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    log(f"  main-path launch counts: {json.dumps(counts)}")

    require(logits.shape == (B, cfg.vocab_size), f"prefill logits shape {tuple(logits.shape)}")
    require(torch.isfinite(logits).all() and torch.isfinite(logits1).all(),
            "non-finite prefill logits")
    for t in (toks, toks1):
        require(((t >= 0) & (t < cfg.vocab_size)).all(), "token out of range")
    require(toks.shape == (B, 32) and toks1.shape == (1, 16), "wrong token counts")
    want_len = torch.tensor(PROMPT_LENGTHS, dtype=torch.int32) + 32
    require(torch.equal(cache.lengths.cpu(), want_len), f"cache lengths {cache.lengths.tolist()}")
    log(f"  greedy tokens (first 8 per request): {toks[:, :8].tolist()}")
    log(f"  top-p tokens: {toks1[0].tolist()}")
    missing = [k for k in INT4_PATH_KERNELS if counts[k] == 0]
    require(not missing, f"kernels not launched on the main path: {missing}")
    require(counts["int4g32_gemv"] == 0, "a bf16 run launched B1's f32 gemv")
    # the decode ran from captured graphs, and its tokens are the eager loop's
    prog = M.decode_program(params, cfg, cache, "int4g32", bf16, rt)
    require(prog.graph is not None and prog.replays == 31,
            f"the batch-4 decode was not replayed from a graph ({prog.replays} replays)")
    eager = TorchRuntimeConfig(cuda_graphs=False)
    ce = M.init_kv_cache(cfg, B, CACHE_LEN, bf16)
    le, ce = M.prefill(params, cfg, ids, lengths, ce, "int4g32", bf16, eager)
    toks_e, ce = M.multi_step_decode(params, cfg, torch.argmax(le, -1).to(torch.int32), ce, 32,
                                     None, "int4g32", bf16, eager)
    ce1 = M.init_kv_cache(cfg, 1, CACHE_LEN, bf16)
    le1, ce1 = M.prefill(params, cfg, ids[:1], lengths[:1], ce1, "int4g32", bf16, eager)
    sample_gen.manual_seed(32)
    toks1_e, _ = M.multi_step_decode(params, cfg, torch.argmax(le1, -1).to(torch.int32), ce1, 16,
                                     sample_gen, "int4g32", bf16, eager, top_k=100, top_p=0.8)
    require(torch.equal(toks, toks_e), "the captured greedy tokens differ from the eager loop's")
    require(torch.equal(toks1, toks1_e),
            "the captured top-p tokens differ from the eager loop's on the same seed")
    log(f"  decode from captured graphs ({G.programs(params).captures} captures): greedy and "
        f"top-p tokens equal to the eager loop's (cuda_graphs=False)")
    del ce, ce1

    # launches of one batch-4 decode step, for the kernel table
    ops.reset_launch_counts()
    M.decode_step(params, cfg, toks[:, -1], cache, "int4g32", bf16, rt)
    per_step = ops.launch_counts()
    ops.reset_launch_counts()
    log(f"  launches per decode step: {json.dumps(per_step)}")
    require(per_step["flash_attention_decode"] == cfg.num_layers,
            f"flash_attention_decode launched {per_step['flash_attention_decode']} times a step")
    require_fused_append(per_step, cfg, "a batch-4 decode step")
    require(per_step["int4g32_splitk"] == 6 * cfg.num_layers + 1 and per_step["int4g32_gemv"] == 0
            and per_step["int4g32_mma"] == 0,
            f"a decode step's B1 launches: {per_step['int4g32_splitk']} split-K, "
            f"{per_step['int4g32_gemv']} gemv, {per_step['int4g32_mma']} mma (want 169 split-K)")
    del cache, cache1

    perf = {"card": smi, "weight_bytes_per_token": wbytes, "launches_per_decode_step": per_step}
    # in turns, each at batch 1 and 4: eager, captured (B4), captured
    # decode_attn_v2 (B12) twice, captured (B4), eager
    rt_v2 = TorchRuntimeConfig(decode_attn_v2=True)
    order = (("eager", eager), ("captured", rt), ("v2", rt_v2), ("v2", rt_v2),
             ("captured", rt), ("eager", eager))
    turns = {batch: {k: [] for k in ("eager", "captured", "v2")} for batch in (1, B)}
    v2_counts = {}
    for name, r_t in order:
        for batch in (1, B):
            ops.reset_launch_counts()
            turns[batch][name].append(decode_rate(params, cfg, "int4g32", batch, 128, CACHE_LEN,
                                                  r_t))
            if name == "v2":
                v2_counts = {k: v2_counts.get(k, 0) + n for k, n in ops.launch_counts().items()}
    ops.reset_launch_counts()
    require(v2_counts["flash_attention_decode_v2"] > 0 and v2_counts["flash_attention_decode"] == 0,
            f"decode_attn_v2 runs launched B12 {v2_counts['flash_attention_decode_v2']}, "
            f"B4 {v2_counts['flash_attention_decode']} times")
    for batch in (1, B):
        t = {k: [r["decode_ms_per_step"] for r in v] for k, v in turns[batch].items()}
        perf[f"batch{batch}"] = turns[batch]["captured"][0]
        perf[f"batch{batch}_turns_ms_per_step"] = t
        perf[f"batch{batch}_prefill_ms"] = [r["prefill_ms"] for r in turns[batch]["captured"]]
        log(f"  batch {batch} decode, cache {CACHE_LEN}, ms/step in turns: eager "
            f"{t['eager'][0]:.3f}, captured {t['captured'][0]:.3f}, captured decode_attn_v2 (B12) "
            f"{t['v2'][0]:.3f} / {t['v2'][1]:.3f}, captured {t['captured'][1]:.3f}, eager "
            f"{t['eager'][1]:.3f}; prefill {batch}x128 tokens "
            f"{turns[batch]['captured'][0]['prefill_ms']:.2f} ms  [{smi}]")
    log(f"  decode_attn_v2 runs: B12 launched {v2_counts['flash_attention_decode_v2']} times, B4 0")
    perf["profile"] = profile_decode(torch, params, cfg, rt)
    busy = perf["profile"]["device_ms_per_step"] / perf["batch1"]["decode_ms_per_step"]
    perf["profile"]["device_busy_share_untraced"] = busy
    log(f"  batch-1 decode: device busy {100 * busy:.1f}% of the untraced step")
    perf["prefill_profile"] = {b: profile_prefill(torch, params, cfg, rt, b) for b in (1, B)}
    perf["captured_prefill"] = captured_prefill(torch, params, cfg, smi)
    return counts, v2_counts, perf


# the prefill programs phase 4 holds against the eager prefill: (name,
# batch, prompt tokens); 57 tokens take the 64-token bucket
PREFILL_CASES = (("1x128", 1, 128), ("4x128", 4, 128), ("1x57", 1, 57))
PREFILL_TURNS = ("eager", "captured") * 4  # the captured calls: warm-up, capture, replays


def device_ms_traced(torch, run):
    """The device time of ``run()`` by torch.profiler: the sum of its CUDA
    kernels' device ms (a graph replay's kernels included)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile

    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / 1e3


def captured_prefill(torch, params, cfg, smi):
    """The prefill program of a bucket (``prefill_program``: eager on its
    first call, captured on its second, replayed after) against the same
    program run eagerly (``cuda_graphs=False``) on the same right-padded
    prompts, in turns: every call's logits and, after the last, every valid
    cache slot bit-equal; every call's kernel launches equal.  ms a call
    (host clock to a sync) by call, and the device ms of an eager call and
    of a replay (torch.profiler; a replay also by CUDA events)."""
    from chatglm_q_tpu_torch import TorchRuntimeConfig, ops
    from chatglm_q_tpu_torch.models import chatglm2 as M
    from chatglm_q_tpu_torch.utils.timing import cuda_event_ms

    bf16 = torch.bfloat16
    rts = {"captured": TorchRuntimeConfig(), "eager": TorchRuntimeConfig(cuda_graphs=False)}
    gen = torch.Generator(device="cuda").manual_seed(34)
    out = {}
    for name, B, n in PREFILL_CASES:
        S = M.prompt_bucket(n, CACHE_LEN)
        ids = torch.zeros((B, S), dtype=torch.long, device="cuda")
        ids[:, :n] = torch.randint(0, cfg.vocab_size, (B, n), device="cuda", generator=gen)
        lengths = torch.full((B,), n, dtype=torch.int32, device="cuda")
        caches = {k: M.init_kv_cache(cfg, B, CACHE_LEN, bf16) for k in rts}
        progs = {k: M.prefill_program(params, cfg, caches[k], S, "int4g32", bf16, r)
                 for k, r in rts.items()}
        require(progs["captured"].capture and not progs["eager"].capture,
                f"prefill {name}: the programs' capture flags {progs['captured'].capture}, "
                f"{progs['eager'].capture}")

        def call(kind):
            prog, cache = progs[kind], caches[kind]
            prog.load(ids=ids, lengths=lengths)
            ops.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits = prog.step(params, cache.k, cache.v)["logits"].clone()
            torch.cuda.synchronize()
            return logits, (time.perf_counter() - t0) * 1e3, ops.launch_counts()

        calls = {k: [] for k in rts}
        for kind in PREFILL_TURNS:
            calls[kind].append(call(kind))
        for i, ((le, _, ce), (lc, _, cc)) in enumerate(zip(calls["eager"], calls["captured"])):
            require(torch.equal(le, lc), f"prefill {name}: call {i + 1}'s captured logits differ "
                                         "from the eager ones")
            require(ce == cc, f"prefill {name}: call {i + 1} launched {cc}, eager {ce}")
        for part in ("k", "v"):
            a, b = getattr(caches["eager"], part), getattr(caches["captured"], part)
            require(torch.equal(a[:, :, :, :n], b[:, :, :, :n]),
                    f"prefill {name}: the captured cache's valid {part} slots differ")
        prog = progs["captured"]
        require(prog.graph is not None and prog.replays >= 3,
                f"prefill {name}: {prog.replays} replays of a captured graph")
        replay = lambda i: prog.step(params, caches["captured"].k, caches["captured"].v)  # noqa
        dev_eager = device_ms_traced(torch, lambda: progs["eager"].step(
            params, caches["eager"].k, caches["eager"].v))
        dev_replay = device_ms_traced(torch, lambda: replay(0))
        event_ms = cuda_event_ms(replay, iters=5, warmup=1)
        ms = {k: [c[1] for c in v] for k, v in calls.items()}
        out[name] = {"bucket": S, "tokens": n, "batch": B, "ms_eager": ms["eager"],
                     "ms_captured": ms["captured"], "device_ms_eager": dev_eager,
                     "device_ms_replay": dev_replay, "replay_event_ms": event_ms,
                     "launches": {k: v for k, v in calls["eager"][0][2].items() if v}}
        log(f"  captured prefill {name} (bucket {S}): logits and valid cache slots bit-equal to "
            f"the eager prefill, launches equal; ms a call in turns: eager "
            + ", ".join(f"{x:.2f}" for x in ms["eager"]) + "; captured (warm-up, capture, "
            "replays) " + ", ".join(f"{x:.2f}" for x in ms["captured"])
            + f"; device ms eager {dev_eager:.3f}, replay {dev_replay:.3f} (CUDA events "
            f"{event_ms:.3f})  [{smi}]")
        del caches, progs
    return out


def require_fused_append(counts, cfg, what):
    """A decode step rotates and writes K/V in one launch a layer: the fused
    kernel 28 times, the write-only B3 / B9 never."""
    require(counts.get("rope_kv_append", 0) == cfg.num_layers
            and not counts.get("kv_cache_write_idx") and not counts.get("kv_pool_write_idx"),
            f"{what}: rope_kv_append launched {counts.get('rope_kv_append', 0)} times "
            f"(want {cfg.num_layers}), B3 {counts.get('kv_cache_write_idx', 0)}, "
            f"B9 {counts.get('kv_pool_write_idx', 0)}")


# torch.profiler can drop CUDA activity records in a burst of launches (seen
# once on an H100: a 4 x 128 int8+dyn prefill's trace held 166 of the 168
# Hopper launches its wrappers count in every run).  A trace whose count of
# the kernel it reads falls short of the launches the run makes is taken
# again, up to TRACE_TRIES times; the count must then be exact.
TRACE_TRIES = 3


def launches_in(prof, steps, *subs):
    """(launches / steps, device ms / steps) of the kernels whose profiler
    name holds every substring of ``subs``."""
    from torch.autograd import DeviceType

    hit = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
           and e.self_device_time_total > 0 and all(k in e.key for k in subs)]
    return (sum(e.count for e in hit) / steps,
            sum(e.self_device_time_total for e in hit) / 1e3 / steps)


def trace_until(torch, run, want, steps, subs, what):
    """torch.profiler's trace of ``run()`` (its result kept) in which the
    kernels ``subs`` name show ``want`` launches a step, after up to
    TRACE_TRIES tries; (profile, run's result)."""
    from torch.profiler import ProfilerActivity, profile as tprofile

    for _ in range(TRACE_TRIES):
        with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            out = run()
            torch.cuda.synchronize()
        n = launches_in(prof, steps, *subs)[0]
        if n == want:
            return prof, out
        log(f"    the trace of {what} holds {n} {subs[0]} launches a step, not {want}: "
            f"traced again")
    require(False, f"{what} ran {n} {subs[0]} launches a step by its trace, not {want}")


def profile_prefill(torch, params, cfg, rt, batch, quant="int4g32", kernel="int4_wgmma_kernel",
                    ids=None):
    """Device time of one prefill of ``batch`` 128-token prompts (or of the
    prompt ``ids`` (1, S)) of ``quant`` weights, by kernel, from a
    torch.profiler trace, the Hopper matmul ``kernel`` apart (its 6 x 28
    launches run at M = batch x S), beside the untraced host-clock prefill
    (the median of three).  Under ``rt.dynamic_int8`` the per-row quantizer
    (``dyn_quantize_rows``, the prologue of every dynamic matmul) runs in a
    traced range of its own for that one run: its kernels' device ms."""
    from torch.autograd import DeviceType
    from torch.profiler import record_function

    from chatglm_q_tpu_torch.models import chatglm2 as M
    from chatglm_q_tpu_torch.ops import dyn_matmul as D
    from chatglm_q_tpu_torch.utils.timing import wall_s

    if ids is None:
        gen = torch.Generator(device="cuda").manual_seed(33)
        ids = torch.randint(0, cfg.vocab_size, (batch, 128), device="cuda", generator=gen)
    batch, S = ids.shape
    lengths = torch.full((batch,), S, dtype=torch.int32, device="cuda")
    run = lambda: M.prefill(params, cfg, ids, lengths,  # noqa: E731
                            M.init_kv_cache(cfg, batch, CACHE_LEN, torch.bfloat16), quant,
                            torch.bfloat16, rt)
    run()
    untraced_ms = wall_s(run) * 1e3
    quantize = D.dyn_quantize_rows

    def traced_quantize(x):
        with record_function("dyn_quantize_rows"):
            return quantize(x)

    D.dyn_quantize_rows = traced_quantize
    try:
        prof, _ = trace_until(torch, run, 6 * cfg.num_layers, 1, (kernel,),
                              f"a {batch}x{S} {quant} prefill")
    finally:
        D.dyn_quantize_rows = quantize
    averages = prof.key_averages()
    events = [e for e in averages if e.device_type == DeviceType.CUDA
              and e.self_device_time_total > 0 and e.key != "dyn_quantize_rows"]
    events.sort(key=lambda e: -e.self_device_time_total)
    dev_ms = sum(e.self_device_time_total for e in events) / 1e3
    mm_n, mm_ms = launches_in(prof, 1, kernel)
    pro = [e for e in averages if e.key == "dyn_quantize_rows" and e.device_type == DeviceType.CPU]
    pro_ms = sum(e.device_time_total for e in pro) / 1e3
    pro_n = sum(e.count for e in pro)
    require(pro_n == (6 * cfg.num_layers + 1 if rt.dynamic_int8 else 0),
            f"a {batch}x{S} {quant} prefill quantized {pro_n} activations")
    top = [(e.key[:60], round(e.self_device_time_total / 1e3, 4), e.count) for e in events[:6]]
    pro_s = (f"; the quantize prologue {pro_ms:.3f} ms in {pro_n} calls" if pro_n else "")
    log(f"  {quant}{'+dyn' if rt.dynamic_int8 else ''} prefill {batch}x{S} profile: device "
        f"{dev_ms:.3f} ms against {untraced_ms:.2f} ms untraced; {kernel} {mm_ms:.3f} ms in "
        f"{mm_n} launches ({100 * mm_ms / dev_ms:.1f}% of the device time){pro_s}; largest (ms) "
        f"{json.dumps(top)}")
    return {"device_ms": dev_ms, "untraced_ms": untraced_ms, "kernel": kernel,
            "kernel_ms": mm_ms, "kernel_launches": mm_n, "prologue_ms": pro_ms,
            "prologue_calls": pro_n, "top_ms": top}


def profile_decode(torch, params, cfg, rt, quant="int4g32"):
    """Device time of decode steps at batch 1 (replays of the captured step
    unless ``rt.cuda_graphs`` is False), by kernel, from a torch.profiler
    trace; then the host's time by function (cProfile)."""
    from torch.autograd import DeviceType

    from chatglm_q_tpu_torch.models import chatglm2 as M

    cache = M.init_kv_cache(cfg, 1, CACHE_LEN, torch.bfloat16)
    ids = torch.zeros((1, 128), dtype=torch.long, device="cuda")
    lengths = torch.full((1,), 128, dtype=torch.int32, device="cuda")
    logits, cache = M.prefill(params, cfg, ids, lengths, cache, quant, torch.bfloat16, rt)
    first = torch.argmax(logits, -1).to(torch.int32)
    steps = 8
    mode = mode_name(quant, rt.dynamic_int8)
    label, subs = DECODE_KERNELS[mode]

    def timed():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        M.multi_step_decode(params, cfg, first, cache, steps, None, quant, torch.bfloat16, rt)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    timed()  # the decode program's warm-up step and capture, outside the trace
    # one launch a linear, no second pass (counted in the replayed graph)
    prof, wall = trace_until(torch, timed, 6 * cfg.num_layers + 1, steps, subs,
                             f"a batch-1 {mode} decode step")
    # device-side events only (kernels, copies): an operator's device time
    # is its kernels' time, so summing both would count it twice
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    events.sort(key=lambda e: -e.self_device_time_total)
    dev_us = sum(e.self_device_time_total for e in events)
    top = [(e.key[:80], round(e.self_device_time_total / steps, 1), e.count // steps)
           for e in events[:12]]
    attn = [e for e in events if "decode_attn_kernel" in e.key]
    attn_ms = sum(e.self_device_time_total for e in attn) / 1e3 / steps
    attn_launches = sum(e.count for e in attn) / steps
    mm_launches, mm_ms = launches_in(prof, steps, *subs)
    append_launches, append_ms = launches_in(prof, steps, "rope_kv_append_kernel")
    launches = sum(e.count for e in events) / steps  # every kernel, copy and fill
    require(not any("splitk_reduce_kernel" in e.key for e in events),
            f"the {mode} decode ran splitk_reduce_kernel")
    log(f"  {mode} profile: {steps} decode steps at batch 1, wall {wall * 1e3 / steps:.3f} "
        f"ms/step (traced), device busy {dev_us / 1e3 / steps:.3f} ms/step "
        f"({100 * dev_us / 1e6 / wall:.1f}% of wall)")
    for name, us, n in top:
        log(f"    {us:9.1f} us/step  x{n:<4d} {name}")
    log(f"  decode_attn_kernel: {attn_ms:.4f} ms of device time per batch-1 step "
        f"({attn_launches:.0f} launches; 1.2 ms before its redesign)")
    log(f"  {label}: {mm_ms:.4f} ms of device time per batch-1 {mode} step "
        f"({mm_launches:.0f} launches; no splitk_reduce_kernel)")
    log(f"  rope_kv_append_kernel: {append_ms:.4f} ms of device time per batch-1 {mode} step "
        f"({append_launches:.1f} launches); the traced step's device launches: {launches:.1f}")

    # where the host's time goes (cProfile inflates Python-heavy frames;
    # read it for ranking, not for absolute times)
    import cProfile
    import io
    import pstats

    prof_host = cProfile.Profile()
    torch.cuda.synchronize()
    prof_host.enable()
    M.multi_step_decode(params, cfg, first, cache, steps, None, quant, torch.bfloat16, rt)
    torch.cuda.synchronize()
    prof_host.disable()
    buf = io.StringIO()
    pstats.Stats(prof_host, stream=buf).sort_stats("tottime").print_stats(14)
    log("  host profile of the same steps (cProfile, by own time):")
    for line in buf.getvalue().splitlines():
        if line.strip():
            log("    " + line.strip()[:150])
    return {"wall_ms_per_step": wall * 1e3 / steps, "device_ms_per_step": dev_us / 1e3 / steps,
            "top_us_per_step": top, "decode_attn_kernel_ms_per_step": attn_ms,
            "decode_attn_kernel_launches_per_step": attn_launches,
            "splitk_kernel": label, "splitk_ms_per_step": mm_ms,
            "splitk_launches_per_step": mm_launches, "device_launches_per_step": launches,
            "rope_kv_append_ms_per_step": append_ms,
            "rope_kv_append_launches_per_step": append_launches}


# ---------------------------------------------------------------------------
# Phase 5: the chat entry point
# ---------------------------------------------------------------------------

def chat_tokenizer():
    """A tokenizer with ChatGLM2-6B's 65024 ids: 3 control and 256 byte
    pieces, synthetic text pieces, and the 5 special tokens at the top, so
    every id the model can emit decodes to text or is a special token (a
    small vocabulary would decode most random-weight tokens to nothing)."""
    from chatglm_q_tpu_torch.tokenizer import ChatGLM2Tokenizer
    from chatglm_q_tpu_torch.tokenizer.build import build_unigram_model

    n = 65024 - 5 - 3 - 256
    return ChatGLM2Tokenizer(build_unigram_model({f"w{i}": -float(i) for i in range(n)}))


def model_level_text(torch, params, cfg, quant, rt, tokenizer, ids, eos):
    """The greedy text of ``prefill`` + ``multi_step_decode`` on ``ids``, cut
    after eos as the decoder cuts it; and the launches of that prefill and of
    one batch-1 decode step."""
    from chatglm_q_tpu_torch import ops
    from chatglm_q_tpu_torch.models import chatglm2 as M
    from chatglm_q_tpu_torch.serving import process_response

    bf16 = torch.bfloat16
    cache = M.init_kv_cache(cfg, 1, CACHE_LEN, bf16)
    prompt = torch.tensor([ids], device="cuda")
    lengths = torch.tensor([len(ids)], dtype=torch.int32, device="cuda")
    ops.reset_launch_counts()
    logits, cache = M.prefill(params, cfg, prompt, lengths, cache, quant, bf16, rt)
    per_prefill = ops.launch_counts()
    first = torch.argmax(logits, -1).to(torch.int32)
    toks, cache = M.multi_step_decode(params, cfg, first, cache, CHAT_TOKENS - 1, None, quant,
                                      bf16, rt)
    ops.reset_launch_counts()
    M.decode_step(params, cfg, toks[:, -1], cache, quant, bf16, rt)
    per_step = ops.launch_counts()
    ops.reset_launch_counts()
    out = [int(first[0])] + toks[0].tolist()
    if eos in out:
        out = out[: out.index(eos) + 1]
    launches = {"per_prefill": {k: v for k, v in per_prefill.items() if v},
                "per_decode_step": {k: v for k, v in per_step.items() if v}}
    return process_response(tokenizer.decode(out)), out, launches


def run_generate(decoder, prompt, tokens=CHAT_TOKENS, **kw):
    """(the streamed texts, the final text, host ms a token between the
    first and the last streamed text) of ``tokens`` greedy tokens."""
    it = decoder.generate(prompt, max_generated_tokens=tokens, temperature=0.0, **kw)
    stream, stamps = [], []
    while True:
        try:
            stream.append(next(it))
            stamps.append(time.perf_counter())
        except StopIteration as e:
            require(len(stamps) >= 8, f"generate streamed {len(stamps)} texts")
            return stream, e.value, (stamps[-1] - stamps[0]) * 1e3 / (len(stamps) - 1)


def first_token_ms(torch, decoder, prompt):
    """Host ms from ``generate``'s call to its first streamed text (the
    prompt's prefill program, the first token sampled and decoded to text)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    it = decoder.generate(prompt, max_generated_tokens=CHAT_TOKENS, temperature=0.0)
    try:
        next(it)
    except StopIteration:
        pass
    ms = (time.perf_counter() - t0) * 1e3
    it.close()
    return ms


def map_tree(tree, fn):
    return {k: map_tree(v, fn) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


def tree_leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from tree_leaves(v, prefix + k + ".")
        else:
            yield prefix + k, v


def round_trip(torch, quant, tokenizer):
    """save_pretrained → GLMDecoder.from_pretrained at 6B widths, depth 2,
    in a temporary directory under the (gitignored) build directory:
    identical tensors and equal logits."""
    import tempfile

    from chatglm_q_tpu_torch import ChatGLM2Config, GLMLoadConfig, TorchRuntimeConfig
    from chatglm_q_tpu_torch.bench import random_quantized_params
    from chatglm_q_tpu_torch.models import chatglm2 as M
    from chatglm_q_tpu_torch.ops import _build
    from chatglm_q_tpu_torch.serving import GLMDecoder

    bf16 = torch.bfloat16
    cfg = ChatGLM2Config(num_layers=2)
    gen = torch.Generator(device="cuda").manual_seed(51)
    # the values a bfloat16 checkpoint stores: every float leaf rounded to bf16
    params = map_tree(random_quantized_params(cfg, quant, gen),
                      lambda t: t.to(bf16).to(t.dtype) if t.is_floating_point() else t)
    rt = TorchRuntimeConfig()
    decoder = GLMDecoder(GLMLoadConfig(model_config=cfg, quant_type=quant, torch_dtype="bfloat16"),
                         params, tokenizer, rt=rt)
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
        t0 = time.perf_counter()
        decoder.save_pretrained(tmp)
        t1 = time.perf_counter()
        loaded = GLMDecoder.from_pretrained(tmp, rt=rt)
        t2 = time.perf_counter()
        disk = sum(f.stat().st_size for f in pathlib.Path(tmp).iterdir())
        files = len(loaded.config.weight_files)
    a, b = dict(tree_leaves(params)), dict(tree_leaves(loaded.params))
    require(a.keys() == b.keys(), f"round trip {quant}: keys differ")
    for k in a:
        require(a[k].dtype == b[k].dtype and a[k].shape == b[k].shape and b[k].device == a[k].device
                and torch.equal(a[k], b[k]), f"round trip {quant}: {k} differs")
    ids, lengths = make_prompts(torch, cfg, gen)
    logits = []
    for p in (params, loaded.params):
        cache = M.init_kv_cache(cfg, ids.shape[0], 256, bf16)
        logits.append(M.prefill(p, cfg, ids, lengths, cache, quant, bf16, rt)[0])
    require(torch.equal(logits[0], logits[1]), f"round trip {quant}: logits differ")
    log(f"  round trip {quant}: 6B widths, 2 layers, {disk / 1e9:.3f} GB in {files} safetensors "
        f"files; save {t1 - t0:.1f} s, from_pretrained {t2 - t1:.1f} s; {len(a)} tensors "
        f"identical, prefill logits equal")
    return {"bytes_on_disk": disk, "files": files, "save_s": t1 - t0, "load_s": t2 - t1}


def chat_slice(torch, smi):
    from chatglm_q_tpu_torch import ChatGLM2Config, GLMLoadConfig, TorchRuntimeConfig, ops
    from chatglm_q_tpu_torch.bench import decode_rate, random_quantized_params, \
        weight_bytes_per_token
    from chatglm_q_tpu_torch.models import chatglm2 as M
    from chatglm_q_tpu_torch.serving import GLMDecoder, chat_template

    cfg = ChatGLM2Config()
    t0 = time.perf_counter()
    tokenizer = chat_tokenizer()
    require(len(tokenizer) == cfg.vocab_size, f"tokenizer has {len(tokenizer)} ids")
    prompt = chat_template([], CHAT_QUESTION)
    ids = tokenizer.encode(prompt)
    require(16 < len(ids) <= 64, f"chat prompt of {len(ids)} tokens")
    log(f"  tokenizer of {len(tokenizer)} ids built in {time.perf_counter() - t0:.1f} s; "
        f"chat prompt {len(ids)} tokens")
    counts, perf, params, loaded = {}, {}, None, None
    for quant, dyn, kernels in CHAT_MODES:
        name = mode_name(quant, dyn)
        if loaded != quant:
            params = None
            torch.cuda.empty_cache()
            params = random_quantized_params(cfg, quant,
                                             torch.Generator(device="cuda").manual_seed(41))
            torch.cuda.synchronize()
            loaded = quant
            log(f"  ChatGLM2-6B {quant}, 28 layers, random weights: "
                f"{weight_bytes_per_token(params) / 1e9:.3f} GB of weights per decode token")
        rt = TorchRuntimeConfig(dynamic_int8=dyn)
        eager = TorchRuntimeConfig(dynamic_int8=dyn, cuda_graphs=False)
        load = GLMLoadConfig(model_config=cfg, quant_type=quant, torch_dtype="bfloat16")
        decoder = GLMDecoder(load, params, tokenizer, max_sequence_length=CACHE_LEN, rt=rt)
        eager_decoder = GLMDecoder(load, params, tokenizer, max_sequence_length=CACHE_LEN,
                                   rt=eager)
        ops.reset_launch_counts()
        stream, final, _ = run_generate(decoder, prompt)
        torch.cuda.synchronize()
        c = ops.launch_counts()
        counts[name] = c
        step = M.decode_program(params, cfg, decoder._free_caches[0][0], quant, torch.bfloat16, rt)
        require(step.graph is not None and step.replays >= CHAT_TOKENS - 3,
                f"{name}: GLMDecoder's decode step was not replayed from a graph "
                f"({step.replays} replays)")
        # the eager loop's text, and the decoder's ms a token in turns
        _, final_eager, _ = run_generate(eager_decoder, prompt)
        require(final_eager == final, f"{name}: the captured decoder's text differs from the "
                                      f"eager one's: {final[:60]!r} / {final_eager[:60]!r}")
        tok_ms = {"eager": [], "captured": []}
        for turn, d in (("eager", eager_decoder), ("captured", decoder),
                        ("captured", decoder), ("eager", eager_decoder)):
            tok_ms[turn].append(run_generate(d, prompt)[2])
        want, toks, launches = model_level_text(torch, params, cfg, quant, rt, tokenizer, ids,
                                                decoder.eos_token_id)
        require(final == want, f"{name}: GLMDecoder text {final[:80]!r} differs from the "
                               f"model-level text {want[:80]!r}")
        require(len(final) > 0, f"{name}: empty text")
        path = kernels + ("rope_kv_append", "flash_attention_decode", "flash_attention_prefill")
        missing = [k for k in path if c[k] == 0]
        require(not missing, f"{name}: kernels not launched by GLMDecoder.generate: {missing}")
        require_fused_append(launches["per_decode_step"], cfg, f"{name}: a batch-1 decode step")
        log(f"  {name}: GLMDecoder.generate gave {len(toks)} tokens and {len(stream)} streamed "
            f"texts from {step.replays} replays of its captured decode step; its final text "
            f"equals the model-level text and the eager decoder's: {final[:70]!r}")
        log(f"  {name} GLMDecoder ms a token in turns: eager {tok_ms['eager'][0]:.3f}, captured "
            f"{tok_ms['captured'][0]:.3f} / {tok_ms['captured'][1]:.3f}, eager "
            f"{tok_ms['eager'][1]:.3f}  [{smi}]")
        # time to first token: the bucket's prefill program replayed (its
        # warm-up and capture fell in the runs above) against the eager one
        ttft = {"eager": [], "captured": []}
        for turn, d in (("eager", eager_decoder), ("captured", decoder),
                        ("captured", decoder), ("eager", eager_decoder)):
            ttft[turn].append(first_token_ms(torch, d, prompt))
        pre = M.prefill_program(params, cfg, decoder._free_caches[0][0],
                                M.prompt_bucket(len(ids), CACHE_LEN), quant, torch.bfloat16, rt)
        require(pre.graph is not None and pre.replays >= 2,
                f"{name}: GLMDecoder's prefill was not replayed from a graph ({pre.replays})")
        log(f"  {name} GLMDecoder time to first token ({len(ids)}-token prompt, bucket "
            f"{M.prompt_bucket(len(ids), CACHE_LEN)}) in turns: eager {ttft['eager'][0]:.2f}, "
            f"captured {ttft['captured'][0]:.2f} / {ttft['captured'][1]:.2f}, eager "
            f"{ttft['eager'][1]:.2f} ms  [{smi}]")
        spec = None
        if not dyn and quant == "int4g32":  # prompt-lookup speculation, its verify captured
            sd = GLMDecoder(load, params, tokenizer, max_sequence_length=CACHE_LEN, rt=rt)
            sd_eager = GLMDecoder(load, params, tokenizer, max_sequence_length=CACHE_LEN,
                                  rt=eager)
            _, spec_eager, spec_eager_ms = run_generate(sd_eager, prompt, speculative_k=SPEC_K)
            _, final_spec, spec_ms = run_generate(sd, prompt, speculative_k=SPEC_K)
            verify = sd._verify_program(sd._free_caches[0][0], SPEC_K)
            # the verify step attends through B5's chunked form where a decode
            # step takes B4: bf16 rounds elsewhere, so a near-tie may flip
            # (phase 6's greedy-gap check reads such runs); capture changes
            # nothing, so the text must be the eager speculative decoder's
            shared = next((i for i, (a, b) in enumerate(zip(final_spec, final)) if a != b),
                          min(len(final_spec), len(final)))
            spec = {**sd.spec_stats, "ms_per_token": spec_ms, "eager_ms_per_token": spec_eager_ms,
                    "verify_replays": verify.replays, "chars_shared_with_greedy": shared}
            require(final_spec == spec_eager, f"{name}: the captured speculative text "
                                              f"{final_spec[:60]!r} differs from the eager one's "
                                              f"{spec_eager[:60]!r}")
            require(sd.spec_stats["verify_steps"] >= 2 and verify.graph is not None,
                    f"{name}: speculation ran {sd.spec_stats} with no captured verify step")
            log(f"  {name} GLMDecoder.generate(speculative_k={SPEC_K}): {json.dumps(sd.spec_stats)}"
                f", the verify step replayed {verify.replays} times; the eager speculative "
                f"decoder's text; its first {shared} of {len(final)} characters are the plain "
                f"greedy text's; ms a token: captured {spec_ms:.3f}, eager {spec_eager_ms:.3f}  "
                f"[{smi}]")
            del sd, sd_eager
        log(f"  {name} launch counts of the generate run: "
            f"{json.dumps({k: v for k, v in c.items() if v})}")
        log(f"  {name} launches per prefill ({len(ids)} tokens): "
            f"{json.dumps(launches['per_prefill'])}; per batch-1 decode step: "
            f"{json.dumps(launches['per_decode_step'])}")
        turns = {"eager": [], "captured": []}
        for turn, r_t in (("eager", eager), ("captured", rt), ("captured", rt), ("eager", eager)):
            turns[turn].append(decode_rate(params, cfg, quant, 1, 128, CACHE_LEN, r_t))
        r = turns["captured"][0]
        ms = {k: [x["decode_ms_per_step"] for x in v] for k, v in turns.items()}
        perf[name] = {**r, **launches, "weight_bytes_per_token": weight_bytes_per_token(params),
                      "decode_turns_ms_per_step": ms, "generate_turns_ms_per_token": tok_ms,
                      "first_token_turns_ms": ttft,
                      "speculative": spec}
        log(f"  {name} batch 1: prefill 1x128 tokens {r['prefill_ms']:.2f} ms; decode ms/step in "
            f"turns: eager {ms['eager'][0]:.3f}, captured {ms['captured'][0]:.3f} / "
            f"{ms['captured'][1]:.3f}, eager {ms['eager'][1]:.3f}  [{smi}]")
        # where a batch-1 decode step's time goes (and an int8 4 x 128 prefill's)
        perf[name]["profile"] = profile_decode(torch, params, cfg, rt, quant)
        busy = perf[name]["profile"]["device_ms_per_step"] / r["decode_ms_per_step"]
        perf[name]["profile"]["device_busy_share_untraced"] = busy
        log(f"  {name} batch-1 decode: device busy {100 * busy:.1f}% of the untraced step")
        if name == "int8":
            perf[name]["prefill_profile"] = profile_prefill(torch, params, cfg, rt, 4, quant,
                                                            "int8_wgmma_kernel")
        if dyn:  # the chat prompt's prefill (and int8's 4 x 128) on B7 / B8's Hopper kernel
            perf[name]["prefill_profile"] = profile_prefill(
                torch, params, cfg, rt, 1, quant, "dyn_wgmma_kernel",
                ids=torch.tensor([ids], device="cuda"))
            if quant == "int8":
                perf[name]["prefill_profile_4x128"] = profile_prefill(
                    torch, params, cfg, rt, 4, quant, "dyn_wgmma_kernel")
        if name == "int4g32":
            counts["int4g32 fp8"], perf["int4g32 fp8 cache"] = chat_fp8(
                torch, smi, params, cfg, tokenizer, prompt, ids, decoder)
        # the float16 config of the same tree (also under dynamic int8, and
        # int4g32 over an fp8 cache: those with F16_NEW_TOKENS)
        counts[f"{name} f16"], perf[f"{name} f16"] = chat_f16(
            torch, smi, params, cfg, quant, tokenizer, prompt, ids, decoder, dyn=dyn,
            tokens=F16_NEW_TOKENS if dyn else CHAT_TOKENS)
        if name == "int4g32":
            counts["int4g32 f16 fp8"], perf["int4g32 f16 fp8"] = chat_f16(
                torch, smi, params, cfg, quant, tokenizer, prompt, ids, decoder,
                kv_dtype=torch.float8_e4m3fn, tokens=F16_NEW_TOKENS)
        # the float32 config of the same tree (the CUDA-core attention forms)
        for q, kv_name in F32_CHAT:
            if q == name:
                kv = None if kv_name == "float32" else getattr(torch, kv_name)
                f32_name = f"{name} f32" + (" fp8" if kv else "")
                counts[f32_name], perf[f32_name] = chat_f32(
                    torch, smi, params, cfg, quant, tokenizer, prompt, ids, decoder, kv)
        del decoder, eager_decoder
    del params
    torch.cuda.empty_cache()
    perf["round_trip"] = {q: round_trip(torch, q, tokenizer) for q in ("int8", "int4g32")}
    perf["launcher_f16"] = launcher_f16(torch, smi, tokenizer, prompt)
    return counts, perf


# ---------------------------------------------------------------------------
# Phase 6: the serving engines
# ---------------------------------------------------------------------------

ENGINE_KW = dict(max_batch=4, max_seq_len=SEQ, decode_chunk=16)
NEW_TOKENS = 64
EOS = 2  # no tokenizer: the engines' eos id
# Greedy consistency: the largest gap, over every emitted greedy token, between
# the dense unpaged unchunked path's max logit and its logit of the emitted
# token, as a fraction of max|logits| at that position.  The logits are taken
# in f32 (that path's final hidden states through the lm_head, before the bf16
# rounding that makes every gap a whole number of bf16 ulps: 7.4e-3 of a logit
# near 17).  The engines' paths round bf16 differently from that path (paged
# or chunked attention, other matmul shapes), so a near-tie may flip.  The
# limit is 1.5x the largest f32 reading over seeds 61-171 (--gap-seeds, twelve
# seeds, runs a, b, c) on the tree before B1's Hopper kernel: 2.70e-2 on an
# H100 (seed 121), where that tree also read 2.25e-2 and the tree with the
# kernel at most 2.49e-2.  The stream shifted by one token read 1.03 to 1.60.
GREEDY_GAP_TOL = 4.04e-2
# what the paged runs (a) and (b) launch ((c) none of the first two), and the
# dense run (c); the fused RoPE + KV append (B3 / B9) is on both paths
PAGED_KERNELS = ("flash_attention_decode_paged", "flash_attention_chunk_paged",
                 "flash_attention_prefill_chunk", "rope_kv_append")
DENSE_KERNELS = ("flash_attention_decode", "rope_kv_append")


def engine_prompts(torch, seed=61):
    """Run (a)'s seven requests (six greedy of 300-1100 tokens, the ones of
    700, 1100, 900 and 620 tokens sharing a 512-token head, and one sampled)
    and run (b)'s three prompts, each repeating a 40-token span; ids from a
    seeded generator."""
    g = torch.Generator().manual_seed(seed)

    def ids(n):
        return torch.randint(3, 65000, (n,), generator=g).tolist()

    head = ids(512)
    greedy = dict(temperature=0.0, max_new_tokens=NEW_TOKENS)
    a = [(head + ids(188), greedy), (ids(300), greedy), (ids(850), greedy),
         (ids(400), dict(temperature=0.8, top_p=0.8, max_new_tokens=NEW_TOKENS)),
         (head + ids(588), greedy), (head + ids(388), greedy), (head + ids(108), greedy)]
    b = []
    for _ in range(3):
        span = ids(40)
        b.append((ids(60) + span * 6 + ids(20), greedy))
    return a, b


def _decode_only(engine) -> bool:
    """Whether the next step can only decode: no prompt mid-prefill, and
    nothing queued that a free slot could admit."""
    free = any(s.request is None for s in engine.slots)
    return (not any(s.pending_ids is not None for s in engine.slots)
            and not (engine.queue and free))


def drive(torch, engine, reqs, name):
    """Submit ``reqs`` at once and step the engine until it drains: the host
    time to first token of each request (when ``step()`` returns it, which
    includes that step's decode chunk), aggregate tokens/s over the drain,
    the median wall of a decode-only step, every kernel's launches, and the
    step programs captured in the run (a capture's warm-up and recording
    fall inside the time to first token)."""
    from chatglm_q_tpu_torch import ops
    from chatglm_q_tpu_torch.utils import graphs as G

    registry = G.programs(engine.params)
    captures = registry.captures
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ids = [engine.submit(p, **kw) for p, kw in reqs]
    first, walls = {}, {"decode": [], "admit": []}
    while engine.has_work:
        kind = "decode" if _decode_only(engine) else "admit"
        ts = time.perf_counter()
        events = engine.step()
        torch.cuda.synchronize()
        now = time.perf_counter()
        walls[kind].append(now - ts)
        for rid, _ in events:
            first.setdefault(rid, now - t0)
        require(engine.stats["steps"] < 1000, f"{name}: the engine did not drain")
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    by_id = {r.req_id: r for r in engine.finished}
    reqs_done = [by_id[i] for i in ids]
    for r, (_, kw) in zip(reqs_done, reqs):
        require(r.done and len(r.generated) <= kw["max_new_tokens"],
                f"{name}: request {r.req_id} unfinished or over budget ({len(r.generated)})")
    tokens = sum(len(r.generated) for r in reqs_done)
    med = {k: sorted(v)[len(v) // 2] * 1e3 if v else None for k, v in walls.items()}
    res = {"ttft_s": [first.get(i) for i in ids], "tokens": tokens, "wall_s": wall,
           "tok_per_s": tokens / wall, "steps": len(walls["decode"]) + len(walls["admit"]),
           "decode_step_ms_median": med["decode"], "admit_step_ms_median": med["admit"],
           "admit_steps": len(walls["admit"]), "launches": counts, "stats": dict(engine.stats),
           "captures": registry.captures - captures}
    log(f"  {name}: {len(reqs)} requests, {tokens} tokens in {wall:.2f} s "
        f"({res['tok_per_s']:.1f} tok/s aggregate); time to first token "
        + ", ".join(f"{t:.2f}" for t in res["ttft_s"]) + " s")
    log(f"    {len(walls['admit'])} steps with admission or prefill work (median "
        f"{med['admit'] or 0:.1f} ms), {len(walls['decode'])} decode-only steps (median "
        f"{med['decode'] or 0:.1f} ms, {engine.chunk} decode steps each); "
        f"{res['captures']} step programs captured in the run")
    log(f"    launches: {json.dumps({k: v for k, v in counts.items() if v})}")
    return reqs_done, res


def chunk_busy(torch, engine, reqs, name):
    """The device's busy share of one decode-only step (``decode_chunk``
    decode steps): torch.profiler's device time of a traced step over the
    host wall of the untraced decode-only step before it, in a short run of
    its own (tracing inflates the host's time, so the drain above is
    untraced)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile

    from chatglm_q_tpu_torch import ops

    ids = [engine.submit(p, **kw) for p, kw in reqs]
    untraced = res = None
    while engine.has_work:
        if res is None and _decode_only(engine) and engine.queue == []:
            if untraced is None:
                ts = time.perf_counter()
                engine.step()
                torch.cuda.synchronize()
                untraced = time.perf_counter() - ts
                continue
            ops.reset_launch_counts()
            with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                engine.step()
                torch.cuda.synchronize()
            per_step = {k: v / engine.chunk for k, v in ops.launch_counts().items() if v}
            events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
            dev_ms = sum(e.self_device_time_total for e in events) / 1e3
            # the paged attention kernels' share: B10 (decode_attn_kernel) and
            # B11 (prefill_attn_kernel, the verify step)
            attn = {k: sum(e.self_device_time_total for e in events if k in e.key) / 1e3
                    for k in ("decode_attn_kernel", "prefill_attn_kernel")}
            b1_ms = sum(e.self_device_time_total for e in events
                        if "int4_splitk_mma_kernel" in e.key) / 1e3
            top = sorted(events, key=lambda e: -e.self_device_time_total)[:3]
            res = {"device_ms": dev_ms, "wall_ms": untraced * 1e3, "attention_device_ms": attn,
                   "int4_splitk_mma_kernel_ms": b1_ms,
                   "top_kernels_ms": {e.key[:60]: e.self_device_time_total / 1e3 for e in top},
                   "busy_share": dev_ms / (untraced * 1e3),
                   "device_ms_per_decode_step": dev_ms / engine.chunk,
                   "launches_per_decode_step": per_step,
                   "device_launches_per_decode_step": sum(e.count for e in events)
                   / engine.chunk}
            for rid in ids:  # measured: the rest of the run is not needed
                engine.cancel(rid)
            continue
        engine.step()
    require(res is not None, f"{name}: no two decode-only steps to profile")
    log(f"    {name}: one decode-only step ({engine.chunk} decode steps): device "
        f"{res['device_ms']:.2f} ms of {res['wall_ms']:.2f} ms untraced wall, busy "
        f"{100 * res['busy_share']:.1f}%; device {res['device_ms_per_decode_step']:.2f} ms "
        f"a decode step; attention kernels (ms) {json.dumps(res['attention_device_ms'])}; "
        f"B1 int4_splitk_mma_kernel {res['int4_splitk_mma_kernel_ms']:.3f} ms "
        f"({res['int4_splitk_mma_kernel_ms'] / engine.chunk:.3f} a decode step); "
        f"largest (ms) {json.dumps(res['top_kernels_ms'])}; launches a decode step "
        f"{json.dumps(res['launches_per_decode_step'])}, "
        f"{res['device_launches_per_decode_step']:.1f} on the device")
    return res


CHUNK_PROMPT = 1024  # tokens of each prompt of the chunk-step profile: four 256-token chunks


def chunk_step_busy(torch, engine, name, seed):
    """Where an admission step's time goes: four fresh prompts of
    CHUNK_PROMPT tokens (no prefix hit), so the engine's second and third
    steps each prefill one 256-token chunk of all four (1024 rows through
    every linear) and decode nothing.  The second step's untraced host wall
    against the third's device time under torch.profiler, B1's Hopper
    kernel apart."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile

    from chatglm_q_tpu_torch.utils import graphs as G

    g = torch.Generator().manual_seed(seed)
    ids = [engine.submit(torch.randint(3, 65000, (CHUNK_PROMPT,), generator=g).tolist(),
                         temperature=0.0, max_new_tokens=8) for _ in range(4)]
    engine.step()  # admission and the first chunks
    torch.cuda.synchronize()
    progs = list(G.programs(engine.params, "prefill")._programs.values())
    replays = sum(p.replays for p in progs)
    ts = time.perf_counter()
    engine.step()
    torch.cuda.synchronize()
    untraced = time.perf_counter() - ts
    require(not any(s.decoding for s in engine.slots), f"{name}: a chunk step decoded")
    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        engine.step()
        torch.cuda.synchronize()
    replays = sum(p.replays for p in progs) - replays
    # a captured engine's two measured chunk steps replay its (4, 256) chunk
    # program (captured in the run before): no capture in the measurement
    require(replays == (2 if engine.rt.cuda_graphs else 0),
            f"{name}: {replays} chunk-program replays in the two measured chunk steps")
    for rid in ids:
        engine.cancel(rid)
    while engine.has_work:
        engine.step()
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    dev_ms = sum(e.self_device_time_total for e in events) / 1e3
    b1 = [e for e in events if "int4_wgmma_kernel" in e.key]
    b1_ms = sum(e.self_device_time_total for e in b1) / 1e3
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:3]
    res = {"device_ms": dev_ms, "wall_ms": untraced * 1e3, "busy_share": dev_ms / (untraced * 1e3),
           "chunk_replays": replays,
           "int4_wgmma_kernel_ms": b1_ms, "int4_wgmma_kernel_launches": sum(e.count for e in b1),
           "top_kernels_ms": {e.key[:60]: e.self_device_time_total / 1e3 for e in top}}
    log(f"    {name}: one chunk step (4 x 256 prompt rows, {replays} replays in 2 steps): "
        f"device {dev_ms:.2f} ms of "
        f"{res['wall_ms']:.2f} ms untraced wall, busy {100 * res['busy_share']:.1f}%, host "
        f"{res['wall_ms'] - dev_ms:.2f} ms; B1 int4_wgmma_kernel {b1_ms:.3f} ms in "
        f"{res['int4_wgmma_kernel_launches']} launches; largest (ms) "
        f"{json.dumps(res['top_kernels_ms'])}")
    return res


def eager_turn(torch, make, reqs, done, name, busy_reqs=None, chunk_seed=None):
    """The same run from eager launches (``cuda_graphs=False``): its greedy
    tokens must equal the captured run's ``done``; tokens/s, time to first
    token and (with ``busy_reqs``) the decode-only step's busy share (with
    ``chunk_seed`` also a chunk step's)."""
    from chatglm_q_tpu_torch import TorchRuntimeConfig

    eng = make(TorchRuntimeConfig(cuda_graphs=False))
    e_done, res = drive(torch, eng, reqs, f"{name}, eager")
    for x, y, (_, kw) in zip(done, e_done, reqs):
        if kw["temperature"] == 0:
            require(x.generated == y.generated, f"{name}: request {x.req_id}'s captured greedy "
                                                f"tokens differ from the eager run's")
    res["sampled_equal"] = all(x.generated == y.generated for x, y in zip(done, e_done))
    log(f"    {name}: the captured run's greedy tokens equal the eager run's; sampled rows "
        f"{'equal' if res['sampled_equal'] else 'differ'} on the same seed")
    if busy_reqs is not None:
        res["busy"] = chunk_busy(torch, eng, busy_reqs, f"{name} eager")
    if chunk_seed is not None:
        res["chunk_step"] = chunk_step_busy(torch, eng, f"{name} eager", chunk_seed)
    return res


def sampled_speculation(torch, make_d, b_reqs, b_done, params, smi):
    """Run (d): the paged engine with ``speculative_k=8`` and
    ``speculative_sampled`` on (b)'s prompts as a mixed batch, (b)'s first
    two greedy and two rows at temperature 0.8 / top-p 0.8 (the third and
    the first prompt), captured, then from eager launches on the same seed.
    The greedy rows must give (b)'s tokens, the captured sampled rows the
    eager run's, and the sampled verify program must replay."""
    from chatglm_q_tpu_torch import TorchRuntimeConfig
    from chatglm_q_tpu_torch.utils import graphs as G

    sampled = dict(temperature=0.8, top_p=0.8, max_new_tokens=NEW_TOKENS)
    reqs = [b_reqs[0], b_reqs[1], (b_reqs[2][0], sampled), (b_reqs[0][0], sampled)]
    eng = make_d(TorchRuntimeConfig())
    done, res = drive(torch, eng, reqs, "(d) paged, speculative k=8, two greedy and two sampled "
                                        "rows")
    require(eng.pages_in_use == 0, f"(d): {eng.pages_in_use} pages in use after the drain")
    res["spec_accepted"] = eng.stats["spec_accepted"]
    res["spec_steps"] = eng.stats["spec_steps"]
    progs = [p for k, p in G.programs(params)._programs.items()
             if k[0] == "spec_step" and k[-1][0] == "rows"]
    res["sampled_replays"] = sum(p.replays for p in progs)
    require(res["sampled_replays"] > 0 and all(p.graph is not None for p in progs
                                               if p.calls > 1),
            "(d): the sampled verify program did not replay from a graph")
    for i in (0, 1):
        require(done[i].generated == b_done[i].generated,
                f"(d): greedy row {i}'s tokens differ from (b)'s")
    del eng
    res["eager"] = eager_turn(torch, make_d, reqs, done, "(d)")
    require(res["eager"]["sampled_equal"],
            "(d): the captured sampled rows' tokens differ from the eager run's on the same seed")
    log(f"    (d) greedy rows equal (b)'s; the captured sampled rows equal the eager run's on "
        f"one seed; {res['sampled_replays']} replays of the sampled verify program; "
        f"{res['spec_accepted']} drafted tokens accepted in {res['spec_steps']} verify steps  "
        f"[{smi}]")
    return res


def captured_programs(params, name, kinds, family="decode"):
    """The step programs of ``kinds`` (of ``family``) that replayed from a
    graph."""
    from chatglm_q_tpu_torch.utils import graphs as G

    progs = [p for p in G.programs(params, family)._programs.values()
             if p.name in kinds and p.capture]
    n = sum(p.replays for p in progs)
    require(n > 0 and all(p.graph is not None for p in progs if p.calls > 1),
            f"{name}: no captured {kinds} program replayed")
    return {p.name: p.replays for p in progs}


def greedy_gaps(torch, params, cfg, reqs_done, prompts, cache_len=SEQ, kv_dtype=None, rt=None,
                quant="int4g32", dtype=None):
    """For each greedy request, prefill_chunk over prompt + generated[:-1] on a
    fresh dense cache (one chunk, all logits; activations of ``dtype`` and a
    cache of ``kv_dtype``, both bf16 by default, through ``rt``, the kernels
    by default), and the largest relative gap
    between each position's max logit and the emitted token's logit; and the
    same over the stream shifted by one token (the control).  Read two ways:
    from the bf16 logits prefill_chunk returns, and from the same final
    hidden states through the lm_head in f32 (the plain matmul of ``quant``
    on h in f32: the logits before their rounding to bf16, which makes every
    bf16 gap a whole number of ulps of the top logit; "bf16" is the
    activations' dtype, f16 where ``dtype`` says so).  Returns {"bf16":
    (worst, control), "f32": (worst, control)}."""
    from chatglm_q_tpu_torch import TorchRuntimeConfig
    from chatglm_q_tpu_torch.models import chatglm2 as M
    from chatglm_q_tpu_torch.ops.int8_matmul import int8_matmul_plain
    from chatglm_q_tpu_torch.ops.quant_matmul import int4g32_matmul_plain

    head_plain = int8_matmul_plain if quant == "int8" else int4g32_matmul_plain
    act = dtype or torch.bfloat16

    head, linear, seen = params["lm_head"], M.quant_linear, {}

    def keep_head_input(h, p, *args):
        if p is head:
            seen["h"] = h
        return linear(h, p, *args)

    dev = params["final_ln"]["weight"].device
    res = {"bf16": [0.0, 0.0], "f32": [0.0, 0.0]}
    M.quant_linear = keep_head_input
    try:
        for req, (prompt, kw) in zip(reqs_done, prompts):
            if kw["temperature"] > 0 or len(req.generated) < 2:
                continue
            seq = prompt + req.generated[:-1]
            cache = M.init_kv_cache(cfg, 1, cache_len, kv_dtype or torch.bfloat16, dev)
            ids = torch.tensor([seq], device=dev)
            zero = torch.zeros((1,), dtype=torch.int32, device=dev)
            logits, _ = M.prefill_chunk(params, cfg, ids, zero, zero + len(seq), cache,
                                        quant, act, rt or TorchRuntimeConfig(),
                                        return_all_logits=True)
            h = seen.pop("h")[0, len(prompt) - 1:]  # row i predicts generated[i]
            f32 = head_plain(h.float(), head["weight"], head["weight_scale"])
            toks = torch.tensor(req.generated, device=dev)
            for key, lg in (("bf16", logits[0, len(prompt) - 1:].float()),
                            ("f32", f32[:, : cfg.vocab_size])):
                top = lg.max(dim=-1).values
                scale = lg.abs().max(dim=-1).values
                gap = (top - lg.gather(1, toks[:, None])[:, 0]) / scale
                shifted = (top[:-1] - lg[:-1].gather(1, toks[1:, None])[:, 0]) / scale[:-1]
                res[key][0] = max(res[key][0], gap.max().item())
                res[key][1] = max(res[key][1], shifted.max().item())
            del cache, logits, h, f32
    finally:
        M.quant_linear = linear
    return {k: tuple(v) for k, v in res.items()}


def engines_slice(torch, smi, seed=61, survey=False):
    """Runs (a), (b) and (c) on a tree and prompts made from ``seed``.  With
    ``survey``, only the runs the greedy check reads and their gaps: no
    busy-share runs, no (b'), no launch checks (``--gap-seeds``)."""
    from chatglm_q_tpu_torch import ChatGLM2Config, GLMLoadConfig, TorchRuntimeConfig
    from chatglm_q_tpu_torch.bench import random_quantized_params
    from chatglm_q_tpu_torch.serving import PagedServingEngine, ServingEngine

    cfg = ChatGLM2Config()
    params = random_quantized_params(cfg, "int4g32",
                                     torch.Generator(device="cuda").manual_seed(seed + 2))
    load = GLMLoadConfig(model_config=cfg, quant_type="int4g32", torch_dtype="bfloat16")
    rt = TorchRuntimeConfig()
    a_reqs, b_reqs = engine_prompts(torch, seed)
    # the busy-share runs: four 128-token prompts (cancelled once measured)
    short = [(p[:128], {**kw, "temperature": 0.0, "max_new_tokens": 256})
             for p, kw in a_reqs[:4]]
    out = {}

    def make_a(r_t):
        return PagedServingEngine(load, params, num_pages=POOL_PAGES, page_size=PAGE,
                                  prefill_chunk_size=PAGE, prefix_cache=True, rt=r_t,
                                  seed=seed + 3, **ENGINE_KW)

    def make_b(r_t, k=8):
        return PagedServingEngine(load, params, num_pages=POOL_PAGES, page_size=PAGE,
                                  speculative_k=k, speculative_ngram=3, rt=r_t, **ENGINE_KW)

    def make_d(r_t):
        return PagedServingEngine(load, params, num_pages=POOL_PAGES, page_size=PAGE,
                                  speculative_k=8, speculative_ngram=3, speculative_sampled=True,
                                  rt=r_t, seed=seed + 7, **ENGINE_KW)

    def make_c(r_t):
        return ServingEngine(load, params, prefill_chunk_size=PAGE, lookahead=True, rt=r_t,
                             **ENGINE_KW)

    # (a) paged, chunked admission through the prefix cache
    eng = make_a(rt)
    a_done, out["a"] = drive(torch, eng, a_reqs, "(a) paged, chunked + prefix cache")
    out["a"]["replays"] = captured_programs(params, "(a)", ("decode_step_paged",))
    out["a"]["chunk_replays"] = captured_programs(params, "(a)", ("prefill_chunk_paged",),
                                                  "prefill")
    require(eng.pages_in_use == 0, f"(a): {eng.pages_in_use} pages in use after the drain")
    require(eng.stats["prefix_hits"] > 0, "(a): no prefix hit")
    eng.clear_prefix_cache()
    require(len(eng._free_pages) == POOL_PAGES - 1,
            f"(a): {len(eng._free_pages)} pages free after clearing the prefix cache")
    log(f"    prefix hits {eng.stats['prefix_hits']}, {eng.stats['prefix_tokens_reused']} tokens "
        f"reused; every usable page free after the drain and clear_prefix_cache()")
    if not survey:
        out["a"]["busy"] = chunk_busy(torch, eng, short, "(a)")
        out["a"]["chunk_step"] = chunk_step_busy(torch, eng, "(a)", seed + 5)
    del eng
    if not survey:
        out["a"]["eager"] = eager_turn(torch, make_a, a_reqs, a_done, "(a)", short, seed + 5)

    # (b) paged, whole-prompt admission, in-loop speculation, and the same
    # requests without it
    eng = make_b(rt)
    b_done, out["b"] = drive(torch, eng, b_reqs, "(b) paged, speculative k=8")
    require(eng.pages_in_use == 0, f"(b): {eng.pages_in_use} pages in use after the drain")
    out["b"]["spec_accepted"] = eng.stats["spec_accepted"]
    out["b"]["replays"] = captured_programs(params, "(b)", ("spec_step",))
    if not survey:
        out["b"]["busy"] = chunk_busy(torch, eng, [(p, {**kw, "max_new_tokens": 256})
                                                   for p, kw in b_reqs], "(b)")
    del eng
    if not survey:
        out["b"]["eager"] = eager_turn(torch, make_b, b_reqs, b_done, "(b)")
        eng = make_b(rt, 0)
        b_plain, out["b_plain"] = drive(torch, eng, b_reqs, "(b') the same without speculation")
        del eng
        out["b_plain"]["eager"] = eager_turn(torch, lambda r_t: make_b(r_t, 0), b_reqs, b_plain,
                                             "(b')")
        shared = []
        for x, y in zip(b_done, b_plain):
            n = 0
            while (n < min(len(x.generated), len(y.generated))
                   and x.generated[n] == y.generated[n]):
                n += 1
            shared.append((n, len(x.generated)))
        out["b"]["tokens_shared_with_plain"] = shared
        log(f"    (b) accepted {out['b']['spec_accepted']} drafted tokens; tokens equal to the "
            f"run without speculation (common prefix / emitted): {shared}")
        out["d"] = sampled_speculation(torch, make_d, b_reqs, b_done, params, smi)
        out["d"]["vs"] = {k: (out[k]["tok_per_s"], out[k]["eager"]["tok_per_s"])
                          for k in ("b", "b_plain", "d")}
        log(f"    tok/s captured / eager: (b) {out['b']['tok_per_s']:.1f} / "
            f"{out['b']['eager']['tok_per_s']:.1f}, (b') {out['b_plain']['tok_per_s']:.1f} / "
            f"{out['b_plain']['eager']['tok_per_s']:.1f}, (d) {out['d']['tok_per_s']:.1f} / "
            f"{out['d']['eager']['tok_per_s']:.1f}; drafted tokens accepted (b) "
            f"{out['b']['spec_accepted']}, (d) {out['d']['spec_accepted']}  [{smi}]")

    # (c) the dense engine: chunked admission, lookahead
    eng = make_c(rt)
    c_reqs = [a_reqs[i] for i in (0, 1, 2, 4)]
    c_done, out["c"] = drive(torch, eng, c_reqs, "(c) dense, chunked + lookahead")
    out["c"]["replays"] = captured_programs(params, "(c)", ("decode_step",))
    out["c"]["chunk_replays"] = captured_programs(params, "(c)", ("prefill_chunk",), "prefill")
    if not survey:
        out["c"]["busy"] = chunk_busy(torch, eng, short, "(c)")
        out["c"]["chunk_step"] = chunk_step_busy(torch, eng, "(c)", seed + 5)
    del eng
    if not survey:
        out["c"]["eager"] = eager_turn(torch, make_c, c_reqs, c_done, "(c)", short, seed + 5)
        for run in ("a", "c"):
            cap, eag = out[run]["chunk_step"], out[run]["eager"]["chunk_step"]
            log(f"    ({run}) chunk step (4 x 256 rows) busy share captured "
                f"{100 * cap['busy_share']:.1f}% ({cap['wall_ms']:.2f} ms wall, "
                f"{cap['device_ms']:.2f} ms device), eager {100 * eag['busy_share']:.1f}% "
                f"({eag['wall_ms']:.2f} ms wall, {eag['device_ms']:.2f} ms device); time to "
                f"first token (s) captured "
                + ", ".join(f"{t:.2f}" for t in out[run]["ttft_s"]) + ", eager "
                + ", ".join(f"{t:.2f}" for t in out[run]["eager"]["ttft_s"]) + f"  [{smi}]")

    gaps = {}
    for run, done, reqs in (("a", a_done, a_reqs), ("b", b_done, b_reqs),
                            ("c", c_done, c_reqs)):
        gaps[run] = greedy_gaps(torch, params, cfg, done, reqs)
    out["greedy_gap"] = gaps
    for key in ("bf16", "f32"):
        log(f"  greedy consistency (dense unpaged unchunked prefill_chunk, {key} logits): "
            f"largest gap of an emitted token "
            + ", ".join(f"({k}) {v[key][0]:.4e}" for k, v in gaps.items())
            + "; shifted-stream control " + ", ".join(f"({k}) {v[key][1]:.3e}"
                                                      for k, v in gaps.items()))
    if survey:
        return gaps
    worst = max(g["f32"][0] for g in gaps.values())
    control = min(g["f32"][1] for g in gaps.values())
    log(f"    limit {GREEDY_GAP_TOL:.1e} on the f32 readings; the control must exceed it")
    require(worst <= GREEDY_GAP_TOL, f"greedy consistency: gap {worst} > {GREEDY_GAP_TOL}")
    require(control > GREEDY_GAP_TOL,
            f"greedy consistency: the shifted control passes ({control} <= {GREEDY_GAP_TOL})")

    ca, cb, cc = (out[k]["launches"] for k in ("a", "b", "c"))
    for kern in ("int4g32_splitk", "flash_attention_chunk_paged"):
        require(out["d"]["launches"][kern] > 0, f"(d) did not launch {kern}")
    require(out["d"]["launches"]["kv_cache_write_idx"] == 0
            and out["d"]["launches"]["flash_attention_decode"] == 0, "(d) launched B3/B4")
    for kern in ("int4g32_splitk", "int4g32_mma", "rope_kv_append",
                 "flash_attention_decode_paged", "flash_attention_prefill_chunk"):
        require(ca[kern] > 0, f"(a) did not launch {kern}")
    for kern in ("int4g32_splitk", "flash_attention_chunk_paged", "flash_attention_prefill"):
        require(cb[kern] > 0, f"(b) did not launch {kern}")
    for run, c in (("a", ca), ("b", cb), ("c", cc)):  # bf16 throughout: never the f32 gemv
        require(c["int4g32_gemv"] == 0, f"({run}) launched B1's f32 gemv")
    for kern in ("flash_attention_prefill_chunk",) + DENSE_KERNELS:
        require(cc[kern] > 0, f"(c) did not launch {kern}")
    for run, c in (("a", ca), ("b", cb)):
        require(c["kv_cache_write_idx"] == 0 and c["flash_attention_decode"] == 0,
                f"({run}) launched B3/B4: {c}")
    require(all(cc[k] == 0 for k in PAGED_KERNELS[:2]), f"(c) launched a paged kernel: {cc}")
    for run in ("a", "c"):  # a decode-only step: 16 decode steps of the fused append
        per_step = out[run]["busy"]["launches_per_decode_step"]
        require_fused_append(per_step, cfg, f"({run}) a decode step")
    cd = out["d"]["launches"]
    counts = {k: ca[k] + cb[k] + cc[k] + cd[k] for k in PAGED_KERNELS + ("int4g32_splitk",)}
    counts["rope_kv_append paged"] = ca["rope_kv_append"] + cb["rope_kv_append"] + cd[
        "rope_kv_append"]
    fp8_counts, out["fp8"] = engines_fp8(torch, smi, params, cfg, load, a_reqs, b_reqs, short,
                                         seed)
    for k in PAGED_KERNELS[:3]:
        counts[k + " fp8"] = fp8_counts[k + "_fp8"]
    counts["rope_kv_append paged fp8"] = fp8_counts["rope_kv_append_fp8"]
    long_counts, out["long_context"] = long_context_fp8(torch, smi, params, cfg)
    counts["flash_attention_decode_v2 fp8"] = \
        long_counts["fp8 decode_attn_v2"]["flash_attention_decode_v2_fp8"]
    f16_counts, out["f16"] = engines_f16(torch, smi, params, cfg, a_reqs, short, seed)
    for k in ("flash_attention_decode_paged", "flash_attention_prefill_chunk", "int4g32_mma"):
        counts[k + " f16"] = f16_counts[k + "_f16"]
    counts["rope_kv_append paged f16"] = f16_counts["rope_kv_append_f16"]
    f8_counts, out["f16_fp8"] = engines_f16(torch, smi, params, cfg, a_reqs, short, seed,
                                            torch.float8_e4m3fn)
    for k in ("flash_attention_decode_paged", "flash_attention_prefill_chunk"):
        counts[k + " fp8_f16"] = f8_counts[k + "_fp8_f16"]
    counts["rope_kv_append paged fp8_f16"] = f8_counts["rope_kv_append_fp8_f16"]
    f32_counts, out["f32"] = engines_f32(torch, smi, params, cfg, seed)
    counts.update(f32_counts)
    return counts, out


# ---------------------------------------------------------------------------
# Phase 9: the OpenAI-style API server over the paged engine
# ---------------------------------------------------------------------------

API_TOKENS = 24


def api_slice(torch, smi, seed=91):
    """``GLMAPIServer`` on the 28-layer int4g32 ``PagedServingEngine``
    (whole-prompt admission, the in-process 65024-id tokenizer), answering
    on localhost: a chat completion, the same streamed (SSE), a text
    completion, a stop string, ``n = 2`` and ``/metrics``.  Each greedy text
    must equal the engine's own ``run`` of the same prompt, run before the
    server takes the engine; the decode chunks replay captured programs.
    Whole-prompt admission prefills each prompt alone, and a decode row's
    result does not depend on its batch (its split-K plan is the same from
    1 to 8 rows), so a text does not depend on which requests the server
    admitted together; a chunked prefill of two prompts runs B1's Hopper
    kernel on twice the rows, another plan, and may flip a near-tie."""
    import urllib.request

    from chatglm_q_tpu_torch import ChatGLM2Config, GLMLoadConfig, ops
    from chatglm_q_tpu_torch.bench import random_quantized_params
    from chatglm_q_tpu_torch.serving import GLMAPIServer, PagedServingEngine
    from chatglm_q_tpu_torch.serving.api_server import _messages_to_prompt

    cfg = ChatGLM2Config()
    params = random_quantized_params(cfg, "int4g32",
                                     torch.Generator(device="cuda").manual_seed(seed))
    tokenizer = chat_tokenizer()
    eng = PagedServingEngine(GLMLoadConfig(model_config=cfg, quant_type="int4g32",
                                           torch_dtype="bfloat16"),
                             params, tokenizer, num_pages=POOL_PAGES, page_size=PAGE,
                             seed=seed, **ENGINE_KW)
    messages = [{"role": "user", "content": CHAT_QUESTION}]
    chat_prompt, text_prompt = _messages_to_prompt(messages), "The quick brown fox"
    greedy = dict(temperature=0.0, max_new_tokens=API_TOKENS)
    want_chat = eng.run([chat_prompt], **greedy)[0]
    want_text = eng.run([text_prompt], **greedy)[0]
    require(len(want_chat) >= 8, f"phase 9: the engine's answer is {want_chat!r}")
    stop = want_chat[len(want_chat) // 2: len(want_chat) // 2 + 3]
    server = GLMAPIServer(eng, port=0, model_name="chatglm2-6b")
    url = f"http://{server.host}:{server.port}"
    chat_body = {"model": "chatglm2-6b", "messages": messages, "max_tokens": API_TOKENS,
                 "temperature": 0.0}

    def post(path, body):
        req = urllib.request.Request(url + path, data=json.dumps(body).encode(),
                                     headers={"Content-Type": "application/json"})
        t0 = time.perf_counter()
        with urllib.request.urlopen(req, timeout=300) as resp:
            data = resp.read().decode()
        return data, (time.perf_counter() - t0) * 1e3

    ms = {}
    ops.reset_launch_counts()
    server.start()
    try:
        data, ms["chat"] = post("/v1/chat/completions", chat_body)
        chat = json.loads(data)
        data, ms["stream"] = post("/v1/chat/completions", dict(chat_body, stream=True))
        chunks = [json.loads(line[6:]) for line in data.splitlines()
                  if line.startswith("data: {")]
        require(data.rstrip().endswith("data: [DONE]"), "phase 9: the stream did not end in "
                                                        "[DONE]")
        streamed = "".join(c["choices"][0]["delta"].get("content", "") for c in chunks)
        data, ms["completion"] = post("/v1/completions", {
            "model": "chatglm2-6b", "prompt": text_prompt, "max_tokens": API_TOKENS,
            "temperature": 0.0})
        completion = json.loads(data)
        data, ms["stop"] = post("/v1/chat/completions", dict(chat_body, stop=stop))
        stopped = json.loads(data)
        data, ms["n2"] = post("/v1/chat/completions", dict(chat_body, n=2))
        pair = json.loads(data)
        with urllib.request.urlopen(url + "/metrics", timeout=60) as resp:
            metrics = resp.read().decode()
    finally:
        server.shutdown()
    counts = ops.launch_counts()
    got_chat = chat["choices"][0]["message"]["content"]
    require(got_chat == want_chat, f"phase 9: chat {got_chat!r} differs from the engine's "
                                   f"{want_chat!r}")
    require(streamed == want_chat, f"phase 9: the stream {streamed!r} differs")
    require(completion["choices"][0]["text"] == want_text,
            f"phase 9: completion {completion['choices'][0]['text']!r} differs from {want_text!r}")
    got_stop = stopped["choices"][0]
    require(got_stop["message"]["content"] == want_chat[: want_chat.find(stop)]
            and got_stop["finish_reason"] == "stop",
            f"phase 9: stop {stop!r} gave {got_stop}")
    require([c["message"]["content"] for c in pair["choices"]] == [want_chat] * 2,
            f"phase 9: n = 2 gave {pair['choices']}")
    require(pair["usage"]["prompt_tokens"] == 2 * chat["usage"]["prompt_tokens"],
            f"phase 9: n = 2 usage {pair['usage']}")
    gen_line = next(line for line in metrics.splitlines() if 'stat="generated_tokens"' in line)
    require(int(gen_line.rsplit(" ", 1)[1]) > 0, f"phase 9: /metrics {gen_line}")
    for kern in ("int4g32_splitk", "flash_attention_decode_paged", "rope_kv_append"):
        require(counts[kern] > 0, f"phase 9: the served requests did not launch {kern}")
    replays = captured_programs(params, "phase 9", ("decode_step_paged",))
    log(f"  GLMAPIServer on {url}: chat, SSE stream ({len(chunks)} chunks), completion, stop "
        f"{stop!r}, n = 2 and /metrics answered; every greedy text equals the engine's own run "
        f"({chat['usage']['completion_tokens']} tokens: {got_chat[:60]!r}); the decode chunks "
        f"replayed captured programs {json.dumps(replays)}")
    log(f"  request ms (host clock, client side): {json.dumps({k: round(v, 1) for k, v in ms.items()})}"
        f"  [{smi}]")
    return {"request_ms": ms, "usage": chat["usage"], "replays": replays,
            "launches": {k: v for k, v in counts.items() if v}}


# ---------------------------------------------------------------------------
# Phase 2 (sharded forms): K1, K2, K3 against their plain versions
# ---------------------------------------------------------------------------

# K1's and K2's (m, l) against their plain versions: the running max of the
# scaled scores, f32 sums of bf16 products in another order, and its sum of
# f32 exponentials; the relative error of each, beside its output's.
LSE_TOL = 1e-4
SHARD_TP = 2  # the model axis of the sharded rows and of phase 8
SHARD_T = 8192  # phase 8 (a)'s cache: 4096 slots a rank
SHARD_LENGTHS = (8000, 5000, 3000, -1)


class _MeshAt:
    """Model rank ``r`` of a (1, tp) mesh, for the local-table helpers in one
    process."""

    def __init__(self, tp, r):
        self.n_data, self.n_model, self.data_index, self.model_index = 1, tp, 0, r


def hold_lse(torch, name, got, want, where, tol=KERNEL_TOL):
    """K1's / K2's (out, m, l) against the plain version's: out within
    ``tol`` of max|plain|, m and l within LSE_TOL relative, −inf and 0
    exactly where the shard holds no row of a (b, g).  Returns (max |Δout|,
    its relative error, m's, l's)."""
    (out, m, l), (out_p, m_p, l_p) = got, want
    _, rel = rel_err(out, out_p)
    empty = torch.isinf(m_p)
    require(torch.equal(torch.isinf(m), empty) and not l[empty].any()
            and not out[empty].float().any(),
            f"{name} {where}: an empty shard's (out, m, l) are not (0, -inf, 0)")
    fin = ~empty
    dm = ((m[fin] - m_p[fin]).abs() / m_p[fin].abs().clamp_min(1.0)).max().item() \
        if fin.any() else 0.0
    dl = ((l[fin] - l_p[fin]).abs() / l_p[fin]).max().item() if fin.any() else 0.0
    require(torch.isfinite(out.float()).all() and rel <= tol and dm <= LSE_TOL
            and dl <= LSE_TOL, f"{name} {where}: out {rel}, m {dm}, l {dl}")
    return rel_err(out, out_p)[0], rel, dm, dl


def hold_merge(torch, name, parts, want32, abs32, limit, where):
    """The shards' partials (out, m, l) merged (``merge_lse_partials``) held
    to the bound the design allows beyond the unsharded function in f32
    (``want32``): the merged output's bf16 rounding (half an ulp of the
    larger of it and want32), one bf16 rounding of each partial (2^-8 ·
    Σ_r w_r|out_r| / Σ_r w_r, w_r the merge's weights) and, where the kernel
    rounds p to bf16 for PV (K1), one rounding of each p (2^-8 · Σ p|v| / l,
    ``abs32``: the function over |v|, else None).  The largest excess over
    max|want32| must be within ``limit``, and a control that merges the live
    shards with equal weights (what the merge gives if it drops m and l)
    beyond it.  Returns (merged, excess, control's excess)."""
    from chatglm_q_tpu_torch.ops import attention as A

    out, m, l = parts
    m_max = m.amax(dim=0)
    w = (l.double() * torch.exp(m.double() - torch.where(torch.isfinite(m_max), m_max,
                                                         0.0).double()[None]))
    allowed = (2.0 ** -8) * (out.double().abs() * w[..., None]).sum(0) / (
        w.sum(0).clamp_min(1e-300)[..., None])
    if abs32 is not None:
        allowed = allowed + (2.0 ** -8) * abs32.double()
    scale = max(want32.abs().max().item(), 1e-30)

    def excess(got):
        mag = torch.maximum(want32.abs(), got.float().abs())
        half_ulp = torch.where(mag == 0, 0.0,
                               torch.ldexp(torch.ones_like(mag), torch.frexp(mag).exponent - 9))
        return ((got.double() - want32.double()).abs() - half_ulp.double() - allowed
                ).clamp_min(0.0).max().item() / scale

    merged = A.merge_lse_partials(out, m, l, torch.bfloat16)
    live = (l > 0).float()[..., None]
    equal = ((out.float() * live).sum(0) / live.sum(0).clamp_min(1.0)).to(torch.bfloat16)
    err, ctrl = excess(merged), excess(equal)
    require(err <= limit < ctrl, f"{name} {where}: the merged shards beyond the design's bound "
                                 f"{err} (limit {limit}), equal-weight control {ctrl}")
    return merged, err, ctrl


def lse_library(torch, q, k, v, valid, sm):
    """One PyTorch call that computes the output and the log-sum-exp of the
    same attention: the memory-efficient SDPA with ``compute_log_sumexp``, K
    and V expanded to the heads beforehand (no GQA there), masked by an
    additive bias.  A yardstick the port never calls; None if the call
    refuses the shapes on this build."""
    from chatglm_q_tpu_torch.utils.timing import cuda_event_ms

    B, G, Hg, D = q.shape
    qh = q.reshape(B, G * Hg, 1, D)
    kh = [k[l][:, :, None].expand(B, G, Hg, *k.shape[-2:]).reshape(B, G * Hg, -1, D)
          for l in range(2)]
    vh = [v[l][:, :, None].expand(B, G, Hg, *v.shape[-2:]).reshape(B, G * Hg, -1, D)
          for l in range(2)]
    bias = torch.where(valid, 0.0, -1e30).to(q.dtype)[:, None, None, :].expand(
        B, G * Hg, 1, valid.shape[1])
    try:
        return cuda_event_ms(lambda i: torch.ops.aten._scaled_dot_product_efficient_attention(
            qh, kh[i % 2], vh[i % 2], bias, True, scale=sm), iters=56)
    except RuntimeError as e:  # a yardstick only: its absence fails nothing
        log(f"  (the lse library call refused these shapes: {str(e).splitlines()[0]})")
        return None


def synced_ms(torch, fn, iters):
    """Host-clock ms a call of ``fn(i)``, synchronized before and after the
    loop: for a plain version that reads a device value on the host (a
    ``nonzero``), which ``cuda_event_ms``'s hold of the stream cannot
    outlast."""
    fn(0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(iters):
        fn(i)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


def check_sharded_attention(torch):
    """K1 (B4's return_lse form on a T-shard), K2 (B10's strided return_lse
    form on a phase of the pool) and K3 (the fused RoPE + KV append on a
    sharded cache) at phase 8's shapes, both shards of a tp = 2 model axis
    in this process.  K1 and K2 against their plain versions (out, m, l;
    ``hold_lse``), the two shards merged (``merge_lse_partials``) held by
    ``hold_merge`` to B12_TOL (K1) / B10_TOL (K2) beyond the roundings the
    design allows against the unsharded function in f32 (each shard's output
    is rounded to bf16 before the merge, as JAX's is), an equal-weight merge
    beyond it, a row empty on every shard merged to 0; the merge against the
    unsharded kernel is reported.  K3 bit-equal to its plain version on
    each shard, the shards' writes together equal to the unsharded
    append's, q rotated on every rank.  Each timed over the 28 layers beside its byte bound, its
    plain version and, for K1 / K2, the memory-efficient SDPA with
    ``compute_log_sumexp`` over the shard (K2's after a page gather)."""
    from chatglm_q_tpu_torch.models.chatglm2 import precompute_freqs_cis
    from chatglm_q_tpu_torch.ops import attention as A
    from chatglm_q_tpu_torch.utils.timing import cuda_event_ms

    gen = torch.Generator(device="cuda").manual_seed(15)
    L, B, G, Hg, D, tp = 28, len(SHARD_LENGTHS), 2, 16, 128, SHARD_TP
    T, sm = SHARD_T, 1.0 / math.sqrt(D)
    Tl = T // tp
    out = {}

    def bf(*shape):
        return torch.randn(shape, device="cuda", generator=gen).to(torch.bfloat16)

    def i32(*xs):
        return torch.tensor(xs, dtype=torch.int32, device="cuda")

    # K1 over the two T-shards of an 8192-slot cache
    kc, vc = bf(L, B, G, T, D), bf(L, B, G, T, D)
    ks = [kc[..., r * Tl:(r + 1) * Tl, :].contiguous() for r in range(tp)]
    vs = [vc[..., r * Tl:(r + 1) * Tl, :].contiguous() for r in range(tp)]
    q = bf(B, G, Hg, D)
    lens = i32(*SHARD_LENGTHS)
    parts, errs = [], []
    for r in range(tp):
        got = A.flash_attention_decode_lse(q, ks[r][0], vs[r][0], lens, sm, r * Tl)
        torch.cuda.synchronize()
        errs.append(hold_lse(torch, "flash_attention_decode_lse", got,
                             A.flash_attention_decode_lse_plain(q, ks[r][0], vs[r][0], lens, sm,
                                                                r * Tl), f"shard {r}"))
        require(all(torch.equal(a, b) for a, b in zip(
            got, A.flash_attention_decode_lse(q, ks[r][0], vs[r][0], lens, sm, r * Tl))),
            "flash_attention_decode_lse: two calls on the same inputs differ")
        parts.append(got)
    # K1's function in f32 over the whole cache: its plain version on f32
    # inputs (p is not rounded), and over |v| for the bound of p's rounding
    qf, kf, vf = q.float(), kc[0].float(), vc[0].float()
    want32 = A.flash_attention_decode_lse_plain(qf, kf, vf, lens, sm)[0]
    abs32 = A.flash_attention_decode_lse_plain(qf, kf, vf.abs(), lens, sm)[0]
    del qf, kf, vf
    merged, k1_beyond, k1_ctrl = hold_merge(
        torch, "K1", tuple(torch.stack(x) for x in zip(*parts)), want32, abs32, B12_TOL, "main")
    whole = A.flash_attention_decode(q, kc[0], vc[0], lens, sm)
    _, merge_rel = rel_err(merged, whole)
    require(not merged[3].float().any(),
            f"K1: row -1 merged to {merged[3].float().abs().max().item()}, not 0")
    log(f"  K1 shards merged: beyond the design's bound {k1_beyond:.3e} of max|out| (limit "
        f"{B12_TOL:.1e}), equal-weight control {k1_ctrl:.3e}; against the unsharded kernel "
        f"{merge_rel:.3e} of max|out|")
    del want32, abs32
    for r in range(tp):
        n = [max(0, min(x + 1 - r * Tl, Tl)) for x in SHARD_LENGTHS]
        valid = torch.arange(Tl, device="cuda")[None, :] < torch.tensor(n, device="cuda")[:, None]
        ms = cuda_event_ms(lambda i: A.flash_attention_decode_lse(q, ks[r][i % L], vs[r][i % L],
                                                                  lens, sm, r * Tl), iters=56)
        plain = cuda_event_ms(lambda i: A.flash_attention_decode_lse_plain(
            q, ks[r][0], vs[r][0], lens, sm, r * Tl), iters=5)
        lib = lse_library(torch, q, ks[r], vs[r], valid, sm)
        b, by = bound_ms(2 * q.numel() * 2 + 2 * B * G * Hg * 4 + sum(n) * G * D * 2 * 2 + B * 4,
                         4.0 * sum(n) * G * Hg * D)
        key = "flash_attention_decode_lse" + ("" if r == 0 else f" shard {r}")
        out[key] = dict(
            max_abs_err=errs[r][0], rel_err=errs[r][1], m_rel_err=errs[r][2],
            l_rel_err=errs[r][3], ms=ms, plain_ms=plain, bound_ms=b, bound_by=by,
            library_ms=lib, merged_vs_unsharded_rel_err=merge_rel,
            merged_beyond_bound=k1_beyond, merged_equal_weight_control=k1_ctrl,
            shape=f"q (B={B}, G={G}, Hg={Hg}, D={D}), shard {r} of T={T}: (B, G, {Tl}, D) "
                  f"slots {r * Tl}.., lengths={list(SHARD_LENGTHS)}, valid rows {n}")
    del ks, vs

    # K3 on the dense T-shards: bit-equal to its plain version on each shard,
    # both shards' writes equal to the unsharded append, q rotated everywhere
    table = torch.from_numpy(precompute_freqs_cis(D, T + 1)).to("cuda", torch.bfloat16)
    kv = bf(B, 2 * G * D)
    ql = bf(B, 1, Hg, D)  # rank 0's heads: group 0 (rank 1's: group 1)
    for st in (i32(8000, 5000, 3000, 2), i32(T - 1, T, T + 5, Tl - 1), i32(Tl, Tl + 1, 0, 4095)):
        freqs = table[(st.long() + 1).clamp(max=T)]
        kw, vw = kc.clone(), vc.clone()
        A.rope_kv_append_plain(q, kv, freqs, kw, vw, 5, st)
        for r in range(tp):
            shard = A.KVShard(offset=r * Tl, total=T)
            k_r = kc[..., r * Tl:(r + 1) * Tl, :].contiguous()
            v_r = vc[..., r * Tl:(r + 1) * Tl, :].contiguous()
            k_p, v_p = k_r.clone(), v_r.clone()
            got = A.rope_kv_append_sharded(ql, kv, freqs, k_r, v_r, 5, st, shard)
            torch.cuda.synchronize()
            want = A.rope_kv_append_sharded_plain(ql, kv, freqs, k_p, v_p, 5, st, shard)
            require(torch.equal(got, want) and torch.equal(k_r, k_p) and torch.equal(v_r, v_p),
                    f"rope_kv_append_sharded shard {r}, starts {st.tolist()}: differs from its "
                    "plain version")
            require(torch.equal(k_r, kw[..., r * Tl:(r + 1) * Tl, :])
                    and torch.equal(v_r, vw[..., r * Tl:(r + 1) * Tl, :]),
                    f"rope_kv_append_sharded shard {r}, starts {st.tolist()}: its writes differ "
                    "from the unsharded append's")
            del k_r, v_r, k_p, v_p
        del kw, vw
    st = i32(*[x if x >= 0 else 0 for x in SHARD_LENGTHS])
    freqs = table[(st.long() + 1)]
    k0, v0 = kc[..., :Tl, :].contiguous(), vc[..., :Tl, :].contiguous()
    shard = A.KVShard(offset=0, total=T)
    ms = cuda_event_ms(lambda i: A.rope_kv_append_sharded(ql, kv, freqs, k0, v0, i % L, st, shard),
                       iters=56)
    plain = synced_ms(torch, lambda i: A.rope_kv_append_sharded_plain(ql, kv, freqs, k0, v0,
                                                                      i % L, st, shard), 14)
    owned = sum(1 for x in st.tolist() if x < Tl)
    # q read and written, the kv row and freqs row read, k and v written
    # where the shard holds the slot, starts read
    b, by = bound_ms(B * (2 * ql[0].numel() * 2 + G * D * 2 * 2 + D * 2 + 4)
                     + owned * 2 * G * D * 2, 6.0 * B * (Hg + G) * D / 2, PEAK_F32_FLOPS)
    out["rope_kv_append_sharded"] = dict(
        max_abs_err=0.0, rel_err=0.0, ms=ms, plain_ms=plain, bound_ms=b, bound_by=by,
        library_ms=None, shape=f"q (B={B}, 1, Hg={Hg}, D={D}) rank 0's heads, T-shard 0 "
                               f"(L={L}, B={B}, G={G}, {Tl}, D={D}) of T={T}, starts "
                               f"{st.tolist()}; exact on both shards, starts in each, at the "
                               "wall and past it")
    del kc, vc, k0, v0

    # K2 over the two phases of a pool of 256-row pages: logical block j of a
    # row on phase j % 2's sub-pool
    P, MP = PAGE, 16
    sp = B * MP // tp + 1  # a sub-pool: its garbage page, then the rows' pages
    pt = torch.tensor([[(j % tp) * sp + 1 + b * (MP // tp) + j // tp for j in range(MP)]
                       for b in range(B)], dtype=torch.int32, device="cuda")
    kp, vp = bf(L, tp * sp, G, P, D), bf(L, tp * sp, G, P, D)
    kps = [kp[:, r * sp:(r + 1) * sp].contiguous() for r in range(tp)]
    vps = [vp[:, r * sp:(r + 1) * sp].contiguous() for r in range(tp)]
    tables = [A.msharded_page_table(pt, _MeshAt(tp, r), sp) for r in range(tp)]
    cap = MP * P
    worst = {"out": 0.0, "m": 0.0, "l": 0.0, "merged": 0.0, "beyond": 0.0, "control": math.inf}
    k2_rows = {}
    for where, lens2 in (("main", i32(3500, 2100, 700, -1)),
                         ("edges", i32(-1, 0, P - 1, P, 2 * P - 1, 2 * P, cap - 1, cap + 30))):
        Bx = lens2.shape[0]
        q2 = bf(Bx, G, Hg, D)
        ptx = pt.repeat(2, 1)[:Bx] if Bx > B else pt
        tabs = [t.repeat(2, 1)[:Bx] if Bx > B else t for t in tables]
        parts = []
        for r in range(tp):
            got = A.flash_attention_decode_paged_lse(q2, kps[r], vps[r], 0, tabs[r], lens2, sm,
                                                     tp, r)
            torch.cuda.synchronize()
            e = hold_lse(torch, "flash_attention_decode_paged_lse", got,
                         A.flash_attention_decode_paged_lse_plain(q2, kps[r], vps[r], 0, tabs[r],
                                                                  lens2, sm, tp, r),
                         f"{where} phase {r}")
            worst.update(out=max(worst["out"], e[1]), m=max(worst["m"], e[2]),
                         l=max(worst["l"], e[3]))
            parts.append(got)
            if where == "main":
                k2_rows[r] = e
        # B10's function in f32 over the gathered pages (p in f32: no term
        # for p's rounding)
        want32 = decode_v2_f32(torch, q2, A.gather_pages(kp[0], ptx), A.gather_pages(vp[0], ptx),
                               lens2, sm)
        merged, beyond, ctrl = hold_merge(torch, "K2", tuple(torch.stack(x) for x in zip(*parts)),
                                          want32, None, B10_TOL, where)
        whole = A.flash_attention_decode_paged(q2, kp, vp, 0, ptx, lens2, sm)
        _, mrel = rel_err(merged, whole)
        require(not merged[(lens2 < 0).nonzero()[:, 0]].float().any(),
                f"K2 {where}: a length -1 row merged to a nonzero output")
        worst.update(merged=max(worst["merged"], mrel), beyond=max(worst["beyond"], beyond),
                     control=min(worst["control"], ctrl))
    log(f"  K2 phases against the plain version (out, m, l), the merge beyond the design's "
        f"bound (limit {B10_TOL:.1e}), its equal-weight control (least) and the merge against "
        f"the unsharded kernel: {json.dumps(worst)}")
    lens2 = i32(3500, 2100, 700, -1)
    for r in range(tp):
        q2 = bf(B, G, Hg, D)
        blocks = [(max(0, x + 1) + P - 1) // P for x in lens2.tolist()]
        n = [sum(min(P, x + 1 - j * P) for j in range(nb) if j % tp == r)
             for x, nb in zip(lens2.tolist(), blocks)]
        ms = cuda_event_ms(lambda i: A.flash_attention_decode_paged_lse(
            q2, kps[r], vps[r], i % L, tables[r], lens2, sm, tp, r), iters=56)
        plain = cuda_event_ms(lambda i: A.flash_attention_decode_paged_lse_plain(
            q2, kps[r], vps[r], 0, tables[r], lens2, sm, tp, r), iters=5)
        t_loc = torch.arange(tables[r].shape[1] * P, device="cuda")
        logical = ((t_loc // P) * tp + r) * P + t_loc % P
        valid = logical[None, :] <= lens2.long()[:, None]
        dense = [torch.stack([A.gather_pages(kps[r][l], tables[r]) for l in range(2)]),
                 torch.stack([A.gather_pages(vps[r][l], tables[r]) for l in range(2)])]
        lib = lse_library(torch, q2, dense[0], dense[1], valid, sm)
        if lib is not None:  # with the page gather, as B10's library row
            lib += cuda_event_ms(lambda i: (A.gather_pages(kps[r][i % L], tables[r]),
                                            A.gather_pages(vps[r][i % L], tables[r])), iters=56)
        b, by = bound_ms(2 * q2.numel() * 2 + 2 * B * G * Hg * 4 + sum(n) * G * D * 2 * 2
                         + B * tables[r].shape[1] * 4 + B * 4, 4.0 * sum(n) * G * Hg * D)
        key = "flash_attention_decode_paged_lse" + ("" if r == 0 else f" phase {r}")
        out[key] = dict(max_abs_err=k2_rows[r][0], rel_err=k2_rows[r][1],
                        m_rel_err=k2_rows[r][2], l_rel_err=k2_rows[r][3], ms=ms, plain_ms=plain,
                        bound_ms=b, bound_by=by, library_ms=lib, merged_vs_unsharded_rel_err=worst["merged"],
                        merged_beyond_bound=worst["beyond"],
                        merged_equal_weight_control=worst["control"],
                        shape=f"B={B} G={G} Hg={Hg} D={D} P={P}, phase {r} of stride {tp}: "
                              f"local table (B, {tables[r].shape[1]}) of MP={MP}, lengths="
                              f"{lens2.tolist()}, valid rows {n}")
        del dense

    # K3 on the model-sharded pool: each phase's writes, exact, and together
    # the unsharded B9-with-RoPE's
    for st in (i32(3500, 2100, 700, 5), i32(cap - 1, cap, cap + 100, 256)):
        freqs = table[(st.long() + 1).clamp(max=T)]
        kw, vw = kp.clone(), vp.clone()
        A.rope_kv_append_plain(q, kv, freqs, kw, vw, 7, st, pt)
        for r in range(tp):
            shard = A.KVShard(stride=tp, phase=r, total=cap)
            k_r, v_r = kps[r].clone(), vps[r].clone()
            k_p, v_p = k_r.clone(), v_r.clone()
            got = A.rope_kv_append_sharded(ql, kv, freqs, k_r, v_r, 7, st, shard, tables[r])
            torch.cuda.synchronize()
            want = A.rope_kv_append_sharded_plain(ql, kv, freqs, k_p, v_p, 7, st, shard,
                                                  tables[r])
            require(torch.equal(got, want) and torch.equal(k_r, k_p) and torch.equal(v_r, v_p),
                    f"rope_kv_append_sharded phase {r}, starts {st.tolist()}: differs from its "
                    "plain version")
            require(torch.equal(k_r, kw[:, r * sp:(r + 1) * sp])
                    and torch.equal(v_r, vw[:, r * sp:(r + 1) * sp]),
                    f"rope_kv_append_sharded phase {r}, starts {st.tolist()}: its writes differ "
                    "from the unsharded append's")
            del k_r, v_r, k_p, v_p
        del kw, vw
    st = i32(3500, 2100, 700, 5)
    freqs = table[(st.long() + 1)]
    shard = A.KVShard(stride=tp, phase=0, total=cap)
    ms = cuda_event_ms(lambda i: A.rope_kv_append_sharded(ql, kv, freqs, kps[0], vps[0], i % L,
                                                          st, shard, tables[0]), iters=56)
    plain = synced_ms(torch, lambda i: A.rope_kv_append_sharded_plain(
        ql, kv, freqs, kps[0], vps[0], i % L, st, shard, tables[0]), 14)
    b, by = bound_ms(B * (2 * ql[0].numel() * 2 + 2 * G * D * 2 + D * 2 + 8),
                     6.0 * B * (Hg + G) * D / 2, PEAK_F32_FLOPS)
    out["rope_kv_append_sharded paged"] = dict(
        max_abs_err=0.0, rel_err=0.0, ms=ms, plain_ms=plain, bound_ms=b, bound_by=by,
        library_ms=None, shape=f"q (B={B}, 1, Hg={Hg}, D={D}) rank 0's heads, phase 0 of "
                               f"stride {tp}: pool (L={L}, {sp}, G={G}, P={P}, D={D}), local "
                               f"table (B, {tables[0].shape[1]}), starts {st.tolist()}; exact "
                               "on both phases, at the capacity and past it")
    del kp, vp, kps, vps
    log_attention_rows(out, 38)
    return out


# ---------------------------------------------------------------------------
# Phase 8: tensor-parallel serving on two ranks sharing the card
# ---------------------------------------------------------------------------

SHARD_NEW_TOKENS = 32
# phase 8's depth on gloo ranks sharing the card (every width full): its
# eager steps pay the host transport once a layer; --nccl runs all 28
SHARD_LAYERS = 8
SHARD_SPEC_TOKENS = 8  # runs (c)-(g)
SHARD_LOOP_TOKENS = 32  # the greedy rows of (c)-(f) on short cycles, which drafts must hit
SHARD_HTTP_TOKENS = 12
SHARD_FP8_TOKENS = 16  # runs (a8), (b8): the fp8 cache and pool; and (a32) ... (b32f8) in f32
SHARD_F32_PROMPTS = (48, 64, 80, 56)  # the f32 runs' prompt lengths
# what each run's verify steps must launch, once a layer a step: the
# model-sharded pool's verify attends the all-gathered pages (B5's chunked
# form), the data-sharded pool's through the chunk kernel (B11)
SHARDED_VERIFY = {"c": "flash_attention_prefill_chunk", "d": "flash_attention_prefill_chunk",
                  "e": "flash_attention_chunk_paged", "f": "flash_attention_chunk_paged"}
# the kernels a tensor-parallel decode step runs (once a layer, per rank), and the
# unsharded forms it must not
SHARDED_DECODE = {"a": ("flash_attention_decode_lse", "rope_kv_append_sharded"),
                  "b": ("flash_attention_decode_paged_lse", "rope_kv_append_sharded")}
UNSHARDED_DECODE = ("flash_attention_decode", "flash_attention_decode_paged", "rope_kv_append",
                    "kv_cache_write_idx", "kv_pool_write_idx", "flash_attention_decode_v2")


def sharded_prompts(torch, seed):
    """(a): five prompts of 512-4200 tokens (multiples of tp: the ring splits
    each over the ranks); the 4200-token one crosses the 4096 slots of rank
    0's T-shard, so its prefill writes on rank 1 and its decode merges two
    live shards.  (b): phase 6 (a)'s six greedy prompts of 300-1100 tokens,
    four sharing a 512-token head.  32 greedy tokens each.  (c) and (e):
    two of phase 6 (b)'s prompts repeating a 40-token span, greedy, 8
    tokens each, and two 120-token prompts cycling one and two tokens
    (``cycles``), greedy, 32 tokens each; (d) and (f): a mixed batch, the
    two cycles greedy and two sampled at temperature 0.8 / top-p 0.8 (the
    third and the first span prompt, 8 tokens each).  (g): four prompts of
    1100, 300, 700 and 500 tokens, 8 greedy tokens each (the longest
    crosses into rank 1's T-shard of 1024)."""
    g = torch.Generator().manual_seed(seed)
    kw = dict(temperature=0.0, max_new_tokens=SHARD_NEW_TOKENS)
    a = [(torch.randint(3, 65000, (n,), generator=g).tolist(), kw)
         for n in (4200, 2048, 512, 1200, 760)]
    a_six, b_three = engine_prompts(torch, seed)
    b = [(p, kw) for p, k in a_six if k["temperature"] == 0.0]
    greedy = dict(temperature=0.0, max_new_tokens=SHARD_SPEC_TOKENS)
    sampled = dict(temperature=0.8, top_p=0.8, max_new_tokens=SHARD_SPEC_TOKENS)
    spec = [(p, greedy) for p, _ in b_three]
    look = [(torch.randint(3, 65000, (n,), generator=g).tolist(), greedy)
            for n in (1100, 300, 700, 500)]
    loops = [(p, dict(greedy, max_new_tokens=SHARD_LOOP_TOKENS)) for p in cycles(torch)]
    mixed = loops + [(spec[2][0], sampled), (spec[0][0], sampled)]
    short = dict(kw, max_new_tokens=SHARD_FP8_TOKENS)
    a32 = [(p[:n], short) for (p, _), n in zip(a[1:4], SHARD_F32_PROMPTS)]
    b32 = [(p[:n], short) for (p, _), n in zip(b[:4], SHARD_F32_PROMPTS)]
    return {"a": a, "b": b, "c": spec[:2] + loops, "d": mixed, "e": spec[:2] + loops,
            "f": mixed, "g": look, "a8": [(p, short) for p, _ in a[1:4]],
            "b8": [(p, short) for p, _ in b[:4]], "a32": a32, "b32": b32, "a32f8": a32,
            "b32f8": b32}


def cycles(torch, seed=5):
    """Two 120-token prompts, one token repeated and two cycling, on which a
    random tree falls into a short loop of its own, so n-gram drafts are
    accepted (on phase 8's trees, at 8 layers and at 28, where the 40-token
    spans of phase 6 (b) accept next to none at 8 layers)."""
    g = torch.Generator().manual_seed(seed)
    return [torch.randint(3, 65000, (n,), generator=g).tolist() * (120 // n) for n in (1, 2)]


def sharded_rank(rank, tree_path, prompts, tp, layers, http=True):
    """One rank of phase 8 on a (1, tp) mesh: its slice of the memory-mapped
    tree on its card (gloo: every rank on this one; NCCL: card ``rank``),
    then each run of ``prompts`` on its engine, each draining its requests
    (submitted through rank 0's ``sync_events``), and the API server over
    the mesh (``sharded_http``); returns their tokens, launch counts, decode
    steps, host times and, for (a) and (b), each shard's (layer, decode
    step, b, g) whose partial the merge took with rows in it (l > 0)."""
    import torch

    from chatglm_q_tpu_torch import ChatGLM2Config, GLMLoadConfig, TorchRuntimeConfig, ops
    from chatglm_q_tpu_torch.ops import attention as A
    from chatglm_q_tpu_torch.parallel import sharding as SH
    from chatglm_q_tpu_torch.serving import (DistributedPagedServingEngine,
                                             DistributedServingEngine)
    from chatglm_q_tpu_torch.utils import graphs as G

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = ChatGLM2Config(num_layers=layers)
    mesh = SH.make_mesh(1, tp)
    t0 = time.perf_counter()
    params = SH.shard_params(torch.load(tree_path, mmap=True, weights_only=True), mesh, cfg,
                             "int4g32", device="cuda")
    torch.cuda.synchronize()
    res = {"load_s": time.perf_counter() - t0}
    load = GLMLoadConfig(model_config=cfg, quant_type="int4g32", torch_dtype="bfloat16")
    load32 = GLMLoadConfig(model_config=cfg, quant_type="int4g32", torch_dtype="float32")
    pool = dict(num_pages=POOL_PAGES, page_size=PAGE, max_batch=4, max_seq_len=SEQ)
    spec = dict(pool, decode_chunk=4, speculative_k=8, speculative_ngram=3)

    def paged(load=load, **kw):
        return lambda graphs: DistributedPagedServingEngine(
            load, params, mesh=mesh, rt=TorchRuntimeConfig(cuda_graphs=graphs), **kw)

    def dense32(kv_dtype=None):  # (a) in f32 (a float32 config), chunked admission
        return lambda graphs: DistributedServingEngine(
            load32, params, mesh=mesh, max_batch=4, max_seq_len=SHARD_T, decode_chunk=16,
            prefill_chunk_size=PAGE, kv_dtype=kv_dtype,
            rt=TorchRuntimeConfig(kv_shard_t=True, cuda_graphs=graphs))

    makers = {
        "a": lambda graphs: DistributedServingEngine(
            load, params, mesh=mesh, max_batch=4, max_seq_len=SHARD_T, decode_chunk=16,
            rt=TorchRuntimeConfig(kv_shard_t=True, cuda_graphs=graphs)),
        "b": paged(shard_model_pages=True, prefill_chunk_size=PAGE, prefix_cache=True,
                   decode_chunk=16, **pool),
        "c": paged(shard_model_pages=True, **spec),
        "d": paged(shard_model_pages=True, speculative_sampled=True, seed=SHARD_TP, **spec),
        "e": paged(**spec),
        "f": paged(speculative_sampled=True, seed=SHARD_TP, **spec),
        "g": lambda graphs: DistributedServingEngine(
            load, params, mesh=mesh, max_batch=4, max_seq_len=SEQ, decode_chunk=4,
            lookahead=True, rt=TorchRuntimeConfig(kv_shard_t=True, cuda_graphs=graphs)),
        # (a) and (b) over an fp8 cache and pool, with chunked admission: every
        # prefill reads the stored bytes, as the single-device reference does
        "a8": lambda graphs: DistributedServingEngine(
            load, params, mesh=mesh, max_batch=4, max_seq_len=SHARD_T, decode_chunk=16,
            prefill_chunk_size=PAGE, kv_dtype=torch.float8_e4m3fn,
            rt=TorchRuntimeConfig(kv_shard_t=True, cuda_graphs=graphs)),
        "b8": paged(shard_model_pages=True, prefill_chunk_size=PAGE, prefix_cache=True,
                    decode_chunk=16, kv_dtype=torch.float8_e4m3fn, **pool),
        # (a) and (b) with a float32 config over an f32 cache and pool, and over fp8
        "a32": dense32(),
        "b32": paged(load32, shard_model_pages=True, prefill_chunk_size=PAGE, prefix_cache=True,
                     decode_chunk=16, **pool),
        "a32f8": dense32(torch.float8_e4m3fn),
        "b32f8": paged(load32, shard_model_pages=True, prefill_chunk_size=PAGE,
                       prefix_cache=True, decode_chunk=16, kv_dtype=torch.float8_e4m3fn, **pool),
    }
    # over NCCL the decode chunks are captured (a gloo mesh refuses capture):
    # each run is driven captured, then again from eager launches
    modes = ((True, ""), (False, "_eager")) if mesh.backend == "nccl" else ((True, ""),)
    runs = [(run, reqs, graphs, suffix) for run, reqs in prompts.items()
            for graphs, suffix in modes]
    registry = G.programs(params)
    merge = A.merge_lse_partials
    for run, reqs, graphs, suffix in runs:
        eng = makers[run](graphs)
        captures = registry.captures
        live = torch.zeros(tp, dtype=torch.long, device="cuda")

        def probe(out, m, l, dtype):  # the decode merges only: count each shard's live (b, g)
            live.add_((l[..., 0] > 0).flatten(1).sum(1))
            return merge(out, m, l, dtype)

        ops.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.sync_events([("submit", p, kw) for p, kw in reqs] if rank == 0 else None)
        decode_walls = []
        A.merge_lse_partials = probe
        try:
            while eng.has_work:
                decode = _decode_only(eng)
                ts = time.perf_counter()
                eng.step()
                torch.cuda.synchronize()
                if decode:
                    decode_walls.append(time.perf_counter() - ts)
                if eng.stats["steps"] >= 1000:
                    raise RuntimeError(f"phase 8 ({run}): the engine did not drain")
        finally:
            A.merge_lse_partials = merge
        wall = time.perf_counter() - t0
        by_id = {r.req_id: r.generated for r in eng.finished}
        walls = sorted(decode_walls)
        key = run + suffix
        res[key] = {"tokens": [by_id[i] for i in sorted(by_id)], "counts": ops.launch_counts(),
                    "decode_steps": eng.stats["decode_chunks"] * eng.chunk, "wall_s": wall,
                    "decode_ms_per_step_median": (walls[len(walls) // 2] * 1e3 / eng.chunk
                                                  if walls else None),
                    "live_per_shard": live.tolist(), "stats": dict(eng.stats),
                    "captures": registry.captures - captures}
        if hasattr(eng, "pages_in_use"):
            res[key]["pages_in_use"] = eng.pages_in_use
        if run in ("a", "b"):
            res[key]["decode_timing"] = sharded_decode_timing(torch, eng, mesh)
        del eng
        torch.cuda.empty_cache()
    if http:
        res["http"] = sharded_http(rank, mesh, load, params)
    return res


def sharded_http(rank, mesh, load, params):
    """The API server over the mesh: rank 0 runs ``GLMAPIServer`` on the
    model-sharded paged engine (the 65024-id tokenizer), every other rank
    ``follow``.  First the engine's own greedy run of the chat prompt (all
    ranks in lockstep), then over HTTP on localhost a chat, the same
    streamed and a stop string.  Returns the prompt's ids, the run's tokens
    and text, and on rank 0 the answers and the request ms."""
    import urllib.request

    from chatglm_q_tpu_torch import ops
    from chatglm_q_tpu_torch.serving import DistributedPagedServingEngine, GLMAPIServer
    from chatglm_q_tpu_torch.serving.api_server import _messages_to_prompt, follow
    from chatglm_q_tpu_torch.serving.chat import process_response

    tok = chat_tokenizer()
    eng = DistributedPagedServingEngine(load, params, tok, mesh=mesh, shard_model_pages=True,
                                        num_pages=POOL_PAGES, page_size=PAGE, max_batch=4,
                                        max_seq_len=SEQ, decode_chunk=4)
    messages = [{"role": "user", "content": CHAT_QUESTION}]
    ids = tok.encode(_messages_to_prompt(messages))
    greedy = dict(temperature=0.0, max_new_tokens=SHARD_HTTP_TOKENS)
    eng.sync_submissions([ids] if rank == 0 else None, **greedy)
    while eng.has_work:
        eng.step()
    gen = eng.finished[-1].generated
    res = {"ids": ids, "tokens": gen, "want": process_response(tok.decode(gen))}
    eng.finished.clear()
    ops.reset_launch_counts()
    if rank != 0:
        res["events"] = [e[0] for e, _ in follow(eng)]
        res["counts"] = ops.launch_counts()
        return res
    server = GLMAPIServer(eng, port=0, model_name="chatglm2-6b")
    url = f"http://{server.host}:{server.port}/v1/chat/completions"
    body = {"model": "chatglm2-6b", "messages": messages, "temperature": 0.0,
            "max_tokens": SHARD_HTTP_TOKENS}

    def post(b):
        req = urllib.request.Request(url, data=json.dumps(b).encode(),
                                     headers={"Content-Type": "application/json"})
        t0 = time.perf_counter()
        with urllib.request.urlopen(req, timeout=300) as resp:
            data = resp.read().decode()
        return data, (time.perf_counter() - t0) * 1e3

    want = res["want"]
    stop = want[len(want) // 2: len(want) // 2 + 3]
    ms = {}
    server.start()
    try:
        data, ms["chat"] = post(body)
        res["chat"] = json.loads(data)["choices"][0]["message"]["content"]
        data, ms["stream"] = post(dict(body, stream=True))
        chunks = [json.loads(line[6:]) for line in data.splitlines() if line.startswith("data: {")]
        res["stream"] = "".join(c["choices"][0]["delta"].get("content", "") for c in chunks)
        res["stream_done"] = data.rstrip().endswith("data: [DONE]")
        data, ms["stop"] = post(dict(body, stop=stop))
        res["stop"] = json.loads(data)["choices"][0]
    finally:
        server.shutdown()
        server.worker.join(timeout=120)
    res.update(stop_string=stop, request_ms=ms, counts=ops.launch_counts())
    return res


def sharded_decode_timing(torch, eng, mesh):
    """Decode-only steps of a drained engine on four fresh 256-token prompts
    (no prefix hit): the host wall of each such step (``decode_chunk``
    decode steps) and the collectives it ran and the host time inside them,
    each per decode step."""
    g = torch.Generator().manual_seed(SHARD_TP)
    for _ in range(4):
        eng.submit(torch.randint(3, 65000, (256,), generator=g).tolist(), temperature=0.0,
                   max_new_tokens=3 * eng.chunk)
    walls, calls, secs = [], [], []
    while eng.has_work:
        decode = _decode_only(eng)
        c0, s0 = mesh.calls, mesh.seconds
        ts = time.perf_counter()
        eng.step()
        torch.cuda.synchronize()
        if decode:
            walls.append((time.perf_counter() - ts) * 1e3 / eng.chunk)
            calls.append((mesh.calls - c0) / eng.chunk)
            secs.append((mesh.seconds - s0) * 1e3 / eng.chunk)
    return {"decode_ms_per_step": walls, "collectives_per_step": calls,
            "collective_ms_per_step": secs}


def sharded_serving_checks(torch, params, cfg, ranks, prompts, smi, backend, tp):
    """Runs (c)-(g) and the API server of phase 8: in-loop speculation, greedy
    (c, e) and a mixed batch with sampled rows (d, f), on the model-sharded
    pool (c, d) and the data-sharded one (e, f); (g) the dense engine with
    ``lookahead`` on a T-sharded cache; the server on rank 0 with ``follow``
    on the others.  Checks: the ranks token-equal (sampled rows too), every
    request within its budget, no page in use after a drain, each
    speculation run's verify steps through the attention its pool takes
    (``SHARDED_VERIFY``) and B1's split-K kernel, and drafts accepted on
    every rank in each of them, (g) K1 and K3 once a layer a
    decode step; every greedy token of (c)-(g) and of the server's engine
    within ``GREEDY_GAP_TOL`` of the single-device dense reference, the
    shifted stream not; the chat, the stream and the stop string answer with
    the engine's own greedy text."""
    from types import SimpleNamespace

    out, idle = {}, []
    for run in "cdefg":
        reqs, r0 = prompts[run], ranks[0][run]
        loops = [j for j, (_, kw) in enumerate(reqs) if kw["max_new_tokens"] == SHARD_LOOP_TOKENS]
        require(all(r[run]["tokens"] == r0["tokens"] for r in ranks),
                f"phase 8 ({run}): the ranks' tokens differ")
        require(len(r0["tokens"]) == len(reqs) and all(
            0 < len(t) <= kw["max_new_tokens"] for t, (_, kw) in zip(r0["tokens"], reqs)),
            f"phase 8 ({run}): unfinished or over budget: {[len(t) for t in r0['tokens']]}")
        for i, r in enumerate(ranks):
            c = r[run]["counts"]
            if run in SHARDED_VERIFY:
                steps = r[run]["stats"]["spec_steps"]
                kern = SHARDED_VERIFY[run]
                require(steps > 0 and c[kern] == cfg.num_layers * steps,
                        f"phase 8 ({run}) rank {i}: {kern} launched {c[kern]} times in {steps} "
                        f"verify steps (want {cfg.num_layers} a step)")
                require(c["int4g32_splitk"] > 0 and r[run]["pages_in_use"] == 0,
                        f"phase 8 ({run}) rank {i}: no split-K launch, or pages in use")
                if not r[run]["stats"]["spec_accepted"]:
                    idle.append(f"({run}) rank {i} in {steps} verify steps, the cycle rows "
                                f"{[r[run]['tokens'][j] for j in loops]}")
            else:
                for kern in SHARDED_DECODE["a"]:
                    require(c[kern] == cfg.num_layers * r[run]["decode_steps"],
                            f"phase 8 ({run}) rank {i}: {kern} launched {c[kern]} times in "
                            f"{r[run]['decode_steps']} decode steps")
        done = [SimpleNamespace(generated=t) for t in r0["tokens"]]
        gaps = greedy_gaps(torch, params, cfg, done, reqs)
        require(gaps["f32"][0] <= GREEDY_GAP_TOL and gaps["f32"][1] > GREEDY_GAP_TOL,
                f"phase 8 ({run}): greedy gap {gaps['f32'][0]}, shifted control {gaps['f32'][1]}")
        out[run] = {"gaps": gaps, "wall_s": [r[run]["wall_s"] for r in ranks],
                    "stats": r0["stats"], "tokens": sum(len(t) for t in r0["tokens"]),
                    "counts": {k: v for k, v in r0["counts"].items() if v}}
        log(f"  ({run}) {len(reqs)} requests, {out[run]['tokens']} tokens on {tp} ranks "
            f"({backend}) in {out[run]['wall_s'][0]:.1f} s, ranks token-equal; "
            + (f"{r0['stats']['spec_steps']} verify steps, {r0['stats']['spec_accepted']} drafted "
               f"tokens accepted; " if run in SHARDED_VERIFY else
               f"lookahead, {r0['decode_steps']} decode steps; ")
            + f"greedy gap f32 {gaps['f32'][0]:.4e}, shifted control {gaps['f32'][1]:.3e}  "
            f"[{smi}]")
    # the verify's accept path (advance by 1 + accepted, roll back, all-gather
    # the accepted drafts) ran on every rank of every speculation run
    require(not idle, "phase 8: no drafted token accepted: " + "; ".join(idle))
    h0 = ranks[0]["http"]
    require(all(r["http"]["tokens"] == h0["tokens"] for r in ranks),
            "phase 8 (http): the ranks' greedy runs differ")
    want = h0["want"]
    require(len(want) >= 8 and h0["chat"] == want and h0["stream"] == want and h0["stream_done"],
            f"phase 8 (http): chat {h0['chat']!r} / stream {h0['stream']!r} differ from the "
            f"engine's {want!r}")
    stop = h0["stop_string"]
    require(h0["stop"]["message"]["content"] == want[: want.find(stop)]
            and h0["stop"]["finish_reason"] == "stop", f"phase 8 (http): stop gave {h0['stop']}")
    require(all(r["http"]["events"].count("submit") == 3 for r in ranks[1:]),
            "phase 8 (http): the followers did not apply the three submissions")
    gaps = greedy_gaps(torch, params, cfg, [SimpleNamespace(generated=h0["tokens"])],
                       [(h0["ids"], dict(temperature=0.0))])
    require(gaps["f32"][0] <= GREEDY_GAP_TOL,
            f"phase 8 (http): greedy gap {gaps['f32'][0]} > {GREEDY_GAP_TOL}")
    out["http"] = {"request_ms": h0["request_ms"], "gaps": gaps,
                   "events_per_rank": [len(r["http"].get("events", [])) for r in ranks[1:]]}
    log(f"  (http) GLMAPIServer on rank 0, follow on {tp - 1} rank(s): chat, SSE stream and stop "
        f"{stop!r} answered with the engine's own greedy text ({len(h0['tokens'])} tokens, "
        f"greedy gap f32 {gaps['f32'][0]:.4e}); request ms "
        f"{json.dumps({k: round(v, 1) for k, v in h0['request_ms'].items()})}  [{smi}]")
    return out


def nccl_capture_checks(ranks, prompts, smi):
    """Over NCCL each run's decode chunks were captured (programs captured
    on every rank) and the run driven again from eager launches: the same
    tokens on every rank, and the ms a decode step of both."""
    out = {}
    for run in prompts:
        for i, r in enumerate(ranks):
            cap, eag = r[run], r[run + "_eager"]
            require(cap["tokens"] == eag["tokens"],
                    f"phase 8 ({run}) rank {i}: the captured run's tokens differ from the eager "
                    "run's")
            require(cap["captures"] > 0 and eag["captures"] == 0,
                    f"phase 8 ({run}) rank {i}: {cap['captures']} captures in the captured run, "
                    f"{eag['captures']} in the eager one")
        r0 = ranks[0]
        out[run] = {"captures": [r[run]["captures"] for r in ranks],
                    "decode_ms_per_step_median": {
                        "captured": [r[run]["decode_ms_per_step_median"] for r in ranks],
                        "eager": [r[run + "_eager"]["decode_ms_per_step_median"] for r in ranks]},
                    "wall_s": {"captured": r0[run]["wall_s"],
                               "eager": r0[run + "_eager"]["wall_s"]}}
        if "decode_timing" in r0[run]:
            out[run]["decode_timing_ms"] = {
                k: [r[run + sfx]["decode_timing"]["decode_ms_per_step"] for r in ranks]
                for k, sfx in (("captured", ""), ("eager", "_eager"))}
        med = out[run]["decode_ms_per_step_median"]
        fmt = lambda xs: "/".join("-" if x is None else f"{x:.2f}" for x in xs)  # noqa: E731
        log(f"  ({run}) over NCCL: decode chunks captured ({out[run]['captures']} programs a "
            f"rank), tokens equal to the eager run's on every rank; median ms a decode step "
            f"captured {fmt(med['captured'])}, eager {fmt(med['eager'])}; wall "
            f"{out[run]['wall_s']['captured']:.1f} / {out[run]['wall_s']['eager']:.1f} s  "
            f"[{smi}]")
    return out


def sharded_slice(torch, smi, seed=81, backend="gloo", tp=SHARD_TP, layers=SHARD_LAYERS,
                  runs=None):
    """Phase 8: an int4g32 random tree of ``layers`` layers at ChatGLM2-6B's
    widths built once here, saved to
    the build directory and memory-mapped by ``tp`` spawned ranks (gloo: all
    on this card; NCCL, ``--nccl``: one card a rank), each slicing its
    shard; both distributed engines driven on them, (c)-(g) and the API
    server too (``sharded_serving_checks``).  Checks: the ranks agree
    token for token; every request finishes within its budget; K1 / K2 and
    K3 launch once a layer a decode step on each rank and the unsharded decode
    forms never; every shard that the longest request reaches (at least
    two) gave the decode merges live partials, on every rank; every greedy
    token within GREEDY_GAP_TOL of the argmax of the single-device dense
    prefill_chunk over prompt + stream (phase 6's ``greedy_gaps``), the
    shifted stream not."""
    from types import SimpleNamespace

    from chatglm_q_tpu_torch import ChatGLM2Config
    from chatglm_q_tpu_torch.bench import random_quantized_params
    from chatglm_q_tpu_torch.ops import _build
    from chatglm_q_tpu_torch.utils.distributed import run_spmd

    cfg = ChatGLM2Config(num_layers=layers)
    params = random_quantized_params(cfg, "int4g32",
                                     torch.Generator(device="cuda").manual_seed(seed + 2))
    prompts = sharded_prompts(torch, seed)
    if runs is not None:  # a part of the phase (``--fp8``: the fp8 runs)
        prompts = {k: v for k, v in prompts.items() if k in runs}
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    path = _build.BUILD_DIR / f"sharded_tree_{seed}.pt"
    t0 = time.perf_counter()
    torch.save(map_tree(params, lambda t: t.cpu()), path)
    save_s = time.perf_counter() - t0
    try:
        t0 = time.perf_counter()
        ranks = run_spmd(sharded_rank, tp, backend, timeout=900,
                         args=(str(path), prompts, tp, layers, runs is None))
        spmd_s = time.perf_counter() - t0
    finally:
        path.unlink(missing_ok=True)
    out = {"card": smi, "backend": backend, "tp": tp, "layers": layers, "tree_save_s": save_s,
           "ranks_s": spmd_s,
           "load_s": [r["load_s"] for r in ranks]}
    counts = {}
    for run, reqs in ((k, prompts[k]) for k in ("a", "b") if k in prompts):
        r0 = ranks[0][run]
        require(all(r[run]["tokens"] == r0["tokens"] for r in ranks),
                f"phase 8 ({run}): the ranks' tokens differ")
        require(len(r0["tokens"]) == len(reqs) and all(
            0 < len(t) <= kw["max_new_tokens"] for t, (_, kw) in zip(r0["tokens"], reqs)),
            f"phase 8 ({run}): unfinished or over budget: {[len(t) for t in r0['tokens']]}")
        for i, r in enumerate(ranks):
            c, steps = r[run]["counts"], r[run]["decode_steps"]
            for kern in SHARDED_DECODE[run]:
                require(c[kern] == cfg.num_layers * steps,
                        f"phase 8 ({run}) rank {i}: {kern} launched {c[kern]} times in {steps} "
                        f"decode steps (want {cfg.num_layers} a step)")
            bad = {k: c[k] for k in UNSHARDED_DECODE if c[k]}
            require(not bad, f"phase 8 ({run}) rank {i}: launched unsharded decode forms {bad}")
        # the shards the longest request reaches: its positions cross rank
        # r's first slot (a) or its first logical page of phase r (b)
        first = SHARD_T // tp if run == "a" else PAGE
        longest = max(len(p) for p, _ in reqs) + SHARD_NEW_TOKENS
        reached = [j for j in range(tp) if j * first < longest]
        require(len(reached) >= 2, f"phase 8 ({run}): the traffic reaches shard {reached} only")
        for i, r in enumerate(ranks):
            live = r[run]["live_per_shard"]
            require(all(live[j] > 0 for j in reached),
                    f"phase 8 ({run}) rank {i}: shards {reached} should all give live partials "
                    f"to the decode merge, (layer, step, b, g) counts {live}")
        if run == "b":
            require(all(r["b"]["pages_in_use"] == 0 for r in ranks),
                    "phase 8 (b): pages in use after the drain")
        done = [SimpleNamespace(generated=t) for t in r0["tokens"]]
        gaps = greedy_gaps(torch, params, cfg, done, reqs,
                           cache_len=max(len(p) for p, _ in reqs) + SHARD_NEW_TOKENS)
        out[run] = {"gaps": gaps, "decode_steps": r0["decode_steps"],
                    "decode_ms_per_step_median": [r[run]["decode_ms_per_step_median"]
                                                  for r in ranks],
                    "decode_timing": [r[run]["decode_timing"] for r in ranks],
                    "wall_s": [r[run]["wall_s"] for r in ranks],
                    "launches_per_decode_step": {
                        k: r0["counts"][k] / r0["decode_steps"] for k in SHARDED_DECODE[run]},
                    "counts": {k: v for k, v in r0["counts"].items() if v},
                    "live_per_shard": [r[run]["live_per_shard"] for r in ranks],
                    "stats": r0["stats"]}
        timing = [r[run]["decode_timing"] for r in ranks]
        log(f"  ({run}) {len(reqs)} requests, {sum(len(t) for t in r0['tokens'])} tokens on {tp} "
            f"ranks ({backend}) in {out[run]['wall_s'][0]:.1f} s; launches a decode step "
            f"{json.dumps(out[run]['launches_per_decode_step'])}; live (layer, step, b, g) a "
            f"shard {out[run]['live_per_shard'][0]}; greedy gap f32 "
            f"{gaps['f32'][0]:.4e}, shifted control {gaps['f32'][1]:.3e}  [{smi}]")
        log(f"    decode-only steps at batch 4 (256-token prompts; rank 0 / 1 / .., {backend}): "
            f"ms a decode step "
            + " / ".join(",".join(f"{x:.1f}" for x in t["decode_ms_per_step"]) for t in timing)
            + "; collectives a decode step "
            + " / ".join(",".join(f"{x:.0f}" for x in t["collectives_per_step"]) for t in timing)
            + ", host ms in them "
            + " / ".join(",".join(f"{x:.1f}" for x in t["collective_ms_per_step"])
                         for t in timing))
        require(gaps["f32"][0] <= GREEDY_GAP_TOL,
                f"phase 8 ({run}): greedy gap {gaps['f32'][0]} > {GREEDY_GAP_TOL}")
        require(gaps["f32"][1] > GREEDY_GAP_TOL,
                f"phase 8 ({run}): the shifted control passes ({gaps['f32'][1]})")
        for k, v in r0["counts"].items():
            counts[k] = counts.get(k, 0) + v
    counts.update(sharded_form_checks(torch, params, cfg, ranks, prompts, smi, backend, tp, out))
    if "c" in prompts:
        out.update(sharded_serving_checks(torch, params, cfg, ranks, prompts, smi, backend, tp))
    if backend == "nccl":
        out["captured_vs_eager"] = nccl_capture_checks(ranks, prompts, smi)
    if "a" in prompts:
        counts["rope_kv_append_sharded"] = ranks[0]["a"]["counts"]["rope_kv_append_sharded"]
        counts["rope_kv_append_sharded paged"] = \
            ranks[0]["b"]["counts"]["rope_kv_append_sharded"]
    log(f"  tree saved in {save_s:.1f} s; ranks done in {spmd_s:.1f} s (slices loaded in "
        + " / ".join(f"{x:.1f}" for x in out["load_s"]) + " s)")
    return counts, out


# ---------------------------------------------------------------------------
# Phase 7: fine-tuning through the frozen quantized weights
# ---------------------------------------------------------------------------

FT_BATCH, FT_SEQ, FT_IGNORED = 2, 512, 64  # 2 x 512 tokens, the first 64 labels at -100
FT_TRAINABLE = 28 * 4096 * 2 + 4096       # the stacked attn_ln / ffn_ln and final_ln
PER_STEP = 6 * 28 + 1                     # quantized matmuls a step runs: 6 a layer + lm_head


def fine_tune(torch, smi, quant, steps, seed):
    """ChatGLM2-6B (28 layers) of ``quant`` random weights: ``steps`` AdamW
    steps over the f32 norm masters on one seeded batch, each step's loss,
    time and launches; then (int4g32) the first step's loss and grads again
    with and without ``remat_layers`` from the same start; then a 16-token
    sample, which takes the split-K backward kernels (``short_step``).
    Every frozen leaf must come out bit-unchanged and every norm moved."""
    from chatglm_q_tpu_torch import ChatGLM2Config, TorchRuntimeConfig, ops
    from chatglm_q_tpu_torch.bench import random_quantized_params
    from chatglm_q_tpu_torch.utils.train import (loss_and_grads, make_train_step,
                                                 partition_params, trainable_leaves)

    cfg = ChatGLM2Config()
    bf16 = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = random_quantized_params(cfg, quant, gen)
    trainable, frozen = partition_params(params)
    leaves = trainable_leaves(trainable)
    n_train = sum(t.numel() for t in leaves)
    require(n_train == FT_TRAINABLE, f"{quant}: {n_train} trainable values")
    frozen_before = {k: v.clone() for k, v in tree_leaves(frozen) if v is not None}
    start = map_tree(trainable, lambda t: None if t is None else
                     t.detach().clone().requires_grad_(True))
    ids = torch.randint(0, cfg.vocab_size, (FT_BATCH, FT_SEQ), device="cuda", generator=gen)
    labels = ids.clone()
    labels[:, :FT_IGNORED] = -100
    rt = TorchRuntimeConfig()
    opt = torch.optim.AdamW(leaves, lr=1e-3, weight_decay=0.0)
    step = make_train_step(cfg, quant, opt, bf16, rt)
    t_fwd, t_bwd = (("int4g32_mma", "int4g32_t_mma") if quant == "int4g32"
                    else ("int8_mma", "int8_t_mma"))
    out = {"card": smi, "quant": quant, "trainable_values": n_train, "steps": []}
    counts_total = dict.fromkeys(ops.launch_counts(), 0)

    def add(c):
        for k, v in c.items():
            counts_total[k] += v

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for i in range(steps):
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        loss = step(trainable, frozen, ids, labels).item()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        c = ops.launch_counts()
        add(c)
        require(math.isfinite(loss), f"{quant} step {i + 1}: loss {loss}")
        require(c[t_bwd] == PER_STEP and c[t_fwd] == PER_STEP,
                f"{quant} step {i + 1}: {c[t_fwd]} forward and {c[t_bwd]} backward launches, "
                f"not {PER_STEP}")
        out["steps"].append({"loss": loss, "ms": ms, "tok_per_s": FT_BATCH * FT_SEQ / ms * 1e3,
                             "launches": {k: v for k, v in c.items() if v}})
        log(f"  {quant} step {i + 1}: loss {loss:.6f}, {ms:.1f} ms, "
            f"{FT_BATCH * FT_SEQ / ms * 1e3:.0f} tokens/s; launches {c[t_fwd]} {t_fwd}, "
            f"{c[t_bwd]} {t_bwd}  [{smi}]")
    out["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
    losses = [s_["loss"] for s_ in out["steps"]]
    # the forward casts the f32 masters to bf16, whose step near 1.0 is 2^-8
    # below and 2^-7 above: an AdamW step of ~1e-3 shows in the forward only
    # from the third step on, so a run takes at least three
    require(steps >= 3 and losses[-1] < losses[0], f"{quant}: the loss did not fall: {losses}")
    moved = [not torch.equal(a.detach(), b) for a, b in
             zip(leaves, trainable_leaves(start))]
    require(all(moved), f"{quant}: a norm did not move")
    log(f"  {quant}: {steps} steps of {FT_BATCH}x{FT_SEQ} tokens, {n_train} trainable values; "
        f"peak device memory {out['peak_mem_bytes'] / 2**30:.2f} GiB  [{smi}]")

    out["profile"] = profile_train_step(torch, step, trainable, frozen, ids, labels,
                                        out["steps"][-1]["ms"], quant)
    out["captured"] = train_turns(torch, smi, cfg, quant, start, frozen, ids, labels)
    if quant == "int4g32":  # the first step again, with and without remat
        runs = {}
        for remat in (False, True):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            runs[remat] = loss_and_grads(cfg, quant, start, frozen, ids, labels, bf16,
                                         TorchRuntimeConfig(remat_layers=remat))
            torch.cuda.synchronize()
            out[f"remat_{remat}"] = {"fwd_bwd_ms": (time.perf_counter() - t0) * 1e3,
                                     "peak_mem_bytes": torch.cuda.max_memory_allocated(),
                                     "forward_launches": ops.launch_counts()[t_fwd]}
            add(ops.launch_counts())
        dl, dg = grad_rel(torch, runs[True], runs[False])
        d1 = abs(runs[False][0].item() - losses[0]) / abs(losses[0])
        out["remat_vs_plain"] = {"loss": dl, "grads": dg, "first_step_loss": d1}
        log(f"  remat_layers from the same start: |Δloss|/|loss| {dl:.3e}, grads {dg:.3e} "
            f"(limits {GRAD_LOSS_TOL:.1e}, {GRAD_TOL:.1e}); fwd+bwd "
            f"{out['remat_False']['fwd_bwd_ms']:.1f} ms, peak "
            f"{out['remat_False']['peak_mem_bytes'] / 2**30:.2f} GiB without, "
            f"{out['remat_True']['fwd_bwd_ms']:.1f} ms, "
            f"{out['remat_True']['peak_mem_bytes'] / 2**30:.2f} GiB with (forward launches "
            f"{out['remat_False']['forward_launches']} / {out['remat_True']['forward_launches']})")
        require(dl <= GRAD_LOSS_TOL and dg <= GRAD_TOL and d1 <= GRAD_LOSS_TOL,
                f"remat_layers: loss {dl}, grads {dg}, first step {d1}")
        del runs

    out["short_step"] = short_step(torch, smi, cfg, quant, trainable, frozen,
                                   ids[:1, FT_IGNORED:FT_IGNORED + 16],
                                   labels[:1, FT_IGNORED:FT_IGNORED + 16], add)
    out["f16"] = f16_fine_tune(torch, smi, cfg, quant, start, frozen, ids, labels, add)
    for k, v in tree_leaves(frozen):
        if v is not None:
            require(torch.equal(v, frozen_before[k]), f"{quant}: frozen leaf {k} changed")
    log(f"  {quant}: all {len(frozen_before)} frozen leaves (packed weights, scales, biases, "
        f"embedding) bit-unchanged")
    return counts_total, out


CAPTURED_TRAIN_STEPS = 4
SHORT_STEPS = 4  # the 16-token step: eager warm-up, capture, then replays
# the split-K backward kernels of a 16-token step (M = 16 rows), as the
# profiler names them
SHORT_KERNELS = {"int4g32": ("int4g32_t_splitk", ("t_splitk_mma_kernel", "Int4TView")),
                 "int8": ("int8_t_splitk", ("t_splitk_mma_kernel", "Int8TView"))}


def short_parity(torch, cfg, quant, trainable, frozen, ids, labels):
    """The loss and grads of a 16-token sample through the kernels (the
    split-K backward kernels, PER_STEP launches, no t_gemv) against the
    plain path from the same state: (|Δloss| / |loss|, max |Δgrad| / max
    |grad|) and the kernel run's launch counts."""
    from chatglm_q_tpu_torch import TorchRuntimeConfig, ops
    from chatglm_q_tpu_torch.utils.train import loss_and_grads

    name = SHORT_KERNELS[quant][0]
    t_gemv = name.replace("_splitk", "_gemv")
    ops.reset_launch_counts()
    kern = loss_and_grads(cfg, quant, trainable, frozen, ids, labels, torch.bfloat16,
                          TorchRuntimeConfig())
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    require(counts[name] == PER_STEP and counts[t_gemv] == 0,
            f"{quant} 16-token grads: {counts[name]} {name} launches, {counts[t_gemv]} {t_gemv}")
    plain = loss_and_grads(cfg, quant, trainable, frozen, ids, labels, torch.bfloat16,
                           TorchRuntimeConfig(use_kernels=False))
    for lo, gr in (kern, plain):
        require(math.isfinite(lo.item()) and all(torch.isfinite(g).all() for g in gr),
                f"{quant} 16-token grads: non-finite loss or grads")
    return grad_rel(torch, kern, plain), counts


def short_step(torch, smi, cfg, quant, trainable, frozen, ids, labels, add):
    """Phase 7's 16-token step (labels past the ignored head; M = 16 rows
    take the split-K backward kernels): its loss and grads against the
    plain path within SHORT_LOSS_TOL / SHORT_GRAD_TOL (``short_parity``), then
    SHORT_STEPS calls of the training step with capturable AdamW (eager,
    captured, replayed), each with PER_STEP split-K launches and no t_gemv,
    and one more replay traced: its device ms by kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile

    from chatglm_q_tpu_torch import TorchRuntimeConfig, ops
    from chatglm_q_tpu_torch.utils import graphs as G
    from chatglm_q_tpu_torch.utils.train import make_train_step, merge_params, trainable_leaves

    name, subs = SHORT_KERNELS[quant]
    opt = torch.optim.AdamW(trainable_leaves(trainable), lr=1e-3, weight_decay=0.0,
                            capturable=True)
    step = make_train_step(cfg, quant, opt, torch.bfloat16, TorchRuntimeConfig())
    t_gemv = name.replace("_splitk", "_gemv")
    (dl, dg), counts = short_parity(torch, cfg, quant, trainable, frozen, ids, labels)
    add(counts)
    log(f"  {quant} 16-token grads through the kernels vs the plain path: |Δloss|/|loss| "
        f"{dl:.3e}, grads {dg:.3e} (limits {SHORT_LOSS_TOL:.1e}, {SHORT_GRAD_TOL:.1e}); "
        f"{counts[name]} {name} launches")
    require(dl <= SHORT_LOSS_TOL and dg <= SHORT_GRAD_TOL,
            f"{quant} 16-token step: kernel vs plain path loss {dl}, grads {dg}")
    res = {"vs_plain": {"loss": dl, "grads": dg}, "losses": [], "ms": []}
    for i in range(SHORT_STEPS):
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = step(trainable, frozen, ids, labels).item()
        torch.cuda.synchronize()
        res["ms"].append((time.perf_counter() - t0) * 1e3)
        res["losses"].append(loss)
        c = ops.launch_counts()
        add(c)
        require(math.isfinite(loss) and loss > 0 and c[name] == PER_STEP and c[t_gemv] == 0,
                f"{quant} 16-token step {i + 1}: loss {loss}, {c[name]} {name}, "
                f"{c[t_gemv]} {t_gemv} launches")
    reg = G.programs(merge_params(trainable, frozen), "train")
    prog = next(p for k, p in reg._programs.items() if k[:3] == ("train_step", id(opt),
                                                                  tuple(ids.shape)))
    require(prog.graph is not None and prog.replays == SHORT_STEPS - 1,
            f"{quant} 16-token step: {prog.replays} replays from a graph")
    torch.cuda.synchronize()
    for _ in range(TRACE_TRIES):  # a replay, traced
        with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            step(trainable, frozen, ids, labels)
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
        hit = [e for e in events if all(k in e.key for k in subs)]
        if sum(e.count for e in hit) == PER_STEP:
            break
        log(f"    the trace of a replayed {quant} 16-token step holds "
            f"{sum(e.count for e in hit)} {name} launches, not {PER_STEP}: traced again")
    require(sum(e.count for e in hit) == PER_STEP,
            f"a traced {quant} 16-token step ran {sum(e.count for e in hit)} {name} launches")
    events.sort(key=lambda e: -e.self_device_time_total)
    dev_ms = sum(e.self_device_time_total for e in events) / 1e3
    k_ms = sum(e.self_device_time_total for e in hit) / 1e3
    res.update({"device_ms": dev_ms, "t_splitk_ms": k_ms,
                "top_ms": [(e.key[:80], round(e.self_device_time_total / 1e3, 4), e.count)
                           for e in events[:10]]})
    log(f"  {quant} 16-token step (1 x 16 tokens): losses {res['losses']}; ms a step eager "
        f"{res['ms'][0]:.1f}, capture {res['ms'][1]:.1f}, replays "
        + ", ".join(f"{x:.2f}" for x in res["ms"][2:])
        + f"; a traced replay's device time {dev_ms:.3f} ms, {name} {k_ms:.3f} ms in "
        f"{PER_STEP} launches ({100 * k_ms / dev_ms:.1f}%)  [{smi}]")
    for key, ms, n in res["top_ms"]:
        log(f"    {ms:9.4f} ms  x{n:<5d} {key}")
    return res


def short_survey(torch, smi, seeds):
    """``--short-seeds``: the 16-token grads of a 28-layer tree in int4g32
    and int8 through the kernels against the plain path (``short_parity``)
    at each seed, the readings behind phase 7's limits."""
    from chatglm_q_tpu_torch import ChatGLM2Config
    from chatglm_q_tpu_torch.bench import random_quantized_params
    from chatglm_q_tpu_torch.utils.train import partition_params

    cfg = ChatGLM2Config()
    out = {}
    for quant in ("int4g32", "int8"):
        for seed in seeds:
            gen = torch.Generator(device="cuda").manual_seed(seed)
            trainable, frozen = partition_params(random_quantized_params(cfg, quant, gen))
            ids = torch.randint(0, cfg.vocab_size, (1, 16), device="cuda", generator=gen)
            (dl, dg), _ = short_parity(torch, cfg, quant, trainable, frozen, ids, ids.clone())
            out[f"{quant} seed {seed}"] = {"loss": dl, "grads": dg}
            log(f"  {quant} seed {seed}: 16-token grads, kernels vs plain: |Δloss|/|loss| "
                f"{dl:.3e}, grads {dg:.3e}  [{smi}]")
            del trainable, frozen
            torch.cuda.empty_cache()
    log("detail: " + json.dumps({"card": smi, "short_step_readings": out}))
    return 0


def train_turns(torch, smi, cfg, quant, start, frozen, ids, labels):
    """The training step as a program captured on its second call
    (``make_train_step`` on CUDA) against the same program run eagerly
    (``cuda_graphs=False``), from copies of ``start`` with capturable AdamW
    (lr 1e-3) in both, the steps in turns (eager, captured): every step's
    loss bit-equal, and every trainable leaf after the last; ms a step by
    step (the captured run's first is the eager warm-up, its second the
    capture) and the peak device memory of each run's steps."""
    from chatglm_q_tpu_torch import TorchRuntimeConfig
    from chatglm_q_tpu_torch.utils import graphs as G
    from chatglm_q_tpu_torch.utils.train import make_train_step, merge_params, trainable_leaves

    bf16 = torch.bfloat16
    runs = {}
    for kind, r_t in (("eager", TorchRuntimeConfig(cuda_graphs=False)),
                      ("captured", TorchRuntimeConfig())):
        tr = map_tree(start, lambda t: None if t is None else
                      t.detach().clone().requires_grad_(True))
        opt = torch.optim.AdamW(trainable_leaves(tr), lr=1e-3, weight_decay=0.0, capturable=True)
        runs[kind] = {"tr": tr, "step": make_train_step(cfg, quant, opt, bf16, r_t),
                      "losses": [], "ms": [], "peak": 0}
    for i in range(CAPTURED_TRAIN_STEPS):
        for kind in ("eager", "captured"):
            r = runs[kind]
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            loss = r["step"](r["tr"], frozen, ids, labels).item()
            torch.cuda.synchronize()
            r["ms"].append((time.perf_counter() - t0) * 1e3)
            r["losses"].append(loss)
            r["peak"] = max(r["peak"], torch.cuda.max_memory_allocated())
    le, lc = runs["eager"]["losses"], runs["captured"]["losses"]
    require(le == lc, f"{quant}: the captured training step's losses {lc} differ from the "
                      f"eager ones {le}")
    for a, b in zip(trainable_leaves(runs["eager"]["tr"]),
                    trainable_leaves(runs["captured"]["tr"])):
        require(torch.equal(a.detach(), b.detach()),
                f"{quant}: a trainable leaf differs after the captured steps")
    reg = G.programs(merge_params(runs["captured"]["tr"], frozen), "train")
    prog = next(p for p in reg._programs.values() if p.name == "train_step" and p.capture)
    require(prog.graph is not None and prog.replays == CAPTURED_TRAIN_STEPS - 1,
            f"{quant}: the training step replayed {prog.replays} times from a graph")
    res = {k: {"losses": r["losses"], "ms": r["ms"], "peak_mem_bytes": r["peak"]}
           for k, r in runs.items()}
    log(f"  {quant} training step captured against eager (capturable AdamW, "
        f"{CAPTURED_TRAIN_STEPS} steps in turns): losses bit-equal {lc}; ms a step eager "
        + ", ".join(f"{x:.1f}" for x in runs["eager"]["ms"]) + "; captured (warm-up, capture, "
        "replays) " + ", ".join(f"{x:.1f}" for x in runs["captured"]["ms"])
        + f"; peak memory eager {runs['eager']['peak'] / 2**30:.2f} GiB, captured "
        f"{runs['captured']['peak'] / 2**30:.2f} GiB  [{smi}]")
    return res


# Phase 7's float16 fine-tuning: the loss and grads of the kernel
# path against the plain path in f16 (the f32 masters cast to f16, the
# frozen leaves as a float16 checkpoint loads them), |Δloss| / |loss| and
# the largest over leaves of max|Δgrad| / max|grad|, each 1.5x the largest
# reading of ``--f16-train-seeds 41,71,72,73,74,75`` (28 layers; an H100 80GB HBM3 at
# 700 W), at 2 x 512 tokens (the Hopper B13 / B14) and 1 x 16 (the split-K
# ones), per quantization.  Without loss scaling (JAX's numerics too) most
# of an f16 step's gradients are f16 subnormals, and int8's fold of the
# scale into g, f16(g · f16(s)), flushes most of the lm_head's to 0: at 16
# tokens what remains is a few subnormal steps, so two correct forwards one
# f16 ulp apart move int8's norm grads by 0.7-1.1 of their max (the full
# path's reading is then no check of the kernels).  So each case is also
# held with the forward fixed (``F16_BWD_TOL``): the kernel path's grads
# against the same forward with the plain backward (B13 / B14's plain
# versions), which isolates the backward kernels.
# Readings (largest over seeds 41 and 71-75): the full path, loss / grads,
# int4g32 1.14e-5 / 4.26e-2 (2 x 512) and 1.67e-4 / 4.96e-3 (1 x 16), int8
# 1.32e-5 / 3.45e-3 and 7.11e-5 / 1.08; the backward alone, the loss 0 (the
# same forward), the grads int4g32 4.18e-2 and 3.22e-3 (B14's f16 outputs
# one ulp apart, carried through subnormal gradients), int8 0 (B13's outputs
# took the plain backward's bits on every seed): its limit is one f16
# rounding, 2^-11 of max|grad|, where 1.5x a zero reading would be none.
F16_TRAIN_TOL = {("int4g32", "2x512"): (1.7e-5, 6.4e-2), ("int8", "2x512"): (2.0e-5, 5.2e-3),
                 ("int4g32", "1x16"): (2.5e-4, 7.4e-3), ("int8", "1x16"): (1.1e-4, 1.62)}
F16_BWD_TOL = {("int4g32", "2x512"): (0.0, 6.3e-2), ("int8", "2x512"): (0.0, 2.0 ** -11),
               ("int4g32", "1x16"): (0.0, 4.8e-3), ("int8", "1x16"): (0.0, 2.0 ** -11)}
F16_TRAIN_STEPS = 3  # a step program's eager warm-up, its capture, one replay


def f16_parity(torch, cfg, quant, trainable, frozen, ids, labels):
    """The f16 loss and grads of ``ids`` through the kernels (B13 / B14 in
    f16: PER_STEP launches of the route's kernel, counted in its f16 form)
    against the plain path from the same state, and against the kernels'
    forward with the plain backward (``ops/linear.py``'s transposed wrapper
    swapped for its plain version: the backward kernels alone): two
    (|Δloss| / |loss|, max |Δgrad| / max |grad|) readings, and the kernel
    run's launch counts."""
    from chatglm_q_tpu_torch import TorchRuntimeConfig, ops
    from chatglm_q_tpu_torch.ops import linear as L
    from chatglm_q_tpu_torch.ops import quant_matmul as QM
    from chatglm_q_tpu_torch.utils.train import loss_and_grads

    f16 = torch.float16
    M, N = ids.numel(), cfg.hidden_size
    name = ("int8_t_" if quant == "int8" else "int4g32_t_") + QM.t_route(M, N, f16)
    ops.reset_launch_counts()
    kern = loss_and_grads(cfg, quant, trainable, frozen, ids, labels, f16, TorchRuntimeConfig())
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    require(counts[name + "_f16"] == counts[name] == PER_STEP,
            f"{quant} f16 grads ({tuple(ids.shape)}): {counts[name]} {name} launches, "
            f"{counts[name + '_f16']} in f16")
    plain = loss_and_grads(cfg, quant, trainable, frozen, ids, labels, f16,
                           TorchRuntimeConfig(use_kernels=False))
    attr = "int8_matmul_t" if quant == "int8" else "int4g32_matmul_t"
    wrapper = getattr(L, attr)
    setattr(L, attr, getattr(L, attr + "_plain"))
    try:
        bwd_plain = loss_and_grads(cfg, quant, trainable, frozen, ids, labels, f16,
                                   TorchRuntimeConfig())
    finally:
        setattr(L, attr, wrapper)
    for lo, gr in (kern, plain, bwd_plain):
        require(math.isfinite(lo.item()) and all(torch.isfinite(g).all() for g in gr),
                f"{quant} f16 grads: non-finite loss or grads")
    return grad_rel(torch, kern, plain), grad_rel(torch, kern, bwd_plain), counts


def f16_fine_tune(torch, smi, cfg, quant, start, frozen, ids, labels, add):
    """Phase 7 in float16 (``make_train_step(dtype=torch.float16)``) from
    ``start`` over ``frozen`` cast as a float16 checkpoint loads it: at 2 x
    512 tokens (the Hopper B13 / B14 in f16) and at 1 x 16 (the split-K
    ones), the loss and grads against the plain path within F16_TRAIN_TOL
    and against the plain backward within F16_BWD_TOL (``f16_parity``), then
    F16_TRAIN_STEPS steps of the step program
    captured against the same steps eager (capturable AdamW), in turns: the
    losses bit-equal, every trainable leaf after them."""
    from chatglm_q_tpu_torch import TorchRuntimeConfig, ops
    from chatglm_q_tpu_torch.utils.train import make_train_step, trainable_leaves

    f16 = torch.float16
    fr16 = f16_tree(torch, frozen)
    res = {}
    for label, ii, ll in (("2x512", ids, labels),
                          ("1x16", ids[:1, FT_IGNORED:FT_IGNORED + 16],
                           labels[:1, FT_IGNORED:FT_IGNORED + 16])):
        (dl, dg), (bl, bg), counts = f16_parity(torch, cfg, quant, start, fr16, ii, ll)
        add(counts)
        tols, btols = F16_TRAIN_TOL[(quant, label)], F16_BWD_TOL[(quant, label)]
        require(dl <= tols[0] and dg <= tols[1] and bl <= btols[0] and bg <= btols[1],
                f"{quant} f16 {label}: kernel vs plain path loss {dl}, grads {dg}; against "
                f"the plain backward loss {bl}, grads {bg}")
        runs = {}
        for kind, r_t in (("eager", TorchRuntimeConfig(cuda_graphs=False)),
                          ("captured", TorchRuntimeConfig())):
            tr = map_tree(start, lambda t: None if t is None else
                          t.detach().clone().requires_grad_(True))
            opt = torch.optim.AdamW(trainable_leaves(tr), lr=1e-3, weight_decay=0.0,
                                    capturable=True)
            runs[kind] = {"tr": tr, "step": make_train_step(cfg, quant, opt, f16, r_t),
                          "losses": [], "ms": []}
        ops.reset_launch_counts()
        for _ in range(F16_TRAIN_STEPS):
            for kind in ("eager", "captured"):
                r = runs[kind]
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                r["losses"].append(r["step"](r["tr"], fr16, ii, ll).item())
                torch.cuda.synchronize()
                r["ms"].append((time.perf_counter() - t0) * 1e3)
        add(ops.launch_counts())
        le, lc = runs["eager"]["losses"], runs["captured"]["losses"]
        require(le == lc and all(math.isfinite(x) for x in le),
                f"{quant} f16 {label}: captured losses {lc}, eager {le}")
        for a_, b_ in zip(trainable_leaves(runs["eager"]["tr"]),
                          trainable_leaves(runs["captured"]["tr"])):
            require(torch.equal(a_.detach(), b_.detach()),
                    f"{quant} f16 {label}: a trainable leaf differs after the captured steps")
        res[label] = {"vs_plain": {"loss": dl, "grads": dg},
                      "vs_plain_backward": {"loss": bl, "grads": bg}, "losses": lc,
                      "ms": {k: r["ms"] for k, r in runs.items()}}
        log(f"  {quant} f16 {label}: kernels vs plain path |Δloss|/|loss| {dl:.3e}, grads "
            f"{dg:.3e} (limits {tols[0]:.1e}, {tols[1]:.1e}); against the plain backward "
            f"{bl:.3e}, {bg:.3e} (limits {btols[0]:.1e}, {btols[1]:.1e}); captured = eager over "
            f"{F16_TRAIN_STEPS} steps, losses {lc}; ms a step eager "
            + ", ".join(f"{x:.1f}" for x in runs["eager"]["ms"]) + "; captured "
            + ", ".join(f"{x:.1f}" for x in runs["captured"]["ms"]) + f"  [{smi}]")
        del runs
    return res


def f16_train_survey(torch, smi, seeds):
    """``--f16-train-seeds``: the f16 loss and grads of a 28-layer tree in
    int4g32 and int8 through the kernels against the plain path
    (``f16_parity``) at 2 x 512 and 1 x 16 tokens per seed, the readings
    behind the F16_TRAIN_TOL / F16_BWD_TOL limits."""
    from chatglm_q_tpu_torch import ChatGLM2Config
    from chatglm_q_tpu_torch.bench import random_quantized_params
    from chatglm_q_tpu_torch.utils.train import partition_params

    cfg = ChatGLM2Config()
    out = {}
    for quant in ("int4g32", "int8"):
        for seed in seeds:
            gen = torch.Generator(device="cuda").manual_seed(seed)
            trainable, frozen = partition_params(random_quantized_params(cfg, quant, gen))
            frozen = f16_tree(torch, frozen)
            ids = torch.randint(0, cfg.vocab_size, (FT_BATCH, FT_SEQ), device="cuda",
                                generator=gen)
            labels = ids.clone()
            labels[:, :FT_IGNORED] = -100
            for label, ii, ll in (("2x512", ids, labels),
                                  ("1x16", ids[:1, FT_IGNORED:FT_IGNORED + 16],
                                   labels[:1, FT_IGNORED:FT_IGNORED + 16])):
                (dl, dg), (bl, bg), _ = f16_parity(torch, cfg, quant, trainable, frozen, ii,
                                                   ll)
                out[f"{quant} {label} seed {seed}"] = {"loss": dl, "grads": dg,
                                                       "bwd_loss": bl, "bwd_grads": bg}
                log(f"  {quant} {label} seed {seed}: f16 grads, kernels vs plain: "
                    f"|Δloss|/|loss| {dl:.3e}, grads {dg:.3e}; vs the plain backward "
                    f"{bl:.3e}, {bg:.3e}  [{smi}]")
            del trainable, frozen
            torch.cuda.empty_cache()
    log("detail: " + json.dumps({"card": smi, "f16_train_readings": out}))
    return 0


# the Hopper matmuls of a training step, by quantization: (ID, substrings of
# the profiler's kernel name)
TRAIN_KERNELS = {
    "int4g32": (("B1 int4_wgmma_kernel", ("int4_wgmma_kernel",)),
                ("B14 t_wgmma_kernel<Int4TView>", ("t_wgmma_kernel", "Int4TView"))),
    "int8": (("B6 int8_wgmma_kernel", ("int8_wgmma_kernel",)),
             ("B13 t_wgmma_kernel<Int8TView>", ("t_wgmma_kernel", "Int8TView"))),
}


def profile_train_step(torch, step, trainable, frozen, ids, labels, untraced_ms, quant):
    """One more training step under torch.profiler: device time by kernel,
    the device's busy share of the untraced step before it, and the forward
    and backward Hopper matmuls' device ms (PER_STEP launches each).  A trace
    short of those launches (dropped activity records) is taken again on
    the next step, up to TRACE_TRIES times, as ``trace_until`` does."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile

    torch.cuda.synchronize()
    for _ in range(TRACE_TRIES):
        with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            step(trainable, frozen, ids, labels)
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
        counts = [sum(e.count for e in events if all(k in e.key for k in subs))
                  for _, subs in TRAIN_KERNELS[quant]]
        if all(n == PER_STEP for n in counts):
            break
        log(f"    the trace of a {quant} training step holds {counts} launches of "
            f"{[label for label, _ in TRAIN_KERNELS[quant]]}, not {PER_STEP} each: traced again")
    events.sort(key=lambda e: -e.self_device_time_total)
    dev_ms = sum(e.self_device_time_total for e in events) / 1e3
    top = [(e.key[:80], round(e.self_device_time_total / 1e3, 3), e.count) for e in events[:10]]
    res = {"device_ms": dev_ms, "busy_share_untraced": dev_ms / untraced_ms, "top_ms": top,
           "kernels": {}}
    parts = []
    for label, subs in TRAIN_KERNELS[quant]:
        hit = [e for e in events if all(k in e.key for k in subs)]
        ms, n = sum(e.self_device_time_total for e in hit) / 1e3, sum(e.count for e in hit)
        require(n == PER_STEP, f"a traced {quant} step ran {n} {label} launches, not {PER_STEP}")
        res["kernels"][label] = {"ms": ms, "launches": n, "share_of_device": ms / dev_ms,
                                 "share_of_step": ms / untraced_ms}
        parts.append(f"{label} {ms:.2f} ms in {n} launches ({100 * ms / dev_ms:.1f}% of the "
                     f"device time)")
    log(f"  profile of one {quant} training step: device busy {dev_ms:.1f} ms, "
        f"{100 * dev_ms / untraced_ms:.1f}% of the untraced step ({untraced_ms:.1f} ms); "
        + "; ".join(parts))
    for name, ms, n in top:
        log(f"    {ms:9.3f} ms  x{n:<5d} {name}")
    return res


def fine_tune_slice(torch, smi):
    counts, out = {}, {}
    counts["int4g32"], out["int4g32"] = fine_tune(torch, smi, "int4g32", 4, 71)
    torch.cuda.empty_cache()
    counts["int8"], out["int8"] = fine_tune(torch, smi, "int8", 3, 72)
    torch.cuda.empty_cache()
    return counts, out


# ---------------------------------------------------------------------------
# Phase 10: the quantizers (RTN, GPTQ, the GPTQ column-sweep kernel)
# ---------------------------------------------------------------------------

QUANT_SEED = 101
QUANT_PROMPTS = 8     # calibration prompts, each cut to QUANT_TOKENS tokens
QUANT_TOKENS = 128
QUANT_BATCH = 4       # two calibration batches: the Hessians average over both
QUANT_EVAL_SEED = 7   # the perplexity texts: another draw of the synthetic corpus
QUANT_DECODE_TOKENS = 16
SWEEP_BS = 128
# The sweep kernel against its plain version (the per-column PyTorch loop)
# on the same factor of the same Hessian, per linear: the fraction of
# integer grid points apart, max |Δscale| (int4) and |Δ mean loss| / mean
# loss.  The kernel rounds each operation as PyTorch does (no FMA), so the
# limits are 0: bit-equal.  The control (the sweep without its in-block
# error feedback) must exceed them.
SWEEP_GRID_TOL = 0.0
SWEEP_SCALE_TOL = 0.0
SWEEP_LOSS_TOL = 0.0


def quant_batches(torch, tokenizer, seed, n=QUANT_PROMPTS):
    """``n`` texts of the port's synthetic corpus, each at most QUANT_TOKENS
    tokens, left padded in batches of QUANT_BATCH: [(ids, mask)]."""
    from chatglm_q_tpu_torch.examples.data import synthetic_texts

    texts = synthetic_texts(n, seed)
    out = []
    for i in range(0, n, QUANT_BATCH):
        enc = tokenizer(texts[i:i + QUANT_BATCH], padding=True, max_length=QUANT_TOKENS,
                        return_tensors="pt")
        out.append((enc["input_ids"].cuda(), enc["attention_mask"].cuda()))
    return texts, out


def quant_hessians(torch, params, cfg, batches):
    """The Hessians of layer 0's taps and of the final_ln's output over the
    calibration batches (embedded through the float table, where
    quant/calibrate.py takes the quantized one): {tap: (H, seconds of
    accumulation)}."""
    from chatglm_q_tpu_torch import TorchRuntimeConfig
    from chatglm_q_tpu_torch.models import chatglm2 as M
    from chatglm_q_tpu_torch.quant import gptq as G

    rt, hs, acc_s = TorchRuntimeConfig(), {}, {}
    prepared = []
    for ids, mask in batches:
        bias, pos = M.build_parity_mask_and_positions(mask, ids.shape[1])
        h = params["word_embedding"]["weight"][ids].float()
        prepared.append((h, M._serving_freqs(cfg, pos, torch.float32), bias[:, None, None]))
    with torch.no_grad():
        for layer in range(cfg.num_layers):
            lp = M._layer(params["layers"], layer)
            nxt = []
            for h, f, m in prepared:
                out, _, taps = M.block_forward(lp, h, f, m, cfg, "none", rt, collect_taps=True)
                nxt.append((out, f, m))
                for name, x in (taps.items() if layer == 0 else ()):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    hs[name] = G.accumulate_hessian(*hs.get(name, G.init_hessian(x.shape[-1],
                                                                                 "cuda")), x)
                    torch.cuda.synchronize()
                    acc_s[name] = acc_s.get(name, 0.0) + time.perf_counter() - t0
            prepared = nxt
        for h, _, _ in prepared:
            x = M.rms_norm(h, params["final_ln"]["weight"], cfg.layernorm_epsilon)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            hs["final"] = G.accumulate_hessian(*hs.get("final", G.init_hessian(x.shape[-1],
                                                                                "cuda")), x)
            torch.cuda.synchronize()
            acc_s["final"] = acc_s.get("final", 0.0) + time.perf_counter() - t0
    return {k: (v[0], acc_s[k]) for k, v in hs.items()}


def sweep_launches(cfg):
    """One launch a 128-column block: per layer five linears at K = hidden
    and w_out at K = inner, then the lm_head."""
    blocks = lambda k: -(-k // SWEEP_BS)  # noqa: E731
    return cfg.num_layers * (5 * blocks(cfg.hidden_size) + blocks(cfg.inner_hidden_size)) \
        + blocks(cfg.hidden_size)


def sweep_without_feedback(torch):
    """The control: a block quantized column by column with the same scales
    rule and the same errors out, but no error fed to its later columns."""
    def block(w_blk, hinv_blk, scale_n, groupsize):
        w = w_blk.float()
        N, bs = w.shape
        d = hinv_blk.diagonal()
        if scale_n is None:
            sc = torch.clamp(w.reshape(N, bs // groupsize, groupsize).abs().amax(dim=2) / 7,
                             min=1e-10)
            s, qmax = sc.repeat_interleave(groupsize, dim=1), 7
        else:
            s, qmax = scale_n[:, None], 127
        qd = torch.clamp(torch.round(w / s), -qmax, qmax) * s
        err = (w - qd) / d
        loss = (w - qd) ** 2 / d ** 2
        return (qd, err, loss, sc.T.contiguous()) if scale_n is None else (qd, err, loss)
    return block


def sweep_gap(torch, got, want, int4):
    """(fraction of integer grid points apart, max |Δscale|, |Δ mean loss| /
    mean loss) of sweep ``got`` against ``want``, each (grid, losses,
    scales or None).  int8 rows share one fixed scale, so their grids
    differ exactly where their integers do."""
    (g1, l1, s1), (g2, l2, s2) = got, want
    if int4:
        q1 = torch.round(g1 / s1.repeat_interleave(32, dim=0).T)
        q2 = torch.round(g2 / s2.repeat_interleave(32, dim=0).T)
        dscale = (s1 - s2).abs().max().item()
    else:
        q1, q2, dscale = g1, g2, 0.0
    m1, m2 = l1.mean().item(), l2.mean().item()
    return (q1 != q2).float().mean().item(), dscale, abs(m1 - m2) / max(abs(m2), 1e-30)


def synced_s(torch, fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def sweep_bound_ms(N, bs, int4):
    """The least time of one block: its f32 block and factor read once, the
    three (N, bs) f32 outputs (and the int4 scales) written once; or the
    update's multiply and subtract on the N x bs(bs+1)/2 elements it
    touches (plus ~8 operations a weight for the quantization) at the
    card's f32 CUDA-core peak."""
    nbytes = 4 * (N * bs + bs * bs + 3 * N * bs + (N * bs // 32 if int4 else N))
    ops = N * bs * (bs + 1) + 8 * N * bs
    return bound_ms(nbytes, ops, PEAK_F32_FLOPS)


def check_gptq_sweep(torch, smi, params, cfg, batches):
    """Step 2 and 3: the sweep kernel against its plain version at the
    seven linears of ChatGLM2-6B, both forms, on the calibration Hessians;
    each linear's times.  Returns (rows, kernel line entries by form)."""
    from chatglm_q_tpu_torch.ops import gptq_sweep as GS
    from chatglm_q_tpu_torch.quant import gptq as G
    from chatglm_q_tpu_torch.utils.timing import cuda_event_ms

    hes = quant_hessians(torch, params, cfg, batches)
    lay = params["layers"]
    linears = [("q_proj", lay["q_proj"]["weight"][0], "qkv_in"),
               ("kv_proj", lay["kv_proj"]["weight"][0], "qkv_in"),
               ("o_proj", lay["o_proj"]["weight"][0], "o_in"),
               ("w_in_h", lay["w_in_h"]["weight"][0], "w_in_in"),
               ("w_in_gate", lay["w_in_gate"]["weight"][0], "w_in_in"),
               ("w_out", lay["w_out"]["weight"][0], "w_out_in"),
               ("lm_head", params["lm_head"]["weight"], "final")]
    control = sweep_without_feedback(torch)
    rows, entries = [], {}
    for name, w_kn, tap in linears:
        H, acc_s = hes[tap]
        w_nk = w_kn.float().T.contiguous()
        N, K = w_nk.shape
        (_, wz, U, failed), prep_s = synced_s(torch, lambda: G._prepare_hinv(H, w_nk, 0.01))
        G._check_hinv(U, failed)
        for int4 in (False, True):
            form = "int4" if int4 else "int8"
            scale = None if int4 else G._naive_scale_int8(w_nk)[1]

            def run(fn):
                return G.sweep(wz, U, scale, SWEEP_BS, 32, fn)

            kern, kern_s = synced_s(torch, lambda: run(GS.gptq_sweep_block))
            plain, plain_s = synced_s(torch, lambda: run(GS.gptq_sweep_block_plain))
            ctrl = run(control)
            gap = sweep_gap(torch, kern, plain, int4)
            cgap = sweep_gap(torch, ctrl, plain, int4)
            max_abs = (kern[0] - plain[0]).abs().max().item()
            del ctrl
            blk_w, blk_u = wz[:, :SWEEP_BS], U[:SWEEP_BS, :SWEEP_BS]
            blk_ms = cuda_event_ms(lambda i: GS.gptq_sweep_block(blk_w, blk_u, scale),
                                   iters=10, warmup=2)
            _, blk_plain_s = synced_s(torch, lambda: GS.gptq_sweep_block_plain(blk_w, blk_u,
                                                                               scale))
            b_ms, b_by = sweep_bound_ms(N, SWEEP_BS, int4)
            blocks = -(-K // SWEEP_BS)
            r = {"linear": name, "form": form, "N": N, "K": K, "blocks": blocks,
                 "grid_mismatch": gap[0], "max_abs_dscale": gap[1], "rel_dloss": gap[2],
                 "control_grid_mismatch": cgap[0], "control_max_abs_dscale": cgap[1],
                 "control_rel_dloss": cgap[2], "max_abs_err": max_abs,
                 "sweep_kernel_s": kern_s, "sweep_plain_s": plain_s, "prepare_hinv_s": prep_s,
                 "hessian_accumulate_s": acc_s, "block_ms": blk_ms,
                 "block_plain_ms": blk_plain_s * 1e3, "block_bound_ms": b_ms,
                 "block_bound_by": b_by}
            rows.append(r)
            log(f"  sweep {form} {name:9s} N={N:5d} K={K:5d}: kernel vs plain: grid points "
                f"apart {gap[0]:.3e}, max|Δscale| {gap[1]:.3e}, rel Δloss {gap[2]:.3e} "
                f"(limits {SWEEP_GRID_TOL:g} / {SWEEP_SCALE_TOL:g} / {SWEEP_LOSS_TOL:g}); "
                f"control (no in-block feedback) {cgap[0]:.3e} / {cgap[1]:.3e} / {cgap[2]:.3e}; "
                f"sweep s: kernel {kern_s:.4f}, plain loop {plain_s:.4f}; Cholesky + H^-1 "
                f"{prep_s:.4f}, Hessian accumulation {acc_s:.4f}; one {SWEEP_BS}-column block: "
                f"kernel {blk_ms:.4f} ms, plain {blk_plain_s * 1e3:.3f} ms, bound {b_ms:.4f} "
                f"({b_by})  [{smi}]")
            require(gap[0] <= SWEEP_GRID_TOL and gap[1] <= SWEEP_SCALE_TOL
                    and gap[2] <= SWEEP_LOSS_TOL,
                    f"sweep {form} {name}: kernel vs plain {gap} beyond the limits")
            require(cgap[0] > SWEEP_GRID_TOL and cgap[2] > SWEEP_LOSS_TOL,
                    f"sweep {form} {name}: the no-feedback control passes ({cgap})")
            if name == "q_proj":
                entries[form] = {"ms": blk_ms, "plain_ms": blk_plain_s * 1e3,
                                 "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": max_abs,
                                 "shape": f"N={N} block of {SWEEP_BS} columns (q_proj, K={K})"}
            del kern, plain
        del wz, U, w_nk
    del hes
    torch.cuda.empty_cache()
    # the 28-layer estimate from this run's per-linear times: per layer the
    # six linears' preparation and kernel sweeps and their Hessians, then
    # the lm_head
    by = {(r["linear"], r["form"]): r for r in rows}
    est = {}
    for form in ("int8", "int4"):
        layer_s = sum(by[(n, form)]["sweep_kernel_s"] + by[(n, form)]["prepare_hinv_s"]
                      for n in ("q_proj", "kv_proj", "o_proj", "w_in_h", "w_in_gate", "w_out"))
        layer_s += sum(by[(n, form)]["hessian_accumulate_s"]
                       for n in ("q_proj", "o_proj", "w_in_h", "w_out"))
        head = by[("lm_head", form)]
        est[form] = 28 * layer_s + head["sweep_kernel_s"] + head["prepare_hinv_s"]
        plain_layer = sum(by[(n, form)]["sweep_plain_s"] + by[(n, form)]["prepare_hinv_s"]
                          for n in ("q_proj", "kv_proj", "o_proj", "w_in_h", "w_in_gate",
                                    "w_out"))
        est[form + "_plain"] = 28 * plain_layer + head["sweep_plain_s"] + head["prepare_hinv_s"]
        log(f"  estimate for 28 layers + lm_head ({form}, sweeps and Cholesky, {QUANT_PROMPTS} "
            f"prompts): kernel {est[form]:.1f} s, plain loop {est[form + '_plain']:.1f} s  "
            f"[{smi}]")
    return rows, entries, est


def storage_rounded(torch, t):
    """A float leaf as a float16 checkpoint stores it, read back in the
    loader's dtype for it (integers as they are)."""
    return t.to(torch.float16) if t.is_floating_point() else t


def quant_slice(torch, smi):
    """Phase 10 (the quantizers) at 6B widths, depth 2, on a random float32
    tree built on the card.  Returns (launch counts by form, perf, kernel
    line entries by form)."""
    import tempfile

    from chatglm_q_tpu_torch import ChatGLM2Config, GLMLoadConfig, TorchRuntimeConfig, ops
    from chatglm_q_tpu_torch.examples.ppl import perplexity
    from chatglm_q_tpu_torch.loader import load_model_and_tokenizer, save_model_and_tokenizer
    from chatglm_q_tpu_torch.models import chatglm2 as M
    from chatglm_q_tpu_torch.ops import _build
    from chatglm_q_tpu_torch.quant import gptq_quantize_model, rtn_quantize_model
    from chatglm_q_tpu_torch.serving import GLMDecoder, chat_template

    cfg = ChatGLM2Config(num_layers=2)
    gen = torch.Generator(device="cuda").manual_seed(QUANT_SEED)
    (params, build_s) = synced_s(torch, lambda: M.init_params(gen, cfg, "none", torch.float32))
    tokenizer = chat_tokenizer()
    texts, batches = quant_batches(torch, tokenizer, 42)
    n_tok = sum(int(m.sum()) for _, m in batches)
    log(f"  float32 ChatGLM2-6B widths, 2 layers, init_params on the card in {build_s:.1f} s; "
        f"calibration: {len(texts)} synthetic prompts, {n_tok} tokens in {len(batches)} batches")

    rows, entries, est = check_gptq_sweep(torch, smi, params, cfg, batches)

    # 4. the whole model, GPTQ (kernel path) and RTN, per linear MSE
    trees, counts, stats, perf = {}, {}, {}, {"sweep_rows": rows, "estimate_28_layers_s": est}
    for quant in ("int8", "int4g32"):
        st = {}
        ops.reset_launch_counts()
        trees[f"gptq {quant}"], s = synced_s(
            torch, lambda: gptq_quantize_model(params, cfg, batches, quant, stats=st))
        counts[quant] = ops.launch_counts()
        trees[f"rtn {quant}"], rtn_s = synced_s(torch, lambda: rtn_quantize_model(params, cfg,
                                                                                  quant))
        stats[quant] = st
        form = "gptq_sweep_int8" if quant == "int8" else "gptq_sweep_int4"
        want = sweep_launches(cfg)
        require(counts[quant][form] == want,
                f"gptq {quant}: {counts[quant][form]} sweep launches, {want} expected "
                f"(one a 128-column block)")
        worse = [t for t, v in st.items() if not v["debug_mse"] < v["rtn_debug_mse"]]
        require(len(st) == 13 and not worse, f"gptq {quant}: MSE not below RTN's at {worse}")
        ratio = max(v["debug_mse"] / v["rtn_debug_mse"] for v in st.values())
        perf[f"gptq {quant}"] = {"seconds": s, "rtn_seconds": rtn_s, "sweep_launches":
                                 counts[quant][form], "per_linear": st}
        log(f"  gptq_quantize_model {quant}: {s:.2f} s, {counts[quant][form]} sweep launches "
            f"(one a 128-column block); rtn_quantize_model {rtn_s:.2f} s; GPTQ's output MSE on "
            f"the last batch's activations below RTN's at all 13 linears, at most "
            f"{ratio:.3f} of it  [{smi}]")
        for tag, v in st.items():
            log(f"    {tag}: quant_loss {v['quant_loss']:.4e}, MSE gptq {v['debug_mse']:.4e} "
                f"rtn {v['rtn_debug_mse']:.4e}")

    # 5. save / load, and the ppl protocol through the kernel and plain paths
    eval_texts, _ = quant_batches(torch, tokenizer, QUANT_EVAL_SEED)
    kernel_rt, plain_rt = TorchRuntimeConfig(), TorchRuntimeConfig(use_kernels=False)
    bf16 = torch.bfloat16
    enc = tokenizer(eval_texts, padding=True, return_tensors="pt")
    ids, mask = enc["input_ids"].cuda(), enc["attention_mask"].cuda()
    loaded = {"float": (GLMLoadConfig(model_config=cfg, torch_dtype="float32"), params)}
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    for name, tree in trees.items():
        quant = name.split()[1]
        lc = GLMLoadConfig(model_config=cfg, quant_type=quant, torch_dtype="float16")
        with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
            _, save_s = synced_s(torch, lambda: save_model_and_tokenizer(tmp, lc, tree, tokenizer))
            (lcfg, back, _), load_s = synced_s(torch, lambda: load_model_and_tokenizer(
                tmp, "bfloat16"))
        a, b = dict(tree_leaves(tree)), dict(tree_leaves(back))
        require(a.keys() == b.keys(), f"{name}: keys differ after the round trip")
        for k in a:
            want_t = storage_rounded(torch, a[k]).to(b[k].dtype)
            require(b[k].shape == a[k].shape and torch.equal(b[k], want_t),
                    f"{name}: {k} differs after the round trip")
        log(f"  {name}: saved (float16 checkpoint) in {save_s:.1f} s and loaded in {load_s:.1f} "
            f"s: {len(a)} tensors, each the tree's value as float16 stores it")
        loaded[name] = (lcfg, back)
    ppls = {}
    for name, (lcfg, tree) in loaded.items():
        quant = lcfg.quant_type
        got = {}
        for path, rt in (("kernel", kernel_rt), ("plain", plain_rt)):
            ops.reset_launch_counts()
            with torch.no_grad():
                got[path] = M.forward(tree, cfg, ids, attention_mask=mask, quant_type=quant,
                                      dtype=bf16, rt=rt)[1]
            if path == "kernel" and quant != "none":
                c = ops.launch_counts()
                mm = ("int8_mma", "int8_splitk") if quant == "int8" else ("int4g32_mma",
                                                                          "int4g32_splitk")
                require(sum(c[k] for k in mm) > 0, f"{name}: the kernel forward launched "
                                                   f"none of {mm}")
            got[path + "_ppl"] = perplexity(tree, lcfg, tokenizer, eval_texts, 20, bf16, rt)
        require(torch.isfinite(got["kernel"]).all(), f"{name}: non-finite logits")
        err = rel_err(got["kernel"], got["plain"])[1]
        require(err <= E2E_TOL, f"{name}: kernel vs plain logits {err} > {E2E_TOL}")
        require(math.isfinite(got["kernel_ppl"]), f"{name}: ppl {got['kernel_ppl']}")
        ppls[name] = {"kernel": got["kernel_ppl"], "plain": got["plain_ppl"],
                      "logits_rel_err": err}
        log(f"  ppl ({len(eval_texts)} synthetic texts, batch 20, left padded) {name}: kernel "
            f"path {got['kernel_ppl']:.4f}, plain path {got['plain_ppl']:.4f}; logits kernel vs "
            f"plain {err:.3e} (limit {E2E_TOL:.1e})")
    perf["ppl"] = ppls

    # 6. the GPTQ int4g32 checkpoint decodes through the captured GLMDecoder
    lcfg, tree = loaded["gptq int4g32"]
    prompt = chat_template([], CHAT_QUESTION)
    texts_out = {}
    for label, rt in (("captured", kernel_rt), ("eager", TorchRuntimeConfig(cuda_graphs=False))):
        dec = GLMDecoder(lcfg, tree, tokenizer, max_sequence_length=CACHE_LEN, rt=rt, dtype=bf16)
        final = None
        for final in dec.generate(prompt, max_generated_tokens=QUANT_DECODE_TOKENS,
                                  temperature=0.0):
            pass
        texts_out[label] = final
        if label == "captured":
            step = M.decode_program(tree, lcfg.model_config, dec._free_caches[0][0], "int4g32",
                                    bf16, rt)
            require(step.graph is not None and step.replays >= QUANT_DECODE_TOKENS - 3,
                    f"the GPTQ decoder's step was not replayed from a graph ({step.replays})")
    require(texts_out["captured"] == texts_out["eager"],
            f"GPTQ int4g32: captured text {texts_out['captured'][:60]!r} differs from the eager "
            f"one {texts_out['eager'][:60]!r}")
    log(f"  GPTQ int4g32 checkpoint through GLMDecoder: {QUANT_DECODE_TOKENS} greedy tokens "
        f"from a captured decode step, the eager decoder's text: {texts_out['captured'][:60]!r}")
    perf["decode_text"] = texts_out["captured"]
    del trees, loaded, params
    torch.cuda.empty_cache()
    return counts, perf, entries


def quant_28_layers(torch, smi):
    """``--quant``: GPTQ int4g32 of a random float32 ChatGLM2-6B (28 layers)
    on the card, the offline cost of quantizing the model: wall seconds."""
    from chatglm_q_tpu_torch import ChatGLM2Config, ops
    from chatglm_q_tpu_torch.models import chatglm2 as M
    from chatglm_q_tpu_torch.quant import gptq_quantize_model

    cfg = ChatGLM2Config()
    gen = torch.Generator(device="cuda").manual_seed(QUANT_SEED)
    params, build_s = synced_s(torch, lambda: M.init_params(gen, cfg, "none", torch.float32))
    _, batches = quant_batches(torch, chat_tokenizer(), 42)
    ops.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    tree, s = synced_s(torch, lambda: gptq_quantize_model(params, cfg, batches, "int4g32"))
    launches = ops.launch_counts()["gptq_sweep_int4"]
    peak = torch.cuda.max_memory_allocated() / 1e9
    require(launches == sweep_launches(cfg), f"{launches} sweep launches")
    require(torch.isfinite(tree["layers"]["w_out"]["weight_scale"].float()).all(),
            "non-finite scales")
    log(f"  GPTQ int4g32 of ChatGLM2-6B (28 layers, float32 random weights built in "
        f"{build_s:.1f} s), {QUANT_PROMPTS} calibration prompts: {s:.1f} s, {launches} sweep "
        f"launches, peak device memory {peak:.1f} GB  [{smi}]")
    return {"seconds": s, "sweep_launches": launches, "peak_gb": peak, "build_s": build_s}


# ---------------------------------------------------------------------------
# Phase 2 (tp = 2 shard shapes) and phase 11: training across ranks
# ---------------------------------------------------------------------------

# Phase 11's training step (2 x 256 tokens) on a (1, 2) mesh gives B1 and B6
# (forward) and B13 and B14 (backward) these shapes on each rank at 6B
# widths: q_proj's columns, o_proj's storage rows, w_in's columns on rank 0
# and on rank 1 (the split ends where the logical 13696 columns do: 6912 and
# 6784), w_out's storage rows (rank 1's end in the 128 rows of storage
# padding, over zero activation columns) and the lm_head's columns
TP2_SHAPES = [("q_proj rank", 4096, 2048), ("o_proj rank", 2048, 4096),
              ("w_in rank 0", 4096, 6912), ("w_in rank 1", 4096, 6784),
              ("w_out rank 1", 6912, 4096), ("lm_head rank", 4096, 32768)]
TP2_M = 512
TP2_PAD = {"w_out rank 1": 128}  # storage rows of padding at the end of the shard's K


def check_shard_matmuls(torch):
    """Phase 2 at the tp = 2 shard shapes (TP2_SHAPES, M = TP2_M bf16): B1
    (``int4g32_matmul``) and B6 (``int8_matmul``) forward, B14
    (``int4g32_matmul_t``) and B13 (``int8_matmul_t``) backward, each one
    launch of its Hopper kernel, within KERNEL_TOL of its plain version and
    within SUM_TOL of its exact value beyond its bf16 rounding; ms, plain
    ms, bound and library ms (tinygemm for B1, ``_weight_int8pack_mm`` for
    B6 and B13, timed over 3 calls: 9-150 ms each at M = 512; none for
    B14)."""
    from chatglm_q_tpu_torch.ops import int8_matmul as I8
    from chatglm_q_tpu_torch.ops import quant_matmul as QM
    from chatglm_q_tpu_torch.ops.quant import unpack_int4_tpu
    from chatglm_q_tpu_torch.utils.timing import cuda_event_ms

    gen = torch.Generator(device="cuda").manual_seed(16)
    M, bf16, rows = TP2_M, torch.bfloat16, []

    def row(label, wrapper, name, K, N, wbytes, call, plain, exact, lib, plan):
        before = wrapper.launches
        got = call(0)
        torch.cuda.synchronize()
        require(wrapper.launches == before + 1, f"{label} {name}: not one {wrapper.__name__}")
        want = plain()
        err, rel = rel_err(got, want)
        require(bool(torch.isfinite(got).all()) and rel <= KERNEL_TOL,
                f"{label} {name}: rel err {rel} > {KERNEL_TOL} (or non-finite)")
        beyond = hold_sum(torch, f"{label} {name}", got, *exact())
        n_in, n_out = (K, N) if got.shape[1] == N else (N, K)
        b, by = bound_ms(2 * M * n_in + wbytes + 2 * M * n_out, 2.0 * M * K * N)
        r = {"kernel": wrapper.__name__, "linear": name, "M": M, "K": K, "N": N,
             "max_abs_err": err, "rel_err": rel, "ms": cuda_event_ms(call, iters=30),
             "plain_ms": cuda_event_ms(lambda i: plain(), iters=3, warmup=1), "bound_ms": b,
             "bound_by": by, "library_ms": lib(want), "beyond_sum": beyond, "plan": plan}
        if got.shape[1] == K:
            r["dtype"] = "bfloat16"  # a backward matmul: g (M, N) -> (M, K)
        rows.append(r)
        log_row(label, r)
        log(f"    plan (bm, nsplit, per split, blocks) {plan}; beyond the bf16 rounding "
            f"{beyond:.2e} of sum|terms|")

    for name, K, N in TP2_SHAPES:
        pad = TP2_PAD.get(name, 0)
        x = torch.randn((M, K), device="cuda", generator=gen).to(bf16)
        x[:, K - pad:] = 0
        g = torch.randn((M, N), device="cuda", generator=gen).to(bf16)
        wbytes = K // 2 * N + K // 32 * N * 2
        copies = weight_copies(wbytes)
        packed = torch.randint(0, 256, (copies, K // 2, N), dtype=torch.uint8, device="cuda",
                               generator=gen)
        packed[:, (K - pad) // 2:] = 0
        scale = (torch.rand((copies, K // 32, N), device="cuda", generator=gen) * 0.02).to(bf16)
        lib_w = library_weights(torch, packed, scale)
        w64 = unpack_int4_tpu(packed[0], scale[0]).double()  # q·s, exact in f32
        row("int4g32_matmul", QM.int4g32_mma, name, K, N, wbytes,
            lambda i: QM.int4g32_matmul(x, packed[i % copies], scale[i % copies]),
            lambda: QM.int4g32_matmul_plain(x, packed[0], scale[0]),
            lambda: (x.double() @ w64, x.double().abs() @ w64.abs()),
            lambda want: int4_library(torch, x, lib_w, want), QM.mma_plan(M, K, N))
        del lib_w
        w64 = unpack_int4_tpu(packed[0], scale[0]).to(bf16).double()  # bf16(q·s)
        row("int4g32_matmul_t", QM.int4g32_t_mma, name, K, N, wbytes,
            lambda i: QM.int4g32_matmul_t(g, packed[i % copies], scale[i % copies]),
            lambda: QM.int4g32_matmul_t_plain(g, packed[0], scale[0]),
            lambda: (g.double() @ w64.T, g.double().abs() @ w64.abs().T),
            lambda want: None, QM.t_mma_plan(M, K, N))
        del packed, scale, w64
        wbytes = K * N + 4 * N
        copies = weight_copies(wbytes)
        w = torch.randint(-128, 128, (copies, K, N), dtype=torch.int8, device="cuda",
                          generator=gen)
        w[:, K - pad:] = 0
        scale = (0.5 + torch.rand((copies, N), device="cuda", generator=gen)) * 0.01
        w_t, scale_bf16 = w.transpose(1, 2).contiguous(), scale.to(bf16)
        w64, s64 = w[0].double(), scale[0].double()
        row("int8_matmul", I8.int8_mma, name, K, N, wbytes,
            lambda i: I8.int8_matmul(x, w[i % copies], scale[i % copies]),
            lambda: I8.int8_matmul_plain(x, w[0], scale[0]),
            lambda: ((x.double() @ w64) * s64, (x.double().abs() @ w64.abs()) * s64),
            lambda want: int8_library(torch, x, w_t, scale_bf16, want, iters=3),
            QM.wg_plan(M, K, N))
        del w_t, scale_bf16
        gs = (g * scale[0].to(bf16)).double()  # the plain version's fold, exact
        row("int8_matmul_t", I8.int8_t_mma, name, K, N, wbytes,
            lambda i: I8.int8_matmul_t(g, w[i % copies], scale[i % copies]),
            lambda: I8.int8_matmul_t_plain(g, w[0], scale[0]),
            lambda: (gs @ w64.T, gs.abs() @ w64.abs().T),
            lambda want: int8_t_library(torch, g, w, scale, want, iters=3),
            QM.t_mma_plan(M, K, N))
        del w, scale, w64, gs
    return rows


TM_LAYERS = 4          # phase 11's depth (every width ChatGLM2-6B's)
TM_BATCH, TM_SEQ = 2, 256
TM_IGNORED = (32, 96)  # each row's first labels at -100: uneven over data ranks
TM_SEEDS = (111, 112, 113)
TM_STEPS, TM_LR = 2, 1e-3  # AdamW steps over the norms from one start
TM_MICRO = 2           # the pipeline's micro-batches
TM_QUANTS = ("int4g32", "int8")  # (a); the pipeline (b) runs the int4g32 trees
# Phase 11's limits, of a mesh rank's (a) or a stage's (b) reading against the
# single-process port on the same tree and batch: |Δloss| / |loss| (the
# first pass and the steps' losses), max over the trainable leaves of max
# |Δgrad| / max |grad|, and of Σ |Δleaf| / Σ |the reference's update| after
# TM_STEPS AdamW steps (AdamW moves each element about lr a step whatever
# its gradient's size, so a max would read the few elements whose tiny
# gradients differ in sign).  The mesh rounds each shard's product to bf16 and sums the row
# shards in f32 (the single process rounds the whole product once), the
# pipeline runs its micro-batches at half the rows, so the two paths round
# at other places, as phase 3b's kernel and plain paths do.  Each limit is
# 1.5x the largest reading over TM_SEEDS on an H100: (a) 8.1e-5, 1.62e-2,
# 1.20e-2; (b) 4.2e-5, 1.57e-2, 1.09e-2.  The controls (a gather_from_model
# whose backward sums the gradient over the model axis; the pipeline's
# output gradient summed over the stages) read 1.00-1.01 in grads and must
# exceed them.
TM_TOL = {"mesh": {"loss": 1.2e-4, "grads": 2.4e-2, "leaves": 1.8e-2},
          "pipeline": {"loss": 6.3e-5, "grads": 2.4e-2, "leaves": 1.6e-2}}
TM_FWD = {"int4g32": ("int4g32_mma", "int4g32_t_mma"), "int8": ("int8_mma", "int8_t_mma")}


def tm_batch(torch, cfg, seed):
    """Phase 11's batch of a seed: TM_BATCH x TM_SEQ ids, labels the ids
    with each row's first TM_IGNORED at -100 (the same on every rank)."""
    gen = torch.Generator().manual_seed(seed)
    ids = torch.randint(0, cfg.vocab_size, (TM_BATCH, TM_SEQ), generator=gen)
    labels = ids.clone()
    for b, n in enumerate(TM_IGNORED):
        labels[b, :n] = -100
    return ids, labels


def tm_tree(torch, cfg, quant, seed, device):
    """The random tree of (quant, seed), the same on every card."""
    from chatglm_q_tpu_torch.bench import random_quantized_params

    return random_quantized_params(cfg, quant, torch.Generator(device=device).manual_seed(seed),
                                   device=device)


def tm_named(tree, leaves):
    """{dotted name: f32 numpy array} of trainable leaves (or their grads),
    in ``trainable_leaves`` order."""
    names = [k for k, v in tree_leaves(tree) if v is not None]
    return {k: t.detach().float().cpu().numpy().copy() for k, t in zip(names, leaves)}


def tm_bit_equal(torch, got, want) -> bool:
    """The same keys, and every tensor of ``got`` bit-equal to ``want``'s,
    dtype included."""
    got, want = dict(tree_leaves(got)), dict(tree_leaves(want))
    return got.keys() == want.keys() and all(
        got[k].dtype == w.dtype and torch.equal(got[k], w) for k, w in want.items())


def tm_run(torch, fn, mesh):
    """fn()'s result and its host ms (ending in a sync), with the
    collectives it ran on ``mesh`` and their host ms."""
    torch.cuda.synchronize()
    calls, secs, t0 = mesh.calls, mesh.seconds, time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    return res, {"ms": (time.perf_counter() - t0) * 1e3, "collectives": mesh.calls - calls,
                 "collective_ms": (mesh.seconds - secs) * 1e3}


def tm_train(torch, cfg, quant, tr, fr, ids, labels, grads_fn, step_fn, mesh):
    """One measured record: the first pass's loss and grads (and its launch
    counts), then TM_STEPS AdamW steps from the same start, each timed."""
    from chatglm_q_tpu_torch import ops
    from chatglm_q_tpu_torch.utils.train import trainable_leaves

    ops.reset_launch_counts()
    (loss, grads), first = tm_run(torch, grads_fn, mesh)
    counts = {k: v for k, v in ops.launch_counts().items() if v}
    start = tm_named(tr, trainable_leaves(tr))
    opt = torch.optim.AdamW(trainable_leaves(tr), lr=TM_LR, weight_decay=0.0)
    steps = [tm_run(torch, lambda: step_fn(opt), mesh) for _ in range(TM_STEPS)]
    return {"loss": loss.item(), "grads": tm_named(tr, grads), "counts": counts,
            "first_pass": first, "losses": [s for s, _ in steps], "start": start,
            "steps": [t for _, t in steps], "leaves": tm_named(tr, trainable_leaves(tr))}


def train_mesh_rank(rank, shape, n_stage, ckpt_dir):
    """One rank of phase 11: (a) the sharded training step on a (data,
    model) mesh of ``shape`` for each tree of TM_QUANTS x TM_SEEDS (built on
    its card from the seed, then sliced: ``shard_params``), with the
    control on each quantization's first tree; (b) the int4g32 trees through
    ``n_stage`` pipeline stages over the same ranks, with its control; (c)
    the first int4g32 tree's slices saved from the mesh to ``ckpt_dir`` and
    loaded onto it again.  Returns the records (numpy), the rank's place
    and its peak device memory."""
    import torch

    from chatglm_q_tpu_torch import ChatGLM2Config, TorchRuntimeConfig
    from chatglm_q_tpu_torch.parallel import autograd_ops as AO
    from chatglm_q_tpu_torch.parallel import pipeline as PP
    from chatglm_q_tpu_torch.parallel import sharding as SH
    from chatglm_q_tpu_torch.utils import dist_ckpt as C
    from chatglm_q_tpu_torch.utils import train as T

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, bf16, rt = ChatGLM2Config(num_layers=TM_LAYERS), torch.bfloat16, TorchRuntimeConfig()
    dev = torch.device("cuda", torch.cuda.current_device())
    mesh = SH.make_mesh(*shape)
    stages = SH.make_mesh(shape[0] * shape[1] // n_stage, 1, n_stage)
    out = {"data": mesh.data_index, "model": mesh.model_index, "stage": stages.stage_index,
           "mesh": {}, "pipeline": {}}
    torch.cuda.reset_peak_memory_stats(dev)
    for quant in TM_QUANTS:
        for seed in TM_SEEDS:
            full = tm_tree(torch, cfg, quant, seed, dev)
            ids, labels = (t.to(dev) for t in tm_batch(torch, cfg, seed))
            params = SH.shard_params(full, mesh, cfg, quant)
            tr, fr = T.partition_params(params)

            def mesh_step(opt, tr=tr, fr=fr):
                step = T.make_train_step(cfg, quant, opt, bf16, rt, mesh)
                return step(tr, fr, ids, labels).item()

            rec = tm_train(torch, cfg, quant, tr, fr, ids, labels,
                           lambda: T.loss_and_grads(cfg, quant, tr, fr, ids, labels, bf16, rt,
                                                    None, mesh), mesh_step, mesh)
            if seed == TM_SEEDS[0]:  # the control: a gather backward that sums
                keep = AO.own_columns
                AO.own_columns = lambda m, g: keep(m, m.all_reduce(g.contiguous(), "model"))
                try:
                    tr_c, fr_c = T.partition_params(params)
                    _, g_c = T.loss_and_grads(cfg, quant, tr_c, fr_c, ids, labels, bf16, rt,
                                              None, mesh)
                finally:
                    AO.own_columns = keep
                rec["control_grads"] = tm_named(tr_c, g_c)
            out["mesh"][f"{quant} {seed}"] = rec
            if quant == "int4g32" and seed == TM_SEEDS[0] and ckpt_dir:
                t0 = time.perf_counter()
                C.save_params(ckpt_dir, params, mesh, cfg, quant)
                back = C.load_params(ckpt_dir, mesh=mesh, config=cfg, quant_type=quant,
                                     device=dev)
                out["ckpt"] = {"bit_equal": tm_bit_equal(torch, back, params),
                               "save_load_s": time.perf_counter() - t0}
            del params, tr, fr
            if quant == "int4g32":  # (b): the same tree through the stages
                pp = PP.shard_layers(full, stages)
                tr, fr = T.partition_params(pp)

                def pp_grads(tr, fr):
                    loss = PP.pp_forward(T.merge_params(tr, fr), cfg, ids, labels, quant, bf16,
                                         rt, stages, TM_MICRO)[0]
                    return loss, torch.autograd.grad(loss, T.trainable_leaves(tr))

                def pp_step(opt, tr=tr, fr=fr):
                    loss, grads = pp_grads(tr, fr)
                    for leaf, grad in zip(T.trainable_leaves(tr), grads):
                        leaf.grad = grad
                    opt.step()
                    opt.zero_grad(set_to_none=True)
                    return loss.item()

                rec = tm_train(torch, cfg, quant, tr, fr, ids, labels,
                               lambda: pp_grads(tr, fr), pp_step, stages)
                if seed == TM_SEEDS[0]:  # the control: the output gradient summed over stages
                    keep = PP.last_stage_grad
                    PP.last_stage_grad = lambda g, m: m.all_reduce(g, "stage")
                    try:
                        tr_c, fr_c = T.partition_params(pp)
                        rec["control_grads"] = tm_named(tr_c, pp_grads(tr_c, fr_c)[1])
                    finally:
                        PP.last_stage_grad = keep
                out["pipeline"][f"{quant} {seed}"] = rec
                del pp, tr, fr
            del full
            torch.cuda.empty_cache()
    out["peak_mem_bytes"] = torch.cuda.max_memory_allocated(dev)
    return out


def tm_reference(torch, cfg, quant, seed):
    """The single-process port's record on the same tree and batch."""
    from chatglm_q_tpu_torch import TorchRuntimeConfig
    from chatglm_q_tpu_torch.parallel.sharding import make_mesh
    from chatglm_q_tpu_torch.utils.train import loss_and_grads, make_train_step, partition_params

    rt, bf16 = TorchRuntimeConfig(), torch.bfloat16
    params = tm_tree(torch, cfg, quant, seed, "cuda")
    ids, labels = (t.cuda() for t in tm_batch(torch, cfg, seed))
    tr, fr = partition_params(params)

    def step(opt):
        return make_train_step(cfg, quant, opt, bf16, rt)(tr, fr, ids, labels).item()

    return tm_train(torch, cfg, quant, tr, fr, ids, labels,
                    lambda: loss_and_grads(cfg, quant, tr, fr, ids, labels, bf16, rt), step,
                    make_mesh(1, 1))


def tm_readings(rec, ref, rows=None, key="grads"):
    """(loss, grads, leaves) readings of a record against the reference: the
    first loss and the steps' losses; each grad's max |Δ| over its max
    |ref|; each leaf's Σ |Δ| after the steps over Σ |the reference's
    update| (a stage's layer leaves against the reference's ``rows``)."""
    import numpy as np

    def rel(a, b):
        return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))

    def part(name, a):
        return a[rows] if rows is not None and name.startswith("layers.") else a

    loss = max([abs(rec["loss"] - ref["loss"]) / abs(ref["loss"])]
               + [abs(a - b) / abs(b) for a, b in zip(rec["losses"], ref["losses"])])
    grads = max(rel(g, part(k, ref["grads"][k])) for k, g in rec[key].items())
    leaves = max(float(np.abs(v - part(k, ref["leaves"][k])).sum()
                       / max(np.abs(part(k, ref["leaves"][k] - ref["start"][k])).sum(), 1e-30))
                 for k, v in rec["leaves"].items())
    return loss, grads, leaves


def train_mesh_slice(torch, smi, backend="gloo", shape=(1, 2), n_stage=2):
    """Phase 11: the single-process reference records here, then the ranks
    (``train_mesh_rank``: gloo, all on this card; NCCL, ``--nccl``: a card a
    rank), then every check: each rank's (a) and each stage's (b) readings
    within TM_TOL over every seed and quantization, the controls beyond
    them, every rank the same loss, each forward and backward Hopper matmul
    launched on every rank (6 a layer and the lm_head's, a pass), and (c):
    the mesh's save loaded onto the mesh and whole here, both bit-equal to
    ``shard_params``' slices."""
    import shutil

    from chatglm_q_tpu_torch import ChatGLM2Config
    from chatglm_q_tpu_torch.ops import _build
    from chatglm_q_tpu_torch.parallel import sharding as SH
    from chatglm_q_tpu_torch.utils import dist_ckpt as C
    from chatglm_q_tpu_torch.utils.distributed import run_spmd

    cfg = ChatGLM2Config(num_layers=TM_LAYERS)
    refs = {}
    for quant in TM_QUANTS:
        for seed in TM_SEEDS:
            refs[f"{quant} {seed}"] = tm_reference(torch, cfg, quant, seed)
            torch.cuda.empty_cache()
    ref_ms = [r["steps"][-1]["ms"] for r in refs.values()]
    ckpt = _build.BUILD_DIR / "train_mesh_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    t0 = time.perf_counter()
    try:
        ranks = run_spmd(train_mesh_rank, shape[0] * shape[1], backend, timeout=900,
                         args=(shape, n_stage, str(ckpt)))
        spmd_s = time.perf_counter() - t0
        whole = C.load_params(ckpt, device="cuda")
        want = SH.shard_params(tm_tree(torch, cfg, "int4g32", TM_SEEDS[0], "cuda"),
                               SH.make_mesh(1, 1), cfg, "int4g32")
        whole_equal = tm_bit_equal(torch, whole, want)
        del whole, want
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    layers_per_stage = TM_LAYERS // n_stage
    out = {"card": smi, "backend": backend, "mesh": list(shape), "stages": n_stage,
           "layers": TM_LAYERS, "ranks_s": spmd_s, "reference_step_ms": ref_ms,
           "readings": {}, "control": {}, "ranks": []}
    failed = []
    for part, tol in TM_TOL.items():
        for key, ref in refs.items():
            if key not in ranks[0][part]:
                continue
            for i, r in enumerate(ranks):
                rec = r[part][key]
                rows = None
                if part == "pipeline":
                    rows = slice(r["stage"] * layers_per_stage,
                                 (r["stage"] + 1) * layers_per_stage)
                dl, dg, dv = tm_readings(rec, ref, rows)
                out["readings"].setdefault(part, []).append([key, r["data"], r["model"],
                                                            r["stage"], dl, dg, dv])
                if not (dl <= tol["loss"] and dg <= tol["grads"] and dv <= tol["leaves"]):
                    failed.append(f"({part}) {key} rank {i}: loss {dl:.3e}, grads {dg:.3e}, "
                                  f"leaves {dv:.3e}")
                if rec["loss"] != ranks[0][part][key]["loss"]:
                    failed.append(f"({part}) {key}: the ranks' losses differ")
                if "control_grads" in rec:
                    cg = tm_readings(rec, ref, rows, key="control_grads")[1]
                    out["control"].setdefault(part, []).append([key, i, cg])
                    if not cg > tol["grads"]:
                        failed.append(f"({part}) {key} rank {i}: the control passes ({cg:.3e})")
                passes = (6 * (TM_LAYERS if part == "mesh" else layers_per_stage * TM_MICRO)
                          + 1)
                fwd, bwd = TM_FWD[key.split()[0]]
                c = rec["counts"]
                if not (c.get(fwd) == passes and c.get(bwd) == passes):
                    failed.append(f"({part}) {key} rank {i}: {c.get(fwd)} {fwd} and "
                                  f"{c.get(bwd)} {bwd} launches in a pass, not {passes} each")
        worst = [max(x[i] for x in out["readings"][part]) for i in (4, 5, 6)]
        log(f"  ({'a' if part == 'mesh' else 'b'}) {part}: largest readings over "
            f"{len(out['readings'][part])} (tree, rank) pairs: |Δloss|/|loss| {worst[0]:.3e}, "
            f"grads {worst[1]:.3e}, leaves {worst[2]:.3e} (limits {tol['loss']:.1e}, "
            f"{tol['grads']:.1e}, {tol['leaves']:.1e}); controls "
            + ", ".join(f"{cg:.3e}" for _, _, cg in out["control"][part]) + f"  [{smi}]")
        for key in refs:
            got = [x for x in out["readings"][part] if x[0] == key]
            if got:
                log(f"    {key}: " + "; ".join(f"{x[4]:.3e} {x[5]:.3e} {x[6]:.3e}" for x in got))
    for i, r in enumerate(ranks):
        ckpt_ok = r.get("ckpt", {}).get("bit_equal")
        require(ckpt_ok, f"phase 11 (c) rank {i}: the mesh's checkpoint loaded onto the mesh is "
                         "not bit-equal to its slices")
        row = {"rank": i, "data": r["data"], "model": r["model"], "stage": r["stage"],
               "peak_mem_bytes": r["peak_mem_bytes"],
               "ckpt_save_load_s": r["ckpt"]["save_load_s"]}
        for part in ("mesh", "pipeline"):
            for key, rec in r[part].items():
                row[f"{part} {key}"] = {"counts": rec["counts"], "first_pass": rec["first_pass"],
                                        "steps": rec["steps"]}
        out["ranks"].append(row)
        for part in ("mesh", "pipeline"):
            for key in [k for k in r[part] if k.endswith(str(TM_SEEDS[0]))]:
                rec = r[part][key]
                fwd, bwd = TM_FWD[key.split()[0]]
                log(f"  rank {i} ({part} {key}; data {r['data']}, model {r['model']}, stage "
                    f"{r['stage']}): {rec['counts'][fwd]} {fwd}, {rec['counts'][bwd]} {bwd} in "
                    f"the first pass; step ms "
                    + ", ".join(f"{s['ms']:.1f}" for s in rec["steps"])
                    + "; collectives a step "
                    + ", ".join(str(s["collectives"]) for s in rec["steps"]) + ", host ms in them "
                    + ", ".join(f"{s['collective_ms']:.1f}" for s in rec["steps"]))
        log(f"  rank {i}: peak device memory {r['peak_mem_bytes'] / 2**30:.2f} GiB  [{smi}]")
    require(whole_equal, "phase 11 (c): the mesh's checkpoint loaded whole is not bit-equal to "
                         "the one-process shard_params")
    require(not failed, "phase 11: " + "; ".join(failed))
    log(f"  (c) checkpoint: saved from the ({shape[0]}, {shape[1]}) mesh, loaded onto it and "
        f"whole here, both bit-equal ({ranks[0]['ckpt']['save_load_s']:.1f} s to save and load "
        f"on rank 0); the single process's step "
        + ", ".join(f"{x:.1f}" for x in ref_ms) + f" ms; ranks done in {spmd_s:.1f} s  [{smi}]")
    counts = {}
    for r in ranks:
        for part in ("mesh", "pipeline"):
            for rec in r[part].values():
                for k, v in rec["counts"].items():
                    counts[k] = counts.get(k, 0) + v
    return counts, out


# ---------------------------------------------------------------------------
# Phase 12: the plan table, the exported decode step, the launchers
# ---------------------------------------------------------------------------

AUTOTUNE_M = (1, 4, 36, 128, 512, 1024)  # the main path's rows: decode, verify, prefill, chunk


def launch_args(fn):
    """``fn()``'s result and every (entry, args) it handed ``_build.call``."""
    from chatglm_q_tpu_torch.ops import _build

    calls, call = [], _build.call

    def spy(name, *args):
        calls.append((name, args))
        return call(name, *args)

    _build.call = spy
    try:
        out = fn()
        torch_sync()
    finally:
        _build.call = call
    return out, calls


def torch_sync():
    import torch

    torch.cuda.synchronize()


def autotune_check(torch, smi):
    """(a) With the packaged table (``{}``) and no user table every plan at
    the main path's shapes is the built-in rule; a sweep of B1's q_proj at
    M = 1 and 128 recorded into a table of its own (``$CHATGLM_Q_TPU_TORCH_
    AUTOTUNE`` under the build directory): each launch then takes the
    recorded plan, and so it does for a recorded exact plan that is not the
    built-in one, its output within ``KERNEL_TOL`` and ``SUM_TOL``; the
    split-K entry recorded at M = 1 also at its bucket's M = 8; an invalid
    entry raises naming its key."""
    import os
    import tempfile

    from chatglm_q_tpu_torch.ops import _build
    from chatglm_q_tpu_torch.ops import autotune as AT
    from chatglm_q_tpu_torch.ops import dyn_matmul as D
    from chatglm_q_tpu_torch.ops import quant_matmul as QM
    from chatglm_q_tpu_torch.ops.quant import unpack_int4_tpu
    from chatglm_q_tpu_torch.utils import autotune_sweep as S

    with open(AT.packaged_path()) as f:
        require(json.load(f) == {}, "the packaged autotune table is not empty")
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=_build.BUILD_DIR)
    saved = os.environ.get(AT.ENV)
    out = {"device_kind": AT.device_kind()}
    try:
        os.environ[AT.ENV] = os.path.join(tmp, "absent.json")
        AT.reload()
        n = 0
        for _, K, N in MATMUL_SHAPES:
            for M in AUTOTUNE_M:
                pairs = [(QM.mma_plan(M, K, N), None), (QM.int8_mma_plan(M, K, N), None),
                         (QM.t_mma_plan(M, K, N), QM.wg_plan(M, N, K)),
                         (QM.t_mma_plan(M, K, N, kind="int8"), QM.wg_plan(M, N, K)),
                         (D.dyn_plan(M, K, N), QM.wg_plan(M, K, N, step=QM.DYN_STEP)),
                         (D.dyn_plan(M, K, N, int4=True), QM.wg_plan(M, K, N, step=QM.DYN_STEP))]
                bm, ns, sps, ctas = QM.wg_plan(M, K, N)
                pairs[0] = (pairs[0][0], (bm, ns, QM.MMA_STAGE_GROUPS * sps if ns > 1
                                          else K // 32, ctas))
                pairs[1] = (pairs[1][0], (bm, ns, sps, ctas))
                if M <= QM.SMALL_M_MAX:
                    for xb, i8 in QM.SPLITK_KERNELS:
                        if xb == 2 and not i8 or M <= QM.MMA_MIN_M:
                            pairs.append((QM.splitk_plan(M, K, N, xb, i8),
                                          QM.builtin_splitk_plan(M, K, N, xb, i8)))
                for got, want in pairs:
                    require(tuple(got) == tuple(want), f"autotune: plan {got} at M={M} K={K} "
                                                       f"N={N} is not the built-in {want}")
                    n += 1
        out["plans_unchanged"] = n
        log(f"  (a) the packaged table is {{}}: {n} plans at the main path's shapes are the "
            f"built-in rules")

        os.environ[AT.ENV] = os.path.join(tmp, "autotune.json")
        AT.reload()
        swept = S.sweep("int4", ["q_proj"], [1, 128], record=True, seed=5,
                        log=lambda m: log("  " + m))
        gen = torch.Generator(device="cuda").manual_seed(6)
        out["sweep"] = []
        for res in swept:
            M, K, N = res["M"], res["K"], res["N"]
            require(res["best"] is not None, f"autotune: no exact plan at M={M}")
            packed = torch.randint(0, 256, (K // 2, N), dtype=torch.uint8, device="cuda",
                                   generator=gen)
            scale = (torch.rand((K // 32, N), device="cuda", generator=gen) * 0.02
                     ).to(torch.bfloat16)
            w64 = unpack_int4_tpu(packed, scale).double()
            splitk = M <= QM.SMALL_M_MAX
            span = slice(10, 15) if splitk else slice(10, 14)  # after M, K, N and the dtype code
            # a split-K entry serves its whole bucket: launch it at the
            # bucket's largest M too
            launch_m = [M] + ([res["bucket"]] if splitk and res["bucket"] != M else [])
            others = [c for c in res["candidates"]
                      if c["exact_enough"] and c["fits_bucket"] and not c["builtin"]]
            checks = [("recorded", res["best"]["plan"])] + (
                [("non-built-in", others[0]["plan"])] if others else [])
            row = {"M": M, "kernel": res["kernel"], "key": res["key"],
                   "candidates": res["candidates"], "launched": []}
            for label, plan in checks:
                if label != "recorded":
                    AT.record(res["kernel"], res["bucket"], K, N, plan)
                for rows in launch_m:
                    x = torch.randn((rows, K), device="cuda", generator=gen).to(torch.bfloat16)
                    exact, terms = x.double() @ w64, x.double().abs() @ w64.abs()
                    want = QM.int4g32_matmul_plain(x, packed, scale)
                    got, calls = launch_args(lambda: QM.int4g32_matmul(x, packed, scale))
                    require(len(calls) == 1 and list(calls[0][1][span]) == list(plan),
                            f"autotune: the M={rows} launch took "
                            f"{calls[0][1][span] if calls else None}, not the {label} plan {plan}")
                    rel = rel_err(got, want)[1]
                    b = hold_sum(torch, f"autotune {label} plan M={rows}", got, exact, terms)
                    require(rel <= KERNEL_TOL, f"autotune {label} plan M={rows}: rel err {rel}")
                    row["launched"].append({"which": label, "M": rows, "plan": list(plan),
                                            "rel_err": rel, "beyond_sum": b})
                    log(f"  (a) M={rows} (entry {res['key']}): the {label} plan {list(plan)} "
                        f"reached the launch ({calls[0][0]}); rel err {rel:.2e}, beyond the bf16 "
                        f"rounding {b:.2e} of sum|terms|")
                    del exact, terms
            del w64
            out["sweep"].append(row)
        # an entry the kernel refuses raises, naming its key
        bad = AT.record("int4_splitk", 8, 4096, 4096, (1, 8, 1, 1, 8))
        try:
            QM.splitk_plan(1, 4096, 4096)
            raised = None
        except ValueError as e:
            raised = str(e)
        require(raised is not None and bad in raised, f"autotune: an invalid entry gave {raised}")
        log(f"  (a) an invalid entry raises: {raised[:120]}  [{smi}]")
    finally:
        if saved is None:
            os.environ.pop(AT.ENV, None)
        else:
            os.environ[AT.ENV] = saved
        AT.reload()
    require(QM.splitk_plan(1, 4096, 4096) == QM.builtin_splitk_plan(1, 4096, 4096),
            "autotune: the built-in plan did not come back")
    return out


def export_check(torch, smi):
    """(b) ``torch.export`` of the decode step at ChatGLM2-6B widths, depth 2,
    batch 2 over a 256-slot cache prefilled with 12-20 tokens a row, int4g32
    and int8: saved, reloaded and run, its logits, lengths and both caches
    bit-equal to the eager step's; the graph calls the kernels' custom ops."""
    import tempfile

    from chatglm_q_tpu_torch import ChatGLM2Config, ops
    from chatglm_q_tpu_torch.bench import random_quantized_params
    from chatglm_q_tpu_torch.examples import export as EX
    from chatglm_q_tpu_torch.ops import _build

    cfg = ChatGLM2Config(num_layers=2)
    out = {}
    for quant in ("int4g32", "int8"):
        params = random_quantized_params(cfg, quant,
                                         torch.Generator(device="cuda").manual_seed(111))
        cache, ids = EX.prefilled_cache(params, cfg, quant, torch.bfloat16, 2, 256, "cuda")
        with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
            t0 = time.perf_counter()
            ops.reset_launch_counts()
            res = EX.round_trip(params, cfg, quant, torch.bfloat16, cache, ids,
                                f"{tmp}/decode_step.pt2")
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            size = pathlib.Path(f"{tmp}/decode_step.pt2").stat().st_size
        counts = {k: v for k, v in ops.launch_counts().items() if v}
        mm = "int4g32_matmul" if quant == "int4g32" else "int8_matmul"
        want_ops = {f"chatglm_q_tpu_torch.{op}.default" for op in
                    (mm, "rope_kv_append", "flash_attention_decode")}
        require(all(res["equal"].values()), f"export {quant}: reloaded step differs: "
                                            f"{res['equal']}")
        require(want_ops <= set(res["ops"]), f"export {quant}: the graph's custom ops "
                                             f"{res['ops']}")
        out[quant] = {"equal": res["equal"], "ops": res["ops"], "seconds": secs, "bytes": size,
                      "launches": counts}
        log(f"  (b) export {quant}: the reloaded decode step's logits, lengths and caches "
            f"bit-equal to the eager step's; custom ops {res['ops']}; {size / 1e3:.0f} kB, "
            f"{secs:.1f} s (export, save, load, run); launches {json.dumps(counts)}")
        del params, cache
    return out


def run_module(args, timeout, stdin=None):
    """``python -m`` a module of the port from this checkout's root; its
    (exit code, standard output, standard error)."""
    root = pathlib.Path(__file__).resolve().parent
    res = subprocess.run([sys.executable, "-m", *args], cwd=root, input=stdin,
                         capture_output=True, text=True, timeout=timeout)
    return res.returncode, res.stdout, res.stderr


def launchers_check(torch, smi):
    """(c) The launchers as a user runs them, each in a process of its own:
    ``engine_demo`` (random weights at 6B widths, 2 layers), ``cli_chat``
    with two questions piped in, and ``api_server`` answering
    one chat request over HTTP, the last two over a saved 2-layer int4g32
    checkpoint with the 65024-id tokenizer.  (d) ``convert_weight`` on a
    synthetic two-shard ``pytorch_model*.bin`` of 2 layers, the result
    loaded with its tokenizer, its tensors the source's."""
    import tempfile
    import urllib.request

    from chatglm_q_tpu_torch import ChatGLM2Config, GLMLoadConfig
    from chatglm_q_tpu_torch.bench import random_quantized_params
    from chatglm_q_tpu_torch.loader import load_model_and_tokenizer, save_model_and_tokenizer
    from chatglm_q_tpu_torch.ops import _build
    from chatglm_q_tpu_torch.tokenizer.build import build_unigram_model

    out = {}
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
        t0 = time.perf_counter()
        rc, so, se = run_module(["chatglm_q_tpu_torch.examples.engine_demo", "--requests", "4",
                                 "--new-tokens", "16"], 600)
        require(rc == 0 and "engine" in so.splitlines()[-1],
                f"engine_demo: exit {rc}\n{so[-2000:]}\n{se[-2000:]}")
        out["engine_demo"] = {"s": time.perf_counter() - t0, "stdout": so.splitlines()}
        log("  (c) engine_demo: " + " | ".join(so.strip().splitlines()))

        cfg = ChatGLM2Config(num_layers=2)
        ckpt = f"{tmp}/ckpt"
        params = random_quantized_params(cfg, "int4g32",
                                         torch.Generator(device="cuda").manual_seed(121))
        save_model_and_tokenizer(ckpt, GLMLoadConfig(model_config=cfg, quant_type="int4g32",
                                                     torch_dtype="bfloat16"),
                                 params, chat_tokenizer())
        del params
        t0 = time.perf_counter()
        rc, so, se = run_module(["chatglm_q_tpu_torch.examples.cli_chat", "--model", ckpt,
                                 "--max-tokens", "12", "--temperature", "0"], 600,
                                stdin=f"{CHAT_QUESTION}\n/clear\n{CHAT_QUESTION}\n\n")
        answers = [ln.split("答：", 1)[1] for ln in so.splitlines() if "答：" in ln]
        require(rc == 0 and len(answers) == 2 and answers[0] == answers[1] and answers[0],
                f"cli_chat: exit {rc}, answers {answers}\n{se[-2000:]}")
        out["cli_chat"] = {"s": time.perf_counter() - t0, "answer": answers[0]}
        log(f"  (c) cli_chat: two greedy answers after /clear, equal: {answers[0][:60]!r}")

        root = pathlib.Path(__file__).resolve().parent
        out_path, err_path = (pathlib.Path(tmp) / f"api_server.{x}" for x in ("out", "err"))
        with open(out_path, "w") as so_f, open(err_path, "w") as se_f:
            proc = subprocess.Popen([sys.executable, "-m",
                                     "chatglm_q_tpu_torch.examples.api_server", "--model", ckpt,
                                     "--port", "0", "--max-batch", "2", "--max-seq-len", "256",
                                     "--decode-chunk", "4"], cwd=root, stdout=so_f, stderr=se_f)
        try:
            t0 = time.perf_counter()
            line = ""
            while "serving" not in line:
                require(proc.poll() is None and time.perf_counter() - t0 < 300,
                        f"api_server not serving after {time.perf_counter() - t0:.0f} s (exit "
                        f"{proc.poll()}): {err_path.read_text()[-2000:]}")
                time.sleep(0.5)
                line = next((ln for ln in out_path.read_text().splitlines() if "serving" in ln),
                            "")
            url = line.split(" on ", 1)[1].strip()
            body = {"messages": [{"role": "user", "content": CHAT_QUESTION}],
                    "max_tokens": 12, "temperature": 0.0}
            req = urllib.request.Request(f"{url}/chat/completions", data=json.dumps(body).encode(),
                                         headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=120) as resp:
                obj = json.loads(resp.read())
            text = obj["choices"][0]["message"]["content"]
            require(obj["choices"][0]["finish_reason"] in ("stop", "length")
                    and isinstance(text, str), f"api_server: {obj}")
            out["api_server"] = {"s": time.perf_counter() - t0, "text": text,
                                 "finish_reason": obj["choices"][0]["finish_reason"]}
            log(f"  (c) api_server: one chat completion over HTTP: {text[:60]!r} "
                f"({obj['choices'][0]['finish_reason']})")
        finally:
            proc.terminate()
            try:
                proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()

        # (d) convert_weight on a synthetic HF checkpoint of 2 layers
        g = torch.Generator().manual_seed(131)
        H, I, V, G_, D_ = 256, 512, 1024, 2, 32
        src, dst = pathlib.Path(f"{tmp}/hf"), pathlib.Path(f"{tmp}/safe")
        src.mkdir()
        sd = {"transformer.embedding.word_embeddings.weight": torch.randn((V, H), generator=g),
              "transformer.encoder.final_layernorm.weight": torch.randn((H,), generator=g),
              "transformer.output_layer.weight": torch.randn((V, H), generator=g),
              "transformer.rotary_pos_emb.inv_freq": torch.randn((D_ // 4,), generator=g)}
        qkv = H + 2 * G_ * D_
        for i in range(2):
            pre = f"transformer.encoder.layers.{i}."
            sd.update({pre + "input_layernorm.weight": torch.randn((H,), generator=g),
                       pre + "self_attention.query_key_value.weight": torch.randn((qkv, H),
                                                                                  generator=g),
                       pre + "self_attention.query_key_value.bias": torch.randn((qkv,),
                                                                                generator=g),
                       pre + "self_attention.dense.weight": torch.randn((H, H), generator=g),
                       pre + "post_attention_layernorm.weight": torch.randn((H,), generator=g),
                       pre + "mlp.dense_h_to_4h.weight": torch.randn((2 * I, H), generator=g),
                       pre + "mlp.dense_4h_to_h.weight": torch.randn((H, I), generator=g)})
        sd = {k: v.to(torch.bfloat16) for k, v in sd.items()}
        shards = {f"pytorch_model-0000{j}-of-00002.bin": {k: v for k, v in sd.items()
                                                          if ("layers.1." in k) == (j == 2)}
                  for j in (1, 2)}
        for name, part in shards.items():
            torch.save(part, src / name)
        (src / "pytorch_model.bin.index.json").write_text(json.dumps(
            {"weight_map": {k: name for name, part in shards.items() for k in part}}))
        (src / "tokenizer.model").write_bytes(build_unigram_model([f"w{i}" for i in range(200)]))
        t0 = time.perf_counter()
        rc, so, se = run_module(["chatglm_q_tpu_torch.examples.convert_weight", "--source",
                                 str(src), "--target", str(dst)], 300)
        require(rc == 0, f"convert_weight: exit {rc}\n{so}\n{se[-2000:]}")
        conf = json.loads((dst / "config.json").read_text())
        # the script writes ChatGLM2-6B's config, as the JAX one does: this
        # synthetic checkpoint's widths and depth go in by hand
        conf["model_config"].update(hidden_size=H, inner_hidden_size=I, head_hidden_size=D_,
                                    num_multi_query_groups=G_, num_attention_heads=H // D_,
                                    num_layers=2, vocab_size=V)
        (dst / "config.json").write_text(json.dumps(conf))
        config, loaded, tok = load_model_and_tokenizer(dst, device="cuda")
        emb = sd["transformer.embedding.word_embeddings.weight"].cuda()
        require(torch.equal(loaded["word_embedding"]["weight"].to(emb.dtype), emb)
                and loaded["layers"]["attn_ln"]["weight"].shape[0] == 2 and tok is not None,
                "convert_weight: the converted checkpoint does not load the source's tensors")
        out["convert_weight"] = {"s": time.perf_counter() - t0,
                                 "files": conf["weight_files"], "stdout": so.splitlines()}
        log(f"  (d) convert_weight: {len(conf['weight_files'])} safetensors files; loaded with "
            f"its tokenizer ({len(tok)} ids), the embedding and 2 layers the source's  [{smi}]")
    return out


def phase12(torch, smi):
    return {"autotune": autotune_check(torch, smi), "export": export_check(torch, smi),
            "launchers": launchers_check(torch, smi)}


def gap_survey(torch, smi, seeds):
    """Phase 6's greedy readings alone, on each seed's tree and prompts, from
    bf16 and from f32 logits: the basis of GREEDY_GAP_TOL."""
    res = {}
    for seed in seeds:
        log(f"== greedy gap survey, seed {seed}")
        res[seed] = engines_slice(torch, smi, seed, survey=True)
        torch.cuda.empty_cache()
    log("gap survey: " + json.dumps(res))
    return 0


# ---------------------------------------------------------------------------
# The float8_e4m3fn cache: every attention kernel's fp8 form (phase 2)
# ---------------------------------------------------------------------------

def fp8_cache(torch, gen, shape, act=None):
    """A random fp8 cache tensor written through the port's store
    (``kv_store_cast``) and its exact upcast to ``act`` (default bf16)."""
    from chatglm_q_tpu_torch.ops import attention as A

    k8 = A.kv_store_cast(torch.randn(shape, device="cuda", generator=gen), torch.float8_e4m3fn)
    return k8, k8.to(act or torch.bfloat16)


def fp8_equal(a, b):
    """Bit-equal outputs (a tuple's every tensor), fp8 tensors by their bytes."""
    a, b = (a, b) if isinstance(a, tuple) else ((a,), (b,))
    return all(torch_equal_bytes(x, y) for x, y in zip(a, b))


def torch_equal_bytes(x, y):
    import torch

    if x.dtype == torch.float8_e4m3fn:
        x, y = x.view(torch.uint8), y.view(torch.uint8)
    return torch.equal(x, y)


def fp8_row(torch, name, fp8_fn, same_fn, plain_fn, nbytes, ops, lib_fn, shape, exact=False,
            plain_iters=5, plain_syncs=False, act="bf16", tol=KERNEL_TOL, peak=PEAK_BF16_FLOPS,
            lib_syncs=False):
    """One fp8 form of a kernel under ``act`` activations ("bf16", "f16" or
    "f32"): ``fp8_fn(i)`` over layer i of an fp8 cache, ``same_fn(i)`` its
    16-bit (f32) form (activations and cache in ``act``) over the same cache
    upcast, ``plain_fn()`` the plain version on layer 0 of the fp8 cache.
    Required: the fp8 form bit-equal to the 16-bit form (``same_fn`` None:
    an append, bit-equal to its plain version instead) and within ``tol``
    of its plain version (``exact``: bit-equal).  Timed over the 28 layers:
    the fp8 form, the 16-bit form (``<act>_ms``), the plain version, and the
    library yardstick (``lib_fn``: the cache cast to ``act`` and SDPA; None
    where no call computes it); the bound counts each K/V byte read once at
    1 B.  ``plain_syncs``: the plain version reads a device value on the
    host, so it is timed on the host's clock (``synced_ms``); ``lib_syncs``
    likewise the library call."""
    from chatglm_q_tpu_torch.utils.timing import cuda_event_ms

    got = fp8_fn(0)
    same = same_fn(0) if same_fn is not None else None
    torch.cuda.synchronize()
    want = plain_fn()
    if exact:
        require(fp8_equal(got, want), f"{name}: differs from its plain version")
        err = rel = 0.0
    else:
        g0, w0 = (got[0], want[0]) if isinstance(got, tuple) else (got, want)
        err, rel = rel_err(g0, w0)
        require(torch.isfinite(g0.float()).all() and rel <= tol, f"{name} rel err {rel}")
    if same is not None:
        require(fp8_equal(got, same), f"{name}: differs from the {act} form on the upcast cache")
    ms = cuda_event_ms(fp8_fn, iters=56)
    same_ms = cuda_event_ms(same_fn, iters=56) if same_fn is not None else None
    if plain_syncs:
        plain = synced_ms(torch, lambda i: plain_fn(), plain_iters)
    else:
        plain = cuda_event_ms(lambda i: plain_fn(), iters=plain_iters)
    lib = (None if lib_fn is None else synced_ms(torch, lib_fn, 8) if lib_syncs
           else cuda_event_ms(lib_fn, iters=56))
    b, by = bound_ms(nbytes, ops, peak)
    return {"max_abs_err": err, "rel_err": rel, "ms": ms, "plain_ms": plain, "bound_ms": b,
            "bound_by": by, "library_ms": lib, f"{act}_ms": same_ms,
            "bit_equal_to_16bit_form": same is not None, "shape": shape}


def f32_store_sweep(torch):
    """f32 values at 64 points of every e4m3 binade (subnormals included),
    each nudged 2^-9 below, onto and above (across the e4m3 rounding
    midpoints, where a bf16 hop rounds a second time), random values, the
    top of the range and past it, +-inf, NaN, their negatives: (N, 2, 128)
    rows on the card."""
    e = torch.arange(-12, 9, device="cuda").float()
    grid = (torch.linspace(1, 2, 64, device="cuda")[None, :] * torch.exp2(e)[:, None]).flatten()
    nudge = torch.tensor([1 - 2 ** -9, 1, 1 + 2 ** -9], device="cuda")
    edge = torch.tensor([448.0, 449.0, 463.9, 464.0, 1e30, math.inf, math.nan, 0.0],
                        device="cuda")
    x = torch.cat([(grid[:, None] * nudge).flatten(),
                   torch.randn(8192, device="cuda", generator=torch.Generator(
                       device="cuda").manual_seed(5)) * 40, edge])
    x = torch.cat([x, -x])
    return torch.cat([x, x.new_zeros(-x.numel() % 256)]).reshape(-1, 2, 128)


def fp8_store_line(torch, act):
    """The write-only append into an fp8 cache, byte for byte against
    ``kv_store_cast`` on the card and on the CPU: all 65,536 bit patterns
    of ``act`` (bf16 or f16), or for f32 ``f32_store_sweep``, whose bytes a
    bf16 hop first (two roundings) must change somewhere (the control)."""
    from chatglm_q_tpu_torch.ops import attention as A

    fp8 = torch.float8_e4m3fn
    if act == torch.float32:
        x = f32_store_sweep(torch)
    else:
        x = torch.arange(65536, dtype=torch.int32, device="cuda").to(torch.int16).view(
            act).reshape(256, 2, 128)
    n = x.shape[0]
    want = A.kv_store_cast(x, fp8)
    cache = A.kv_zeros((1, n, 2, 4, 128), fp8, "cuda")
    A.kv_cache_write_idx(cache, x, 0, torch.full((n,), 2, dtype=torch.int32, device="cuda"))
    torch.cuda.synchronize()
    card = torch_equal_bytes(cache[0, :, :, 2], want)
    cpu = torch_equal_bytes(want.cpu(), A.kv_store_cast(x.cpu(), fp8))
    nan = int(torch.isnan(x.float()).sum())
    sat = int(((x.float().abs() > A.FP8_MAX) & ~torch.isnan(x.float())).sum())
    require(card and cpu, f"the fp8 store: kernel == kv_store_cast on the card {card}, "
                          f"card == CPU {cpu}")
    res = {"patterns": x.numel(), "equal_on_card": card, "card_equals_cpu": cpu,
           "nan_patterns": nan, "saturated_patterns": sat}
    if act == torch.float32:
        hop = A.kv_store_cast(x.to(torch.bfloat16), fp8)
        res["bf16_hop_differs"] = int((hop.view(torch.uint8) != want.view(torch.uint8)).sum())
        require(res["bf16_hop_differs"] > 0, "the f32 store: no value where a bf16 hop differs")
        log(f"  fp8 store: {x.numel()} f32 values (every e4m3 binade across its rounding "
            f"midpoints) through the write-only append equal kv_store_cast byte for byte on the "
            f"card and on the CPU, one rounding from f32 ({nan} NaN stored 0x7F, {sat} past "
            f"+-448 saturated); a bf16 hop first gives other bytes for "
            f"{res['bf16_hop_differs']} of them")
        return res
    log(f"  fp8 store: all 65536 {str(act)[6:]} patterns through the write-only append equal "
        f"kv_store_cast byte for byte on the card and on the CPU ({nan} NaN patterns stored "
        f"0x7F, {sat} past +-448 saturated)")
    return res


def check_fp8_attention(torch, act=None):
    """Every attention kernel's fp8-cache form under ``act`` activations
    (bf16, the default; f16: the f16-over-fp8 form, rows keyed "...
    fp8_f16"; f32: "... fp8_f32") at the shapes of its bf16 row: B3 / B9 (the fused
    append, B = 4 and 1, dense and paged), B4 (B = 4 and 1), B12, B5 (both
    forms), B10, B11 (S = 9), K1, K2, K3 (dense and paged), and the store
    over every pattern of ``act``.  The same seed as the bf16 rows: the
    same fp8 caches, q rounded to ``act``."""
    import torch.nn.functional as F

    from chatglm_q_tpu_torch.models.chatglm2 import precompute_freqs_cis
    from chatglm_q_tpu_torch.ops import attention as A

    gen = torch.Generator(device="cuda").manual_seed(17)
    act = act or torch.bfloat16
    tag, form, tol = {torch.bfloat16: (" fp8", "bf16", KERNEL_TOL),
                      torch.float16: (" fp8_f16", "f16", F16_KERNEL_TOL),
                      torch.float32: (" fp8_f32", "f32", F32_TOL)}[act]
    esz = act.itemsize  # bytes of a q or output element
    peak = PEAK_F32_FLOPS if act == torch.float32 else PEAK_BF16_FLOPS
    L, G, Hg, D = 28, 2, 16, 128
    sm = 1.0 / math.sqrt(D)
    out = {"store": fp8_store_line(torch, act)}
    rows = {}

    def row_of(name, *args, **kw):  # fp8_row with this form's twin (16-bit or f32) and limit
        return fp8_row(torch, name, *args, act=form, tol=tol, peak=peak,
                       lib_syncs=act == torch.float32, **kw)

    def cache_of(shape):
        return fp8_cache(torch, gen, shape, act)

    def rnd(*shape):
        return torch.randn(shape, device="cuda", generator=gen).to(act)

    def i32(*xs):
        return torch.tensor(xs, dtype=torch.int32, device="cuda")

    def kv_bytes_read(n):  # K and V at one byte an element
        return n * G * D * 2

    # the dense cache of phase 2's B4 row: (L, 4, G, 1024, D)
    B, T = len(PROMPT_LENGTHS), CACHE_LEN
    (k8, k16), (v8, v16) = cache_of((L, B, G, T, D)), \
        cache_of((L, B, G, T, D))
    q = rnd(B, G, Hg, D)
    lens = i32(1000, 600, 200, 0)
    n = [min(int(x) + 1, T) for x in lens.tolist()]
    mask = (torch.arange(T, device="cuda")[None, :] <= lens[:, None])[:, None, None, :]

    def lib_decode(qq, kk, vv, mm):
        return lambda i: F.scaled_dot_product_attention(
            qq.reshape(qq.shape[0], G * Hg, 1, D), kk[i % L].to(act), vv[i % L].to(act),
            attn_mask=mm, scale=sm, enable_gqa=True)

    for key, fn, plain in (("flash_attention_decode", A.flash_attention_decode,
                            A.flash_attention_decode_plain),
                           ("flash_attention_decode_v2", A.flash_attention_decode_v2,
                            A.flash_attention_decode_v2_plain)):
        rows[key + tag] = row_of(
            key + tag, lambda i, fn=fn: fn(q, k8[i % L], v8[i % L], lens, sm),
            lambda i, fn=fn: fn(q, k16[i % L], v16[i % L], lens, sm),
            lambda plain=plain: plain(q, k8[0], v8[0], lens, sm),
            2 * q.numel() * esz + kv_bytes_read(sum(n)) + B * 4, 4.0 * sum(n) * G * Hg * D,
            lib_decode(q, k8, v8, mask),
            f"B={B} G={G} Hg={Hg} D={D} T={T} lengths={lens.tolist()} fp8 cache")
    q1, l1 = q[:1].contiguous(), i32(140)
    mask1 = (torch.arange(T, device="cuda") <= 140)[None, None, None, :]
    rows[f"flash_attention_decode B=1{tag}"] = row_of(
        f"flash_attention_decode B=1{tag}",
        lambda i: A.flash_attention_decode(q1, k8[i % L][:1], v8[i % L][:1], l1, sm),
        lambda i: A.flash_attention_decode(q1, k16[i % L][:1], v16[i % L][:1], l1, sm),
        lambda: A.flash_attention_decode_plain(q1, k8[0][:1], v8[0][:1], l1, sm),
        2 * q1.numel() * esz + kv_bytes_read(141) + 4, 4.0 * 141 * G * Hg * D,
        lambda i: F.scaled_dot_product_attention(
            q1.reshape(1, G * Hg, 1, D), k8[i % L][:1].to(act), v8[i % L][:1].to(act),
            attn_mask=mask1, scale=sm, enable_gqa=True),
        f"B=1 G={G} Hg={Hg} D={D} T={T} lengths=[140] fp8 cache")

    # B5, whole prompts over the same cache
    S = max(PROMPT_LENGTHS)
    qp = rnd(B, S, G, Hg, D)
    lp = i32(*PROMPT_LENGTHS)
    pos = torch.arange(S, device="cuda")
    pmask = ((pos[None, :] <= pos[:, None])[None] & (pos[None, None, :] < lp[:, None, None]))
    qsp = qp.permute(0, 2, 3, 1, 4).reshape(B, G * Hg, S, D)
    pairs = sum(min(s + 1, lb) for lb in PROMPT_LENGTHS for s in range(S))
    rows[f"flash_attention_prefill{tag}"] = row_of(
        f"flash_attention_prefill{tag}",
        lambda i: A.flash_attention_prefill(qp, k8[i % L], v8[i % L], lp, sm),
        lambda i: A.flash_attention_prefill(qp, k16[i % L], v16[i % L], lp, sm),
        lambda: A.flash_attention_prefill_plain(qp, k8[0], v8[0], lp, sm),
        2 * qp.numel() * esz + kv_bytes_read(sum(min(S, lb) for lb in PROMPT_LENGTHS)) + B * 4,
        4.0 * pairs * G * Hg * D,
        lambda i: F.scaled_dot_product_attention(
            qsp, k8[i % L][:, :, :S].to(act), v8[i % L][:, :, :S].to(act), attn_mask=pmask[:, None],
            scale=sm, enable_gqa=True),
        f"B={B} S={S} G={G} Hg={Hg} D={D} lengths={list(PROMPT_LENGTHS)} fp8 cache")

    # B3 with the RoPE: bit-equal to its plain version (RoPE in bf16, then the store)
    freqs_table = torch.from_numpy(precompute_freqs_cis(D, 2049)).to("cuda", act)

    def append_row(key, kk, vv, pt, st, shard=None):
        Bq = st.shape[0]
        qa = rnd(Bq, G, Hg, D)
        kv = rnd(Bq, 2 * G * D)
        fr = freqs_table[torch.tensor([5, 700, 1500, 2048], device="cuda")[:Bq]]
        kr, vr = (t.view(torch.uint8).clone().view(torch.float8_e4m3fn) for t in (kk, vv))
        kb, vb = kk.to(act), vv.to(act)  # a 16-bit cache for the 16-bit form's time

        def run(i, k_, v_):
            if shard is None:
                return A.rope_kv_append(qa, kv, fr, k_, v_, i % L, st, pt)
            return A.rope_kv_append_sharded(qa, kv, fr, k_, v_, i % L, st, shard, pt)

        def plain():
            if shard is None:
                return A.rope_kv_append_plain(qa, kv, fr, kr, vr, 3, st, pt)
            return A.rope_kv_append_sharded_plain(qa, kv, fr, kr, vr, 3, st, shard, pt)

        got = run(3, kk, vv)
        torch.cuda.synchronize()
        want = plain()
        require(torch.equal(got, want) and torch_equal_bytes(kk, kr) and
                torch_equal_bytes(vv, vr), f"{key}: differs from its plain version")
        nbytes = Bq * (2 * qa[0].numel() * esz + kv[0].numel() * esz + D * esz + 2 * G * D + 4) \
            + (0 if pt is None else Bq * 4)
        row = row_of(key, lambda i: run(i, kk, vv), None, plain, nbytes,
                      6.0 * Bq * (G * Hg + G) * D / 2, None,
                      f"q (B={Bq}, G={G}, Hg={Hg}, D={D}), fp8 "
                      + (f"cache (L={L}, B={kk.shape[1]}, G={G}, T={kk.shape[3]}, D={D})"
                         if pt is None else f"pool (L={L}, NP={kk.shape[1]}, G={G}, "
                                            f"P={kk.shape[3]}, D={D}), MP={pt.shape[1]}")
                      + f", starts {st.tolist()}" + ("" if shard is None else f", {shard}"),
                      exact=True, plain_iters=14, plain_syncs=shard is not None)
        row["bound_ms"], row["bound_by"] = bound_ms(nbytes, 6.0 * Bq * (G * Hg + G) * D / 2,
                                                    PEAK_F32_FLOPS)
        from chatglm_q_tpu_torch.utils.timing import cuda_event_ms

        row[f"{form}_ms"] = cuda_event_ms(lambda i: run(i, kb, vb), iters=56)
        del kb, vb, kr, vr
        return row

    rows[f"rope_kv_append{tag}"] = append_row(f"rope_kv_append{tag}", k8, v8, None,
                                            i32(T - 1, T, T + 5, 2))
    k1, v1 = (cache_of((L, 1, G, T, D))[0] for _ in range(2))
    rows[f"rope_kv_append B=1{tag}"] = append_row(f"rope_kv_append B=1{tag}", k1, v1, None,
                                                  i32(140))
    del k1, v1

    # B5's chunked form: 4 compact rows x 256 against a 2048-slot cache
    Sc = 256
    (c8, c16), (d8, d16) = cache_of((L, B, G, SEQ, D)), \
        cache_of((L, B, G, SEQ, D))
    qc = rnd(B, Sc, G, Hg, D)
    cstarts = i32(768, 512, 256, 0)
    clens = cstarts + i32(256, 256, 200, 256)
    rmap = i32(2, 0, 3, 1)
    qpos = cstarts.long()[:, None] + torch.arange(Sc, device="cuda")[None, :]
    cols = torch.arange(SEQ, device="cuda")[None, None, :]
    cmask = (cols <= qpos[:, :, None]) & (cols < clens.long()[:, None, None])
    qcs = qc.permute(0, 2, 3, 1, 4).reshape(B, G * Hg, Sc, D)
    kv_rows = sum(min(int(ln), int(st) + Sc) for st, ln in zip(cstarts.tolist(), clens.tolist()))
    cpairs = sum(min(st + t + 1, ln) for st, ln in zip(cstarts.tolist(), clens.tolist())
                 for t in range(Sc))
    rows[f"flash_attention_prefill_chunk{tag}"] = row_of(
        f"flash_attention_prefill_chunk{tag}",
        lambda i: A.flash_attention_prefill_chunk(qc, c8[i % L], d8[i % L], clens, cstarts, sm,
                                                  rmap),
        lambda i: A.flash_attention_prefill_chunk(qc, c16[i % L], d16[i % L], clens, cstarts, sm,
                                                  rmap),
        lambda: A.flash_attention_prefill_plain(qc, c8[0], d8[0], clens, sm, cstarts, rmap),
        2 * qc.numel() * esz + kv_bytes_read(kv_rows) + 3 * B * 4, 4.0 * cpairs * G * Hg * D,
        lambda i: F.scaled_dot_product_attention(
            qcs, c8[i % L].to(act)[rmap.long()], d8[i % L].to(act)[rmap.long()],
            attn_mask=cmask[:, None], scale=sm, enable_gqa=True),
        f"B={B} Sc={Sc} G={G} Hg={Hg} D={D} T={SEQ} starts={cstarts.tolist()} "
        f"lengths={clens.tolist()} kv_row_map={rmap.tolist()} fp8 cache")
    del c8, c16, d8, d16, k16, v16

    # K1 on shard 0 of phase 8's 8192-slot cache (4096 a rank): the first
    # 4096 slots of a fresh fp8 cache
    Tl = SHARD_T // SHARD_TP
    (s8, s16), (t8, t16) = cache_of((L, B, G, Tl, D)), \
        cache_of((L, B, G, Tl, D))
    slen = i32(*SHARD_LENGTHS)
    sn = [max(0, min(int(x) + 1, Tl)) for x in SHARD_LENGTHS]
    smask = (torch.arange(Tl, device="cuda")[None, :] <= slen[:, None])[:, None, None, :]
    rows[f"flash_attention_decode_lse{tag}"] = row_of(
        f"flash_attention_decode_lse{tag}",
        lambda i: A.flash_attention_decode_lse(q, s8[i % L], t8[i % L], slen, sm, 0),
        lambda i: A.flash_attention_decode_lse(q, s16[i % L], t16[i % L], slen, sm, 0),
        lambda: A.flash_attention_decode_lse_plain(q, s8[0], t8[0], slen, sm, 0),
        2 * q.numel() * esz + kv_bytes_read(sum(sn)) + B * 4 + 2 * B * G * Hg * 4,
        4.0 * sum(sn) * G * Hg * D, lib_decode(q, s8, t8, smask),
        f"B={B} G={G} Hg={Hg} D={D} shard 0 of T={SHARD_T} (T_local={Tl}) "
        f"lengths={list(SHARD_LENGTHS)} fp8 cache")
    rows[f"rope_kv_append_sharded{tag}"] = append_row(
        f"rope_kv_append_sharded{tag}", s8, t8, None, i32(100, Tl - 1, Tl, SHARD_T + 3),
        A.KVShard(offset=0, total=SHARD_T))
    del s8, s16, t8, t16, k8, v8

    # the pool of phase 2's paged rows: (L, 64, G, 256, D), 2048-slot rows
    MP = SEQ // PAGE
    (p8, p16), (w8, w16) = cache_of((L, POOL_PAGES, G, PAGE, D)), \
        cache_of((L, POOL_PAGES, G, PAGE, D))
    pt = (torch.randperm(POOL_PAGES - 1, device="cuda", generator=gen)[: B * MP] + 1
          ).reshape(B, MP).to(torch.int32)
    plens = i32(*PAGED_LENGTHS)
    pn = [min(x + 1, MP * PAGE) for x in PAGED_LENGTHS]
    dmask = (torch.arange(MP * PAGE, device="cuda")[None, :] <= plens[:, None])[:, None, None]

    def lib_paged(qq, mm):
        def call(i):
            kd = A.gather_pages(p8[i % L], pt).to(act)
            vd = A.gather_pages(w8[i % L], pt).to(act)
            if qq.dim() == 4:
                qs = qq.reshape(qq.shape[0], G * Hg, 1, D)
            else:
                qs = qq.permute(0, 2, 3, 1, 4).reshape(qq.shape[0], G * Hg, qq.shape[1], D)
            return F.scaled_dot_product_attention(qs, kd, vd, attn_mask=mm, scale=sm,
                                                  enable_gqa=True)
        return call

    rows[f"flash_attention_decode_paged{tag}"] = row_of(
        f"flash_attention_decode_paged{tag}",
        lambda i: A.flash_attention_decode_paged(q, p8, w8, i % L, pt, plens, sm),
        lambda i: A.flash_attention_decode_paged(q, p16, w16, i % L, pt, plens, sm),
        lambda: A.flash_attention_decode_paged_plain(q, p8, w8, 0, pt, plens, sm),
        2 * q.numel() * esz + kv_bytes_read(sum(pn)) + B * MP * 4 + B * 4,
        4.0 * sum(pn) * G * Hg * D, lib_paged(q, dmask),
        f"B={B} G={G} Hg={Hg} D={D} P={PAGE} MP={MP} lengths={list(PAGED_LENGTHS)} fp8 pool")
    S9 = 9
    q9 = rnd(B, S9, G, Hg, D)
    qpos9 = plens.long()[:, None] + torch.arange(S9, device="cuda")[None, :]
    cmask9 = (torch.arange(MP * PAGE, device="cuda")[None, None, :] <= qpos9[:, :, None])
    rows9 = [min(st + S9, MP * PAGE) for st in PAGED_LENGTHS]
    pairs9 = sum(min(st + t + 1, MP * PAGE) for st in PAGED_LENGTHS for t in range(S9))
    rows[f"flash_attention_chunk_paged S=9{tag}"] = row_of(
        f"flash_attention_chunk_paged S=9{tag}",
        lambda i: A.flash_attention_chunk_paged(q9, p8, w8, i % L, pt, plens, sm),
        lambda i: A.flash_attention_chunk_paged(q9, p16, w16, i % L, pt, plens, sm),
        lambda: A.flash_attention_chunk_paged_plain(q9, p8, w8, 0, pt, plens, sm),
        2 * q9.numel() * esz + kv_bytes_read(sum(rows9)) + B * MP * 4 + B * 4,
        4.0 * pairs9 * G * Hg * D, lib_paged(q9, cmask9[:, None]),
        f"B={B} S={S9} G={G} Hg={Hg} D={D} P={PAGE} starts={list(PAGED_LENGTHS)} fp8 pool")
    cap = MP * PAGE
    rows[f"rope_kv_append paged{tag}"] = append_row(f"rope_kv_append paged{tag}", p8, w8, pt,
                                                  i32(cap - 1, cap, cap + 100, 5))
    # K2 / K3 on phase 0 of a stride-2 local table: the table's even columns
    half = pt[:, ::2].contiguous()
    rows[f"flash_attention_decode_paged_lse{tag}"] = row_of(
        f"flash_attention_decode_paged_lse{tag}",
        lambda i: A.flash_attention_decode_paged_lse(q, p8, w8, i % L, half, plens, sm, 2, 0),
        lambda i: A.flash_attention_decode_paged_lse(q, p16, w16, i % L, half, plens, sm, 2, 0),
        lambda: A.flash_attention_decode_paged_lse_plain(q, p8, w8, 0, half, plens, sm, 2, 0),
        2 * q.numel() * esz + kv_bytes_read(sum(pn) // 2) + B * MP * 2 + B * 4 + 2 * B * G * Hg * 4,
        4.0 * sum(pn) / 2 * G * Hg * D, None,
        f"B={B} G={G} Hg={Hg} D={D} P={PAGE}, phase 0 of a stride-2 table (B, {MP // 2}), "
        f"lengths={list(PAGED_LENGTHS)} fp8 pool")
    rows[f"rope_kv_append_sharded paged{tag}"] = append_row(
        f"rope_kv_append_sharded paged{tag}", p8, w8, half,
        i32(100, PAGE + 3, cap - 1, cap + 9),
        A.KVShard(stride=2, phase=0, total=cap))
    del p8, p16, w8, w16
    width = max(len(k) for k in rows)
    for k, r in rows.items():
        lib = "none" if r["library_ms"] is None else f"{r['library_ms']:.4f} ms"
        log(f"  {k:{width}s} rel_err {r['rel_err']:.2e}  {r['ms']:.4f} ms ({form} form "
            f"{r[form + '_ms']:.4f} ms)  bound {r['bound_ms']:.6f} ms ({r['bound_by']})  plain "
            f"{r['plain_ms']:.4f} ms  cast + SDPA {lib}  "
            f"{f'= {form} form on the upcast cache' if r['bit_equal_to_16bit_form'] else '= plain'}"
            f"  [{r['shape']}]")
    out.update(rows)
    return out


# ---------------------------------------------------------------------------
# The fp8 cache end to end: phases 5, 6 and 8, and a long-context step
# ---------------------------------------------------------------------------

FP8_REL_TOL = 0.15  # JAX's own limit on fp8-cache logits (tests/test_attention.py:168)


def fp8_logit_drift(torch, params, cfg, ids, rt):
    """max|Δlogits| / max|logits| of the first decode step after the chat
    prompt's prefill over an fp8 cache against a bf16 one (the same input
    token: the bf16 run's greedy token)."""
    from chatglm_q_tpu_torch.models import chatglm2 as M

    bf = torch.bfloat16
    prompt = torch.tensor([ids], device="cuda")
    lengths = torch.tensor([len(ids)], dtype=torch.int32, device="cuda")
    out, tok = [], None
    for dt in (bf, torch.float8_e4m3fn):
        cache = M.init_kv_cache(cfg, 1, CACHE_LEN, dt)
        logits, cache = M.prefill(params, cfg, prompt, lengths, cache, "int4g32", bf, rt)
        tok = torch.argmax(logits, -1).to(torch.int32) if tok is None else tok
        out.append(M.decode_step(params, cfg, tok, cache, "int4g32", bf, rt)[0].float())
        del cache
    return ((out[1] - out[0]).abs().max() / out[0].abs().max()).item()


def chat_fp8(torch, smi, params, cfg, tokenizer, prompt, ids, bf16_decoder):
    """Phase 5's fp8 run: ``GLMDecoder(kv_dtype=torch.float8_e4m3fn)`` on the
    28-layer int4g32 tree, the chat prompt, 32 greedy tokens, captured and
    eager (equal texts); every token within GREEDY_GAP_TOL of the argmax of
    the plain path (``use_kernels=False``) over the same fp8 cache; the
    first decode step's logits against the bf16 cache's within JAX's 0.15;
    ms a token beside the bf16 decoder's, in turns."""
    from types import SimpleNamespace

    from chatglm_q_tpu_torch import GLMLoadConfig, TorchRuntimeConfig, ops
    from chatglm_q_tpu_torch.models import chatglm2 as M
    from chatglm_q_tpu_torch.serving import GLMDecoder

    fp8 = torch.float8_e4m3fn
    load = GLMLoadConfig(model_config=cfg, quant_type="int4g32", torch_dtype="bfloat16")
    rt, eager = TorchRuntimeConfig(), TorchRuntimeConfig(cuda_graphs=False)
    dec = GLMDecoder(load, params, tokenizer, max_sequence_length=CACHE_LEN, rt=rt, kv_dtype=fp8)
    dec_eager = GLMDecoder(load, params, tokenizer, max_sequence_length=CACHE_LEN, rt=eager,
                           kv_dtype=fp8)
    ops.reset_launch_counts()
    _, final, _ = run_generate(dec, prompt)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    step = M.decode_program(params, cfg, dec._free_caches[0][0], "int4g32", torch.bfloat16, rt)
    require(dec._free_caches[0][0].k.dtype == fp8 and step.graph is not None
            and step.replays >= CHAT_TOKENS - 3,
            f"int4g32 fp8: the decode step was not replayed from a graph ({step.replays})")
    _, final_eager, _ = run_generate(dec_eager, prompt)
    require(final_eager == final, f"int4g32 fp8: the captured decoder's text differs from the "
                                  f"eager one's: {final[:60]!r} / {final_eager[:60]!r}")
    for k in ("rope_kv_append", "flash_attention_decode", "flash_attention_prefill"):
        require(counts[k + "_fp8"] > 0 and counts[k + "_fp8"] == counts[k],
                f"int4g32 fp8: {k} launched {counts[k]} times, {counts[k + '_fp8']} in fp8")
    # the tokens: the model-level loop over an fp8 cache gives the decoder's text
    cache = M.init_kv_cache(cfg, 1, CACHE_LEN, fp8)
    logits, cache = M.prefill(params, cfg, torch.tensor([ids], device="cuda"),
                              torch.tensor([len(ids)], dtype=torch.int32, device="cuda"), cache,
                              "int4g32", torch.bfloat16, rt)
    first = torch.argmax(logits, -1).to(torch.int32)
    toks, _ = M.multi_step_decode(params, cfg, first, cache, CHAT_TOKENS - 1, None, "int4g32",
                                  torch.bfloat16, rt)
    out = [int(first[0])] + toks[0].tolist()
    del cache
    plain = TorchRuntimeConfig(use_kernels=False, use_flash_attention=True, cuda_graphs=False)
    gaps = greedy_gaps(torch, params, cfg, [SimpleNamespace(generated=out)],
                       [(ids, dict(temperature=0.0))], cache_len=CACHE_LEN, kv_dtype=fp8,
                       rt=plain)
    require(gaps["f32"][0] <= GREEDY_GAP_TOL and gaps["f32"][1] > GREEDY_GAP_TOL,
            f"int4g32 fp8: greedy gap {gaps['f32'][0]} against the plain path over the fp8 "
            f"cache (shifted control {gaps['f32'][1]})")
    drift = fp8_logit_drift(torch, params, cfg, ids, rt)
    require(drift <= FP8_REL_TOL, f"int4g32 fp8: logits {drift} from the bf16 cache's")
    tok_ms = {"bf16": [], "fp8": []}
    for turn, d in (("bf16", bf16_decoder), ("fp8", dec), ("fp8", dec), ("bf16", bf16_decoder)):
        tok_ms[turn].append(run_generate(d, prompt)[2])
    log(f"  int4g32 fp8 cache: GLMDecoder.generate captured = eager ({len(out)} tokens): "
        f"{final[:60]!r}; greedy gap f32 against the plain path over the fp8 cache "
        f"{gaps['f32'][0]:.4e} (shifted control {gaps['f32'][1]:.3e}); the first decode step's "
        f"max|dlogits| / max|logits| against the bf16 cache {drift:.4e} (limit {FP8_REL_TOL})")
    log(f"  int4g32 GLMDecoder ms a token in turns: bf16 cache {tok_ms['bf16'][0]:.3f}, fp8 "
        f"{tok_ms['fp8'][0]:.3f} / {tok_ms['fp8'][1]:.3f}, bf16 {tok_ms['bf16'][1]:.3f}  [{smi}]")
    log(f"  int4g32 fp8 launch counts of the generate run: "
        f"{json.dumps({k: v for k, v in counts.items() if v})}")
    del dec, dec_eager
    return counts, {"gaps": gaps, "logit_drift_vs_bf16": drift, "ms_per_token_turns": tok_ms,
                    "replays": step.replays, "text": final[:80]}


def engines_fp8(torch, smi, params, cfg, load, a_reqs, b_reqs, short, seed):
    """Phase 6 over an fp8 pool: (a8) (a)'s engine (chunked admission, the
    prefix cache, the top-p row) and (b8) in-loop speculation (k = 8) with
    chunked admission, whose verify steps read the pool through B11.  Each:
    budgets, page accounting, the fp8 forms launched (B3 / B4 never), every
    greedy token within GREEDY_GAP_TOL of the dense ``prefill_chunk`` over an
    fp8 cache, tok/s and the busy share of a decode-only step."""
    from chatglm_q_tpu_torch import TorchRuntimeConfig
    from chatglm_q_tpu_torch.serving import PagedServingEngine

    fp8 = torch.float8_e4m3fn
    rt = TorchRuntimeConfig()
    out, counts = {}, {}
    makers = {
        "a8": lambda: PagedServingEngine(load, params, num_pages=POOL_PAGES, page_size=PAGE,
                                         prefill_chunk_size=PAGE, prefix_cache=True, rt=rt,
                                         seed=seed + 3, kv_dtype=fp8, **ENGINE_KW),
        "b8": lambda: PagedServingEngine(load, params, num_pages=POOL_PAGES, page_size=PAGE,
                                         prefill_chunk_size=PAGE, speculative_k=8,
                                         speculative_ngram=3, rt=rt, kv_dtype=fp8, **ENGINE_KW)}
    names = {"a8": "(a8) paged, chunked + prefix cache, fp8 pool",
             "b8": "(b8) paged, chunked, speculative k=8, fp8 pool"}
    for run, reqs in (("a8", a_reqs), ("b8", b_reqs)):
        eng = makers[run]()
        require(eng.cache.k_pool.dtype == fp8, f"({run}) the pool is {eng.cache.k_pool.dtype}")
        done, res = drive(torch, eng, reqs, names[run])
        require(eng.pages_in_use == 0, f"({run}): {eng.pages_in_use} pages in use after the drain")
        if run == "a8":
            require(eng.stats["prefix_hits"] > 0, "(a8): no prefix hit")
            eng.clear_prefix_cache()
            require(len(eng._free_pages) == POOL_PAGES - 1,
                    f"(a8): {len(eng._free_pages)} pages free after clearing the prefix cache")
        c = res["launches"]
        # (b8)'s every decode chunk verifies: B11, no B9 append
        want = (("rope_kv_append", "flash_attention_decode_paged", "flash_attention_prefill_chunk")
                if run == "a8" else ("flash_attention_chunk_paged", "flash_attention_prefill_chunk"))
        for kern in want:
            require(c[kern + "_fp8"] > 0 and c[kern + "_fp8"] == c[kern],
                    f"({run}): {kern} launched {c[kern]} times, {c[kern + '_fp8']} in fp8")
        require(c["kv_cache_write_idx"] == 0 and c["flash_attention_decode"] == 0,
                f"({run}) launched B3/B4")
        if run == "b8":
            require(eng.stats["spec_accepted"] > 0, "(b8): no drafted token accepted")
        busy_reqs = short if run == "a8" else [(p, {**kw, "max_new_tokens": 256})
                                               for p, kw in reqs]
        res["busy"] = chunk_busy(torch, eng, busy_reqs, f"({run})")
        del eng
        res["gaps"] = greedy_gaps(torch, params, cfg, done, reqs, kv_dtype=fp8)
        g = res["gaps"]["f32"]
        require(g[0] <= GREEDY_GAP_TOL and g[1] > GREEDY_GAP_TOL,
                f"({run}): greedy gap {g[0]} against the dense fp8-cache prefill_chunk "
                f"(shifted control {g[1]})")
        log(f"    ({run}) greedy gap f32 {g[0]:.4e} (shifted control {g[1]:.3e}); "
            f"{res['tok_per_s']:.1f} tok/s, busy share of a decode-only step "
            f"{100 * res['busy']['busy_share']:.1f}%; spec accepted "
            f"{res['stats'].get('spec_accepted')}  [{smi}]")
        out[run] = res
        for k, v in c.items():
            counts[k] = counts.get(k, 0) + v
    return counts, out


def long_context_fp8(torch, smi, params, cfg):
    """A decode step at long context: int4g32, 28 layers, batch 32 over an
    8192-slot cache at lengths near 8000, K/V random and written through
    the store (no 8K prefill: only time is read).  The captured step timed
    with a bf16 cache, an fp8 cache and an fp8 cache under
    ``decode_attn_v2`` (B12), in turns in this process; each step's traced
    device ms and the decode attention's share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile

    from chatglm_q_tpu_torch import TorchRuntimeConfig, ops
    from chatglm_q_tpu_torch.models import chatglm2 as M
    from chatglm_q_tpu_torch.ops import attention as A

    B, T, steps = LONG_BATCH, LONG_T, 8
    gen = torch.Generator(device="cuda").manual_seed(23)
    lengths = (LONG_T - 200 + torch.randint(0, 64, (B,), device="cuda", generator=gen)
               ).to(torch.int32)
    ids = torch.randint(3, 65000, (B,), device="cuda", generator=gen).to(torch.int32)
    fp8, bf = torch.float8_e4m3fn, torch.bfloat16
    caches = {}
    for dt in (bf, fp8):
        c = M.init_kv_cache(cfg, B, T, dt)
        for t in (c.k, c.v):
            for layer in range(cfg.num_layers):
                A.kv_put(t[layer], (slice(None),), torch.randn(t.shape[1:], device="cuda",
                                                               generator=gen, dtype=bf))
        caches[dt] = c
    torch.cuda.synchronize()
    kinds = {"bf16": (bf, TorchRuntimeConfig()), "fp8": (fp8, TorchRuntimeConfig()),
             "fp8 decode_attn_v2": (fp8, TorchRuntimeConfig(decode_attn_v2=True))}
    progs = {}
    for name, (dt, rt) in kinds.items():
        c = caches[dt]
        prog = M.decode_program(params, cfg, c, "int4g32", bf, rt)
        progs[name] = prog
        prog.load(ids=ids, lengths=lengths)
        ops.reset_launch_counts()
        prog.run(3, params, c.k, c.v)  # the warm-up step, the capture, a replay
        torch.cuda.synchronize()
        require(prog.graph is not None, f"long context {name}: the step was not captured")

    def timed(name):
        dt = kinds[name][0]
        prog = progs[name]
        prog.load(ids=ids, lengths=lengths)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prog.run(steps, params, caches[dt].k, caches[dt].v)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / steps

    order = ["bf16", "fp8", "fp8 decode_attn_v2", "fp8 decode_attn_v2", "fp8", "bf16"]
    turns = {k: [] for k in kinds}
    for name in order:
        turns[name].append(timed(name))
    res, counts = {"turns_ms_per_step": turns}, {}
    for name in kinds:
        dt = kinds[name][0]
        prog = progs[name]
        prog.load(ids=ids, lengths=lengths)
        ops.reset_launch_counts()
        with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            prog.run(steps, params, caches[dt].k, caches[dt].v)
            torch.cuda.synchronize()
        counts[name] = ops.launch_counts()
        ev = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
        dev = sum(e.self_device_time_total for e in ev) / 1e3 / steps
        attn = sum(e.self_device_time_total for e in ev if "decode_attn_kernel" in e.key) \
            / 1e3 / steps
        res[name] = {"device_ms_per_step": dev, "decode_attn_ms_per_step": attn,
                     "decode_attn_share": attn / dev}
    n_rows = int((lengths.long() + 1).sum())
    att_bytes = {bf: n_rows * cfg.num_multi_query_groups * cfg.head_hidden_size * 2 * 2,
                 fp8: n_rows * cfg.num_multi_query_groups * cfg.head_hidden_size * 2}
    for name in kinds:
        nb = att_bytes[kinds[name][0]] * cfg.num_layers
        res[name]["attention_bytes_per_step"] = nb
        res[name]["attention_bound_ms"] = nb / PEAK_HBM_BYTES_PER_S * 1e3
        log(f"  long context ({name} cache): batch {B}, {T}-slot cache, lengths "
            f"{int(lengths.min())}-{int(lengths.max())}, 28 layers: captured step "
            + " / ".join(f"{x:.3f}" for x in turns[name]) + " ms (host, in turns); traced "
            f"device {res[name]['device_ms_per_step']:.3f} ms a step, decode_attn_kernel "
            f"{res[name]['decode_attn_ms_per_step']:.3f} ms "
            f"({100 * res[name]['decode_attn_share']:.1f}%; its K/V bytes at the HBM rate "
            f"{res[name]['attention_bound_ms']:.3f} ms)  [{smi}]")
    req = {"fp8": "flash_attention_decode_fp8", "fp8 decode_attn_v2": "flash_attention_decode_v2_fp8"}
    for name, kern in req.items():
        require(counts[name][kern] == cfg.num_layers * steps,
                f"long context {name}: {kern} launched {counts[name][kern]} times")
    res["cache_bytes"] = {str(dt): caches[dt].k.numel() * caches[dt].k.element_size() * 2
                          for dt in caches}
    del caches, progs
    torch.cuda.empty_cache()
    return counts, res


# phase 8's runs over another cache or activation dtype: (run, its base
# run's kernels, the launch form, the cache dtype's name, the activations')
SHARDED_FORM_RUNS = (("a8", "a", "fp8", "float8_e4m3fn", "bfloat16"),
                     ("b8", "b", "fp8", "float8_e4m3fn", "bfloat16"),
                     ("a32", "a", "f32", "float32", "float32"),
                     ("b32", "b", "f32", "float32", "float32"),
                     ("a32f8", "a", "fp8_f32", "float8_e4m3fn", "float32"),
                     ("b32f8", "b", "fp8_f32", "float8_e4m3fn", "float32"))


def sharded_form_checks(torch, params, cfg, ranks, prompts, smi, backend, tp, out):
    """Phase 8's runs over an fp8 cache and in f32 (``SHARDED_FORM_RUNS``):
    (a8) / (a32) / (a32f8) the T-sharded cache (K3 writes, K1 over each
    shard, the merge) and (b8) / (b32) / (b32f8) the model-sharded pool (K3,
    K2), all with chunked admission, 16 tokens a request (the f32 runs on
    48-80-token prompts).  The ranks token-equal, every request within its
    budget, K1 / K2 and K3 once a layer a decode step on every rank and all
    of them in the run's form, the unsharded forms never, no page in use
    after a paged drain; every greedy token within GREEDY_GAP_TOL of the
    single-device dense ``prefill_chunk`` with the run's activations and
    cache dtype, the shifted stream not.  Returns the forms' launches on
    rank 0."""
    from types import SimpleNamespace

    counts = {}
    for run, base, form, kv_name, act_name in (r for r in SHARDED_FORM_RUNS if r[0] in prompts):
        reqs, r0 = prompts[run], ranks[0][run]
        require(all(r[run]["tokens"] == r0["tokens"] for r in ranks),
                f"phase 8 ({run}): the ranks' tokens differ")
        require(len(r0["tokens"]) == len(reqs) and all(
            0 < len(t) <= kw["max_new_tokens"] for t, (_, kw) in zip(r0["tokens"], reqs)),
            f"phase 8 ({run}): unfinished or over budget: {[len(t) for t in r0['tokens']]}")
        for i, r in enumerate(ranks):
            c, steps = r[run]["counts"], r[run]["decode_steps"]
            for kern in SHARDED_DECODE[base]:
                require(c[kern] == cfg.num_layers * steps and c[f"{kern}_{form}"] == c[kern],
                        f"phase 8 ({run}) rank {i}: {kern} launched {c[kern]} times "
                        f"({c[f'{kern}_{form}']} {form}) in {steps} decode steps")
            bad = {k: c[k] for k in UNSHARDED_DECODE if c[k]}
            require(not bad, f"phase 8 ({run}) rank {i}: launched unsharded decode forms {bad}")
            require(r[run].get("pages_in_use", 0) == 0,
                    f"phase 8 ({run}) rank {i}: pages in use after the drain")
            if act_name == "float32":  # the shards' linears through B1's f32 forms
                require(c["int4g32_gemv"] == 0 and c["int4g32_splitk_f32"] > 0
                        and all(c[f"{k}_f32"] == c[k] for k in ("int4g32_splitk", "int4g32_mma")),
                        f"phase 8 ({run}) rank {i}: B1 launched {c['int4g32_splitk']} split-K "
                        f"({c['int4g32_splitk_f32']} f32), {c['int4g32_mma']} Hopper "
                        f"({c['int4g32_mma_f32']} f32), {c['int4g32_gemv']} gemv")
        done = [SimpleNamespace(generated=t) for t in r0["tokens"]]
        gaps = greedy_gaps(torch, params, cfg, done, reqs,
                           cache_len=max(len(p) for p, _ in reqs) + SHARD_FP8_TOKENS,
                           kv_dtype=getattr(torch, kv_name), dtype=getattr(torch, act_name))
        require(gaps["f32"][0] <= GREEDY_GAP_TOL and gaps["f32"][1] > GREEDY_GAP_TOL,
                f"phase 8 ({run}): greedy gap {gaps['f32'][0]} against the {form} reference "
                f"(shifted control {gaps['f32'][1]})")
        per_step = {k: r0["counts"][f"{k}_{form}"] / r0["decode_steps"]
                    for k in SHARDED_DECODE[base]}
        out[run] = {"gaps": gaps, "decode_steps": r0["decode_steps"],
                    f"launches_per_decode_step_{form}": per_step,
                    "wall_s": [r[run]["wall_s"] for r in ranks],
                    "decode_ms_per_step_median": [r[run]["decode_ms_per_step_median"]
                                                  for r in ranks],
                    "counts": {k: v for k, v in r0["counts"].items() if v}, "stats": r0["stats"]}
        log(f"  ({run}) {act_name} over a {kv_name} {'cache' if base == 'a' else 'pool'}: "
            f"{len(reqs)} requests, {sum(len(t) for t in r0['tokens'])} tokens on {tp} ranks "
            f"({backend}) in {out[run]['wall_s'][0]:.1f} s, ranks token-equal; {form} launches a "
            f"decode step {json.dumps(per_step)}; greedy gap f32 {gaps['f32'][0]:.4e} against "
            f"the {form} reference, shifted control {gaps['f32'][1]:.3e}  [{smi}]")
        for k in SHARDED_DECODE[base]:
            name = k + (" paged" if base == "b" and k == "rope_kv_append_sharded" else "")
            counts[f"{name} {form}"] = r0["counts"][f"{k}_{form}"]
        if act_name == "float32":
            for k in ("int4g32_splitk", "int4g32_mma", "split_bf16x3_pass"):
                key = k if k == "split_bf16x3_pass" else f"{k} f32"
                counts[key] = counts.get(key, 0) + r0["counts"][k if k == key else f"{k}_f32"]
    return counts


LONG_BATCH, LONG_T = 32, 8192  # the long-context step: batch 32 over an 8192-slot cache


def fp8_slice(torch, smi):
    """``--fp8``: phase 2's fp8 rows and the fp8 runs of phases 5, 6 and 8
    and the long-context step, on their own."""
    from chatglm_q_tpu_torch import ChatGLM2Config, GLMLoadConfig, TorchRuntimeConfig
    from chatglm_q_tpu_torch.bench import random_quantized_params
    from chatglm_q_tpu_torch.serving import GLMDecoder, chat_template

    rows = check_fp8_attention(torch)
    cfg = ChatGLM2Config()
    params = random_quantized_params(cfg, "int4g32", torch.Generator(device="cuda").manual_seed(41))
    tokenizer = chat_tokenizer()
    prompt = chat_template([], CHAT_QUESTION)
    ids = tokenizer.encode(prompt)
    load = GLMLoadConfig(model_config=cfg, quant_type="int4g32", torch_dtype="bfloat16")
    decoder = GLMDecoder(load, params, tokenizer, max_sequence_length=CACHE_LEN,
                         rt=TorchRuntimeConfig())
    run_generate(decoder, prompt)  # its programs captured before the turns
    chat_counts, chat = chat_fp8(torch, smi, params, cfg, tokenizer, prompt, ids, decoder)
    del decoder
    a_reqs, b_reqs = engine_prompts(torch, 61)
    short = [(p[:128], {**kw, "temperature": 0.0, "max_new_tokens": 256})
             for p, kw in a_reqs[:4]]
    engine_counts, engines = engines_fp8(torch, smi, params, cfg, load, a_reqs, b_reqs, short, 61)
    long_counts, long = long_context_fp8(torch, smi, params, cfg)
    del params
    torch.cuda.empty_cache()
    sharded_counts, sharded = sharded_slice(torch, smi, runs=("a8", "b8"))
    return {"rows": rows, "chat": chat, "engines": engines, "long_context": long,
            "sharded": sharded,
            "counts": {"chat": {k: v for k, v in chat_counts.items() if v},
                       "engines": {k: v for k, v in engine_counts.items() if v},
                       "sharded": sharded_counts,
                       "long_context": {k: {n: v for n, v in c.items() if v}
                                        for k, c in long_counts.items()}}}


# ---------------------------------------------------------------------------
# float16 activations: phase 2's f16 rows, the f16 runs of phases 5 and 6,
# and the float16-checkpoint launcher run (``--fp16`` runs them alone)
# ---------------------------------------------------------------------------

# Phase 2's f16 limits, each 1.5x the largest reading over the seeds of
# ``--fp16-seeds`` (F16_SURVEY_SEEDS) on an H100 80GB HBM3 at 700 W.  An f16
# output against its plain version, max|Δ| / max|plain|: one f16 rounding
# (2^-11) apart where both sum exact products in another order; largest
# 7.01e-4 (B6's wgmma at M = 512).  The matmuls are also held to SUM_TOL
# beyond half an f16 ulp of their exact value (largest 5.24e-8).
F16_KERNEL_TOL = 1.05e-3
# The error beyond the output's f16 rounding of the kernel's function in
# f32, each with its control, the same function with p rounded to bf16,
# which must land above the limit: B4 (p rounded to f16, v's dtype, per
# tile where the function rounds it per row: largest 3.31e-5, control
# 2.16e-4), B12 and B10 (p in f32 through PV as two f16 fragments: 4.49e-8
# and 7.86e-8, controls 1.86e-4 and 1.85e-4), B11 at S = 9 (1.21e-7,
# control 8.92e-4).
F16_B4_TOL = 5e-5
F16_B12_TOL = 6.8e-8
F16_B10_TOL = 1.2e-7
F16_B11_TOL = 1.8e-7
F16_SEED = 17
F16_SURVEY_SEEDS = (17, 27, 37)
# phase 2's f16 rows of B1 (split-K at decode and the verify step's 36
# rows, wgmma at a 4 x 128 prefill) and of B6 (split-K, wgmma)
F16_MATMUL_M = {"int4g32": (1, 4, 36, 512), "int8": (1, 4, 512)}


def f16_matmul_rows(torch, seed, hold):
    """B1 and B6 in f16 at F16_MATMUL_M on the six linears: one launch of
    the route's kernel counted in its f16 form, within F16_KERNEL_TOL of the
    plain version and within SUM_TOL of sum|terms| beyond half an f16 ulp
    of the exact value; timed beside the same kernel on the rows in bf16,
    the plain version and the library call where this torch has one in f16.
    ``hold`` False: the readings only, untimed (``--fp16-seeds``)."""
    from chatglm_q_tpu_torch.ops import int8_matmul as I8
    from chatglm_q_tpu_torch.ops import quant_matmul as QM
    from chatglm_q_tpu_torch.ops.quant import unpack_int4_tpu
    from chatglm_q_tpu_torch.utils.timing import cuda_event_ms

    f16, bf = torch.float16, torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(seed)
    rows = []
    for name, K, N in MATMUL_SHAPES:
        for kind in ("int4g32", "int8"):
            if kind == "int4g32":
                wbytes = K // 2 * N + K // 32 * N * 2
                copies = weight_copies(wbytes) if hold else 1
                w = torch.randint(0, 256, (copies, K // 2, N), dtype=torch.uint8, device="cuda",
                                  generator=gen)
                scale = (torch.rand((copies, K // 32, N), device="cuda", generator=gen) * 0.02
                         ).to(bf)
                fn, plain, route = QM.int4g32_matmul, QM.int4g32_matmul_plain, QM.int4_route
                w64, s64 = unpack_int4_tpu(w[0], scale[0]).double(), 1.0
            else:
                wbytes = K * N + 4 * N
                copies = weight_copies(wbytes) if hold else 1
                w = torch.randint(-128, 128, (copies, K, N), dtype=torch.int8, device="cuda",
                                  generator=gen)
                scale = (0.5 + torch.rand((copies, N), device="cuda", generator=gen)) * 0.01
                fn, plain, route = I8.int8_matmul, I8.int8_matmul_plain, I8.int8_route
                w64, s64 = w[0].double(), scale[0].double()
            mod = QM if kind == "int4g32" else I8
            # the library call in f16: tinygemm's weights made once a shape (it
            # takes bf16 x only, so its first refusal stands for the shape)
            lib_w = library_weights(torch, w[:1], scale[:1]) if (
                hold and kind == "int4g32") else None
            for M in F16_MATMUL_M[kind]:
                x = torch.randn((M, K), device="cuda", generator=gen).to(f16)
                kernel = f"{'int4g32' if kind == 'int4g32' else 'int8'}_{route(M, N, f16)}"
                wrapper = getattr(mod, kernel)
                before = wrapper.f16.launches
                got = fn(x, w[0], scale[0])
                torch.cuda.synchronize()
                require(wrapper.f16.launches == before + 1, f"{kernel} f16 {name} M={M}: "
                                                            "not one launch of its f16 form")
                err, rel = rel_err(got, plain(x, w[0], scale[0]))
                exact = (x.double() @ w64) * s64
                terms = (x.double().abs() @ w64.abs()) * s64
                beyond = beyond_sum(torch, got, exact, terms, 11)
                del exact, terms
                require(torch.isfinite(got).all() and (not hold or (
                    rel <= F16_KERNEL_TOL and beyond <= SUM_TOL)),
                    f"{kernel} f16 {name} M={M}: rel err {rel}, beyond the f16 rounding {beyond}")
                r = {"kernel": kernel, "linear": name, "M": M, "K": K, "N": N,
                     "x_dtype": "float16", "max_abs_err": err, "rel_err": rel,
                     "beyond_sum": beyond}
                if hold:
                    xb = x.to(bf)
                    r["ms"] = cuda_event_ms(lambda i: fn(x, w[i % copies], scale[i % copies]),
                                            iters=30)
                    r["bf16_ms"] = cuda_event_ms(lambda i: fn(xb, w[i % copies],
                                                              scale[i % copies]), iters=30)
                    r["plain_ms"] = cuda_event_ms(lambda i: plain(x, w[0], scale[0]), iters=3,
                                                  warmup=1)
                    r["bound_ms"], r["bound_by"] = bound_ms(M * K * 2 + wbytes + M * N * 2,
                                                            2.0 * M * K * N)
                    want = plain(x, w[0], scale[0])
                    if kind == "int4g32":
                        r["library_ms"] = int4_library(torch, x, lib_w, want)
                        lib_w = lib_w if r["library_ms"] is not None else None
                    else:  # _weight_int8pack_mm takes 60-300 ms at M = 512: three calls
                        r["library_ms"] = int8_library(
                            torch, x, w[:1].transpose(1, 2).contiguous(), scale[:1].to(f16),
                            want, iters=30 if M <= 16 else 3)
                    log_row("f16 " + ("int4g32_matmul" if kind == "int4g32" else "int8_matmul"),
                            r)
                    log(f"    bf16 form {r['bf16_ms']:.5f} ms; beyond the f16 rounding "
                        f"{beyond:.2e} of sum|terms|")
                rows.append(r)
            del w, scale, w64
    return rows


# phase 2's f16 rows of B7 / B8 (F16_MATMUL_M of the same weights: B7 on
# the int8 weights, B8 on the int4g32 ones) and of B13 / B14 (a 1-token and
# a 16-token step's split-K kernel, a 2 x 256-token step's wgmma one)
F16_DYN_M = {"int8": F16_MATMUL_M["int8"], "int4g32": F16_MATMUL_M["int4g32"]}
F16_T_M = (1, 16, 512)


def f16_dyn_t_rows(torch, seed, hold):
    """B7 / B8 with f16 outputs and B13 / B14 on f16 g at F16_DYN_M /
    F16_T_M on the six linears: one launch of the route's kernel counted in
    its f16 form; B7 bit-equal to its plain version, B8, B13 and B14 within
    F16_KERNEL_TOL of theirs and within SUM_TOL of sum|terms| beyond half an
    f16 ulp of their exact value (B8: q·s exact; B13: f16(g · f16(s)) and the
    exact int8; B14: f16(f16(q) · f16(s))); timed beside the same kernel in
    bf16 (B7 / B8: the same s8 rows, a bf16 output), the plain version, and
    the library call where one computes the function (``_int_mm`` for B7's
    accumulator, ``_weight_int8pack_mm`` for B13).  ``hold`` False: the
    readings only, untimed (``--fp16-seeds``)."""
    from chatglm_q_tpu_torch.ops import dyn_matmul as D
    from chatglm_q_tpu_torch.ops import int8_matmul as I8
    from chatglm_q_tpu_torch.ops import quant_matmul as QM
    from chatglm_q_tpu_torch.ops.quant import unpack_int4_tpu, unpack_int4_tpu_q
    from chatglm_q_tpu_torch.utils.timing import cuda_event_ms

    f16, bf = torch.float16, torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    rows = []

    def hold_row(r, got, want, exact, terms, label, equal=False):
        err, rel = rel_err(got, want)
        beyond = beyond_sum(torch, got, exact, terms, 11)
        ok = torch.equal(got, want) if equal else (rel <= F16_KERNEL_TOL and beyond <= SUM_TOL)
        require(torch.isfinite(got).all() and (not hold or ok),
                f"{label}: rel err {rel}, beyond the f16 rounding {beyond}"
                + (", not bit-equal to plain" if equal else ""))
        r.update(max_abs_err=err, rel_err=rel, beyond_sum=beyond)

    for name, K, N in MATMUL_SHAPES:
        for kind in ("int8", "int4g32"):
            if kind == "int4g32":
                wbytes = K // 2 * N + K // 32 * N * 2
                copies = weight_copies(wbytes) if hold else 1
                w = torch.randint(0, 256, (copies, K // 2, N), dtype=torch.uint8, device="cuda",
                                  generator=gen)
                scale = (torch.rand((copies, K // 32, N), device="cuda", generator=gen) * 0.02
                         ).to(bf)
                dyn, plain_dyn, tfn, tplain = (D.int4_dyn_matmul, D.int4_dyn_matmul_plain,
                                               QM.int4g32_matmul_t, QM.int4g32_matmul_t_plain)
                w64 = unpack_int4_tpu(w[0], scale[0]).double()  # q·s, exact
                q16 = unpack_int4_tpu_q(w[0]).to(f16).reshape(K // 32, 32, N)
                wt64 = (q16 * scale[0].to(f16)[:, None]).reshape(K, N).double()  # B14's weights
                del q16
            else:
                wbytes = K * N + 4 * N
                copies = weight_copies(wbytes) if hold else 1
                w = torch.randint(-128, 128, (copies, K, N), dtype=torch.int8, device="cuda",
                                  generator=gen)
                scale = (0.5 + torch.rand((copies, N), device="cuda", generator=gen)) * 0.01
                dyn, plain_dyn, tfn, tplain = (D.int8_dyn_matmul, D.int8_dyn_matmul_plain,
                                               I8.int8_matmul_t, I8.int8_matmul_t_plain)
                w64 = wt64 = w[0].double()
            pre = "int8" if kind == "int8" else "int4"
            for M in F16_DYN_M[kind]:
                x = torch.randn((M, K), device="cuda", generator=gen).to(f16)
                kernel = f"{pre}_dyn_{'mma' if D.uses_mma(M, N) else 'splitk'}"
                kfn = getattr(D, kernel)
                before = kfn.f16.launches
                got = dyn(x, w[0], scale[0])
                torch.cuda.synchronize()
                require(kfn.f16.launches == before + 1,
                        f"{kernel} f16 {name} M={M}: not one launch of its f16 form")
                xq, sx = D.dyn_quantize_rows(x)
                if kind == "int8":
                    s64 = sx.double() * scale[0].double()
                else:
                    s64 = sx.double()
                r = {"kernel": kernel, "linear": name, "M": M, "K": K, "N": N,
                     "x_dtype": "float16"}
                hold_row(r, got, plain_dyn(x, w[0], scale[0]), (xq.double() @ w64) * s64,
                         (xq.double().abs() @ w64.abs()) * s64,
                         f"{kernel} f16 {name} M={M}", equal=kind == "int8")
                if hold:
                    r["ms"] = cuda_event_ms(lambda i: kfn(xq, sx, w[i % copies], scale[i % copies],
                                                          f16), iters=30)
                    r["bf16_ms"] = cuda_event_ms(lambda i: kfn(xq, sx, w[i % copies],
                                                               scale[i % copies], bf), iters=30)
                    r["plain_ms"] = cuda_event_ms(lambda i: plain_dyn(x, w[0], scale[0]), iters=3,
                                                  warmup=1)
                    r["bound_ms"], r["bound_by"] = bound_ms(M * K + 4 * M + wbytes + M * N * 2,
                                                            2.0 * M * K * N, PEAK_INT8_OPS)
                    r["library_ms"] = (int_mm_library(torch, xq, w, D.int8_dyn_acc_plain(xq, w[0]))
                                       if kind == "int8" else None)
                    log_row(f"f16 {pre}_dyn_matmul", {**r, "kernel": kernel + " f16"})
                    log(f"    bf16 form {r['bf16_ms']:.5f} ms; beyond the f16 rounding "
                        f"{r['beyond_sum']:.2e} of sum|terms|")
                rows.append(r)
            for M in F16_T_M:
                g = torch.randn((M, N), device="cuda", generator=gen).to(f16)
                kernel = ("int8_t_" if kind == "int8" else "int4g32_t_") + QM.t_route(M, N, f16)
                mod = I8 if kind == "int8" else QM
                kfn = getattr(mod, kernel)
                before = kfn.f16.launches
                got = tfn(g, w[0], scale[0])
                torch.cuda.synchronize()
                require(kfn.f16.launches == before + 1,
                        f"{kernel} f16 {name} M={M}: not one launch of its f16 form")
                gs = (g * scale[0].to(f16)).double() if kind == "int8" else g.double()
                r = {"kernel": kernel, "linear": name, "M": M, "K": K, "N": N,
                     "dtype": "float16"}
                want = tplain(g, w[0], scale[0])
                hold_row(r, got, want, gs @ wt64.T, gs.abs() @ wt64.abs().T,
                         f"{kernel} f16 {name} M={M}")
                if hold:
                    gb = g.to(bf)
                    r["ms"] = cuda_event_ms(lambda i: tfn(g, w[i % copies], scale[i % copies]),
                                            iters=30)
                    r["bf16_ms"] = cuda_event_ms(lambda i: tfn(gb, w[i % copies],
                                                               scale[i % copies]), iters=30)
                    r["plain_ms"] = cuda_event_ms(lambda i: tplain(g, w[0], scale[0]), iters=3,
                                                  warmup=1)
                    r["bound_ms"], r["bound_by"] = bound_ms(M * N * 2 + wbytes + M * K * 2,
                                                            2.0 * M * K * N)
                    # _weight_int8pack_mm takes 60-300 ms at M = 512: three calls
                    r["library_ms"] = (int8_t_library(torch, g, w, scale, want,
                                                      iters=30 if M <= 16 else 3)
                                       if kind == "int8" else None)
                    log_row(f"f16 {'int8' if kind == 'int8' else 'int4g32'}_matmul_t",
                            {**r, "kernel": kernel + " f16"})
                    log(f"    bf16 form {r['bf16_ms']:.5f} ms; beyond the f16 rounding "
                        f"{r['beyond_sum']:.2e} of sum|terms|")
                rows.append(r)
            del w, scale, w64, wt64
    return rows


def b4_f32(torch, q, k, v, lengths, sm_scale, p_dtype):
    """B4's function in f32 before the output's rounding: scores scaled in
    f32, p rounded to ``p_dtype`` (v's dtype, f16; bf16 for the control),
    l from f32 p."""
    from chatglm_q_tpu_torch.ops import attention as A

    s = torch.einsum("bghd,bgtd->bght", q.float(), k.float()) * sm_scale
    valid = torch.arange(k.shape[2], device=q.device)[None, :] <= lengths.long()[:, None]
    s = s.masked_fill(~valid[:, None, None, :], A.MASK_VALUE)
    p = torch.exp(s - s.amax(-1, keepdim=True)) * (lengths >= 0).float()[:, None, None, None]
    l = p.sum(-1, keepdim=True)
    return torch.einsum("bght,bgtd->bghd", p.to(p_dtype).float(), v.float()) / \
        torch.where(l > 0, l, 1.0)


def act_attention_rows(torch, act, seed, hold):
    """Every attention kernel's form over a cache of the activations' dtype
    ``act`` (f16, or f32: the CUDA-core forms) at the shapes of its bf16
    row: B3 / B9 with the RoPE (B = 4, dense and paged; B = 1 dense), K3
    (dense and paged) and the write-only B3 / B9, bit-equal to their plain
    versions; B4 (B = 4 and 1), B12, B5 (both forms), B10, B11 (S = 9), K1,
    K2 within F16_KERNEL_TOL (f32: F32_TOL) of theirs (K1, K2: and their (m,
    l) within LSE_TOL); in f16, B4, B12, B10 and B11 also beyond the
    output's f16 rounding of their function in f32, against the control
    with p rounded to bf16.  Timed over the 28 layers beside the bf16 form
    on the same shapes, the plain version, and SDPA in ``act``; the bounds
    count ``act``'s bytes and, in f32, the CUDA cores' f32 peak."""
    import torch.nn.functional as F

    from chatglm_q_tpu_torch.models.chatglm2 import precompute_freqs_cis
    from chatglm_q_tpu_torch.ops import attention as A
    from chatglm_q_tpu_torch.utils.timing import cuda_event_ms

    gen = torch.Generator(device="cuda").manual_seed(seed)
    bf = torch.bfloat16
    f16 = act == torch.float16
    label = "f16" if f16 else "f32"
    tol = (F16_KERNEL_TOL if hold else math.inf) if f16 else F32_TOL
    esz = 2 if f16 else 4  # bytes an activation or cache element
    att_peak = PEAK_BF16_FLOPS if f16 else PEAK_F32_FLOPS
    L, G, Hg, D = (28 if hold else 2), 2, 16, 128
    sm = 1.0 / math.sqrt(D)
    rows, controls = {}, {}

    def rnd(*shape):
        return torch.randn(shape, device="cuda", generator=gen).to(act)

    def i32(*xs):
        return torch.tensor(xs, dtype=torch.int32, device="cuda")

    def kv_read(n):  # K and V rows at ``esz`` bytes an element
        return n * G * D * esz * 2

    def row(key, fn, plain_fn, nbytes, ops, lib_fn, shape, exact=False, plain_iters=5,
            peak=att_peak, plain_syncs=False):
        """fn(i, dtype): the kernel over layer i in ``act`` (or bf16 for the
        bf16 form's time); plain_fn(): the plain version on layer 0.  In f32
        the library call is timed on the host's clock, synchronized: SDPA's
        f32 path outlasts the event timer's hold while it is enqueued."""
        got = fn(0, act)
        torch.cuda.synchronize()
        want = plain_fn()
        if exact:
            g, w_ = (got, want) if not isinstance(got, tuple) else (got[0], want[0])
            require(torch.equal(g, w_), f"{key}: differs from its plain version")
            err = rel = 0.0
        elif isinstance(got, tuple):
            err, rel, _, _ = hold_lse(torch, key, got, want, label, tol=tol)
        else:
            err, rel = rel_err(got, want)
            require(torch.isfinite(got.float()).all() and rel <= tol, f"{key} rel err {rel}")
        r = {"max_abs_err": err, "rel_err": rel, "shape": shape, "bit_equal_to_plain": exact}
        if hold:
            r["ms"] = cuda_event_ms(lambda i: fn(i, act), iters=56)
            r["bf16_ms"] = cuda_event_ms(lambda i: fn(i, bf), iters=56)
            r["plain_ms"] = (synced_ms(torch, lambda i: plain_fn(), plain_iters) if plain_syncs
                             else cuda_event_ms(lambda i: plain_fn(), iters=plain_iters))
            r["library_ms"] = (None if lib_fn is None else cuda_event_ms(lib_fn, iters=56)
                               if f16 else synced_ms(torch, lib_fn, 8))
            r["bound_ms"], r["bound_by"] = bound_ms(nbytes, ops, peak)
        rows[key] = r
        return got

    # the dense cache of phase 2's B4 row: (L, 4, G, 1024, D), in act and bf16
    B, T = len(PROMPT_LENGTHS), CACHE_LEN
    kc, vc = rnd(L, B, G, T, D), rnd(L, B, G, T, D)
    caches = {act: (kc, vc), bf: (kc.to(bf), vc.to(bf))}
    q = rnd(B, G, Hg, D)
    qs = {act: q, bf: q.to(bf)}
    lens = i32(1000, 600, 200, 0)
    n = [min(int(x) + 1, T) for x in lens.tolist()]
    mask = (torch.arange(T, device="cuda")[None, :] <= lens[:, None])[:, None, None, :]

    def lib_decode(qq, kk, vv, mm):
        return lambda i: F.scaled_dot_product_attention(
            qq.reshape(qq.shape[0], G * Hg, 1, D), kk[i % L], vv[i % L], attn_mask=mm, scale=sm,
            enable_gqa=True)

    for key, fn, plain in (("flash_attention_decode", A.flash_attention_decode,
                            A.flash_attention_decode_plain),
                           ("flash_attention_decode_v2", A.flash_attention_decode_v2,
                            A.flash_attention_decode_v2_plain)):
        got = row(f"{key} {label}",
                  lambda i, dt, fn=fn: fn(qs[dt], caches[dt][0][i % L], caches[dt][1][i % L],
                                          lens, sm),
                  lambda plain=plain: plain(q, kc[0], vc[0], lens, sm),
                  2 * q.numel() * esz + kv_read(sum(n)) + B * 4, 4.0 * sum(n) * G * Hg * D,
                  lib_decode(q, kc, vc, mask),
                  f"B={B} G={G} Hg={Hg} D={D} T={T} lengths={lens.tolist()} {label} cache")
        if not f16:
            continue
        if key == "flash_attention_decode":
            want32 = b4_f32(torch, q, kc[0], vc[0], lens, sm, act)
            control = b4_f32(torch, q, kc[0], vc[0], lens, sm, bf)
            controls[key + " f16"] = hold_beyond(torch, key + " f16", got, want32, control,
                                                 F16_B4_TOL, "main shape", hold)
        else:
            controls[key + " f16"] = hold_beyond(
                torch, key + " f16", got, decode_v2_f32(torch, q, kc[0], vc[0], lens, sm),
                decode_v2_f32(torch, q, kc[0], vc[0], lens, sm, p_bf16=True), F16_B12_TOL,
                "main shape", hold)
    q1, l1 = q[:1].contiguous(), i32(140)
    q1s = {act: q1, bf: q1.to(bf)}
    row(f"flash_attention_decode B=1 {label}",
        lambda i, dt: A.flash_attention_decode(q1s[dt], caches[dt][0][i % L][:1],
                                               caches[dt][1][i % L][:1], l1, sm),
        lambda: A.flash_attention_decode_plain(q1, kc[0][:1], vc[0][:1], l1, sm),
        2 * q1.numel() * esz + kv_read(141) + 4, 4.0 * 141 * G * Hg * D,
        lambda i: F.scaled_dot_product_attention(
            q1.reshape(1, G * Hg, 1, D), kc[i % L][:1], vc[i % L][:1],
            attn_mask=(torch.arange(T, device="cuda") <= 140)[None, None, None, :], scale=sm,
            enable_gqa=True),
        f"B=1 G={G} Hg={Hg} D={D} T={T} lengths=[140] {label} cache")

    # B5, whole prompts over the same cache
    S = max(PROMPT_LENGTHS)
    qp = rnd(B, S, G, Hg, D)
    qps = {act: qp, bf: qp.to(bf)}
    lp = i32(*PROMPT_LENGTHS)
    pos = torch.arange(S, device="cuda")
    pmask = ((pos[None, :] <= pos[:, None])[None] & (pos[None, None, :] < lp[:, None, None]))
    qsp = qp.permute(0, 2, 3, 1, 4).reshape(B, G * Hg, S, D)
    pairs = sum(min(s + 1, lb) for lb in PROMPT_LENGTHS for s in range(S))
    row(f"flash_attention_prefill {label}",
        lambda i, dt: A.flash_attention_prefill(qps[dt], caches[dt][0][i % L],
                                                caches[dt][1][i % L], lp, sm),
        lambda: A.flash_attention_prefill_plain(qp, kc[0], vc[0], lp, sm),
        2 * qp.numel() * esz + kv_read(sum(min(S, lb) for lb in PROMPT_LENGTHS)) + B * 4,
        4.0 * pairs * G * Hg * D,
        lambda i: F.scaled_dot_product_attention(
            qsp, kc[i % L][:, :, :S], vc[i % L][:, :, :S], attn_mask=pmask[:, None], scale=sm,
            enable_gqa=True),
        f"B={B} S={S} G={G} Hg={Hg} D={D} lengths={list(PROMPT_LENGTHS)} {label} cache")

    # B3 with the RoPE, and K3 on shard 1 of a 2048-slot cache, bit-equal
    table = torch.from_numpy(precompute_freqs_cis(D, 2049)).to("cuda")
    fr = table[torch.tensor([5, 700, 1500, 2048], device="cuda")]
    kv = rnd(B, 2 * G * D)

    def append_row(key, kk, vv, pt, st, shard=None):
        Bq = st.shape[0]
        ins = {dt: (q[:Bq].to(dt).contiguous(), kv[:Bq].to(dt), fr[:Bq].to(dt))
               for dt in (act, bf)}
        ab = {act: (kk, vv), bf: (kk.to(bf), vv.to(bf))}
        kr, vr = kk.clone(), vv.clone()

        def run(i, dt):
            if shard is None:
                return A.rope_kv_append(*ins[dt], *ab[dt], i % L, st, pt)
            return A.rope_kv_append_sharded(*ins[dt], *ab[dt], i % L, st, shard, pt)

        def plain():
            if shard is None:
                return A.rope_kv_append_plain(*ins[act], kr, vr, 0, st, pt)
            return A.rope_kv_append_sharded_plain(*ins[act], kr, vr, 0, st, shard, pt)

        nbytes = Bq * (2 * q[0].numel() * esz + kv[0].numel() * esz + D * esz
                       + 2 * G * D * esz + 4) + (0 if pt is None else Bq * 4)
        row(key, run, plain, nbytes, 6.0 * Bq * (G * Hg + G) * D / 2, None,
            f"q (B={Bq}, G={G}, Hg={Hg}, D={D}), {label} "
            + (f"cache (L={L}, B={kk.shape[1]}, G={G}, T={kk.shape[3]}, D={D})" if pt is None
               else f"pool (L={L}, NP={kk.shape[1]}, G={G}, P={kk.shape[3]}, D={D}), "
                    f"MP={pt.shape[1]}") + f", starts {st.tolist()}"
            + ("" if shard is None else f", {shard}"),
            exact=True, plain_iters=14, peak=PEAK_F32_FLOPS, plain_syncs=shard is not None)
        require(torch.equal(kk[0], kr[0]) and torch.equal(vv[0], vr[0]),
                f"{key}: the cache differs from the plain version's")

    def write_row(key, dst, pt, st):
        """The write-only B3 (``pt`` None) / B9 form: (B, G, D) into the slot."""
        Bq = st.shape[0]
        new = rnd(Bq, G, D)
        ab = {act: dst, bf: dst.to(bf)}
        ref = dst.clone()

        def run(i, dt):
            if pt is None:
                return A.kv_cache_write_idx(ab[dt], new.to(dt), i % L, st)
            return A.kv_pool_write_idx(ab[dt], new.to(dt), i % L, pt, st)

        def plain():
            if pt is None:
                return A.kv_cache_write_idx_plain(ref, new, 0, st)
            return A.kv_pool_write_idx_plain(ref, new, 0, pt, st)

        ar, slot = torch.arange(Bq, device="cuda"), st.long().clamp(0, T - 1)

        def lib(i):  # index_put_ of the dense cache's slots
            dst[i % L][ar, :, slot] = new

        row(key, run, plain, Bq * (2 * G * D * esz + 4) + (0 if pt is None else Bq * 4), 0.0,
            lib if pt is None else None,
            f"new (B={Bq}, G={G}, D={D}) into a {label} "
            + ("cache" if pt is None else "pool") + f", starts {st.tolist()}", exact=True,
            plain_iters=14, peak=PEAK_F32_FLOPS)

    append_row(f"rope_kv_append {label}", kc, vc, None, i32(T - 1, T, T + 5, 2))
    append_row(f"rope_kv_append B=1 {label}", kc[:, :1].contiguous(), vc[:, :1].contiguous(),
               None, i32(140))
    append_row(f"rope_kv_append_sharded {label}", kc, vc, None, i32(100, T - 1, T + 7, 2 * T + 3),
               A.KVShard(offset=T, total=2 * T))
    write_row(f"kv_cache_write_idx {label}", kc, None, i32(T - 1, T, T + 5, 2))
    del caches

    # B5's chunked form: 4 compact rows x 256 against a 2048-slot cache
    Sc = 256
    cc, dc = rnd(L, B, G, SEQ, D), rnd(L, B, G, SEQ, D)
    ccs = {act: (cc, dc), bf: (cc.to(bf), dc.to(bf))}
    qc = rnd(B, Sc, G, Hg, D)
    qcs = {act: qc, bf: qc.to(bf)}
    cstarts = i32(768, 512, 256, 0)
    clens = cstarts + i32(256, 256, 200, 256)
    rmap = i32(2, 0, 3, 1)
    qpos = cstarts.long()[:, None] + torch.arange(Sc, device="cuda")[None, :]
    cols = torch.arange(SEQ, device="cuda")[None, None, :]
    cmask = (cols <= qpos[:, :, None]) & (cols < clens.long()[:, None, None])
    kv_rows = sum(min(int(ln), int(st) + Sc) for st, ln in zip(cstarts.tolist(), clens.tolist()))
    cpairs = sum(min(st + t + 1, ln) for st, ln in zip(cstarts.tolist(), clens.tolist())
                 for t in range(Sc))
    row(f"flash_attention_prefill_chunk {label}",
        lambda i, dt: A.flash_attention_prefill_chunk(qcs[dt], ccs[dt][0][i % L],
                                                      ccs[dt][1][i % L], clens, cstarts, sm,
                                                      rmap),
        lambda: A.flash_attention_prefill_plain(qc, cc[0], dc[0], clens, sm, cstarts, rmap),
        2 * qc.numel() * esz + kv_read(kv_rows) + 3 * B * 4, 4.0 * cpairs * G * Hg * D,
        lambda i: F.scaled_dot_product_attention(
            qc.permute(0, 2, 3, 1, 4).reshape(B, G * Hg, Sc, D), cc[i % L][rmap.long()],
            dc[i % L][rmap.long()], attn_mask=cmask[:, None], scale=sm, enable_gqa=True),
        f"B={B} Sc={Sc} G={G} Hg={Hg} D={D} T={SEQ} starts={cstarts.tolist()} "
        f"lengths={clens.tolist()} kv_row_map={rmap.tolist()} {label} cache")
    del ccs, cc, dc

    # K1 on shard 0 of phase 8's 8192-slot cache (4096 a rank)
    Tl = SHARD_T // SHARD_TP
    sk, sv = rnd(L, B, G, Tl, D), rnd(L, B, G, Tl, D)
    sks = {act: (sk, sv), bf: (sk.to(bf), sv.to(bf))}
    slen = i32(*SHARD_LENGTHS)
    sn = [max(0, min(int(x) + 1, Tl)) for x in SHARD_LENGTHS]
    smask = (torch.arange(Tl, device="cuda")[None, :] <= slen[:, None])[:, None, None, :]
    row(f"flash_attention_decode_lse {label}",
        lambda i, dt: A.flash_attention_decode_lse(qs[dt], sks[dt][0][i % L], sks[dt][1][i % L],
                                                   slen, sm, 0),
        lambda: A.flash_attention_decode_lse_plain(q, sk[0], sv[0], slen, sm, 0),
        2 * q.numel() * esz + kv_read(sum(sn)) + B * 4 + 2 * B * G * Hg * 4,
        4.0 * sum(sn) * G * Hg * D, lib_decode(q, sk, sv, smask),
        f"B={B} G={G} Hg={Hg} D={D} shard 0 of T={SHARD_T} (T_local={Tl}) "
        f"lengths={list(SHARD_LENGTHS)} {label} cache")
    del sks, sk, sv

    # the pool of phase 2's paged rows: (L, 64, G, 256, D), 2048-slot rows
    MP = SEQ // PAGE
    kp, vp = rnd(L, POOL_PAGES, G, PAGE, D), rnd(L, POOL_PAGES, G, PAGE, D)
    pools = {act: (kp, vp), bf: (kp.to(bf), vp.to(bf))}
    pt = (torch.randperm(POOL_PAGES - 1, device="cuda", generator=gen)[: B * MP] + 1
          ).reshape(B, MP).to(torch.int32)
    plens = i32(*PAGED_LENGTHS)
    pn = [min(x + 1, MP * PAGE) for x in PAGED_LENGTHS]
    dmask = (torch.arange(MP * PAGE, device="cuda")[None, :] <= plens[:, None])[:, None, None]

    def lib_paged(qq, mm):
        def call(i):
            kd, vd = A.gather_pages(kp[i % L], pt), A.gather_pages(vp[i % L], pt)
            if qq.dim() == 4:
                qx = qq.reshape(qq.shape[0], G * Hg, 1, D)
            else:
                qx = qq.permute(0, 2, 3, 1, 4).reshape(qq.shape[0], G * Hg, qq.shape[1], D)
            return F.scaled_dot_product_attention(qx, kd, vd, attn_mask=mm, scale=sm,
                                                  enable_gqa=True)
        return call

    got = row(f"flash_attention_decode_paged {label}",
              lambda i, dt: A.flash_attention_decode_paged(qs[dt], *pools[dt], i % L, pt, plens,
                                                           sm),
              lambda: A.flash_attention_decode_paged_plain(q, kp, vp, 0, pt, plens, sm),
              2 * q.numel() * esz + kv_read(sum(pn)) + B * MP * 4 + B * 4,
              4.0 * sum(pn) * G * Hg * D, lib_paged(q, dmask),
              f"B={B} G={G} Hg={Hg} D={D} P={PAGE} MP={MP} lengths={list(PAGED_LENGTHS)} "
              f"{label} pool")
    if f16:
        kd, vd = A.gather_pages(kp[0], pt), A.gather_pages(vp[0], pt)
        controls["flash_attention_decode_paged f16"] = hold_beyond(
            torch, "flash_attention_decode_paged f16", got,
            decode_v2_f32(torch, q, kd, vd, plens, sm),
            decode_v2_f32(torch, q, kd, vd, plens, sm, p_bf16=True), F16_B10_TOL, "main shape",
            hold)
        del kd, vd
    S9 = 9
    q9 = rnd(B, S9, G, Hg, D)
    q9s = {act: q9, bf: q9.to(bf)}
    qpos9 = plens.long()[:, None] + torch.arange(S9, device="cuda")[None, :]
    cmask9 = (torch.arange(MP * PAGE, device="cuda")[None, None, :] <= qpos9[:, :, None])
    rows9 = [min(st + S9, MP * PAGE) for st in PAGED_LENGTHS]
    pairs9 = sum(min(st + t + 1, MP * PAGE) for st in PAGED_LENGTHS for t in range(S9))
    got = row(f"flash_attention_chunk_paged S=9 {label}",
              lambda i, dt: A.flash_attention_chunk_paged(q9s[dt], *pools[dt], i % L, pt, plens,
                                                          sm),
              lambda: A.flash_attention_chunk_paged_plain(q9, kp, vp, 0, pt, plens, sm),
              2 * q9.numel() * esz + kv_read(sum(rows9)) + B * MP * 4 + B * 4,
              4.0 * pairs9 * G * Hg * D, lib_paged(q9, cmask9[:, None]),
              f"B={B} S={S9} G={G} Hg={Hg} D={D} P={PAGE} starts={list(PAGED_LENGTHS)} "
              f"{label} pool")
    if f16:
        args = (torch, q9, kp, vp, 0, pt, plens, sm, None)
        controls["flash_attention_chunk_paged S=9 f16"] = hold_beyond(
            torch, "flash_attention_chunk_paged f16", got, chunk_paged_f32(*args),
            chunk_paged_f32(*args, p_bf16=True), F16_B11_TOL, "S=9", hold)
    cap = MP * PAGE
    append_row(f"rope_kv_append paged {label}", kp, vp, pt, i32(cap - 1, cap, cap + 100, 5))
    write_row(f"kv_pool_write_idx {label}", kp, pt, i32(cap - 1, cap, cap + 100, 5))
    half = pt[:, ::2].contiguous()
    row(f"flash_attention_decode_paged_lse {label}",
        lambda i, dt: A.flash_attention_decode_paged_lse(qs[dt], *pools[dt], i % L, half, plens,
                                                         sm, 2, 0),
        lambda: A.flash_attention_decode_paged_lse_plain(q, kp, vp, 0, half, plens, sm, 2, 0),
        2 * q.numel() * esz + kv_read(sum(pn) // 2) + B * MP * 2 + B * 4 + 2 * B * G * Hg * 4,
        4.0 * sum(pn) / 2 * G * Hg * D, None,
        f"B={B} G={G} Hg={Hg} D={D} P={PAGE}, phase 0 of a stride-2 table (B, {MP // 2}), "
        f"lengths={list(PAGED_LENGTHS)} {label} pool")
    append_row(f"rope_kv_append_sharded paged {label}", kp, vp, half,
               i32(100, PAGE + 3, cap - 1, cap + 9), A.KVShard(stride=2, phase=0, total=cap))
    del pools, kp, vp
    for key, (err, ctrl) in controls.items():
        rows[key]["beyond_rounding"], rows[key]["control"] = err, ctrl
    if hold:
        width = max(len(k) for k in rows)
        for k, r in rows.items():
            lib = "none" if r["library_ms"] is None else f"{r['library_ms']:.4f} ms"
            extra = (f"  beyond the f16 rounding {r['beyond_rounding']:.2e} (bf16-p control "
                     f"{r['control']:.2e})" if "control" in r else "")
            log(f"  {k:{width}s} rel_err {r['rel_err']:.2e}  {r['ms']:.4f} ms (bf16 form "
                f"{r['bf16_ms']:.4f} ms)  bound {r['bound_ms']:.6f} ms ({r['bound_by']})  plain "
                f"{r['plain_ms']:.4f} ms  "
                + ("index_put_" if k.startswith("kv_cache_write") else f"SDPA {label}")
                + f" {lib}{'  = plain' if r['bit_equal_to_plain'] else ''}{extra}  "
                f"[{r['shape']}]")
    return rows


def check_f16_kernels(torch, seed=F16_SEED, hold=True):
    """Phase 2's f16 rows: B1 and B6 (``f16_matmul_rows``), B7 / B8 / B13 /
    B14 (``f16_dyn_t_rows``), every attention kernel's f16 form over an f16
    cache (``act_attention_rows`` in f16) and, where ``hold``, over an fp8 cache
    (``check_fp8_attention`` in f16: each bit-equal to its f16 form on the
    upcast cache)."""
    out = {"matmul": f16_matmul_rows(torch, seed, hold) + f16_dyn_t_rows(torch, seed, hold),
           "attention": act_attention_rows(torch, torch.float16, seed, hold)}
    if hold:
        fp8 = check_fp8_attention(torch, torch.float16)
        out["fp8_store"] = fp8.pop("store")
        out["attention"].update(fp8)
    return out


def f16_survey(torch, smi, seeds):
    """``--fp16-seeds``: phase 2's f16 readings per seed, untimed and
    unheld, and their largest over the seeds (the basis of the f16
    limits)."""
    worst = {}
    for seed in seeds:
        res = check_f16_kernels(torch, seed, hold=False)
        for r in res["matmul"]:
            for key in ("rel_err", "beyond_sum"):
                k = f"{r['kernel']} M={r['M']} {key}"
                worst[k] = max(worst.get(k, 0.0), r[key])
        for name, r in res["attention"].items():
            for key in ("rel_err", "beyond_rounding", "control"):
                if key in r:
                    k = f"{name} {key}"
                    fn = min if key == "control" else max
                    worst[k] = fn(worst.get(k, r[key]), r[key])
        log(f"  seed {seed}: " + json.dumps({k: v for k, v in worst.items()}))
    log("detail: " + json.dumps({"card": smi, "f16_survey_seeds": list(seeds),
                                 "largest (controls: smallest)": worst}))
    return 0


def f16_tree(torch, params, dtype=None):
    """The tree a float16 checkpoint of ``params`` loads into (loader.py):
    every float leaf in f16 (or ``dtype``: float32 for a float32
    checkpoint) but the quantized weights' scales (int4g32's bf16, int8's
    f32), which the kernels take as they are."""
    dtype = dtype or torch.float16

    def conv(tree):  # None: a leaf held elsewhere (a partition's other half)
        return {k: conv(v) if isinstance(v, dict) else
                v.to(dtype) if v is not None and v.is_floating_point()
                and k != "weight_scale" else v
                for k, v in tree.items()}
    return conv(params)


def f16_logit_drift(torch, params, p16, cfg, quant, ids, rt, kv_dtype=None):
    """max|Δlogits| / max|logits| of the first decode step after the chat
    prompt's prefill in f16 (the f16 tree ``p16``, a cache of ``kv_dtype``,
    f16 by default) against bf16 (``params``; a bf16 cache, or the same
    ``kv_dtype``; the same input token: the bf16 run's greedy token).  A
    reading only."""
    from chatglm_q_tpu_torch.models import chatglm2 as M

    prompt = torch.tensor([ids], device="cuda")
    lengths = torch.tensor([len(ids)], dtype=torch.int32, device="cuda")
    out, tok = [], None
    for dt, p in ((torch.bfloat16, params), (torch.float16, p16)):
        cache = M.init_kv_cache(cfg, 1, CACHE_LEN, kv_dtype or dt)
        logits, cache = M.prefill(p, cfg, prompt, lengths, cache, quant, dt, rt)
        tok = torch.argmax(logits, -1).to(torch.int32) if tok is None else tok
        out.append(M.decode_step(p, cfg, tok, cache, quant, dt, rt)[0].float())
        del cache
    return ((out[1] - out[0]).abs().max() / out[0].abs().max()).item()


# phase 5's float16-config runs under dynamic int8 and over an fp8 cache:
# greedy tokens a generate, shortened to fit the whole run's time
F16_NEW_TOKENS = 16
# The greedy gap of a dynamic-int8 run against the plain path: dynamic int8
# rounds each activation row to steps of 1/127 of its max, so two correct
# paths sit about 4x further apart than weight-only ones (E2E_DYN_TOL's
# reasoning), and the limit is E2E_DYN_TOL, the dynamic modes' logit limit
# between the kernel and plain paths (a gap is at most twice the logits'
# difference).  First reading 3.91e-2 (int8 + dyn in f16, 28 layers; the
# stream shifted by one reads 0.84).
F16_DYN_GAP_TOL = E2E_DYN_TOL
# the matmul kernels a float16-config GLMDecoder.generate must launch in f16
F16_CHAT_MATMULS = {("int8", False): ("int8_splitk", "int8_mma"),
                    ("int4g32", False): ("int4g32_splitk",),
                    ("int8", True): ("int8_dyn_splitk", "int8_dyn_mma"),
                    ("int4g32", True): ("int4_dyn_splitk", "int4_dyn_mma")}


def chat_f16(torch, smi, params, cfg, quant, tokenizer, prompt, ids, bf16_decoder, dyn=False,
             kv_dtype=None, tokens=CHAT_TOKENS):
    """Phase 5's f16 run of one mode: ``GLMDecoder`` with a float16 config
    (f16 activations over an f16 cache, or over ``kv_dtype``, fp8; with
    ``dyn`` the dynamic int8 kernels) on the 28-layer tree as a float16
    checkpoint of it loads (``f16_tree``), the chat prompt, ``tokens``
    greedy tokens, captured and eager (equal texts), the f16 forms launched
    (``<k>_f16``; the attention kernels over fp8 ``<k>_fp8_f16``); every
    token within GREEDY_GAP_TOL (F16_DYN_GAP_TOL with ``dyn``) of the argmax
    of the plain path (``use_kernels=False``) in f16 over the same cache;
    the first decode step's logits against the bf16 model's (the same mode
    and cache dtype; a reading); ms a token beside the bf16 decoder's, in
    turns.  int4g32 also takes one f16 decode step through B12
    (``decode_attn_v2``)."""
    from types import SimpleNamespace

    from chatglm_q_tpu_torch import GLMLoadConfig, TorchRuntimeConfig, ops
    from chatglm_q_tpu_torch.models import chatglm2 as M
    from chatglm_q_tpu_torch.serving import GLMDecoder

    f16 = torch.float16
    kv = kv_dtype or f16
    form = "fp8_f16" if kv_dtype else "f16"
    name = f"{mode_name(quant, dyn)} f16" + (" fp8" if kv_dtype else "")
    bf16_params, params = params, f16_tree(torch, params)
    load = GLMLoadConfig(model_config=cfg, quant_type=quant, torch_dtype="float16")
    rt = TorchRuntimeConfig(dynamic_int8=dyn)
    eager = TorchRuntimeConfig(dynamic_int8=dyn, cuda_graphs=False)
    dec = GLMDecoder(load, params, tokenizer, max_sequence_length=CACHE_LEN, rt=rt,
                     kv_dtype=kv_dtype)
    dec_eager = GLMDecoder(load, params, tokenizer, max_sequence_length=CACHE_LEN, rt=eager,
                           kv_dtype=kv_dtype)
    require(dec.dtype == f16 and dec.kv_dtype == kv, f"{name}: decoder in {dec.dtype}")
    ops.reset_launch_counts()
    _, final, _ = run_generate(dec, prompt, tokens)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    step = M.decode_program(params, cfg, dec._free_caches[0][0], quant, f16, rt)
    require(dec._free_caches[0][0].k.dtype == kv and step.graph is not None
            and step.replays >= tokens - 3,
            f"{name}: the decode step was not replayed from a graph ({step.replays})")
    _, final_eager, _ = run_generate(dec_eager, prompt, tokens)
    require(final_eager == final, f"{name}: the captured decoder's text differs from the eager "
                                  f"one's: {final[:60]!r} / {final_eager[:60]!r}")
    for k in F16_CHAT_MATMULS[(quant, dyn)]:
        require(counts[k + "_f16"] > 0 and counts[k + "_f16"] == counts[k],
                f"{name}: {k} launched {counts[k]} times, {counts[k + '_f16']} in f16")
    for k in ("rope_kv_append", "flash_attention_decode", "flash_attention_prefill"):
        require(counts[f"{k}_{form}"] > 0 and counts[f"{k}_{form}"] == counts[k],
                f"{name}: {k} launched {counts[k]} times, {counts[f'{k}_{form}']} as {form}")
    # the tokens: the model-level loop over the same cache dtype
    cache = M.init_kv_cache(cfg, 1, CACHE_LEN, kv)
    logits, cache = M.prefill(params, cfg, torch.tensor([ids], device="cuda"),
                              torch.tensor([len(ids)], dtype=torch.int32, device="cuda"), cache,
                              quant, f16, rt)
    first = torch.argmax(logits, -1).to(torch.int32)
    toks, cache = M.multi_step_decode(params, cfg, first, cache, tokens - 1, None, quant, f16, rt)
    out = [int(first[0])] + toks[0].tolist()
    if quant == "int4g32" and not dyn:  # one f16 step through B12
        v2 = TorchRuntimeConfig(decode_attn_v2=True, cuda_graphs=False)
        key = f"flash_attention_decode_v2_{form}"
        before = ops.launch_counts()[key]
        M.decode_step(params, cfg, toks[:, -1], cache, quant, f16, v2)
        torch.cuda.synchronize()
        counts[key] = ops.launch_counts()[key] - before
        require(counts[key] == cfg.num_layers,
                f"{name}: decode_attn_v2 launched B12 as {form} {counts[key]} times")
    del cache
    plain = TorchRuntimeConfig(use_kernels=False, use_flash_attention=True, cuda_graphs=False,
                               dynamic_int8=dyn)
    gaps = greedy_gaps(torch, params, cfg, [SimpleNamespace(generated=out)],
                       [(ids, dict(temperature=0.0))], cache_len=CACHE_LEN, kv_dtype=kv,
                       rt=plain, quant=quant, dtype=f16)
    gap_tol = F16_DYN_GAP_TOL if dyn else GREEDY_GAP_TOL
    require(gaps["f32"][0] <= gap_tol < gaps["f32"][1],
            f"{name}: greedy gap {gaps['f32'][0]} against the plain path in f16 (limit "
            f"{gap_tol}; shifted control {gaps['f32'][1]})")
    drift = f16_logit_drift(torch, bf16_params, params, cfg, quant, ids, rt, kv_dtype)
    tok_ms = {"bf16": [], "f16": []}
    for turn, d in (("bf16", bf16_decoder), ("f16", dec), ("f16", dec), ("bf16", bf16_decoder)):
        tok_ms[turn].append(run_generate(d, prompt, tokens)[2])
    log(f"  {name}: GLMDecoder.generate (float16 config, {str(kv)[6:]} cache) captured = "
        f"eager ({len(out)} tokens): {final[:60]!r}; greedy gap f32 against the plain path in "
        f"f16 {gaps['f32'][0]:.4e} (shifted control {gaps['f32'][1]:.3e}); the first decode "
        f"step's max|dlogits| / max|logits| against the bf16 model {drift:.4e} (a reading)")
    log(f"  {name} GLMDecoder ms a token in turns ({tokens} tokens): bf16 "
        f"{tok_ms['bf16'][0]:.3f}, f16 {tok_ms['f16'][0]:.3f} / {tok_ms['f16'][1]:.3f}, bf16 "
        f"{tok_ms['bf16'][1]:.3f}  [{smi}]")
    log(f"  {name} launch counts of the generate run: "
        f"{json.dumps({k: v for k, v in counts.items() if v})}")
    del dec, dec_eager
    return counts, {"gaps": gaps, "logit_drift_vs_bf16": drift, "ms_per_token_turns": tok_ms,
                    "replays": step.replays, "text": final[:80]}


def engines_f16(torch, smi, params, cfg, a_reqs, short, seed, kv_dtype=None):
    """Phase 6 over an f16 pool, (a16): (a)'s engine (chunked admission, the
    prefix cache, the top-p row) with a float16 config: budgets, page
    accounting, prefix hits, the f16 forms launched (B3 / B4 never), every
    greedy token within GREEDY_GAP_TOL of the dense ``prefill_chunk`` in f16
    over an f16 cache (its logits read in f32), tok/s and the busy share of
    a decode-only step.  With ``kv_dtype`` fp8, (a16f8): the same over an
    fp8 pool (the attention forms as ``<k>_fp8_f16``), F16_NEW_TOKENS a
    request and no busy-share run."""
    from chatglm_q_tpu_torch import GLMLoadConfig, TorchRuntimeConfig
    from chatglm_q_tpu_torch.serving import PagedServingEngine

    f16 = torch.float16
    kv = kv_dtype or f16
    tag, form = ("(a16f8)", "fp8_f16") if kv_dtype else ("(a16)", "f16")
    if kv_dtype:
        a_reqs = [(p, {**kw, "max_new_tokens": F16_NEW_TOKENS}) for p, kw in a_reqs]
    params = f16_tree(torch, params)  # as a float16 checkpoint of the tree loads
    load = GLMLoadConfig(model_config=cfg, quant_type="int4g32", torch_dtype="float16")
    eng = PagedServingEngine(load, params, num_pages=POOL_PAGES, page_size=PAGE,
                             prefill_chunk_size=PAGE, prefix_cache=True, rt=TorchRuntimeConfig(),
                             seed=seed + 3, kv_dtype=kv_dtype, **ENGINE_KW)
    require(eng.cache.k_pool.dtype == kv, f"{tag} the pool is {eng.cache.k_pool.dtype}")
    done, res = drive(torch, eng, a_reqs, f"{tag} paged, chunked + prefix cache, f16 over "
                                          f"{str(kv)[6:]}")
    require(eng.pages_in_use == 0, f"{tag}: {eng.pages_in_use} pages in use after the drain")
    require(eng.stats["prefix_hits"] > 0, f"{tag}: no prefix hit")
    eng.clear_prefix_cache()
    require(len(eng._free_pages) == POOL_PAGES - 1,
            f"{tag}: {len(eng._free_pages)} pages free after clearing the prefix cache")
    c = res["launches"]
    for kern in ("int4g32_splitk", "int4g32_mma"):
        require(c[kern + "_f16"] > 0 and c[kern + "_f16"] == c[kern],
                f"{tag}: {kern} launched {c[kern]} times, {c[kern + '_f16']} in f16")
    for kern in ("rope_kv_append", "flash_attention_decode_paged", "flash_attention_prefill_chunk"):
        require(c[f"{kern}_{form}"] > 0 and c[f"{kern}_{form}"] == c[kern],
                f"{tag}: {kern} launched {c[kern]} times, {c[f'{kern}_{form}']} as {form}")
    require(c["kv_cache_write_idx"] == 0 and c["flash_attention_decode"] == 0,
            f"{tag} launched B3/B4")
    if not kv_dtype:
        res["busy"] = chunk_busy(torch, eng, short, tag)
    del eng
    res["gaps"] = greedy_gaps(torch, params, cfg, done, a_reqs, kv_dtype=kv, dtype=f16)
    g = res["gaps"]["f32"]
    require(g[0] <= GREEDY_GAP_TOL and g[1] > GREEDY_GAP_TOL,
            f"{tag}: greedy gap {g[0]} against the dense f16 prefill_chunk over "
            f"{str(kv)[6:]} (shifted control {g[1]})")
    busy = (f", busy share of a decode-only step {100 * res['busy']['busy_share']:.1f}%"
            if "busy" in res else "")
    log(f"    {tag} greedy gap f32 {g[0]:.4e} (shifted control {g[1]:.3e}); "
        f"{res['tok_per_s']:.1f} tok/s{busy}  [{smi}]")
    return c, res


F16_LAUNCH_LAYERS = 2  # the launcher run's depth: phase 5 holds the full 28


def launcher_f16(torch, smi, tokenizer, prompt):
    """The launch path on a float16 checkpoint: a float tree at ChatGLM2-6B
    widths, F16_LAUNCH_LAYERS layers, saved as a float16 checkpoint (as the
    reference's are), quantized to int4g32 by ``examples/quantize_naive``
    on the card (a float16-config checkpoint), then
    ``GLMDecoder.from_pretrained`` with no dtype generates on the card
    through the f16 kernels, in a temporary directory under the
    (gitignored) build directory."""
    import tempfile

    from chatglm_q_tpu_torch import ChatGLM2Config, GLMLoadConfig, ops
    from chatglm_q_tpu_torch import loader as TLD
    from chatglm_q_tpu_torch.examples import quantize_naive
    from chatglm_q_tpu_torch.models import chatglm2 as M
    from chatglm_q_tpu_torch.ops import _build
    from chatglm_q_tpu_torch.serving import GLMDecoder

    cfg = ChatGLM2Config(num_layers=F16_LAUNCH_LAYERS)
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
        t0 = time.perf_counter()
        params = M.init_params(torch.Generator(device="cuda").manual_seed(61), cfg, "none",
                               torch.float32, "cuda")
        TLD.save_model_and_tokenizer(f"{tmp}/float", GLMLoadConfig(model_config=cfg,
                                                                   torch_dtype="float16"),
                                     params, tokenizer)
        del params
        t1 = time.perf_counter()
        quantize_naive.main(["--quant", "int4g32", "--source", f"{tmp}/float", "--target",
                             f"{tmp}/int4g32"])
        t2 = time.perf_counter()
        dec = GLMDecoder.from_pretrained(f"{tmp}/int4g32")
        t3 = time.perf_counter()
        require(dec.config.torch_dtype == "float16" and dec.dtype == torch.float16
                and dec.device.type == "cuda", f"launcher: {dec.config.torch_dtype}, {dec.dtype}")
        ops.reset_launch_counts()
        stream, final, ms = run_generate(dec, prompt)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        del dec
    for k in ("int4g32_splitk_f16", "rope_kv_append_f16", "flash_attention_decode_f16",
              "flash_attention_prefill_f16"):
        require(counts[k] > 0, f"launcher: no {k} launch")
    require(len(final) > 0, "launcher: empty text")
    log(f"  launcher: a float16 ChatGLM2-6B-width checkpoint ({F16_LAUNCH_LAYERS} layers) saved "
        f"in {t1 - t0:.1f} s, quantize_naive int4g32 in {t2 - t1:.1f} s, "
        f"GLMDecoder.from_pretrained in {t3 - t2:.1f} s (float16 config, f16 activations and "
        f"cache); generate gave {len(stream)} streamed texts, {ms:.3f} ms a token: "
        f"{final[:60]!r}  [{smi}]")
    return {"save_s": t1 - t0, "quantize_s": t2 - t1, "load_s": t3 - t2,
            "ms_per_token": ms, "text": final[:80],
            "launches": {k: v for k, v in counts.items() if v}}


def f16_slice(torch, smi):
    """``--fp16``: phase 2's f16 rows, the f16 runs of phases 5, 6 and 7 and
    the launcher run, on their own."""
    from chatglm_q_tpu_torch import ChatGLM2Config, GLMLoadConfig, TorchRuntimeConfig, ops
    from chatglm_q_tpu_torch.bench import random_quantized_params
    from chatglm_q_tpu_torch.serving import GLMDecoder, chat_template
    from chatglm_q_tpu_torch.utils.train import partition_params

    rows = check_f16_kernels(torch)
    cfg = ChatGLM2Config()
    tokenizer = chat_tokenizer()
    prompt = chat_template([], CHAT_QUESTION)
    ids = tokenizer.encode(prompt)
    chat, counts, train = {}, {}, {}
    for quant in ("int8", "int4g32"):
        params = random_quantized_params(cfg, quant,
                                         torch.Generator(device="cuda").manual_seed(41))
        load = GLMLoadConfig(model_config=cfg, quant_type=quant, torch_dtype="bfloat16")
        for dyn in (False, True):
            decoder = GLMDecoder(load, params, tokenizer, max_sequence_length=CACHE_LEN,
                                 rt=TorchRuntimeConfig(dynamic_int8=dyn))
            run_generate(decoder, prompt)  # its programs captured before the turns
            name = mode_name(quant, dyn)
            counts[name], chat[name] = chat_f16(
                torch, smi, params, cfg, quant, tokenizer, prompt, ids, decoder, dyn=dyn,
                tokens=F16_NEW_TOKENS if dyn else CHAT_TOKENS)
            if name == "int4g32":
                counts["int4g32 fp8"], chat["int4g32 fp8"] = chat_f16(
                    torch, smi, params, cfg, quant, tokenizer, prompt, ids, decoder,
                    kv_dtype=torch.float8_e4m3fn, tokens=F16_NEW_TOKENS)
            del decoder
        # phase 7's f16 fine-tuning on the same tree
        trainable, frozen = partition_params(params)
        start = map_tree(trainable, lambda t: None if t is None else
                         t.detach().clone().requires_grad_(True))
        gen = torch.Generator(device="cuda").manual_seed(71)
        tids = torch.randint(0, cfg.vocab_size, (FT_BATCH, FT_SEQ), device="cuda", generator=gen)
        tlabels = tids.clone()
        tlabels[:, :FT_IGNORED] = -100
        tc = counts[f"{quant} train"] = dict.fromkeys(ops.launch_counts(), 0)
        train[quant] = f16_fine_tune(torch, smi, cfg, quant, start, frozen, tids, tlabels,
                                     lambda c: tc.update({k: tc[k] + v for k, v in c.items()}))
        del trainable, frozen, start
        if quant == "int8":
            del params
            torch.cuda.empty_cache()
    a_reqs, _ = engine_prompts(torch, 61)
    short = [(p[:128], {**kw, "temperature": 0.0, "max_new_tokens": 256})
             for p, kw in a_reqs[:4]]
    counts["a16"], engines = engines_f16(torch, smi, params, cfg, a_reqs, short, 61)
    counts["a16f8"], engines_fp8 = engines_f16(torch, smi, params, cfg, a_reqs, short, 61,
                                               torch.float8_e4m3fn)
    del params
    torch.cuda.empty_cache()
    launcher = launcher_f16(torch, smi, tokenizer, prompt)
    return {"rows": rows, "chat": chat, "a16": engines, "a16f8": engines_fp8,
            "launcher": launcher, "fine_tune_f16": train,
            "counts": {k: {n: v for n, v in c.items() if v} for k, c in counts.items()}}


# ---------------------------------------------------------------------------
# float32 activations (a float32 checkpoint, the loaders' default dtype):
# phase 2's f32 attention rows and the f32 runs of phases 5, 6 and 8
# (``--fp32`` runs them alone)
# ---------------------------------------------------------------------------

F32_SEED = 19
F32_NEW_TOKENS = 16  # greedy tokens a request of the f32 runs of phases 5 and 6
# phase 5's float32-config GLMDecoder runs: (quant, cache dtype name)
F32_CHAT = (("int4g32", "float32"), ("int8", "float32"), ("int4g32", "float8_e4m3fn"))


def tf32_off(torch) -> dict:
    """TF32 off for both of PyTorch's f32 paths, set and printed before an
    f32 comparison (the plain versions' einsums then sum in IEEE f32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    flags = {"torch.backends.cuda.matmul.allow_tf32": torch.backends.cuda.matmul.allow_tf32,
             "torch.backends.cudnn.allow_tf32": torch.backends.cudnn.allow_tf32}
    log(f"  TF32 off before the f32 comparisons: {json.dumps(flags)}")
    return flags


# B1's and B6's f32 forms (phase 2): the rows of F32_MATMUL_M on the six
# linears, with the CUDA-core gemv they replace timed in turns; and every
# output held, besides F32_TOL, within F32_SUM_C · 2^-24 · Σ|x_k·w_k| of the
# plain version, c fixed at 1.5x the largest reading of F32_SUM_SEEDS (of
# random inputs against the plain version, and of lo-coherent ones,
# ``lo_coherent``, against the exact value); a control, the exact value of
# x without its lo pieces, must exceed it there.
F32_MATMUL_M = (1, 4, 16, 36, 57, 128, 512)
F32_SUM_SEEDS = (31, 32, 33)
F32_SUM_C = 25.0
# the lo-coherent rows: split-K, Hopper with a tile past M's rows, Hopper
F32_COHERENT_M = (4, 8, 57)
# the split-K / Hopper crossover sweep of the f32 forms (both forced; split-K
# up to F32_SPLITK_MAX, the most rows whose pieces fit its two m-tiles)
F32_SWEEP_M = (1, 2, 3, 4, 5, 6, 8, 10, 12, 16, 24, 32, 57, 128)


def lo_coherent(torch, gen, M, K):
    """(M, K) positive f32 x whose lo pieces (``split_bf16x3``) are positive,
    63 · 2^-23 of x's binade (about 2^-17.6 of x): mantissa bit 15 clear (hi
    truncates), bit 14 set (mid takes bits 14-7), bit 6 clear (mid
    truncates) and bits 5-0 set (lo).  With positive weights the dropped lo
    then adds up instead of cancelling: the control that must exceed the
    limit."""
    e = torch.randint(-3, 3, (M, K), device="cuda", generator=gen)
    m = torch.randint(0, 1 << 23, (M, K), device="cuda", generator=gen)
    m = (m & ~((1 << 15) | (1 << 6))) | (1 << 14) | 63
    return (((127 + e) << 23) | m).to(torch.int32).view(torch.float32)


def f32_matmul_kind(kind):
    """(weights maker, matmul, plain, route, its wrappers by route) of B1
    ("int4g32") or B6 ("int8")."""
    from chatglm_q_tpu_torch.ops import int8_matmul as I8
    from chatglm_q_tpu_torch.ops import quant_matmul as QM

    def int4_weights(torch, gen, copies, K, N, positive=False):
        packed = torch.randint(0, 256, (copies, K // 2, N), dtype=torch.uint8, device="cuda",
                               generator=gen)
        if positive:  # nibbles 0..7
            packed &= 0x77
        scale = (torch.rand((copies, K // 32, N), device="cuda", generator=gen) * 0.02
                 ).to(torch.bfloat16)
        return packed, scale, K // 2 * N + K // 32 * N * 2

    def int8_weights(torch, gen, copies, K, N, positive=False):
        w = torch.randint(0 if positive else -128, 128, (copies, K, N), dtype=torch.int8,
                          device="cuda", generator=gen)
        scale = (0.5 + torch.rand((copies, N), device="cuda", generator=gen)) * 0.01
        return w, scale, K * N + 4 * N

    if kind == "int4g32":
        return (int4_weights, QM.int4g32_matmul, QM.int4g32_matmul_plain, QM.int4_route,
                {"splitk": QM.int4g32_splitk, "mma": QM.int4g32_mma, "gemv": QM.int4g32_gemv})
    return (int8_weights, I8.int8_matmul, I8.int8_matmul_plain, I8.int8_route,
            {"splitk": I8.int8_splitk, "mma": I8.int8_mma, "gemv": I8.int8_gemv})


def f32_terms(torch, kind, x, w, s):
    """Σ_k |x_k · w_k| of each output, f64 (int8: times the column scale)."""
    from chatglm_q_tpu_torch.ops.quant import unpack_int4_tpu

    if kind == "int4g32":
        return x.double().abs() @ unpack_int4_tpu(w, s).double().abs()
    return (x.double().abs() @ w.double().abs()) * s.double()


def f32_exact(torch, kind, x, w, s):
    """The exact value of x @ w in f64 (int8: times the column scale)."""
    from chatglm_q_tpu_torch.ops.quant import unpack_int4_tpu

    if kind == "int4g32":
        return x.double() @ unpack_int4_tpu(w, s).double()
    return (x.double() @ w.double()) * s.double()


def f32_reading(torch, got, want, terms) -> float:
    """max |got - want| / (2^-24 · Σ|terms|) over the outputs."""
    return ((got.double() - want.double()).abs() / (2.0 ** -24 * terms).clamp_min(1e-300)
            ).max().item()


def check_f32_matmul(torch, calibrate=False):
    """Phase 2's f32 rows of B1 and B6 (f32 x as its three bf16 pieces on
    the tensor cores): at F32_MATMUL_M on the six linears, one launch of the
    route's f32 form (the Hopper form after one split pass), within F32_TOL
    of the plain version (TF32 off), and the CUDA-core gemv too; the form's
    ms and the gemv's in turns (form, gemv, gemv, form), the plain
    version's and (B6) ``_weight_int8pack_mm``'s in f32; the readings of
    the timing seed, of F32_SUM_SEEDS and of lo-coherent inputs, all within
    F32_SUM_C · 2^-24 · Σ|x·w| of the plain version, and the drop-lo control
    above that limit (``calibrate``: the readings alone, for
    ``--fp32-readings``); the split-K / Hopper sweep over F32_SWEEP_M; the
    split pass alone, bit-equal to ``split_bf16x3``, its input rotated as
    the weights are.  Returns (rows, readings, sweep, split pass row)."""
    from chatglm_q_tpu_torch.ops import quant_matmul as QM
    from chatglm_q_tpu_torch.ops.quant import split_bf16x3
    from chatglm_q_tpu_torch.utils.timing import cuda_event_ms

    require(not torch.backends.cuda.matmul.allow_tf32, "f32 matmul rows: TF32 is on")
    gen = torch.Generator(device="cuda").manual_seed(F32_SEED)
    rows, readings, sweep = [], [], []
    for kind in ("int4g32", "int8"):
        make, fn, plain, route, wrappers = f32_matmul_kind(kind)
        for name, K, N in MATMUL_SHAPES:
            probe = make(torch, gen, 1, K, N)
            copies = weight_copies(probe[2])
            del probe
            w, s, wbytes = make(torch, gen, copies, K, N)
            w_t = w.transpose(1, 2).contiguous() if kind == "int8" else None
            for M in F32_MATMUL_M:
                x = torch.randn((M, K), device="cuda", generator=gen)
                r = route(M, N, torch.float32)
                require(r in ("splitk", "mma"), f"{kind} f32 {name} M={M}: route {r}")
                before = {k: f.f32.launches for k, f in wrappers.items()}
                passes = QM.split_bf16x3_pass.launches
                got = fn(x, w[0], s[0])
                torch.cuda.synchronize()
                launched = {k: f.f32.launches - before[k] for k, f in wrappers.items()}
                require(launched == {k: int(k == r) for k in wrappers}
                        and QM.split_bf16x3_pass.launches - passes == int(r == "mma"),
                        f"{kind} f32 {name} M={M}: launches {launched}")
                want = plain(x, w[0], s[0])
                err, rel = rel_err(got, want)
                reading = f32_reading(torch, got, want, f32_terms(torch, kind, x, w[0], s[0]))
                require(torch.isfinite(got).all() and rel <= F32_TOL,
                        f"{kind} f32 {name} M={M}: rel err {rel} > {F32_TOL}")
                gemv_rel = rel_err(wrappers["gemv"](x, w[0], s[0]), want)[1]
                require(gemv_rel <= F32_TOL,
                        f"{kind} f32 {name} M={M}: the gemv's rel err {gemv_rel} > {F32_TOL}")
                readings.append({"kind": kind, "linear": name, "M": M, "seed": F32_SEED,
                                 "reading": reading, "route": r})
                turns = []
                for turn in ("form", "gemv", "gemv", "form"):
                    f = fn if turn == "form" else wrappers["gemv"]
                    turns.append(cuda_event_ms(lambda i: f(x, w[i % copies], s[i % copies]),
                                               iters=30))
                plain_ms = cuda_event_ms(lambda i: plain(x, w[0], s[0]), iters=3, warmup=1)
                refusal = []
                lib = (int8_library(torch, x, w_t, s, want, refusal) if kind == "int8"
                       else None)
                b, by = bound_ms(M * K * 4 + wbytes + M * N * 4, 3 * 2.0 * M * K * N)
                kernel = f"{'int4g32' if kind == 'int4g32' else 'int8'}_{r}"
                row = {"kernel": kernel, "form": "f32", "linear": name, "M": M, "K": K, "N": N,
                       "x_dtype": "float32", "max_abs_err": err, "rel_err": rel,
                       "sum_reading": reading, "ms": (turns[0] + turns[3]) / 2,
                       "gemv_ms": (turns[1] + turns[2]) / 2, "turns_ms": turns,
                       "plain_ms": plain_ms, "bound_ms": b, "bound_by": by,
                       "cuda_core_ops_ms": 2.0 * M * K * N / PEAK_F32_FLOPS * 1e3,
                       "library_ms": lib}
                if refusal:
                    row["library_refusal"] = refusal[0]
                if r == "splitk":
                    row["plan"] = list(QM.splitk_f32_plan(M, K, N, kind == "int8"))
                else:
                    row["plan"] = (QM.mma_plan(M, K, N, True) if kind == "int4g32"
                                   else QM.int8_mma_plan(M, K, N, True))
                rows.append(row)
                lib_s = "none" if lib is None else f"{lib:.5f} ms"
                log(f"  {kind} f32 {name:17s} M={M:4d} [{kernel}_f32] rel_err {rel:.2e}, "
                    f"{reading:.3f} x 2^-24 sum|terms|; {row['ms']:.5f} ms (gemv in turns "
                    f"{row['gemv_ms']:.5f}; turns {', '.join(f'{t:.5f}' for t in turns)})  "
                    f"bound {b:.5f} ms ({by}; CUDA-core ops {row['cuda_core_ops_ms']:.5f})  "
                    f"plain {plain_ms:.3f} ms  library {lib_s}  plan {row['plan']}")
                del x, got, want
            # the readings of the other seeds, and the lo-coherent inputs with the control
            for seed in F32_SUM_SEEDS:
                g = torch.Generator(device="cuda").manual_seed(seed)
                for M in F32_MATMUL_M:
                    x = torch.randn((M, K), device="cuda", generator=g)
                    got, want = fn(x, w[0], s[0]), plain(x, w[0], s[0])
                    rd = f32_reading(torch, got, want, f32_terms(torch, kind, x, w[0], s[0]))
                    readings.append({"kind": kind, "linear": name, "M": M, "seed": seed,
                                     "reading": rd, "route": route(M, N, torch.float32)})
            # lo-coherent inputs at each form's rows (split-K, Hopper): every
            # term positive, where the plain version's own f32
            # sums drift (its reading is logged), so held against the exact
            # value; the control is the exact value of x without its lo pieces
            wp, sp, _ = make(torch, gen, 1, K, N, positive=True)
            for seed in F32_SUM_SEEDS:
                g = torch.Generator(device="cuda").manual_seed(seed)
                for M in F32_COHERENT_M:
                    x = lo_coherent(torch, g, M, K)
                    hi, mid, _ = split_bf16x3(x)
                    exact = f32_exact(torch, kind, x, wp[0], sp[0])
                    terms = f32_terms(torch, kind, x, wp[0], sp[0])
                    rd = f32_reading(torch, fn(x, wp[0], sp[0]), exact, terms)
                    plain_rd = f32_reading(torch, plain(x, wp[0], sp[0]), exact, terms)
                    control = f32_reading(torch, f32_exact(torch, kind, hi.double() + mid.double(),
                                                           wp[0], sp[0]), exact, terms)
                    readings.append({"kind": kind, "linear": name, "M": M, "seed": seed,
                                     "inputs": "lo-coherent", "reading": rd,
                                     "plain_reading": plain_rd, "drop_lo_control": control,
                                     "route": route(M, N, torch.float32)})
                    log(f"  {kind} f32 {name:17s} M={M:4d} lo-coherent seed {seed}: {rd:.3f} x "
                        f"2^-24 sum|terms| of the exact value (plain {plain_rd:.3f}), the drop-lo "
                        f"control {control:.3f}")
            del wp, sp
            # the crossover sweep
            for M in F32_SWEEP_M:
                x = torch.randn((M, K), device="cuda", generator=gen)
                got = {}
                if M <= QM.F32_SPLITK_MAX:
                    got["splitk"] = lambda i: wrappers["splitk"](x, w[i % copies], s[i % copies])
                if N % 16 == 0:
                    got["mma"] = lambda i: wrappers["mma"](x, w[i % copies], s[i % copies])
                ms = {k: cuda_event_ms(f, iters=20) for k, f in got.items()}
                sweep.append({"kind": kind, "linear": name, "M": M, "ms": ms,
                              "route": route(M, N, torch.float32)})
                log(f"  {kind} f32 sweep {name:17s} M={M:4d}: "
                    + ", ".join(f"{k} {v:.5f} ms" for k, v in ms.items())
                    + f"  (route: {route(M, N, torch.float32)})")
            del w, s, w_t
    # the split pass alone, at a 1 x 512 prefill's w_in input, x rotated
    # over copies that exceed the L2 as the weights are (its pieces go to the
    # one scratch buffer every call reuses, as on the main path)
    n = 512 * 4096
    copies = weight_copies(4 * n)
    xs = torch.randn((copies, 512, 4096), device="cuda", generator=gen)
    pieces = QM.split_bf16x3_pass(xs[0])
    want = torch.stack(split_bf16x3(xs[0]))
    require(torch.equal(pieces.view(torch.int16), want.view(torch.int16)),
            "split_bf16x3_pass: pieces differ from split_bf16x3's")
    b, by = bound_ms(10 * n, 0)
    split_row = {"kernel": "split_bf16x3_pass", "shape": f"x (512, 4096) f32 -> (3, 512, 4096) "
                 f"bf16, x rotated over {copies} copies", "max_abs_err": 0.0,
                 "ms": cuda_event_ms(lambda i: QM.split_bf16x3_pass(xs[i % copies]), iters=50),
                 "plain_ms": cuda_event_ms(lambda i: split_bf16x3(xs[0]), iters=5, warmup=1),
                 "bound_ms": b, "bound_by": by, "library_ms": None}
    log(f"  split_bf16x3_pass x (512, 4096) over {copies} copies: bit-equal to split_bf16x3; "
        f"{split_row['ms']:.5f} ms, bound {b:.5f} ms ({by}), plain "
        f"{split_row['plain_ms']:.4f} ms")
    del xs
    worst = max(readings, key=lambda rd: rd["reading"])
    least = min(rd["drop_lo_control"] for rd in readings if "drop_lo_control" in rd)
    log(f"  f32 forms: largest reading over seeds {F32_SUM_SEEDS} (random inputs against the "
        f"plain version, lo-coherent ones against the exact value) and the timing seed "
        f"{F32_SEED} {worst['reading']:.3f} x 2^-24 sum|terms| ({worst}); limit F32_SUM_C "
        f"{F32_SUM_C}; least drop-lo control {least:.3f}")
    if not calibrate:
        require(worst["reading"] <= F32_SUM_C < least,
                f"f32 forms: largest reading {worst['reading']:.3f}, least drop-lo control "
                f"{least:.3f} x 2^-24 sum|terms| (limit F32_SUM_C {F32_SUM_C})")
    return rows, readings, sweep, split_row


def check_f32_kernels(torch):
    """Phase 2's f32 rows: B1's and B6's f32 forms (``check_f32_matmul``);
    every attention kernel's f32 form over an f32
    cache (``act_attention_rows`` in f32, within F32_TOL of its plain
    version; the appends and writes bit-equal), over an fp8 cache
    (``check_fp8_attention`` in f32: each bit-equal to its f32 form on the
    upcast cache; the f32 -> e4m3 store byte-equal to ``kv_store_cast``),
    and the attention edge cases in f32."""
    flags = tf32_off(torch)
    mm_rows, mm_readings, sweep, split_row = check_f32_matmul(torch)
    rows = act_attention_rows(torch, torch.float32, F32_SEED, True)
    fp8 = check_fp8_attention(torch, torch.float32)
    store = fp8.pop("store")
    rows.update(fp8)
    return {"attention": rows, "fp8_store": store, "tf32": flags,
            "edge_cases_max_rel_err": check_attention_edges(torch, torch.float32),
            "matmul": mm_rows, "matmul_readings": mm_readings, "matmul_sweep": sweep,
            "split_pass": split_row}


def chat_f32(torch, smi, params, cfg, quant, tokenizer, prompt, ids, bf16_decoder, kv_dtype=None):
    """Phase 5's f32 run of one mode: ``GLMDecoder`` with a float32 config
    (f32 activations over an f32 cache, or over ``kv_dtype``, fp8) on the
    28-layer tree as a float32 checkpoint of it loads, the chat prompt,
    F32_NEW_TOKENS greedy tokens, captured and eager (equal texts); its text
    that of ``prefill`` + ``multi_step_decode``; B1's or B6's f32 forms
    (split-K in decode, Hopper in the prefill; never the gemv) and the
    attention kernels' f32 (fp8_f32) forms launched, and one f32 decode step
    through B12 (``decode_attn_v2``); every token within GREEDY_GAP_TOL of
    the argmax of the plain path (``use_kernels=False``) in f32 over the same
    cache dtype; ms a token and the prompt's prefill ms (time to first
    token) beside the bf16 decoder of the same mode, in turns."""
    from types import SimpleNamespace

    from chatglm_q_tpu_torch import GLMLoadConfig, TorchRuntimeConfig, ops
    from chatglm_q_tpu_torch.models import chatglm2 as M
    from chatglm_q_tpu_torch.serving import GLMDecoder, process_response

    f32, tokens = torch.float32, F32_NEW_TOKENS
    kv = kv_dtype or f32
    form = "fp8_f32" if kv_dtype else "f32"
    name = f"{quant} f32" + (" fp8" if kv_dtype else "")
    params = f16_tree(torch, params, f32)  # as a float32 checkpoint of the tree loads
    load = GLMLoadConfig(model_config=cfg, quant_type=quant, torch_dtype="float32")
    rt = TorchRuntimeConfig()
    dec = GLMDecoder(load, params, tokenizer, max_sequence_length=CACHE_LEN, rt=rt,
                     kv_dtype=kv_dtype)
    dec_eager = GLMDecoder(load, params, tokenizer, max_sequence_length=CACHE_LEN,
                           rt=TorchRuntimeConfig(cuda_graphs=False), kv_dtype=kv_dtype)
    require(dec.dtype == f32 and dec.kv_dtype == kv, f"{name}: decoder in {dec.dtype}")
    ops.reset_launch_counts()
    _, final, _ = run_generate(dec, prompt, tokens)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    step = M.decode_program(params, cfg, dec._free_caches[0][0], quant, f32, rt)
    require(dec._free_caches[0][0].k.dtype == kv and step.graph is not None
            and step.replays >= tokens - 3,
            f"{name}: the decode step was not replayed from a graph ({step.replays})")
    _, final_eager, _ = run_generate(dec_eager, prompt, tokens)
    require(final_eager == final, f"{name}: the captured decoder's text differs from the eager "
                                  f"one's: {final[:60]!r} / {final_eager[:60]!r}")
    # the f32 forms: split-K in decode, the Hopper kernel in the prompt's prefill
    for k in [f"{quant}_{r}" for r in ("splitk", "mma")]:
        require(counts[f"{k}_f32"] > 0 and counts[f"{k}_f32"] == counts[k],
                f"{name}: {k} launched {counts[k]} times, {counts[f'{k}_f32']} as f32")
    require(counts[f"{quant}_gemv"] == 0, f"{name}: {quant}'s gemv launched")
    for k in ("rope_kv_append", "flash_attention_decode", "flash_attention_prefill"):
        require(counts[f"{k}_{form}"] > 0 and counts[f"{k}_{form}"] == counts[k],
                f"{name}: {k} launched {counts[k]} times, {counts[f'{k}_{form}']} as {form}")
    # the model-level loop over the same cache dtype: the same text
    cache = M.init_kv_cache(cfg, 1, CACHE_LEN, kv)
    logits, cache = M.prefill(params, cfg, torch.tensor([ids], device="cuda"),
                              torch.tensor([len(ids)], dtype=torch.int32, device="cuda"), cache,
                              quant, f32, rt)
    first = torch.argmax(logits, -1).to(torch.int32)
    toks, cache = M.multi_step_decode(params, cfg, first, cache, tokens - 1, None, quant, f32, rt)
    out = [int(first[0])] + toks[0].tolist()
    cut = out[: out.index(dec.eos_token_id) + 1] if dec.eos_token_id in out else out
    require(process_response(tokenizer.decode(cut)) == final,
            f"{name}: GLMDecoder text {final[:60]!r} differs from the model-level text")
    key = f"flash_attention_decode_v2_{form}"  # one f32 step through B12
    before = ops.launch_counts()[key]
    M.decode_step(params, cfg, toks[:, -1], cache, quant, f32,
                  TorchRuntimeConfig(decode_attn_v2=True, cuda_graphs=False))
    torch.cuda.synchronize()
    counts[key] = ops.launch_counts()[key] - before
    require(counts[key] == cfg.num_layers,
            f"{name}: decode_attn_v2 launched B12 as {form} {counts[key]} times")
    del cache
    plain = TorchRuntimeConfig(use_kernels=False, use_flash_attention=True, cuda_graphs=False)
    gaps = greedy_gaps(torch, params, cfg, [SimpleNamespace(generated=out)],
                       [(ids, dict(temperature=0.0))], cache_len=CACHE_LEN, kv_dtype=kv,
                       rt=plain, quant=quant, dtype=f32)
    require(gaps["f32"][0] <= GREEDY_GAP_TOL < gaps["f32"][1],
            f"{name}: greedy gap {gaps['f32'][0]} against the plain path in f32 (limit "
            f"{GREEDY_GAP_TOL}; shifted control {gaps['f32'][1]})")
    tok_ms, ttft = {"bf16": [], "f32": []}, {"bf16": [], "f32": []}
    for turn, d in (("bf16", bf16_decoder), ("f32", dec), ("f32", dec), ("bf16", bf16_decoder)):
        tok_ms[turn].append(run_generate(d, prompt, tokens)[2])
        ttft[turn].append(first_token_ms(torch, d, prompt))
    log(f"  {name}: GLMDecoder.generate (float32 config, {str(kv)[6:]} cache) captured = "
        f"eager = prefill + multi_step_decode ({len(out)} tokens): {final[:60]!r}; greedy gap "
        f"f32 against the plain path in f32 {gaps['f32'][0]:.4e} (shifted control "
        f"{gaps['f32'][1]:.3e})")
    log(f"  {name} GLMDecoder in turns ({tokens} tokens): ms a token bf16 "
        f"{tok_ms['bf16'][0]:.3f}, f32 {tok_ms['f32'][0]:.3f} / {tok_ms['f32'][1]:.3f}, bf16 "
        f"{tok_ms['bf16'][1]:.3f}; prefill of the {len(ids)}-token prompt (time to first token) "
        f"ms bf16 {ttft['bf16'][0]:.2f}, f32 {ttft['f32'][0]:.2f} / {ttft['f32'][1]:.2f}, bf16 "
        f"{ttft['bf16'][1]:.2f}  [{smi}]")
    log(f"  {name} launch counts of the generate run: "
        f"{json.dumps({k: v for k, v in counts.items() if v})}")
    del dec, dec_eager
    return counts, {"gaps": gaps, "ms_per_token_turns": tok_ms, "first_token_ms_turns": ttft,
                    "replays": step.replays, "text": final[:80]}


def f32_engine_prompts(torch, seed):
    """(a32)'s six greedy prompts of 40-72 tokens, four sharing a 32-token
    head (two 16-row pages: prefix hits), and one sampled; (b32)'s three
    prompts, each repeating an 8-token span (drafts the verify steps test)."""
    g = torch.Generator().manual_seed(seed)

    def ids(n):
        return torch.randint(3, 65000, (n,), generator=g).tolist()

    head = ids(32)
    greedy = dict(temperature=0.0, max_new_tokens=F32_NEW_TOKENS)
    a = [(head + ids(25), greedy), (ids(40), greedy), (ids(72), greedy),
         (ids(50), dict(temperature=0.8, top_p=0.8, max_new_tokens=F32_NEW_TOKENS)),
         (head + ids(40), greedy), (head + ids(9), greedy), (head + ids(33), greedy)]
    b = []
    for _ in range(3):
        span = ids(8)
        b.append((ids(20) + span * 4 + ids(5), greedy))
    return a, b


F32_PAGE, F32_POOL_PAGES, F32_SEQ = 16, 96, 256  # the f32 engines' pool: 16-row pages
# (a32)'s chunks: a chunk of more than 32 rows (S·Hg > 512) attends through
# B5's chunked form over the gathered pages, a shorter one through B11
F32_CHUNK = 64


def engines_f32(torch, smi, params, cfg, seed):
    """Phase 6 in f32 (a float32 config on the tree as a float32 checkpoint
    of it loads), F32_NEW_TOKENS a request on f32_engine_prompts, a pool of
    16-row pages: (a32) chunked admission (64-token chunks: B5's chunked
    form, B11 for a short rest) through the prefix cache, and (b32)
    whole-prompt admission with in-loop speculation
    (k = 4), whose verify steps read the pool through B11, over an f32 pool;
    (a32f8) and (b32f8) the same over an fp8 pool.  Each: budgets, page
    accounting, prefix hits ((a32), (a32f8)), the run's forms launched (B3 /
    B4 never), every greedy token within GREEDY_GAP_TOL of the dense f32
    ``prefill_chunk`` over a cache of the pool's dtype, the shifted stream
    not; tok/s."""
    from chatglm_q_tpu_torch import GLMLoadConfig, TorchRuntimeConfig
    from chatglm_q_tpu_torch.serving import PagedServingEngine

    f32, fp8 = torch.float32, torch.float8_e4m3fn
    params = f16_tree(torch, params, f32)
    load = GLMLoadConfig(model_config=cfg, quant_type="int4g32", torch_dtype="float32")
    a_reqs, b_reqs = f32_engine_prompts(torch, seed)
    pool = dict(num_pages=F32_POOL_PAGES, page_size=F32_PAGE, max_batch=4, max_seq_len=F32_SEQ,
                decode_chunk=16, rt=TorchRuntimeConfig())
    out, counts = {}, {}
    for run, kv in (("a32", None), ("b32", None), ("a32f8", fp8), ("b32f8", fp8)):
        form = "fp8_f32" if kv else "f32"
        if run.startswith("a"):
            reqs = a_reqs
            eng = PagedServingEngine(load, params, prefill_chunk_size=F32_CHUNK,
                                     prefix_cache=True, seed=seed + 3, kv_dtype=kv, **pool)
            want = ("rope_kv_append", "flash_attention_decode_paged",
                    "flash_attention_prefill_chunk")
        else:
            reqs = b_reqs
            eng = PagedServingEngine(load, params, speculative_k=4, speculative_ngram=3,
                                     kv_dtype=kv, **pool)
            want = ("flash_attention_chunk_paged",)
        require(eng.cache.k_pool.dtype == (kv or f32), f"({run}) the pool is "
                                                       f"{eng.cache.k_pool.dtype}")
        done, res = drive(torch, eng, reqs, f"({run}) paged, f32 over {str(kv or f32)[6:]}, "
                          + ("chunked + prefix cache" if run.startswith("a")
                             else "speculative k=4"))
        require(eng.pages_in_use == 0, f"({run}): {eng.pages_in_use} pages in use after the drain")
        if run.startswith("a"):
            require(eng.stats["prefix_hits"] > 0, f"({run}): no prefix hit")
            eng.clear_prefix_cache()
            require(len(eng._free_pages) == F32_POOL_PAGES - 1,
                    f"({run}): {len(eng._free_pages)} pages free after clearing the prefix cache")
        c = res["launches"]
        require(c["int4g32_splitk_f32"] > 0 and c["int4g32_gemv"] == 0
                and c["int4g32_splitk_f32"] == c["int4g32_splitk"]
                and c["int4g32_mma_f32"] == c["int4g32_mma"],
                f"({run}): the f32 linears did not all take B1's f32 forms")
        for k in ("int4g32_splitk", "int4g32_mma"):
            counts[f"{k} f32"] = counts.get(f"{k} f32", 0) + c[f"{k}_f32"]
        counts["split_bf16x3_pass"] = counts.get("split_bf16x3_pass", 0) + c["split_bf16x3_pass"]
        for kern in want:
            require(c[f"{kern}_{form}"] > 0 and c[f"{kern}_{form}"] == c[kern],
                    f"({run}): {kern} launched {c[kern]} times, {c[f'{kern}_{form}']} as {form}")
        if run.startswith("b"):  # a whole prompt attends its fresh K/V, in f32 whatever the pool
            require(c["flash_attention_prefill_f32"] > 0
                    and c["flash_attention_prefill_f32"] == c["flash_attention_prefill"],
                    f"({run}): B5 launched {c['flash_attention_prefill']} times, "
                    f"{c['flash_attention_prefill_f32']} as f32")
        require(c["kv_cache_write_idx"] == 0 and c["flash_attention_decode"] == 0,
                f"({run}) launched B3/B4")
        del eng
        res["gaps"] = greedy_gaps(torch, params, cfg, done, reqs, cache_len=F32_SEQ,
                                  kv_dtype=kv or f32, dtype=f32)
        g = res["gaps"]["f32"]
        require(g[0] <= GREEDY_GAP_TOL and g[1] > GREEDY_GAP_TOL,
                f"({run}): greedy gap {g[0]} against the dense f32 prefill_chunk over "
                f"{str(kv or f32)[6:]} (shifted control {g[1]})")
        log(f"    ({run}) greedy gap f32 {g[0]:.4e} (shifted control {g[1]:.3e}); "
            f"{res['tok_per_s']:.1f} tok/s; prefix hits {res['stats'].get('prefix_hits')}, spec "
            f"accepted {res['stats'].get('spec_accepted')}  [{smi}]")
        out[run] = res
        for k in ("flash_attention_decode_paged", "flash_attention_chunk_paged",
                  "flash_attention_prefill_chunk"):
            counts[f"{k} {form}"] = counts.get(f"{k} {form}", 0) + c[f"{k}_{form}"]
        counts["flash_attention_prefill f32"] = (counts.get("flash_attention_prefill f32", 0)
                                                 + c["flash_attention_prefill_f32"])
        counts[f"rope_kv_append paged {form}"] = (counts.get(f"rope_kv_append paged {form}", 0)
                                                  + c[f"rope_kv_append_{form}"])
    return counts, out


def f32_slice(torch, smi):
    """``--fp32``: phase 2's f32 rows and the f32 runs of phases 5, 6 and 8,
    on their own, with the seconds each part took."""
    from chatglm_q_tpu_torch import ChatGLM2Config, GLMLoadConfig, TorchRuntimeConfig
    from chatglm_q_tpu_torch.bench import random_quantized_params
    from chatglm_q_tpu_torch.serving import GLMDecoder, chat_template

    seconds = {}

    def timed(part, fn, *args):
        t0 = time.perf_counter()
        res = fn(*args)
        seconds[part] = seconds.get(part, 0.0) + time.perf_counter() - t0
        return res

    rows = timed("phase 2", check_f32_kernels, torch)
    cfg = ChatGLM2Config()
    tokenizer = chat_tokenizer()
    prompt = chat_template([], CHAT_QUESTION)
    ids = tokenizer.encode(prompt)
    chat, counts = {}, {}
    for quant in ("int4g32", "int8"):
        params = random_quantized_params(cfg, quant,
                                         torch.Generator(device="cuda").manual_seed(41))
        load = GLMLoadConfig(model_config=cfg, quant_type=quant, torch_dtype="bfloat16")
        decoder = GLMDecoder(load, params, tokenizer, max_sequence_length=CACHE_LEN,
                             rt=TorchRuntimeConfig())
        run_generate(decoder, prompt)  # its programs captured before the turns
        for q, kv_name in F32_CHAT:
            if q == quant:
                kv = None if kv_name == "float32" else getattr(torch, kv_name)
                name = f"{quant} f32" + (" fp8" if kv else "")
                counts[name], chat[name] = timed("phase 5", chat_f32, torch, smi, params, cfg,
                                                 quant, tokenizer, prompt, ids, decoder, kv)
        del decoder
        if quant == "int4g32":
            counts["engines"], engines = timed("phase 6", engines_f32, torch, smi, params, cfg,
                                               61)
        del params
        torch.cuda.empty_cache()
    sharded_counts, sharded = timed("phase 8", lambda: sharded_slice(
        torch, smi, runs=tuple(r[0] for r in SHARDED_FORM_RUNS if "32" in r[0])))
    log(f"  the f32 parts' seconds: {json.dumps(seconds)}")
    return {"rows": rows, "chat": chat, "engines": engines, "sharded": sharded,
            "seconds": seconds,
            "counts": {**{k: {n: v for n, v in c.items() if v} for k, c in counts.items()},
                       "sharded": sharded_counts}}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs on the card",
              file=sys.stderr)
        return 2
    try:
        from chatglm_q_tpu_torch.ops import _build
    except ImportError as e:
        print(f"chip_smoke: run from the root of a checkout ({e})", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    def phase(title):  # a phase's header, with the seconds since the start
        log(f"{title}  [{time.perf_counter() - t_start:.1f} s]")

    phase("== phase 1: card and build")
    smi = nvidia_smi_line()
    log(f"  card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    _build.lib()
    log(f"  kernels built from csrc/ in {time.perf_counter() - t0:.1f} s")
    bw = copy_bandwidth(torch)
    log(f"  device-to-device copy bandwidth {bw / 1e12:.3f} TB/s (the bounds use the published "
        f"{PEAK_HBM_BYTES_PER_S / 1e12:.2f} TB/s)")
    if "--gap-seeds" in sys.argv:
        seeds = sys.argv[sys.argv.index("--gap-seeds") + 1]
        return gap_survey(torch, smi, [int(v) for v in seeds.split(",")])
    if "--f16-train-seeds" in sys.argv:  # phase 7's f16 grads against the plain path
        seeds = sys.argv[sys.argv.index("--f16-train-seeds") + 1]
        return f16_train_survey(torch, smi, [int(v) for v in seeds.split(",")])
    if "--short-seeds" in sys.argv:  # phase 7's 16-token grads against the plain path
        seeds = sys.argv[sys.argv.index("--short-seeds") + 1]
        return short_survey(torch, smi, [int(v) for v in seeds.split(",")])
    if "--nccl" in sys.argv:  # phase 8 alone over NCCL, one card a rank
        tp = int(sys.argv[sys.argv.index("--nccl") + 1])
        require(torch.cuda.device_count() >= tp,
                f"--nccl {tp} needs {tp} cards, found {torch.cuda.device_count()}")
        cards = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                "--format=csv,noheader"], capture_output=True, text=True,
                               check=True).stdout.strip().splitlines()
        phase(f"== phase 8 over NCCL: tensor-parallel serving on a (1, {tp}) mesh, a card a "
            f"rank; cards: {cards}")
        _, sharded_perf = sharded_slice(torch, smi, backend="nccl", tp=tp, layers=28)
        shape = (tp // 2, 2) if tp % 2 == 0 else (1, tp)
        phase(f"== phase 11 over NCCL: training across ranks, a {shape} mesh and {tp} pipeline "
              f"stages, a card a rank")
        _, train_perf = train_mesh_slice(torch, smi, backend="nccl", shape=shape, n_stage=tp)
        log("detail: " + json.dumps({"card": smi, "cards": cards,
                                     "sharded_serving": sharded_perf, "train_mesh": train_perf}))
        log(f"total {time.perf_counter() - t_start:.1f} s")
        return 0
    if "--serving" in sys.argv:  # phases 4, 5, 6 and 9 alone
        phase("== phase 4: ChatGLM2-6B int4g32, 28 layers, 4 requests")
        perf = full_slice(torch, smi)[2]
        torch.cuda.empty_cache()
        phase("== phase 5: GLMDecoder on ChatGLM2-6B int8, int8+dyn, int4g32+dyn, int4g32, 28 "
            "layers")
        chat_perf = chat_slice(torch, smi)[1]
        torch.cuda.empty_cache()
        phase("== phase 6: the serving engines on ChatGLM2-6B int4g32, 28 layers")
        engine_perf = engines_slice(torch, smi)[1]
        torch.cuda.empty_cache()
        phase("== phase 9: the OpenAI-style API server over the paged engine, ChatGLM2-6B "
            "int4g32, 28 layers")
        api_perf = api_slice(torch, smi)
        log("detail: " + json.dumps({"card": smi, "int4g32_28_layers": perf,
                                     "chat_28_layers": chat_perf, "engines_28_layers": engine_perf,
                                     "api_server_28_layers": api_perf}))
        log(f"total {time.perf_counter() - t_start:.1f} s")
        return 0
    if "--sharded" in sys.argv:  # phase 2's sharded rows and phase 8 alone
        phase("== phase 2 (sharded forms): K1, K2, K3 against their plain versions")
        sharded_rows = check_sharded_attention(torch)
        phase("== phase 8: tensor-parallel serving, 2 ranks on this card")
        _, sharded_perf = sharded_slice(torch, smi)
        log("detail: " + json.dumps({"card": smi, "sharded_rows": sharded_rows,
                                     "sharded_serving": sharded_perf}))
        log(f"total {time.perf_counter() - t_start:.1f} s")
        return 0
    if "--train-mesh" in sys.argv:  # phase 2's tp = 2 rows and phase 11 alone
        phase("== phase 2 (tp = 2 shard shapes): B1, B6, B13, B14 against their plain versions")
        tp2_rows = check_shard_matmuls(torch)
        phase(f"== phase 11: training across ranks, ChatGLM2-6B widths, {TM_LAYERS} layers, a "
              "(1, 2) mesh and 2 pipeline stages of gloo ranks sharing this card")
        _, train_perf = train_mesh_slice(torch, smi)
        log("detail: " + json.dumps({"card": smi, "tp2_rows": tp2_rows,
                                     "train_mesh": train_perf}))
        log(f"total {time.perf_counter() - t_start:.1f} s")
        return 0
    if "--phase12" in sys.argv:  # phase 12 alone
        phase("== phase 12: the plan table, torch.export of the decode step, the launchers")
        p12 = phase12(torch, smi)
        log("detail: " + json.dumps({"card": smi, "phase12": p12}))
        log(f"total {time.perf_counter() - t_start:.1f} s")
        return 0
    if "--programs" in sys.argv:  # phase 4's captured prefill, phase 7 and phase 12
        from chatglm_q_tpu_torch import ChatGLM2Config
        from chatglm_q_tpu_torch.bench import random_quantized_params

        phase("== phase 4 (captured prefill): ChatGLM2-6B int4g32, 28 layers")
        cfg = ChatGLM2Config()
        params = random_quantized_params(cfg, "int4g32",
                                         torch.Generator(device="cuda").manual_seed(31))
        prefill = captured_prefill(torch, params, cfg, smi)
        del params
        torch.cuda.empty_cache()
        phase("== phase 7: fine-tuning ChatGLM2-6B, 28 layers, int4g32 then int8")
        ft = fine_tune_slice(torch, smi)[1]
        torch.cuda.empty_cache()
        phase("== phase 12: the plan table, torch.export of the decode step, the launchers")
        p12 = phase12(torch, smi)
        log("detail: " + json.dumps({"card": smi, "captured_prefill": prefill,
                                     "fine_tune_28_layers": ft, "phase12": p12}))
        log(f"total {time.perf_counter() - t_start:.1f} s")
        return 0
    if "--quant" in sys.argv:  # phase 10 alone, then the 28-layer GPTQ
        phase("== phase 10: the quantizers at ChatGLM2-6B widths, 2 layers")
        _, quant_perf, _ = quant_slice(torch, smi)
        log("== GPTQ int4g32 of ChatGLM2-6B, 28 layers")
        quant_perf["gptq_int4g32_28_layers"] = quant_28_layers(torch, smi)
        log("detail: " + json.dumps({"card": smi, "quant_2_layers": quant_perf}))
        log(f"total {time.perf_counter() - t_start:.1f} s")
        return 0
    if "--fp16-seeds" in sys.argv:  # phase 2's f16 readings per seed (the f16 limits)
        seeds = sys.argv[sys.argv.index("--fp16-seeds") + 1]
        return f16_survey(torch, smi, [int(v) for v in seeds.split(",")])
    if "--fp16" in sys.argv:  # the float16 rows and runs alone
        phase("== float16 activations: phase 2's f16 rows, the f16 runs of phases 5, 6 and 7, "
              "the float16-checkpoint launcher")
        res = f16_slice(torch, smi)
        log("detail: " + json.dumps({"card": smi, "f16": res}))
        log(f"total {time.perf_counter() - t_start:.1f} s")
        return 0
    if "--fp32" in sys.argv:  # the float32 rows and runs alone
        phase("== float32 activations: phase 2's f32 rows, the f32 runs of phases 5, 6 and 8")
        res = f32_slice(torch, smi)
        log("detail: " + json.dumps({"card": smi, "f32": res}))
        log(f"total {time.perf_counter() - t_start:.1f} s")
        return 0
    if "--fp32-readings" in sys.argv:  # phase 2's f32 matmul rows, readings unheld (F32_SUM_C)
        phase("== float32 activations: B1's and B6's f32 rows, the sweep, the readings")
        tf32_off(torch)
        rows, readings, sweep, split = check_f32_matmul(torch, calibrate=True)
        log("detail: " + json.dumps({"card": smi, "f32_matmul_rows": rows,
                                     "f32_matmul_readings": readings, "f32_matmul_sweep": sweep,
                                     "f32_split_pass": split}))
        log(f"total {time.perf_counter() - t_start:.1f} s")
        return 0
    if "--fp8" in sys.argv:  # the fp8 cache's rows and runs alone
        phase("== the float8_e4m3fn KV cache: phase 2's fp8 rows, the fp8 runs of phases 5, 6 "
              "and 8, the long-context step")
        res = fp8_slice(torch, smi)
        log("detail: " + json.dumps({"card": smi, "fp8": res}))
        log(f"total {time.perf_counter() - t_start:.1f} s")
        return 0

    phase("== phase 2: kernels against their plain versions (bf16, main-path shapes)")
    mm_rows, crossover, splitk_crossover = check_matmul(torch)
    int8_rows = check_int8_matmul(torch)
    dyn_division = check_dyn_division(torch, smi)
    t_rows = check_transposed(torch)
    tp2_rows = check_shard_matmuls(torch)
    att = check_attention(torch)
    att.update(check_paged_attention(torch))
    att["edge_cases_max_rel_err"] = check_attention_edges(torch)
    att.update(check_sharded_attention(torch))
    phase("== phase 2 (fp8 cache): every attention kernel's float8_e4m3fn form")
    att_fp8 = check_fp8_attention(torch)
    att["fp8_store"] = att_fp8.pop("store")
    att.update(att_fp8)
    phase("== phase 2 (f16): B1, B6, B7, B8, B13, B14 and every attention kernel's float16 "
          "form, over an f16 and an fp8 cache")
    f16_rows = check_f16_kernels(torch)
    att.update(f16_rows["attention"])
    att["f16_fp8_store"] = f16_rows["fp8_store"]
    phase("== phase 2 (f32): B1's and B6's float32 forms (x's bf16 pieces on the tensor cores) "
          "and every attention kernel's float32 form, over an f32 and an fp8 cache")
    f32_rows = check_f32_kernels(torch)
    att.update(f32_rows["attention"])
    att["f32_fp8_store"] = f32_rows["fp8_store"]
    att["edge_cases_f32_max_rel_err"] = f32_rows["edge_cases_max_rel_err"]

    phase("== phase 3: end to end, 6B widths at depth 2, kernel path vs plain path")
    e2e = {mode_name(q, d): end_to_end_parity(torch, q, d) for q, d in PARITY_MODES}
    e2e["int4g32 decode_attn_v2"] = end_to_end_parity(torch, "int4g32", False, v2=True)
    f32_counts = {}
    for quant in F32_KERNELS:
        e2e[f"{quant} f32 forward"], f32_counts[quant] = f32_forward_parity(torch, quant)

    phase("== phase 3b: gradients at 6B widths, depth 2, bf16, 2 x 128 tokens, kernel path vs "
        "plain path")
    grads = check_grad_parity(torch)

    phase("== phase 4: ChatGLM2-6B int4g32, 28 layers, 4 requests")
    counts, v2_counts, perf = full_slice(torch, smi)
    torch.cuda.empty_cache()

    phase("== phase 5: GLMDecoder on ChatGLM2-6B int8, int8+dyn, int4g32+dyn, int4g32, 28 layers")
    chat_counts, chat_perf = chat_slice(torch, smi)
    torch.cuda.empty_cache()

    phase("== phase 6: the serving engines on ChatGLM2-6B int4g32, 28 layers")
    engine_counts, engine_perf = engines_slice(torch, smi)
    torch.cuda.empty_cache()

    phase("== phase 7: fine-tuning ChatGLM2-6B, 28 layers, int4g32 then int8, through the frozen "
        "quantized weights")
    ft_counts, ft_perf = fine_tune_slice(torch, smi)
    torch.cuda.empty_cache()

    phase(f"== phase 8: tensor-parallel serving of ChatGLM2-6B int4g32, {SHARD_LAYERS} layers, on "
          "a (1, 2) mesh of two gloo ranks sharing this card")
    sharded_counts, sharded_perf = sharded_slice(torch, smi)

    phase("== phase 9: the OpenAI-style API server over the paged engine, ChatGLM2-6B int4g32, "
        "28 layers")
    api_perf = api_slice(torch, smi)
    torch.cuda.empty_cache()

    phase("== phase 10: the quantizers at ChatGLM2-6B widths, 2 layers")
    quant_counts, quant_perf, sweep_entries = quant_slice(torch, smi)
    torch.cuda.empty_cache()

    phase(f"== phase 11: training across ranks, ChatGLM2-6B widths, {TM_LAYERS} layers, a (1, 2) "
          "mesh and 2 pipeline stages of gloo ranks sharing this card")
    train_counts, train_perf = train_mesh_slice(torch, smi)
    for kern in ("int4g32_mma", "int4g32_t_mma", "int8_mma", "int8_t_mma"):
        require(train_counts.get(kern, 0) > 0, f"phase 11: no {kern} launch")
    torch.cuda.empty_cache()

    phase("== phase 12: the plan table, torch.export of the decode step, the launchers")
    p12 = phase12(torch, smi)

    # the kernels line: per kernel, its representative main-path shape, and
    # its launches from the main-path run that drives it
    def pick(kernel, M, name="w_in_h/w_in_gate"):
        return next(r for r in mm_rows + int8_rows + t_rows if r["kernel"] == kernel
                    and r["M"] == M and r["linear"] == name)

    mm4, mm8, dyn = ("chatglm_q_tpu_torch/csrc/int4_matmul.cu",
                     "chatglm_q_tpu_torch/csrc/int8_matmul.cu",
                     "chatglm_q_tpu_torch/csrc/dyn_matmul.cu")
    att_src, pm, pa = ("chatglm_q_tpu_torch/csrc/attention.cu",
                       "chatglm_q_tpu/ops/pallas_matmul.py", "chatglm_q_tpu/ops/pallas_attention.py")
    gq, jg = "chatglm_q_tpu_torch/csrc/gptq.cu", "chatglm_q_tpu/quant/gptq.py"
    specs = [
        ("int4g32_splitk", mm4, f"{pm}:826", pick("int4g32_splitk", 1), counts),
        ("int4g32_mma", mm4, f"{pm}:244", pick("int4g32_mma", 512), counts),
        ("int8_splitk", mm8, f"{pm}:188", pick("int8_splitk", 1), chat_counts["int8"]),
        ("int8_mma", mm8, f"{pm}:188", pick("int8_mma", 512), chat_counts["int8"]),
        ("int8_dyn_splitk", dyn, f"{pm}:960", pick("int8_dyn_splitk", 1),
         chat_counts["int8+dyn"]),
        ("int8_dyn_mma", dyn, f"{pm}:960", pick("int8_dyn_mma", 64), chat_counts["int8+dyn"]),
        ("int4_dyn_splitk", dyn, f"{pm}:1040", pick("int4_dyn_splitk", 1),
         chat_counts["int4g32+dyn"]),
        ("int4_dyn_mma", dyn, f"{pm}:1040", pick("int4_dyn_mma", 64), chat_counts["int4g32+dyn"]),
        ("rope_kv_append", att_src, f"{pa}:427", att["rope_kv_append"], counts),
        ("int4g32_t_splitk", mm4, f"{pm}:671", pick("int4g32_t_splitk", 16),
         ft_counts["int4g32"]),
        ("int4g32_t_gemv", mm4, f"{pm}:671", pick("int4g32_t_gemv", 8), f32_counts["int4g32"]),
        ("int4g32_t_mma", mm4, f"{pm}:671", pick("int4g32_t_mma", 512), ft_counts["int4g32"]),
        ("int8_t_splitk", mm8, f"{pm}:653", pick("int8_t_splitk", 16), ft_counts["int8"]),
        ("int8_t_gemv", mm8, f"{pm}:653", pick("int8_t_gemv", 8), f32_counts["int8"]),
        ("int8_t_mma", mm8, f"{pm}:653", pick("int8_t_mma", 512), ft_counts["int8"]),
        ("flash_attention_decode", att_src, f"{pa}:207", att["flash_attention_decode"], counts),
        ("flash_attention_decode_v2", att_src, f"{pa}:662", att["flash_attention_decode_v2"],
         v2_counts),
        ("flash_attention_prefill", att_src, f"{pa}:43", att["flash_attention_prefill"], counts),
        ("flash_attention_prefill_chunk", att_src, f"{pa}:43",
         att["flash_attention_prefill_chunk"], engine_counts),
        ("rope_kv_append paged", att_src, f"{pa}:480", att["rope_kv_append paged"],
         engine_counts),
        ("flash_attention_decode_paged", att_src, f"{pa}:787",
         att["flash_attention_decode_paged"], engine_counts),
        ("flash_attention_chunk_paged", att_src, f"{pa}:951",
         att["flash_attention_chunk_paged S=9"], engine_counts),
        ("flash_attention_decode_lse", att_src, f"{pa}:207",
         att["flash_attention_decode_lse"], sharded_counts),
        ("flash_attention_decode_paged_lse", att_src, f"{pa}:787",
         att["flash_attention_decode_paged_lse"], sharded_counts),
        ("rope_kv_append_sharded", att_src, f"{pa}:427", att["rope_kv_append_sharded"],
         sharded_counts),
        ("rope_kv_append_sharded paged", att_src, f"{pa}:480",
         att["rope_kv_append_sharded paged"], sharded_counts),
        # no pallas_call: the JAX package's jitted lax.fori_loop sweeps
        ("gptq_sweep_int8", gq, f"{jg}:100", {**sweep_entries["int8"], "library_ms": None},
         quant_counts["int8"]),
        ("gptq_sweep_int4", gq, f"{jg}:141", {**sweep_entries["int4"], "library_ms": None},
         quant_counts["int4g32"]),
    ]
    # the fp8-cache forms: launches from the runs over an fp8 cache (phase 5's
    # GLMDecoder, phase 6's (a8) / (b8) and long-context step, phase 8's (a8) / (b8))
    cf = chat_counts["int4g32 fp8"]
    fp8_runs = {"rope_kv_append fp8": cf["rope_kv_append_fp8"],
                "flash_attention_decode fp8": cf["flash_attention_decode_fp8"],
                "flash_attention_prefill fp8": cf["flash_attention_prefill_fp8"],
                **{k: v for k, v in engine_counts.items() if k.endswith(" fp8")},
                **{k: v for k, v in sharded_counts.items() if k.endswith(" fp8")}}
    # the float16 forms: launches from the f16 runs (phase 5's float16-config
    # GLMDecoder in int4g32 and int8, phase 6's (a16)); their rows phase 2's
    c16, c8 = chat_counts["int4g32 f16"], chat_counts["int8 f16"]
    f16_runs = {"int4g32_splitk f16": c16["int4g32_splitk_f16"],
                "int4g32_mma f16": engine_counts["int4g32_mma f16"],
                "int8_splitk f16": c8["int8_splitk_f16"], "int8_mma f16": c8["int8_mma_f16"],
                **{k + " f16": c16[k + "_f16"] for k in (
                    "rope_kv_append", "flash_attention_decode", "flash_attention_decode_v2",
                    "flash_attention_prefill")},
                **{k: v for k, v in engine_counts.items() if k.endswith(" f16")}}

    # the other float16 forms: B7 / B8 from phase 5's float16-config dynamic
    # GLMDecoder runs, B13 / B14 from phase 7's f16 fine-tuning, and the
    # attention kernels over an fp8 cache from phase 5's int4g32 f16 fp8 run
    # and phase 6's (a16f8)
    c8d, c4d, c16f8 = (chat_counts["int8+dyn f16"], chat_counts["int4g32+dyn f16"],
                       chat_counts["int4g32 f16 fp8"])
    f16_runs.update({
        "int8_dyn_splitk f16": c8d["int8_dyn_splitk_f16"],
        "int8_dyn_mma f16": c8d["int8_dyn_mma_f16"],
        "int4_dyn_splitk f16": c4d["int4_dyn_splitk_f16"],
        "int4_dyn_mma f16": c4d["int4_dyn_mma_f16"],
        **{f"{k} f16": ft_counts[q][k + "_f16"] for q, k in (
            ("int8", "int8_t_splitk"), ("int8", "int8_t_mma"),
            ("int4g32", "int4g32_t_splitk"), ("int4g32", "int4g32_t_mma"))},
        **{k + " fp8_f16": c16f8[k + "_fp8_f16"] for k in (
            "rope_kv_append", "flash_attention_decode", "flash_attention_decode_v2",
            "flash_attention_prefill")},
        **{k: v for k, v in engine_counts.items() if k.endswith(" fp8_f16")}})

    def pick16(kernel, M, name="w_in_h/w_in_gate"):
        return next(r for r in f16_rows["matmul"] if r["kernel"] == kernel and r["M"] == M
                    and r["linear"] == name)

    for name, src, line, row in (
            ("int4g32_splitk f16", mm4, f"{pm}:826", pick16("int4g32_splitk", 1)),
            ("int4g32_mma f16", mm4, f"{pm}:244", pick16("int4g32_mma", 512)),
            ("int8_splitk f16", mm8, f"{pm}:188", pick16("int8_splitk", 1)),
            ("int8_mma f16", mm8, f"{pm}:188", pick16("int8_mma", 512)),
            ("rope_kv_append f16", att_src, f"{pa}:427", att["rope_kv_append f16"]),
            ("flash_attention_decode f16", att_src, f"{pa}:207", att["flash_attention_decode f16"]),
            ("flash_attention_decode_v2 f16", att_src, f"{pa}:662",
             att["flash_attention_decode_v2 f16"]),
            ("flash_attention_prefill f16", att_src, f"{pa}:43",
             att["flash_attention_prefill f16"]),
            ("flash_attention_prefill_chunk f16", att_src, f"{pa}:43",
             att["flash_attention_prefill_chunk f16"]),
            ("rope_kv_append paged f16", att_src, f"{pa}:480", att["rope_kv_append paged f16"]),
            ("flash_attention_decode_paged f16", att_src, f"{pa}:787",
             att["flash_attention_decode_paged f16"]),
            ("int8_dyn_splitk f16", dyn, f"{pm}:960", pick16("int8_dyn_splitk", 1)),
            ("int8_dyn_mma f16", dyn, f"{pm}:960", pick16("int8_dyn_mma", 512)),
            ("int4_dyn_splitk f16", dyn, f"{pm}:1040", pick16("int4_dyn_splitk", 1)),
            ("int4_dyn_mma f16", dyn, f"{pm}:1040", pick16("int4_dyn_mma", 36)),
            ("int8_t_splitk f16", mm8, f"{pm}:653", pick16("int8_t_splitk", 16)),
            ("int8_t_mma f16", mm8, f"{pm}:653", pick16("int8_t_mma", 512)),
            ("int4g32_t_splitk f16", mm4, f"{pm}:671", pick16("int4g32_t_splitk", 16)),
            ("int4g32_t_mma f16", mm4, f"{pm}:671", pick16("int4g32_t_mma", 512))):
        specs.append((name, src, line, row, f16_runs))
    for name, line, row in (
            ("rope_kv_append fp8_f16", 427, "rope_kv_append fp8_f16"),
            ("flash_attention_decode fp8_f16", 207, "flash_attention_decode fp8_f16"),
            ("flash_attention_decode_v2 fp8_f16", 662, "flash_attention_decode_v2 fp8_f16"),
            ("flash_attention_prefill fp8_f16", 43, "flash_attention_prefill fp8_f16"),
            ("flash_attention_prefill_chunk fp8_f16", 43, "flash_attention_prefill_chunk fp8_f16"),
            ("rope_kv_append paged fp8_f16", 480, "rope_kv_append paged fp8_f16"),
            ("flash_attention_decode_paged fp8_f16", 787, "flash_attention_decode_paged fp8_f16")):
        r = att[row]
        r["bf16_ms"] = att[row.replace(" fp8_f16", " fp8")]["ms"]  # bf16 over the same fp8 cache
        specs.append((name, att_src, f"{pa}:{line}", r, f16_runs))
    for name, line, row in (
            ("rope_kv_append fp8", 427, "rope_kv_append fp8"),
            ("flash_attention_decode fp8", 207, "flash_attention_decode fp8"),
            ("flash_attention_decode_v2 fp8", 662, "flash_attention_decode_v2 fp8"),
            ("flash_attention_prefill fp8", 43, "flash_attention_prefill fp8"),
            ("flash_attention_prefill_chunk fp8", 43, "flash_attention_prefill_chunk fp8"),
            ("rope_kv_append paged fp8", 480, "rope_kv_append paged fp8"),
            ("flash_attention_decode_paged fp8", 787, "flash_attention_decode_paged fp8"),
            ("flash_attention_chunk_paged fp8", 951, "flash_attention_chunk_paged S=9 fp8"),
            ("flash_attention_decode_lse fp8", 207, "flash_attention_decode_lse fp8"),
            ("flash_attention_decode_paged_lse fp8", 787, "flash_attention_decode_paged_lse fp8"),
            ("rope_kv_append_sharded fp8", 427, "rope_kv_append_sharded fp8"),
            ("rope_kv_append_sharded paged fp8", 480, "rope_kv_append_sharded paged fp8")):
        specs.append((name, att_src, f"{pa}:{line}", att[row], fp8_runs))
    # the float32 forms (the CUDA-core kernels): launches from the f32 runs
    # (phase 5's float32-config GLMDecoder in int4g32, int8 and int4g32 over
    # fp8, phase 6's (a32), (b32), (a32f8), (b32f8), phase 8's (a32), (b32),
    # (a32f8), (b32f8)); their rows phase 2's
    c4, c8f, c48 = (chat_counts["int4g32 f32"], chat_counts["int8 f32"],
                    chat_counts["int4g32 f32 fp8"])
    # B1's and B6's f32 forms and their split pass: launches from the same
    # f32 runs (phase 5's decoders, phase 6's and phase 8's int4g32 engines)
    f32_mm = {f"{k} f32": sum(c[f"{k}_f32"] for c in (c4, c8f, c48))
              + engine_counts.get(f"{k} f32", 0) + sharded_counts.get(f"{k} f32", 0)
              for k in ("int4g32_splitk", "int4g32_mma", "int8_splitk", "int8_mma")}
    f32_mm["split_bf16x3_pass"] = (sum(c["split_bf16x3_pass"] for c in (c4, c8f, c48))
                                   + engine_counts.get("split_bf16x3_pass", 0)
                                   + sharded_counts.get("split_bf16x3_pass", 0))

    def pick32(kernel, M, name="w_in_h/w_in_gate"):
        return next(r for r in f32_rows["matmul"] if r["kernel"] == kernel and r["M"] == M
                    and r["linear"] == name)

    for name, src, line, row in (
            ("int4g32_splitk f32", mm4, f"{pm}:826", pick32("int4g32_splitk", 1)),
            ("int4g32_mma f32", mm4, f"{pm}:244", pick32("int4g32_mma", 512)),
            ("int8_splitk f32", mm8, f"{pm}:188", pick32("int8_splitk", 1)),
            ("int8_mma f32", mm8, f"{pm}:188", pick32("int8_mma", 512)),
            # no pallas_call of its own: part of the f32 forms of :244 and :188
            ("split_bf16x3_pass", mm4, f"{pm}:244", f32_rows["split_pass"])):
        specs.append((name, src, line, row, f32_mm))
    f32_runs = {**{k: v for k, v in engine_counts.items() if k.endswith(("f32", "fp8_f32"))},
                **{k: v for k, v in sharded_counts.items() if k.endswith(("f32", "fp8_f32"))}}
    for form, cc in (("f32", (c4, c8f)), ("fp8_f32", (c48,))):
        for k in ("rope_kv_append", "flash_attention_decode", "flash_attention_decode_v2"):
            f32_runs[f"{k} {form}"] = sum(c[f"{k}_{form}"] for c in cc)
        f32_runs[f"flash_attention_prefill {form}"] = (
            f32_runs.get(f"flash_attention_prefill {form}", 0)
            + sum(c[f"flash_attention_prefill_{form}"] for c in cc))
        for name, line, row in (
                ("rope_kv_append", 427, "rope_kv_append"),
                ("flash_attention_decode", 207, "flash_attention_decode"),
                ("flash_attention_decode_v2", 662, "flash_attention_decode_v2"),
                ("flash_attention_prefill", 43, "flash_attention_prefill"),
                ("flash_attention_prefill_chunk", 43, "flash_attention_prefill_chunk"),
                ("rope_kv_append paged", 480, "rope_kv_append paged"),
                ("flash_attention_decode_paged", 787, "flash_attention_decode_paged"),
                ("flash_attention_chunk_paged", 951, "flash_attention_chunk_paged S=9"),
                ("flash_attention_decode_lse", 207, "flash_attention_decode_lse"),
                ("flash_attention_decode_paged_lse", 787, "flash_attention_decode_paged_lse"),
                ("rope_kv_append_sharded", 427, "rope_kv_append_sharded"),
                ("rope_kv_append_sharded paged", 480, "rope_kv_append_sharded paged")):
            r = att[f"{row} {form}"]
            if form == "fp8_f32":  # bf16 over the same fp8 cache
                r["bf16_ms"] = att[f"{row} fp8"]["ms"]
            specs.append((f"{name} {form}", att_src, f"{pa}:{line}", r, f32_runs))
    entries = []
    for name, src, replaces, r, run_counts in specs:
        require(run_counts[name] > 0, f"{name}: no launch on its main-path run")
        shape = r.get("shape") or f"M={r['M']} K={r['K']} N={r['N']} ({r['linear']})"
        if "dtype" in r:  # a backward matmul: g (M, N) → (M, K)
            shape = f"g (M={r['M']}, N={r['N']}) {r['dtype']} -> K={r['K']} ({r['linear']})"
        elif r.get("x_dtype") in ("float32", "float16"):
            shape += " f32" if r["x_dtype"] == "float32" else " f16"
        entries.append({"name": name, "route": "cuda", "source": src, "replaces": replaces,
                        "launches": run_counts[name], "max_abs_err": r["max_abs_err"],
                        "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"], "library_ms": r["library_ms"],
                        "shape": shape})
        base = name.removesuffix(" f16").removesuffix(" f32")
        if base in CUDA_KERNEL:
            entries[-1]["kernel"] = CUDA_KERNEL[base] + (f" ({name[len(base) + 1:]} form)"
                                                         if base != name else "")
        if "gemv_ms" in r:  # an f32 form: the CUDA-core gemv's time in turns beside it
            entries[-1]["gemv_ms"] = r["gemv_ms"]
            entries[-1]["cuda_core_ops_ms"] = r["cuda_core_ops_ms"]
        if "old_path_ms" in r:
            entries[-1]["old_path_ms"] = r["old_path_ms"]
        if r.get("bf16_ms") is not None:  # an fp8 or f16 form: its bf16 form's time beside it
            entries[-1]["bf16_form_ms"] = r["bf16_ms"]
        if r.get("f16_ms") is not None:  # f16 over fp8: the f16 form on the upcast cache
            entries[-1]["f16_form_ms"] = r["f16_ms"]
        if r.get("f32_ms") is not None:  # f32 over fp8: the f32 form on the upcast cache
            entries[-1]["f32_form_ms"] = r["f32_ms"]
    detail = {"card": smi, "matmul_rows": mm_rows + int8_rows, "transposed_rows": t_rows,
              "f16_matmul_rows": f16_rows["matmul"],
              "f32_matmul_rows": f32_rows["matmul"], "f32_matmul_sweep": f32_rows["matmul_sweep"],
              "f32_matmul_readings": f32_rows["matmul_readings"],
              "f32_split_pass": f32_rows["split_pass"],
              "b8_b1_crossover": crossover, "b1_splitk_mma_crossover": splitk_crossover,
              "dyn_division": dyn_division,
              "attention": att, "e2e_rel_err": e2e,
              "grad_parity": grads, "int4g32_28_layers": perf, "chat_28_layers": chat_perf,
              "engines_28_layers": engine_perf, "api_server_28_layers": api_perf,
              "fine_tune_28_layers": ft_perf,
              "sharded_serving": sharded_perf, "quant_2_layers": quant_perf,
              "tp2_rows": tp2_rows, "train_mesh": train_perf, "phase12": p12}
    log("detail: " + json.dumps(detail))
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": entries}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

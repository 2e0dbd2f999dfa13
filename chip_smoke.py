"""Chip smoke test of the PyTorch/CUDA port (chatglm_q_tpu_torch) on one GPU.

Run from the root of a checkout, on a machine with an NVIDIA H100:

    python3 chip_smoke.py    # all phases, a few minutes with the build
    python3 chip_smoke.py --gap-seeds 61,71,81    # phase 6's greedy readings alone, per seed
    python3 chip_smoke.py --sharded    # phase 2's sharded rows (K1, K2, K3) and phase 8 alone
    python3 chip_smoke.py --nccl 4    # phase 8 alone over NCCL on 4 cards, one a rank
    python3 chip_smoke.py --serving    # phases 4, 5, 6 and 9 alone (the captured decode)
    python3 chip_smoke.py --quant    # phase 10 alone, then GPTQ int4g32 of the 28-layer model

Phases (any failure raises and exits non-zero):

1. Card and build: the card's name and power limit, torch/CUDA versions,
   the kernels built from csrc/ (build seconds), and the device-to-device
   copy bandwidth (for comparison with the published rate the bounds use).
2. Each CUDA kernel against its plain PyTorch version on the card, at the
   shapes of the ChatGLM2-6B main paths (B1 at M = 1, 4, 16, 20, 32, 36, 48,
   128, 512 and 1024 in bf16 and M = 1 in f32; the paged kernels at a 64-page pool
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
   B1's M in bf16 and M = 1 in f32, its bf16 rows (the split-K kernel at M
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
   shapes transposed, M = 512 and 1024 bf16, M = 16 bf16 (phase 7's 16-token step)
   and M = 8 f32, the Hopper rows of B1, B6, B13 and B14 also within
   ``SUM_TOL`` of their exact value beyond its bf16 rounding and beside a
   cuBLAS dense product on bf16 weights (``dense_ms``); B12
   (``flash_attention_decode_v2``) beside B4's row, held also to its own
   limit on the error beyond the output's bf16 rounding (``B12_TOL``), with
   a control that rounds p to bf16 and must exceed it, and B10 / B11 (the
   paged decode and chunk attention) likewise to ``B10_TOL`` / ``B11_TOL``,
   each called twice for a bit-equal result; B4 at the decoder's
   batch-1 shape (lengths 140 of 1024), B5 (both forms), and the decode and
   prefill kernels at the edge cases their main-path shapes miss
   (``check_attention_edges``).
3. End to end at full width and depth 2: the kernel path against the plain
   path on the same random weights, prefill then 8 teacher-forced decode
   steps, for int4g32, int8, int8 with dynamic int8 activations and
   int4g32 with dynamic int8 activations, and int4g32 with
   ``decode_attn_v2`` (B12, never B4), with control bugs that must fail
   the same limit; then the f32 parity forward (``models.chatglm2.forward``)
   in int4g32 and in int8, whose linears take B1's and B6's CUDA-core
   gemvs, within ``F32_E2E_TOL`` of the plain path (the launches of those
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
   traced the same way, ``int4_wgmma_kernel``'s 168 launches apart.
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
   for int8 and int4g32, with identical tensors and equal logits.
6. The serving engines at full size: ChatGLM2-6B (28 layers) int4g32 with
   random weights, no tokenizer (eos id 2), token-id prompts from a seeded
   generator.  (a) ``PagedServingEngine`` with 256-token chunked admission
   and the prefix cache: six greedy requests of 300-1100 tokens, four
   sharing a 512-token head, and one top-p request, 64 new tokens each;
   (b) the paged engine with whole-prompt admission and in-loop speculation
   (k = 8) on three prompts repeating a 40-token span, and the same without
   speculation (the tokens they share are reported); (c) the dense
   ``ServingEngine`` with chunked admission and lookahead on four of (a)'s
   prompts.  Checks: every request finishes within its budget; no page in
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
   a compact batch; (b)'s speculation steps too); each run is driven again
   from eager launches (``cuda_graphs=False``), its greedy tokens equal,
   with its tokens/s, time to first token and (a), (c) busy share.
7. Fine-tuning at full size through the frozen quantized weights
   (``utils/train.py``): ChatGLM2-6B (28 layers) int4g32, AdamW (lr 1e-3)
   over the 233,472 f32 norm values, 4 steps on one seeded batch of 2 x 512
   tokens (the first 64 labels ignored): a falling loss, 169 B1 and 169 B14
   launches a step, the first step's loss and grads again with
   ``remat_layers`` within phase 3b's limits, one 16-token step (the
   CUDA-core B14), every frozen leaf bit-unchanged; then the int8 tree for
   3 steps (B6 and B13).  ms and tokens/s a step, peak device memory, and
   for each tree a traced step's device time by kernel, with its forward
   and backward Hopper kernels' shares (B1 and B14, B6 and B13).

8. Tensor-parallel serving at full size: the 28-layer int4g32 tree built
   once, saved under the build directory and memory-mapped by two spawned
   ranks of a (1, 2) mesh (gloo, both on this card), each taking its slice
   (``shard_params``).  (a) ``DistributedServingEngine`` with ``kv_shard_t``
   (an 8192-slot cache, 4096 a rank): five prompts of 512-4200 tokens
   through ring prefill, the longest crossing into rank 1's slots; (b) ``DistributedPagedServingEngine(
   shard_model_pages=True)``, pages of 256 split by phase, chunked
   admission with the prefix cache: phase 6 (a)'s six greedy prompts; 32
   greedy tokens each.  Checks: the ranks token-equal, every request within
   its budget, K1 / K2 and K3 launched 28 times a decode step on each rank
   and the unsharded decode forms never, every shard the traffic reaches
   live in the decode merges on every rank, every greedy token within
   ``GREEDY_GAP_TOL`` of the single-device dense ``prefill_chunk``
   reference (phase 6's ``greedy_gaps``) and the shifted stream not.  Then
   decode-only steps on four 256-token prompts: ms a decode step, the
   collectives it runs and the host ms in them, per rank (gloo through the
   host on one card: a correctness run, not a multi-GPU speed figure).
   Phase 2 holds K1 (a T-shard), K2 (each phase of a strided table) and K3
   (dense and paged, bit for bit) against their plain versions, the
   shards merged against the unsharded function in f32 within the
   roundings the design allows (``hold_merge``).  The mesh decodes from
   eager launches: it refuses CUDA-graph capture.
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
# The f32 parity forward (phase 3) at depth 2 through B1's CUDA-core gemv
# against the plain path: f32 sums in another order, carried through two
# layers of norms, attention and six linears.  On an H100 it read 1.35e-6,
# the wrong-scale control 2.0e-1.
F32_E2E_TOL = 1e-5
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
# B13/B14 rows: the tensor-core kernel at a 4 x 128 batch and at training's
# M = 1024; the CUDA-core kernels at phase 7's 16-token step (bf16, M = 16:
# the row the kernels line reports) and in f32
T_ROWS = ((512, "bfloat16"), (1024, "bfloat16"), (16, "bfloat16"), (8, "float32"))
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


def beyond_sum(torch, got, exact, terms) -> float:
    """The largest error of a bf16 output beyond half a bf16 ulp of its
    exact value (f64), over the sum of its terms' magnitudes (f64)."""
    half_ulp = torch.ldexp(torch.ones_like(exact), torch.frexp(exact).exponent - 9)
    excess = ((got.double() - exact).abs() - half_ulp).clamp_min(0.0)
    return (excess / terms.clamp_min(1e-300)).max().item()


def hold_sum(torch, name, got, exact, terms) -> float:
    b = beyond_sum(torch, got, exact, terms)
    require(b <= SUM_TOL, f"{name}: error beyond the bf16 rounding {b:.3e} of sum|terms| "
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
               "int4g32_t_mma": "t_wgmma_kernel<Int4TView> (csrc/common.cuh)",
               "int4g32_t_gemv": "t_gemv_kernel<Int4TView> (csrc/common.cuh)",
               "int8_t_mma": "t_wgmma_kernel<Int8TView> (csrc/common.cuh)",
               "int8_t_gemv": "t_gemv_kernel<Int8TView> (csrc/common.cuh)",
               "rope_kv_append": "rope_kv_append_kernel<DenseKV, true>",
               "rope_kv_append paged": "rope_kv_append_kernel<PagedKV, true>",
               "gptq_sweep_int8": "gptq_sweep_kernel<false>",
               "gptq_sweep_int4": "gptq_sweep_kernel<true>"}


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
        for M, dtype in [(m, torch.bfloat16) for m in MATMUL_M] + [(1, torch.float32)]:
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


def int8_library(torch, x, w_t, scale_bf16, want, refusal=None):
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
    return cuda_event_ms(lambda i: mm(x, w_t[i % n], scale_bf16[i % n]), iters=30)


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
        for M, dtype in [(m, torch.bfloat16) for m in MATMUL_M] + [(1, torch.float32)]:
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


def int8_t_library(torch, g, w, scale, want):
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
    return cuda_event_ms(lambda i: mm(g * scale[i % n].to(g.dtype), w[i % n], ones), iters=30)


def check_transposed(torch):
    """B13 (``int8_matmul_t``) and B14 (``int4g32_matmul_t``), the backward
    matmuls, at the six main-path shapes transposed (g (M, N) → (M, K)), at
    M = 512 and 1024 bf16 (the Hopper kernel, also held to SUM_TOL), M = 16
    bf16 and M = 8 f32 (the CUDA-core kernels).  Library:
    ``_weight_int8pack_mm`` for B13; none for B14 (no PyTorch call takes
    group scales along the output dimension).  Every row carries the dense
    ``g @ w_deq.T`` time on weights dequantized beforehand, a cuBLAS
    yardstick (``dense_ms``)."""
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
        got = fn(g, wts[0][0], wts[1][0])
        torch.cuda.synchronize()
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
            r["plan"] = QM.t_mma_plan(M, K, N)
            r["beyond_sum"] = hold_sum(torch, f"{fn.__name__} {name} M={M}", got, *exact())
        rows.append(r)
        log_row(fn.__name__, r)
        if dense is not None:
            log(f"    dense g @ w_deq.T (cuBLAS, bf16 weights, a yardstick) {dense:.4f} ms"
                + (f"; plan (bm, nsplit, stages/split, blocks) {r['plan']}; beyond the bf16 "
                   f"rounding {r['beyond_sum']:.2e} of sum|terms|" if "plan" in r else ""))

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
            kernel = "int8_t_mma" if QM.uses_mma(M, N, dtype) else "int8_t_gemv"
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
            kernel = "int4g32_t_mma" if QM.uses_mma(M, N, dtype) else "int4g32_t_gemv"
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


def beyond_rounding(torch, got, want32) -> float:
    """max(|got - want32| - half a bf16 ulp of want32) over max|want32|: the
    error of a bf16 output beyond its own rounding of the f32 result."""
    half_ulp = torch.ldexp(torch.ones_like(want32), torch.frexp(want32).exponent - 9)
    half_ulp = torch.where(want32 == 0, 0.0, half_ulp)
    excess = ((got.float() - want32).abs() - half_ulp).clamp_min(0.0).max().item()
    return excess / max(want32.abs().max().item(), 1e-30)


def hold_beyond(torch, name, got, want32, control32, limit, where) -> tuple[float, float]:
    """A kernel that keeps p in f32 through PV, held to its own limit: its
    error beyond the output's rounding of ``want32`` (its function in f32)
    within ``limit``, and the control's (``control32``: the same function
    with p rounded to bf16) beyond it.  Returns (kernel, control)."""
    err = beyond_rounding(torch, got, want32)
    ctrl = beyond_rounding(torch, control32.to(torch.bfloat16), want32)
    require(err <= limit < ctrl, f"{name} {where}: error beyond the bf16 rounding {err} "
                                 f"(limit {limit}), control {ctrl}")
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


def check_attention_edges(torch):
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
    beyond the output's rounding, with their controls above them."""
    from chatglm_q_tpu_torch.ops import attention as A

    gen = torch.Generator(device="cuda").manual_seed(14)
    G, D = 2, 128
    sm = 1.0 / math.sqrt(D)
    worst = {}

    def bf(*shape):
        return torch.randn(shape, device="cuda", generator=gen).to(torch.bfloat16)

    def hold(name, got, want, zero_rows):
        torch.cuda.synchronize()
        _, rel = rel_err(got, want)
        require(torch.isfinite(got.float()).all() and rel <= KERNEL_TOL,
                f"{name} edge case: rel err {rel}")
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
                if v2:
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
                err, ctrl = hold_b11(torch, got, q, kp, vp, 1, table, starts, sm, row_map,
                                     f"edge case P={P} S={S} Hg={Hg} "
                                     f"row_map={row_map is not None}")
                b11 = [max(b11[0], err), min(b11[1], ctrl)]
        del kp, vp
    for name, (err, ctrl) in (("flash_attention_decode_v2", b12),
                              ("flash_attention_decode_paged", b10),
                              ("flash_attention_chunk_paged", b11)):
        worst[f"{name} beyond rounding"] = err
        worst[f"{name} control beyond rounding"] = ctrl
    log(f"  attention edge cases: max rel err {json.dumps(worst)}")
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


# the CUDA-core gemv each quantization's f32 forward takes, and the kernels
# of the same matmul it must not launch
F32_KERNELS = {"int4g32": ("int4g32_gemv", ("int4g32_splitk", "int4g32_mma")),
               "int8": ("int8_gemv", ("int8_splitk", "int8_mma"))}


def f32_forward_parity(torch, quant, seed=24):
    """The parity forward (``models.chatglm2.forward``, the reference's
    semantics; f32 activations by default) at 6B widths, depth 2, in
    ``quant``, 2 x 64 tokens: the kernel path, whose linears take the
    CUDA-core gemv (f32 x; B1's or B6's), against the plain path, max
    |Δlogits| / max|logits| within F32_E2E_TOL, and the plain path on a tree
    with a wrong scale index (the control) outside it.  Returns the readings
    and the kernel run's launch counts."""
    from chatglm_q_tpu_torch import ops
    from chatglm_q_tpu_torch import ChatGLM2Config, TorchRuntimeConfig
    from chatglm_q_tpu_torch.bench import random_quantized_params
    from chatglm_q_tpu_torch.models import chatglm2 as M

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
    gemv, others = F32_KERNELS[quant]
    log(f"  {quant} f32 parity forward, 6B widths, 2 layers, 2 x 64 tokens: max rel logits err "
        f"of the kernel path vs plain {rel:.3e}, vs the wrong-scale control {control:.3e} (limit "
        f"{F32_E2E_TOL:.0e}); launches: {json.dumps({k: counts[k] for k in (gemv,) + others})}")
    require(rel <= F32_E2E_TOL, f"{quant} f32 forward: kernel path vs plain {rel} > {F32_E2E_TOL}")
    require(control > F32_E2E_TOL,
            f"{quant} f32 forward: the wrong-scale control passes ({control})")
    require(counts[gemv] == 6 * cfg.num_layers + 1 and not any(counts[k] for k in others),
            f"{quant} f32 forward: launches {counts}")
    return {"rel_err": rel, "wrong_scale_control": control}, counts


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
    return counts, v2_counts, perf


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


def run_generate(decoder, prompt, **kw):
    """(the streamed texts, the final text, host ms a token between the
    first and the last streamed text)."""
    it = decoder.generate(prompt, max_generated_tokens=CHAT_TOKENS, temperature=0.0, **kw)
    stream, stamps = [], []
    while True:
        try:
            stream.append(next(it))
            stamps.append(time.perf_counter())
        except StopIteration as e:
            require(len(stamps) >= 8, f"generate streamed {len(stamps)} texts")
            return stream, e.value, (stamps[-1] - stamps[0]) * 1e3 / (len(stamps) - 1)


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
        del decoder, eager_decoder
    del params
    torch.cuda.empty_cache()
    perf["round_trip"] = {q: round_trip(torch, q, tokenizer) for q in ("int8", "int4g32")}
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

    g = torch.Generator().manual_seed(seed)
    ids = [engine.submit(torch.randint(3, 65000, (CHUNK_PROMPT,), generator=g).tolist(),
                         temperature=0.0, max_new_tokens=8) for _ in range(4)]
    engine.step()  # admission and the first chunks
    torch.cuda.synchronize()
    ts = time.perf_counter()
    engine.step()
    torch.cuda.synchronize()
    untraced = time.perf_counter() - ts
    require(not any(s.decoding for s in engine.slots), f"{name}: a chunk step decoded")
    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        engine.step()
        torch.cuda.synchronize()
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
           "int4_wgmma_kernel_ms": b1_ms, "int4_wgmma_kernel_launches": sum(e.count for e in b1),
           "top_kernels_ms": {e.key[:60]: e.self_device_time_total / 1e3 for e in top}}
    log(f"    {name}: one chunk step (4 x 256 prompt rows): device {dev_ms:.2f} ms of "
        f"{res['wall_ms']:.2f} ms untraced wall, busy {100 * res['busy_share']:.1f}%, host "
        f"{res['wall_ms'] - dev_ms:.2f} ms; B1 int4_wgmma_kernel {b1_ms:.3f} ms in "
        f"{res['int4_wgmma_kernel_launches']} launches; largest (ms) "
        f"{json.dumps(res['top_kernels_ms'])}")
    return res


def eager_turn(torch, make, reqs, done, name, busy_reqs=None):
    """The same run from eager launches (``cuda_graphs=False``): its greedy
    tokens must equal the captured run's ``done``; tokens/s, time to first
    token and (with ``busy_reqs``) the decode-only step's busy share."""
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
    return res


def captured_programs(params, name, kinds):
    """The step programs of ``kinds`` that replayed from a graph."""
    from chatglm_q_tpu_torch.utils import graphs as G

    progs = [p for p in G.programs(params)._programs.values() if p.name in kinds and p.capture]
    n = sum(p.replays for p in progs)
    require(n > 0 and all(p.graph is not None for p in progs if p.calls > 1),
            f"{name}: no captured {kinds} program replayed")
    return {p.name: p.replays for p in progs}


def greedy_gaps(torch, params, cfg, reqs_done, prompts, cache_len=SEQ):
    """For each greedy request, prefill_chunk over prompt + generated[:-1] on a
    fresh dense cache (one chunk, all logits), and the largest relative gap
    between each position's max logit and the emitted token's logit; and the
    same over the stream shifted by one token (the control).  Read two ways:
    from the bf16 logits prefill_chunk returns, and from the same final
    hidden states through the lm_head in f32 (``int4g32_matmul_plain`` on h
    in f32: the logits before their rounding to bf16, which makes every bf16
    gap a whole number of ulps of the top logit).  Returns {"bf16": (worst,
    control), "f32": (worst, control)}."""
    from chatglm_q_tpu_torch import TorchRuntimeConfig
    from chatglm_q_tpu_torch.models import chatglm2 as M
    from chatglm_q_tpu_torch.ops.quant_matmul import int4g32_matmul_plain

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
            cache = M.init_kv_cache(cfg, 1, cache_len, torch.bfloat16, dev)
            ids = torch.tensor([seq], device=dev)
            zero = torch.zeros((1,), dtype=torch.int32, device=dev)
            logits, _ = M.prefill_chunk(params, cfg, ids, zero, zero + len(seq), cache,
                                        "int4g32", torch.bfloat16, TorchRuntimeConfig(),
                                        return_all_logits=True)
            h = seen.pop("h")[0, len(prompt) - 1:]  # row i predicts generated[i]
            f32 = int4g32_matmul_plain(h.float(), head["weight"], head["weight_scale"])
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

    def make_c(r_t):
        return ServingEngine(load, params, prefill_chunk_size=PAGE, lookahead=True, rt=r_t,
                             **ENGINE_KW)

    # (a) paged, chunked admission through the prefix cache
    eng = make_a(rt)
    a_done, out["a"] = drive(torch, eng, a_reqs, "(a) paged, chunked + prefix cache")
    out["a"]["replays"] = captured_programs(params, "(a)", ("decode_step_paged",))
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
        out["a"]["eager"] = eager_turn(torch, make_a, a_reqs, a_done, "(a)", short)

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

    # (c) the dense engine: chunked admission, lookahead
    eng = make_c(rt)
    c_reqs = [a_reqs[i] for i in (0, 1, 2, 4)]
    c_done, out["c"] = drive(torch, eng, c_reqs, "(c) dense, chunked + lookahead")
    out["c"]["replays"] = captured_programs(params, "(c)", ("decode_step",))
    if not survey:
        out["c"]["busy"] = chunk_busy(torch, eng, short, "(c)")
    del eng
    if not survey:
        out["c"]["eager"] = eager_turn(torch, make_c, c_reqs, c_done, "(c)", short)

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
    counts = {k: ca[k] + cb[k] + cc[k] for k in PAGED_KERNELS + ("int4g32_splitk",)}
    counts["rope_kv_append paged"] = ca["rope_kv_append"] + cb["rope_kv_append"]
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


def hold_lse(torch, name, got, want, where):
    """K1's / K2's (out, m, l) against the plain version's: out within
    KERNEL_TOL of max|plain|, m and l within LSE_TOL relative, −inf and 0
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
    require(torch.isfinite(out.float()).all() and rel <= KERNEL_TOL and dm <= LSE_TOL
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
# the kernels a tensor-parallel decode step runs (28 each, per rank), and the
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
    four sharing a 512-token head.  32 greedy tokens each."""
    g = torch.Generator().manual_seed(seed)
    kw = dict(temperature=0.0, max_new_tokens=SHARD_NEW_TOKENS)
    a = [(torch.randint(3, 65000, (n,), generator=g).tolist(), kw)
         for n in (4200, 2048, 512, 1200, 760)]
    b = [(p, kw) for p, k in engine_prompts(torch, seed)[0] if k["temperature"] == 0.0]
    return a, b


def sharded_rank(rank, tree_path, prompts_a, prompts_b, tp):
    """One rank of phase 8 on a (1, tp) mesh: its slice of the memory-mapped
    tree on its card (gloo: every rank on this one; NCCL: card ``rank``),
    then (a) the T-sharded dense engine and (b) the model-sharded paged
    engine, each draining its requests; returns their tokens, launch counts,
    decode steps, host times and, for each shard, the (layer, decode step,
    b, g) whose partial the merge took with rows in it (l > 0)."""
    import torch

    from chatglm_q_tpu_torch import ChatGLM2Config, GLMLoadConfig, TorchRuntimeConfig, ops
    from chatglm_q_tpu_torch.ops import attention as A
    from chatglm_q_tpu_torch.parallel import sharding as SH
    from chatglm_q_tpu_torch.serving import (DistributedPagedServingEngine,
                                             DistributedServingEngine)

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = ChatGLM2Config()
    mesh = SH.make_mesh(1, tp)
    t0 = time.perf_counter()
    params = SH.shard_params(torch.load(tree_path, mmap=True, weights_only=True), mesh, cfg,
                             "int4g32", device="cuda")
    torch.cuda.synchronize()
    res = {"load_s": time.perf_counter() - t0}
    load = GLMLoadConfig(model_config=cfg, quant_type="int4g32", torch_dtype="bfloat16")
    runs = {
        "a": (lambda: DistributedServingEngine(
            load, params, mesh=mesh, max_batch=4, max_seq_len=SHARD_T, decode_chunk=16,
            rt=TorchRuntimeConfig(kv_shard_t=True)), prompts_a),
        "b": (lambda: DistributedPagedServingEngine(
            load, params, mesh=mesh, shard_model_pages=True, num_pages=POOL_PAGES,
            page_size=PAGE, prefill_chunk_size=PAGE, prefix_cache=True, max_batch=4,
            max_seq_len=SEQ, decode_chunk=16), prompts_b),
    }
    merge = A.merge_lse_partials
    for run, (make, reqs) in runs.items():
        eng = make()
        live = torch.zeros(tp, dtype=torch.long, device="cuda")

        def probe(out, m, l, dtype):  # the decode merges only: count each shard's live (b, g)
            live.add_((l[..., 0] > 0).flatten(1).sum(1))
            return merge(out, m, l, dtype)

        ops.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.sync_submissions([p for p, _ in reqs] if rank == 0 else None, **reqs[0][1])
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
        res[run] = {"tokens": [by_id[i] for i in sorted(by_id)], "counts": ops.launch_counts(),
                    "decode_steps": eng.stats["decode_chunks"] * eng.chunk, "wall_s": wall,
                    "decode_ms_per_step_median": (walls[len(walls) // 2] * 1e3 / eng.chunk
                                                  if walls else None),
                    "live_per_shard": live.tolist(), "stats": dict(eng.stats)}
        if run == "b":
            res[run]["pages_in_use"] = eng.pages_in_use
        res[run]["decode_timing"] = sharded_decode_timing(torch, eng, mesh)
        del eng
        torch.cuda.empty_cache()
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


def sharded_slice(torch, smi, seed=81, backend="gloo", tp=SHARD_TP):
    """Phase 8: the 28-layer int4g32 random tree built once here, saved to
    the build directory and memory-mapped by ``tp`` spawned ranks (gloo: all
    on this card; NCCL, ``--nccl``: one card a rank), each slicing its
    shard; both distributed engines driven on them.  Checks: the ranks agree
    token for token; every request finishes within its budget; K1 / K2 and
    K3 launch 28 times a decode step on each rank and the unsharded decode
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

    cfg = ChatGLM2Config()
    params = random_quantized_params(cfg, "int4g32",
                                     torch.Generator(device="cuda").manual_seed(seed + 2))
    a_reqs, b_reqs = sharded_prompts(torch, seed)
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    path = _build.BUILD_DIR / f"sharded_tree_{seed}.pt"
    t0 = time.perf_counter()
    torch.save(map_tree(params, lambda t: t.cpu()), path)
    save_s = time.perf_counter() - t0
    try:
        t0 = time.perf_counter()
        ranks = run_spmd(sharded_rank, tp, backend, timeout=900,
                         args=(str(path), a_reqs, b_reqs, tp))
        spmd_s = time.perf_counter() - t0
    finally:
        path.unlink(missing_ok=True)
    out = {"card": smi, "backend": backend, "tp": tp, "tree_save_s": save_s, "ranks_s": spmd_s,
           "load_s": [r["load_s"] for r in ranks]}
    counts = {}
    for run, reqs in (("a", a_reqs), ("b", b_reqs)):
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
    counts["rope_kv_append_sharded"] = ranks[0]["a"]["counts"]["rope_kv_append_sharded"]
    counts["rope_kv_append_sharded paged"] = ranks[0]["b"]["counts"]["rope_kv_append_sharded"]
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
    with and without ``remat_layers`` from the same start; then one step on
    a 16-token sample, which takes the CUDA-core backward kernels.  Every
    frozen leaf must come out bit-unchanged and every norm moved."""
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

    # a 16-token sample (labels past the ignored head): M = 16 rows take the
    # CUDA-core backward kernels
    ops.reset_launch_counts()
    short = step(trainable, frozen, ids[:1, FT_IGNORED:FT_IGNORED + 16],
                 labels[:1, FT_IGNORED:FT_IGNORED + 16]).item()
    torch.cuda.synchronize()
    c = ops.launch_counts()
    add(c)
    t_gemv = t_bwd.replace("_mma", "_gemv")
    require(math.isfinite(short) and short > 0 and c[t_gemv] == PER_STEP,
            f"{quant} 16-token step: loss {short}, {c[t_gemv]} {t_gemv} launches")
    log(f"  {quant} 16-token step: loss {short:.6f}; {c[t_gemv]} {t_gemv} launches")
    for k, v in tree_leaves(frozen):
        if v is not None:
            require(torch.equal(v, frozen_before[k]), f"{quant}: frozen leaf {k} changed")
    log(f"  {quant}: all {len(frozen_before)} frozen leaves (packed weights, scales, biases, "
        f"embedding) bit-unchanged")
    return counts_total, out


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
    and backward Hopper matmuls' device ms (PER_STEP launches each)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile

    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step(trainable, frozen, ids, labels)
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
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

    log("== phase 1: card and build")
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
    if "--nccl" in sys.argv:  # phase 8 alone over NCCL, one card a rank
        tp = int(sys.argv[sys.argv.index("--nccl") + 1])
        require(torch.cuda.device_count() >= tp,
                f"--nccl {tp} needs {tp} cards, found {torch.cuda.device_count()}")
        cards = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                "--format=csv,noheader"], capture_output=True, text=True,
                               check=True).stdout.strip().splitlines()
        log(f"== phase 8 over NCCL: tensor-parallel serving on a (1, {tp}) mesh, a card a "
            f"rank; cards: {cards}")
        _, sharded_perf = sharded_slice(torch, smi, backend="nccl", tp=tp)
        log("detail: " + json.dumps({"card": smi, "sharded_28_layers": sharded_perf}))
        log(f"total {time.perf_counter() - t_start:.1f} s")
        return 0
    if "--serving" in sys.argv:  # phases 4, 5, 6 and 9 alone
        log("== phase 4: ChatGLM2-6B int4g32, 28 layers, 4 requests")
        perf = full_slice(torch, smi)[2]
        torch.cuda.empty_cache()
        log("== phase 5: GLMDecoder on ChatGLM2-6B int8, int8+dyn, int4g32+dyn, int4g32, 28 "
            "layers")
        chat_perf = chat_slice(torch, smi)[1]
        torch.cuda.empty_cache()
        log("== phase 6: the serving engines on ChatGLM2-6B int4g32, 28 layers")
        engine_perf = engines_slice(torch, smi)[1]
        torch.cuda.empty_cache()
        log("== phase 9: the OpenAI-style API server over the paged engine, ChatGLM2-6B "
            "int4g32, 28 layers")
        api_perf = api_slice(torch, smi)
        log("detail: " + json.dumps({"card": smi, "int4g32_28_layers": perf,
                                     "chat_28_layers": chat_perf, "engines_28_layers": engine_perf,
                                     "api_server_28_layers": api_perf}))
        log(f"total {time.perf_counter() - t_start:.1f} s")
        return 0
    if "--sharded" in sys.argv:  # phase 2's sharded rows and phase 8 alone
        log("== phase 2 (sharded forms): K1, K2, K3 against their plain versions")
        sharded_rows = check_sharded_attention(torch)
        log("== phase 8: tensor-parallel serving, 2 ranks on this card")
        _, sharded_perf = sharded_slice(torch, smi)
        log("detail: " + json.dumps({"card": smi, "sharded_rows": sharded_rows,
                                     "sharded_28_layers": sharded_perf}))
        log(f"total {time.perf_counter() - t_start:.1f} s")
        return 0
    if "--quant" in sys.argv:  # phase 10 alone, then the 28-layer GPTQ
        log("== phase 10: the quantizers at ChatGLM2-6B widths, 2 layers")
        _, quant_perf, _ = quant_slice(torch, smi)
        log("== GPTQ int4g32 of ChatGLM2-6B, 28 layers")
        quant_perf["gptq_int4g32_28_layers"] = quant_28_layers(torch, smi)
        log("detail: " + json.dumps({"card": smi, "quant_2_layers": quant_perf}))
        log(f"total {time.perf_counter() - t_start:.1f} s")
        return 0

    log("== phase 2: kernels against their plain versions (bf16, main-path shapes)")
    mm_rows, crossover, splitk_crossover = check_matmul(torch)
    int8_rows = check_int8_matmul(torch)
    t_rows = check_transposed(torch)
    att = check_attention(torch)
    att.update(check_paged_attention(torch))
    att["edge_cases_max_rel_err"] = check_attention_edges(torch)
    att.update(check_sharded_attention(torch))

    log("== phase 3: end to end, 6B widths at depth 2, kernel path vs plain path")
    e2e = {mode_name(q, d): end_to_end_parity(torch, q, d) for q, d in PARITY_MODES}
    e2e["int4g32 decode_attn_v2"] = end_to_end_parity(torch, "int4g32", False, v2=True)
    f32_counts = {}
    for quant in F32_KERNELS:
        e2e[f"{quant} f32 forward"], f32_counts[quant] = f32_forward_parity(torch, quant)

    log("== phase 3b: gradients at 6B widths, depth 2, bf16, 2 x 128 tokens, kernel path vs "
        "plain path")
    grads = check_grad_parity(torch)

    log("== phase 4: ChatGLM2-6B int4g32, 28 layers, 4 requests")
    counts, v2_counts, perf = full_slice(torch, smi)
    torch.cuda.empty_cache()

    log("== phase 5: GLMDecoder on ChatGLM2-6B int8, int8+dyn, int4g32+dyn, int4g32, 28 layers")
    chat_counts, chat_perf = chat_slice(torch, smi)
    torch.cuda.empty_cache()

    log("== phase 6: the serving engines on ChatGLM2-6B int4g32, 28 layers")
    engine_counts, engine_perf = engines_slice(torch, smi)
    torch.cuda.empty_cache()

    log("== phase 7: fine-tuning ChatGLM2-6B, 28 layers, int4g32 then int8, through the frozen "
        "quantized weights")
    ft_counts, ft_perf = fine_tune_slice(torch, smi)
    torch.cuda.empty_cache()

    log("== phase 8: tensor-parallel serving of ChatGLM2-6B int4g32, 28 layers, on a (1, 2) "
        "mesh of two gloo ranks sharing this card")
    sharded_counts, sharded_perf = sharded_slice(torch, smi)

    log("== phase 9: the OpenAI-style API server over the paged engine, ChatGLM2-6B int4g32, "
        "28 layers")
    api_perf = api_slice(torch, smi)
    torch.cuda.empty_cache()

    log("== phase 10: the quantizers at ChatGLM2-6B widths, 2 layers")
    quant_counts, quant_perf, sweep_entries = quant_slice(torch, smi)

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
        ("int4g32_gemv", mm4, f"{pm}:244", pick("int4g32_gemv", 1), f32_counts["int4g32"]),
        ("int8_splitk", mm8, f"{pm}:188", pick("int8_splitk", 1), chat_counts["int8"]),
        ("int8_gemv", mm8, f"{pm}:188", pick("int8_gemv", 1), f32_counts["int8"]),
        ("int8_mma", mm8, f"{pm}:188", pick("int8_mma", 512), chat_counts["int8"]),
        ("int8_dyn_splitk", dyn, f"{pm}:960", pick("int8_dyn_splitk", 1),
         chat_counts["int8+dyn"]),
        ("int8_dyn_mma", dyn, f"{pm}:960", pick("int8_dyn_mma", 64), chat_counts["int8+dyn"]),
        ("int4_dyn_splitk", dyn, f"{pm}:1040", pick("int4_dyn_splitk", 1),
         chat_counts["int4g32+dyn"]),
        ("int4_dyn_mma", dyn, f"{pm}:1040", pick("int4_dyn_mma", 64), chat_counts["int4g32+dyn"]),
        ("rope_kv_append", att_src, f"{pa}:427", att["rope_kv_append"], counts),
        ("int4g32_t_gemv", mm4, f"{pm}:671", pick("int4g32_t_gemv", 16), ft_counts["int4g32"]),
        ("int4g32_t_mma", mm4, f"{pm}:671", pick("int4g32_t_mma", 512), ft_counts["int4g32"]),
        ("int8_t_gemv", mm8, f"{pm}:653", pick("int8_t_gemv", 16), ft_counts["int8"]),
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
    entries = []
    for name, src, replaces, r, run_counts in specs:
        require(run_counts[name] > 0, f"{name}: no launch on its main-path run")
        shape = r.get("shape") or f"M={r['M']} K={r['K']} N={r['N']} ({r['linear']})"
        if "dtype" in r:  # a backward matmul: g (M, N) → (M, K)
            shape = f"g (M={r['M']}, N={r['N']}) {r['dtype']} -> K={r['K']} ({r['linear']})"
        elif r.get("x_dtype") == "float32":
            shape += " f32"
        entries.append({"name": name, "route": "cuda", "source": src, "replaces": replaces,
                        "launches": run_counts[name], "max_abs_err": r["max_abs_err"],
                        "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"], "library_ms": r["library_ms"],
                        "shape": shape})
        if name in CUDA_KERNEL:
            entries[-1]["kernel"] = CUDA_KERNEL[name]
        if "old_path_ms" in r:
            entries[-1]["old_path_ms"] = r["old_path_ms"]
    detail = {"card": smi, "matmul_rows": mm_rows + int8_rows, "transposed_rows": t_rows,
              "b8_b1_crossover": crossover, "b1_splitk_mma_crossover": splitk_crossover,
              "attention": att, "e2e_rel_err": e2e,
              "grad_parity": grads, "int4g32_28_layers": perf, "chat_28_layers": chat_perf,
              "engines_28_layers": engine_perf, "api_server_28_layers": api_perf,
              "fine_tune_28_layers": ft_perf,
              "sharded_28_layers": sharded_perf, "quant_2_layers": quant_perf}
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

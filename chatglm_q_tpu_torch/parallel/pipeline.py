"""GPipe pipeline stages over the stacked layer dim: the counterpart of
chatglm_q_tpu/parallel/pipeline.py.

The model keeps its L blocks as one stacked tree (models/chatglm2.py), so a
stage is an even split of the leading L dim over the mesh's ``stage`` axis:
stage s holds layers s·L/S .. (s + 1)·L/S − 1 (``stage_pspecs``,
``shard_layers``).  The mesh (``parallel.sharding.make_mesh(n_rep, 1,
n_stage)``) is laid out as JAX's (stage, rep) test mesh: rank s · n_rep + r;
the replicas of a stage run the same program.

``pipeline_blocks`` runs the ``n_micro + S − 1`` steps of the schedule: at
step t stage i runs micro-batch t − i (where it has one), taking it from
stage i − 1 (``Mesh.recv``; stage 0 from the embedded input) and passing
its output on to i + 1 (``Mesh.send``, through the host on gloo).  The last
stage's stream is broadcast to every stage, as JAX's masked psum gives it
to every device.  Where JAX differentiates through ``ppermute``, the port's
schedule is one ``torch.autograd.Function``: its forward keeps each
micro-batch's graph of the stage's layers, and its backward walks the
schedule in reverse, each stage taking its output's gradient from the next
stage (the last from the head, once), running its layers' backward and
passing its input's gradient back.  Stage 0's input gradient is broadcast
to every stage, so the embedding, which every stage computes, gets its
whole gradient everywhere; the head (final_ln, lm_head, loss) runs alike on
every stage and its gradients are whole as they are; a layer's gradient
lives on its stage.  Training through frozen quantized layers runs each
stage's transposed kernels (B13 / B14) in that backward.

Scope, as JAX's: the full-sequence parity forward and training (no
dropout, no KV cache); serving uses tensor and data parallelism.
"""
from __future__ import annotations

import dataclasses

import torch

from ..config import ChatGLM2Config, TorchRuntimeConfig
from ..models import chatglm2 as M
from ..ops.linear import quant_embedding_lookup, quant_linear
from .sharding import STAGE_AXIS, leaf_paths, take_slice

_DEFAULT_RT = TorchRuntimeConfig()


def _stage_range(n_layers: int, mesh) -> tuple:
    S = mesh.n_stage
    if n_layers % S:
        raise ValueError(f"{n_layers} layers do not split over {S} stages")
    s = mesh.stage_index
    return s * n_layers // S, (s + 1) * n_layers // S


def stage_pspecs(params_layers: dict, mesh) -> dict:
    """This stage's part of every stacked layer leaf: a tree of (0, l0, l1)
    slices of the leading L dim (``parallel.sharding.take_slice``)."""
    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        return (0, *_stage_range(node.shape[0], mesh))

    return walk(params_layers)


def shard_layers(params: dict, mesh, device=None) -> dict:
    """The rank's tree: the ``layers`` subtree cut to its stage's layers
    (contiguous copies, on ``device``, default where the tree lies), the
    other subtrees whole."""
    def walk(node, sl):
        if isinstance(node, dict):
            return {k: walk(v, sl[k] if sl is not None else None) for k, v in node.items()}
        t = take_slice(node, sl).contiguous()
        return t if device is None else t.to(device)

    out = {k: walk(v, None) for k, v in params.items() if k != "layers"}
    out["layers"] = walk(params["layers"], stage_pspecs(params["layers"], mesh))
    return out


def _with(tree: dict, repl: dict, prefix=()) -> dict:
    return {k: _with(v, repl, prefix + (k,)) if isinstance(v, dict) else repl.get(prefix + (k,), v)
            for k, v in tree.items()}


def last_stage_grad(g: torch.Tensor, mesh) -> torch.Tensor:
    """The gradient of the pipeline's output that the last stage takes: its
    own (every stage's is the same, the head running alike everywhere),
    once."""
    return g


@dataclasses.dataclass
class _Schedule:
    layers: dict          # the stage's stacked layers, frozen leaves included
    n_layers: int
    paths: list           # the key paths of the leaves passed to the function
    grad: bool            # keep each micro-batch's graph for the backward
    freqs: tuple          # per micro-batch
    masks: tuple
    config: ChatGLM2Config
    quant_type: str
    rt: TorchRuntimeConfig
    mesh: object
    n_micro: int

    def micros(self, reverse=False):
        """The micro-batches this stage runs, in the order of the schedule's
        steps t (micro-batch t − i at stage i)."""
        i, n_steps = self.mesh.stage_index, self.n_micro + self.mesh.n_stage - 1
        steps = range(n_steps - 1, -1, -1) if reverse else range(n_steps)
        return [t - i for t in steps if 0 <= t - i < self.n_micro]

    def run(self, layers, x, m):
        for l in range(self.n_layers):
            x, _ = M.block_forward(M._layer(layers, l), x, self.freqs[m], self.masks[m],
                                   self.config, self.quant_type, self.rt)
        return x


class _Pipeline(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, sched, *leaves):
        mesh, i, S = sched.mesh, sched.mesh.stage_index, sched.mesh.n_stage
        local = [t.detach().requires_grad_(True) for t in leaves]
        layers = _with(sched.layers, dict(zip(sched.paths, local)))
        h_m = h.chunk(sched.n_micro)
        xs, ys = {}, {}
        with torch.set_grad_enabled(sched.grad):
            for m in sched.micros():
                x = h_m[m] if i == 0 else mesh.recv(h_m[m], i - 1)
                x = x.detach().requires_grad_(sched.grad)
                y = sched.run(layers, x, m)
                if i < S - 1:
                    mesh.send(y.detach(), i + 1)
                xs[m], ys[m] = x, y
        if i == S - 1:
            out = torch.cat([ys[m].detach() for m in range(sched.n_micro)])
        else:
            out = torch.zeros_like(h)
        ctx.sched, ctx.local, ctx.xs, ctx.ys = sched, local, xs, ys
        return mesh.broadcast(out, S - 1, STAGE_AXIS)

    @staticmethod
    def backward(ctx, g):
        sched, local = ctx.sched, ctx.local
        mesh, i, S = sched.mesh, sched.mesh.stage_index, sched.mesh.n_stage
        g_m = last_stage_grad(g.contiguous(), mesh).chunk(sched.n_micro)
        grads = [None] * len(local)
        gh = [None] * sched.n_micro
        for m in sched.micros(reverse=True):
            y = ctx.ys[m]
            gy = g_m[m] if i == S - 1 else mesh.recv(y, i + 1)
            out = torch.autograd.grad(y, [ctx.xs[m]] + local, gy, allow_unused=True)
            for j, t in enumerate(out[1:]):
                if t is not None:
                    grads[j] = t if grads[j] is None else grads[j] + t
            if i > 0:
                mesh.send(out[0], i - 1)
            else:
                gh[m] = out[0]
            del ctx.xs[m], ctx.ys[m]
        gh = torch.cat(gh) if i == 0 else torch.zeros_like(g)
        grads = [torch.zeros_like(t) if d is None else d for t, d in zip(local, grads)]
        return (mesh.broadcast(gh, 0, STAGE_AXIS), None, *grads)


def pipeline_blocks(layers_params: dict, h: torch.Tensor, freqs_cis: torch.Tensor,
                    mask5: torch.Tensor, config: ChatGLM2Config, quant_type: str,
                    rt: TorchRuntimeConfig = _DEFAULT_RT, mesh=None, n_micro: int = 2):
    """The L transformer blocks as an S-stage GPipe pipeline over the mesh's
    ``stage`` axis.  ``layers_params`` is the stage's part of the stacked
    layers (``shard_layers``); h (B, T, H) the embedded input, freqs_cis
    (B, T, D), mask5 (B or 1, 1, 1, T, T) additive f32, each whole on every
    rank.  The batch splits into ``n_micro`` micro-batches (bubble fraction
    (S − 1) / (n_micro + S − 1)).  Returns the blocks' output (B, T, H) on
    every rank, differentiable (see the module note)."""
    if mesh is None or mesh.n_model != 1:
        raise ValueError("pipeline parallelism needs a mesh with a 'stage' axis and no model "
                         "axis (parallel.sharding.make_mesh(n_rep, 1, n_stage))")
    B = h.shape[0]
    if B % n_micro:
        raise ValueError(f"batch {B} does not split into {n_micro} micro-batches")
    masks = mask5.chunk(n_micro) if mask5.shape[0] == B else (mask5,) * n_micro
    grad = torch.is_grad_enabled()
    flat = leaf_paths(layers_params)
    paths = [p for p, t in flat if grad and t.requires_grad]
    leaves = [t for p, t in flat if grad and t.requires_grad]
    grad = grad and (h.requires_grad or bool(leaves))
    sched = _Schedule(layers_params, flat[0][1].shape[0], paths, grad, freqs_cis.chunk(n_micro),
                      masks, config, quant_type, dataclasses.replace(rt, mesh=None), mesh,
                      n_micro)
    return _Pipeline.apply(h, sched, *leaves)


def pp_forward(params: dict, config: ChatGLM2Config, input_ids: torch.Tensor,
               labels: torch.Tensor = None, quant_type: str = "none", dtype=torch.float32,
               rt: TorchRuntimeConfig = _DEFAULT_RT, mesh=None, n_micro: int = 2):
    """The parity forward (models/chatglm2.forward, all-ones mask) with the
    block stack pipelined over the ``stage`` axis; ``params`` the rank's
    ``shard_layers`` tree, ``input_ids`` (B, S) and ``labels`` (−100
    ignored) whole on every rank.  Embedding, final RMSNorm, lm_head and the
    shifted cross-entropy run on every rank alike, outside the pipeline.
    Returns (loss or None, logits (B, S, V))."""
    B, S = input_ids.shape
    dev = input_ids.device
    attention_mask = torch.ones((B, S), dtype=torch.int32, device=dev)
    mask_bias, pos = M.build_parity_mask_and_positions(attention_mask, S)
    freqs_cis = M._serving_freqs(config, pos, dtype)
    h = quant_embedding_lookup(params["word_embedding"], input_ids, quant_type, dtype)
    h = pipeline_blocks(params["layers"], h, freqs_cis, mask_bias[:, None, None], config,
                        quant_type, rt, mesh, n_micro)
    h = M.rms_norm(h, params["final_ln"]["weight"], config.layernorm_epsilon)
    logits = quant_linear(h, params["lm_head"], quant_type,
                          dataclasses.replace(rt, mesh=None))[..., : config.vocab_size]
    loss = None if labels is None else M.cross_entropy_loss(logits, labels.to(dev))
    return loss, logits

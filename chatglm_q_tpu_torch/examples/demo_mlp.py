"""GPTQ on a toy two-layer MLP over synthetic data: the port's
examples/quantize_gptq/demo_mlp.py.

    python -m chatglm_q_tpu_torch.examples.demo_mlp [--device cpu]

The whole GPTQ flow in isolation: calibrate (correlated features, where
GPTQ matters) → accumulate each linear's Hessian → quantize both layers
int4g32 with GPTQ, and with RTN for comparison → swap the quantized
weights in → verify the output error against the float MLP, then export
the quantized MLP with ``torch.export`` (the int4g32 linears trace as the
custom op ``chatglm_q_tpu_torch::int4g32_matmul`` on the card), save,
reload and run it: its output must equal the eager one.
"""
from __future__ import annotations

import argparse

import torch

D_IN, D_H, D_OUT = 256, 512, 10


class MLP(torch.nn.Module):
    """relu(x @ W1) @ W2 through ``quant_linear`` of ``quant_type``, its
    first D_OUT columns."""

    def __init__(self, quant_type: str):
        super().__init__()
        self.quant_type = quant_type

    def forward(self, x, p1, p2):
        from ..ops.linear import quant_linear

        h = torch.relu(quant_linear(x, p1, self.quant_type))
        return quant_linear(h, p2, self.quant_type)[..., :D_OUT]


def run(device, out_path: str = "demo_mlp.pt2") -> dict:
    from ..ops import export_ops  # noqa: F401  (registers the custom ops)
    from ..ops import quant as Q
    from ..quant import gptq as GQ

    gen = torch.Generator().manual_seed(0)
    w1 = (torch.randn((D_IN, D_H), generator=gen) * 0.05).to(device)
    w2 = (torch.randn((D_H, D_OUT), generator=gen) * 0.05).to(device)
    base = torch.randn((512, D_IN // 4), generator=gen)
    mix = torch.randn((D_IN // 4, D_IN), generator=gen)
    X = (base @ mix + 0.1 * torch.randn((512, D_IN), generator=gen)).to(device)

    # Hessians of each linear's input
    h1, n1 = GQ.init_hessian(D_IN, device)
    h1, n1 = GQ.accumulate_hessian(h1, n1, X)
    h2, n2 = GQ.init_hessian(D_H, device)
    h2, n2 = GQ.accumulate_hessian(h2, n2, torch.relu(X @ w1))

    # the output layer's 10 columns padded to 16 (zero weights, unit
    # scales), as the model pads its linears' N: the card's kernels take N
    # in multiples of 8 or 16
    gptq = (GQ.gptq_linear_params_int4(w1, h1),
            Q.pad_linear_n(GQ.gptq_linear_params_int4(w2, h2), multiple=16))
    rtn = (Q.quantize_linear_int4(w1), Q.pad_linear_n(Q.quantize_linear_int4(w2), multiple=16))
    xb = X.to(torch.bfloat16)
    ref = MLP("none")(X, {"weight": w1}, {"weight": w2}).float()
    out_gptq = MLP("int4g32")(xb, *gptq).float()
    out_rtn = MLP("int4g32")(xb, *rtn).float()
    err_g = float(torch.mean((out_gptq - ref) ** 2))
    err_r = float(torch.mean((out_rtn - ref) ** 2))

    model = MLP("int4g32")
    ep = torch.export.export(model, (xb[:8], *gptq), strict=False)
    ep.example_inputs = None  # the weights are inputs, not part of the artifact
    torch.export.save(ep, out_path)
    again = torch.export.load(out_path).module()(xb[:8], *gptq)
    eager = model(xb[:8], *gptq)
    return {"mse_gptq": err_g, "mse_rtn": err_r, "export_equal": bool(torch.equal(again, eager)),
            "ops": sorted({str(n.target) for n in ep.graph.nodes
                           if export_ops.NAMESPACE in str(n.target)})}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--out", default="demo_mlp.pt2")
    args = ap.parse_args(argv)
    from ..config import resolve_device

    res = run(resolve_device(args.device), args.out)
    print(f"output MSE — gptq: {res['mse_gptq']:.6f}  rtn: {res['mse_rtn']:.6f}  "
          f"(gptq {'BETTER' if res['mse_gptq'] < res['mse_rtn'] else 'worse'})")
    print(f"torch.export round trip {'OK' if res['export_equal'] else 'DIFFERS'} "
          f"(custom ops: {res['ops'] or 'none'})")
    return 0 if res["export_equal"] else 1


if __name__ == "__main__":
    raise SystemExit(main())

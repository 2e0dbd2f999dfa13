"""Scripts of the port, run as ``python -m chatglm_q_tpu_torch.examples.<name>``:
quantize a float checkpoint (``quantize_naive``, ``quantize_gptq``) and
evaluate one (``ppl``, ``ceval``), with calibration and evaluation text
from ``data.py`` (local files or a synthetic corpus; nothing is fetched);
serve and chat (``api_server``, ``cli_chat``, ``web_ui``), tour the engines
(``engine_demo``), convert the HF checkpoint (``convert_weight``), export
the decode step (``export``) and walk GPTQ through a toy MLP
(``demo_mlp``): the counterparts of the root examples/ scripts."""

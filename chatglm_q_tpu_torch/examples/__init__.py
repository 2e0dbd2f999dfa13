"""Scripts of the port, run as ``python -m chatglm_q_tpu_torch.examples.<name>``:
quantize a float checkpoint (``quantize_naive``, ``quantize_gptq``) and
evaluate one (``ppl``, ``ceval``), with calibration and evaluation text
from ``data.py`` (local files or a synthetic corpus; nothing is fetched)."""

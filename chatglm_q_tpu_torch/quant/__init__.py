"""The quantizers: naive RTN, GPTQ and its layer-pipelined calibration
driver (the counterpart of chatglm_q_tpu/quant/)."""
from .rtn import rtn_quantize_model
from .gptq import (
    init_hessian, accumulate_hessian,
    gptq_quantize_int8, gptq_quantize_int4,
    gptq_linear_params_int8, gptq_linear_params_int4,
)
from .calibrate import gptq_quantize_model

from .gpt import GPT_CONFIGS, GPTConfig, compute_dtype, ln_fp32
from .params import (cast_for_compute, init_gpt_params, param_shapes,
                     params_from_numpy)
from .generation import generate_from_params
from .gpt_hybrid import (HybridTrainStep, gpt_forward, gpt_hidden,
                         gpt_loss)

__all__ = ["GPT_CONFIGS", "GPTConfig", "compute_dtype", "ln_fp32",
           "cast_for_compute", "init_gpt_params", "param_shapes",
           "params_from_numpy", "generate_from_params", "HybridTrainStep",
           "gpt_forward", "gpt_hidden", "gpt_loss"]

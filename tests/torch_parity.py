"""Shared set-up of the port's parity tests (tests/test_torch_*.py): one
small GPT configuration for both frameworks and one set of weights, drawn
by the reference's ``init_gpt_params`` and handed to the port as numpy
arrays. fp32 compute, so differences are summation order only."""
import functools

import jax
import jax.numpy as jnp
import numpy as np

from paddle_tpu.models.gpt import GPTConfig as JaxGPTConfig
from paddle_tpu.models.gpt_hybrid import init_gpt_params as jax_init_params
from paddle_tpu_torch.models import GPTConfig, params_from_numpy

CFG_KW = dict(vocab_size=512, hidden_size=256, num_layers=2, num_heads=2,
              max_seq_len=128, dropout=0.0, use_flash=False,
              compute_dtype="float32", remat=False)
JCFG = JaxGPTConfig(**CFG_KW)
TCFG = GPTConfig(**CFG_KW)


@functools.lru_cache(maxsize=None)
def numpy_params():
    tree = jax_init_params(JCFG, jax.random.key(0))
    return jax.tree_util.tree_map(np.asarray, tree)


def jax_params():
    return jax.tree_util.tree_map(jnp.asarray, numpy_params())


def torch_params():
    return params_from_numpy(numpy_params(), TCFG, device="cpu")


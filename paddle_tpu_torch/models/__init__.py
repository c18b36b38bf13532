from .bert import (BERT_CONFIGS, BertConfig, BertForPretraining,
                   BertForSequenceClassification, BertModel)
from .gpt import (GPT_CONFIGS, GPTConfig, GPTForCausalLM, compute_dtype,
                  gpt_loss_fn, ln_fp32)
from .params import (cast_for_compute, init_gpt_params,
                     layer_params_from_numpy, layer_params_from_tree,
                     param_shapes, params_from_numpy, tree_from_layer_params)
from .generation import generate_from_params
from .gpt_hybrid import (HybridTrainStep, gpt_forward, gpt_hidden,
                         gpt_loss)
from .transformer import (TRANSFORMER_CONFIGS, TransformerConfig,
                          TransformerForTranslation, translation_batch)

__all__ = ["BERT_CONFIGS", "BertConfig", "BertForPretraining",
           "BertForSequenceClassification", "BertModel", "GPT_CONFIGS", "GPTConfig", "GPTForCausalLM", "compute_dtype",
           "gpt_loss_fn", "ln_fp32", "cast_for_compute", "init_gpt_params",
           "layer_params_from_numpy", "layer_params_from_tree",
           "param_shapes", "params_from_numpy", "tree_from_layer_params",
           "generate_from_params", "HybridTrainStep", "gpt_forward",
           "gpt_hidden", "gpt_loss", "TRANSFORMER_CONFIGS",
           "TransformerConfig", "TransformerForTranslation",
           "translation_batch"]

"""Activation recomputation for the single-device training step
(counterpart of ``paddle_tpu/distributed``; the multi-GPU layers are
ROADMAP Queue A item 11)."""

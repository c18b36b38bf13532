"""Attention and loss operators (counterpart of ``paddle_tpu/ops``)."""

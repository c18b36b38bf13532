"""Model-FLOP estimators (counterpart of ``paddle_tpu/observability``)."""

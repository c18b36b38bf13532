"""Calibration observers (counterpart of ``paddle_tpu/quantization``):
only the observers serving calibration reads."""
from .observers import (AbsmaxObserver, BaseObserver,
                        PerChannelAbsmaxObserver, PercentileObserver)

__all__ = ["AbsmaxObserver", "BaseObserver", "PerChannelAbsmaxObserver",
           "PercentileObserver"]

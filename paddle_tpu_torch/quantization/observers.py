"""Observers that record range statistics for calibration (counterpart of
``paddle_tpu/quantization/observers.py:63-174``).

The reference's observers are eager ``Layer``s over jax arrays; these are
plain classes over numpy arrays and torch tensors, with the same
statistics and the ``observe()`` / ``cal_thresholds()`` / ``scales()`` /
``bit_length()`` surface that ``serving.quant.calibrate`` reads. Statistics live on the host as Python floats and numpy
arrays.
"""
from __future__ import annotations

import numpy as np
import torch


def _numpy_f32(x):
    """x (torch tensor, numpy array or array-like) as a float32 ndarray."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)


class BaseObserver:
    """Symmetric observer: ``observe`` records, ``cal_thresholds``
    finalizes, ``scales()`` is clip / (2^(bits-1) - 1)."""

    def __init__(self, quant_bits=8):
        self._quant_bits = quant_bits

    def bit_length(self):
        return self._quant_bits

    def observe(self, x):  # pragma: no cover - abstract
        raise NotImplementedError

    def cal_thresholds(self):
        pass

    def scales(self):  # pragma: no cover - abstract
        raise NotImplementedError


class AbsmaxObserver(BaseObserver):
    """Running max of |x| over every observed batch (per tensor)."""

    def __init__(self, quant_bits=8):
        super().__init__(quant_bits)
        self._max = 1e-9

    def observe(self, x):
        self._max = max(self._max, float(np.abs(_numpy_f32(x)).max()))

    def scales(self):
        return self._max / (2.0 ** (self._quant_bits - 1) - 1)


class PercentileObserver(BaseObserver):
    """Clip range = the given percentile of |x| over everything observed.
    Trades a bounded clip of the outlier tail for a finer grid; samples
    are stride-downsampled on the host to ``max_samples`` in all."""

    def __init__(self, percentile=99.9, quant_bits=8, max_samples=1 << 20):
        super().__init__(quant_bits)
        if not 0 < percentile <= 100:
            raise ValueError(f"percentile must be in (0, 100], got "
                             f"{percentile}")
        self._percentile = float(percentile)
        self._max_samples = int(max_samples)
        self._samples = []
        self._threshold = None

    def observe(self, x):
        a = np.abs(_numpy_f32(x)).ravel()
        if a.size > self._max_samples:
            a = a[:: a.size // self._max_samples + 1]
        self._samples.append(a)
        total = sum(s.size for s in self._samples)
        if total > self._max_samples:
            allv = np.concatenate(self._samples)
            self._samples = [allv[:: allv.size // self._max_samples + 1]]
        self._threshold = None

    def cal_thresholds(self):
        if not self._samples:
            self._threshold = 1e-9
            return
        allv = np.concatenate(self._samples)
        self._threshold = max(float(np.percentile(allv, self._percentile)),
                              1e-9)

    def scales(self):
        if self._threshold is None:
            self.cal_thresholds()
        return self._threshold / (2.0 ** (self._quant_bits - 1) - 1)


class PerChannelAbsmaxObserver(BaseObserver):
    """Per-channel max of |x| along ``quant_axis`` (weights)."""

    def __init__(self, quant_axis=0, quant_bits=8):
        super().__init__(quant_bits)
        self._axis = quant_axis
        self._max = None

    def observe(self, x):
        arr = np.abs(_numpy_f32(x))
        reduce_axes = tuple(i for i in range(arr.ndim) if i != self._axis)
        cur = arr.max(axis=reduce_axes)
        self._max = cur if self._max is None else np.maximum(self._max, cur)

    def scales(self):
        m = np.maximum(self._max, 1e-9)
        return m / (2.0 ** (self._quant_bits - 1) - 1)

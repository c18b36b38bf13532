"""The encoder-decoder Transformer for translation around Paddle's
``nn.Transformer`` (``nn/transformer.py``): "base" of Vaswani et al.
2017, Table 3, at the reference layer's defaults (d_model 512, 8 heads
of 64, 6 + 6 post-LN layers, FFN 2048, relu, dropout 0.1), a source and
target embedding shared between the two sides and scaled by
sqrt(d_model), sinusoidal positions (ibid. 3.5), and a vocabulary
projection whose softmax cross-entropy runs fused over vocab chunks
(``ops/fused_ce.py``): the [tokens, vocab] logits never exist.

Attention goes through the flash kernels: the encoder's and the
cross-attention's key-padding bias [B, 1, 1, S_src] (``PAD_BIAS`` at
padded source tokens), the decoder's ``generate_square_subsequent_mask``
(-inf above the diagonal) as an additive bias, attention dropout in the
kernels. Cross-attention puts the target's queries against the source's
keys: q and key lengths apart.

Parameter names are the reference layers', so a model built from the
reference's ``nn.Embedding``, ``nn.Transformer`` and ``nn.Linear`` under
the names below loads by name (``models.params.
layer_params_from_numpy``).
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from .. import nn as pnn
from ..ops.fused_ce import fused_linear_cross_entropy

PAD_BIAS = -1e9


@dataclass
class TransformerConfig:
    vocab_size: int = 37000
    d_model: int = 512
    nhead: int = 8
    num_encoder_layers: int = 6
    num_decoder_layers: int = 6
    dim_feedforward: int = 2048
    dropout: float = 0.1
    max_length: int = 1024
    pad_id: int = 0


# "base": Vaswani et al. 2017, Table 3 (37,000 shared BPE tokens of WMT
# 2014 English-German), nn.Transformer's defaults
TRANSFORMER_CONFIGS = {"transformer-base": TransformerConfig()}


def position_encoding(length, d_model):
    """fp32 numpy [length, d_model]: sin(pos / 10000^(2i / d)) at column
    2i, cos at 2i + 1."""
    pos = np.arange(length, dtype=np.float64)[:, None]
    inv = np.power(10000.0, -np.arange(0, d_model, 2) / d_model)
    pe = np.zeros((length, d_model))
    pe[:, 0::2] = np.sin(pos * inv)
    pe[:, 1::2] = np.cos(pos * inv)
    return pe.astype(np.float32)


def padding_bias(ids, pad_id):
    """fp32 [B, 1, 1, S]: PAD_BIAS at padded tokens, 0 elsewhere."""
    return torch.where(ids == pad_id, PAD_BIAS, 0.0)[:, None, None, :]


class TransformerForTranslation(nn.Module):
    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        self.config = cfg
        d = cfg.d_model
        self.word_embedding = pnn.Embedding(
            cfg.vocab_size, d, weight_attr=pnn.ParamAttr(
                initializer=pnn.initializer.Normal(0.0, d ** -0.5)))
        self.transformer = pnn.Transformer(
            d, cfg.nhead, cfg.num_encoder_layers, cfg.num_decoder_layers,
            cfg.dim_feedforward, cfg.dropout)
        self.project = pnn.Linear(d, cfg.vocab_size)
        self.dropout = pnn.Dropout(cfg.dropout)
        self.register_buffer("positions", torch.from_numpy(
            position_encoding(cfg.max_length, d)), persistent=False)

    def embed(self, ids):
        """sqrt(d_model) * embedding + position, then dropout."""
        x = self.word_embedding(ids) * math.sqrt(self.config.d_model)
        return self.dropout(x + self.positions[:ids.shape[1]].to(x.dtype))

    def hidden(self, src_ids, tgt_ids):
        """The decoder's output [B, T, d_model]."""
        bias = padding_bias(src_ids, self.config.pad_id)
        causal = pnn.Transformer.generate_square_subsequent_mask(
            tgt_ids.shape[1]).to(tgt_ids.device)
        return self.transformer(self.embed(src_ids), self.embed(tgt_ids),
                                src_mask=bias, tgt_mask=causal,
                                memory_mask=bias)

    def forward(self, src_ids, tgt_ids):
        """Logits [B, T, vocab]."""
        return self.project(self.hidden(src_ids, tgt_ids))

    def loss(self, src_ids, tgt_ids, labels, ignore_index=-100):
        """Mean cross-entropy of the labels [B, T] that are not
        ``ignore_index``, the projection fused into it."""
        h = self.hidden(src_ids, tgt_ids)
        labels = labels.reshape(-1)
        losses = fused_linear_cross_entropy(
            h.reshape(-1, h.shape[-1]), self.project.weight.to(h.dtype),
            labels, head_b=self.project.bias.to(h.dtype))
        keep = labels != ignore_index
        return torch.where(keep, losses, 0.0).sum() / keep.sum().clamp(min=1)


def translation_batch(cfg, B, S_src, S_tgt, seed, src_lengths=(64, 256),
                      tgt_lengths=(32, 128)):
    """One padded batch as numpy, from the seed: source ids [B, S_src] and
    target ids [B, S_tgt] of lengths drawn per row from the given
    (inclusive) ranges, ``pad_id`` after them; the labels [B, S_tgt] are
    the target shifted one left (the next token), -100 from the last real
    token on. Token ids avoid ``pad_id``."""
    rng = np.random.default_rng(seed)
    V, pad = cfg.vocab_size, cfg.pad_id

    def side(S, lo, hi):
        n = rng.integers(lo, hi + 1, B)
        ids = rng.integers(1, V, (B, S))
        ids = np.where(ids == pad, 1, ids)
        real = np.arange(S)[None, :] < n[:, None]
        return np.where(real, ids, pad).astype(np.int64), n

    src, _ = side(S_src, *src_lengths)
    tgt, n = side(S_tgt, *tgt_lengths)
    labels = np.full_like(tgt, -100)
    labels[:, :-1] = tgt[:, 1:]
    labels[np.arange(S_tgt)[None, :] >= (n - 1)[:, None]] = -100
    return src, tgt, labels

"""Transformer encoder layers (counterpart of
``paddle_tpu/nn/layer/transformer.py:19-140`` and ``_clone_layer``), with
the reference's parameter names and its post-LN order, on [batch, seq,
d_model] tensors.

``MultiHeadAttention`` routes through
``functional.scaled_dot_product_attention``: the flash kernels with the
mask as an additive bias and in-kernel dropout. The reference's
incremental-decode ``cache`` and ``need_weights`` are not ported and
raise; the decoder layers wait for a model that uses them.
"""
from __future__ import annotations

import copy

from torch import nn

from . import functional as F
from .initializer import XavierUniform
from .layer import Dropout, LayerNorm, Linear


class MultiHeadAttention(nn.Module):
    def __init__(self, embed_dim, num_heads, dropout=0.0, kdim=None,
                 vdim=None, need_weights=False, weight_attr=None,
                 bias_attr=None):
        super().__init__()
        if need_weights:
            raise NotImplementedError("MultiHeadAttention(need_weights=True) "
                                      "is not ported")
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.dropout = dropout
        self.head_dim = embed_dim // num_heads
        if self.head_dim * num_heads != embed_dim:
            raise ValueError(f"embed_dim {embed_dim} is not a multiple of "
                             f"num_heads {num_heads}")
        self.q_proj = Linear(embed_dim, embed_dim, weight_attr, bias_attr)
        self.k_proj = Linear(kdim or embed_dim, embed_dim, weight_attr,
                             bias_attr)
        self.v_proj = Linear(vdim or embed_dim, embed_dim, weight_attr,
                             bias_attr)
        self.out_proj = Linear(embed_dim, embed_dim, weight_attr, bias_attr)

    def forward(self, query, key=None, value=None, attn_mask=None,
                cache=None):
        if cache is not None:
            raise NotImplementedError("MultiHeadAttention's cache is not "
                                      "ported")
        key = query if key is None else key
        value = query if value is None else value
        B, Sq, Sk = query.shape[0], query.shape[1], key.shape[1]
        H, D = self.num_heads, self.head_dim
        q = self.q_proj(query).view(B, Sq, H, D)
        k = self.k_proj(key).view(B, Sk, H, D)
        v = self.v_proj(value).view(B, Sk, H, D)
        mask = attn_mask
        if mask is not None and mask.dim() == 3:
            mask = mask.unsqueeze(1)     # [B, 1, Sq, Sk] over the heads
        out = F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, dropout_p=self.dropout,
            training=self.training)
        return self.out_proj(out.reshape(B, Sq, H * D))


class TransformerEncoderLayer(nn.Module):
    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None):
        super().__init__()
        attn_dropout = dropout if attn_dropout is None else attn_dropout
        act_dropout = dropout if act_dropout is None else act_dropout
        self.normalize_before = normalize_before
        self.self_attn = MultiHeadAttention(d_model, nhead, attn_dropout,
                                            weight_attr=weight_attr,
                                            bias_attr=bias_attr)
        self.linear1 = Linear(d_model, dim_feedforward, weight_attr,
                              bias_attr)
        self.dropout = Dropout(act_dropout)
        self.linear2 = Linear(dim_feedforward, d_model, weight_attr,
                              bias_attr)
        self.norm1 = LayerNorm(d_model)
        self.norm2 = LayerNorm(d_model)
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(dropout)
        self.activation = getattr(F, activation)

    def forward(self, src, src_mask=None, cache=None):
        if cache is not None:
            raise NotImplementedError("TransformerEncoderLayer's cache is "
                                      "not ported")
        residual = src
        if self.normalize_before:
            src = self.norm1(src)
        src = residual + self.dropout1(self.self_attn(src, src, src,
                                                      src_mask))
        if not self.normalize_before:
            src = self.norm1(src)
        residual = src
        if self.normalize_before:
            src = self.norm2(src)
        src = self.linear2(self.dropout(self.activation(self.linear1(src))))
        src = residual + self.dropout2(src)
        if not self.normalize_before:
            src = self.norm2(src)
        return src


class TransformerEncoder(nn.Module):
    def __init__(self, encoder_layer, num_layers, norm=None):
        super().__init__()
        self.layers = nn.ModuleList([encoder_layer] + [
            _clone_layer(encoder_layer) for _ in range(num_layers - 1)])
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, src, src_mask=None, cache=None):
        if cache is not None:
            raise NotImplementedError("TransformerEncoder's cache is not "
                                      "ported")
        output = src
        for layer in self.layers:
            output = layer(output, src_mask)
        if self.norm is not None:
            output = self.norm(output)
        return output


def _clone_layer(layer):
    """A copy of ``layer`` whose matrices are drawn anew (Xavier-uniform,
    as the reference's ``_clone_layer``); vectors are copied."""
    new = copy.deepcopy(layer)
    for p in new.parameters():
        if p.dim() >= 2:
            XavierUniform()(p.data)
    return new

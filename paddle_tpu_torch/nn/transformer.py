"""Transformer layers (counterpart of
``paddle_tpu/nn/layer/transformer.py``): multi-head attention with
``kdim``/``vdim`` and the incremental ``cache``, the encoder and decoder
layers and stacks, and the encoder-decoder ``Transformer`` with
``generate_square_subsequent_mask``, with the reference's parameter
names, its post-LN (or pre-LN) order and its ``_clone_layer``, on
[batch, seq, d_model] tensors.

``MultiHeadAttention`` routes through
``functional.scaled_dot_product_attention``: the flash kernels with the
mask as an additive bias and in-kernel dropout, queries against keys of
another length where the decoder attends to the encoder's memory. The
reference's ``need_weights`` is not ported and raises.
"""
from __future__ import annotations

import copy

import torch
from torch import nn

from . import functional as F
from .initializer import XavierUniform
from .layer import Dropout, LayerNorm, Linear


class MultiHeadAttention(nn.Module):
    Cache = tuple
    StaticCache = tuple

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
        """The attention output; with ``cache`` (k, v [B, S0, H, D] of the
        earlier steps) also the cache grown by this call's keys and
        values, as (output, (k, v))."""
        key = query if key is None else key
        value = query if value is None else value
        B, Sq, Sk = query.shape[0], query.shape[1], key.shape[1]
        H, D = self.num_heads, self.head_dim
        q = self.q_proj(query).view(B, Sq, H, D)
        k = self.k_proj(key).view(B, Sk, H, D)
        v = self.v_proj(value).view(B, Sk, H, D)
        if cache is not None:
            pk, pv = cache
            k = torch.cat([pk, k], 1)
            v = torch.cat([pv, v], 1)
        mask = attn_mask
        if mask is not None and mask.dim() == 3:
            mask = mask.unsqueeze(1)     # [B, 1, Sq, Sk] over the heads
        out = F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, dropout_p=self.dropout,
            training=self.training)
        out = self.out_proj(out.reshape(B, Sq, H * D))
        return out if cache is None else (out, (k, v))

    def gen_cache(self, key, value=None, type=None):
        """An empty incremental cache: fp32 k and v [B, 0, H, D]."""
        z = torch.zeros(key.shape[0], 0, self.num_heads, self.head_dim,
                        device=key.device)
        return (z, z)


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
        residual = src
        if self.normalize_before:
            src = self.norm1(src)
        if cache is None:
            src = self.self_attn(src, src, src, src_mask)
        else:
            src, cache = self.self_attn(src, src, src, src_mask, cache)
        src = residual + self.dropout1(src)
        if not self.normalize_before:
            src = self.norm1(src)
        residual = src
        if self.normalize_before:
            src = self.norm2(src)
        src = self.linear2(self.dropout(self.activation(self.linear1(src))))
        src = residual + self.dropout2(src)
        if not self.normalize_before:
            src = self.norm2(src)
        return src if cache is None else (src, cache)

    def gen_cache(self, src):
        return self.self_attn.gen_cache(src)


class TransformerEncoder(nn.Module):
    def __init__(self, encoder_layer, num_layers, norm=None):
        super().__init__()
        self.layers = nn.ModuleList([encoder_layer] + [
            _clone_layer(encoder_layer) for _ in range(num_layers - 1)])
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, src, src_mask=None, cache=None):
        output = src
        new_caches = []
        for i, layer in enumerate(self.layers):
            if cache is None:
                output = layer(output, src_mask)
            else:
                output, new_cache = layer(output, src_mask, cache[i])
                new_caches.append(new_cache)
        if self.norm is not None:
            output = self.norm(output)
        return output if cache is None else (output, new_caches)

    def gen_cache(self, src):
        return [layer.gen_cache(src) for layer in self.layers]


class TransformerDecoderLayer(nn.Module):
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
        self.cross_attn = MultiHeadAttention(d_model, nhead, attn_dropout,
                                             weight_attr=weight_attr,
                                             bias_attr=bias_attr)
        self.linear1 = Linear(d_model, dim_feedforward, weight_attr,
                              bias_attr)
        self.dropout = Dropout(act_dropout)
        self.linear2 = Linear(dim_feedforward, d_model, weight_attr,
                              bias_attr)
        self.norm1 = LayerNorm(d_model)
        self.norm2 = LayerNorm(d_model)
        self.norm3 = LayerNorm(d_model)
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(dropout)
        self.dropout3 = Dropout(dropout)
        self.activation = getattr(F, activation)

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None,
                cache=None):
        residual = tgt
        if self.normalize_before:
            tgt = self.norm1(tgt)
        if cache is None:
            tgt = self.self_attn(tgt, tgt, tgt, tgt_mask)
        else:
            tgt, incr = self.self_attn(tgt, tgt, tgt, tgt_mask, cache[0])
        tgt = residual + self.dropout1(tgt)
        if not self.normalize_before:
            tgt = self.norm1(tgt)
        residual = tgt
        if self.normalize_before:
            tgt = self.norm2(tgt)
        tgt = self.cross_attn(tgt, memory, memory, memory_mask)
        tgt = residual + self.dropout2(tgt)
        if not self.normalize_before:
            tgt = self.norm2(tgt)
        residual = tgt
        if self.normalize_before:
            tgt = self.norm3(tgt)
        tgt = self.linear2(self.dropout(self.activation(self.linear1(tgt))))
        tgt = residual + self.dropout3(tgt)
        if not self.normalize_before:
            tgt = self.norm3(tgt)
        return tgt if cache is None else (tgt, (incr,))

    def gen_cache(self, memory):
        return (self.self_attn.gen_cache(memory),)


class TransformerDecoder(nn.Module):
    def __init__(self, decoder_layer, num_layers, norm=None):
        super().__init__()
        self.layers = nn.ModuleList([decoder_layer] + [
            _clone_layer(decoder_layer) for _ in range(num_layers - 1)])
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None,
                cache=None):
        output = tgt
        new_caches = []
        for i, layer in enumerate(self.layers):
            if cache is None:
                output = layer(output, memory, tgt_mask, memory_mask)
            else:
                output, new_cache = layer(output, memory, tgt_mask,
                                          memory_mask, cache[i])
                new_caches.append(new_cache)
        if self.norm is not None:
            output = self.norm(output)
        return output if cache is None else (output, new_caches)

    def gen_cache(self, memory, do_zip=False):
        return [layer.gen_cache(memory) for layer in self.layers]


class Transformer(nn.Module):
    """The encoder-decoder of Vaswani et al. 2017 with Paddle's defaults
    (reference transformer.py:224-257): d_model 512, 8 heads, 6 + 6
    layers, FFN 2048, dropout 0.1, relu, post-LN."""

    def __init__(self, d_model=512, nhead=8, num_encoder_layers=6,
                 num_decoder_layers=6, dim_feedforward=2048, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 custom_encoder=None, custom_decoder=None):
        super().__init__()
        self.d_model = d_model
        self.nhead = nhead
        if custom_encoder is not None:
            self.encoder = custom_encoder
        else:
            enc_layer = TransformerEncoderLayer(
                d_model, nhead, dim_feedforward, dropout, activation,
                attn_dropout, act_dropout, normalize_before, weight_attr,
                bias_attr)
            norm = LayerNorm(d_model) if normalize_before else None
            self.encoder = TransformerEncoder(enc_layer, num_encoder_layers,
                                              norm)
        if custom_decoder is not None:
            self.decoder = custom_decoder
        else:
            dec_layer = TransformerDecoderLayer(
                d_model, nhead, dim_feedforward, dropout, activation,
                attn_dropout, act_dropout, normalize_before, weight_attr,
                bias_attr)
            norm = LayerNorm(d_model) if normalize_before else None
            self.decoder = TransformerDecoder(dec_layer, num_decoder_layers,
                                              norm)

    def forward(self, src, tgt, src_mask=None, tgt_mask=None,
                memory_mask=None):
        memory = self.encoder(src, src_mask)
        return self.decoder(tgt, memory, tgt_mask, memory_mask)

    @staticmethod
    def generate_square_subsequent_mask(length):
        """fp32 [length, length]: 0 on and below the diagonal, -inf
        above it."""
        keep = torch.ones(length, length, dtype=torch.bool).tril()
        return torch.where(keep, 0.0, float("-inf"))


def _clone_layer(layer):
    """A copy of ``layer`` whose matrices are drawn anew (Xavier-uniform,
    as the reference's ``_clone_layer``); vectors are copied."""
    new = copy.deepcopy(layer)
    for p in new.parameters():
        if p.dim() >= 2:
            XavierUniform()(p.data)
    return new

"""BERT for MLM / NSP pretraining (counterpart of
``paddle_tpu/models/bert.py``): the shared transformer encoder
(``nn/transformer.py``, post-LN), attention through the flash kernels
with the padding mask as an additive [B, 1, 1, S] bias of -1e4 and the
config's attention dropout in the kernels, and the MLM head fused into
the cross-entropy with its bias (``ops/fused_ce.py``).

Parameter names and shapes are the reference's, so its
``named_parameters`` load by name (``models.params.
layer_params_from_numpy``). The port's own initial values come from the
seeded generators of ``framework.random`` with the reference's recipes.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from .. import nn as pnn
from ..nn import functional as F
from ..ops.fused_ce import fused_linear_cross_entropy


@dataclass
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    hidden_act: str = "gelu"
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    initializer_range: float = 0.02
    layer_norm_eps: float = 1e-12
    pad_token_id: int = 0


BERT_CONFIGS = {
    "bert-base": BertConfig(),
    "bert-large": BertConfig(hidden_size=1024, num_hidden_layers=24,
                             num_attention_heads=16, intermediate_size=4096),
}


class BertEmbeddings(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        attr = pnn.ParamAttr(initializer=pnn.initializer.Normal(
            0.0, cfg.initializer_range))
        self.word_embeddings = pnn.Embedding(cfg.vocab_size, cfg.hidden_size,
                                             weight_attr=attr)
        self.position_embeddings = pnn.Embedding(
            cfg.max_position_embeddings, cfg.hidden_size, weight_attr=attr)
        self.token_type_embeddings = pnn.Embedding(
            cfg.type_vocab_size, cfg.hidden_size, weight_attr=attr)
        self.layer_norm = pnn.LayerNorm(cfg.hidden_size,
                                        epsilon=cfg.layer_norm_eps)
        self.dropout = pnn.Dropout(cfg.hidden_dropout_prob)

    def forward(self, input_ids, token_type_ids=None):
        S = input_ids.shape[1]
        pos = torch.arange(S, device=input_ids.device)[None, :]
        emb = self.word_embeddings(input_ids) + self.position_embeddings(pos)
        if token_type_ids is not None:
            emb = emb + self.token_type_embeddings(token_type_ids)
        return self.dropout(self.layer_norm(emb))


class BertModel(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.config = cfg
        self.embeddings = BertEmbeddings(cfg)
        enc_layer = pnn.TransformerEncoderLayer(
            cfg.hidden_size, cfg.num_attention_heads, cfg.intermediate_size,
            dropout=cfg.hidden_dropout_prob, activation="gelu",
            attn_dropout=cfg.attention_probs_dropout_prob,
            normalize_before=False)
        self.encoder = pnn.TransformerEncoder(enc_layer,
                                              cfg.num_hidden_layers)
        self.pooler = pnn.Linear(cfg.hidden_size, cfg.hidden_size)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None):
        x = self.embeddings(input_ids, token_type_ids)
        if attention_mask is not None and attention_mask.dim() == 2:
            # [B, S] 1 / 0 -> additive [B, 1, 1, S]
            am = (1.0 - attention_mask.float()) * -1e4
            attention_mask = am[:, None, None, :]
        seq = self.encoder(x, attention_mask)
        pooled = F.tanh(self.pooler(seq[:, 0]))
        return seq, pooled


class BertForPretraining(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.bert = BertModel(cfg)
        self.mlm_transform = pnn.Linear(cfg.hidden_size, cfg.hidden_size)
        self.mlm_norm = pnn.LayerNorm(cfg.hidden_size,
                                      epsilon=cfg.layer_norm_eps)
        self.mlm_head = pnn.Linear(cfg.hidden_size, cfg.vocab_size)
        self.nsp_head = pnn.Linear(cfg.hidden_size, 2)

    def _mlm_hidden(self, seq):
        return self.mlm_norm(F.gelu(self.mlm_transform(seq)))

    def forward(self, input_ids, token_type_ids=None, attention_mask=None):
        seq, pooled = self.bert(input_ids, token_type_ids, attention_mask)
        mlm = self.mlm_head(self._mlm_hidden(seq))
        nsp = self.nsp_head(pooled)
        return mlm, nsp

    def loss(self, outputs, mlm_labels, nsp_labels=None, ignore_index=-100):
        mlm, nsp = outputs
        V = mlm.shape[-1]
        loss = F.cross_entropy(mlm.reshape(-1, V), mlm_labels.reshape(-1),
                               ignore_index=ignore_index)
        if nsp_labels is not None:
            loss = loss + F.cross_entropy(nsp, nsp_labels)
        return loss

    def pretraining_loss(self, input_ids, mlm_labels, token_type_ids=None,
                         attention_mask=None, nsp_labels=None,
                         ignore_index=-100):
        """MLM (+ NSP) loss with the MLM head fused into the cross-entropy:
        the [B, S, V] logits never exist. The value of
        ``loss(forward(...), ...)`` up to fp32 rounding."""
        seq, pooled = self.bert(input_ids, token_type_ids, attention_mask)
        h = self._mlm_hidden(seq)
        labels = mlm_labels.reshape(-1)
        losses = fused_linear_cross_entropy(
            h.reshape(-1, h.shape[-1]), self.mlm_head.weight.to(h.dtype),
            labels, head_b=self.mlm_head.bias.to(h.dtype))
        keep = labels != ignore_index
        loss = torch.where(keep, losses, 0.0).sum() / keep.sum().clamp(min=1)
        if nsp_labels is not None:
            loss = loss + F.cross_entropy(self.nsp_head(pooled), nsp_labels)
        return loss


class BertForSequenceClassification(nn.Module):
    def __init__(self, cfg: BertConfig, num_classes=2):
        super().__init__()
        self.bert = BertModel(cfg)
        self.dropout = pnn.Dropout(cfg.hidden_dropout_prob)
        self.classifier = pnn.Linear(cfg.hidden_size, num_classes)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None):
        _, pooled = self.bert(input_ids, token_type_ids, attention_mask)
        return self.classifier(self.dropout(pooled))

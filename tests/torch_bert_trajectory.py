"""BERT pretraining loss trajectories of the reference and the port on the
CPU, from the same weights and batch: a record, not a test.

The reference's BERT at BERT-base width (768 wide, 12 heads of 64, FFN
3072, vocab 30522) cut to ``--layers`` layers, its seeded init carried to
the port by name as numpy arrays, dropout 0 (the frameworks' masks come
from different generators), both under ``amp.decorate`` O2 bf16 with
AdamW(``--lr``, global-norm clip 1.0) through ``jit.TrainStep``, on one
batch of chip_smoke.py's recipe (lengths 64..S, the rest padded, 15 %
MLM targets, NSP labels; drawn with numpy from ``--seed``). Prints each
step's loss for both.

    JAX_PLATFORMS=cpu python tests/torch_bert_trajectory.py \
        [--layers 2] [--steps 7] [--batch 32] [--seq 128] [--lr 1e-4]
"""
import argparse
import os
import sys

import jax
import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import paddle_tpu as paddle                                  # noqa: E402
from paddle_tpu.models.bert import BertConfig as JaxBertConfig  # noqa: E402
from paddle_tpu.models.bert import BertForPretraining as JaxBert  # noqa
from paddle_tpu_torch import amp                             # noqa: E402
from paddle_tpu_torch.jit import TrainStep                   # noqa: E402
from paddle_tpu_torch.models import (BertConfig, BertForPretraining,  # noqa
                                     layer_params_from_numpy)
from paddle_tpu_torch.nn import ClipGradByGlobalNorm         # noqa: E402
from paddle_tpu_torch.optimizer import AdamW                 # noqa: E402


def batch(cfg, B, S, seed):
    rng = np.random.default_rng(seed)
    lengths = rng.integers(64, S + 1, B)
    real = np.arange(S)[None, :] < lengths[:, None]
    ids = rng.integers(1, cfg["vocab_size"], (B, S)) * real
    labels = np.where((rng.random((B, S)) < 0.15) & real, ids, -100)
    types = (np.arange(S)[None, :] >= lengths[:, None] // 2)
    nsp = rng.integers(0, 2, B)
    return tuple(a.astype(np.int64) for a in
                 (ids, labels, types, real, nsp))


class _Loss(torch.nn.Module):
    def __init__(self, inner):
        super().__init__()
        self.inner = inner

    def forward(self, *batch):
        return self.inner.pretraining_loss(*batch)


class _JaxLoss(paddle.nn.Layer):
    def __init__(self, inner):
        super().__init__()
        self.inner = inner

    def forward(self, *batch):
        return self.inner.pretraining_loss(*batch)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--steps", type=int, default=7)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    jax.config.update("jax_platforms", "cpu")
    cfg = dict(vocab_size=30522, hidden_size=768,
               num_hidden_layers=args.layers, num_attention_heads=12,
               intermediate_size=3072, hidden_dropout_prob=0.0,
               attention_probs_dropout_prob=0.0)
    data = batch(cfg, args.batch, args.seq, args.seed)
    paddle.seed(args.seed)
    ref = JaxBert(JaxBertConfig(**cfg))
    weights = {n: np.array(p._data) for n, p in ref.named_parameters()}
    port = layer_params_from_numpy(BertForPretraining(BertConfig(**cfg)),
                                   weights)
    jopt = paddle.optimizer.AdamW(
        args.lr, grad_clip=paddle.nn.ClipGradByGlobalNorm(1.0))
    topt = AdamW(args.lr, grad_clip=ClipGradByGlobalNorm(1.0))
    ref, jopt = paddle.amp.decorate(ref, jopt, level="O2", dtype="bfloat16")
    port, topt = amp.decorate(port, topt, level="O2", dtype="bfloat16")
    jstep = paddle.jit.TrainStep(_JaxLoss(ref), lambda out: out, jopt)
    tstep = TrainStep(_Loss(port), lambda out: out, topt, device="cpu")
    print(f"BERT-base width, {args.layers} layers, batch [{args.batch}, "
          f"{args.seq}], dropout 0, O2 bf16, AdamW({args.lr}, clip 1.0), "
          f"seed {args.seed}")
    for i in range(args.steps):
        jl = float(jstep(tuple(paddle.to_tensor(a) for a in data),
                         ()).numpy())
        tl = float(tstep(tuple(torch.from_numpy(a) for a in data), ()))
        print(f"step {i + 1}: reference {jl:.4f}  port {tl:.4f}")


if __name__ == "__main__":
    main()

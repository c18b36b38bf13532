"""Prints what sets the gate of chip_smoke.py's phase 14 kernels-vs-composed
check, on the CPU: a 2 + 2-layer copy of Transformer-base at full width
(d_model 512, 8 heads of 64, FFN 2048, vocab 37,000), amp O2 bf16,
dropout 0.1, the phase's batch (32 pairs of 256 -> 128 slots), through
the flash path (on the CPU the kernels' plain versions) and through
FLAGS_use_flash_attention=False (the composed path) from the same weights
and generator state: one step's loss and every gradient leaf, then 3
jit.TrainStep steps of each route (chip_smoke.parity_routes, its gates
reported instead of raised). A record, not a test (~3 min):

    JAX_PLATFORMS=cpu python tests/torch_transformer_gate.py [--seeds 0 1]
"""
import argparse
import dataclasses
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, nargs="+", default=[0])
    args = ap.parse_args()
    cs.check = lambda cond, msg: None if cond else print(
        f"[gate] would fail: {msg[:300]}")
    cfg = dataclasses.replace(cs.TRANSFORMER_CONFIGS[cs.TRANSFORMER_MODEL],
                              num_encoder_layers=2, num_decoder_layers=2)
    cpu = torch.device("cpu")
    for seed in args.seeds:
        print(f"[gate] seed {seed}")
        cs.parity_routes("transformer-parity-cpu",
                         lambda: cs.transformer_model(cfg, seed + 1, cpu),
                         cs.TranslationLoss,
                         cs.transformer_batch(cfg, seed + 1, cpu), seed,
                         cs.TF_PARITY_STEPS)


if __name__ == "__main__":
    main()

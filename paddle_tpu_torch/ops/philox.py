"""The keep mask of flash attention's in-kernel dropout: Philox4x32-10 on
torch int64 tensors, the plain version of ``csrc/philox.cuh``.

Counterpart of ``dropout_keep`` (``paddle_tpu/ops/pallas_kernels/
flash_attention_bwd.py:40-54``), which seeds the TPU's generator with the
grid block. The port's three flash kernels tile the (query, key) plane
differently (forward 128 x 128, dQ 128 x 64, dK/dV 128 keys x 64
queries), so a keep bit must be a function of the element alone: for
batch b, head h (of H), query i and key j under the call's 64-bit key,

    words = Philox4x32-10(counter = (j >> 1, i >> 1, b*H + h, 0),
                          key = (key & 0xffffffff, key >> 32))
    bits  = words[2 * (i & 1) + (j & 1)]
    keep  = bits >= threshold(p) = floor(p * 2**32)

One call covers a 2 x 2 block of (query, key) pairs. In a wgmma
accumulator fragment the two lanes of a quad's neighbouring rows (lane
and lane ^ 4) hold both rows of such a block, whether the rows are
queries (forward, dQ) or keys (dK/dV), so the kernels share each call
between two lanes.

The plain version runs on int64 tensors, whose 64-bit products of two
32-bit words would overflow: ``_mulhilo`` splits the multiplier into
16-bit halves.
"""
from __future__ import annotations

import torch

PHILOX_M0 = 0xD2511F53
PHILOX_M1 = 0xCD9E8D57
PHILOX_W0 = 0x9E3779B9
PHILOX_W1 = 0xBB67AE85
ROUNDS = 10
MASK32 = 0xFFFFFFFF


def threshold(p):
    """The uint32 threshold of dropout rate ``p`` in [0, 1): a word is kept
    when it is at least this."""
    p = float(p)
    if not 0.0 <= p < 1.0:
        raise ValueError(f"dropout rate must be in [0, 1), got {p}")
    return min(int(p * 2 ** 32), MASK32)


def _mulhilo(m, x):
    """(hi, lo) 32-bit words of the 64-bit product m * x, for a constant m
    and x an int64 tensor of 32-bit values; no partial product reaches
    2**49."""
    p1 = x * (m & 0xFFFF)
    p2 = x * (m >> 16) + (p1 >> 16)
    return p2 >> 16, ((p2 & 0xFFFF) << 16) | (p1 & 0xFFFF)


def philox4x32(c0, c1, c2, c3, key):
    """Philox4x32-10 of the counter words (int64 tensors of 32-bit values,
    broadcastable) under the 64-bit ``key``: four int64 tensors of 32-bit
    words."""
    k0, k1 = key & MASK32, (key >> 32) & MASK32
    x = list(torch.broadcast_tensors(c0, c1, c2, c3))
    for r in range(ROUNDS):
        if r:
            k0, k1 = (k0 + PHILOX_W0) & MASK32, (k1 + PHILOX_W1) & MASK32
        hi0, lo0 = _mulhilo(PHILOX_M0, x[0])
        hi1, lo1 = _mulhilo(PHILOX_M1, x[2])
        x = [hi1 ^ x[1] ^ k0, lo1, hi0 ^ x[3] ^ k1, lo0]
    return x


def keep_mask(B, H, Sq, Sk, p, key, device="cpu"):
    """bool [B, H, Sq, Sk]: which (query, key) probabilities the flash
    kernels keep at dropout rate ``p`` under ``key``."""
    i2, j2 = -(-Sq // 2), -(-Sk // 2)

    def ar(n):
        return torch.arange(n, dtype=torch.int64, device=device)

    c0 = ar(j2).view(1, 1, 1, j2)
    c1 = ar(i2).view(1, 1, i2, 1)
    c2 = ar(B * H).view(B, H, 1, 1)
    words = philox4x32(c0, c1, c2, torch.zeros((), dtype=torch.int64,
                                               device=device), int(key))
    # word 2 * (i & 1) + (j & 1) of the block (i >> 1, j >> 1)
    bits = torch.stack(words, -1).view(B, H, i2, j2, 2, 2)
    bits = bits.permute(0, 1, 2, 4, 3, 5).reshape(B, H, 2 * i2, 2 * j2)
    return bits[:, :, :Sq, :Sk] >= threshold(p)

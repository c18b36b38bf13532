"""Seeded randomness (counterpart of ``paddle_tpu/framework/random.py``).

The reference threads JAX keys split from one seeded key. The port keeps
one named ``torch.Generator`` per device, all seeded by ``seed(n)``: every
dropout of the port draws from them, never from torch's global RNG, so a
test or a run that calls ``seed(n)`` again gets the same masks.

* ``generator(device)``: the device's generator (hidden dropout's
  ``bernoulli_`` on a tensor of that device draws from it);
* ``philox_key()``: the 64-bit key of one flash attention call's in-kernel
  dropout (``ops/philox.py``), drawn from the host's generator, so taking
  it waits for no device work;
* ``state_dict()`` / ``set_state_dict(state)``: every generator's state,
  which remat (``distributed/recompute.py``) takes before a block's
  forward and puts back for its recompute, so the backward sees the
  forward's masks.
"""
from __future__ import annotations

import torch


class _RngState:
    def __init__(self):
        self.seed = 0
        self.generators = {}      # device string -> torch.Generator


_rng = _RngState()


def _name(device):
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return str(dev)


def seed(s: int):
    """paddle.seed parity: reseed every device's generator with ``s``."""
    _rng.seed = int(s)
    for gen in _rng.generators.values():
        gen.manual_seed(_rng.seed)
    return _rng


def get_seed() -> int:
    return _rng.seed


def generator(device="cpu") -> torch.Generator:
    """The named generator of ``device``, made at first use and seeded with
    the last ``seed``."""
    name = _name(device)
    gen = _rng.generators.get(name)
    if gen is None:
        gen = torch.Generator(device=name).manual_seed(_rng.seed)
        _rng.generators[name] = gen
    return gen


def philox_key() -> int:
    """A 64-bit Philox key for one in-kernel dropout call, from the host
    generator (no device sync)."""
    words = torch.randint(0, 2 ** 32, (2,), dtype=torch.int64,
                          generator=generator("cpu"))
    return int(words[0]) | (int(words[1]) << 32)


def state_dict():
    """The seed and every generator's state."""
    return {"seed": _rng.seed,
            "generators": {name: gen.get_state()
                           for name, gen in _rng.generators.items()}}


def set_state_dict(state):
    """Put back a ``state_dict``: each generator it holds gets its state,
    one made since is reseeded as it was made (with the state's seed)."""
    _rng.seed = state["seed"]
    for name, gen in _rng.generators.items():
        saved = state["generators"].get(name)
        if saved is None:
            gen.manual_seed(_rng.seed)
        else:
            gen.set_state(saved)

"""Framework state the port's layers share (counterpart of
``paddle_tpu/framework``): the seeded generators."""
from . import random
from .random import get_seed, seed

__all__ = ["get_seed", "random", "seed"]

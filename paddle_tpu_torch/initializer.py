"""Parameter initializers — emit init ops into the startup program.

Counterpart of ``paddle_tpu/initializer.py``, cut to the constant and
uniform families the training slice uses (Xavier in its uniform
form). The normal-distribution initializers need
``gaussian_random``, which lands with the RNG plane.
"""
from __future__ import annotations

import math

from .core.types import dtype_name


class Initializer:
    def __call__(self, var, block):
        raise NotImplementedError


class ConstantInitializer(Initializer):
    def __init__(self, value: float = 0.0):
        self.value = value

    def __call__(self, var, block):
        block.append_op(
            "fill_constant", outputs={"Out": [var.name]},
            attrs={"shape": list(var.shape), "dtype": dtype_name(var.dtype),
                   "value": float(self.value)})


class UniformInitializer(Initializer):
    def __init__(self, low: float = -1.0, high: float = 1.0, seed: int = 0):
        self.low, self.high, self.seed = low, high, seed

    def __call__(self, var, block):
        block.append_op(
            "uniform_random", outputs={"Out": [var.name]},
            attrs={"shape": list(var.shape), "dtype": dtype_name(var.dtype),
                   "min": self.low, "max": self.high, "seed": self.seed})


def _fans(var):
    shape = var.shape
    if len(shape) == 2:
        return shape[0], shape[1]
    if len(shape) == 4:
        # conv filter OIHW: receptive field * channels
        rf = shape[2] * shape[3]
        return shape[1] * rf, shape[0] * rf
    n = math.prod(shape)
    return n, n


def _normal_not_ported(kind):
    raise NotImplementedError(
        f"{kind}(uniform=False) draws from a normal distribution "
        "(gaussian_random), which is not ported to paddle_tpu_torch yet: it "
        "lands with the RNG plane")


class XavierInitializer(Initializer):
    """Glorot init: U(-sqrt(6 / (fan_in + fan_out)), +...)."""

    def __init__(self, uniform: bool = True, fan_in=None, fan_out=None,
                 seed: int = 0):
        self.uniform, self.fan_in, self.fan_out, self.seed = (
            uniform, fan_in, fan_out, seed)

    def __call__(self, var, block):
        if not self.uniform:
            _normal_not_ported("XavierInitializer")
        fin, fout = _fans(var)
        fin = self.fan_in if self.fan_in is not None else fin
        fout = self.fan_out if self.fan_out is not None else fout
        limit = math.sqrt(6.0 / (fin + fout))
        UniformInitializer(-limit, limit, self.seed)(var, block)


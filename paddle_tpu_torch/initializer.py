"""Parameter initializers — emit init ops into the startup program.

Counterpart of ``paddle_tpu/initializer.py``: constant, uniform, normal,
truncated-normal, Xavier and MSRA, with the fluid-style aliases. The
random ones draw from the executor's scope key, so a startup program's
values equal the JAX package's for the same seed.
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


class NormalInitializer(Initializer):
    def __init__(self, loc: float = 0.0, scale: float = 1.0, seed: int = 0):
        self.mean, self.std, self.seed = loc, scale, seed

    def __call__(self, var, block):
        block.append_op(
            "gaussian_random", outputs={"Out": [var.name]},
            attrs={"shape": list(var.shape), "dtype": dtype_name(var.dtype),
                   "mean": self.mean, "std": self.std, "seed": self.seed})


class TruncatedNormalInitializer(Initializer):
    def __init__(self, loc: float = 0.0, scale: float = 1.0, seed: int = 0):
        self.mean, self.std, self.seed = loc, scale, seed

    def __call__(self, var, block):
        block.append_op(
            "truncated_gaussian_random", outputs={"Out": [var.name]},
            attrs={"shape": list(var.shape), "dtype": dtype_name(var.dtype),
                   "mean": self.mean, "std": self.std, "seed": self.seed})


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


class XavierInitializer(Initializer):
    """Glorot init: U(-sqrt(6 / (fan_in + fan_out)), +...), or with
    ``uniform=False`` N(0, sqrt(2 / (fan_in + fan_out)))."""

    def __init__(self, uniform: bool = True, fan_in=None, fan_out=None,
                 seed: int = 0):
        self.uniform, self.fan_in, self.fan_out, self.seed = (
            uniform, fan_in, fan_out, seed)

    def __call__(self, var, block):
        fin, fout = _fans(var)
        fin = self.fan_in if self.fan_in is not None else fin
        fout = self.fan_out if self.fan_out is not None else fout
        if self.uniform:
            limit = math.sqrt(6.0 / (fin + fout))
            UniformInitializer(-limit, limit, self.seed)(var, block)
        else:
            std = math.sqrt(2.0 / (fin + fout))
            NormalInitializer(0.0, std, self.seed)(var, block)



class MSRAInitializer(Initializer):
    """He init: U(-sqrt(6 / fan_in), +...), or with ``uniform=False``
    N(0, sqrt(2 / fan_in))."""

    def __init__(self, uniform: bool = True, fan_in=None, seed: int = 0):
        self.uniform, self.fan_in, self.seed = uniform, fan_in, seed

    def __call__(self, var, block):
        fin, _ = _fans(var)
        fin = self.fan_in if self.fan_in is not None else fin
        if self.uniform:
            limit = math.sqrt(6.0 / fin)
            UniformInitializer(-limit, limit, self.seed)(var, block)
        else:
            std = math.sqrt(2.0 / fin)
            NormalInitializer(0.0, std, self.seed)(var, block)


# fluid-style aliases
Constant = ConstantInitializer
Uniform = UniformInitializer
Normal = NormalInitializer
TruncatedNormal = TruncatedNormalInitializer
Xavier = XavierInitializer
MSRA = MSRAInitializer
